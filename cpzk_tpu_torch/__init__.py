"""cpzk_tpu_torch — the PyTorch/CUDA port of cpzk_tpu's batch verification.

A second package beside ``cpzk_tpu``, built for an NVIDIA H100:

- **Host plane** (``core/`` + ``protocol/``): copies of the reference
  package's ristretto255 group API, Merlin transcripts, the 109-byte proof
  codec (eager and deferred batch parsing), single-proof prove/verify and
  the ``BatchVerifier`` with its combined-then-fallback policy, running on
  the port's own C++ host core (``native/``, built with g++ at first use
  by ``core/_native.py``), with pure-Python twins kept as the tests'
  oracles.
- **GPU data plane** (``ops/``): limb-tensor field arithmetic, point
  operations and the batch-verification ladders in PyTorch, with the two
  point kernels (add, fused k-doubling) written by hand in CUDA C++ for
  ``sm_90a`` (``csrc/``).  ``ops.backend.TorchBackend`` is the
  ``VerifierBackend`` that drives them; import it from there (this module
  does not import torch).

This package imports neither ``jax`` nor ``cpzk_tpu``.
"""

from .errors import (
    Error,
    InvalidGroupElement,
    InvalidParams,
    InvalidProofEncoding,
    InvalidScalar,
)
from .core.ristretto import Element, Ristretto255, Scalar
from .core.rng import SecureRng
from .core.transcript import Transcript
from .protocol.gadgets import (
    Commitment,
    Parameters,
    Proof,
    Response,
    Statement,
    Witness,
)
from .protocol.prover import Nonce, Prover
from .protocol.verifier import Verifier
from .protocol.batch import BatchVerifier, CpuBackend

__all__ = [
    "BatchVerifier",
    "Commitment",
    "CpuBackend",
    "Element",
    "Error",
    "InvalidGroupElement",
    "InvalidParams",
    "InvalidProofEncoding",
    "InvalidScalar",
    "Nonce",
    "Parameters",
    "Proof",
    "Prover",
    "Response",
    "Ristretto255",
    "Scalar",
    "SecureRng",
    "Statement",
    "Transcript",
    "Verifier",
    "Witness",
]
