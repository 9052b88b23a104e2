"""cpzk_tpu_torch — the PyTorch/CUDA port of cpzk_tpu's batch verification.

A second package beside ``cpzk_tpu``, built for an NVIDIA H100:

- **Host plane** (``core/`` + ``protocol/``): pure-Python copies of the
  reference package's ristretto255 group arithmetic, Merlin transcripts,
  the 109-byte proof codec, single-proof prove/verify and the
  ``BatchVerifier`` with its combined-then-fallback policy.
- **GPU data plane** (``ops/``): limb-tensor field arithmetic, point
  operations and the batch-verification ladders in PyTorch, with the two
  point kernels (add, fused k-doubling) written by hand in CUDA C++ for
  ``sm_90a`` (``csrc/``).  ``ops.backend.TorchBackend`` is the
  ``VerifierBackend`` that drives them; import it from there (this module
  does not import torch).

This package imports neither ``jax`` nor ``cpzk_tpu``.
"""

from .errors import Error, InvalidGroupElement, InvalidParams, InvalidScalar
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
