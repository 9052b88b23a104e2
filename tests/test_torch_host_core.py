"""The slice as a whole: wire bytes in, accept set out.  The port's
wire-fed marshalling (``curve.wires_to_device``) against the JAX
package's, and a seeded wire-parsed batch with tampered and undecodable rows
through the port's ``BatchVerifier(backend=TorchBackend(device="cpu"))``
and the JAX package's ``BatchVerifier``.

Tolerance: exact (limbs bit for bit; accept sets, error types and
messages)."""

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.ops import curve as jcurve
from cpzk_tpu.protocol.batch import BatchVerifier as JBatchVerifier
from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend
from cpzk_tpu.protocol.gadgets import Proof as JProof
from cpzk_tpu.core import _native as jnative
from cpzk_tpu_torch.core import _native, edwards
from cpzk_tpu_torch.ops import curve
from cpzk_tpu_torch.ops.backend import TorchBackend
import torch_reference_core


@pytest.fixture(autouse=True, scope="module")
def reference_core():
    """The reference's host core, built under a lock (see
    ``tests/torch_reference_core.py``) and loaded in this worker."""
    return torch_reference_core.require()


BAD_POINT_MSG = "Bytes do not represent a valid Ristretto point"


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def random_wires(seed, n):
    rng = np.random.default_rng(seed)
    return [edwards.ristretto_encode(edwards.pt_scalar_mul(
        edwards.BASEPOINT, int.from_bytes(rng.bytes(32), "little"))) for _ in range(n)]


@pytest.mark.parametrize("n,pad", [(1, 1), (5, 8), (13, 16)])
def test_wires_to_device_matches_jax_and_points_soa(n, pad):
    wires = random_wires(40 + n, n)
    wires[0] = bytes(32)  # the identity
    blob = b"".join(wires)
    got = curve.wires_to_device(blob, pad, "cpu")
    want = jcurve.wires_to_device(blob, pad)
    ref = curve.points_soa([edwards.ristretto_decode(w) for w in wires], pad, "cpu")
    for g, w, r in zip(got, want, ref):
        assert g.dtype == torch.int32 and g.shape == (20, pad)
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, r)
    assert _native.batch_decode(blob) == jnative.batch_decode(blob)
    assert _native.batch_decode(blob)[1] == b"\x01" * n


def test_wires_to_device_staging_reuse_and_rejects():
    """Two calls at one width from one thread give independent results:
    the first must not change under the second.  An undecodable wire
    raises."""
    a, b = random_wires(50, 6), random_wires(51, 6)
    first = curve.wires_to_device(b"".join(a), 8, "cpu")
    kept = [c.clone() for c in first]
    second = curve.wires_to_device(b"".join(b), 8, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(first, kept))
    assert not all(torch.equal(x, y) for x, y in zip(first, second))
    with pytest.raises(T.InvalidGroupElement, match="batch decode"):
        curve.wires_to_device(b"".join(a[:3]) + b"\xff" * 32, 4, "cpu")
    with pytest.raises(ValueError, match="smaller"):
        curve.wires_to_device(b"".join(a), 4, "cpu")


def test_wire_only_element_equality_and_hash_match_jax():
    w1, w2 = random_wires(52, 2)
    pairs = {
        "port": (T.Ristretto255.element_from_bytes(w1), T.Element(edwards.ristretto_decode(w1)),
                 T.Ristretto255.element_from_bytes(w2)),
        "jax": (J.Ristretto255.element_from_bytes(w1),
                J.Element(edwards.ristretto_decode(w1)), J.Ristretto255.element_from_bytes(w2)),
    }
    for lazy, eager, other in pairs.values():
        assert lazy == eager and eager == lazy and lazy != other
        assert hash(lazy) == hash(eager) == hash(w1)


def slice_wires(pkg, seed, n):
    """n entries as wire bytes from ``pkg``'s prover (same seed, same bytes
    for both packages), with one wrong-s row, one wrong-context row and
    one undecodable commitment."""
    rng = SeededRng(seed)
    params = pkg.Parameters.new()
    out = []
    for i in range(n):
        prover = pkg.Prover(params, pkg.Witness(pkg.Ristretto255.random_scalar(rng)))
        ctx = b"slice-%d" % i
        t = pkg.Transcript()
        t.append_context(ctx)
        wire = prover.prove_with_transcript(rng, t).to_bytes()
        out.append([wire, prover.statement.y1.wire(), prover.statement.y2.wire(), ctx])
    s = int.from_bytes(out[1][0][77:], "little") + 1
    out[1][0] = out[1][0][:77] + s.to_bytes(32, "little")
    out[2][3] = b"replayed"
    out[4][0] = out[4][0][:5] + b"\xff" * 32 + out[4][0][37:]
    return params, out


def verify_wires(pkg, proof_cls, backend, deferred, seed=60, n=6):
    params, entries = slice_wires(pkg, seed, n)
    parsed = proof_cls.from_bytes_batch([e[0] for e in entries],
                                        defer_point_validation=deferred)
    bv = (T.BatchVerifier if pkg is T else JBatchVerifier)(backend=backend, max_size=n)
    results = [None] * n
    kept = []
    for i, ((_, y1, y2, ctx), proof) in enumerate(zip(entries, parsed)):
        if not isinstance(proof, proof_cls):
            results[i] = proof  # the eager parse's error
            continue
        st = pkg.Statement(pkg.Ristretto255.element_from_bytes(y1),
                           pkg.Ristretto255.element_from_bytes(y2))
        bv.add_with_context(params, st, proof, ctx)
        kept.append(i)
    for i, r in zip(kept, bv.verify(pkg.SecureRng())):
        results[i] = r
    return [None if r is None else (type(r).__name__, str(r)) for r in results]


def test_wire_parsed_batch_through_torch_backend_matches_jax():
    backend = TorchBackend(device="cpu")
    want = [None, ("InvalidParams", "Proof verification failed"),
            ("InvalidParams", "Proof verification failed"), None,
            ("InvalidProofEncoding", BAD_POINT_MSG), None]
    deferred = verify_wires(T, T.Proof, backend, True)
    assert deferred == verify_wires(J, JProof, JCpuBackend(), True) == want
    assert verify_wires(T, T.Proof, T.CpuBackend(), True) == want
    # eager: the undecodable row fails at parse, with the same message
    eager = verify_wires(J, JProof, JCpuBackend(), False)
    assert eager[4] == ("InvalidGroupElement", BAD_POINT_MSG)
    assert verify_wires(T, T.Proof, T.CpuBackend(), False) == eager
