"""The port's host layers against ``cpzk_tpu`` byte for byte.

Both packages draw from the same seeded stand-in rng (``fill_bytes`` over a
numpy generator), so witnesses, nonces and therefore proofs must come out
identical; transcript challenges, encodings and parse errors must match;
and proofs made by either package verify in the other."""

import numpy as np
import pytest

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.core import edwards as jedwards
from cpzk_tpu.core.transcript import derive_challenges_batch as j_derive
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.core import edwards as tedwards
from cpzk_tpu_torch.core.transcript import derive_challenges_batch as t_derive


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def prove(pkg, seed, n, context=None):
    """n (statement, proof) pairs from ``pkg``'s prover on a seeded rng."""
    rng = SeededRng(seed)
    params = pkg.Parameters.new()
    out = []
    for _ in range(n):
        prover = pkg.Prover(params, pkg.Witness(pkg.Ristretto255.random_scalar(rng)))
        t = pkg.Transcript()
        if context is not None:
            t.append_context(context)
        out.append((prover.statement, prover.prove_with_transcript(rng, t)))
    return params, out


def test_generators_and_encodings_match():
    assert T.Ristretto255.generator_g().wire() == J.Ristretto255.generator_g().wire()
    assert T.Ristretto255.generator_h().wire() == J.Ristretto255.generator_h().wire()
    rng = np.random.default_rng(5)
    for _ in range(8):
        k = int.from_bytes(rng.bytes(32), "little")
        tp = tedwards.pt_scalar_mul(tedwards.BASEPOINT, k)
        assert tp == jedwards.pt_scalar_mul(jedwards.BASEPOINT, k)
        wire = tedwards.ristretto_encode(tp)
        assert wire == jedwards.ristretto_encode(tp)
        assert tedwards.ristretto_decode(wire) == jedwards.ristretto_decode(wire)
    for bad in [b"\xff" * 32, (1).to_bytes(32, "little"), bytes([2]) + bytes(31)]:
        assert tedwards.ristretto_decode(bad) is None
        assert jedwards.ristretto_decode(bad) is None


@pytest.mark.parametrize("context", [None, b"login-ctx"])
def test_proof_bytes_identical_from_same_seed(context):
    _, jp = prove(J, 11, 3, context)
    _, tp = prove(T, 11, 3, context)
    for (js, jpr), (ts, tpr) in zip(jp, tp):
        assert jpr.to_bytes() == tpr.to_bytes()
        assert len(tpr.to_bytes()) == 109
        assert (js.y1.wire(), js.y2.wire()) == (ts.y1.wire(), ts.y2.wire())


def test_transcript_challenges_match():
    params, tp = prove(T, 12, 4)
    eb = T.Ristretto255.element_to_bytes
    cols = (
        [None, b"ctx", b"", b"x" * 200],
        [eb(params.generator_g)] * 4, [eb(params.generator_h)] * 4,
        [eb(st.y1) for st, _ in tp], [eb(st.y2) for st, _ in tp],
        [eb(pr.commitment.r1) for _, pr in tp], [eb(pr.commitment.r2) for _, pr in tp],
    )
    assert [c.value for c in t_derive(*cols)] == [c.value for c in j_derive(*cols)]


def test_proofs_cross_both_ways():
    jparams, jp = prove(J, 13, 2, b"ctx-a")
    tparams, tp = prove(T, 14, 2, b"ctx-b")
    # JAX-made proofs verify in the port
    for st, pr in jp:
        t_params = convert.parameters(jparams.generator_g.wire(), jparams.generator_h.wire())
        t_st = convert.statement(st.y1.wire(), st.y2.wire())
        tr = T.Transcript()
        tr.append_context(b"ctx-a")
        T.Verifier(t_params, t_st).verify_with_transcript(convert.proof(pr.to_bytes()), tr)
    # and port-made proofs verify in the JAX package
    for st, pr in tp:
        j_params = J.Parameters.with_generators(
            J.Ristretto255.element_from_bytes(tparams.generator_g.wire()),
            J.Ristretto255.element_from_bytes(tparams.generator_h.wire()))
        j_st = J.Statement(J.Ristretto255.element_from_bytes(st.y1.wire()),
                           J.Ristretto255.element_from_bytes(st.y2.wire()))
        tr = J.Transcript()
        tr.append_context(b"ctx-b")
        J.Verifier(j_params, j_st).verify_with_transcript(J.Proof.from_bytes(pr.to_bytes()), tr)
    # a wrong context fails in both, with the same error
    st, pr = tp[0]
    errors = []
    for pkg in (T, J):
        tr = pkg.Transcript()
        tr.append_context(b"other")
        params = pkg.Parameters.new()
        stmt = pkg.Statement(pkg.Ristretto255.element_from_bytes(st.y1.wire()),
                             pkg.Ristretto255.element_from_bytes(st.y2.wire()))
        with pytest.raises(pkg.Error) as exc:
            pkg.Verifier(params, stmt).verify_with_transcript(
                pkg.Proof.from_bytes(pr.to_bytes()), tr)
        errors.append((type(exc.value).__name__, str(exc.value)))
    assert errors[0] == errors[1] == ("InvalidParams", "Proof verification failed")


def test_parse_errors_identical():
    _, tp = prove(T, 15, 1)
    good = tp[0][1].to_bytes()
    ident = bytes(32)
    cases = [
        b"", good[:20], b"\x02" + good[1:], good + b"\x00",
        good[:1] + (0).to_bytes(4, "big") + good[5:],
        good[:5] + b"\xff" * 32 + good[37:],
        good[:5] + ident + good[37:],
        good[:77] + bytes(32),
        good[:77] + b"\xff" * 32,
        good[:1] + (5000).to_bytes(4, "big") + good[5:],
    ]
    for wire in cases:
        got = []
        for pkg in (T, J):
            try:
                pkg.Proof.from_bytes(wire)
                got.append(None)
            except pkg.Error as exc:
                got.append((type(exc).__name__, str(exc)))
        assert got[0] == got[1], wire.hex()
        assert got[0] is not None


@pytest.mark.parametrize("capacity", [-1, 0, 5, 10**6])
def test_batch_verifier_with_capacity(capacity):
    """``BatchVerifier.with_capacity`` as the reference's: a negative
    capacity raises ``InvalidParams`` with the same message; otherwise an
    empty verifier at the default bound, on the backend passed."""
    from cpzk_tpu.protocol.batch import BatchVerifier as JBatchVerifier
    from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend

    def outcome(cls, backend):
        try:
            bv = cls.with_capacity(capacity, backend)
        except Exception as e:  # noqa: BLE001 - compared across packages
            return (type(e).__name__, str(e))
        return (len(bv), bv.remaining_capacity(), bv.is_empty())

    cpu = T.CpuBackend()
    port = outcome(T.BatchVerifier, cpu)
    assert port == outcome(JBatchVerifier, JCpuBackend())
    if capacity < 0:
        assert port == ("InvalidParams", "Capacity cannot be negative")
    else:
        assert T.BatchVerifier.with_capacity(capacity, cpu).backend is cpu
