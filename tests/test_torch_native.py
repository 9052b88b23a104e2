"""The port's C++ host core (``cpzk_tpu_torch/native``) against its
pure-Python twins and against the JAX package's own native core and pure
paths, on numpy-seeded inputs.  Twins of the cases of ``test_native.py``.

Tolerance: exact everywhere (transcript and challenge bytes, canonical
encodings, row statuses, error types and messages)."""

import threading

import numpy as np
import pytest

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.core import _native as jnative
from cpzk_tpu.core import edwards as jedwards
from cpzk_tpu.core.strobe import Strobe128 as JStrobe
from cpzk_tpu.core.transcript import MerlinTranscript as JMerlin
from cpzk_tpu.core.transcript import derive_challenges_batch as j_derive
from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend
from cpzk_tpu_torch.core import _native, edwards, scalars
from cpzk_tpu_torch.core.strobe import Strobe128
from cpzk_tpu_torch.core.transcript import (
    CHALLENGE_DST,
    PROTOCOL_DST,
    PROTOCOL_LABEL,
    MerlinTranscript,
    PureTranscript,
    derive_challenges_batch,
    derive_challenges_batch_pure,
)
from cpzk_tpu_torch.protocol.batch import BatchRow, CpuBackend
import torch_reference_core


@pytest.fixture(autouse=True, scope="module")
def reference_core():
    """The reference's host core, built under a lock (see
    ``tests/torch_reference_core.py``) and loaded in this worker."""
    return torch_reference_core.require()


L = scalars.L


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def rand_scalar(rng):
    return int.from_bytes(rng.bytes(32), "little") % L


def rand_wire(rng):
    return edwards.ristretto_encode(edwards.pt_scalar_mul(edwards.BASEPOINT, rand_scalar(rng)))


def proof_row(params, seed, context=None):
    """One valid (g, h, y1, y2, r1, r2, s, c) wire row from the port's prover."""
    rng = SeededRng(seed)
    prover = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng)))
    t = T.Transcript()
    if context is not None:
        t.append_context(context)
    proof = prover.prove_with_transcript(rng, t)
    eb = T.Ristretto255.element_to_bytes
    vt = PureTranscript()
    if context is not None:
        vt.append_context(context)
    vt.append_parameters(eb(params.generator_g), eb(params.generator_h))
    vt.append_statement(eb(prover.statement.y1), eb(prover.statement.y2))
    vt.append_commitment(eb(proof.commitment.r1), eb(proof.commitment.r2))
    c = vt.challenge_scalar()
    return (eb(params.generator_g), eb(params.generator_h),
            eb(prover.statement.y1), eb(prover.statement.y2),
            eb(proof.commitment.r1), eb(proof.commitment.r2),
            T.Ristretto255.scalar_to_bytes(proof.response.s),
            T.Ristretto255.scalar_to_bytes(c))


def pure_statuses(rows):
    """Row statuses of the pure-Python twin for (g, h, y1, y2, r1, r2, s, c) wires."""
    def elem(w):
        return T.Element(wire=w)

    return CpuBackend.verify_each_pure([
        BatchRow(elem(g), elem(h), elem(y1), elem(y2), elem(r1), elem(r2),
                 T.Scalar(int.from_bytes(s, "little")), T.Scalar(int.from_bytes(c, "little")),
                 T.Scalar(1))
        for g, h, y1, y2, r1, r2, s, c in rows])


def native_statuses(rows):
    """Statuses from the port's and the JAX package's native row verifiers
    (they share the generators of the first row); asserted equal."""
    g, h = rows[0][0], rows[0][1]
    cols = [b"".join(r[k] for r in rows) for k in range(2, 8)]
    port = _native.verify_rows(g, h, *cols)
    assert port == jnative.verify_rows(g, h, *cols)
    return port


def test_native_merlin_matches_python():
    rng = np.random.default_rng(1)
    for _ in range(5):
        label = rng.bytes(int(rng.integers(1, 41)))
        ts = [MerlinTranscript(PROTOCOL_LABEL), _native.NativeMerlin(PROTOCOL_LABEL),
              JMerlin(PROTOCOL_LABEL), jnative.NativeMerlin(PROTOCOL_LABEL)]
        msgs = [(b"protocol", PROTOCOL_DST), (b"context", label),
                (b"big", rng.bytes(700)),  # > the STROBE rate: several runs of F
                (b"empty", b"")]
        for lab, msg in msgs:
            for t in ts:
                t.append_message(lab, msg)
        outs = {t.challenge_bytes(CHALLENGE_DST, 64) for t in ts}
        assert len(outs) == 1
        for t in ts:  # state still aligned after a challenge
            t.append_message(b"more", b"x")
        assert len({t.challenge_bytes(b"c2", 32) for t in ts}) == 1


def test_native_challenge_batch_matches_python():
    rng = np.random.default_rng(2)
    n = 17
    # absent (None), empty (b"", still appended) and sized contexts
    contexts = [None if i % 3 == 0 else rng.bytes(i - 1) for i in range(n)]
    assert b"" in contexts
    cols = [[rng.bytes(32) for _ in range(n)] for _ in range(6)]
    native = [c.value for c in derive_challenges_batch(contexts, *cols)]
    assert native == [c.value for c in derive_challenges_batch_pure(contexts, *cols)]
    assert native == [c.value for c in j_derive(contexts, *cols)]
    raw = _native.challenge_batch(contexts, *(b"".join(c) for c in cols))
    assert raw == jnative.challenge_batch(contexts, *(b"".join(c) for c in cols))
    for threads in (1, 3):
        assert _native.challenge_batch(contexts, *(b"".join(c) for c in cols),
                                       threads=threads) == raw
    with pytest.raises(ValueError, match="n\\*32"):
        _native.challenge_batch(contexts, b"", *(b"".join(c) for c in cols[1:]))


@pytest.mark.parametrize("size", [165, 166, 167, 400])
def test_strobe_rate_boundary(size):
    """Absorb and squeeze across the 166-byte STROBE rate: Python STROBE of
    both packages, and the native transcript against the Python one."""
    data = np.random.default_rng(size).bytes(size)
    s1, s2 = Strobe128(b"proto"), JStrobe(b"proto")
    s1.ad(data, False)
    s2.ad(data, False)
    assert s1.prf(200, False) == s2.prf(200, False)
    py, nat = MerlinTranscript(b"proto"), _native.NativeMerlin(b"proto")
    for t in (py, nat):
        t.append_message(b"m", data)
    assert py.challenge_bytes(b"c", 200) == nat.challenge_bytes(b"c", 200)


INVALID_WIRES = [
    (3).to_bytes(32, "little"),                          # odd s
    ((edwards.P + 1) % 2**256).to_bytes(32, "little"),   # non-canonical
    b"\xff" * 32,                                        # garbage
    (edwards.P - 1).to_bytes(32, "little"),              # s = -1: negative
    bytes([2]) + bytes(31),                              # not a square
]


def test_native_point_roundtrip_differential():
    rng = np.random.default_rng(3)
    for _ in range(24):
        wire = rand_wire(rng)
        assert _native.point_roundtrip(wire) == wire == jnative.point_roundtrip(wire)
        assert edwards.ristretto_encode(edwards.ristretto_decode(wire)) == wire
    for bad in INVALID_WIRES:
        assert _native.point_roundtrip(bad) == b"" == jnative.point_roundtrip(bad)
        assert edwards.ristretto_decode(bad) is None
    assert _native.point_roundtrip(edwards.ristretto_encode(edwards.BASEPOINT)) != b""


def test_native_group_ops_differential():
    rng = np.random.default_rng(4)
    for _ in range(10):
        k, m = rand_scalar(rng), rand_scalar(rng)
        P = edwards.pt_scalar_mul(edwards.BASEPOINT, k)
        Q = edwards.pt_scalar_mul(edwards.BASEPOINT, m)
        wp, wq = edwards.ristretto_encode(P), edwards.ristretto_encode(Q)
        mb = m.to_bytes(32, "little")
        want = edwards.ristretto_encode(edwards.pt_scalar_mul(P, m))
        assert _native.scalarmul(wp, mb) == want == jnative.scalarmul(wp, mb)
        want = edwards.ristretto_encode(edwards.pt_add(P, Q))
        assert _native.point_add(wp, wq) == want == jnative.point_add(wp, wq)
        # the group API on lazy (wire-only) elements goes through the core
        e = T.Ristretto255.element_from_bytes(wp)
        assert T.Ristretto255.scalar_mul(e, T.Scalar(m)).wire() == edwards.ristretto_encode(
            edwards.pt_scalar_mul(P, m))
        assert T.Ristretto255.element_mul(e, T.Ristretto255.element_from_bytes(wq)).wire() == (
            J.Ristretto255.element_mul(J.Ristretto255.element_from_bytes(wp),
                                       J.Ristretto255.element_from_bytes(wq)).wire())
    wp = edwards.ristretto_encode(edwards.pt_scalar_mul(edwards.BASEPOINT, 7))
    assert _native.scalarmul(wp, bytes(32)) == edwards.ristretto_encode(edwards.IDENTITY)
    assert _native.scalarmul(wp, (1).to_bytes(32, "little")) == wp
    assert _native.scalarmul(b"\xff" * 32, (1).to_bytes(32, "little")) == b""
    with pytest.raises(T.InvalidGroupElement, match="valid Ristretto point"):
        T.Ristretto255.scalar_mul(T.Element(wire=b"\xff" * 32), T.Scalar(5))


def test_native_verify_rows_differential():
    params = T.Parameters.new()
    rows = [proof_row(params, 100 + i) for i in range(6)]
    assert native_statuses(rows) == [1] * 6 == pure_statuses(rows)

    def with_col(k, i, value):
        out = [list(r) for r in rows]
        out[i][k] = value
        return [tuple(r) for r in out]

    cases = {
        # corrupted challenge: that row only
        "challenge": (with_col(7, 1, bytes(32)), [1, 0, 1, 1, 1, 1]),
        # invalid statement encoding: plain failure, no crash
        "statement": (with_col(2, 0, b"\xff" * 32), [0, 1, 1, 1, 1, 1]),
        # invalid commitment encoding: tri-state 2 (deferred-parse rows)
        "commitment": (with_col(4, 0, b"\xff" * 32), [2, 1, 1, 1, 1, 1]),
    }
    swapped = [list(r) for r in rows]
    swapped[0][2], swapped[1][2] = rows[1][2], rows[0][2]
    cases["swapped"] = ([tuple(r) for r in swapped], [0, 0, 1, 1, 1, 1])
    for name, (case, want) in cases.items():
        assert native_statuses(case) == want, name
        if name != "statement":  # the pure twin cannot decode a bad statement
            assert pure_statuses(case) == want, name


def test_native_point_validate_differential():
    rng = np.random.default_rng(5)
    for _ in range(24):
        wire = rand_wire(rng)
        assert _native.point_validate(wire) is True is jnative.point_validate(wire)
    for bad in INVALID_WIRES:
        assert _native.point_validate(bad) is False is jnative.point_validate(bad)
        with pytest.raises(T.InvalidGroupElement) as native_err:
            T.Ristretto255.element_from_bytes(bad)
        with pytest.raises(T.InvalidGroupElement) as pure_err:
            T.Ristretto255.element_from_bytes_pure(bad)
        with pytest.raises(J.InvalidGroupElement) as jax_err:
            J.Ristretto255.element_from_bytes(bad)
        assert str(native_err.value) == str(pure_err.value) == str(jax_err.value)
    assert _native.point_validate(bytes(32)) is True  # the identity's wire
    assert _native.point_validate(bytes(31)) is False


def test_native_sc_mul_beta_differential():
    rng = np.random.default_rng(6)
    cases = [(int.from_bytes(rng.bytes(16), "little"), rand_scalar(rng)) for _ in range(200)]
    cases += [(0, 5), (1, L - 1), (2**128 - 1, L - 1), (2**128 - 1, 2**252),
              (2**127, L - 1), (1, 0)]
    for beta, s in cases:
        b16, s32 = beta.to_bytes(16, "little"), s.to_bytes(32, "little")
        out = _native.sc_mul_beta(b16, s32)
        assert int.from_bytes(out, "little") == beta * s % L, (beta, s)
        assert out == jnative.sc_mul_beta(b16, s32)
    with pytest.raises(ValueError, match="domain"):
        _native.sc_mul_beta((1).to_bytes(16, "little"), (2**253).to_bytes(32, "little"))


def test_verify_rows_single_equation_failures():
    """Exactly one of the two equations fails: never a false accept."""
    params = T.Parameters.new()
    row = proof_row(params, 7)
    junk = rand_wire(np.random.default_rng(7))
    eq2_broken = row[:5] + (junk,) + row[6:]
    eq1_broken = row[:4] + (junk,) + row[5:]
    assert native_statuses([row]) == [1] == pure_statuses([row])
    assert native_statuses([eq2_broken]) == [0] == pure_statuses([eq2_broken])
    assert native_statuses([eq1_broken]) == [0] == pure_statuses([eq1_broken])


def test_verify_rows_custom_generator_pairs():
    """Alternating generator pairs (cached verify-context churn) stay correct."""
    base = T.Parameters.new()
    k = T.Scalar(rand_scalar(np.random.default_rng(8)))
    custom = T.Parameters.with_generators(
        T.Ristretto255.scalar_mul(base.generator_g, k), base.generator_h)
    a, b = proof_row(base, 81, b"a"), proof_row(custom, 82, b"b")
    for row in (a, b, a, b):
        assert native_statuses([row]) == [1] == pure_statuses([row])


def test_cpu_backend_uses_native_rows():
    """BatchVerifier on the port's CpuBackend (native rows) against the JAX
    package's, mixed valid/invalid, and its verify_each against the pure
    twin, mixed generator pairs included."""
    rng = SeededRng(9)
    entries = []
    for pkg in (T, J):
        params = pkg.Parameters.new()
        out = []
        for _ in range(5):
            pr = pkg.Prover(params, pkg.Witness(pkg.Ristretto255.random_scalar(rng)))
            out.append((pr.statement, pr.prove_with_transcript(rng, pkg.Transcript())))
        entries.append((params, out))
    results = []
    for pkg, (params, proofs), backend in ((T, entries[0], T.CpuBackend()),
                                           (J, entries[1], JCpuBackend())):
        bv = pkg.BatchVerifier(backend=backend)
        for st, p in proofs:
            bv.add(params, st, p)
        bv.add(params, proofs[0][0], proofs[1][1])  # mismatched row
        results.append([None if r is None else (type(r).__name__, str(r))
                        for r in bv.verify(pkg.SecureRng())])
    assert results[0] == results[1]
    assert [r is None for r in results[0]] == [True] * 5 + [False]

    base = T.Parameters.new()
    custom = T.Parameters.with_generators(base.generator_h, base.generator_g)
    rows = []
    for i, params in enumerate([base, custom, base, custom]):
        g, h, y1, y2, r1, r2, s, c = proof_row(params, 90 + i)
        if i == 2:
            s = (int.from_bytes(s, "little") + 1).to_bytes(32, "little")
        rows.append(BatchRow(*(T.Element(wire=w) for w in (g, h, y1, y2, r1, r2)),
                             T.Scalar(int.from_bytes(s, "little")),
                             T.Scalar(int.from_bytes(c, "little")), T.Scalar(1)))
    assert T.CpuBackend().verify_each(rows) == [1, 1, 0, 1] == CpuBackend.verify_each_pure(rows)


def test_double_basemul_matches_python_oracle():
    """The constant-time comb is bit-exact against the Python ladder and
    the JAX package's comb, for the standard pair and a custom pair."""
    rng = np.random.default_rng(10)
    g, h = T.Ristretto255.generator_g(), T.Ristretto255.generator_h()
    cases = [rand_scalar(rng) for _ in range(8)]
    cases += [0, 1, 15, 16, 17, 255, L - 1, 2**252 + 27742]

    def check(gg, hh, v):
        r1, r2 = T.Ristretto255.double_base_mul(gg, hh, T.Scalar(v))
        assert r1.wire() == edwards.ristretto_encode(edwards.pt_scalar_mul(gg.point, v % L))
        assert r2.wire() == edwards.ristretto_encode(edwards.pt_scalar_mul(hh.point, v % L))
        if v % L:
            j = jnative.double_basemul(gg.wire(), hh.wire(), (v % L).to_bytes(32, "little"))
            assert (r1.wire(), r2.wire()) == j

    for v in cases:
        check(g, h, v)
    g2, h2 = T.Ristretto255.double_base_mul(g, h, T.Scalar(rand_scalar(rng)))
    s = rand_scalar(rng)
    check(g2, h2, s)  # tables rebuild for the new pair
    check(g, h, s)    # and back


def test_double_base_mul_never_falls_back(monkeypatch):
    """When the comb cannot serve a pair the call raises: no variable-time
    ladder runs instead."""
    g, h = T.Ristretto255.generator_g(), T.Ristretto255.generator_h()
    monkeypatch.setattr(_native, "double_basemul", lambda *a: None)
    monkeypatch.setattr(_native, "basemul_init", lambda *a: False)
    monkeypatch.setattr(edwards, "pt_scalar_mul", None)
    with pytest.raises(_native.NativeCoreError, match="fixed-base comb"):
        T.Ristretto255.double_base_mul(g, h, T.Scalar(5))


def test_double_base_mul_rebuilds_and_retries_once_after_a_comb_race(monkeypatch):
    """A comb read that lost a race with another thread's rebuild (None)
    is retried once after an explicit rebuild, still on the comb."""
    g, h = T.Ristretto255.generator_g(), T.Ristretto255.generator_h()
    real = _native.double_basemul
    calls = []

    def racy(*args):
        calls.append(args)
        return None if len(calls) == 1 else real(*args)

    monkeypatch.setattr(_native, "double_basemul", racy)
    r1, r2 = T.Ristretto255.double_base_mul(g, h, T.Scalar(12345))
    assert len(calls) == 2
    assert r1.wire() == edwards.ristretto_encode(edwards.pt_scalar_mul(g.point, 12345))
    assert r2.wire() == edwards.ristretto_encode(edwards.pt_scalar_mul(h.point, 12345))


def test_verify_rows_rejects_ragged_scalar_column():
    with pytest.raises(ValueError, match="multiple of 32"):
        _native.verify_rows(bytes(32), bytes(32), b"", b"", b"", b"", b"\x01" * 33, b"")


def test_double_basemul_concurrent_generator_churn():
    """Threads alternating generator pairs always get correct points (the C
    side serializes table rebuilds; ctypes releases the GIL)."""
    rng = np.random.default_rng(11)
    g, h = T.Ristretto255.generator_g(), T.Ristretto255.generator_h()
    g2, h2 = T.Ristretto255.double_base_mul(g, h, T.Scalar(rand_scalar(rng)))
    pairs = [(g, h), (g2, h2)]
    values = [rand_scalar(rng) for _ in range(8)]
    expected = {
        (p, v): (edwards.ristretto_encode(edwards.pt_scalar_mul(pairs[p][0].point, v)),
                 edwards.ristretto_encode(edwards.pt_scalar_mul(pairs[p][1].point, v)))
        for p in range(2) for v in values
    }
    failures: list[str] = []

    def worker(which: int) -> None:
        for i in range(20):
            p = (which + i) % 2
            v = values[i % len(values)]
            r1, r2 = T.Ristretto255.double_base_mul(*pairs[p], T.Scalar(v))
            if (r1.wire(), r2.wire()) != expected[(p, v)]:
                failures.append(f"thread {which} iter {i}")

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures
    assert jedwards.ristretto_encode(jedwards.BASEPOINT) == g.wire()
