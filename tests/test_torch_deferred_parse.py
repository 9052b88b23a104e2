"""Deferred proof parsing in the port: the fast parse postpones the two
commitment point decodes to the batch-verify stage, and must be
observationally identical to eager parsing — the same accept/reject set and
the same error types and messages — as in the JAX package.  Twins of the
non-gRPC cases of ``test_deferred_parse.py``.

Tolerance: exact (error types and messages, wire bytes)."""

import numpy as np
import pytest

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.protocol.batch import BatchVerifier as JBatchVerifier
from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend
from cpzk_tpu.protocol.gadgets import Proof as JProof
from cpzk_tpu_torch.protocol.gadgets import PROOF_WIRE_SIZE
import torch_reference_core


@pytest.fixture(autouse=True, scope="module")
def reference_core():
    """The reference's host core, built under a lock (see
    ``tests/torch_reference_core.py``) and loaded in this worker."""
    return torch_reference_core.require()


BAD_POINT_MSG = "Bytes do not represent a valid Ristretto point"
L = 2**252 + 27742317777372353535851937790883648493


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def proof_corpus():
    """One valid wire plus every malformed family the parser rejects."""
    rng = SeededRng(31)
    params = T.Parameters.new()
    prover = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng)))
    t = T.Transcript()
    t.append_context(b"ctx")
    wire = prover.prove_with_transcript(rng, t).to_bytes()
    assert len(wire) == PROOF_WIRE_SIZE
    return [
        wire,
        wire[:50],                                  # truncated
        b"",                                        # empty
        b"\x02" + wire[1:],                         # bad version
        wire[:5] + bytes(32) + wire[37:],           # identity r1
        wire[:41] + bytes(32) + wire[73:],          # identity r2
        wire[:5] + b"\xff" * 32 + wire[37:],        # invalid r1 point
        wire[:41] + b"\xff" * 32 + wire[73:],       # invalid r2 point
        wire[:77] + bytes(32),                      # zero scalar
        wire[:77] + L.to_bytes(32, "little"),       # non-canonical scalar (= l)
        wire + b"\x00",                             # trailing byte
        wire[:1] + b"\x00\x00\x00\x21" + wire[5:],  # wrong length field
    ]


def outcome(parse, item):
    try:
        parse(item)
        return "OK"
    except (T.Error, J.Error) as e:
        return f"{type(e).__name__}: {e}"


def as_text(got):
    return "OK" if isinstance(got, (T.Proof, JProof)) else f"{type(got).__name__}: {got}"


def test_from_bytes_batch_eager_differential():
    corpus = proof_corpus()
    port = T.Proof.from_bytes_batch(corpus)
    jax = JProof.from_bytes_batch(corpus)
    for got, jgot, item in zip(port, jax, corpus):
        want = outcome(T.Proof.from_bytes, item)
        assert want == outcome(T.Proof.from_bytes_pure, item) == outcome(JProof.from_bytes, item)
        assert as_text(got) == as_text(jgot) == want
        if isinstance(got, T.Proof):
            assert not got.deferred
            assert got.to_bytes() == item == jgot.to_bytes()
    assert [as_text(p) for p in T.Proof.from_bytes_batch([corpus[0]] * 3)] == ["OK"] * 3


def test_from_bytes_batch_deferred_differential():
    """Deferred: only point-decode failures may surface later (as a deferred
    Proof); every other malformation errors here as the eager parse does."""
    corpus = proof_corpus()
    port = T.Proof.from_bytes_batch(corpus, defer_point_validation=True)
    jax = JProof.from_bytes_batch(corpus, defer_point_validation=True)
    for got, jgot, item in zip(port, jax, corpus):
        want = outcome(T.Proof.from_bytes_pure, item)
        assert as_text(got) == as_text(jgot)
        if isinstance(got, T.Proof):
            assert got.deferred == jgot.deferred
            assert got.to_bytes() == item
            if want != "OK":  # postponed decode failure, settled at verify
                assert BAD_POINT_MSG in want
                assert got.deferred
        else:
            assert as_text(got) == want


def entries_for(pkg, n, seed):
    """n independent (params, statement, proof wire, context) entries."""
    rng = SeededRng(seed)
    params = pkg.Parameters.new()
    out = []
    for i in range(n):
        prover = pkg.Prover(params, pkg.Witness(pkg.Ristretto255.random_scalar(rng)))
        ctx = b"ctx-%d" % i
        t = pkg.Transcript()
        t.append_context(ctx)
        out.append((params, prover.statement, prover.prove_with_transcript(rng, t).to_bytes(), ctx))
    return out


def test_batch_verifier_settles_deferred_rows():
    """Multi-row: valid deferred rows pass, an undecodable commitment wire
    maps to the exact parse error, a wrong-context row is a plain failure —
    on the port's CpuBackend (tri-state rows) as on the JAX package's."""
    results = []
    for pkg, proof_cls, bv in ((T, T.Proof, T.BatchVerifier(backend=T.CpuBackend())),
                               (J, JProof, JBatchVerifier(backend=JCpuBackend()))):
        entries = entries_for(pkg, 4, 32)
        wires = [w for _, _, w, _ in entries]
        wires[1] = wires[1][:5] + b"\xff" * 32 + wires[1][37:]  # bad r1 point
        parsed = proof_cls.from_bytes_batch(wires, defer_point_validation=True)
        assert all(isinstance(p, proof_cls) and p.deferred for p in parsed)
        for (params, stmt, _, ctx), proof in zip(entries, parsed):
            bv.add_with_context(params, stmt, proof, b"wrong" if ctx == b"ctx-3" else ctx)
        results.append([None if r is None else (type(r).__name__, str(r))
                        for r in bv.verify(pkg.SecureRng())])
    assert results[0] == results[1]
    assert results[0][0] is None and results[0][2] is None
    assert results[0][1] == ("InvalidProofEncoding", BAD_POINT_MSG)
    assert results[0][3] == ("InvalidParams", "Proof verification failed")


def test_batch_verifier_single_deferred_row():
    """n == 1 screens eagerly: a bad wire errors with the parse error, a
    good one verifies through the single-proof path."""
    (params, stmt, wire, ctx), = entries_for(T, 1, 33)
    good, = T.Proof.from_bytes_batch([wire], defer_point_validation=True)
    bv = T.BatchVerifier(backend=T.CpuBackend())
    bv.add_with_context(params, stmt, good, ctx)
    assert bv.verify(T.SecureRng()) == [None]

    bad_wire = wire[:41] + b"\xff" * 32 + wire[73:]
    for pkg, proof_cls, bv in ((T, T.Proof, T.BatchVerifier(backend=T.CpuBackend())),
                               (J, JProof, JBatchVerifier(backend=JCpuBackend()))):
        bad, = proof_cls.from_bytes_batch([bad_wire], defer_point_validation=True)
        assert isinstance(bad, proof_cls) and bad.deferred
        jstmt = stmt if pkg is T else J.Statement(
            J.Ristretto255.element_from_bytes(stmt.y1.wire()),
            J.Ristretto255.element_from_bytes(stmt.y2.wire()))
        bv.add_with_context(params if pkg is T else J.Parameters.new(), jstmt, bad, ctx)
        res, = bv.verify(pkg.SecureRng())
        assert type(res).__name__ == "InvalidProofEncoding" and str(res) == BAD_POINT_MSG
    # the single-proof verifier reports a deferred undecodable wire the same way
    bad, = T.Proof.from_bytes_batch([bad_wire], defer_point_validation=True)
    t = T.Transcript()
    t.append_context(ctx)
    for verify in (lambda: T.Verifier(params, stmt).verify_with_transcript(bad, t),
                   lambda: T.Verifier(params, stmt).verify_pure(bad, ctx)):
        try:
            verify()
            raise AssertionError("an undecodable commitment verified")
        except T.InvalidProofEncoding as e:
            assert str(e) == BAD_POINT_MSG
