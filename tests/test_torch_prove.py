"""The port's batch prover (:mod:`cpzk_tpu_torch.ops.prove`) on the CPU,
where the hand-written ``comb_tables`` and ``commitments`` kernels run their
plain PyTorch versions: twins of ``tests/test_batch_prove.py`` and of
``tests/test_chunking.py::test_chunked_batch_prover``, with the same seeded
witnesses, contexts and nonces through the JAX package's ``BatchProver``.

Tolerance: exact (comb tables limb for limb, statement and proof bytes;
proofs verify with the port's ``Verifier``)."""

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.ops import prove as jprove
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.observability import flightrec
from cpzk_tpu_torch.ops import backend
from cpzk_tpu_torch.ops.prove import BatchProver
import torch_reference_core


@pytest.fixture(autouse=True, scope="module")
def reference_core():
    """The reference's host core, built under a lock (see
    ``tests/torch_reference_core.py``) and loaded in this worker."""
    return torch_reference_core.require()


class SeededRng:
    """``SecureRng``'s interface on a seeded generator: the same nonces for
    both provers."""

    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


@pytest.fixture(scope="module")
def bp():
    return BatchProver(T.Parameters.new(), device="cpu")


@pytest.fixture(scope="module")
def jbp():
    return jprove.BatchProver(J.Parameters.new())


def witnesses(seed, n):
    rng = SeededRng(seed)
    return [T.Ristretto255.random_scalar(rng) for _ in range(n)]


def as_jax(ws):
    return [J.Scalar(w.value) for w in ws]


def statement(y1b, y2b):
    return T.Statement(T.Ristretto255.element_from_bytes(y1b),
                       T.Ristretto255.element_from_bytes(y2b))


def verify(params, st, wire, ctx):
    t = T.Transcript()
    if ctx is not None:
        t.append_context(ctx)
    T.Verifier(params, st).verify_with_transcript(T.Proof.from_bytes(wire), t)


def test_comb_tables_match_jax(bp, jbp):
    """convert.comb_tables of the JAX ``_comb_tables_kernel`` output equals
    the port's plain tables limb for limb, for G and for H."""
    for mine, theirs in ((bp._tg, jbp._tg), (bp._th, jbp._th)):
        ref = convert.comb_tables([np.asarray(c) for c in theirs], "cpu")
        assert all(torch.equal(a, b) for a, b in zip(mine, ref))
        assert mine[0].shape == (64, 16, 20, 1)


def test_statements_match_host(bp, jbp):
    ws = witnesses(1, 5)
    got = bp.statements(ws)
    for w, (y1b, y2b) in zip(ws, got):
        st = T.Statement.from_witness(bp.params, T.Witness(w))
        assert y1b == T.Ristretto255.element_to_bytes(st.y1)
        assert y2b == T.Ristretto255.element_to_bytes(st.y2)
    assert got == jbp.statements(as_jax(ws))


def test_batch_proofs_verify(bp, jbp):
    n = 6
    ws = witnesses(2, n)
    contexts = [None, b"ctx-1", b"ctx-2", None, b"ctx-4", b"ctx-5"]
    statements, proofs = bp.prove(ws, contexts, SeededRng(3))
    for ctx, (y1b, y2b), wire in zip(contexts, statements, proofs):
        assert len(wire) == 109
        verify(bp.params, statement(y1b, y2b), wire, ctx)
    # the JAX prover gives the same bytes for the same nonces
    assert (statements, proofs) == jbp.prove(as_jax(ws), contexts, SeededRng(3))
    # context binding: proof 0 must not verify under another context
    with pytest.raises(T.Error):
        verify(bp.params, statement(*statements[0]), proofs[0], b"ctx-1")


def test_precomputed_statements_path(bp, jbp):
    ws = witnesses(4, 3)
    statements = bp.statements(ws)
    st2, proofs = bp.prove(ws, None, SeededRng(5), statements=statements)
    assert st2 == statements
    for (y1b, y2b), wire in zip(st2, proofs):
        verify(bp.params, statement(y1b, y2b), wire, None)
    assert proofs == jbp.prove(as_jax(ws), None, SeededRng(5), statements=statements)[1]


def test_length_checks(bp):
    ws = witnesses(6, 2)
    with pytest.raises(ValueError, match="^contexts length mismatch$"):
        bp.prove(ws, [None], SeededRng(6))
    with pytest.raises(ValueError, match="^statements length mismatch$"):
        bp.prove(ws, None, SeededRng(6), statements=bp.statements(ws[:1]))


def test_chunked_batch_prover(bp, jbp, monkeypatch):
    """Past a (tiny) LANE_CHUNK the prover runs lane tiles and concatenates
    the byte columns: statements equal the host prover's, proofs verify,
    and the bytes equal the JAX prover's untiled ones."""
    monkeypatch.setattr(backend, "LANE_CHUNK", 8)
    n = 20
    ws = witnesses(7, n)
    ctxs = [b"chunk-ctx-%02d" % i for i in range(n)]
    statements, proofs = bp.prove(ws, ctxs, SeededRng(8))
    for (y1b, y2b), wire, ctx, w in zip(statements, proofs, ctxs, ws):
        expected = T.Statement.from_witness(bp.params, T.Witness(w))
        assert (y1b, y2b) == (expected.y1.wire(), expected.y2.wire())
        verify(bp.params, statement(y1b, y2b), wire, ctx)
    assert (statements, proofs) == jbp.prove(as_jax(ws), ctxs, SeededRng(8))


def test_prover_reports_its_device_interval(bp, monkeypatch):
    """Each walk of the tables reports the interval of its device work to
    an installed device sink, as the verifier backend does: twice for a
    ``prove()`` that computes the statements, once for one given them."""
    ws = witnesses(10, 3)
    calls = []
    real = flightrec.note_device
    monkeypatch.setattr(flightrec, "note_device",
                        lambda a, b: (calls.append((a, b)), real(a, b)))
    for statements, walks in ((None, 2), (bp.statements(ws), 1)):
        calls.clear()
        sink, token = flightrec.install_sink()
        try:
            bp.prove(ws, None, SeededRng(11), statements=statements)
        finally:
            flightrec.uninstall_sink(token)
        assert len(calls) == walks and all(a <= b for a, b in calls)
        assert sink.device_interval_s > 0.0
        assert (sink.device_start, sink.device_end) == (
            min(a for a, _ in calls), max(b for _, b in calls))


def test_sharded_prover_matches_one_device(bp, monkeypatch):
    """``BatchProver(mesh_devices=...)`` shards the statements over a mesh
    of CPU "devices" (the comb tables copied to each) and gives the
    one-device prover's bytes, ragged batch included; ``device=`` with a
    mesh raises, a mesh larger than the pool raises naming both numbers,
    and ``device=None`` means the card and raises without CUDA."""
    meshed = BatchProver(bp.params, mesh_devices=0, devices=["cpu"] * 3)
    assert len(meshed.mesh) == 3
    ws = witnesses(21, 5)
    assert meshed.statements(ws) == bp.statements(ws)
    with pytest.raises(ValueError, match="mesh"):
        BatchProver(T.Parameters.new(), mesh_devices=0, device="cpu")
    with pytest.raises(ValueError, match="mesh_devices=4 exceeds the 3 visible"):
        BatchProver(T.Parameters.new(), mesh_devices=4, devices=["cpu"] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchProver(T.Parameters.new())
