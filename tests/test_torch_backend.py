"""The whole slice: ``BatchVerifier(backend=TorchBackend(device="cpu"))``
against ``cpzk_tpu``'s ``BatchVerifier(backend=CpuBackend())`` on the
batches of tests/test_tpu_backend.py (all-valid, mixed, context-bound,
custom generators), plus a multi-chunk case forced through the
constructor's ``lane_chunk``.  Per-index results and error messages must be
identical.  On the CPU the port runs its kernels' plain versions."""

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.protocol.batch import CpuBackend as JaxCpuBackend
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.ops.backend import TorchBackend, _chunk_bounds, _pad_lanes


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module: its plain point and scalar
    arithmetic runs many small tensor ops, and a full thread team each,
    beside the test suite's other workers, oversubscribes the host's
    cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


@pytest.fixture(scope="module")
def backend():
    return TorchBackend(device="cpu")


def make_entries(seed, n, context=None, params=None):
    """n port-made (params, statement, proof) entries."""
    rng = SeededRng(seed)
    params = params or T.Parameters.new()
    entries = []
    for _ in range(n):
        prover = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng)))
        t = T.Transcript()
        if context is not None:
            t.append_context(context)
        entries.append((params, prover.statement, prover.prove_with_transcript(rng, t)))
    return entries


def to_jax(params, statement, proof):
    el = J.Ristretto255.element_from_bytes
    return (
        J.Parameters(el(params.generator_g.wire()), el(params.generator_h.wire())),
        J.Statement(el(statement.y1.wire()), el(statement.y2.wire())),
        J.Proof.from_bytes(proof.to_bytes()),
    )


def results_both(entries, torch_backend, context=None):
    """Per-index (error type, message) from the port on ``torch_backend``
    and from cpzk_tpu's CPU oracle, on the same entries."""
    tb = T.BatchVerifier(backend=torch_backend)
    jb = J.BatchVerifier(backend=JaxCpuBackend())
    for params, st, pr in entries:
        tb.add_with_context(params, st, pr, context)
        jb.add_with_context(*to_jax(params, st, pr), context)

    def text(results):
        return [None if r is None else (type(r).__name__, str(r)) for r in results]

    return text(tb.verify(T.SecureRng())), text(jb.verify(J.SecureRng()))


def test_combined_accepts_valid_batch(backend):
    port, ref = results_both(make_entries(21, 5), backend)
    assert port == ref == [None] * 5


def test_mixed_batch_matches_cpu_oracle(backend):
    entries = make_entries(22, 6)
    params = entries[2][0]
    wrong = T.Statement.from_witness(params, T.Witness(T.Scalar(123456789)))
    entries[2] = (params, wrong, entries[2][2])
    port, ref = results_both(entries, backend)
    assert port == ref
    assert [r is None for r in port] == [True, True, False, True, True, True]
    assert port[2] == ("InvalidParams", "Proof verification failed")


def test_context_bound_batch(backend):
    entries = make_entries(23, 4, context=b"batch-ctx")
    port, ref = results_both(entries, backend, context=b"batch-ctx")
    assert port == ref == [None] * 4
    # wrong context: every proof rejected, same as the CPU oracle
    port, ref = results_both(entries, backend, context=b"other-ctx")
    assert port == ref
    assert all(r is not None for r in port)


def test_custom_generators_batch(backend):
    rng = SeededRng(24)
    g = T.Ristretto255.scalar_mul(T.Ristretto255.generator_g(), T.Ristretto255.random_scalar(rng))
    h = T.Ristretto255.scalar_mul(T.Ristretto255.generator_h(), T.Ristretto255.random_scalar(rng))
    params = T.Parameters.with_generators(g, h)
    port, ref = results_both(make_entries(25, 3, params=params), backend)
    assert port == ref == [None] * 3


def test_multi_chunk_batch_matches_cpu_oracle():
    """lane_chunk=4 splits 6 rows (+1 correction row, 8 lanes) into two
    combined chunks and the fallback's verify_each into two as well."""
    small = TorchBackend(device="cpu", lane_chunk=4)
    assert list(_chunk_bounds(_pad_lanes(7, 4), 4)) == [(0, 4), (4, 8)]
    entries = make_entries(26, 6)
    port, ref = results_both(entries, small)
    assert port == ref == [None] * 6
    params, st, pr = entries[4]
    bad = T.Proof(pr.commitment, T.Response(T.Scalar(pr.response.s.value + 1)))
    entries[4] = (params, st, bad)
    port, ref = results_both(entries, small)
    assert port == ref
    assert [r is None for r in port] == [True] * 4 + [False, True]


def test_pad_schedule_and_constructor_checks():
    assert [_pad_lanes(n) for n in (1, 2, 3, 5, 2048, 2049, 4097, 16385)] == \
        [1, 2, 4, 8, 2048, 4096, 6144, 18432]
    assert list(_chunk_bounds(18432)) == [(0, 16384), (16384, 18432)]
    with pytest.raises(ValueError):
        TorchBackend(device="cpu", lane_chunk=3000)
    with pytest.raises(ValueError):
        TorchBackend(device="cpu", lane_chunk=0)


def test_gh_cache_is_lru_bounded(monkeypatch):
    from cpzk_tpu_torch.ops import backend as backend_mod

    monkeypatch.setattr(backend_mod, "GH_CACHE_MAX", 1)
    be = TorchBackend(device="cpu")
    rows_a = [_row(T.Parameters.new())]
    rng = SeededRng(27)
    g = T.Ristretto255.scalar_mul(T.Ristretto255.generator_g(), T.Ristretto255.random_scalar(rng))
    rows_b = [_row(T.Parameters.with_generators(g, T.Ristretto255.generator_h()))]
    pa = be._gh(rows_a[0])
    assert be._gh(rows_a[0]) is pa
    be._gh(rows_b[0])
    assert len(be._gh_cache) == 1
    assert be._gh(rows_a[0]) is not pa
    g_pt = convert.to_numpy(pa[0])
    assert g_pt[0].shape == (20, 1)


def _row(params):
    from cpzk_tpu_torch.protocol.batch import BatchRow

    e = T.Ristretto255.identity()
    s = T.Scalar(1)
    return BatchRow(params.generator_g, params.generator_h, e, e, e, e, s, s, s)


def test_gh_cache_lru_bounded_telemetry():
    """Twin of ``tests/test_flightrec.py::test_gh_cache_lru_bounded``: the
    same four generator pairs through the JAX ``TpuBackend(gh_cache_max=2)``
    and ``TorchBackend(gh_cache_max=2)``: the same cache size, the same
    ``tpu.gh_cache.size`` gauge and ``tpu.gh_cache.evictions`` counts (each
    in its own package's metrics), the same LRU order after re-touches."""
    from cpzk_tpu.ops.backend import TpuBackend
    from cpzk_tpu.protocol.batch import BatchRow as JBatchRow
    from cpzk_tpu.server import metrics as jmetrics
    from cpzk_tpu_torch.protocol.batch import BatchRow
    from cpzk_tpu_torch.server import metrics as tmetrics

    rng = SeededRng(29)
    wires = []
    for _ in range(4):
        st = J.Prover(J.Parameters.new(), J.Witness(J.Ristretto255.random_scalar(rng))).statement
        wires.append((J.Ristretto255.element_to_bytes(st.y1),
                       J.Ristretto255.element_to_bytes(st.y2)))

    def rows(pkg, Row):
        R = pkg.Ristretto255
        s = pkg.Scalar(1)
        out = []
        for y1, y2 in wires:  # any two distinct valid elements form a pair
            g, h = R.element_from_bytes(y1), R.element_from_bytes(y2)
            out.append(Row(g=g, h=h, y1=g, y2=h, r1=g, r2=h, s=s, c=s, alpha=s))
        return out

    def drive(backend, metrics, rs):
        ev0 = metrics.read("tpu.gh_cache.evictions")
        seen = []
        for row in rs:
            backend._gh(row)
            seen.append((len(backend._gh_cache), metrics.read("tpu.gh_cache.size", "g"),
                         metrics.read("tpu.gh_cache.evictions") - ev0))
        backend._gh(rs[2])  # re-touching promotes
        backend._gh(rs[0])  # re-marshalled (it was evicted): evicts rows[3]'s pair
        seen.append(list(backend._gh_cache))
        seen.append(metrics.read("tpu.gh_cache.evictions") - ev0)
        return seen

    ref = drive(TpuBackend(gh_cache_max=2), jmetrics, rows(J, JBatchRow))
    port = drive(TorchBackend(device="cpu", gh_cache_max=2), tmetrics, rows(T, BatchRow))
    assert port == ref
    assert port[:4] == [(1, 1.0, 0.0), (2, 2.0, 0.0), (2, 2.0, 1.0), (2, 2.0, 2.0)]
    assert port[4] == [wires[2], wires[0]]
    assert port[5] == 3.0


# -- the Pippenger route and the device scalar plane, across lane chunks ------
# Twins of the Pippenger and device-RLC cases of tests/test_chunking.py,
# chunked through the constructor's ``lane_chunk`` (no module reload).

def test_pippenger_min_defaults_to_the_reference_value(monkeypatch):
    from cpzk_tpu_torch.ops import backend as backend_mod

    assert backend_mod.PIPPENGER_MIN_ROWS == 1 << 62  # never, as the reference
    assert TorchBackend(device="cpu").pippenger_min == 1 << 62
    monkeypatch.setattr(backend_mod, "PIPPENGER_MIN_ROWS", 3)
    assert TorchBackend(device="cpu").pippenger_min == 3
    assert TorchBackend(device="cpu", pippenger_min=7).pippenger_min == 7


def test_chunked_pippenger_accepts_valid_batch():
    # m = 4 * pad_pow2(20) + 2 = 130 terms -> 5 chunks of 32 through msm_kernel
    be = TorchBackend(device="cpu", lane_chunk=32, pippenger_min=2)
    port, ref = results_both(make_entries(41, 20), be)
    assert port == ref == [None] * 20


def test_chunked_pippenger_mixed_matches_oracle():
    entries = make_entries(42, 12)
    params = entries[3][0]
    wrong = T.Statement.from_witness(params, T.Witness(T.Scalar(987654321)))
    entries[3] = (params, wrong, entries[3][2])
    be = TorchBackend(device="cpu", lane_chunk=32, pippenger_min=2)
    port, ref = results_both(entries, be)
    assert port == ref
    assert [r is None for r in port] == [i != 3 for i in range(12)]


def test_chunked_pippenger_device_rlc(monkeypatch):
    monkeypatch.setenv("CPZK_DEVICE_RLC", "1")
    be = TorchBackend(device="cpu", lane_chunk=32, pippenger_min=2)
    port, ref = results_both(make_entries(43, 10), be)
    assert port == ref == [None] * 10


def test_chunked_rowcombined_device_rlc(monkeypatch):
    """Device-RLC windows are built full-width (correction spliced at lane
    n, possibly inside a middle chunk) and then chunk-sliced: the layout
    must survive the tiling."""
    monkeypatch.setenv("CPZK_DEVICE_RLC", "1")
    be = TorchBackend(device="cpu", lane_chunk=8)
    port, ref = results_both(make_entries(44, 20), be)  # lane 20: chunk 3 of 3
    assert port == ref == [None] * 20
    port, ref = results_both(make_entries(45, 11), be)  # lane 11: chunk 2 of 2
    assert port == ref == [None] * 11
