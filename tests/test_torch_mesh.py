"""The port's sharded paths (``cpzk_tpu_torch/parallel/mesh.py``, the mesh
routes of ``TorchBackend`` and ``BatchProver``) against the JAX package's.

Twins of ``tests/test_flightrec.py``'s mesh cases, ``tests/test_chunking.py``'s
``test_mesh_chunked_prove`` and ``test_mesh_chunked_paths``,
``tests/test_ops_sclimbs.py::test_device_rlc_composes_with_sharded_msm``,
``tests/test_batch_prove.py::test_sharded_batch_prove_matches_single_device``
and ``tests/test_serving_tpu.py``'s global-mesh case.  The port's mesh is
an explicit list of CPU "devices" (the kernels' plain versions, one thread
per slice); the JAX package's is its 8 forced host devices
(``tests/conftest.py``).  The port's verdicts are the JAX package's
oracle's, its statement bytes the JAX package's host arithmetic's and its
sharded prover's; ``tests/test_torch_mesh_twins.py`` holds each sharded
function against the JAX package's on the same inputs.  Every slice is
small: the plain versions pay per operation, not per lane.
"""

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.ops import backend as jbackend
from cpzk_tpu.ops import prove as jprove
from cpzk_tpu.parallel import mesh as jmesh
from cpzk_tpu.protocol.batch import BatchRow as JBatchRow
from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend
from cpzk_tpu_torch.ops import backend as tbackend
from cpzk_tpu_torch.ops import msm as tmsm
from cpzk_tpu_torch.ops.backend import TorchBackend
from cpzk_tpu_torch.ops.prove import BatchProver
from cpzk_tpu_torch.parallel import mesh as tmesh
from cpzk_tpu_torch.server import metrics

CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def comb_tables_once():
    """Each generator's comb table built once for the module: the plain
    build takes seconds, and every prover here uses the same two."""
    from cpzk_tpu_torch.ops import prove as tprove

    build = tprove.prove_kernels.comb_tables
    memo = {}

    def cached(p):
        key = tuple(c.numpy().tobytes() for c in p)
        if key not in memo:
            memo[key] = build(p)
        return memo[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tprove.prove_kernels, "comb_tables", cached)
        yield


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def make_entries(seed, n):
    """n port-made (params, statement, proof) entries."""
    rng = SeededRng(seed)
    params = T.Parameters.new()
    out = []
    for _ in range(n):
        prover = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng)))
        out.append((params, prover.statement, prover.prove_with_transcript(rng, T.Transcript())))
    return out


def wrong_statement(entries, i, seed=99):
    params, _, proof = entries[i]
    other = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(SeededRng(seed))))
    entries[i] = (params, other.statement, proof)


def results(backend, entries):
    bv = T.BatchVerifier(backend=backend)
    for p, st, pr in entries:
        bv.add(p, st, pr)
    return [r is None for r in bv.verify(T.SecureRng())]


def oracle(entries):
    """Per-entry verdicts of the JAX package's host oracle."""
    el = J.Ristretto255.element_from_bytes
    bv = J.BatchVerifier(backend=JCpuBackend())
    for p, st, pr in entries:
        bv.add(J.Parameters(el(p.generator_g.wire()), el(p.generator_h.wire())),
               J.Statement(el(st.y1.wire()), el(st.y2.wire())),
               J.Proof.from_bytes(pr.to_bytes()))
    return [r is None for r in bv.verify(J.SecureRng())]


def to_jax_row(row):
    el = J.Ristretto255.element_from_bytes
    return JBatchRow(g=el(row.g.wire()), h=el(row.h.wire()), y1=el(row.y1.wire()),
                     y2=el(row.y2.wire()), r1=el(row.r1.wire()), r2=el(row.r2.wire()),
                     s=J.Scalar(row.s.value), c=J.Scalar(row.c.value),
                     alpha=J.Scalar(row.alpha.value))


# --- twins of test_flightrec.py's mesh cases ------------------------------------------


def test_mesh_step_pads_to_d_multiple(monkeypatch):
    """``_mesh_step`` is the reference's schedule, case for case: a
    d-multiple below one step, quantum-aligned device shares past it, and
    the occupancy gauge."""
    for module in (tbackend, jbackend):
        monkeypatch.setattr(module, "LANE_CHUNK", 8)
        monkeypatch.setattr(module, "LANE_QUANTUM", 2)
    assert tmesh._mesh_step(8, 72) == (64, 80)
    assert metrics.read("tpu.batch.occupancy", "g") == pytest.approx(72 / 80)
    for d in (1, 2, 3, 8):
        for n in (1, 5, 16, 40, 41, 64, 65, 72, 200):
            assert tmesh._mesh_step(d, n) == jmesh._mesh_step(d, n), (d, n)


def test_mesh_remainder_slice_matches_oracle(monkeypatch):
    """Over-cap mesh per-row check with a short (d-multiple) remainder
    slice on two CPU "devices" (the route a failed combined check takes):
    the JAX package's verdicts, and the occupancy gauge shows the
    reclaimed lanes (18 rows on 20 mesh lanes, not 32)."""
    monkeypatch.setattr(tbackend, "LANE_CHUNK", 8)
    monkeypatch.setattr(tbackend, "LANE_QUANTUM", 2)
    entries = make_entries(11, 18)
    wrong_statement(entries, 11)
    backend = TorchBackend(mesh_devices=0, devices=CPU2)
    assert len(backend.mesh) == 2
    expect = oracle(entries)
    assert expect == [i != 11 for i in range(18)]
    bv = T.BatchVerifier(backend=T.CpuBackend())
    for p, st, pr in entries:
        bv.add(p, st, pr)
    assert backend.verify_each(bv.prepare_rows(SeededRng(17))) == expect
    # 18 rows pad to 18 lanes (the patched quantum), then to two passes of
    # the mesh: 16 lanes, then a remainder of 4 (a d-multiple)
    assert metrics.read("tpu.batch.occupancy", "g") == pytest.approx(18 / 20)


# --- twins of test_chunking.py's mesh cases --------------------------------------------


def test_mesh_chunked_prove(monkeypatch):
    """The sharded prover's over-cap slicing (n > d * LANE_CHUNK) emits
    the statement bytes of the JAX package's host arithmetic."""
    monkeypatch.setattr(tbackend, "LANE_CHUNK", 4)
    params = T.Parameters.new()
    sharded = BatchProver(params, mesh_devices=0, devices=CPU2)
    ws = [T.Ristretto255.random_scalar(SeededRng(12)) for _ in range(10)]  # step 8
    g = J.Ristretto255.element_from_bytes(params.generator_g.wire())
    h = J.Ristretto255.element_from_bytes(params.generator_h.wire())
    want = [(J.Ristretto255.element_to_bytes(J.Ristretto255.scalar_mul(g, J.Scalar(w.value))),
             J.Ristretto255.element_to_bytes(J.Ristretto255.scalar_mul(h, J.Scalar(w.value))))
            for w in ws]
    assert sharded.statements(ws) == want


def test_mesh_chunked_paths(monkeypatch):
    """The sharded MSM splits into passes of d * LANE_CHUNK terms (5 valid
    rows: 34 terms, padded to 48, two passes) and accepts; with a wrong
    row the verdicts are the JAX package's."""
    monkeypatch.setattr(tbackend, "LANE_CHUNK", 16)
    entries = make_entries(13, 5)
    backend = TorchBackend(mesh_devices=0, devices=CPU2)
    calls = []
    msm_kernel = tmsm.msm_kernel
    monkeypatch.setattr(tmsm, "msm_kernel",
                        lambda p, d, c: calls.append(d.shape[-1]) or msm_kernel(p, d, c))
    assert results(backend, entries) == [True] * 5
    assert calls == [16] * 4
    wrong_statement(entries, 3)
    expect = oracle(entries)
    assert expect == [i != 3 for i in range(5)]
    assert results(backend, entries) == expect


# --- the device scalar plane, the sharded prover, the global mesh -----------------


def test_device_rlc_composes_with_sharded_msm(monkeypatch):
    """``CPZK_DEVICE_RLC=1`` digits (the scalar kernels' plain versions
    on the mesh's first device) feed the sharded MSM unchanged: valid
    rows accept, a mismatched row is isolated as by the JAX oracle."""
    monkeypatch.setenv("CPZK_DEVICE_RLC", "1")
    entries = make_entries(14, 5)
    backend = TorchBackend(mesh_devices=0, devices=CPU2)
    assert backend._sharded_msm is not None
    assert results(backend, entries) == [True] * 5
    params, st, _ = entries[0]
    entries.append((params, st, entries[1][2]))
    assert results(backend, entries) == oracle(entries) == [True] * 5 + [False]


def test_sharded_batch_prove_matches_single_device():
    """DP-sharded proving over three CPU "devices" (a ragged batch): the
    one-device prover's and the JAX package's sharded prover's (over three
    of its host devices) statement bytes; the sharded instance's proofs
    verify on the JAX host verifier."""
    import jax

    params = T.Parameters.new()
    ws = [T.Ristretto255.random_scalar(SeededRng(15)) for _ in range(11)]
    sharded = BatchProver(params, mesh_devices=0, devices=["cpu"] * 3)
    single = BatchProver(params, device="cpu")
    got = sharded.statements(ws)
    assert got == single.statements(ws)
    jsharded = jprove.BatchProver(J.Parameters.new(), mesh_devices=min(3, jax.device_count()))
    assert jsharded._sharded is not None
    assert got == jsharded.statements([J.Scalar(w.value) for w in ws])
    statements, proofs = sharded.prove(ws, None, SeededRng(16))
    for (y1b, y2b), wire in zip(statements, proofs):
        st = J.Statement(J.Ristretto255.element_from_bytes(y1b),
                         J.Ristretto255.element_from_bytes(y2b))
        J.Verifier(J.Parameters.new(), st).verify_with_transcript(
            J.Proof.from_bytes(wire), J.Transcript())


def test_multihost_single_process_global_mesh():
    """``multihost.initialize`` is a no-op for a single-process job, and
    the global mesh covers every local device given (the reference's 8
    host devices as 8 CPU "devices"), as the JAX package's covers its."""
    import jax

    from cpzk_tpu.parallel import multihost as jmultihost
    from cpzk_tpu_torch.parallel import multihost

    multihost.initialize()
    jmultihost.initialize()
    assert multihost.process_info() == jmultihost.process_info() == (0, 1)
    mesh = multihost.global_batch_mesh(["cpu"] * jax.device_count())
    assert len(mesh) == jmultihost.global_batch_mesh().devices.size == jax.device_count()
    assert mesh.world == 1 and mesh.local == list(range(len(mesh)))
