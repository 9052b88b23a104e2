"""Twins of ``tests/test_multihost.py`` for the port's multi-process job
(``cpzk_tpu_torch/parallel/multihost.py``): ``torch.distributed`` over
gloo, a global mesh over every rank's devices, and the sharded checks run
SPMD over replicated inputs, the per-slice partial points and row bits
all-gathered on the host.

- the single-process case: ``initialize`` is a no-op, the global mesh
  covers the given local devices (the reference's 8 host devices as 8 CPU
  "devices"), and it serves a ``TorchBackend`` verify and a
  ``BatchProver`` statement pass;
- a 2-rank gloo job at 6 rows in tier-1 (``chip_smoke.py``'s ``multihost``
  phase on CPU "devices"): both ranks accept the all-valid batch through
  the combined check and isolate one mismatched row through the per-row
  route, with the same verdicts;
- the reference's ``(2, 2)`` and ``(4, 1)`` multi-process cases, gated as
  the reference gates them.
"""

import os
import runpy
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cpzk_tpu as J

ROOT = Path(__file__).resolve().parent.parent

WORKER = r"""
import os, sys
import torch

torch.set_num_threads(1)
from cpzk_tpu_torch.parallel import multihost

multihost.initialize()  # CPZK_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID env

EXPECT_PC = int(os.environ["CPZK_TEST_EXPECT_PROCS"])
EXPECT_LOCAL = int(os.environ["CPZK_TEST_EXPECT_LOCAL"])

pi, pc = multihost.process_info()
assert pc == EXPECT_PC, f"expected {EXPECT_PC} processes, got {pc}"
mesh = multihost.global_batch_mesh(["cpu"] * EXPECT_LOCAL)
assert len(mesh) == EXPECT_PC * EXPECT_LOCAL, len(mesh)
assert len(mesh.local) == EXPECT_LOCAL

import hashlib


class StubRng:
    def __init__(self, seed: bytes):
        self.seed, self.n = seed, 0

    def fill_bytes(self, k: int) -> bytes:
        out = b""
        while len(out) < k:
            out += hashlib.sha256(self.seed + self.n.to_bytes(8, "little")).digest()
            self.n += 1
        return out[:k]


from cpzk_tpu_torch import BatchVerifier, Parameters, Prover, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.ops.backend import TorchBackend

rng = StubRng(b"multihost-test")
params = Parameters.new()
rows = []
for i in range(6):
    pr = Prover(params, Witness(Ristretto255.random_scalar(rng)))
    rows.append((pr.statement, pr.prove_with_transcript(rng, Transcript())))

backend = TorchBackend(mesh_devices=0, devices=mesh)
assert len(backend.mesh) == EXPECT_PC * EXPECT_LOCAL

bv = BatchVerifier(backend=backend)
for st, p in rows:
    bv.add(params, st, p)
assert bv.verify(rng) == [None] * 6

bv = BatchVerifier(backend=backend)
for st, p in rows:
    bv.add(params, st, p)
bv.add(params, rows[0][0], rows[1][1])
flags = [r is None for r in bv.verify(rng)]
assert flags == [True] * 6 + [False], flags

print(f"MULTIHOST_OK process={pi}/{pc} devices={len(mesh)}")
multihost.shutdown()
"""


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


@pytest.fixture(autouse=True, scope="module")
def comb_tables_once():
    """The two comb tables built once (the plain build takes seconds)."""
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


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_single_process_global_mesh_serves_backend_and_prover():
    """``multihost.initialize`` unconfigured is a no-op, not a latch;
    ``global_batch_mesh`` over the local devices feeds a sharded
    ``TorchBackend`` verify (context-bound proofs, accepted) and a sharded
    ``BatchProver`` statement pass equal to the JAX package's host
    arithmetic."""
    import jax

    import cpzk_tpu_torch as T
    from cpzk_tpu_torch.ops.backend import TorchBackend
    from cpzk_tpu_torch.ops.prove import BatchProver
    from cpzk_tpu_torch.parallel import multihost

    multihost.initialize()
    assert multihost.process_info() == (0, 1)
    mesh = multihost.global_batch_mesh(["cpu"] * jax.device_count())
    assert len(mesh) == jax.device_count() >= 1

    rng = SeededRng(31)
    params = T.Parameters.new()
    bv = T.BatchVerifier(backend=TorchBackend(mesh_devices=0, devices=mesh))
    witnesses = [T.Ristretto255.random_scalar(rng) for _ in range(3)]
    for w in witnesses:
        prover = T.Prover(params, T.Witness(w))
        t = T.Transcript()
        t.append_context(b"mh")
        bv.add_with_context(params, prover.statement, prover.prove_with_transcript(rng, t), b"mh")
    assert bv.verify(rng) == [None] * 3

    bp = BatchProver(params, mesh_devices=0, devices=mesh)
    g = J.Ristretto255.element_from_bytes(params.generator_g.wire())
    h = J.Ristretto255.element_from_bytes(params.generator_h.wire())
    for (y1b, y2b), w in zip(bp.statements(witnesses), witnesses):
        assert y1b == J.Ristretto255.element_to_bytes(J.Ristretto255.scalar_mul(g, J.Scalar(w.value)))
        assert y2b == J.Ristretto255.element_to_bytes(J.Ristretto255.scalar_mul(h, J.Scalar(w.value)))


def test_repeat_initialize_after_a_job_is_refused(monkeypatch):
    """A configured ``initialize`` after the job was formed raises, as the
    reference's does; an unconfigured one stays a no-op."""
    from cpzk_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "_initialized", True)
    for key in ("CPZK_COORDINATOR", "CPZK_NUM_PROCESSES", "CPZK_PROCESS_ID", "CPZK_MULTIHOST"):
        monkeypatch.delenv(key, raising=False)
    multihost.initialize()
    monkeypatch.setenv("CPZK_MULTIHOST", "1")
    with pytest.raises(RuntimeError, match="called again"):
        multihost.initialize()
    monkeypatch.setattr(multihost, "_initialized", False)
    with pytest.raises(ValueError, match="CPZK_COORDINATOR"):
        multihost.initialize()


def test_two_rank_gloo_job_at_six_rows(tmp_path, monkeypatch):
    """The cross-process gather in tier-1: ``chip_smoke.py``'s
    ``multihost`` phase on CPU "devices" (one per rank), 6 rows: both
    ranks exit 0 with a global mesh of 2, accept the all-valid batch and
    isolate the mismatched seventh row, with the same verdicts."""
    monkeypatch.chdir(tmp_path)
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke_rehearsal")
    out = smoke["multihost_phase"](6, corpus_n=4, local="cpu", timeout=120.0)
    assert out["exit_codes"] == [0, 0] and out["verdicts_equal_across_ranks"]
    assert [r["rank"] for r in out["ranks"]] == [0, 1]
    for rank in out["ranks"]:
        assert rank["world"] == 2 and rank["owners"] == [0, 1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.skipif(
    not os.environ.get("CPZK_SLOW_TESTS"),
    reason="set CPZK_SLOW_TESTS=1 (CI slow tier) — spawns a gloo multi-process "
    "job over CPU devices, ~1-2 min each",
)
@pytest.mark.parametrize("n_procs,local_devices", [(2, 2), (4, 1)])
def test_multi_process_distributed_sharded_verify(n_procs, local_devices):
    env_base = {k: v for k, v in os.environ.items() if not k.startswith("CPZK_")}
    env_base["PYTHONPATH"] = str(ROOT) + os.pathsep + env_base.get("PYTHONPATH", "")
    env_base["CPZK_COORDINATOR"] = f"127.0.0.1:{_free_port()}"
    env_base["CPZK_NUM_PROCESSES"] = str(n_procs)
    env_base["CPZK_TEST_EXPECT_PROCS"] = str(n_procs)
    env_base["CPZK_TEST_EXPECT_LOCAL"] = str(local_devices)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER], cwd=str(ROOT),
                              env=dict(env_base, CPZK_PROCESS_ID=str(pid)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for pid in range(n_procs)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err[-3000:]}"
        assert "MULTIHOST_OK" in out, out
