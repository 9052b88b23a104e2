"""The port's serving plane (``cpzk_tpu_torch.server``): twins of the
non-gRPC cases of ``tests/test_serving_tpu.py`` — the dynamic batching
queue, the card-to-host failover and the double-buffered dispatch lane —
plus ``build_backend`` and one parity run of 48 seeded entries through the
JAX package's serving plane and the port's.

Tolerance everywhere: exact (accept sets, error types and messages)."""

import asyncio
import threading

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.ops.backend import TpuBackend as JTpuBackend
from cpzk_tpu.protocol.batch import BatchEntry as JBatchEntry
from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend
from cpzk_tpu.protocol.batch import FailoverBackend as JFailoverBackend
from cpzk_tpu.protocol.gadgets import Proof as JProof
from cpzk_tpu.server.batching import DynamicBatcher as JDynamicBatcher
from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.errors import InvalidParams
from cpzk_tpu_torch.observability import get_flight_recorder, get_tracer
from cpzk_tpu_torch.ops import point_kernels
from cpzk_tpu_torch.ops.backend import TorchBackend
from cpzk_tpu_torch.protocol.batch import (
    BatchEntry,
    BatchVerifier,
    CpuBackend,
    FailoverBackend,
    VerifierBackend,
)
from cpzk_tpu_torch.protocol.gadgets import Proof
from cpzk_tpu_torch.server import TpuSettings, build_backend, metrics
from cpzk_tpu_torch.server.batching import DynamicBatcher, QueueFull

STOP_TIMEOUT_S = 60.0


def run(coro):
    return asyncio.run(coro)


async def stop(batcher) -> None:
    await asyncio.wait_for(batcher.stop(), STOP_TIMEOUT_S)


@pytest.fixture(autouse=True)
def _lane_threads_joined():
    """Every lane thread a test starts is gone when it ends."""
    get_tracer().clear()
    get_flight_recorder().clear()
    yield
    for t in threading.enumerate():
        if t.name.startswith("cpzk-lane"):
            t.join(10.0)
            assert not t.is_alive(), f"lane thread {t.name} leaked"


def make_proofs(n, params=None, rng=None):
    rng = rng or SecureRng()
    params = params or Parameters.new()
    out = []
    for _ in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        proof = prover.prove_with_transcript(rng, Transcript())
        out.append((prover.statement, proof))
    return params, out


class RecordingBatcher(DynamicBatcher):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.dispatched_sizes = []

    async def _dispatch(self, take):
        self.dispatched_sizes.append(len(take))
        await super()._dispatch(take)


class BrokenBackend(VerifierBackend):
    """Fault injection: always blows up (simulated device loss)."""

    prefers_combined = True

    def __init__(self):
        self.calls = 0

    def verify_combined(self, rows, beta):
        self.calls += 1
        raise RuntimeError("injected device failure")

    def verify_each(self, rows):
        self.calls += 1
        raise RuntimeError("injected device failure")


# --- DynamicBatcher unit behavior ------------------------------------------


def test_batcher_coalesces_concurrent_submissions():
    params, proofs = make_proofs(6)

    async def main():
        batcher = RecordingBatcher(CpuBackend(), max_batch=64, window_ms=20.0)
        batcher.start()
        try:
            results = await asyncio.gather(
                *[batcher.submit(params, st, pr, None) for st, pr in proofs]
            )
        finally:
            await stop(batcher)
        return batcher, results

    batcher, results = run(main())
    assert results == [None] * 6
    # all six landed in one device batch (20ms window >> submission skew)
    assert batcher.dispatched_sizes == [6]


def test_batcher_flags_invalid_entry_per_index():
    params, proofs = make_proofs(3)

    async def main():
        batcher = DynamicBatcher(CpuBackend(), max_batch=64, window_ms=5.0)
        batcher.start()
        try:
            coros = [batcher.submit(params, st, pr, None) for st, pr in proofs]
            # statement/proof mismatch -> must fail at its index only
            coros.append(batcher.submit(params, proofs[0][0], proofs[1][1], None))
            return await asyncio.gather(*coros)
        finally:
            await stop(batcher)

    results = run(main())
    assert [r is None for r in results] == [True, True, True, False]
    assert (type(results[3]), str(results[3])) == (
        InvalidParams, "Proof verification failed")


def test_batcher_respects_max_batch():
    params, proofs = make_proofs(5)

    async def main():
        batcher = RecordingBatcher(CpuBackend(), max_batch=2, window_ms=5.0)
        batcher.start()
        try:
            results = await asyncio.gather(
                *[batcher.submit(params, st, pr, None) for st, pr in proofs]
            )
        finally:
            await stop(batcher)
        return batcher, results

    batcher, results = run(main())
    assert results == [None] * 5
    assert all(s <= 2 for s in batcher.dispatched_sizes)
    assert sum(batcher.dispatched_sizes) == 5


def test_batcher_sheds_load_at_max_queue():
    """Backpressure: submissions beyond max_queue raise QueueFull instead
    of growing the queue without bound."""
    params, proofs = make_proofs(1)
    st, pr = proofs[0]

    async def main():
        batcher = DynamicBatcher(
            CpuBackend(), max_batch=64, window_ms=5_000.0, max_queue=3
        )
        batcher.start()
        try:
            pending = [
                asyncio.ensure_future(batcher.submit(params, st, pr, None))
                for _ in range(3)
            ]
            await asyncio.sleep(0.05)  # let the 3 land in the queue
            with pytest.raises(QueueFull):
                await batcher.submit(params, st, pr, None)
        finally:
            await stop(batcher)  # drains the 3 queued entries
        return await asyncio.gather(*pending)

    assert run(main()) == [None] * 3


def test_batcher_drains_on_stop():
    params, proofs = make_proofs(2)

    async def main():
        batcher = DynamicBatcher(CpuBackend(), max_batch=64, window_ms=5000.0)
        batcher.start()
        try:
            coros = [
                asyncio.ensure_future(batcher.submit(params, st, pr, None))
                for st, pr in proofs
            ]
            await asyncio.sleep(0)  # let submissions enqueue
        finally:
            await stop(batcher)  # must not wait the 5s window
        return await asyncio.gather(*coros)

    assert run(main()) == [None, None]


# --- failover ---------------------------------------------------------------


def test_failover_backend_degrades_to_cpu():
    params, proofs = make_proofs(4)
    broken = BrokenBackend()
    backend = FailoverBackend(broken, CpuBackend())
    rng = SecureRng()

    bv = BatchVerifier(backend=backend)
    for st, pr in proofs:
        bv.add(params, st, pr)
    assert bv.verify(rng) == [None] * 4
    assert backend.degraded
    assert broken.calls == 1  # first failure degrades (default cooldown 30s)

    # subsequent batches never touch the broken primary again
    bv2 = BatchVerifier(backend=backend)
    for st, pr in proofs:
        bv2.add(params, st, pr)
    assert bv2.verify(rng) == [None] * 4
    assert broken.calls == 1

    backend.reset()
    assert not backend.degraded


def test_failover_mid_each_path():
    """Primary dies in verify_each (combined already skipped): fallback
    still returns per-proof ground truth."""

    class EachOnlyBroken(BrokenBackend):
        prefers_combined = False

    params, proofs = make_proofs(2)
    backend = FailoverBackend(EachOnlyBroken(), CpuBackend())
    bv = BatchVerifier(backend=backend)
    bv.add(params, proofs[0][0], proofs[0][1])
    bv.add(params, proofs[0][0], proofs[1][1])  # mismatched -> invalid
    res = bv.verify(SecureRng())
    assert res[0] is None and res[1] is not None
    assert backend.degraded


def test_failover_through_batcher():
    params, proofs = make_proofs(3)
    backend = FailoverBackend(BrokenBackend(), CpuBackend())

    async def main():
        batcher = DynamicBatcher(backend, max_batch=64, window_ms=5.0)
        batcher.start()
        try:
            return await asyncio.gather(
                *[batcher.submit(params, st, pr, None) for st, pr in proofs]
            )
        finally:
            await stop(batcher)

    assert run(main()) == [None] * 3
    assert backend.degraded


def test_batcher_overlaps_host_prep_with_device_compute():
    """Double-buffering through the dispatch lane: while batch 1 is
    blocked inside the backend on the device thread, batch 2's host prep
    completes on the prep thread and the prepared batch waits in the
    lane's staging slot."""
    release = threading.Event()
    entered = threading.Event()

    class SlowBackend(VerifierBackend):
        prefers_combined = False

        def verify_combined(self, rows, beta):  # pragma: no cover
            raise AssertionError("unused")

        def verify_each(self, rows):
            entered.set()
            release.wait(5.0)
            return [True] * len(rows)

    params, proofs = make_proofs(4)

    async def main():
        batcher = DynamicBatcher(
            SlowBackend(), max_batch=2, window_ms=1.0, pipeline_depth=2
        )
        batcher.start()
        try:
            coros = [batcher.submit(params, st, pr, None) for st, pr in proofs]
            fut = asyncio.gather(*coros)
            # asserted BEFORE release.set(): under a serial lane, batch 2
            # would never be prepared while batch 1 blocks in the backend
            staged = False
            for _ in range(200):
                if entered.is_set() and batcher._lane.depths()[1] >= 1:
                    staged = True
                    break
                await asyncio.sleep(0.02)
            release.set()
            results = await fut
        finally:
            release.set()
            await stop(batcher)
        return results, staged

    results, staged = run(main())
    assert results == [None] * 4
    assert staged, (
        "batch 2 was never host-prepared while batch 1 held the device thread"
    )


def test_default_backend_is_the_card_unless_set(monkeypatch):
    """``BatchVerifier()`` and a batcher without a backend take
    ``default_backend()``: ``TorchBackend()`` on the card (raising without
    CUDA), or whatever ``set_default_backend`` installed."""
    from cpzk_tpu_torch.protocol import batch as batch_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(batch_mod, "_DEFAULT_BACKEND", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_mod.default_backend()
    cpu = CpuBackend()
    batch_mod.set_default_backend(cpu)
    try:
        assert BatchVerifier().backend is cpu
        params, proofs = make_proofs(2)

        async def main():
            batcher = DynamicBatcher(None, max_batch=8, window_ms=1.0)
            batcher.start()
            try:
                return await asyncio.gather(
                    *[batcher.submit(params, st, pr, None) for st, pr in proofs])
            finally:
                await stop(batcher)

        assert run(main()) == [None, None]
    finally:
        batch_mod.set_default_backend(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchVerifier()


# --- build_backend ------------------------------------------------------------


def test_build_backend_cpu_setting_is_inline(monkeypatch):
    # the port's default is the card; "cpu" is the caller asking for the host
    assert TpuSettings().backend == "tpu"
    assert build_backend(TpuSettings(backend="cpu")) == (None, None)
    assert build_backend(TpuSettings(backend="cpu"), device="cpu") == (None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_backend(TpuSettings())


def test_build_backend_refuses_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_backend(TpuSettings(backend="tpu"))
    settings = TpuSettings(backend="tpu", batch_max=128, batch_window_ms=2.0,
                           pipeline_depth=1, recovery_after_s=-1,
                           probe_batch_max=8)
    backend, batcher = build_backend(settings, device="cpu")
    # no host fallback unless the caller passes one: the card is served bare
    assert type(backend) is TorchBackend
    assert backend.device == torch.device("cpu")
    assert batcher.backend is backend
    backend, batcher = build_backend(settings, device="cpu",
                                     fallback=CpuBackend())
    assert isinstance(backend, FailoverBackend)
    assert isinstance(backend.primary, TorchBackend)
    assert backend.primary.device == torch.device("cpu")
    assert type(backend.fallback) is CpuBackend
    assert backend.breaker.recovery_after_s is None  # -1 = never self-heal
    assert backend.probe_batch_max == 8
    assert (batcher.backend, batcher.max_batch, batcher.window,
            batcher.pipeline_depth) == (backend, 128, 0.002, 1)


def _lanes_of(batcher):
    """Per lane device names of a batcher's router (None without one)."""
    router = batcher.router
    return None if router is None else [row["device"] for row in router.status()["lanes"]]


@pytest.mark.parametrize("settings, kwargs, expect", [
    # an explicit pool of four CPU "devices": lanes resolve against it
    (TpuSettings(backend="tpu", lanes=-1, mesh_devices=1),
     {"devices": ["cpu"] * 4}, ("lanes", ["cpu"] * 4)),
    (TpuSettings(backend="tpu", lanes=2, mesh_devices=1, mesh_threshold=64),
     {"devices": ["cpu"] * 4}, ("lanes+mesh", ["cpu"] * 2)),
    (TpuSettings(backend="tpu", mesh_devices=2),
     {"devices": ["cpu"] * 4}, ("mesh", 2)),
    # a pinned device is a pool of one: no lanes, no mesh
    (TpuSettings(backend="tpu", lanes=-1), {"device": "cpu"}, ("single", "cpu")),
    (TpuSettings(backend="tpu", lanes=8, mesh_devices=1), {"devices": ["cpu"] * 4},
     (ValueError, "lanes=8 exceeds the 4 local device")),
    (TpuSettings(backend="tpu", lanes=0), {"device": "cpu"},
     (ValueError, "tpu.lanes must be a positive lane count")),
])
def test_build_backend_never_serves_multi_device_settings_on_one_lane(
        monkeypatch, settings, kwargs, expect):
    """On a host with four cards, a multi-lane setting builds one lane per
    device of the pool behind the lane router (a mesh lane beside them at
    ``mesh_threshold``), a mesh setting shards the one lane, a pinned
    device serves alone, and an overcommitted or invalid setting is
    refused before anything is built: a multi-device setting never serves
    on one lane."""
    from cpzk_tpu_torch.server.router import LaneRouter

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    kind, value = expect
    if isinstance(kind, type):
        with pytest.raises(kind, match=value):
            build_backend(settings, **kwargs)
        return
    backend, batcher = build_backend(settings, **kwargs)
    assert isinstance(backend, TorchBackend)
    if kind.startswith("lanes"):
        assert isinstance(batcher.router, LaneRouter)
        assert _lanes_of(batcher) == value
        assert backend is batcher.router._slots[0].lane._backend
        mesh = batcher.router.status()["mesh"]
        assert (mesh is not None) == (kind == "lanes+mesh")
        assert metrics.read("tpu.lanes", "g") == len(value)
    else:
        assert batcher.router is None and batcher.backend is backend
        assert metrics.read("tpu.lanes", "g") == 1
        if kind == "mesh":
            assert len(backend.mesh) == value
        else:
            assert backend.mesh is None and backend.device == torch.device(value)


def test_build_backend_launch_error_fails_the_batch(monkeypatch):
    """Served bare, the card has no host fallback: a kernel launch that
    fails raises out of the batcher to every caller of the batch, and no
    breaker trips or counts it."""
    params, pairs = make_proofs(4)
    entries = [BatchEntry(params, st, pr, None) for st, pr in pairs]
    backend, batcher = build_backend(
        TpuSettings(backend="tpu", batch_max=4, batch_window_ms=2.0),
        device="cpu")

    def failed_launch(p, q):
        raise RuntimeError("point_add launch failed: CUDA error 700")

    monkeypatch.setattr(point_kernels, "point_add", failed_launch)
    failover_before = metrics.read("tpu.backend.failover")

    async def serve():
        batcher.start()
        try:
            return await asyncio.gather(
                *[batcher.submit_many([e]) for e in entries],
                return_exceptions=True)
        finally:
            await stop(batcher)

    results = run(serve())
    assert [(type(r), str(r)) for r in results] == [
        (RuntimeError, "point_add launch failed: CUDA error 700")] * 4
    assert metrics.read("tpu.backend.failover") == failover_before


# --- parity with the JAX package's serving plane ----------------------------


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def seeded_wires(n, seed):
    """n (proof wire, y1 wire, y2 wire, context) from the port's prover on
    a seeded rng; three rows tampered (wrong s, wrong context, swapped
    r1), at rows 5, 20 and 41."""
    rng = SeededRng(seed)
    params = Parameters.new()
    rows = []
    for i in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        ctx = b"parity-%d" % i
        t = Transcript()
        t.append_context(ctx)
        proof = prover.prove_with_transcript(rng, t)
        st = prover.statement
        rows.append([proof.to_bytes(), st.y1.wire(), st.y2.wire(), ctx])
    s = int.from_bytes(rows[5][0][77:], "little")
    rows[5][0] = rows[5][0][:77] + ((s + 1) % L).to_bytes(32, "little")
    rows[20][3] = rows[20][3] + b"-replayed"
    rows[41][0] = rows[41][0][:5] + rows[42][0][5:37] + rows[41][0][37:]
    return [tuple(r) for r in rows]


def as_text(results):
    return [None if r is None else (type(r).__name__, str(r)) for r in results]


def test_serving_plane_parity_with_jax():
    """The same 48 seeded entries (3 tampered) through the JAX package's
    ``DynamicBatcher(FailoverBackend(TpuBackend(), CpuBackend()))`` on the
    JAX CPU backend and through the port's ``build_backend(...,
    device="cpu")``: every result's type and message are equal, the
    tampered rows are the only rejects, and neither breaker tripped."""
    wires = seeded_wires(48, seed=48)

    def jax_entries():
        params = J.Parameters.new()
        return [JBatchEntry(
            params,
            J.Statement(J.Ristretto255.element_from_bytes(y1),
                        J.Ristretto255.element_from_bytes(y2)),
            JProof.from_bytes(w), ctx) for w, y1, y2, ctx in wires]

    def port_entries():
        params = Parameters.new()
        return [BatchEntry(
            params,
            T.Statement(Ristretto255.element_from_bytes(y1),
                        Ristretto255.element_from_bytes(y2)),
            Proof.from_bytes(w), ctx) for w, y1, y2, ctx in wires]

    async def serve(batcher, entries):
        batcher.start()
        try:
            return await batcher.submit_many(entries, settled=True)
        finally:
            await stop(batcher)

    jax_backend = JFailoverBackend(JTpuBackend(), JCpuBackend())
    jax_results = run(serve(
        JDynamicBatcher(jax_backend, max_batch=64, window_ms=5.0),
        jax_entries()))
    failover_before = metrics.read("tpu.backend.failover")
    backend, batcher = build_backend(
        TpuSettings(backend="tpu", batch_max=64, batch_window_ms=5.0),
        device="cpu", fallback=CpuBackend())
    port_results = run(serve(batcher, port_entries()))

    assert as_text(port_results) == as_text(jax_results)
    rejected = [i for i, r in enumerate(port_results) if r is not None]
    assert rejected == [5, 20, 41]
    assert all(as_text(port_results)[i] == (
        "InvalidParams", "Proof verification failed") for i in rejected)
    assert not jax_backend.degraded and not backend.degraded
    assert metrics.read("tpu.backend.failover") == failover_before
    record = get_flight_recorder().snapshot()[-1]
    assert (record.batch, record.backend) == (48, "primary")
    assert record.device_interval_s > 0.0
