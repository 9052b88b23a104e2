"""The port's dispatch lane (``cpzk_tpu_torch.server.dispatch``): twins of
``tests/test_dispatch_lane.py`` — FIFO ordering, leak-free drain-then-join
shutdown, chaos containment, the double-buffering obligations (near-zero
dispatch gap on a slow-device workload, ``device_wait`` accounting, cheap
``thread_hop``), the splice path's flight record on ``TorchBackend`` —
plus the port's ``prewarm`` inside ``build_backend`` and the ``[tpu]``
validation messages against the JAX package's.

Tolerance: exact for results; timing thresholds are the JAX tests'."""

import asyncio
import json
import threading
import time

import pytest

from cpzk_tpu.server import ServerConfig as JServerConfig
from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.observability import get_flight_recorder, get_tracer
from cpzk_tpu_torch.ops import backend as backend_mod
from cpzk_tpu_torch.ops.backend import TorchBackend
from cpzk_tpu_torch.protocol.batch import (
    BatchEntry,
    CpuBackend,
    FailoverBackend,
    VerifierBackend,
)
from cpzk_tpu_torch.protocol.gadgets import Proof
from cpzk_tpu_torch.server import TpuSettings, build_backend, metrics, validate_tpu
from cpzk_tpu_torch.server.batching import DynamicBatcher
from cpzk_tpu_torch.server.dispatch import DispatchLane, LaneStopped

STOP_TIMEOUT_S = 60.0


def run(coro):
    return asyncio.run(coro)


async def stop(obj) -> None:
    await asyncio.wait_for(obj.stop(), STOP_TIMEOUT_S)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    rec = get_flight_recorder()
    rec.clear()
    get_tracer().clear()
    yield
    rec.clear()
    for t in threading.enumerate():
        if t.name.startswith("cpzk-lane"):
            t.join(10.0)
            assert not t.is_alive(), f"lane thread {t.name} leaked"


def make_entries(n, params=None, rng=None):
    rng = rng or SecureRng()
    params = params or Parameters.new()
    out = []
    for i in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        ctx = b"lane-%04d" % i
        t = Transcript()
        t.append_context(ctx)
        proof = prover.prove_with_transcript(rng, t)
        out.append(BatchEntry(params, prover.statement, proof, ctx))
    return out


class RecordingBackend(VerifierBackend):
    """CPU oracle wrapper that logs every backend call's batch size."""

    prefers_combined = False

    def __init__(self, delay_s: float = 0.0):
        self.sizes: list[int] = []
        self.delay_s = delay_s
        self._inner = CpuBackend()

    def verify_combined(self, rows, beta):  # pragma: no cover - unused
        raise AssertionError("prefers_combined is False")

    def verify_each(self, rows):
        self.sizes.append(len(rows))
        if self.delay_s:
            time.sleep(self.delay_s)
        return self._inner.verify_each(rows)


class ExplodingBackend(VerifierBackend):
    prefers_combined = False

    def __init__(self, explode_times: int = 10**9):
        self.calls = 0
        self.explode_times = explode_times

    def verify_combined(self, rows, beta):  # pragma: no cover - unused
        raise AssertionError("prefers_combined is False")

    def verify_each(self, rows):
        self.calls += 1
        if self.calls <= self.explode_times:
            raise RuntimeError("injected device loss")
        return [True] * len(rows)


# --- ordering / fairness -----------------------------------------------------


def test_lane_executes_batches_fifo():
    """Submission order IS execution order."""
    backend = RecordingBackend()
    sizes = [2, 3, 4, 5, 2, 3]

    async def main():
        lane = DispatchLane(backend, overlap=True)
        lane.start()
        try:
            futs = [lane.submit(make_entries(k), None) for k in sizes]
            return await asyncio.gather(*futs)
        finally:
            await stop(lane)

    results = run(main())
    assert [len(r) for r in results] == sizes
    assert all(all(e is None for e in r) for r in results)
    assert backend.sizes == sizes  # FIFO, nothing reordered or coalesced


def test_lane_serial_mode():
    """overlap=False (pipeline_depth=1) runs both phases on one persistent
    thread — same results, strictly serial."""
    backend = RecordingBackend()

    async def main():
        lane = DispatchLane(backend, overlap=False)
        lane.start()
        try:
            futs = [lane.submit(make_entries(2), None) for _ in range(3)]
            return await asyncio.gather(*futs)
        finally:
            await stop(lane)

    results = run(main())
    assert [len(r) for r in results] == [2, 2, 2]
    assert backend.sizes == [2, 2, 2]


# --- shutdown ----------------------------------------------------------------


def test_lane_stop_drains_in_flight_batches():
    """stop() refuses new work but DRAINS accepted batches: every future
    resolves with real results, and submit-after-stop raises."""
    backend = RecordingBackend(delay_s=0.05)

    async def main():
        lane = DispatchLane(backend, overlap=True)
        lane.start()
        futs = [lane.submit(make_entries(2), None) for _ in range(4)]
        stop_task = asyncio.ensure_future(stop(lane))
        try:
            await asyncio.sleep(0)  # let stop() flip the accepting flag
            with pytest.raises(LaneStopped):
                lane.submit(make_entries(1), None)
        finally:
            await stop_task
        assert all(f.done() for f in futs), "stop() returned before drain"
        return await asyncio.gather(*futs)

    results = run(main())
    assert len(results) == 4
    assert all(r == [None, None] for r in results)
    assert backend.sizes == [2, 2, 2, 2]


def test_lane_futures_never_leak_on_cancel():
    """A cancelled result future neither blocks the lane nor errors it."""
    backend = RecordingBackend(delay_s=0.02)

    async def main():
        lane = DispatchLane(backend, overlap=True)
        lane.start()
        try:
            doomed = lane.submit(make_entries(2), None)
            live = lane.submit(make_entries(3), None)
            doomed.cancel()
            result = await live
        finally:
            await stop(lane)
        return doomed, result

    doomed, result = run(main())
    assert doomed.cancelled()
    assert result == [None] * 3
    assert backend.sizes == [2, 3]  # the cancelled batch still verified


def test_batcher_stop_resolves_every_pending_future():
    """Stopping with in-flight batches resolves every pending entry
    future — none left pending, none leaked."""
    backend = RecordingBackend(delay_s=0.03)
    entries = make_entries(6)

    async def main():
        batcher = DynamicBatcher(backend, max_batch=2, window_ms=1.0)
        batcher.start()
        try:
            pending = [
                asyncio.ensure_future(batcher.submit_many([e])) for e in entries
            ]
            await asyncio.sleep(0.02)  # let some batches commit to the lane
        finally:
            await stop(batcher)
        done = [f.done() for f in pending]
        results = await asyncio.gather(*pending)
        return done, results

    done, results = run(main())
    assert all(done), "batcher.stop() returned with unresolved futures"
    assert results == [[None]] * 6


# --- chaos -------------------------------------------------------------------


def test_lane_contains_backend_explosion_to_its_batch():
    """A backend raise mid-batch resolves THAT batch's future with the
    exception; the lane threads survive and serve the next batch."""
    backend = ExplodingBackend(explode_times=1)

    async def main():
        lane = DispatchLane(backend, overlap=True)
        lane.start()
        try:
            first = lane.submit(make_entries(2), None)
            with pytest.raises(RuntimeError, match="injected device loss"):
                await first
            return await lane.submit(make_entries(2), None)
        finally:
            await stop(lane)

    assert run(main()) == [None, None]


def test_lane_failover_breaker_engages_through_lane():
    """With the failover wrapper, a device loss on the lane's device
    thread degrades to the host fallback mid-stream: results stay correct
    and the breaker records the trip."""
    broken = ExplodingBackend()
    backend = FailoverBackend(broken, CpuBackend())

    async def main():
        batcher = DynamicBatcher(backend, max_batch=8, window_ms=2.0)
        batcher.start()
        try:
            return await batcher.submit_many(make_entries(4))
        finally:
            await stop(batcher)

    assert run(main()) == [None] * 4
    assert backend.degraded
    assert broken.calls == 1  # breaker opened on the first loss


# --- double-buffering proof obligations --------------------------------------


def test_double_buffered_dispatch_gap_near_zero(tmp_path):
    """Slow-device workload: with double-buffering the device thread never
    idles between batches — steady-state dispatch gap clamps toward 0, and
    staged batches book their dwell as ``device_wait``.  Also dumps the
    ring while the lane threads are the writers."""
    backend = RecordingBackend(delay_s=0.06)  # "device" >> host prep

    async def main():
        batcher = DynamicBatcher(
            backend, max_batch=2, window_ms=1.0, pipeline_depth=2
        )
        batcher.start()
        try:
            waves = [make_entries(2) for _ in range(4)]
            return await asyncio.gather(
                *[batcher.submit_many(w) for w in waves]
            )
        finally:
            await stop(batcher)

    results = run(main())
    assert all(r == [None, None] for r in results)
    records = get_flight_recorder().snapshot()
    assert len(records) == 4
    steady = records[1:]  # first batch has no predecessor to overlap
    for rec in steady:
        assert rec.dispatch_gap_s < 0.03, rec.to_dict()
    assert any(
        r.stages_s.get("device_wait", 0.0) > 0.0 for r in steady
    ), [r.to_dict() for r in records]
    path = tmp_path / "ring.json"
    get_flight_recorder().dump(str(path))
    assert len(json.loads(path.read_text())["records"]) == 4


def test_thread_hop_is_condition_variable_cheap():
    """The per-batch thread_hop is a cv wakeup on a hot persistent thread
    (asserted loosely at 50ms p50, as the JAX test does)."""
    backend = RecordingBackend()

    async def main():
        batcher = DynamicBatcher(backend, max_batch=4, window_ms=1.0)
        batcher.start()
        try:
            for _ in range(5):
                await batcher.submit_many(make_entries(2))
        finally:
            await stop(batcher)

    run(main())
    records = get_flight_recorder().snapshot()
    hops = sorted(r.stages_s.get("thread_hop", 0.0) for r in records)
    assert len(hops) == 5
    assert hops[len(hops) // 2] < 0.05
    for rec in records:
        assert rec.stage_sum_s() == pytest.approx(
            rec.wall_s, rel=0.10, abs=2.5e-3
        ), rec.to_dict()


def test_stopped_batcher_inline_path_same_seam():
    """The stopped-batcher inline verify rides the SAME dispatch seam
    (DispatchLane.verify_once): the flight record still lands with the
    full stage decomposition and the stage-sum invariant intact."""
    backend = RecordingBackend()

    async def main():
        batcher = DynamicBatcher(backend, max_batch=8, window_ms=1.0)
        # never started: submit_many falls to the inline seam
        return await batcher.submit_many(make_entries(3))

    assert run(main()) == [None] * 3
    records = get_flight_recorder().snapshot()
    assert len(records) == 1
    rec = records[0]
    assert rec.stages_s.get("thread_hop", 0.0) >= 0.0
    assert rec.stages_s.get("execute", 0.0) > 0.0
    assert rec.stage_sum_s() == pytest.approx(rec.wall_s, rel=0.10, abs=2.5e-3)


# --- deferred-splice path keeps the full stage decomposition -----------------


def test_splice_path_flight_record_tiles_wall():
    """A deferred-parse batch with an undecodable wire takes the
    screen-and-splice path on ``TorchBackend``; its flight record still
    carries the full stage decomposition and tiles the wall.  (The JAX
    test's jit hit/miss check becomes: the backend reported its padded
    lanes and the device's work interval.)"""
    rng = SecureRng()
    params = Parameters.new()
    entries = make_entries(6, params=params, rng=rng)
    wire = entries[2].proof.to_bytes()
    bad_wire = wire[:5] + b"\xff" * 32 + wire[37:]
    bad, = Proof.from_bytes_batch([bad_wire], defer_point_validation=True)
    assert isinstance(bad, Proof)
    entries[2] = BatchEntry(
        params, entries[2].statement, bad, entries[2].transcript_context,
    )

    async def main():
        batcher = DynamicBatcher(
            TorchBackend(device="cpu"), max_batch=16, window_ms=1.0)
        batcher.start()
        try:
            return await batcher.submit_many(entries)
        finally:
            await stop(batcher)

    results = run(main())
    assert [r is None for r in results] == [
        True, True, False, True, True, True,
    ]
    rec = get_flight_recorder().snapshot()[-1]
    assert rec.stages_s.get("pad_and_pack", 0.0) > 0.0, rec.to_dict()
    assert rec.stages_s.get("execute", 0.0) > 0.0, rec.to_dict()
    assert rec.stages_s.get("compile", 0.0) == 0.0, rec.to_dict()
    assert (rec.lanes, rec.jit_hits, rec.jit_misses) == (8, 0, 0), rec.to_dict()
    assert 0.0 < rec.device_interval_s <= rec.stages_s["execute"], rec.to_dict()
    assert rec.stage_sum_s() == pytest.approx(
        rec.wall_s, rel=0.10, abs=2.5e-3
    ), rec.to_dict()


# --- prewarm and the [tpu] knobs ----------------------------------------------


def test_build_backend_prewarms_each_quantum_before_the_breaker(monkeypatch):
    """``build_backend`` runs ``prewarm`` on the configured quanta before it
    returns — one combined check per quantum at its padded width — and a
    build error raised by ``prewarm`` propagates out of ``build_backend``:
    no breaker is built to see it, nothing trips, nothing is counted."""
    real_prewarm = backend_mod.prewarm
    calls, widths = [], []
    real_combined = TorchBackend.verify_combined

    def spy_prewarm(quanta, device=None):
        calls.append((list(quanta), str(device)))
        return real_prewarm(quanta, device)

    def spy_combined(self, rows, beta):
        widths.append(len(rows))
        return real_combined(self, rows, beta)

    monkeypatch.setattr(backend_mod, "prewarm", spy_prewarm)
    monkeypatch.setattr(TorchBackend, "verify_combined", spy_combined)
    backend, batcher = build_backend(
        TpuSettings(backend="tpu", prewarm_quanta="8,16"), device="cpu",
        fallback=CpuBackend())
    assert calls == [([8, 16], "cpu")]
    assert widths == [8, 16]  # one valid combined check per quantum
    assert isinstance(backend, FailoverBackend) and not backend.degraded

    failover_before = metrics.read("tpu.backend.failover")

    def broken_prewarm(quanta, device=None):
        raise RuntimeError("nvcc failed (1): injected build error")

    monkeypatch.setattr(backend_mod, "prewarm", broken_prewarm)
    with pytest.raises(RuntimeError, match="injected build error"):
        build_backend(TpuSettings(backend="tpu"), device="cpu",
                      fallback=CpuBackend())
    assert metrics.read("tpu.backend.failover") == failover_before
    assert not [t for t in get_tracer().completed()
                if t.name == "breaker_transition"]


def test_prewarm_reports_each_padded_width():
    seconds = backend_mod.prewarm([3], "cpu")
    assert list(seconds) == ["combined/4"]  # 3 rows + correction row
    assert seconds["combined/4"] > 0.0
    assert backend_mod.prewarm([], "cpu") == {}  # no CUDA build on the CPU


@pytest.mark.parametrize("field, value", [
    ("backend", "gpu"), ("pipeline_depth", 0), ("batch_max", 0),
    ("batch_window_ms", -1.0), ("mesh_devices", -1), ("lanes", 0),
    ("lanes", -2), ("mesh_threshold", -1), ("mesh_threshold", 8),
    ("recovery_after_s", -2.0), ("probe_batch_max", 0), ("stream_window", 0),
    ("stream_entry_deadline_ms", -1.0), ("prewarm_quanta", "banana"),
    ("prewarm_quanta", "0,16"), ("prewarm_quanta", "16, 4096"),
])
def test_validate_tpu_matches_the_jax_server_config(field, value):
    """Each ``[tpu]`` setting is accepted or refused exactly as the JAX
    package's ``ServerConfig.validate`` does, with the same message."""
    settings = TpuSettings(**{field: value})
    cfg = JServerConfig()
    setattr(cfg.tpu, field, value)

    def outcome(check):
        try:
            check()
        except ValueError as exc:
            return str(exc)
        return None

    assert outcome(lambda: validate_tpu(settings)) == outcome(cfg.validate)
    if value != "banana":
        assert settings.parsed_prewarm_quanta() == cfg.tpu.parsed_prewarm_quanta()


# --- env-gated instrumentation -------------------------------------------------


def test_xprof_dir_captures_each_device_phase(monkeypatch, tmp_path):
    """``CPZK_XPROF_DIR`` wraps each batch's device phase in a
    ``torch.profiler`` capture that lands as a Chrome trace carrying the
    stage names."""
    monkeypatch.setenv("CPZK_XPROF_DIR", str(tmp_path))
    backend = RecordingBackend()

    async def main():
        batcher = DynamicBatcher(backend, max_batch=4, window_ms=1.0)
        batcher.start()
        try:
            return await batcher.submit_many(make_entries(2))
        finally:
            await stop(batcher)

    assert run(main()) == [None, None]
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert "cpzk_batch_verify" in text and "cpzk.device_dispatch" in text


def test_batch_debug_line(monkeypatch, capsys):
    monkeypatch.setenv("CPZK_BATCH_DEBUG", "1")
    bv_results = DispatchLane.verify_once(
        RecordingBackend(), SecureRng(), make_entries(3))
    assert bv_results == [None] * 3
    assert "[batch-debug] n=3 device_phase=" in capsys.readouterr().err
