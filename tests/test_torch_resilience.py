"""The port's resilience layer and the batcher's shedding: twins of the
non-gRPC cases of ``tests/test_chaos.py`` — the breaker state machine and
its exclusive probe token, the seeded fault plan, failover self-healing,
probe disagreement and sizing, deadline and cancellation shedding, the
in-flight queue-depth gauge, and latency spikes riding through without a
trip.  Metrics are read from the port's own registry.

Tolerance: exact (accept sets, error types, counter deltas)."""

import asyncio
import threading
import time

import pytest

from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.protocol.batch import (
    BatchVerifier,
    CpuBackend,
    FailoverBackend,
    VerifierBackend,
)
from cpzk_tpu_torch.resilience import FaultInjectionBackend, FaultPlan
from cpzk_tpu_torch.resilience.breaker import BreakerState, CircuitBreaker
from cpzk_tpu_torch.server import metrics
from cpzk_tpu_torch.server.batching import DeadlineExceeded, DynamicBatcher, QueueFull

pytestmark = pytest.mark.chaos

STOP_TIMEOUT_S = 60.0


def run(coro):
    return asyncio.run(coro)


async def stop(batcher) -> None:
    await asyncio.wait_for(batcher.stop(), STOP_TIMEOUT_S)


@pytest.fixture(autouse=True)
def _lane_threads_joined():
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


# --- breaker state machine ---------------------------------------------------


def test_breaker_state_machine():
    t = [0.0]
    br = CircuitBreaker(recovery_after_s=10.0, clock=lambda: t[0])
    assert br.state is BreakerState.CLOSED
    assert br.acquire() == "primary"

    assert br.record_failure() is True  # caller that transitioned
    assert br.record_failure() is False  # concurrent batch: no double-count
    assert br.state is BreakerState.OPEN

    t[0] = 9.9
    assert br.acquire() == "fallback"  # cooldown not served
    t[0] = 10.0
    assert br.acquire() == "probe"  # exactly one probe granted
    assert br.state is BreakerState.HALF_OPEN
    assert br.acquire() == "fallback"  # probe already in flight

    br.probe_failed()
    assert br.state is BreakerState.OPEN
    t[0] = 15.0
    assert br.acquire() == "fallback"  # cooldown restarted at t=10
    t[0] = 20.0
    assert br.acquire() == "probe"
    br.probe_succeeded()
    assert br.state is BreakerState.CLOSED
    assert br.acquire() == "primary"
    assert br.degraded_seconds == pytest.approx(20.0)  # t=0 .. t=20

    # release_probe hands the token back without restarting the cooldown
    br.record_failure()  # t=20
    t[0] = 30.0
    assert br.acquire() == "probe"
    br.release_probe()
    assert br.acquire() == "probe"  # immediately re-grantable

    # recovery_after_s=None: the permanent latch
    t2 = [0.0]
    br2 = CircuitBreaker(recovery_after_s=None, clock=lambda: t2[0])
    br2.record_failure()
    t2[0] = 1e9
    assert br2.acquire() == "fallback"
    br2.reset()
    assert br2.acquire() == "primary"


def test_breaker_probe_token_is_exclusive_across_threads():
    t = [100.0]
    br = CircuitBreaker(recovery_after_s=0.0, clock=lambda: t[0])
    br.record_failure()
    routes = []
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        routes.append(br.acquire())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10.0)
        assert not th.is_alive()
    assert routes.count("probe") == 1
    assert routes.count("fallback") == 7


# --- fault plan determinism --------------------------------------------------


def test_fault_plan_is_deterministic():
    def build():
        return (
            FaultPlan(seed=3)
            .fail_on(2)
            .fail_range(5, 7)
            .flap(period=3, fail=1, start=9, until=15)
        )

    expected = {2, 5, 6, 9, 12}
    assert {i for i in range(20) if build().should_fail(i)} == expected
    a, b = build(), build()
    assert [a.should_fail(i) for i in range(50)] == [b.should_fail(i) for i in range(50)]

    p1 = FaultPlan(seed=1).fail_probability(0.5, until=200)
    p2 = FaultPlan(seed=1).fail_probability(0.5, until=200)
    seq = [p1.should_fail(i) for i in range(200)]
    assert seq == [p2.should_fail(i) for i in range(200)]
    assert any(seq) and not all(seq)  # actually probabilistic
    p3 = FaultPlan(seed=2).fail_probability(0.5, until=200)
    assert seq != [p3.should_fail(i) for i in range(200)]

    lat = FaultPlan(seed=2).latency(0.1, every=4)
    assert lat.latency_for(0) > 0 and lat.latency_for(1) == 0.0
    assert lat.latency_for(0) == FaultPlan(seed=2).latency(0.1, every=4).latency_for(0)
    assert 0.05 <= lat.latency_for(4) <= 0.15  # ±50% jitter band

    plan = FaultPlan().snapshot_errors(2)
    assert plan.take_snapshot_error() and plan.take_snapshot_error()
    assert not plan.take_snapshot_error()

    assert FaultPlan().fail_after(3).should_fail(10**9)
    with pytest.raises(ValueError):
        FaultPlan().flap(period=0, fail=0)


# --- failover self-healing ---------------------------------------------------


def test_failover_self_heals_after_transient_fault():
    """Fail once, cool down, probe, re-arm."""
    params, proofs = make_proofs(4)
    t = [0.0]
    fault = FaultInjectionBackend(CpuBackend(), FaultPlan().fail_on(0))
    backend = FailoverBackend(
        fault, CpuBackend(), recovery_after_s=5.0, clock=lambda: t[0]
    )
    rng = SecureRng()

    def verify_wave():
        bv = BatchVerifier(backend=backend)
        for st, pr in proofs:
            bv.add(params, st, pr)
        return bv.verify(rng)

    assert verify_wave() == [None] * 4  # batch 0: injected fault -> fallback
    assert backend.degraded and backend.state is BreakerState.OPEN
    assert fault.faults_raised == 1

    assert verify_wave() == [None] * 4  # still cooling down: primary untouched
    assert fault.batches_seen == 1

    t[0] = 5.0
    assert verify_wave() == [None] * 4  # probe batch: primary agrees
    assert backend.state is BreakerState.CLOSED and not backend.degraded
    assert fault.batches_seen == 2

    before = fault.batches_seen
    assert verify_wave() == [None] * 4  # traffic is back on the primary
    assert fault.batches_seen == before + 1


class LyingBackend(VerifierBackend):
    """A device that comes back WRONG: accepts every proof."""

    prefers_combined = False

    def verify_combined(self, rows, beta):  # pragma: no cover - unused
        raise AssertionError("unused")

    def verify_each(self, rows):
        return [1] * len(rows)


def test_probe_disagreement_keeps_fallback_authoritative():
    """A primary that answers — incorrectly — never re-arms, and its wrong
    answers are never returned to callers."""
    params, proofs = make_proofs(3)
    t = [0.0]
    lying = FaultInjectionBackend(LyingBackend(), FaultPlan().fail_on(0))
    backend = FailoverBackend(
        lying, CpuBackend(), recovery_after_s=1.0, clock=lambda: t[0]
    )
    rng = SecureRng()

    def verify_wave():
        bv = BatchVerifier(backend=backend)
        bv.add(params, proofs[0][0], proofs[0][1])
        bv.add(params, proofs[1][0], proofs[1][1])
        bv.add(params, proofs[0][0], proofs[2][1])  # mismatched -> must reject
        return bv.verify(rng)

    def assert_truth(results):
        assert results[0] is None and results[1] is None and results[2] is not None

    assert_truth(verify_wave())  # batch 0 raises -> open
    assert backend.state is BreakerState.OPEN
    for round_no in range(3):
        t[0] += 1.0
        assert_truth(verify_wave())  # probe: lying primary accepts row 2
        assert backend.state is BreakerState.OPEN, round_no  # never re-arms


def test_probe_respects_probe_batch_max():
    """The probe re-verifies at most probe_batch_max rows on the primary."""
    params, proofs = make_proofs(6)
    t = [0.0]

    class RowCounting(CpuBackend):
        def __init__(self):
            self.seen_rows = []

        def verify_each(self, rows):
            self.seen_rows.append(len(rows))
            return super().verify_each(rows)

    counting = RowCounting()
    fault = FaultInjectionBackend(counting, FaultPlan().fail_on(0))
    backend = FailoverBackend(
        fault, CpuBackend(), recovery_after_s=0.0, probe_batch_max=2,
        clock=lambda: t[0],
    )
    rng = SecureRng()
    for _ in range(2):  # batch 0 trips, batch 1 probes
        bv = BatchVerifier(backend=backend)
        for st, pr in proofs:
            bv.add(params, st, pr)
        assert bv.verify(rng) == [None] * 6
    assert backend.state is BreakerState.CLOSED
    assert counting.seen_rows == [2]  # the probe slice, nothing more


# --- deadline shedding -------------------------------------------------------


class RowCountingBackend(CpuBackend):
    def __init__(self):
        self.rows_verified = 0

    def verify_each(self, rows):
        self.rows_verified += len(rows)
        return super().verify_each(rows)


def test_expired_entries_shed_before_dispatch():
    """Expired queue entries resolve as DeadlineExceeded and are never
    verified."""
    params, proofs = make_proofs(5)
    backend = RowCountingBackend()
    expired_before = metrics.read("tpu.queue.expired")

    async def main():
        batcher = DynamicBatcher(backend, max_batch=64, window_ms=30.0)
        batcher.start()
        try:
            now = time.monotonic()
            coros = [
                batcher.submit(params, st, pr, None, deadline=now + 30.0)
                for st, pr in proofs[:3]
            ] + [
                batcher.submit(params, st, pr, None, deadline=now - 0.001)
                for st, pr in proofs[3:]
            ]
            return await asyncio.gather(*coros, return_exceptions=True)
        finally:
            await stop(batcher)

    results = run(main())
    assert results[:3] == [None] * 3
    assert all(isinstance(r, DeadlineExceeded) for r in results[3:])
    assert all(str(r) == "RPC deadline expired before dispatch" for r in results[3:])
    assert backend.rows_verified == 3  # zero device rows for expired entries
    assert metrics.read("tpu.queue.expired") - expired_before == 2


def test_shed_expired_toggle_off_verifies_everything():
    params, proofs = make_proofs(2)
    backend = RowCountingBackend()

    async def main():
        batcher = DynamicBatcher(
            backend, max_batch=64, window_ms=10.0, shed_expired=False
        )
        batcher.start()
        try:
            now = time.monotonic()
            return await asyncio.gather(
                *[
                    batcher.submit(params, st, pr, None, deadline=now - 1.0)
                    for st, pr in proofs
                ]
            )
        finally:
            await stop(batcher)

    assert run(main()) == [None, None]  # verified despite expiry
    assert backend.rows_verified == 2


def test_cancelled_entries_dropped_and_counted_once():
    """Requests cancelled while queued are dropped at drain time (no device
    work) and counted into tpu.queue.abandoned exactly once."""
    params, proofs = make_proofs(4)
    backend = RowCountingBackend()
    abandoned_before = metrics.read("tpu.queue.abandoned")

    async def main():
        batcher = DynamicBatcher(backend, max_batch=64, window_ms=50.0)
        batcher.start()
        try:
            futs = [
                asyncio.ensure_future(batcher.submit(params, st, pr, None))
                for st, pr in proofs
            ]
            await asyncio.sleep(0.01)  # everything enqueued, window still open
            futs[0].cancel()
            futs[1].cancel()
            return await asyncio.gather(*futs, return_exceptions=True)
        finally:
            await stop(batcher)

    results = run(main())
    assert all(isinstance(r, asyncio.CancelledError) for r in results[:2])
    assert results[2:] == [None, None]
    assert backend.rows_verified == 2  # only the live pair hit the device
    assert metrics.read("tpu.queue.abandoned") - abandoned_before == 2


def test_queue_depth_gauge_counts_inflight_entries():
    """While a device batch is in flight the depth gauge reports its
    entries (not 0), and backpressure accounts for them."""
    params, proofs = make_proofs(4)
    release = threading.Event()
    entered = threading.Event()

    class GatedBackend(CpuBackend):
        def verify_each(self, rows):
            entered.set()
            release.wait(10.0)
            return super().verify_each(rows)

    async def main():
        batcher = DynamicBatcher(
            GatedBackend(), max_batch=4, window_ms=1.0, max_queue=4
        )
        batcher.start()
        try:
            coros = [
                asyncio.ensure_future(batcher.submit(params, st, pr, None))
                for st, pr in proofs
            ]
            await asyncio.to_thread(entered.wait, 10.0)
            # the queue itself is drained, but 4 entries are claimed in flight
            assert len(batcher._queue) == 0
            depth_during = metrics.read("tpu.queue.depth", kind="g")
            with pytest.raises(QueueFull):
                await batcher.submit(params, proofs[0][0], proofs[0][1], None)
            release.set()
            results = await asyncio.gather(*coros)
        finally:
            release.set()
            await stop(batcher)
        return depth_during, results

    depth_during, results = run(main())
    assert depth_during == 4.0
    assert results == [None] * 4
    assert metrics.read("tpu.queue.depth", kind="g") == 0.0


def test_latency_spikes_do_not_trip_the_breaker():
    """Slow-but-correct batches are not failures."""
    params, proofs = make_proofs(3)
    fault = FaultInjectionBackend(
        CpuBackend(), FaultPlan(seed=9).latency(0.03, every=2)
    )
    backend = FailoverBackend(fault, CpuBackend(), recovery_after_s=0.05)

    async def main():
        batcher = DynamicBatcher(backend, max_batch=2, window_ms=2.0)
        batcher.start()
        try:
            return await asyncio.gather(
                *[batcher.submit(params, st, pr, None) for st, pr in proofs]
            )
        finally:
            await stop(batcher)

    assert run(main()) == [None] * 3
    assert backend.state is BreakerState.CLOSED
    assert fault.batches_seen >= 1 and fault.faults_raised == 0
