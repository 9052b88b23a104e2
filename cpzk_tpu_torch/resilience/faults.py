"""Deterministic fault injection for the serving stack.

A copy of the backend and write-ahead-log half of
``cpzk_tpu/resilience/faults.py``: a :class:`FaultPlan` is a seeded,
declarative schedule of device faults, and :class:`FaultInjectionBackend`
applies it to any :class:`~cpzk_tpu_torch.protocol.batch.VerifierBackend`
(raise-after-N-batches, intermittent flapping, per-batch latency spikes);
the WAL crash points (:meth:`FaultPlan.crash_on`) schedule deterministic
process-death stand-ins at exact write sites inside
:class:`~cpzk_tpu_torch.durability.wal.WriteAheadLog` (``pre_append`` /
``mid_frame`` / ``post_append_pre_fsync`` / ``pre_rename`` / ``pre_seal``
/ ``pre_unlink``).  Everything is reproducible from the plan alone — same
plan, same faults, same batch indexes — so the chaos and durability tests
assert exact outcomes instead of sampling flaky timing windows.

The reference's other crash points (replication, fleet split, handover)
and its snapshot-write injector belong to layers the port has not taken
yet; they come with those layers.  The snapshot-error budget is kept,
since the plan's builder API carries it.

Example::

    plan = (FaultPlan(seed=7)
            .fail_on(0)                  # first device batch raises
            .flap(period=3, fail=1, start=4, until=10)
            .latency(0.02, every=5))     # every 5th batch sleeps ~20ms
    backend = FailoverBackend(FaultInjectionBackend(TorchBackend(), plan),
                              CpuBackend(), recovery_after_s=0.5)
"""

from __future__ import annotations

import random
import threading
import time

from ..durability.wal import WAL_CRASH_POINTS, CrashPoint  # noqa: F401 (re-export)
from ..protocol.batch import VerifierBackend


class InjectedFault(RuntimeError):
    """Deterministic injected device failure (stand-in for a card loss)."""


class FaultPlan:
    """Seeded, composable schedule of faults, keyed by batch index.

    Builder methods return ``self`` so plans read as one expression.  The
    seed only matters for the probabilistic/jittered knobs
    (:meth:`fail_probability`, latency jitter); the structural schedule
    (``fail_on`` / ``fail_range`` / ``flap``) is exact.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._fail_exact: set[int] = set()
        self._fail_ranges: list[tuple[int, int]] = []  # [start, stop)
        self._flaps: list[tuple[int, int, int, int]] = []  # (period, fail, start, stop)
        self._p_fail: list[tuple[float, int, int]] = []  # (p, start, stop)
        self._latency_s = 0.0
        self._latency_every = 0
        self._snapshot_errors = 0
        self._snapshot_lock = threading.Lock()
        # WAL crash points: site -> scheduled occurrence indexes, and the
        # per-site visit counters (shared lock with the snapshot budget)
        self._crash_points: dict[str, set[int]] = {}
        self._crash_seen: dict[str, int] = {}

    # -- builders ----------------------------------------------------------

    def fail_on(self, *batch_indexes: int) -> "FaultPlan":
        """Raise :class:`InjectedFault` on exactly these batch indexes."""
        self._fail_exact.update(batch_indexes)
        return self

    def fail_range(self, start: int, stop: int) -> "FaultPlan":
        """Raise on every batch index in ``[start, stop)`` — the
        raise-after-N-batches shape is ``fail_range(n, 10**9)``."""
        self._fail_ranges.append((start, stop))
        return self

    def fail_after(self, n: int) -> "FaultPlan":
        """Raise on every batch from index ``n`` onward (device gone for
        good — the permanent-loss scenario)."""
        return self.fail_range(n, 1 << 62)

    def flap(self, period: int, fail: int, start: int = 0,
             until: int = 1 << 62) -> "FaultPlan":
        """Intermittent flapping: within ``[start, until)``, batch ``i``
        raises when ``(i - start) % period < fail``."""
        if period < 1 or not 0 <= fail <= period:
            raise ValueError("flap requires period >= 1 and 0 <= fail <= period")
        self._flaps.append((period, fail, start, until))
        return self

    def fail_probability(self, p: float, start: int = 0,
                         until: int = 1 << 62) -> "FaultPlan":
        """Raise on batch ``i`` with probability ``p`` — deterministic in
        (seed, i), independent across indexes."""
        self._p_fail.append((p, start, until))
        return self

    def latency(self, seconds: float, every: int = 1) -> "FaultPlan":
        """Latency spike (~``seconds``, ±50% seeded jitter) on every
        ``every``-th batch."""
        self._latency_s = seconds
        self._latency_every = max(1, every)
        return self

    def snapshot_errors(self, n: int) -> "FaultPlan":
        """Fail the next ``n`` state-snapshot writes (a budget consumed by
        :meth:`take_snapshot_error`)."""
        self._snapshot_errors = n
        return self

    def crash_on(self, point: str, occurrence: int = 0) -> "FaultPlan":
        """Schedule a :class:`CrashPoint` at the ``occurrence``-th visit of
        a WAL crash site (``pre_append`` / ``mid_frame`` /
        ``post_append_pre_fsync`` count once per append, in that order;
        ``pre_rename`` once per single-file compaction, ``pre_seal`` once
        per segment seal, ``pre_unlink`` once per covered-segment unlink
        under segmented compaction) — the deterministic stand-in for the
        process dying at exactly that instruction.  Pass the plan as
        ``WriteAheadLog(..., faults=plan)`` /
        ``DurabilityManager(..., faults=plan)`` to arm it."""
        if point not in WAL_CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {point!r}; one of {WAL_CRASH_POINTS}"
            )
        if occurrence < 0:
            raise ValueError("crash_on occurrence must be >= 0")
        self._crash_points.setdefault(point, set()).add(occurrence)
        return self

    # -- queries -----------------------------------------------------------

    def should_fail(self, batch_index: int) -> bool:
        i = batch_index
        if i in self._fail_exact:
            return True
        if any(start <= i < stop for start, stop in self._fail_ranges):
            return True
        for period, fail, start, stop in self._flaps:
            if start <= i < stop and (i - start) % period < fail:
                return True
        for p, start, stop in self._p_fail:
            if start <= i < stop and self._roll(i) < p:
                return True
        return False

    def latency_for(self, batch_index: int) -> float:
        if self._latency_s <= 0 or batch_index % self._latency_every:
            return 0.0
        return self._latency_s * (0.5 + self._roll(~batch_index))

    def take_snapshot_error(self) -> bool:
        with self._snapshot_lock:
            if self._snapshot_errors <= 0:
                return False
            self._snapshot_errors -= 1
            return True

    def take_crash(self, point: str) -> bool:
        """Visit one WAL crash site: bump its occurrence counter and report
        whether this visit was scheduled by :meth:`crash_on`."""
        with self._snapshot_lock:
            i = self._crash_seen.get(point, 0)
            self._crash_seen[point] = i + 1
            return i in self._crash_points.get(point, ())

    def _roll(self, key: int) -> float:
        return random.Random(f"{self.seed}:{key}").random()


class FaultInjectionBackend(VerifierBackend):
    """Wrap any backend with a :class:`FaultPlan`.

    Each ``verify_combined`` / ``verify_each`` call is one batch: the
    shared counter increments, the plan's latency spike (if any) is slept
    on the calling worker thread, then either :class:`InjectedFault` is
    raised or the call delegates to the wrapped backend.  The counter is
    lock-guarded (pipelined dispatches call from multiple threads) and
    ``batches_seen`` / ``faults_raised`` are exposed for assertions.
    """

    def __init__(self, inner: VerifierBackend, plan: FaultPlan):
        self.inner = inner
        self.plan = plan
        self.batches_seen = 0
        self.faults_raised = 0
        self._lock = threading.Lock()

    @property
    def prefers_combined(self) -> bool:  # type: ignore[override]
        return self.inner.prefers_combined

    @property
    def supports_deferred_decode(self) -> bool:  # type: ignore[override]
        return self.inner.supports_deferred_decode

    def _gate(self) -> None:
        with self._lock:
            i = self.batches_seen
            self.batches_seen += 1
        lat = self.plan.latency_for(i)
        if lat > 0:
            time.sleep(lat)
        if self.plan.should_fail(i):
            with self._lock:
                self.faults_raised += 1
            raise InjectedFault(f"injected device fault at batch {i}")

    def verify_combined(self, rows, beta) -> bool:
        self._gate()
        return self.inner.verify_combined(rows, beta)

    def verify_each(self, rows) -> list[int]:
        self._gate()
        return self.inner.verify_each(rows)
