"""Deterministic fault injection for the serving stack.

A copy of the backend and write-ahead-log half of
``cpzk_tpu/resilience/faults.py``: a :class:`FaultPlan` is a seeded,
declarative schedule of device faults, and :class:`FaultInjectionBackend`
applies it to any :class:`~cpzk_tpu_torch.protocol.batch.VerifierBackend`
(raise-after-N-batches, intermittent flapping, per-batch latency spikes);
the crash points (:meth:`FaultPlan.crash_on`) schedule deterministic
process-death stand-ins at exact sites: the write sites inside
:class:`~cpzk_tpu_torch.durability.wal.WriteAheadLog` (``pre_append`` /
``mid_frame`` / ``post_append_pre_fsync`` / ``pre_rename`` / ``pre_seal``
/ ``pre_unlink``), the replication plane's shipping and promotion, each
stage of a fleet split and of a coordinated handover.  Everything is
reproducible from the plan alone — same plan, same faults, same batch
indexes — so the chaos, durability and replication tests assert exact
outcomes instead of sampling flaky timing windows.

The reference's snapshot-write injector is not carried; the
snapshot-error budget is kept, since the plan's builder API carries it.

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


#: Replication-plane crash sites: ``pre_ship`` (primary dies before a
#: segment leaves), ``mid_segment`` (primary dies mid-transfer — the
#: standby receives a torn segment and must reject it whole), and
#: ``pre_promote`` (standby dies at the promotion decision; a retried
#: promote must succeed).  Consulted by ``SegmentShipper`` and
#: ``StandbyReplica`` the same way the WAL sites are by ``WriteAheadLog``.
REPLICATION_CRASH_POINTS = ("pre_ship", "mid_segment", "pre_promote")

#: Fleet-split crash sites (one per split stage — see
#: ``cpzk_tpu_torch/fleet/split.py`` SPLIT_CRASH_POINTS for the exact file
#: state each leaves behind).  Consulted by ``run_split(..., faults=)``.
FLEET_CRASH_POINTS = (
    "pre_manifest", "pre_copy", "mid_copy",
    "pre_flip", "pre_drain", "pre_finish",
)

#: Coordinated-handover crash sites, one per protocol stage.  Primary
#: side (``SegmentShipper.run_handover``): ``pre_handover_fence`` (nothing
#: armed yet), ``post_handover_fence`` (write fence armed, tail not
#: shipped), ``pre_handover_promote`` (tail acked at the fence watermark,
#: promote instruction never sent), ``post_handover_promote`` (standby
#: promoted, deposed-redirect mode not entered).  Standby side
#: (``StandbyReplica.handover``): ``pre_handover_ack`` (promote
#: instruction received, nothing done).  A crash at ANY of these must
#: degrade to ordinary lease failover — handover is an optimization of
#: the failure path, never a second consistency protocol.
HANDOVER_CRASH_POINTS = (
    "pre_handover_fence",
    "post_handover_fence",
    "pre_handover_promote",
    "post_handover_promote",
    "pre_handover_ack",
)

ALL_CRASH_POINTS = (
    WAL_CRASH_POINTS + REPLICATION_CRASH_POINTS + FLEET_CRASH_POINTS
    + HANDOVER_CRASH_POINTS
)


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
        under segmented compaction) or a replication site
        (``pre_ship`` / ``mid_segment`` once per shipped segment,
        ``pre_promote`` once per promotion attempt) or a handover stage
        (``HANDOVER_CRASH_POINTS`` — once per visit of that stage in
        ``SegmentShipper.run_handover`` / ``StandbyReplica.handover``) or
        a fleet-split stage (``FLEET_CRASH_POINTS``, once per run) — the
        deterministic stand-in for the process dying at exactly that
        instruction.  Pass the plan as ``WriteAheadLog(..., faults=plan)``
        / ``DurabilityManager(..., faults=plan)`` /
        ``SegmentShipper(..., faults=plan)`` /
        ``StandbyReplica(..., faults=plan)`` /
        ``run_split(..., faults=plan)`` to arm it."""
        if point not in ALL_CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {point!r}; one of {ALL_CRASH_POINTS}"
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
