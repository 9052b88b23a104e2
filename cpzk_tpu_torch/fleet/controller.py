"""Self-driving fleet: the daemon-resident control loop (port of
``cpzk_tpu/fleet/controller.py``).

Every signal this controller consumes already exists — SLO burn pages
(``observability/slo.py``), per-shard sizes and lock-wait
(``server/state.py`` + the ``state.shard.lock_wait`` histogram), lane
breaker states and depths (``server/router.py``) — and every actuator it
drives already exists too: the crash-resumable split machinery
(``fleet/split.py``), the lane router's administrative drain, the
admission controller's level cap.  What was missing is the loop that
closes them, so a partition approaching its soak-calibrated capacity
envelope splits itself, a browned-out lane drains and re-admits itself,
and a burning login SLO sheds load before it cascades — with no operator
at the keyboard.

The loop is deliberately boring:

1. **collect** one :class:`Signals` snapshot per tick;
2. **decide** through two-sided hysteresis (a signal must stay hot for
   ``act_ticks`` consecutive ticks to act, and stay clear for
   ``clear_ticks`` to revert) plus per-action cooldowns;
3. **act** through exactly one actuator per tick, never while another
   action is still in flight, never a split while a split manifest or a
   promotion is unfinished — the safety rails are structural, not tuned.

Every decision — including dry-run "would have acted" and every vetoed
intent — lands in the trace ring as a ``controller_decision`` event, in
the ``/statusz`` controller block (last-N ring), and in the
``fleet.controller.decisions`` counter family.  ``dry_run = true`` (the
shipping default) runs the identical decide path — same hysteresis
bookkeeping, same cooldown stamps, same decision stream — and skips only
the actuator call, so an operator can watch what the controller *would*
do for days before arming it.

The **live split** (:func:`run_live_split`) is the one actuator that
needed new machinery: ``fleet/split.py`` recovers the source partition
from its stopped files, but the controller must split a *serving*
daemon.  The live variant writes the same resumable manifest, then runs
export → copy → map-flip as one synchronous critical section on the
event loop — no await between the consistent cut and the ownership flip,
so no handler can observe a half-exported state.  That alone fences only
handlers whose ownership check and mutation share one synchronous
section; a multi-await handler (``VerifyProof`` awaits the batcher
between its entry check and ``create_session``, ``register`` awaits the
shard lock) can straddle the flip, which is why every acknowledged
user-keyed mutation ALSO re-verifies ownership at write time through
``ServerState.owner_fence`` — inside the shard lock, synchronously with
the mutation — and answers a post-flip write with the standard redirect
instead of an ack (see ``server/state.py``).  The serving pause the
critical section buys is proportional to the moved subset, which is
exactly why the controller fires it *before* the capacity cliff rather
than at it.  A crash at any point leaves the standard manifest; the
offline ``python -m cpzk_tpu_torch.fleet split`` resume completes it.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field

from ..server import metrics
from .partition_map import PartitionMap, user_hash
from .split import MANIFEST_SCHEMA, SplitError, _write_manifest, manifest_path

log = logging.getLogger("cpzk_tpu_torch.fleet.controller")

#: Trace-ring event name carried by every decision (dry-run included).
DECISION_EVENT = "controller_decision"

#: The actions the controller can take (decision ``action`` values).
ACTION_SPLIT = "split"
ACTION_LANE_DRAIN = "lane_drain"
ACTION_LANE_READMIT = "lane_readmit"
ACTION_ADMISSION_SHRINK = "admission_shrink"
ACTION_ADMISSION_RESTORE = "admission_restore"


@dataclass
class Signals:
    """One tick's view of the planes the controller watches.  ``None``
    means the plane is absent on this daemon (no fleet, single lane, no
    SLO engine) — absent planes simply produce no intents."""

    users: int | None = None            # users on THIS partition
    lock_wait_ms: float | None = None   # mean shard lock-wait since last tick
    lanes: list[dict] = field(default_factory=list)
    paging: bool | None = None          # the watched RPC is burn-paging
    manifest: bool = False              # an unfinished split manifest exists
    promoting: bool = False             # this daemon is (or is mid-) standby


@dataclass
class Decision:
    """One decision the controller made — acted, dry-run, or vetoed."""

    action: str
    target: str           # partition index, lane label, or the SLO rpc
    reason: str           # the signal that crossed its envelope
    dry_run: bool
    fired: bool = False   # the actuator actually ran
    veto: str | None = None  # why an eligible intent did NOT act
    at: float = 0.0       # wall-clock time of the decision
    detail: dict = field(default_factory=dict)

    def row(self) -> dict:
        return {
            "action": self.action,
            "target": self.target,
            "reason": self.reason,
            "dry_run": self.dry_run,
            "fired": self.fired,
            "veto": self.veto,
            "at": self.at,
            "detail": self.detail,
        }


class FleetController:
    """The control loop (see module docstring).  All constructor planes
    are optional: a daemon without a fleet router simply never produces a
    split intent, one without a lane router never drains, and tests
    inject exactly the planes a scenario needs.

    ``clock`` is injectable monotonic time (hysteresis, cooldowns) and
    ``wall`` injectable wall time (decision timestamps)."""

    def __init__(
        self,
        settings,
        *,
        state=None,
        router=None,
        admission=None,
        slo=None,
        fleet=None,
        durability=None,
        replica=None,
        epoch_file: str = "",
        segment_bytes: int = 65536,
        clock=time.monotonic,
        wall=time.time,
    ):
        self.settings = settings
        self.state = state
        self.router = router
        self.admission = admission
        self.slo = slo
        self.fleet = fleet
        self.durability = durability
        self.replica = replica
        self.epoch_file = epoch_file
        self.segment_bytes = segment_bytes
        self._clock = clock
        self._wall = wall
        self.ticks = 0
        self.decisions: deque[Decision] = deque(
            maxlen=max(1, settings.decision_ring)
        )
        self.acting = False  # one action in flight at a time (structural)
        # hysteresis state: consecutive hot/clear tick counts per signal
        self._split_hot = 0
        self._paging_hot = 0
        self._paging_clear = 0
        #: lane label -> clock time the breaker was first seen OPEN
        self._lane_open_since: dict[str, float] = {}
        #: lane label -> consecutive CLOSED observations while drained
        self._lane_closed_ticks: dict[str, int] = {}
        #: lane label -> clock time the controller drained it
        self._lane_drained_at: dict[str, float] = {}
        # per-action cooldown stamps (clock time of the last armed action)
        self._cooldown_until: dict[str, float] = {}
        # undo record of THE decision decide() committed this tick, for
        # rollback + error backoff when the live actuator raises
        self._pending_undo: dict | None = None
        # lock-wait histogram baseline for the per-tick delta
        self._lw_count, self._lw_sum = metrics.read_histogram(
            "state.shard.lock_wait"
        )
        metrics.gauge("fleet.controller.dry_run").set(
            1.0 if settings.dry_run else 0.0
        )

    # -- signal collection ---------------------------------------------------

    def collect(self) -> Signals:
        """One snapshot of every attached plane.  Runs on the event loop;
        every read is a synchronous in-process call."""
        sig = Signals()
        if self.state is not None and self.fleet is not None:
            sig.users = sum(
                row["users"] for row in self.state.shard_stats()
            )
            count, total = metrics.read_histogram("state.shard.lock_wait")
            d_count = count - self._lw_count
            d_sum = total - self._lw_sum
            self._lw_count, self._lw_sum = count, total
            sig.lock_wait_ms = (
                (d_sum / d_count) * 1000.0 if d_count > 0 else 0.0
            )
        if self.router is not None:
            sig.lanes = self.router.lane_states()
        if self.slo is not None:
            view = self.slo.snapshot().get("rpcs") or {}
            rpc = view.get(self.settings.slo_rpc)
            sig.paging = bool(rpc and rpc.get("paging"))
        if self.fleet is not None and self.fleet.map_path:
            sig.manifest = os.path.exists(
                manifest_path(self.fleet.map_path)
            )
        if self.replica is not None:
            sig.promoting = getattr(self.replica, "role", "primary") != "primary"
        return sig

    # -- decide (pure over Signals + internal hysteresis state) --------------

    def decide(self, sig: Signals) -> list[Decision]:
        """Turn one signal snapshot into decisions.  Identical in dry-run
        and live mode: hysteresis counters, cooldown stamps, and the
        decision stream never depend on ``dry_run`` — only the actuator
        call (which :meth:`tick` performs) does.

        The ``_decide_*`` helpers are PURE over the arm state: they
        accumulate hysteresis and attach veto reasons but never stamp a
        cooldown or reset a counter.  Only after the single-action rail
        has picked THE action of this tick does :meth:`_commit` consume
        its cooldown + hysteresis — so a same-tick runner-up vetoed as
        ``single-action`` keeps its accumulated eligibility and can fire
        on the very next tick instead of re-paying a full cooldown plus
        ``act_ticks`` of re-accumulation for an action that never ran."""
        now = self._clock()
        out: list[Decision] = []
        self._decide_split(sig, now, out)
        self._decide_lanes(sig, now, out)
        self._decide_admission(sig, now, out)
        # single-action rail: the FIRST armed decision this tick keeps its
        # eligibility; every later armed decision waits for a future tick
        armed = [d for d in out if d.veto is None]
        for d in armed[1:]:
            d.veto = "single-action"
        self._pending_undo = None
        if armed:
            self._pending_undo = self._commit(armed[0], now)
        return out

    def _commit(self, d: Decision, now: float) -> dict:
        """Consume the selected action's cooldown + hysteresis — called
        for exactly ONE decision per tick, after the single-action rail.
        Returns the undo record :meth:`_rollback` needs when the live
        actuator subsequently fails."""
        s = self.settings
        a, t = d.action, d.target
        undo: dict = {"action": a, "target": t}
        if a == ACTION_SPLIT:
            undo["split_hot"] = self._split_hot
            self._arm(a, now, s.split_cooldown_s)
            self._split_hot = 0
        elif a == ACTION_LANE_DRAIN:
            undo["open_since"] = self._lane_open_since.pop(t, None)
            undo["drained_at"] = self._lane_drained_at.get(t)
            undo["closed_ticks"] = self._lane_closed_ticks.get(t, 0)
            self._lane_drained_at[t] = now
            self._lane_closed_ticks[t] = 0
        elif a == ACTION_LANE_READMIT:
            undo["drained_at"] = self._lane_drained_at.pop(t, None)
            undo["closed_ticks"] = self._lane_closed_ticks.get(t, 0)
            self._lane_closed_ticks[t] = 0
        elif a in (ACTION_ADMISSION_SHRINK, ACTION_ADMISSION_RESTORE):
            undo["paging_hot"] = self._paging_hot
            undo["paging_clear"] = self._paging_clear
            self._arm(a, now, s.admission_cooldown_s)
            self._paging_hot = 0
            self._paging_clear = 0
        return undo

    def _rollback(self, d: Decision, undo: dict, now: float) -> None:
        """A live actuator raised: restore the hysteresis/bookkeeping the
        commit consumed (nothing actually changed in the planes) and
        replace the full cooldown with the short ``error_backoff_s`` —
        a transient actuator failure must not block the retry for e.g.
        the 600 s split cooldown, but the very next tick hammering a
        broken actuator helps nobody either."""
        a, t = d.action, d.target
        if a == ACTION_SPLIT:
            self._split_hot = undo["split_hot"]
        elif a == ACTION_LANE_DRAIN:
            if undo["open_since"] is not None:
                self._lane_open_since[t] = undo["open_since"]
            if undo["drained_at"] is None:
                self._lane_drained_at.pop(t, None)   # it is NOT drained
            else:
                self._lane_drained_at[t] = undo["drained_at"]
            self._lane_closed_ticks[t] = undo["closed_ticks"]
        elif a == ACTION_LANE_READMIT:
            if undo["drained_at"] is not None:       # it is STILL drained
                self._lane_drained_at[t] = undo["drained_at"]
            self._lane_closed_ticks[t] = undo["closed_ticks"]
        elif a in (ACTION_ADMISSION_SHRINK, ACTION_ADMISSION_RESTORE):
            self._paging_hot = undo["paging_hot"]
            self._paging_clear = undo["paging_clear"]
        self._arm(a, now, self.settings.error_backoff_s)

    def _cooled(self, kind: str, now: float) -> bool:
        return now >= self._cooldown_until.get(kind, 0.0)

    def _arm(self, kind: str, now: float, cooldown_s: float) -> None:
        self._cooldown_until[kind] = now + cooldown_s

    def _decide_split(
        self, sig: Signals, now: float, out: list[Decision]
    ) -> None:
        s = self.settings
        armed = (
            s.split_target_address
            and (s.split_user_threshold > 0 or s.split_lock_wait_ms > 0)
        )
        if not armed or sig.users is None:
            self._split_hot = 0
            return
        reasons = []
        if 0 < s.split_user_threshold <= sig.users:
            reasons.append(
                f"users {sig.users} >= {s.split_user_threshold}"
            )
        if (
            s.split_lock_wait_ms > 0
            and sig.lock_wait_ms is not None
            and sig.lock_wait_ms >= s.split_lock_wait_ms
        ):
            reasons.append(
                f"lock_wait {sig.lock_wait_ms:.1f}ms >= "
                f"{s.split_lock_wait_ms:.1f}ms"
            )
        if not reasons:
            self._split_hot = 0
            return
        self._split_hot += 1
        if self._split_hot < s.act_ticks:
            return
        d = Decision(
            action=ACTION_SPLIT,
            target=str(self.fleet.self_index if self.fleet else -1),
            reason="; ".join(reasons),
            dry_run=s.dry_run,
            at=self._wall(),
            detail={
                "new_address": s.split_target_address,
                "hot_ticks": self._split_hot,
            },
        )
        if sig.manifest:
            d.veto = "split-manifest"       # never split over an unfinished one
        elif sig.promoting:
            d.veto = "promotion"            # never split during promotion
        elif self.acting:
            d.veto = "action-in-flight"
        elif not self._cooled(ACTION_SPLIT, now):
            d.veto = "cooldown"
        out.append(d)

    def _decide_lanes(
        self, sig: Signals, now: float, out: list[Decision]
    ) -> None:
        s = self.settings
        seen = set()
        for lane in sig.lanes:
            label = lane["lane"]
            seen.add(label)
            is_open = lane["breaker"] == "open"
            if lane["drained"]:
                # recovery path: the breaker re-closes through its probe
                # traffic; clear_ticks consecutive CLOSED observations
                # past the lane cooldown earn re-admission
                if lane["breaker"] == "closed":
                    self._lane_closed_ticks[label] = (
                        self._lane_closed_ticks.get(label, 0) + 1
                    )
                else:
                    self._lane_closed_ticks[label] = 0
                drained_at = self._lane_drained_at.get(label, now)
                if (
                    self._lane_closed_ticks.get(label, 0) >= s.clear_ticks
                    and now - drained_at >= s.lane_cooldown_s
                ):
                    d = Decision(
                        action=ACTION_LANE_READMIT,
                        target=label,
                        reason=(
                            f"breaker closed for {s.clear_ticks} ticks "
                            f"after drain"
                        ),
                        dry_run=s.dry_run,
                        at=self._wall(),
                    )
                    if self.acting:
                        d.veto = "action-in-flight"
                    elif not self._cooled(ACTION_LANE_READMIT, now):
                        d.veto = "cooldown"  # error backoff after a failed
                    out.append(d)            # readmit actuation
                continue
            if not is_open:
                self._lane_open_since.pop(label, None)
                continue
            opened = self._lane_open_since.setdefault(label, now)
            open_for = now - opened
            if open_for < s.lane_open_after_s:
                continue
            d = Decision(
                action=ACTION_LANE_DRAIN,
                target=label,
                reason=(
                    f"breaker OPEN for {open_for:.1f}s >= "
                    f"{s.lane_open_after_s:.1f}s"
                ),
                dry_run=s.dry_run,
                at=self._wall(),
                detail={"pending": lane["pending"]},
            )
            if self.acting:
                d.veto = "action-in-flight"
            elif not self._cooled(ACTION_LANE_DRAIN, now):
                d.veto = "cooldown"          # error backoff after a failed
            out.append(d)                    # drain actuation
        for label in list(self._lane_open_since):
            if label not in seen:
                del self._lane_open_since[label]

    def _decide_admission(
        self, sig: Signals, now: float, out: list[Decision]
    ) -> None:
        s = self.settings
        if sig.paging is None or self.admission is None:
            return
        from ..admission.controller import MIN_LEVEL, N_TIERS

        cap = self.admission.level_cap
        if sig.paging:
            self._paging_clear = 0
            self._paging_hot += 1
            if self._paging_hot < s.act_ticks or cap <= MIN_LEVEL:
                return
            d = Decision(
                action=ACTION_ADMISSION_SHRINK,
                target=s.slo_rpc,
                reason=(
                    f"{s.slo_rpc} burn paging for {self._paging_hot} ticks"
                ),
                dry_run=s.dry_run,
                at=self._wall(),
                detail={"cap": cap, "new_cap": max(MIN_LEVEL, cap - 1.0)},
            )
            if self.acting:
                d.veto = "action-in-flight"
            elif not self._cooled(ACTION_ADMISSION_SHRINK, now):
                d.veto = "cooldown"
            out.append(d)
        else:
            self._paging_hot = 0
            if cap >= float(N_TIERS):
                self._paging_clear = 0
                return
            self._paging_clear += 1
            if self._paging_clear < s.clear_ticks:
                return
            d = Decision(
                action=ACTION_ADMISSION_RESTORE,
                target=s.slo_rpc,
                reason=(
                    f"{s.slo_rpc} burn clear for {self._paging_clear} ticks"
                ),
                dry_run=s.dry_run,
                at=self._wall(),
                detail={"cap": cap, "new_cap": min(float(N_TIERS), cap + 1.0)},
            )
            if self.acting:
                d.veto = "action-in-flight"
            elif not self._cooled(ACTION_ADMISSION_RESTORE, now):
                d.veto = "cooldown"
            out.append(d)

    # -- the tick ------------------------------------------------------------

    async def tick(self) -> list[Decision]:
        """One control-loop iteration: collect, decide, publish every
        decision, and run at most one actuator (live mode only)."""
        self.ticks += 1
        metrics.counter("fleet.controller.ticks").inc()
        decisions = self.decide(self.collect())
        for d in decisions:
            await self._publish_and_act(d)
        return decisions

    async def _publish_and_act(self, d: Decision) -> None:
        eligible = d.veto is None
        if eligible and not self.settings.dry_run:
            self.acting = True
            try:
                await self._act(d)
                d.fired = True
            except Exception as e:
                d.veto = f"actuator-error: {e}"
                # nothing changed in the planes: give the consumed
                # cooldown + hysteresis back and retry after the short
                # error backoff instead of a full action cooldown
                if self._pending_undo is not None:
                    self._rollback(d, self._pending_undo, self._clock())
                    self._pending_undo = None
                log.exception(
                    "controller %s on %s failed", d.action, d.target
                )
            finally:
                self.acting = False
        outcome = (
            "fired" if d.fired
            else "dry_run" if eligible
            else "veto"
        )
        metrics.counter(
            "fleet.controller.decisions", labelnames=("action", "outcome")
        ).labels(action=d.action, outcome=outcome).inc()
        self.decisions.append(d)
        level = logging.INFO if d.fired or eligible else logging.DEBUG
        log.log(
            level, "controller decision: %s %s (%s) -> %s",
            d.action, d.target, d.reason, outcome,
        )
        try:
            from ..observability import get_tracer

            get_tracer().record_event(
                DECISION_EVENT,
                action=d.action, target=d.target, reason=d.reason,
                dry_run=d.dry_run, fired=d.fired, veto=d.veto or "",
            )
        except Exception:  # pragma: no cover - observability optional
            pass

    async def _act(self, d: Decision) -> None:
        if d.action == ACTION_SPLIT:
            report = await run_live_split(
                map_path=self.fleet.map_path,
                source=self.fleet.self_index,
                new_address=self.settings.split_target_address,
                state=self.state,
                fleet=self.fleet,
                durability=self.durability,
                epoch_file=self.epoch_file,
                segment_bytes=self.segment_bytes,
            )
            d.detail["report"] = {
                k: report[k] for k in (
                    "new_version", "new_index", "moved_users",
                    "moved_records", "target_state_file", "critical_section_s",
                )
            }
        elif d.action == ACTION_LANE_DRAIN:
            self.router.drain_lane(d.target)
        elif d.action == ACTION_LANE_READMIT:
            self.router.readmit_lane(d.target)
        elif d.action == ACTION_ADMISSION_SHRINK:
            self.admission.set_level_cap(d.detail["new_cap"])
        elif d.action == ACTION_ADMISSION_RESTORE:
            self.admission.set_level_cap(d.detail["new_cap"])
        else:  # pragma: no cover - decide() only emits the five above
            raise SplitError(f"unknown controller action {d.action!r}")

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """The ``/statusz`` controller block."""
        now = self._clock()
        return {
            "enabled": self.settings.enabled,
            "dry_run": self.settings.dry_run,
            "ticks": self.ticks,
            "acting": self.acting,
            "cooldowns_s": {
                kind: round(max(0.0, until - now), 1)
                for kind, until in self._cooldown_until.items()
                if until > now
            },
            "drained_lanes": sorted(self._lane_drained_at),
            "decisions": [d.row() for d in self.decisions],
        }


# -- the live split actuator -------------------------------------------------

async def run_live_split(
    *,
    map_path: str,
    source: int,
    new_address: str,
    state,
    fleet=None,
    durability=None,
    epoch_file: str = "",
    segment_bytes: int = 65536,
) -> dict:
    """Split a SERVING partition in-process: same manifest, same segment
    trust boundary, same map flip as ``fleet/split.py``, but the source
    is the daemon's live ``ServerState`` instead of stopped files.

    Correctness hinges on two structural properties that together
    totally order every acknowledged write against the cut:

    1. **export → copy → flip runs with no await point**, so the
       single-threaded event loop guarantees no handler interleaves
       between the consistent cut and the ownership flip;
    2. **every acknowledged user-keyed mutation re-verifies ownership
       at write time** (``ServerState.owner_fence``, checked inside the
       shard lock in the same synchronous section as the mutation) —
       a handler that passed its entry ownership check but resumed
       from a later await (the batcher, a shard lock) after the flip
       is answered with the redirect, not an ack.

    An acknowledged write therefore either precedes the export (and
    ships) or follows the flip (and redirects); nothing acked can land
    on a stale copy for ``drop_users`` to discard.  The drain (drop +
    covering checkpoint) runs after the flip, when both fences already
    reject the moved users.

    A crash at any point leaves the standard resumable manifest; the
    offline ``python -m cpzk_tpu_torch.fleet split`` run completes the split
    from whatever stage the crash left (the controller never starts a
    second split while a manifest exists).
    """
    from ..durability.wal import WriteAheadLog
    from ..replication.segments import split_records
    from ..replication.standby import SegmentApplier, load_epoch, store_epoch
    from ..server.state import ServerState

    if segment_bytes < 1:
        raise SplitError("segment_bytes must be positive")
    mpath = manifest_path(map_path)
    if os.path.exists(mpath):
        raise SplitError(
            f"a split manifest already exists: {mpath} — finish it with "
            "the offline `fleet split` resume first"
        )
    current = PartitionMap.load(map_path)
    new_map, moved = current.split(source, new_address)
    new_index = len(current.partitions)
    target_dir = os.path.dirname(os.path.abspath(map_path)) or "."
    target_state_file = os.path.join(
        target_dir, f"partition-{new_index}.state.json"
    )
    target_wal = target_state_file + ".wal"
    target_epoch_file = target_state_file + ".epoch"
    epoch = (load_epoch(epoch_file) if epoch_file else 0) + 1
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "old_version": current.version,
        "new_version": new_map.version,
        "source": source,
        "new_index": new_index,
        "new_address": new_address,
        "moved": [[lo, hi] for lo, hi in moved],
        "epoch": epoch,
    }
    _write_manifest(mpath, manifest)
    moved_ranges = [(int(lo), int(hi)) for lo, hi in moved]

    def moved_user(uid: str) -> bool:
        h = user_hash(uid)
        return any(lo <= h < hi for lo, hi in moved_ranges)

    # ---- critical section: export -> copy -> flip, NO await ----------------
    # (synchronous on the event loop; the serving pause is the price of a
    # consistent cut + atomic ownership edge without stopping the daemon)
    t_cut = time.perf_counter()
    records = state.export_user_records(moved_user)
    for seq, rec in enumerate(records, start=1):
        rec["seq"] = seq
    for stale in (target_state_file, target_wal, target_epoch_file):
        try:
            os.unlink(stale)
        except OSError:
            pass
    # the new partition holds the moved users under the source's capacity
    # caps: the default caps would skip every record past them (and lose
    # acknowledged registrations) once a split moves more users than that
    tgt_state = ServerState(max_users=state.max_users,
                            max_challenges=state.max_challenges,
                            max_sessions=state.max_sessions)
    twal = WriteAheadLog(target_wal, fsync="always")

    def sink(frames: bytes, last_seq: int) -> None:
        twal.append_frames(frames, last_seq)   # durable-before-apply
        twal.sync(force=True)

    applier = SegmentApplier(tgt_state, epoch=epoch, sink=sink)
    segments = split_records(records, epoch, 0, segment_bytes)
    for seg in segments:
        accepted, message = applier.apply(seg)
        if not accepted:
            twal.close()
            raise SplitError(f"target refused segment {seg.index}: {message}")
    new_map.store(map_path)        # the atomic ownership edge
    if fleet is not None:
        fleet.reload()
    critical_section_s = time.perf_counter() - t_cut
    # ---- end critical section ----------------------------------------------

    # covering snapshot + fencing epoch for the new partition's first boot
    # (its WAL already holds every frame durably; this is the tidy boot)
    tgt_state.attach_journal(twal)
    await tgt_state.snapshot(target_state_file)
    twal.close()
    store_epoch(target_epoch_file, epoch)

    # drain: the moved users are fenced by ownership enforcement from the
    # flip onward, so dropping their stale copies cannot lose a write
    dropped = state.drop_users(moved_user)
    if durability is not None:
        await durability.checkpoint()
    try:
        os.unlink(mpath)
    except OSError:
        pass
    report = {
        "old_version": current.version,
        "new_version": new_map.version,
        "source": source,
        "new_index": new_index,
        "new_address": new_address,
        "moved_ranges": [list(r) for r in moved_ranges],
        "epoch": epoch,
        "moved_users": sum(
            1 for r in records if r["type"] == "register_user"
        ),
        "moved_records": len(records),
        "segments": len(segments),
        "dropped_users": dropped[0],
        "dropped_challenges": dropped[1],
        "dropped_sessions": dropped[2],
        "target_state_file": target_state_file,
        "critical_section_s": critical_section_s,
    }
    log.warning(
        "live split complete: map v%d -> v%d, partition %d -> new "
        "partition %d (%s), %d users moved in a %.3f s serving pause; boot the new "
        "daemon from %s",
        report["old_version"], report["new_version"], source, new_index,
        new_address, report["moved_users"], critical_section_s, target_state_file,
    )
    return report
