"""Multi-device serving plane: per-device dispatch lanes behind a
deadline-aware router.

Port of ``cpzk_tpu/server/router.py``.

- **N per-device lanes**: one :class:`~cpzk_tpu_torch.server.dispatch
  .DispatchLane` per device, each holding its own backend pinned to its
  device (``TorchBackend(device=...)``, whose every call runs under
  :func:`~cpzk_tpu_torch.ops.backend.device_scope` on the lane's device
  thread).  N devices, N independent batch streams, no collective on the
  hot path.

- **Deadline-aware placement**: each settled batch goes to the lane with
  the shortest *predicted completion* — pending entries over the lane's
  drain-rate EWMA (a cold lane borrows the fleet's mean rate) — so a slow
  or backlogged device sheds new work to its siblings.  Ties break
  round-robin.

- **Per-lane breaker**: a :class:`~cpzk_tpu_torch.resilience.breaker
  .CircuitBreaker` per device.  A backend raise opens only that lane's
  breaker; the router skips OPEN lanes, so one sick device degrades the
  fleet by exactly one lane.  After the cooldown the breaker goes
  HALF_OPEN and the next batch routes to the sick lane as its *probe*:
  success re-closes it, failure re-opens it.  With every breaker OPEN the
  router routes anyway (least-loaded): refusing all work is strictly worse
  than trying.  A failing batch fails (or re-routes) as the reference's
  does; nothing here switches to the host.

- **Mesh path for big batches**: at or above ``mesh_threshold`` entries
  (a ``[tpu]`` knob, default off) a batch routes to a dedicated mesh lane
  whose backend shards it over the lane devices
  (:mod:`cpzk_tpu_torch.parallel.mesh`).

The single-lane configuration (``[tpu] lanes = 1``, the default) never
constructs a router: :class:`~cpzk_tpu_torch.server.batching
.DynamicBatcher` keeps its direct lane.

Offline hosts (the bulk audit pipeline) attach via
:meth:`LaneRouter.start_in_thread` + :meth:`LaneRouter.verify_blocking`,
which fans each quantum across every routable lane from a daemon-thread
event loop.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from dataclasses import dataclass

from ..core.rng import SecureRng
from ..resilience.breaker import (
    ROUTE_FALLBACK,
    ROUTE_PRIMARY,
    ROUTE_PROBE,
    BreakerState,
    CircuitBreaker,
)
from . import metrics
from .dispatch import DispatchLane, LaneStopped

log = logging.getLogger("cpzk_tpu_torch.server.router")

#: Lane label of the mesh path in metrics / flight records / statusz.
MESH_LANE = "mesh"


@dataclass
class _LaneSlot:
    """One routable lane: its dispatch lane, breaker, and load signals."""

    lane: DispatchLane
    breaker: CircuitBreaker
    device: object | None = None
    label: str = "0"
    pending: int = 0          # entries submitted, not yet settled
    dispatches: int = 0
    errors: int = 0
    drain_rate: float = 0.0   # entries/s EWMA
    drained_at: float | None = None
    probes: int = 0
    stages_lane: int | str = 0
    drained: bool = False     # administratively out of rotation (the
                              # fleet controller's brownout actuator);
                              # distinct from the breaker, which keeps
                              # probing a drained lane's sick backend

    def note_drain(self, n: int, now: float) -> None:
        if self.drained_at is not None:
            dt = now - self.drained_at
            if dt > 0:
                inst = n / dt
                self.drain_rate = (
                    inst if self.drain_rate == 0.0
                    else 0.8 * self.drain_rate + 0.2 * inst
                )
        self.drained_at = now


class LaneRouter:
    """Deadline-aware placement over N per-device dispatch lanes (see
    module docstring).

    ``backends`` is one verifier backend per lane, each already pinned
    to its device; ``devices`` is the matching device list (None entries
    allowed, for host backends).  ``mesh_backend`` (optional) serves
    batches of ``mesh_threshold``+ entries through the sharded kernels.
    """

    def __init__(
        self,
        backends: list,
        devices: list | None = None,
        rng: SecureRng | None = None,
        overlap: bool = True,
        staging_slots: int = 1,
        recovery_after_s: float | None = 30.0,
        mesh_backend=None,
        mesh_threshold: int = 0,
        clock=time.monotonic,
    ):
        if not backends:
            raise ValueError("LaneRouter needs at least one lane backend")
        if devices is not None and len(devices) != len(backends):
            raise ValueError(
                f"{len(backends)} lane backends but {len(devices)} devices"
            )
        self._rng = rng or SecureRng()
        self._clock = clock
        self._lock = threading.Lock()
        self._rr = 0  # tie-break rotation
        self._slots: list[_LaneSlot] = []
        for i, backend in enumerate(backends):
            device = devices[i] if devices is not None else None
            self._slots.append(self._make_slot(
                backend, str(i), i, device,
                overlap=overlap, staging_slots=staging_slots,
                recovery_after_s=recovery_after_s,
            ))
        self._mesh_slot: _LaneSlot | None = None
        self._mesh_threshold = max(0, mesh_threshold)
        if mesh_backend is not None and self._mesh_threshold > 0:
            self._mesh_slot = self._make_slot(
                mesh_backend, MESH_LANE, MESH_LANE, None,
                overlap=overlap, staging_slots=staging_slots,
                recovery_after_s=recovery_after_s,
            )
        self._started = False
        self._stopping = False
        self._thread: threading.Thread | None = None
        self._thread_loop: asyncio.AbstractEventLoop | None = None

    def _make_slot(
        self, backend, label: str, stages_lane, device,
        overlap: bool, staging_slots: int, recovery_after_s: float | None,
    ) -> _LaneSlot:
        slot = _LaneSlot(
            lane=DispatchLane(
                backend, rng=self._rng, overlap=overlap,
                staging_slots=staging_slots, name=f"cpzk-lane{label}",
            ),
            breaker=CircuitBreaker(
                recovery_after_s=recovery_after_s, clock=self._clock,
                on_transition=self._transition_hook(label),
            ),
            device=device,
            label=label,
            stages_lane=stages_lane,
        )
        return slot

    def _transition_hook(self, label: str):
        def hook(old: BreakerState, new: BreakerState) -> None:
            level = logging.WARNING if new is BreakerState.OPEN else logging.INFO
            log.log(
                level, "lane %s breaker %s -> %s%s", label, old.value,
                new.value,
                " (lane skipped until probe succeeds)"
                if new is BreakerState.OPEN else "",
            )
            try:
                from ..observability import get_tracer

                get_tracer().record_event(
                    "lane_breaker", lane=label, old=old.value, new=new.value,
                )
            except Exception:  # pragma: no cover - observability optional
                pass

        return hook

    # -- lifecycle -----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._started and not self._stopping

    @property
    def lane_count(self) -> int:
        return len(self._slots)

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for slot in self._all_slots():
            slot.lane.start()
        metrics.gauge("tpu.lanes").set(len(self._slots))

    async def stop(self) -> None:
        """Drain-then-join every lane: each lane resolves every accepted
        future exactly once (the DispatchLane shutdown contract, fanned
        out over N lanes)."""
        self._stopping = True
        await asyncio.gather(*[s.lane.stop() for s in self._all_slots()])

    def _all_slots(self) -> list[_LaneSlot]:
        slots = list(self._slots)
        if self._mesh_slot is not None:
            slots.append(self._mesh_slot)
        return slots

    # -- placement -----------------------------------------------------------

    def _predicted_s(self, slot: _LaneSlot, n: int, mean_rate: float) -> float:
        """Predicted completion (seconds) of n more entries on this lane:
        queue depth over drain rate.  A lane that has never drained
        borrows the fleet's mean rate so cold lanes still fill."""
        rate = slot.drain_rate if slot.drain_rate > 0 else mean_rate
        backlog = slot.pending + n
        return backlog / rate if rate > 0 else float(backlog)

    def _pick(self, n: int) -> tuple[_LaneSlot, bool]:
        """(slot, is_probe) for one batch.  Mesh routing happens in
        :meth:`submit` before this runs; here only the per-device lanes
        compete."""
        with self._lock:
            # a drained lane takes no PRIMARY placement but still gets its
            # HALF_OPEN probes — recovery must stay provable while the
            # fleet controller holds the lane out of rotation, or it could
            # never earn re-admission.
            routable: list[_LaneSlot] = []
            probe: _LaneSlot | None = None
            for slot in self._slots:
                route = slot.breaker.acquire()
                if route == ROUTE_PRIMARY:
                    if not slot.drained:
                        routable.append(slot)
                elif route == ROUTE_PROBE and probe is None:
                    probe = slot  # this batch becomes the lane's probe
            if probe is not None:
                probe.probes += 1
                return probe, True
            # all OPEN (or all drained): route anyway — refusing every
            # batch is strictly worse than trying the sick pool
            pool = (
                routable
                or [s for s in self._slots if not s.drained]
                or self._slots
            )
            if not routable:
                metrics.counter("tpu.lane.all_open").inc()
            rates = [s.drain_rate for s in pool if s.drain_rate > 0]
            mean_rate = sum(rates) / len(rates) if rates else 0.0
            self._rr += 1
            best = min(
                range(len(pool)),
                key=lambda k: (
                    self._predicted_s(pool[k], n, mean_rate),
                    (k + self._rr) % len(pool),
                ),
            )
            return pool[best], False

    # -- submission (event-loop side) ----------------------------------------

    def submit(self, entries: list, stages) -> asyncio.Future:
        """Route one settled batch to a lane; returns the lane's future.
        Raises :class:`LaneStopped` once :meth:`stop` has begun (the
        batcher falls back to its inline seam, same as the single-lane
        path)."""
        if not self.running:
            raise LaneStopped("lane router is not accepting work")
        slot: _LaneSlot | None = None
        probe = False
        if (
            self._mesh_slot is not None
            and len(entries) >= self._mesh_threshold
        ):
            # big-batch mesh path: one sharded call over every lane device.
            # The acquire doubles as the mesh breaker's routing decision:
            # after a mesh blow-up, big batches fall back to per-device
            # placement until a HALF_OPEN probe batch succeeds.
            route = self._mesh_slot.breaker.acquire()
            if route != ROUTE_FALLBACK:
                slot = self._mesh_slot
                probe = route == ROUTE_PROBE
                if probe:
                    with self._lock:
                        slot.probes += 1
        if slot is None:
            slot, probe = self._pick(len(entries))
        if stages is not None:
            stages.lane = slot.stages_lane
        n = len(entries)
        with self._lock:
            slot.pending += n
            slot.dispatches += 1
        try:
            fut = slot.lane.submit(entries, stages)
        except LaneStopped:
            with self._lock:
                slot.pending = max(0, slot.pending - n)
                slot.dispatches -= 1
            if probe:
                slot.breaker.release_probe()
            raise
        metrics.counter(
            "tpu.lane.dispatches", labelnames=("lane",)
        ).labels(lane=slot.label).inc()
        metrics.gauge(
            "tpu.lane.depth", labelnames=("lane",)
        ).labels(lane=slot.label).set(slot.pending)
        fut.add_done_callback(
            lambda f, s=slot, k=n, p=probe: self._settled(s, k, p, f)
        )
        return fut

    def _settled(self, slot: _LaneSlot, n: int, probe: bool, fut) -> None:
        now = self._clock()
        if fut.cancelled():
            exc: BaseException | None = None
            outcome_known = False
        else:
            exc = fut.exception()
            outcome_known = True
        with self._lock:
            slot.pending = max(0, slot.pending - n)
            if outcome_known and exc is None:
                slot.note_drain(n, now)
            if exc is not None:
                slot.errors += 1
            pending = slot.pending
        metrics.gauge(
            "tpu.lane.depth", labelnames=("lane",)
        ).labels(lane=slot.label).set(pending)
        if not outcome_known:
            # cancelled future: nobody observed the verify — hand an
            # unused probe back so the NEXT batch probes immediately
            if probe:
                slot.breaker.release_probe()
            return
        if exc is not None:
            metrics.counter(
                "tpu.lane.errors", labelnames=("lane",)
            ).labels(lane=slot.label).inc()
            if probe:
                slot.breaker.probe_failed()
            else:
                if slot.breaker.record_failure():
                    log.warning(
                        "lane %s backend raised (%s): breaker OPEN, "
                        "routing around it", slot.label, exc,
                    )
        elif probe:
            slot.breaker.probe_succeeded()
            log.info("lane %s probe succeeded: lane re-admitted", slot.label)

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        """The ``/statusz`` lanes block: one row per lane plus the mesh
        lane when configured."""
        with self._lock:
            rows = [self._slot_row(s) for s in self._slots]
            mesh = (
                self._slot_row(self._mesh_slot)
                if self._mesh_slot is not None else None
            )
        return {
            "lanes": rows,
            "mesh": mesh,
            "mesh_threshold": self._mesh_threshold,
        }

    def _slot_row(self, slot: _LaneSlot) -> dict:
        ingress, staged = slot.lane.depths()
        return {
            "lane": slot.label,
            "device": str(slot.device) if slot.device is not None else None,
            "breaker": slot.breaker.state.value,
            "dispatches": slot.dispatches,
            "errors": slot.errors,
            "probes": slot.probes,
            "pending_entries": slot.pending,
            "queued_batches": ingress + staged,
            "drain_rate_per_s": round(slot.drain_rate, 3),
            "drained": slot.drained,
        }

    # -- administrative drain (fleet controller actuator) --------------------

    def lane_states(self) -> list[dict]:
        """Per-device lane signal rows for the fleet controller: label,
        breaker state, drained flag, pending depth.  Mesh lane excluded —
        the controller rebalances the per-device pool only."""
        with self._lock:
            return [
                {
                    "lane": s.label,
                    "breaker": s.breaker.state.value,
                    "drained": s.drained,
                    "pending": s.pending,
                }
                for s in self._slots
            ]

    def drain_lane(self, label: str) -> bool:
        """Take one per-device lane out of placement rotation (its pending
        work still settles; new batches rebalance across siblings).  True
        when the flag flipped, False for unknown labels or no-ops."""
        return self._set_drained(label, True)

    def readmit_lane(self, label: str) -> bool:
        """Put a drained lane back in rotation.  The breaker still rules:
        a re-admitted lane whose backend is sick re-opens on its own."""
        return self._set_drained(label, False)

    def _set_drained(self, label: str, drained: bool) -> bool:
        with self._lock:
            for slot in self._slots:
                if slot.label == label and slot.drained != drained:
                    slot.drained = drained
                    break
            else:
                return False
        metrics.gauge(
            "tpu.lane.drained", labelnames=("lane",)
        ).labels(lane=label).set(1.0 if drained else 0.0)
        log.warning(
            "lane %s %s rotation", label,
            "drained from" if drained else "re-admitted to",
        )
        return True

    def breakers(self) -> list[CircuitBreaker]:
        """Per-lane breakers, lane order (REPL /reset re-arms them all)."""
        return [s.breaker for s in self._all_slots()]

    def reset(self) -> None:
        for breaker in self.breakers():
            breaker.reset()

    # -- offline (synchronous-host) attachment -------------------------------

    def start_in_thread(self) -> None:
        """Run the router's event loop on a daemon thread — the
        attachment point for synchronous hosts (the bulk audit
        pipeline), mirroring ``OpsPlane.start_in_thread``."""
        if self._thread is not None:
            return
        ready = threading.Event()

        def run() -> None:
            loop = asyncio.new_event_loop()
            self._thread_loop = loop
            loop.call_soon(self.start)
            loop.call_soon(ready.set)
            loop.run_forever()

        self._thread = threading.Thread(
            target=run, name="cpzk-lane-router", daemon=True
        )
        self._thread.start()
        ready.wait(timeout=10.0)

    def stop_thread(self) -> None:
        """Drain every lane and stop a :meth:`start_in_thread` loop."""
        loop = self._thread_loop
        if loop is None:
            return
        done = asyncio.run_coroutine_threadsafe(self.stop(), loop)
        done.result(timeout=600.0)
        loop.call_soon_threadsafe(loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._thread = None
        self._thread_loop = None

    def verify_blocking(self, entries: list) -> list:
        """Fan one quantum across every lane and return per-entry results
        in entry order — the synchronous bulk seam the audit pipeline
        replays through (placement, breakers, and per-lane metrics all
        engaged, exactly like serving traffic).  Entries split into
        ``lane_count`` contiguous slices so every device gets one batch;
        slicing never changes accept/reject semantics (the combined
        check's verify_each fallback is per-row ground truth)."""
        if self._thread_loop is None:
            raise RuntimeError(
                "verify_blocking needs start_in_thread() first"
            )
        if not entries:
            return []
        per = -(-len(entries) // len(self._slots))
        slices = [
            entries[lo: lo + per] for lo in range(0, len(entries), per)
        ]

        async def fan() -> list:
            futs = [self.submit(s, None) for s in slices]
            parts = await asyncio.gather(*futs)
            return [r for part in parts for r in part]

        return asyncio.run_coroutine_threadsafe(
            fan(), self._thread_loop
        ).result()
