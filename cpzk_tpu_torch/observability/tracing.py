"""Software spans + an in-memory completed-trace ring buffer.

A port of ``cpzk_tpu/observability/tracing.py``.  The serving stack needs
(a) per-request stage breakdowns it can assert on in tests and show an
operator, and (b) span names that line up with profiler timelines — both
are a few hundred lines of stdlib.  The shapes mirror OpenTelemetry loosely
(trace id, named spans with start offsets and durations, attributes).

Thread-safety: spans are recorded from the dispatch lane's threads while
the owning request task awaits its future, so every mutation is
lock-guarded.  The ring only holds *completed* traces; in-flight ones live
in a dict keyed by trace id (one active attempt per trace id at a time — a
retry reuses the id with a bumped attempt, producing one ring entry per
attempt).

Profiler alignment: :class:`BatchStages` wraps each software stage in
``torch.profiler.record_function("cpzk.<stage>")``, so a ``torch.profiler``
capture (``CPZK_XPROF_DIR``, or :func:`.flightrec.start_profile`) shows
the same stage names the ring buffer reports, on one timeline with the
card's kernels.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..server import metrics
from . import flightrec
from .context import RequestContext, new_trace_id
from .flightrec import (
    STAGE_DEVICE_WAIT,
    STAGE_EXECUTE,
    STAGE_MARSHAL,
    STAGE_THREAD_HOP,
    FlightRecord,
)

#: Canonical pipeline stage names (doc + test vocabulary).  ``queue_wait``
#: and ``device_dispatch`` bracket the device; ``pad_and_pack`` /
#: ``unpack`` are the host stages around it.  The flight recorder widens
#: ``device_dispatch`` into ``thread_hop``/``marshal``/``execute``
#: sub-spans (see :mod:`.flightrec`).
STAGE_QUEUE_WAIT = "queue_wait"
STAGE_PAD_AND_PACK = "pad_and_pack"
STAGE_DEVICE_DISPATCH = "device_dispatch"
STAGE_UNPACK = "unpack"

#: Which stage feeds which latency histogram.
_STAGE_HISTOGRAM = {
    STAGE_PAD_AND_PACK: "tpu.batch.host_time",
    STAGE_UNPACK: "tpu.batch.host_time",
    STAGE_DEVICE_DISPATCH: "tpu.batch.device_time",
}


#: JSON payload schema tag of the ``/tracez`` dump (the reference's).
TRACEZ_SCHEMA = "cpzk-tracez/1"


@dataclass
class SpanRecord:
    """One completed stage within a trace."""

    name: str
    #: ``time.monotonic()`` at stage entry.
    start: float
    duration_s: float
    attrs: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "start": self.start,
            "duration_s": self.duration_s,
            "attrs": {k: v for k, v in sorted(self.attrs.items())},
        }


@dataclass
class TraceRecord:
    """One completed (or in-flight) request attempt."""

    trace_id: str
    name: str  # RPC / operation name
    attempt: int = 1
    start_wall: float = 0.0  # time.time() at trace start
    start: float = 0.0       # time.monotonic() at trace start
    duration_s: float = 0.0
    status: str = "in-flight"
    spans: list[SpanRecord] = field(default_factory=list)

    def span_names(self) -> list[str]:
        return [s.name for s in self.spans]

    def stage_seconds(self, name: str) -> float:
        """Total recorded duration of all spans named ``name``."""
        return sum(s.duration_s for s in self.spans if s.name == name)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "name": self.name,
            "attempt": self.attempt,
            "start_wall": self.start_wall,
            "duration_s": self.duration_s,
            "status": self.status,
            "spans": [s.to_dict() for s in self.spans],
        }


class Tracer:
    """Active-trace registry + completed-trace ring buffer."""

    def __init__(self, capacity: int = 256, slow_request_s: float = 1.0):
        self._lock = threading.Lock()
        self._active: dict[str, TraceRecord] = {}
        self._ring: deque[TraceRecord] = deque(maxlen=max(1, capacity))
        #: Requests slower than this log a WARNING with their stage
        #: breakdown; 0 logs every request, None/negative disables.
        self.slow_request_s: float | None = slow_request_s

    # -- configuration ------------------------------------------------------

    def configure(
        self,
        capacity: int | None = None,
        slow_request_s: float | None = None,
    ) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, capacity))
            if slow_request_s is not None:
                self.slow_request_s = (
                    None if slow_request_s < 0 else slow_request_s
                )

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._ring.clear()

    # -- lifecycle ----------------------------------------------------------

    def start(self, ctx: RequestContext, name: str) -> TraceRecord:
        """Open a trace for ``ctx``.  A second ``start`` with the same
        trace id (a retry's next attempt) replaces the in-flight record —
        each attempt completes into its own ring entry."""
        rec = TraceRecord(
            trace_id=ctx.trace_id,
            name=name,
            attempt=ctx.attempt,
            start_wall=time.time(),
            start=time.monotonic(),
        )
        with self._lock:
            self._active[ctx.trace_id] = rec
        return rec

    def add_span(
        self,
        trace_id: str | None,
        name: str,
        start: float,
        duration_s: float,
        **attrs,
    ) -> None:
        """Attach a completed span to an in-flight trace; silently dropped
        when the trace is unknown (entry submitted outside an instrumented
        RPC, or the trace already finished)."""
        if not trace_id:
            return
        with self._lock:
            rec = self._active.get(trace_id)
            if rec is not None:
                rec.spans.append(
                    SpanRecord(name, start, max(0.0, duration_s), dict(attrs))
                )

    def add_span_many(
        self,
        trace_ids: list[str],
        name: str,
        start: float,
        duration_s: float,
        **attrs,
    ) -> None:
        """One batch-stage span fanned out to every member trace under a
        SINGLE lock acquisition, with one shared (never mutated) attrs
        dict.  A device batch coalesces hundreds of RPCs and emits ~6
        stages each — per-trace locking made the fan-out itself a
        milliseconds-scale slice of the dispatch wall that no stage span
        covered."""
        if not trace_ids:
            return
        dur = max(0.0, duration_s)
        with self._lock:
            for tid in trace_ids:
                rec = self._active.get(tid)
                if rec is not None:
                    rec.spans.append(SpanRecord(name, start, dur, attrs))

    def finish(
        self, trace_id: str, status: str, duration_s: float | None = None
    ) -> TraceRecord | None:
        """Complete the in-flight trace and move it into the ring."""
        with self._lock:
            rec = self._active.pop(trace_id, None)
            if rec is None:
                return None
            rec.status = status
            rec.duration_s = (
                duration_s
                if duration_s is not None
                else max(0.0, time.monotonic() - rec.start)
            )
            self._ring.append(rec)
        return rec

    def record_event(self, name: str, **attrs) -> TraceRecord:
        """A standalone zero-duration event (breaker flip, failover) as a
        single-span completed trace, so state transitions share the
        ``/tracez`` timeline with the requests they affected."""
        now = time.monotonic()
        rec = TraceRecord(
            trace_id=new_trace_id(),
            name=name,
            start_wall=time.time(),
            start=now,
            status="event",
        )
        rec.spans.append(SpanRecord(name, now, 0.0, dict(attrs)))
        with self._lock:
            self._ring.append(rec)
        return rec

    # -- inspection ---------------------------------------------------------

    def completed(self, n: int | None = None) -> list[TraceRecord]:
        """Most-recent-last snapshot of completed traces (last ``n``)."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def find(self, trace_id: str) -> list[TraceRecord]:
        """All completed attempts of one trace id, oldest first."""
        return [t for t in self.completed() if t.trace_id == trace_id]

    def payload(self, n: int | None = None) -> dict:
        """THE ``cpzk-tracez/1`` payload — the single serializer behind
        every rendering of the ring (one schema, one code path)."""
        return {
            "schema": TRACEZ_SCHEMA,
            "dumped_at": time.time(),
            "traces": [t.to_dict() for t in self.completed(n)],
        }


_TRACER = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer."""
    return _TRACER


# -- profiler alignment --------------------------------------------------------


def _trace_annotation(name: str):
    """``torch.profiler.record_function("cpzk.<name>")`` when torch is
    already loaded (the serving process on the GPU path), else a null
    context — a software span never pays a cold torch import."""
    torch = sys.modules.get("torch")
    if torch is not None:
        return torch.profiler.record_function(f"cpzk.{name}")
    return contextlib.nullcontext()


class BatchStages:
    """Stage recorder handed to ``BatchVerifier.verify``: each stage is
    timed once per device batch and fanned out as a span to every member
    trace, observed into the stage latency histograms, and wrapped in a
    matching ``torch.profiler.record_function`` so a profiler capture
    shows the same stage names.

    Flight-recorder integration: the batcher calls :meth:`mark_submit`
    just before handing the batch to a worker thread and
    :meth:`mark_worker_start` as the worker picks it up (the
    ``thread_hop`` span); the ``device_dispatch`` stage installs a
    :class:`~cpzk_tpu_torch.observability.flightrec.DeviceSink` the
    backend reports marshal time, padded lanes and the card's work
    interval into, which this class turns into ``marshal``/``execute``
    sub-spans and the dispatch gap; and :meth:`finalize` folds everything
    into one :class:`~cpzk_tpu_torch.observability.flightrec.FlightRecord`."""

    def __init__(
        self,
        tracer: Tracer | None,
        trace_ids: list[str],
        batch_size: int = 0,
        backend_label: str = "cpu",
        queue_wait_s: float = 0.0,
    ):
        self.tracer = tracer
        # deduped (order kept): a batch whose entries share one trace (a
        # batch request's items) must get ONE span per stage on that
        # trace, not one per entry
        self.trace_ids = list(dict.fromkeys(t for t in trace_ids if t))
        self.batch_size = batch_size
        self.backend_label = backend_label
        self.queue_wait_s = queue_wait_s
        #: accumulated seconds per stage name (incl. the widened vocab)
        self.durations: dict[str, float] = {}
        #: dispatch-lane index, stamped by the LaneRouter at placement
        #: time ("mesh" for the big-batch mesh path; None = single-lane)
        self.lane: int | str | None = None
        self._submitted_at: float | None = None
        self._staged_at: float | None = None
        self._worker_ended_at: float | None = None
        self._sink: flightrec.DeviceSink | None = None
        self._gap_s = 0.0

    # -- flight-recorder marks ---------------------------------------------

    def mark_submit(self) -> None:
        """Stamp the dispatch commit (event-loop side, just before the
        batch crosses to the dispatch lane or a worker thread)."""
        self._submitted_at = time.monotonic()

    def mark_worker_start(self) -> None:
        """Stamp worker-thread pickup; the elapsed time since
        :meth:`mark_submit` is the ``thread_hop`` span — the per-batch
        cost of crossing the batcher->worker seam (a condition-variable
        wakeup on the persistent dispatch lane; a thread-pool handoff on
        the stopped batcher's inline path)."""
        if self._submitted_at is None:
            return
        now = time.monotonic()
        dur = max(0.0, now - self._submitted_at)
        self._emit(STAGE_THREAD_HOP, now - dur, dur)
        metrics.histogram("tpu.batch.thread_hop").observe(dur)

    def mark_staged(self) -> None:
        """Stamp host-prep completion (the batch entering a dispatch-lane
        staging slot, prepared but not yet on the device thread)."""
        self._staged_at = time.monotonic()

    def mark_device_start(self) -> None:
        """Stamp device-thread pickup; the elapsed time since
        :meth:`mark_staged` is the ``device_wait`` span — staging-slot
        dwell while the device thread finishes the previous batch (the
        double-buffering overlap made visible).  No-op when the batch
        never entered a staging slot (single-thread inline verify)."""
        if self._staged_at is None:
            return
        now = time.monotonic()
        dur = max(0.0, now - self._staged_at)
        self._emit(STAGE_DEVICE_WAIT, now - dur, dur)
        metrics.histogram("tpu.batch.device_wait").observe(dur)

    def mark_worker_end(self) -> None:
        """Stamp verify completion on the worker thread; the record's
        ``wall_s`` is submit -> here, the interval the widened stages
        tile (the hop back to the event loop is scheduling latency the
        request's trace already covers, not device-plane work)."""
        self._worker_ended_at = time.monotonic()

    def _emit(self, name: str, start: float, dur: float, **attrs) -> None:
        self.durations[name] = self.durations.get(name, 0.0) + dur
        if self.tracer is not None:
            self.tracer.add_span_many(
                self.trace_ids, name, start, dur,
                batch=self.batch_size, backend=self.backend_label,
                **attrs,
            )

    @contextlib.contextmanager
    def stage(self, name: str):
        device = name == STAGE_DEVICE_DISPATCH
        token = None
        if device:
            self._sink, token = flightrec.install_sink()
        t0 = time.monotonic()
        try:
            with _trace_annotation(name):
                yield
        finally:
            dur = time.monotonic() - t0
            if device:
                flightrec.uninstall_sink(token)
        hist = _STAGE_HISTOGRAM.get(name)
        if hist == "tpu.batch.device_time":
            metrics.histogram(hist, labelnames=("backend",)).labels(
                backend=self.backend_label
            ).observe(dur)
        elif hist is not None:
            metrics.histogram(hist).observe(dur)
        self._emit(name, t0, dur)
        if device:
            self._split_device(t0, dur)

    def _split_device(self, t0: float, dur: float) -> None:
        """Widen the ``device_dispatch`` interval into ``marshal`` and
        ``execute`` from the sink the backend reported into: marshal is
        measured directly, the remainder is ``execute`` (there is no
        per-shape compile to attribute).  The dispatch gap comes from the
        card's work interval as the backend timed it with CUDA events; a
        backend that reports none (the CPU oracle) is timed by the host
        clock around the whole stage."""
        sink = self._sink or flightrec.DeviceSink()
        marshal = min(max(0.0, sink.marshal_s), dur)
        if marshal > 0.0:
            self._emit(STAGE_MARSHAL, t0, marshal)
        self._emit(STAGE_EXECUTE, t0 + marshal, max(0.0, dur - marshal))
        if sink.device_start is not None and sink.device_end is not None:
            start, end = sink.device_start, sink.device_end
        else:
            start, end = t0, t0 + dur
        self._gap_s = flightrec.get_flight_recorder().note_device_interval(
            start, end
        )

    def finalize(self, wall_s: float) -> "flightrec.FlightRecord":
        """Fold the recorded stages into one flight record (called by the
        batcher once the dispatch's results are in).  ``wall_s`` is the
        event-loop submit->resolved wall time, used as a fallback; when
        the worker marks ran, the record's wall is submit->verify-end —
        the interval the widened stages tile, which is what the stage-sum
        invariant is pinned against."""
        if self._submitted_at is not None and self._worker_ended_at is not None:
            wall_s = max(0.0, self._worker_ended_at - self._submitted_at)
        sink = self._sink or flightrec.DeviceSink()
        lanes = sink.lanes
        rows = sink.rows or self.batch_size
        occupancy = (rows / lanes) if lanes > 0 else 1.0
        rec = FlightRecord(
            batch=self.batch_size,
            lane=self.lane,
            lanes=lanes,
            occupancy=occupancy,
            pad_waste=max(0.0, 1.0 - occupancy),
            backend=self.backend_label,
            queue_wait_s=self.queue_wait_s,
            stages_s=dict(self.durations),
            wall_s=wall_s,
            dispatch_gap_s=self._gap_s,
            device_interval_s=sink.device_interval_s,
        )
        return flightrec.get_flight_recorder().record(rec)


# -- operator rendering -------------------------------------------------------


def format_trace(rec: dict) -> str:
    """One ``/tracez`` line: id, name, outcome, total, stage breakdown.
    Consumes a serialized trace dict (``TraceRecord.to_dict``)."""
    stages = " ".join(
        f"{s['name']}={s['duration_s'] * 1000:.2f}ms" for s in rec["spans"]
    )
    head = (
        f"{rec['trace_id'][:16]} {rec['name']} {rec['status']} "
        f"total={rec['duration_s'] * 1000:.2f}ms attempt={rec['attempt']}"
    )
    return f"{head} {stages}".rstrip()


def format_tracez(payload: dict, limit: int = 20) -> str:
    """The ``/tracez`` text: last ``limit`` traces, newest first, one line
    each.  Takes the :meth:`Tracer.payload` dict, so the text is a
    rendering of exactly the JSON dump."""
    recent = payload.get("traces", [])[-limit:][::-1]
    if not recent:
        return "no completed traces yet"
    lines = [f"last {len(recent)} completed traces (newest first):"]
    lines += ["  " + format_trace(t) for t in recent]
    return "\n".join(lines)
