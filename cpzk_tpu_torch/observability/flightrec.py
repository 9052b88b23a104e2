"""Device-plane flight recorder: per-batch dispatch accounting.

A port of ``cpzk_tpu/observability/flightrec.py``.  The four batch stages
(``queue_wait``/``pad_and_pack``/``device_dispatch``/``unpack``) say
*that* the serving path starves the card, not *why*; this module is the
always-on instrument that splits ``device_dispatch``:

- a :class:`DeviceSink` contextvar the backend reports into from the
  worker thread (``marshal`` seconds, padded lane counts, and the
  interval the card's stream ran the batch's work, timed with CUDA events
  from its first launch to its last, idle stretches between launches
  included) without
  the backend ever importing the tracer;
- a :class:`FlightRecorder` ring of per-batch :class:`FlightRecord` rows:
  batch size, padded lanes, occupancy, pad waste, the widened stage
  breakdown, and the **dispatch gap** — the card's idle time between
  consecutive dispatches, the direct measure of "serving starves the
  card";
- gauges and histograms on top (``tpu.device.busy_fraction``,
  ``tpu.batch.occupancy``, ``tpu.dispatch.gap``, a rolling proofs/s
  EWMA);
- an on-demand deep capture (:func:`start_profile` / :func:`stop_profile`)
  wrapping a ``torch.profiler`` session that writes a Chrome trace, guarded
  against concurrent captures, whose timeline carries the same
  ``cpzk.<stage>`` names as the software spans.

The reference's jit-cache attribution (``compile`` stage, jit hits and
misses, the compile-storm warning) has no PyTorch meaning: PyTorch runs
eagerly and compiles nothing per batch shape.  A record keeps those fields,
at 0 and empty, so it has the reference's shape.

Everything here is batch-shape metadata — no statement bytes, proofs, or
secrets ever enter a record, so dumps are safe to attach to bugs.

Thread-safety: records are built by the dispatch lane's threads while
readers take the ring from the event-loop thread; every ring and window
mutation is lock-guarded.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..server import metrics

log = logging.getLogger("cpzk_tpu_torch.observability.flightrec")

#: JSON dump schema tag (the reference's; bump on incompatible changes).
SCHEMA = "cpzk-flightrec/1"

#: Stage vocabulary widening (the split of ``device_dispatch``).
STAGE_THREAD_HOP = "thread_hop"
STAGE_DEVICE_WAIT = "device_wait"
STAGE_MARSHAL = "marshal"
STAGE_COMPILE = "compile"
STAGE_EXECUTE = "execute"

#: Stage keys of one flight record, dispatch order.  ``queue_wait`` is
#: carried separately (per-entry mean) — these tile the submit->resolve
#: wall time, which is the sum invariant the tests pin.  ``device_wait``
#: is the dispatch lane's staging-slot dwell: a host-prepared batch
#: waiting for the device thread to finish the previous batch.
#: ``compile`` is always 0 here (see the module docstring).
RECORD_STAGES = (
    STAGE_THREAD_HOP,
    "pad_and_pack",
    STAGE_DEVICE_WAIT,
    STAGE_MARSHAL,
    STAGE_COMPILE,
    STAGE_EXECUTE,
    "unpack",
)

#: Percentiles of :func:`stage_percentiles`.
PERCENTILES = (50, 90, 99)


# -- device sink (backend -> recorder seam) -----------------------------------


@dataclass
class DeviceSink:
    """Per-batch accumulator the backend reports device-plane facts into.

    Installed (contextvar) by the stage recorder around the
    ``device_dispatch`` stage in the worker thread; the backend calls the
    module-level ``note_*`` helpers, which no-op when no sink is active
    (direct ``BatchVerifier`` use stays unrecorded)."""

    marshal_s: float = 0.0
    rows: int = 0
    lanes: int = 0
    #: seconds from the start to the end of this batch's work on the
    #: card's stream, summed over the backend's calls (CUDA events around
    #: each call's launches).  An interval, not busy time: it includes the
    #: card waiting for the host to issue the next launch.
    device_interval_s: float = 0.0
    #: host-monotonic span of that work: the first call's start and the
    #: last call's end, each anchored at the host clock where the backend
    #: synchronised with the card; None when the backend reported nothing
    device_start: float | None = None
    device_end: float | None = None


_SINK: contextvars.ContextVar[DeviceSink | None] = contextvars.ContextVar(
    "cpzk_torch_device_sink", default=None
)


def install_sink() -> tuple[DeviceSink, contextvars.Token]:
    sink = DeviceSink()
    return sink, _SINK.set(sink)


def uninstall_sink(token: contextvars.Token) -> None:
    _SINK.reset(token)


def note_marshal(duration_s: float) -> None:
    """Host SoA limb-marshal seconds within the current device dispatch."""
    sink = _SINK.get()
    if sink is not None:
        sink.marshal_s += max(0.0, duration_s)


def note_lanes(rows: int, lanes: int) -> None:
    """Padded device-lane accounting for the current dispatch: occupancy
    = true rows / padded lanes (the complement of ``tpu.batch.pad_waste``)."""
    if lanes > 0:
        metrics.gauge("tpu.batch.occupancy").set(rows / lanes)
    sink = _SINK.get()
    if sink is not None:
        sink.rows = rows
        sink.lanes = lanes


def note_device(start: float, end: float) -> None:
    """One interval ``[start, end]`` (host-monotonic seconds) in which the
    card ran this dispatch's work, as the backend measured it on the card."""
    sink = _SINK.get()
    if sink is not None:
        sink.device_interval_s += max(0.0, end - start)
        if sink.device_start is None or start < sink.device_start:
            sink.device_start = start
        if sink.device_end is None or end > sink.device_end:
            sink.device_end = end


# -- flight records -----------------------------------------------------------


@dataclass
class FlightRecord:
    """One device batch through the batcher->backend seam."""

    seq: int = 0
    ts: float = 0.0            # wall clock at record time
    batch: int = 0             # true rows in the batch
    lane: int | str | None = None  # dispatch lane index ("mesh" for the
                               # big-batch mesh path; None = single-lane)
    lanes: int = 0             # padded device lanes (0 = no device padding)
    occupancy: float = 1.0     # batch / lanes (1.0 without device padding)
    pad_waste: float = 0.0     # 1 - occupancy
    backend: str = "cpu"
    queue_wait_s: float = 0.0  # mean over member entries
    stages_s: dict[str, float] = field(default_factory=dict)
    wall_s: float = 0.0        # dispatch commit -> results returned
    dispatch_gap_s: float = 0.0  # device idle before this dispatch
    # start-to-end seconds of the batch's work on the card's stream (CUDA
    # events), idle stretches between launches included; 0 = unreported
    device_interval_s: float = 0.0
    # jit-cache attribution: always 0 / empty here (no per-shape compiles)
    jit_hits: int = 0
    jit_misses: int = 0
    compiled: list[str] = field(default_factory=list)

    def stage_sum_s(self) -> float:
        """Sum of the widened stage spans — the tests pin this against
        ``wall_s`` (within 10%): the decomposition must tile the wall."""
        return sum(self.stages_s.get(name, 0.0) for name in RECORD_STAGES)

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "ts": self.ts,
            "batch": self.batch,
            "lane": self.lane,
            "lanes": self.lanes,
            "occupancy": round(self.occupancy, 6),
            "pad_waste": round(self.pad_waste, 6),
            "backend": self.backend,
            "queue_wait_s": self.queue_wait_s,
            "stages_s": {k: v for k, v in sorted(self.stages_s.items())},
            "wall_s": self.wall_s,
            "dispatch_gap_s": self.dispatch_gap_s,
            "device_interval_s": self.device_interval_s,
            "jit_hits": self.jit_hits,
            "jit_misses": self.jit_misses,
            "compiled": list(self.compiled),
        }


class FlightRecorder:
    """Fixed-size ring of :class:`FlightRecord` rows + the derived
    device-plane gauges.  Always on; the per-batch cost is a lock, a
    deque append, and a handful of float ops."""

    def __init__(self, capacity: int = 512, clock=time.monotonic):
        self._lock = threading.Lock()
        self._ring: deque[FlightRecord] = deque(maxlen=max(1, capacity))
        self._clock = clock
        self._seq = 0
        # device-idle accounting between consecutive dispatches
        self._last_device_end: float | None = None
        self._busy_ewma = 0.0
        # rolling serving throughput
        self._last_record_at: float | None = None
        self._pps_ewma = 0.0

    # -- configuration ------------------------------------------------------

    def configure(self, capacity: int | None = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(1, capacity))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._last_device_end = None
            self._busy_ewma = 0.0
            self._last_record_at = None
            self._pps_ewma = 0.0

    # -- device-idle signal -------------------------------------------------

    def note_device_interval(self, start: float, end: float) -> float:
        """Account one device work interval [start, end] (monotonic
        seconds); returns the **dispatch gap** — device idle time since
        the previous dispatch ended (0 for the first dispatch, and 0
        under pipelined overlap, where the device never went idle).
        ``tpu.device.busy_fraction`` keeps the reference's name: it is
        the share of time inside work intervals, which on the card
        include idle stretches between launches, not the SMs' busy
        share."""
        with self._lock:
            if self._last_device_end is None:
                gap = 0.0
            else:
                gap = max(0.0, start - self._last_device_end)
            self._last_device_end = max(self._last_device_end or end, end)
            busy = max(0.0, end - start)
            frac = busy / (busy + gap) if busy + gap > 0 else 0.0
            self._busy_ewma = (
                frac if self._busy_ewma == 0.0
                else 0.8 * self._busy_ewma + 0.2 * frac
            )
            busy_ewma = self._busy_ewma
        metrics.histogram("tpu.dispatch.gap").observe(gap)
        metrics.gauge("tpu.device.busy_fraction").set(busy_ewma)
        return gap

    # -- recording ----------------------------------------------------------

    def record(self, rec: FlightRecord) -> FlightRecord:
        now = self._clock()
        with self._lock:
            self._seq += 1
            rec.seq = self._seq
            if rec.ts == 0.0:
                rec.ts = time.time()
            if self._last_record_at is not None and rec.batch > 0:
                dt = now - self._last_record_at
                if dt > 0:
                    inst = rec.batch / dt
                    self._pps_ewma = (
                        inst if self._pps_ewma == 0.0
                        else 0.8 * self._pps_ewma + 0.2 * inst
                    )
            self._last_record_at = now
            pps = self._pps_ewma
            self._ring.append(rec)
        metrics.gauge("tpu.throughput.proofs_per_s").set(pps)
        metrics.gauge("tpu.batch.occupancy").set(rec.occupancy)
        return rec

    # -- inspection / dump --------------------------------------------------

    def snapshot(self, n: int | None = None) -> list[FlightRecord]:
        """Most-recent-last copy of the ring (last ``n``)."""
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def proofs_per_s(self) -> float:
        with self._lock:
            return self._pps_ewma

    def payload(self, n: int | None = None) -> dict:
        """THE ``cpzk-flightrec/1`` payload — the single serializer behind
        every rendering and dump of the ring."""
        return {
            "schema": SCHEMA,
            "dumped_at": time.time(),
            "proofs_per_s_ewma": self.proofs_per_s(),
            "records": [r.to_dict() for r in self.snapshot(n)],
        }

    def to_json(self, n: int | None = None) -> str:
        return json.dumps(self.payload(n), indent=2, sort_keys=True)

    def dump(self, path: str, n: int | None = None) -> str:
        """Write the ring as JSON to ``path``.  Serialization happens
        outside the lock via :meth:`snapshot`."""
        text = self.to_json(n)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        return path


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder."""
    return _RECORDER


def stage_percentiles(
    records, percentiles: tuple[int, ...] = PERCENTILES
) -> dict[str, dict[str, float]]:
    """Per-stage latency percentiles (ms) over flight-recorder records.
    Nearest-rank on the sorted per-batch stage durations; empty dict when
    no records.  (From ``cpzk_tpu/observability/perf.py``.)"""
    by_stage: dict[str, list[float]] = {}
    for rec in records:
        for name, secs in rec.stages_s.items():
            by_stage.setdefault(name, []).append(secs * 1000.0)
    out: dict[str, dict[str, float]] = {}
    for name, values in sorted(by_stage.items()):
        values.sort()
        out[name] = {
            f"p{q}": values[
                min(len(values) - 1, max(0, -(-q * len(values) // 100) - 1))
            ]
            for q in percentiles
        }
    return out


# -- operator rendering -------------------------------------------------------


def format_record(rec: dict) -> str:
    """One line per record: shape, occupancy, gap, stage breakdown.
    Consumes a serialized record dict (``FlightRecord.to_dict``)."""
    stages_s = rec.get("stages_s", {})
    stages = " ".join(
        f"{name}={stages_s.get(name, 0.0) * 1000:.2f}ms"
        for name in RECORD_STAGES
    )
    lane = rec.get("lane")
    lane_tag = "" if lane is None else f"lane={lane} "
    return (
        f"#{rec['seq']} {lane_tag}n={rec['batch']} lanes={rec['lanes']} "
        f"occ={rec['occupancy']:.2f} gap={rec['dispatch_gap_s'] * 1000:.2f}ms "
        f"wait={rec['queue_wait_s'] * 1000:.2f}ms {stages} "
        f"wall={rec['wall_s'] * 1000:.2f}ms "
        f"device_interval={rec.get('device_interval_s', 0.0) * 1000:.2f}ms "
        f"{rec['backend']}"
    )


def format_flightrec(payload: dict, limit: int = 20) -> str:
    """Last ``limit`` batches, newest first, one line each, plus the
    rolling throughput header.  Takes the :meth:`FlightRecorder.payload`
    dict, so the text is a rendering of exactly the JSON dump."""
    recent = payload.get("records", [])[-limit:][::-1]
    if not recent:
        return "no recorded batches yet"
    lines = [
        f"last {len(recent)} device batches (newest first), "
        f"~{payload.get('proofs_per_s_ewma', 0.0):.0f} proofs/s EWMA:"
    ]
    lines += ["  " + format_record(r) for r in recent]
    return "\n".join(lines)


# -- on-demand deep capture (torch.profiler) ----------------------------------

_PROFILE_LOCK = threading.Lock()
_PROFILE_DIR: str | None = None
_PROFILER = None  # the running torch.profiler.profile session


def profile_active() -> str | None:
    """The capture directory of an in-flight profile, or None."""
    with _PROFILE_LOCK:
        return _PROFILE_DIR


def start_profile(logdir: str) -> bool:
    """Begin a ``torch.profiler`` capture (host, and the card when CUDA is
    available) whose Chrome trace :func:`stop_profile` writes into
    ``logdir``; False when a capture is already running (concurrent
    captures corrupt the trace)."""
    global _PROFILE_DIR, _PROFILER
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _PROFILE_LOCK:
        if _PROFILE_DIR is not None:
            return False
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        _PROFILER, _PROFILE_DIR = prof, logdir
        return True


def stop_profile() -> str | None:
    """End the in-flight capture and write its Chrome trace into the
    capture directory; returns the directory (None when no capture was
    running)."""
    global _PROFILE_DIR, _PROFILER
    with _PROFILE_LOCK:
        if _PROFILE_DIR is None:
            return None
        logdir, _PROFILE_DIR = _PROFILE_DIR, None
        prof, _PROFILER = _PROFILER, None
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            logdir, f"cpzk-trace-{os.getpid()}-{time.time_ns()}.json"))
        return logdir
