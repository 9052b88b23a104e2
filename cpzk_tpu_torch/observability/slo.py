"""SLO engine: multi-window burn rates over the existing RPC families.

A copy of ``cpzk_tpu/observability/slo.py`` over the port's metrics
facade (its own Prometheus registry).
Raw counters tell an operator what happened; an SLO tells them whether to
page.  This module turns the labeled families the ``traced_rpc`` /
``traced_stream_rpc`` decorators already maintain — ``rpc.requests{rpc,
outcome}`` and ``rpc.duration{rpc}`` — into per-RPC objectives and
**burn rates** over the standard multi-window pairs (5m/1h fast,
30m/6h slow, the Google SRE workbook alerting scheme):

- **availability**: the fraction of requests that must succeed
  (``[slo] availability_target``, default 99.9%).  Burn over a window =
  observed error ratio / allowed error ratio — burn 1.0 spends the error
  budget exactly at the rate that exhausts it at the window's end of the
  SLO period, burn 14.4 exhausts a 30-day budget in 2 days.
- **latency**: a per-RPC-class target mean (``[slo] latency_ms``, with
  built-in defaults per RPC).  Latency burn = windowed mean duration /
  target — above 1.0 the class is out of its latency objective.

``slo.burn_rate{rpc,window}`` exports the worse of the two per window;
``slo.error_budget_remaining{rpc}`` exports the unspent fraction of the
availability budget over the slow (6h) window.  A page-worthy burn —
BOTH windows of a pair above the pair's threshold (defaults 14.4 fast /
6.0 slow) — logs one WARNING per window period per RPC and lands a
``slo_burn`` event in the trace ring, so pages and request traces share
a timeline.

The engine is pull-based and pure over the metrics facade: ``tick()``
samples the cumulative counters (both backings — the no-prometheus
fallback tracks identical numbers) into a bounded per-RPC ring and
derives every window from deltas, so it never instruments the serving
path.  The daemon ticks it on ``[slo] tick_interval_ms``; the ops
plane's ``/slo`` endpoint ticks once more on demand so the payload is
always current.  ``clock`` is injectable, which is how the synthetic
error-storm test drives hours of budget math in milliseconds.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

from ..server import metrics

log = logging.getLogger("cpzk_tpu_torch.observability.slo")

#: Schema tag of the ``/slo`` JSON payload.
SCHEMA = "cpzk-slo/1"

#: The RPC classes with objectives (the ``rpc`` label values the
#: ``traced_rpc`` decorators emit).
RPC_CLASSES = (
    "Register",
    "RegisterBatch",
    "CreateChallenge",
    "VerifyProof",
    "VerifyProofBatch",
    "VerifyProofStream",
)

#: (label, seconds) of every burn window, dashboard order.
WINDOWS: tuple[tuple[str, float], ...] = (
    ("5m", 300.0),
    ("30m", 1800.0),
    ("1h", 3600.0),
    ("6h", 21600.0),
)
_WINDOW_S = dict(WINDOWS)

#: The multi-window page pairs: a page fires only when BOTH windows of a
#: pair burn above the pair's threshold (short window = it is happening
#: now; long window = it is not a blip).
FAST_PAIR = ("5m", "1h")
SLOW_PAIR = ("30m", "6h")

#: Built-in latency targets (ms, windowed mean) per RPC class —
#: overridable per class via ``[slo] latency_ms``.  Batch and stream
#: RPCs carry device-quantum batches, so their targets are wider.
DEFAULT_LATENCY_MS: dict[str, float] = {
    "Register": 250.0,
    "RegisterBatch": 1000.0,
    "CreateChallenge": 100.0,
    "VerifyProof": 500.0,
    "VerifyProofBatch": 2000.0,
    "VerifyProofStream": 30000.0,
}


@dataclass
class _Sample:
    """One cumulative-counter observation for one RPC class."""

    t: float          # engine clock at sample time
    ok: float         # rpc.requests{outcome="success"} cumulative
    fail: float       # rpc.requests{outcome="failure"} cumulative
    dur_count: float  # rpc.duration observation count cumulative
    dur_sum: float    # rpc.duration seconds sum cumulative


class SloEngine:
    """Windowed burn-rate computation over the RPC metric families."""

    def __init__(self, settings, clock=time.monotonic):
        self.settings = settings
        self._clock = clock
        self._lock = threading.Lock()
        #: per-RPC ring of cumulative samples, pruned past the slow window
        self._samples: dict[str, deque[_Sample]] = {
            rpc: deque() for rpc in RPC_CLASSES
        }
        #: (rpc, pair) -> engine-clock time of the last WARNING, so a
        #: sustained burn warns once per short-window period, not per tick
        self._warned_at: dict[tuple[str, str], float] = {}
        self.latency_ms = dict(DEFAULT_LATENCY_MS)
        self.latency_ms.update(settings.parsed_latency_ms())
        #: allowed error ratio (the denominator of availability burn)
        self.allowed_error = max(1e-9, 1.0 - settings.availability_target)
        #: last computed per-RPC view (the ``/slo`` payload body)
        self._last: dict[str, dict] = {}
        self._pages = 0
        #: fleet partition label ("" outside a fleet): stamped into the
        #: ``/slo`` payload so per-partition dashboards can join burn
        #: rates across the fleet without scraping instance labels
        self.partition = ""

    # -- sampling ------------------------------------------------------------

    def _read_rpc(self, rpc: str) -> tuple[float, float, float, float]:
        ok = metrics.read(
            "rpc.requests", labels={"rpc": rpc, "outcome": "success"}
        )
        fail = metrics.read(
            "rpc.requests", labels={"rpc": rpc, "outcome": "failure"}
        )
        dur_count, dur_sum = metrics.read_histogram(
            "rpc.duration", labels={"rpc": rpc}
        )
        return ok, fail, dur_count, dur_sum

    def _window_delta(
        self, ring: deque[_Sample], now_s: _Sample, window_s: float
    ) -> tuple[float, float, float, float, float]:
        """(covered_s, d_requests, d_failures, d_dur_count, d_dur_sum)
        between ``now_s`` and the newest sample at least ``window_s`` old
        (or the oldest available — a young process reports over the
        history it actually has)."""
        base = ring[0]
        horizon = now_s.t - window_s
        for s in ring:
            if s.t > horizon:
                break
            base = s
        return (
            max(0.0, now_s.t - base.t),
            max(0.0, (now_s.ok + now_s.fail) - (base.ok + base.fail)),
            max(0.0, now_s.fail - base.fail),
            max(0.0, now_s.dur_count - base.dur_count),
            max(0.0, now_s.dur_sum - base.dur_sum),
        )

    # -- the tick ------------------------------------------------------------

    def tick(self) -> dict[str, dict]:
        """Sample the counters, recompute every (rpc, window) burn rate,
        export the gauges, and fire page WARNINGs.  Returns the per-RPC
        view (also kept for :meth:`snapshot`).  Thread-safe: the daemon's
        tick task and an on-demand ``/slo`` render may overlap."""
        now = self._clock()
        horizon = now - _WINDOW_S[SLOW_PAIR[1]] - 1.0
        burn_gauge = metrics.gauge(
            "slo.burn_rate", labelnames=("rpc", "window")
        )
        budget_gauge = metrics.gauge(
            "slo.error_budget_remaining", labelnames=("rpc",)
        )
        with self._lock:
            view: dict[str, dict] = {}
            for rpc in RPC_CLASSES:
                ok, fail, dc, ds = self._read_rpc(rpc)
                sample = _Sample(now, ok, fail, dc, ds)
                ring = self._samples[rpc]
                ring.append(sample)
                while len(ring) > 1 and ring[1].t <= horizon:
                    ring.popleft()
                target_ms = self.latency_ms.get(
                    rpc, DEFAULT_LATENCY_MS["VerifyProof"]
                )
                windows: dict[str, dict] = {}
                for label, seconds in WINDOWS:
                    covered, d_req, d_fail, d_dc, d_ds = self._window_delta(
                        ring, sample, seconds
                    )
                    err_ratio = d_fail / d_req if d_req > 0 else 0.0
                    avail_burn = err_ratio / self.allowed_error
                    mean_ms = (d_ds / d_dc) * 1000.0 if d_dc > 0 else 0.0
                    latency_burn = mean_ms / target_ms if target_ms > 0 else 0.0
                    burn = max(avail_burn, latency_burn)
                    windows[label] = {
                        "burn_rate": round(burn, 4),
                        "availability_burn": round(avail_burn, 4),
                        "latency_burn": round(latency_burn, 4),
                        "requests": d_req,
                        "failures": d_fail,
                        "mean_latency_ms": round(mean_ms, 3),
                        "covered_s": round(covered, 1),
                    }
                    burn_gauge.labels(rpc=rpc, window=label).set(burn)
                # budget remaining over the slow window: the unspent
                # fraction of the availability error budget
                slow = windows[SLOW_PAIR[1]]
                if slow["requests"] > 0:
                    spent = slow["failures"] / (
                        self.allowed_error * slow["requests"]
                    )
                else:
                    spent = 0.0
                remaining = max(0.0, 1.0 - spent)
                budget_gauge.labels(rpc=rpc).set(remaining)
                paging = self._check_pages(rpc, windows, now)
                view[rpc] = {
                    "availability_target": self.settings.availability_target,
                    "latency_target_ms": target_ms,
                    "windows": windows,
                    "error_budget_remaining": round(remaining, 4),
                    "paging": paging,
                    "total_requests": ok + fail,
                    "total_failures": fail,
                }
            self._last = view
            return view

    def _check_pages(
        self, rpc: str, windows: dict[str, dict], now: float
    ) -> list[str]:
        """Page-worthy pairs this tick (["fast"] / ["slow"] / both).
        Each fires its WARNING + trace-ring event at most once per its
        short window's period."""
        paging: list[str] = []
        for name, pair, threshold in (
            ("fast", FAST_PAIR, self.settings.fast_burn_threshold),
            ("slow", SLOW_PAIR, self.settings.slow_burn_threshold),
        ):
            short, long_ = pair
            if not (
                windows[short]["burn_rate"] >= threshold
                and windows[long_]["burn_rate"] >= threshold
            ):
                continue
            paging.append(name)
            warned = self._warned_at.get((rpc, name))
            if warned is not None and now - warned < _WINDOW_S[short]:
                continue
            self._warned_at[(rpc, name)] = now
            self._pages += 1
            log.warning(
                "SLO burn (%s): %s burning error budget at %.1fx over %s "
                "and %.1fx over %s (threshold %.1fx) — budget spends to "
                "zero well before the period ends; see /slo",
                name, rpc,
                windows[short]["burn_rate"], short,
                windows[long_]["burn_rate"], long_,
                threshold,
            )
            from . import get_tracer

            get_tracer().record_event(
                "slo_burn",
                rpc=rpc,
                pair=name,
                burn_short=windows[short]["burn_rate"],
                burn_long=windows[long_]["burn_rate"],
                threshold=threshold,
            )
        return paging

    # -- inspection ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``/slo`` JSON payload (last computed view + objectives)."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "partition": self.partition,
                "availability_target": self.settings.availability_target,
                "fast_burn_threshold": self.settings.fast_burn_threshold,
                "slow_burn_threshold": self.settings.slow_burn_threshold,
                "windows": [label for label, _ in WINDOWS],
                "pages_fired": self._pages,
                "rpcs": self._last,
            }
