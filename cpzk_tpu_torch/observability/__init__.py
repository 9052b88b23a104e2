"""Request tracing and device-plane flight recording for the serving plane.

A port of the parts of ``cpzk_tpu/observability`` the single-card serving
plane runs:

- :mod:`.context` — ``RequestContext``, the trace identity of one request,
  stable across retries;
- :mod:`.tracing` — per-stage software spans (``queue_wait``,
  ``pad_and_pack``, ``device_dispatch``, ``unpack``), a completed-trace
  ring buffer, and ``torch.profiler.record_function`` alignment so a
  profiler capture shows the same stage names;
- :mod:`.flightrec` — the per-batch flight recorder: the widened stage
  split, padded-lane occupancy, and the card's dispatch gap;
- :mod:`.instrument` — the ``traced_rpc`` decorators owning the
  requests/outcome/duration metric lifecycle of every RPC handler of the
  gRPC service;
- :mod:`.logs` — the opt-in JSON log formatter with automatic trace-id
  correlation;
- :mod:`.slo` and :mod:`.opsplane` — the burn-rate engine and the HTTP
  introspection server the daemon starts (``/metrics /statusz /tracez
  /flightrec /healthz /slo``);
- :mod:`.perf` — the benchmark snapshot schema and its comparator.

``configure(settings)`` applies an ``[observability]`` config section to
the process-wide tracer, flight recorder, metric buckets and log format in
one call.
"""

from __future__ import annotations

from .context import RequestContext, current_context, new_trace_id
from .flightrec import (
    FlightRecord,
    FlightRecorder,
    format_flightrec,
    get_flight_recorder,
)
from .instrument import rpc_deadline, traced_rpc, traced_stream_rpc
from .logs import JsonLogFormatter, enable_json_logs
from .opsplane import OpsPlane, OpsSources
from .slo import SloEngine
from .tracing import (
    BatchStages,
    SpanRecord,
    TraceRecord,
    Tracer,
    format_trace,
    format_tracez,
    get_tracer,
)

__all__ = [
    "BatchStages",
    "FlightRecord",
    "FlightRecorder",
    "JsonLogFormatter",
    "OpsPlane",
    "OpsSources",
    "RequestContext",
    "SloEngine",
    "SpanRecord",
    "TraceRecord",
    "Tracer",
    "configure",
    "current_context",
    "enable_json_logs",
    "format_flightrec",
    "format_trace",
    "format_tracez",
    "get_flight_recorder",
    "get_tracer",
    "new_trace_id",
    "rpc_deadline",
    "traced_rpc",
    "traced_stream_rpc",
]


def configure(settings) -> None:
    """Apply an ``ObservabilitySettings`` (see ``server/config.py``):
    trace ring capacity, slow-request threshold, histogram buckets, the
    flight-recorder ring, and the JSON log formatter opt-in.
    ``compile_storm_threshold`` is accepted and has nothing to act on:
    PyTorch compiles nothing per batch shape, so there are no compile
    storms to warn about."""
    from ..server import metrics

    get_tracer().configure(
        capacity=settings.trace_ring,
        slow_request_s=(
            -1.0 if settings.slow_request_ms < 0
            else settings.slow_request_ms / 1000.0
        ),
    )
    get_flight_recorder().configure(capacity=settings.flight_ring)
    buckets = settings.parsed_buckets()
    if buckets:
        metrics.set_default_buckets(buckets)
    if settings.json_logs:
        enable_json_logs()
