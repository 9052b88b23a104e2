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
  gRPC service.

The reference's JSON logs, ops plane and SLO engine come with the host
control plane.
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
    "RequestContext",
    "SpanRecord",
    "TraceRecord",
    "Tracer",
    "current_context",
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
