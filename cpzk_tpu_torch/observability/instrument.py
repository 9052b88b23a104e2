"""RPC instrumentation: one decorator for the whole requests/outcome/
duration/trace lifecycle.

A copy of ``cpzk_tpu/observability/instrument.py``, recording into the
port's own tracer and its metrics registry (``server.metrics.PROM_REGISTRY``).
The decorator owns the lifecycle of every handler in ``server/service.py``:

- extracts the client's :class:`RequestContext` from gRPC metadata (or
  mints one), publishes it via ``current_context`` for the handler body,
  the batcher, and the JSON log formatter;
- counts ``<prefix>.requests`` on entry and exactly one of
  ``<prefix>.success`` / ``<prefix>.failure`` on exit (aborts and
  cancellations are failures), and ALWAYS observes
  ``<prefix>.duration`` — both outcomes, every path;
- mirrors everything into the labeled facade (``rpc.requests{rpc,
  outcome}``, ``rpc.duration{rpc}``) so one dashboard query covers all
  RPCs;
- completes the trace in the ring buffer and emits the slow-request
  WARNING (threshold ``observability.slow_request_ms``; 0 logs every
  request, -1 disables) with the per-stage breakdown inline.
"""

from __future__ import annotations

import functools
import logging
import time

from ..server import metrics
from .context import RequestContext, current_context
from .tracing import get_tracer

rpc_log = logging.getLogger("cpzk_tpu_torch.observability.rpc")


def rpc_deadline(context) -> float | None:
    """Absolute ``time.monotonic()`` deadline of this RPC, or None when the
    client set none (tolerates hand-rolled test contexts)."""
    try:
        remaining = context.time_remaining()
    except Exception:
        return None
    if remaining is None:
        return None
    return time.monotonic() + max(0.0, remaining)


def traced_stream_rpc(rpc: str, metric_prefix: str):
    """The :func:`traced_rpc` lifecycle for an async-generator
    ``(self, request_iterator, context)`` bidi-streaming handler: one
    trace per STREAM (entries inherit its trace id through the batcher,
    so their stage spans land on the stream's trace exactly like a unary
    request's do), requests/outcome counters and a duration histogram
    over the stream's whole life, and the slow-request WARNING keyed on
    stream duration."""

    def decorator(fn):
        @functools.wraps(fn)
        async def wrapper(self, request_iterator, context):
            rctx = RequestContext.from_grpc(
                context, deadline=rpc_deadline(context)
            )
            token = current_context.set(rctx)
            tracer = get_tracer()
            tracer.start(rctx, rpc)
            metrics.counter(f"{metric_prefix}.requests").inc()
            start = time.perf_counter()
            outcome = "failure"
            try:
                async for response in fn(self, request_iterator, context):
                    yield response
                outcome = "success"
            finally:
                duration = time.perf_counter() - start
                metrics.counter(f"{metric_prefix}.{outcome}").inc()
                metrics.histogram(f"{metric_prefix}.duration").observe(duration)
                metrics.counter(
                    "rpc.requests", labelnames=("rpc", "outcome")
                ).labels(rpc=rpc, outcome=outcome).inc()
                metrics.histogram(
                    "rpc.duration", labelnames=("rpc",)
                ).labels(rpc=rpc).observe(duration)
                record = tracer.finish(
                    rctx.trace_id, outcome, duration_s=duration
                )
                threshold = tracer.slow_request_s
                if threshold is not None and duration >= threshold:
                    stages = {
                        s.name: round(s.duration_s * 1000, 3)
                        for s in (record.spans if record else ())
                    }
                    rpc_log.warning(
                        "%s %s in %.2fms (attempt %d)",
                        rpc, outcome, duration * 1000, rctx.attempt,
                        extra={
                            "trace_id": rctx.trace_id,
                            "rpc": rpc,
                            "outcome": outcome,
                            "duration_ms": round(duration * 1000, 3),
                            "attempt": rctx.attempt,
                            "stages_ms": stages,
                        },
                    )
                current_context.reset(token)

        return wrapper

    return decorator


def traced_rpc(rpc: str, metric_prefix: str):
    """Wrap an async ``(self, request, context)`` RPC handler with the
    full metrics + tracing lifecycle described in the module docstring."""

    def decorator(fn):
        @functools.wraps(fn)
        async def wrapper(self, request, context):
            rctx = RequestContext.from_grpc(
                context, deadline=rpc_deadline(context)
            )
            token = current_context.set(rctx)
            tracer = get_tracer()
            tracer.start(rctx, rpc)
            metrics.counter(f"{metric_prefix}.requests").inc()
            start = time.perf_counter()
            outcome = "failure"
            try:
                response = await fn(self, request, context)
                outcome = "success"
                return response
            finally:
                duration = time.perf_counter() - start
                metrics.counter(f"{metric_prefix}.{outcome}").inc()
                metrics.histogram(f"{metric_prefix}.duration").observe(duration)
                metrics.counter(
                    "rpc.requests", labelnames=("rpc", "outcome")
                ).labels(rpc=rpc, outcome=outcome).inc()
                metrics.histogram(
                    "rpc.duration", labelnames=("rpc",)
                ).labels(rpc=rpc).observe(duration)
                record = tracer.finish(
                    rctx.trace_id, outcome, duration_s=duration
                )
                threshold = tracer.slow_request_s
                if threshold is not None and duration >= threshold:
                    stages = {
                        s.name: round(s.duration_s * 1000, 3)
                        for s in (record.spans if record else ())
                    }
                    rpc_log.warning(
                        "%s %s in %.2fms (attempt %d)",
                        rpc, outcome, duration * 1000, rctx.attempt,
                        extra={
                            "trace_id": rctx.trace_id,
                            "rpc": rpc,
                            "outcome": outcome,
                            "duration_ms": round(duration * 1000, 3),
                            "attempt": rctx.attempt,
                            "stages_ms": stages,
                        },
                    )
                current_context.reset(token)

        return wrapper

    return decorator
