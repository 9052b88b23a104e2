"""Request trace context: minted at the client, carried over gRPC metadata.

A copy of ``cpzk_tpu/observability/context.py`` (the port imports nothing
of the JAX package).

A :class:`RequestContext` identifies one logical request across its whole
path — client stub, wire, service handler, batching queue, device dispatch
— and across client retries: the trace id is minted once per logical call
and stays stable while ``attempt`` increments, so a retried RPC shows up
as one trace with several completions rather than unrelated ids.

The wire encoding is two ASCII metadata keys (``cpzk-trace-id``,
``cpzk-attempt``); unknown or absent metadata mints a fresh server-side
context, so uninstrumented clients still get traced from the service
boundary on.  ``current_context`` is a contextvar set for the duration of
each instrumented RPC handler — the JSON log formatter and any code
downstream of the handler can read the active trace id without threading
it through every signature.
"""

from __future__ import annotations

import contextvars
import os
from dataclasses import dataclass, field

#: gRPC metadata keys (lowercase per the metadata spec).
TRACE_ID_KEY = "cpzk-trace-id"
ATTEMPT_KEY = "cpzk-attempt"
PARENT_SPAN_KEY = "cpzk-parent-span"

#: The trace context of the RPC currently being served on this task, or
#: None outside an instrumented handler.
current_context: contextvars.ContextVar["RequestContext | None"] = (
    contextvars.ContextVar("cpzk_request_context", default=None)
)


def new_trace_id() -> str:
    """128-bit random hex trace id (W3C traceparent sized)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random hex span id."""
    return os.urandom(8).hex()


@dataclass
class RequestContext:
    """Identity + position of one request in the serving pipeline."""

    trace_id: str = field(default_factory=new_trace_id)
    #: 1-based attempt number; bumped by the client retry loop, stable
    #: trace_id across attempts.
    attempt: int = 1
    #: Span id of the caller's enclosing span ("" = root).
    parent_span: str = ""
    #: Absolute ``time.monotonic()`` RPC deadline, when known.
    deadline: float | None = None

    def child(self) -> "RequestContext":
        """Context for the next attempt of the same logical request."""
        return RequestContext(
            trace_id=self.trace_id,
            attempt=self.attempt + 1,
            parent_span=self.parent_span,
            deadline=self.deadline,
        )

    # -- gRPC metadata ------------------------------------------------------

    def to_metadata(self) -> tuple[tuple[str, str], ...]:
        md = [(TRACE_ID_KEY, self.trace_id), (ATTEMPT_KEY, str(self.attempt))]
        if self.parent_span:
            md.append((PARENT_SPAN_KEY, self.parent_span))
        return tuple(md)

    @classmethod
    def from_metadata(cls, metadata, deadline: float | None = None) -> "RequestContext":
        """Extract from an iterable of (key, value) metadata pairs; any
        missing or malformed field falls back to a freshly minted value
        (a garbage attempt header must not kill the RPC)."""
        trace_id = ""
        attempt = 1
        parent = ""
        for key, value in metadata or ():
            k = key.lower()
            if k == TRACE_ID_KEY:
                trace_id = str(value)
            elif k == ATTEMPT_KEY:
                try:
                    attempt = max(1, int(value))
                except (TypeError, ValueError):
                    attempt = 1
            elif k == PARENT_SPAN_KEY:
                parent = str(value)
        return cls(
            trace_id=trace_id or new_trace_id(),
            attempt=attempt,
            parent_span=parent,
            deadline=deadline,
        )

    @classmethod
    def from_grpc(cls, context, deadline: float | None = None) -> "RequestContext":
        """Extract from a gRPC servicer context; tolerates hand-rolled
        test contexts without ``invocation_metadata``."""
        try:
            md = context.invocation_metadata()
        except Exception:
            md = ()
        return cls.from_metadata(md, deadline=deadline)
