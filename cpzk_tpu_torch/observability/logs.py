"""Structured JSON logging with trace-id correlation.

A copy of ``cpzk_tpu/observability/logs.py``.  One formatter for the whole
process: every record becomes a single-line
JSON object with a stable schema (documented in docs/operations.md
§Telemetry), and the active request's trace id is attached automatically
from :data:`~cpzk_tpu_torch.observability.context.current_context` — log lines
emitted anywhere below an instrumented RPC handler correlate with the
trace ring buffer and the Prometheus exporter without any call-site
changes.  Opt-in via the ``[observability] json_logs`` config key /
``SERVER_OBSERVABILITY_JSON_LOGS`` env (human-readable logging stays the
default for interactive runs).
"""

from __future__ import annotations

import json
import logging
import time

from .context import current_context

#: logging.LogRecord attributes that are plumbing, not payload — anything
#: else found on a record (``extra=...``) is emitted as a JSON field.
_RESERVED = frozenset(
    (
        "name", "msg", "args", "levelname", "levelno", "pathname", "filename",
        "module", "exc_info", "exc_text", "stack_info", "lineno", "funcName",
        "created", "msecs", "relativeCreated", "thread", "threadName",
        "processName", "process", "taskName", "message", "asctime",
    )
)


class JsonLogFormatter(logging.Formatter):
    """``{"ts", "level", "logger", "message", "trace_id"?, ...extras}``."""

    def format(self, record: logging.LogRecord) -> str:
        data: dict = {
            "ts": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)
            )
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        trace_id = getattr(record, "trace_id", None)
        if trace_id is None:
            ctx = current_context.get()
            trace_id = ctx.trace_id if ctx is not None else None
        if trace_id:
            data["trace_id"] = trace_id
        for key, value in record.__dict__.items():
            if key in _RESERVED or key.startswith("_") or key == "trace_id":
                continue
            if key in data:
                continue
            try:
                json.dumps(value)
            except (TypeError, ValueError):
                value = repr(value)
            data[key] = value
        if record.exc_info:
            data["exc"] = self.formatException(record.exc_info)
        return json.dumps(data, separators=(",", ":"), sort_keys=False)


def enable_json_logs(logger: logging.Logger | None = None) -> logging.Handler:
    """Swap the (root by default) logger's stream handlers to the JSON
    formatter; installs one if none exist.  Returns the handler so tests
    and the daemon can detach it."""
    target = logger or logging.getLogger()
    formatter = JsonLogFormatter()
    for handler in target.handlers:
        if isinstance(handler, logging.StreamHandler):
            handler.setFormatter(formatter)
            return handler
    handler = logging.StreamHandler()
    handler.setFormatter(formatter)
    target.addHandler(handler)
    return handler
