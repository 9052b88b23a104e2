"""Serving plane of the port: the pieces of ``cpzk_tpu/server`` that feed
the card.

- :mod:`.batching` — ``DynamicBatcher``, coalescing concurrent
  submissions into device batches, with deadline shedding and
  backpressure;
- :mod:`.dispatch` — ``DispatchLane``, the persistent host-prep + device
  thread pair behind it;
- :mod:`.plane` — ``build_backend``, which assembles the card (behind a
  host failover only when the caller passes one) and the batcher from the
  ``[tpu]`` settings;
- :mod:`.config` — ``TpuSettings`` and ``validate_tpu``;
- :mod:`.metrics` — the metrics facade, on a Prometheus registry of this
  package's own.

The gRPC service, the state store and the daemon come with a later slice.
Exports resolve on first access: :mod:`.metrics` is imported by the
observability layer, which the batcher itself imports.
"""

from __future__ import annotations

_EXPORTS = {
    "build_backend": "plane",
    "DynamicBatcher": "batching",
    "DeadlineExceeded": "batching",
    "QueueFull": "batching",
    "DispatchLane": "dispatch",
    "LaneStopped": "dispatch",
    "TpuSettings": "config",
    "validate_tpu": "config",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
