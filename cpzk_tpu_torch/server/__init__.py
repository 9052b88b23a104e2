"""The port's server: the serving plane that feeds the card, the state
store, and the gRPC auth service in process.

- :mod:`.batching` — ``DynamicBatcher``, coalescing concurrent
  submissions into device batches, with deadline shedding and
  backpressure;
- :mod:`.dispatch` — ``DispatchLane``, the persistent host-prep + device
  thread pair behind it;
- :mod:`.plane` — ``build_backend``, which assembles the card (behind a
  host failover only when the caller passes one) and the batcher from the
  ``[tpu]`` settings;
- :mod:`.config` — ``ServerConfig`` with every section of the
  reference's (``TpuSettings`` and ``validate_tpu`` among them) and the
  global ``RateLimiter``;
- :mod:`.metrics` — the metrics facade, on a Prometheus registry of this
  package's own;
- :mod:`.state` — ``ServerState``: users, single-use challenges and
  sessions in independently locked shards, with snapshot/restore;
- :mod:`.wire` — the native parse of the three hot request messages;
- :mod:`.proto` and :mod:`.service` — the protobuf bindings and the gRPC
  ``AuthServiceImpl`` with ``serve``;
- :mod:`.ingest` — the SO_REUSEPORT ingest shards
  (``[server] ingest_shards > 1``) and their supervisor;
- :mod:`.__main__` — the daemon, ``python -m cpzk_tpu_torch.server``:
  config resolution, the state restore, the cleanup supervisor, the ops
  plane, the admin REPL and graceful shutdown.

Exports resolve on first access:
:mod:`.metrics` is imported by the observability layer, which the batcher
itself imports.
"""

from __future__ import annotations

_EXPORTS = {
    "build_backend": "plane",
    "DynamicBatcher": "batching",
    "DeadlineExceeded": "batching",
    "QueueFull": "batching",
    "DispatchLane": "dispatch",
    "LaneStopped": "dispatch",
    "ServerConfig": "config",
    "TpuSettings": "config",
    "validate_tpu": "config",
    "RateLimiter": "config",
    "RateLimitExceeded": "config",
    "ServerState": "state",
    "UserData": "state",
    "ChallengeData": "state",
    "SessionData": "state",
    "serve": "service",
    "AuthServiceImpl": "service",
    "IngestSupervisor": "ingest",
    "amain": "__main__",
    "handle_command": "__main__",
    "load_state": "__main__",
    "parse_args": "__main__",
    "resolve_config": "__main__",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
