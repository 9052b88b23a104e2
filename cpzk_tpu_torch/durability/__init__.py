"""Crash-consistent durability: write-ahead log + bounded-loss recovery.

A port of ``cpzk_tpu/durability/``.  It upgrades the opt-in snapshot
persistence (``state_file``) to the contract every production serving
stack provides — an acknowledged write survives a crash, recovery is
automatic and bounded, and the failure modes are exercised by
deterministic tests:

- :mod:`.wal` — :class:`WriteAheadLog`: length- and CRC32-framed JSON
  records (``register_user`` / ``create_session`` / ``revoke_session`` /
  ``expire_sessions`` and the challenge lifecycle) with a configurable
  fsync policy and atomic-rename compaction, plus the deterministic crash
  points the fault harness schedules.  Its bytes on disk are the
  reference's, so either package recovers the other's log;
- :mod:`.recovery` — boot: snapshot load with corrupt-file quarantine,
  torn-tail truncation, and WAL-suffix replay through the same
  trust-boundary validators live RPCs pass;
- :mod:`.manager` — :class:`DurabilityManager`: the lifecycle object the
  daemon drives (recover → checkpoint-per-sweep → close-on-shutdown).

Configuration lives in the ``[durability]`` section of the server config
(``SERVER_DURABILITY_*`` env).  Exports resolve on first access: the
ingest shards import only the frame helpers of :mod:`.wal`, and must not
pull in the state store or the observability layer with them.
"""

from __future__ import annotations

_EXPORTS = {
    "DurabilityManager": "manager",
    "RecoveryReport": "recovery",
    "quarantine_file": "recovery",
    "recover_state": "recovery",
    "MAX_FRAME_PAYLOAD": "wal",
    "WAL_CRASH_POINTS": "wal",
    "WAL_FORMAT_VERSION": "wal",
    "CrashPoint": "wal",
    "NewerFormatError": "wal",
    "WriteAheadLog": "wal",
    "check_record_format": "wal",
    "encode_record": "wal",
    "iter_frames": "wal",
    "read_frames": "wal",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{module}", __name__), name)
