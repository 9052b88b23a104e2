"""Snapshot quarantine, from ``cpzk_tpu/durability/recovery.py``.

Only :func:`quarantine_file` is ported: the daemon's plain snapshot
restore uses it.  WAL replay and ``recover_state`` come with the port's
durability subsystem.
"""

from __future__ import annotations

import os


def quarantine_file(path: str, seq: int) -> str:
    """Move an unreadable snapshot/WAL aside as ``<path>.corrupt-<seq>``
    (suffixed further if that name is taken), preserving 0600 — corrupt or
    not, the file may still hold live bearer tokens.  Returns the new
    path."""
    base = f"{path}.corrupt-{seq}"
    dst, i = base, 0
    while os.path.exists(dst):
        i += 1
        dst = f"{base}.{i}"
    os.replace(path, dst)
    try:
        os.chmod(dst, 0o600)
    except OSError:  # pragma: no cover - chmod on our own fresh rename
        pass
    return dst
