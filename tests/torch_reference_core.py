"""The JAX package's host core (``cpzk_tpu/_lib/libcpzk_native.so``) for the
port's differential tests, built once per checkout under a file lock.

The reference builds its library at first use with an unlocked ``make``
that writes the shared object in place, and ``cpzk_tpu.core._native.load``
remembers a failed load for the rest of the process.  Under pytest-xdist
several workers reach that first use together: a worker whose ``make``
finds the file another worker's compiler is still writing calls it up to
date, ``dlopen`` fails on the partial file, and that worker runs every
later test without the native core (some of them then fail, or time out
where the pure-Python fallback is slow).

:func:`reference_native` takes an exclusive ``fcntl`` lock, builds the
library with the reference's own Makefile into a temporary name and
renames it into place (so no reader can see a partial file), then loads it
through ``cpzk_tpu.core._native.load``.  The port's test modules that use
the reference's core import this module, which calls it once at import:
pytest-xdist workers import every test module before running any test, so
every worker has the reference's core loaded before its first test.
Nothing under ``cpzk_tpu/`` changes.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LIB = ROOT / "cpzk_tpu" / "_lib" / "libcpzk_native.so"
SRC = ROOT / "cpzk_tpu" / "native"

_error: Exception | None = None


def _loadable() -> bool:
    """The library on disk opens and has the ABI the reference expects."""
    from cpzk_tpu.core import _native as jnative

    try:
        lib = ctypes.CDLL(str(LIB))
    except OSError:
        return False
    return jnative._abi(lib) == jnative._ABI_EXPECTED


def reference_native() -> ctypes.CDLL:
    """The reference's loaded host core; builds it first if it is missing,
    partial or stale.  Raises if it cannot be built or loaded."""
    from cpzk_tpu.core import _native as jnative

    if jnative._lib is not None:
        return jnative._lib
    LIB.parent.mkdir(parents=True, exist_ok=True)
    with open(LIB.parent / "libcpzk_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not LIB.exists() or not _loadable():
            tmp = LIB.with_name(f"{LIB.name}.{os.getpid()}.tmp")
            try:
                subprocess.run(["make", "-s", "-B", f"OUT=../_lib/{tmp.name}"], cwd=SRC,
                               check=True, capture_output=True, text=True)
                os.replace(tmp, LIB)
            finally:
                tmp.unlink(missing_ok=True)
        # a load in this process that raced an unlocked build latched None
        jnative._tried = False
        lib = jnative.load()
    if lib is None:
        raise RuntimeError(f"the reference's host core did not load from {LIB}")
    return lib


def prebuild() -> None:
    """:func:`reference_native` at import: remembers a failure instead of
    raising, so that collection goes on and :func:`require` reports it."""
    global _error
    try:
        reference_native()
    except Exception as exc:  # reported by require()
        _error = exc


def require() -> ctypes.CDLL:
    """The loaded reference core, or the error that stopped its build."""
    if _error is not None:
        raise RuntimeError(f"the reference's host core failed to build: {_error}")
    return reference_native()


prebuild()
