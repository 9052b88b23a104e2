"""The port's sanitizer drivers: ``native/tsan_driver.cpp`` linked with the
host core's own ``SOURCES`` by ``core/_native.py``'s
``build_sanitizer_driver``, the twin of the reference Makefile's ``tsan``
and ``asan-ubsan`` targets (``cpzk_tpu/native/Makefile``).

Each driver runs the three concurrent paths of the host core (the
``cpzk_verify_rows`` row pool, threaded ``cpzk_challenge_batch``, the comb
rwlock under generator churn) and must exit 0 with no sanitizer report.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import pytest

from cpzk_tpu_torch.core import _native

#: what each sanitizer prints when it finds something
REPORTS = ("WARNING: ThreadSanitizer", "ERROR: AddressSanitizer",
           "ERROR: LeakSanitizer", "runtime error:", "SUMMARY:")
OPTIONS = {"TSAN_OPTIONS": "halt_on_error=1", "ASAN_OPTIONS": "halt_on_error=1",
           "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1"}


@pytest.fixture(scope="module")
def compiler():
    if shutil.which(_native.CXX) is None:
        pytest.skip(f"{_native.CXX} is not installed")
    return _native.CXX


@pytest.mark.parametrize("kind", sorted(_native.SANITIZERS))
def test_driver_runs_clean(kind, compiler):
    driver = _native.build_sanitizer_driver(kind)
    assert driver.parent == _native.BUILD_DIR and os.access(driver, os.X_OK)
    done = subprocess.run([str(driver)], capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, **OPTIONS))
    assert done.returncode == 0, done.stdout + done.stderr
    assert "tsan driver done" in done.stdout
    assert not [r for r in REPORTS if r in done.stderr], done.stderr


def test_driver_builds_from_the_library_sources(tmp_path, monkeypatch):
    """The instrumented binary is compiled from the library's own
    ``SOURCES`` (``wire.cpp`` included) plus the driver, with the
    Makefile's sanitizer flags, to a temporary name renamed into place."""
    calls = []

    def compile_(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_native.subprocess, "run", compile_)
    built = {kind: _native.build_sanitizer_driver(kind, cxx="c++", out_dir=tmp_path)
             for kind in _native.SANITIZERS}
    assert len(calls) == 2 and len(set(built.values())) == 2
    for cmd, kind in zip(calls, _native.SANITIZERS):
        assert cmd[0] == "c++" and built[kind].exists()
        assert [a for a in cmd if a.endswith(".cpp")] == [
            *map(str, _native.SOURCES), str(_native.SAN_DRIVER)]
        assert {"-O1", "-g", "-std=c++17", f"-fsanitize={kind}"} <= set(cmd)
        assert ("-fno-sanitize-recover=all" in cmd) == (kind == "address,undefined")
        assert "-shared" not in cmd
    assert _native.build_sanitizer_driver("thread", cxx="c++", out_dir=tmp_path) == (
        built["thread"])
    assert len(calls) == 2  # built once: the second call finds it


def test_unknown_sanitizer_is_refused():
    with pytest.raises(ValueError, match="not one of"):
        _native.build_sanitizer_driver("memory")
