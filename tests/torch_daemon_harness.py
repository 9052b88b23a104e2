"""Harness of the daemon tests (``tests/test_torch_daemon*.py``): boot a
daemon through its package's ``amain`` in a subprocess of its own, read
the gRPC and ops-plane ports from its output, and stop it with SIGTERM.

Each daemon runs in its own process because the two packages cannot share
one: both register ``auth.proto`` in protobuf's default descriptor pool
and both start a process-wide gRPC server stack.  The port's daemon is
given ``device="cpu"`` (the CUDA kernels' plain versions) when it serves
``backend = "tpu"``; the reference's runs as its own tests run it, on the
JAX CPU backend.
"""

from __future__ import annotations

import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent

_LAUNCH = {
    "reference": (
        "import asyncio, sys\n"
        "from cpzk_tpu.server.__main__ import amain, parse_args\n"
        "asyncio.run(amain(parse_args(sys.argv[1:])))\n"
    ),
    "port": (
        "import asyncio, sys\n"
        "from cpzk_tpu_torch.server.__main__ import amain, parse_args\n"
        "asyncio.run(amain(parse_args(sys.argv[1:]), device='cpu'))\n"
    ),
}

_LISTENING = re.compile(r"AuthService listening on [^:\s]+:(\d+)")
_OPSPLANE = re.compile(r"ops plane on http://[^:\s]+:(\d+)")


class Daemon:
    """One daemon process: ``side`` is ``"reference"`` or ``"port"``."""

    def __init__(self, side: str, cwd: pathlib.Path, toml: str = "",
                 env: dict | None = None, argv: tuple = ()):
        self.side = side
        self.cwd = pathlib.Path(cwd)
        self.cwd.mkdir(parents=True, exist_ok=True)
        config = self.cwd / "server.toml"
        config.write_text(toml)
        full_env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
        full_env["SERVER_CONFIG_PATH"] = str(config)
        full_env["PYTHONPATH"] = str(ROOT) + os.pathsep + full_env.get("PYTHONPATH", "")
        full_env.setdefault("JAX_PLATFORMS", "cpu")
        full_env["PYTHONUNBUFFERED"] = "1"  # the reference prints unflushed
        full_env.update(env or {})
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _LAUNCH[side], "--no-repl", "--port", "0", *argv],
            cwd=str(self.cwd), env=full_env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        self.out: list[str] = []
        self.err: list[str] = []
        self._readers = [
            threading.Thread(target=self._drain, args=(self.proc.stdout, self.out), daemon=True),
            threading.Thread(target=self._drain, args=(self.proc.stderr, self.err), daemon=True),
        ]
        for t in self._readers:
            t.start()
        self.port: int | None = None
        self.ops_port: int | None = None

    @staticmethod
    def _drain(stream, sink: list) -> None:
        for line in stream:
            sink.append(line)

    def logs(self) -> str:
        return "".join(self.out) + "".join(self.err)

    def wait_listening(self, timeout: float = 90.0) -> "Daemon":
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.out):
                m = _LISTENING.search(line)
                if m:
                    self.port = int(m.group(1))
            for line in list(self.err):
                m = _OPSPLANE.search(line)
                if m:
                    self.ops_port = int(m.group(1))
            if self.port is not None:
                return self
            if self.proc.poll() is not None:
                raise AssertionError(f"{self.side} daemon exited {self.proc.returncode} "
                                     f"before listening:\n{self.logs()[-4000:]}")
            time.sleep(0.05)
        self.kill()
        raise AssertionError(f"{self.side} daemon never listened:\n{self.logs()[-4000:]}")

    def wait_exit(self, timeout: float) -> int:
        try:
            rc = self.proc.wait(timeout=timeout)
        finally:
            for t in self._readers:
                t.join(timeout=5.0)
        return rc

    def terminate(self, timeout: float = 40.0) -> int:
        """SIGTERM, then the exit code (the graceful path: drain, final
        snapshot)."""
        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.wait_exit(timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
