"""Fuzz target: cpzk-lint never crashes on parseable source.

(A port-owned copy of the reference package's ``fuzz/fuzz_lint.py``,
driving ``cpzk_tpu_torch.analysis``.)

Invariant: for ANY byte blob, the analyzer either returns a report
(possibly containing PARSE-001 findings) or — never — raises.  Inputs
that happen to be valid Python exercise the taint pass, the waiver
parser, and every rule's visitor over adversarial ASTs; inputs that are
not valid Python must come back as a single PARSE-001 finding, not an
exception.  Findings are re-rendered and serialized so the reporting
path is covered too.

Run: python tests/torch_fuzz/fuzz_lint.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

import json

from common import run_fuzzer

from cpzk_tpu_torch.analysis import analyze_source

_SEED_SNIPPETS = [
    b"",
    b"x = 1\n",
    b"# cpzk-lint: disable=CT-001 -- seed reason\nx = 1 == 2\n",
    b"# cpzk-lint: disable=LOCK-001\n",
    b"def f(password):\n    return password == 'x'\n",
    b"""\
import asyncio, time
class ServerState:
    async def mutate(self):
        self._users['a'] = 1
        time.sleep(1)
        asyncio.create_task(self.mutate())
""",
    b"""\
import jax
@jax.jit
def f(x):
    import time
    return time.time()
""",
    b"""\
async def handler(self, request, context):
    await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "x")
""",
    b"f'{witness.secret().value}'\n",
    b"while witness.secret():\n    pass\n",
    # threaded/process-spawning shapes: the execution-context inference
    # (call graph, spawn-site seeding, propagation) and the context rules
    # (THREAD-001/PROC-001) must hold their invariants over mutations of
    # these too — self-referential spawns, nested defs, bound targets
    b"""\
import asyncio, threading
class Lane:
    def start(self):
        threading.Thread(target=self._loop).start()
    def _loop(self):
        self._post()
    def _post(self):
        def _resolve():
            self.fut.set_result(1)
        self.loop.call_soon_threadsafe(_resolve)
        self.fut.set_exception(ValueError())
""",
    b"""\
import multiprocessing, threading
def child(x):
    return x
class Sup:
    def spawn(self):
        lock = threading.Lock()
        ctx = multiprocessing.get_context("spawn")
        ctx.Process(target=self.spawn, args=(lock, self)).start()
        ctx.Process(target=child, args=(1,)).start()
""",
    b"""\
import asyncio, threading
def a():
    b()
def b():
    a()
    asyncio.ensure_future(None)
threading.Thread(target=a).start()
""",
    b"""\
import struct, zlib
_H = struct.Struct(">II")
def frame(p):
    crc = zlib.crc32(p) & 0xFFFFFFFF
    return _H.pack(len(p), crc) + p
""",
    b"""\
class ServerState:
    async def bad(self, uid, data):
        shard = self._shard_for_user(uid)
        registry = shard._sessions if uid else shard._challenges
        registry.pop(uid, None)
""",
    b"x = 1  # cpzk-lint: disable=THREAD-001,NO-SUCH-RULE -- stale on purpose\n",
]


def _seeds() -> list[bytes]:
    return list(_SEED_SNIPPETS)


def one_input(data: bytes) -> None:
    try:
        source = data.decode()
    except UnicodeDecodeError:
        source = data.decode("utf-8", "replace")
    # rotate the virtual path so plane-scoped rules all get exercised
    plane = ("core", "protocol", "server", "client", "ops", "")[len(data) % 6]
    path = f"cpzk_tpu_torch/{plane}/fuzzed.py" if plane else "fuzzed.py"
    report = analyze_source(source, path=path)
    # the reporting path must hold too: render + JSON round-trip
    for f in report.findings + report.waived:
        assert f.render()
    json.dumps(report.to_dict())


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
