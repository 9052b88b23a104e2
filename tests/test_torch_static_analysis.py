"""cpzk-lint on the port: the twin of ``tests/test_static_analysis.py``.

Every case of the reference's file runs here against
``cpzk_tpu_torch.analysis`` on fixture paths under ``cpzk_tpu_torch/``,
and each fixture also goes through the reference's analyser at the same
path under ``cpzk_tpu/``: the two must give the same ``(rule, line,
col, message)`` lists, waived findings and waiver audit (see
:func:`analyze_source` below).  Beside the twins:

- the port's self-host: zero findings over ``cpzk_tpu_torch/``, the
  waived findings are LOCK-001, ACK-001 and FENCE-001 in
  ``server/state.py`` and AWAIT-001 in ``server/service.py``, no waiver
  is stale;
- the tree parity: the reference's analyser over a copy of the port
  placed at ``cpzk_tpu/`` reports what the port's reports over the port;
- the CLI's exit codes and the docs/security.md drift guard on the
  port's registry (in the twins).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from cpzk_tpu.analysis import analyze_paths as reference_analyze_paths
from cpzk_tpu.analysis import analyze_source as reference_analyze_source
from cpzk_tpu_torch.analysis import REGISTRY, all_rule_ids, analyze_paths
from cpzk_tpu_torch.analysis import analyze_source as port_analyze_source

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "cpzk_tpu_torch")

#: The rule pack; WAIVER/PARSE are engine-emitted.
CORE_RULES = [
    "CT-001", "CT-002", "LEAK-001", "LOCK-001",
    "ASYNC-001", "ASYNC-002", "GRPC-001", "JAX-001",
    "THREAD-001", "FUNNEL-001", "PROC-001", "FRAME-001",
    "AWAIT-001", "ACK-001", "FENCE-001",
]


def rules_of(report) -> list[str]:
    return sorted({f.rule for f in report.findings})


def reference_path(path: str) -> str:
    """The reference's path for a port path: ``cpzk_tpu_torch/x`` ->
    ``cpzk_tpu/x`` (the plane key of each analyser is its own package)."""
    head, _, rest = path.partition("/")
    return f"cpzk_tpu/{rest}" if head == "cpzk_tpu_torch" else path


def verdicts(report) -> tuple:
    """What parity compares: findings and waived findings as ``(rule,
    line, col, message)``, and the waiver audit."""
    return ([(f.rule, f.line, f.col, f.message) for f in report.findings],
            [(f.rule, f.line, f.col, f.message) for f in report.waived],
            [(w.line, w.rules, w.reason, w.waived, w.stale) for w in report.waivers])


def analyze_source(source: str, path: str = "cpzk_tpu_torch/fixture.py",
                   rules: list[str] | None = None):
    """The port's analyser on one fixture, held against the reference's
    on the same source at :func:`reference_path`; returns the port's
    report."""
    report = port_analyze_source(source, path=path, rules=rules)
    reference = reference_analyze_source(source, path=reference_path(path), rules=rules)
    assert verdicts(report) == verdicts(reference), (path, source)
    return report


@pytest.fixture(scope="module")
def tree_report():
    """The port's analyser over the whole port (about 5 s; shared)."""
    return analyze_paths([PKG])


# -- self-hosting -------------------------------------------------------------


class TestSelfHosted:
    def test_whole_tree_is_clean(self, tree_report):
        """THE gate: zero findings over the real package.  A new violation
        anywhere in cpzk_tpu_torch/ — or a reverted fix — fails tier-1."""
        report = tree_report
        assert report.files > 50  # sanity: the walker saw the real tree
        assert [f.render() for f in report.findings] == []

    def test_real_waivers_carry_reasons(self, tree_report):
        """The tree's own waivers are active, reasoned, and bounded:
        LOCK-001 on ServerState's documented single-threaded paths, plus
        the v3 atomicity waivers (unfenced consume/sweep/restore with
        their live-split and handover rationale, and verify_proof_batch's per-entry
        fence mapping)."""
        report = tree_report
        assert report.waived, "expected the documented waivers"
        assert {f.rule for f in report.waived} == {
            "LOCK-001", "AWAIT-001", "ACK-001", "FENCE-001",
        }
        assert all(
            f.path.endswith(("server/state.py", "server/service.py"))
            for f in report.waived
        )

    def test_cli_json_on_real_tree(self, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", PKG, "--json"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["findings"] == []
        assert doc["summary"]["findings"] == 0

    def test_cli_exit_two_on_missing_path(self):
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", "/no/such/dir"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 2  # a typo'd path must not gate green

    def test_cli_exit_one_on_findings(self, tmp_path):
        bad = tmp_path / "cpzk_tpu_torch" / "server" / "bad.py"
        bad.parent.mkdir(parents=True)
        bad.write_text("import asyncio\nasyncio.create_task(f())\n")
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", str(bad)],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 1
        assert "ASYNC-002" in proc.stdout


# -- CT-001 -------------------------------------------------------------------


class TestCT001:
    def test_true_positive_secret_bytes_equality(self):
        src = (
            "import hashlib\n"
            "def check(password: str, stored: bytes) -> bool:\n"
            "    okm = hashlib.sha256(password.encode()).digest()\n"
            "    return okm == stored\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/client/fx.py")
        assert "CT-001" in rules_of(report)

    def test_true_positive_kdf_output(self):
        src = (
            "from argon2.low_level import hash_secret_raw\n"
            "def check(data, stored):\n"
            "    okm = hash_secret_raw(secret=data, salt=b'x')\n"
            "    return stored != okm\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/client/fx.py")
        assert "CT-001" in rules_of(report)

    def test_clean_compare_digest(self):
        src = (
            "import hashlib, hmac\n"
            "def check(password: str, stored: bytes) -> bool:\n"
            "    okm = hashlib.sha256(password.encode()).digest()\n"
            "    return hmac.compare_digest(okm, stored)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/client/fx.py")
        assert "CT-001" not in rules_of(report)

    def test_clean_scalar_equality(self):
        """Scalar-to-Scalar == goes through the ct __eq__ — not a finding."""
        src = (
            "def check(witness: Witness, other: Witness) -> bool:\n"
            "    return witness.secret() == other.secret()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/protocol/fx.py")
        assert "CT-001" not in rules_of(report)

    def test_clean_public_equality(self):
        src = "def f(a: bytes, b: bytes):\n    return a == b\n"
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert rules_of(report) == []


# -- CT-002 -------------------------------------------------------------------


class TestCT002:
    TP = (
        "def f(witness: Witness):\n"
        "    x = witness.secret()\n"
        "    if x.value:\n"
        "        return 1\n"
        "    return 0\n"
    )

    def test_true_positive_in_core(self):
        report = analyze_source(self.TP, path="cpzk_tpu_torch/core/fx.py")
        assert "CT-002" in rules_of(report)

    def test_true_positive_short_circuit(self):
        src = (
            "def f(nonce: Nonce, flag: bool):\n"
            "    return nonce.k().value and flag\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/protocol/fx.py")
        assert "CT-002" in rules_of(report)

    def test_out_of_scope_plane_is_clean(self):
        """Host planes branch on secrets' existence legitimately; CT-002
        is scoped to the protocol math."""
        report = analyze_source(self.TP, path="cpzk_tpu_torch/server/fx.py")
        assert "CT-002" not in rules_of(report)

    def test_clean_public_branch(self):
        src = (
            "def f(witness: Witness, n: int):\n"
            "    if n > 0:\n"
            "        return witness.secret()\n"
            "    return None\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/core/fx.py")
        assert "CT-002" not in rules_of(report)


# -- LEAK-001 -----------------------------------------------------------------


class TestLEAK001:
    def test_true_positive_fstring_log(self):
        src = (
            "import logging\n"
            "log = logging.getLogger('x')\n"
            "def f(witness: Witness):\n"
            "    log.info(f'witness is {witness.secret().value}')\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "LEAK-001" in rules_of(report)

    def test_true_positive_exception_message(self):
        src = (
            "def f(password: str):\n"
            "    raise ValueError('bad password: ' + password)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/client/fx.py")
        assert "LEAK-001" in rules_of(report)

    def test_true_positive_record_event(self):
        src = (
            "def f(tracer, nonce: Nonce):\n"
            "    tracer.record_event('prove', k=nonce.k().value)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/protocol/fx.py")
        assert "LEAK-001" in rules_of(report)

    def test_true_positive_metric_label(self):
        src = (
            "def f(hist, password: str):\n"
            "    hist.labels(backend=password).observe(1.0)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "LEAK-001" in rules_of(report)

    def test_clean_public_logging(self):
        src = (
            "import logging\n"
            "log = logging.getLogger('x')\n"
            "def f(witness: Witness, user_id: str):\n"
            "    log.info('registered %s', user_id)\n"
            "    log.info(f'user {user_id} ok')\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "LEAK-001" not in rules_of(report)

    def test_clean_length_is_sanitized(self):
        src = (
            "import logging\n"
            "log = logging.getLogger('x')\n"
            "def f(password: str):\n"
            "    log.info('password length %d', len(password))\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/client/fx.py")
        assert "LEAK-001" not in rules_of(report)


# -- LOCK-001 -----------------------------------------------------------------


FIXTURE_STATE = """\
import asyncio

class ServerState:
    def __init__(self):
        self._lock = asyncio.Lock()
        self._users = {}
        self._sessions = {}
        self._user_sessions = {}
        self.journal = None

    async def good(self, uid, data):
        async with self._lock:
            self._users[uid] = data
            self._journal_append("register_user", {})

    async def bad(self, uid, data):
        self._users[uid] = data

    async def bad_pop(self, token):
        self._sessions.pop(token, None)

    async def bad_alias(self, uid, token):
        per_user = self._user_sessions.setdefault(uid, [])
        per_user.append(token)

    async def bad_journal(self):
        self._journal_append("revoke_session", {})
"""


class TestLOCK001:
    def test_true_positives(self):
        report = analyze_source(FIXTURE_STATE, path="cpzk_tpu_torch/server/state.py")
        lock_findings = [f for f in report.findings if f.rule == "LOCK-001"]
        flagged = "\n".join(f.message for f in lock_findings)
        # bad, bad_pop, bad_alias (both the .setdefault and the aliased
        # .append), bad_journal — and never the locked/`__init__` sites
        assert len(lock_findings) == 5
        assert "bad " in flagged or "rebinds" in flagged or "subscript" in flagged
        assert any("journal" in f.message for f in lock_findings)
        assert any(".append()" in f.message for f in lock_findings)

    def test_clean_under_lock_and_init(self):
        clean = FIXTURE_STATE.split("    async def bad")[0]
        report = analyze_source(clean, path="cpzk_tpu_torch/server/state.py")
        assert "LOCK-001" not in rules_of(report)

    def test_other_classes_out_of_scope(self):
        src = (
            "class Batcher:\n"
            "    def f(self):\n"
            "        self._users['a'] = 1\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/batching.py")
        assert "LOCK-001" not in rules_of(report)


FIXTURE_SHARDED = """\
import asyncio

class ServerState:
    def __init__(self):
        self._shards = [None]

    def _shard_for_user(self, uid):
        return self._shards[0]

    async def good(self, uid, data):
        shard = self._shard_for_user(uid)
        async with shard.lock:
            shard._users[uid] = data
            per_user = shard._user_sessions.setdefault(uid, [])
            per_user.append("t")
            self._journal_append("register_user", {})

    async def good_sweep(self):
        for shard in self._shards:
            async with shard.lock:
                shard._sessions.pop("t", None)

    async def good_subscript_alias(self, idx, cid):
        shard = self._shards[idx]
        async with shard.lock:
            del shard._challenges[cid]

    async def bad(self, uid, data):
        shard = self._shard_for_user(uid)
        shard._users[uid] = data

    async def bad_wrong_shard_lock(self, uid, data):
        a = self._shard_for_user(uid)
        b = self._shard_for_user("other")
        async with a.lock:
            b._users[uid] = data

    async def bad_member_alias(self, uid, token):
        shard = self._shard_for_user(uid)
        per_user = shard._user_sessions.setdefault(uid, [])
        per_user.append(token)

    async def bad_journal_outside(self, uid):
        shard = self._shard_for_user(uid)
        self._journal_append("revoke_session", {})
"""


class TestLOCK001Sharded:
    """The sharded-lock contract: mutations through a shard
    alias need that SAME shard's lock; journal appends need any held
    state/shard lock.  The real sharded ``ServerState`` self-hosts at
    zero findings through these rules — no blanket waivers."""

    def test_true_positives(self):
        report = analyze_source(FIXTURE_SHARDED, path="cpzk_tpu_torch/server/state.py")
        lock_findings = [f for f in report.findings if f.rule == "LOCK-001"]
        flagged = "\n".join(f.message for f in lock_findings)
        # bad, bad_wrong_shard_lock, bad_member_alias (setdefault + the
        # aliased append), bad_journal_outside — never the locked sites
        assert len(lock_findings) == 5
        assert "bad " in flagged or "subscript" in flagged
        # holding shard A's lock does not license mutating shard B
        assert "`with b.lock`" in flagged
        assert any("journal" in f.message for f in lock_findings)
        assert not any("good" in f.message for f in lock_findings)

    def test_clean_under_shard_locks(self):
        clean = FIXTURE_SHARDED.split("    async def bad")[0]
        report = analyze_source(clean, path="cpzk_tpu_torch/server/state.py")
        assert "LOCK-001" not in rules_of(report)

    def test_real_sharded_state_self_hosts(self):
        """The actual ServerState — shard routing, bulk per-shard ops,
        journal funnel — passes with only its two documented waivers."""
        report = analyze_paths([os.path.join(PKG, "server", "state.py")])
        assert [f.render() for f in report.findings] == []
        assert report.waived  # replay/journal waivers are active, not dead


# -- ASYNC-001 ----------------------------------------------------------------


class TestASYNC001:
    def test_true_positive_sleep_and_open(self):
        src = (
            "import time\n"
            "async def handler():\n"
            "    time.sleep(0.1)\n"
            "    with open('/tmp/x') as f:\n"
            "        return f.read()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        msgs = [f.message for f in report.findings if f.rule == "ASYNC-001"]
        assert len(msgs) == 2
        assert any("time.sleep" in m for m in msgs)
        assert any("open()" in m for m in msgs)

    def test_true_positive_fsync_subprocess(self):
        src = (
            "import os, subprocess\n"
            "async def handler(fd):\n"
            "    os.fsync(fd)\n"
            "    subprocess.run(['ls'])\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/durability/fx.py")
        assert len([f for f in report.findings if f.rule == "ASYNC-001"]) == 2

    def test_clean_to_thread_and_nested_sync_def(self):
        src = (
            "import asyncio, os, time\n"
            "async def handler(path):\n"
            "    def write():\n"
            "        with open(path, 'w') as f:\n"
            "            f.write('x')\n"
            "            os.fsync(f.fileno())\n"
            "    await asyncio.to_thread(write)\n"
            "    await asyncio.to_thread(time.sleep, 0.1)\n"
            "    await asyncio.sleep(0.1)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-001" not in rules_of(report)

    def test_nested_sync_def_called_inline_is_flagged(self):
        """The context-inference upgrade: a nested helper the
        async body calls inline runs ON the loop — the indirection no
        longer hides the blocking call."""
        src = (
            "import time\n"
            "async def handler():\n"
            "    def helper():\n"
            "        time.sleep(1)\n"
            "    helper()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        msgs = [f.message for f in report.findings if f.rule == "ASYNC-001"]
        assert len(msgs) == 1
        assert "helper" in msgs[0] and "handler" in msgs[0]

    def test_nested_def_both_inline_and_to_thread_is_exempt(self):
        """Shipped to a thread at least once -> the helper may block."""
        src = (
            "import asyncio, time\n"
            "async def handler():\n"
            "    def helper():\n"
            "        time.sleep(1)\n"
            "    helper()\n"
            "    await asyncio.to_thread(helper)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-001" not in rules_of(report)

    def test_out_of_scope_plane_is_clean(self):
        src = "import time\nasync def f():\n    time.sleep(1)\n"
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "ASYNC-001" not in rules_of(report)

    def test_sync_functions_are_clean(self):
        src = "def f(path):\n    return open(path).read()\n"
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-001" not in rules_of(report)


# -- ASYNC-002 ----------------------------------------------------------------


class TestASYNC002:
    def test_true_positive_discarded(self):
        src = (
            "import asyncio\n"
            "async def f():\n"
            "    asyncio.create_task(work())\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-002" in rules_of(report)

    def test_true_positive_underscore(self):
        src = (
            "import asyncio\n"
            "async def f():\n"
            "    _ = asyncio.ensure_future(work())\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-002" in rules_of(report)

    def test_clean_retained(self):
        src = (
            "import asyncio\n"
            "async def f(self):\n"
            "    self._task = asyncio.create_task(work())\n"
            "    t = asyncio.get_running_loop().create_task(work())\n"
            "    self._tasks.add(t)\n"
            "    await asyncio.create_task(work())\n"
            "    await self._task\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-002" not in rules_of(report)


# -- GRPC-001 -----------------------------------------------------------------


class TestGRPC001:
    def test_true_positive_direct_abort(self):
        """The overload pushback invariant: reverting a handler to a direct
        RESOURCE_EXHAUSTED abort is flagged."""
        src = (
            "import grpc\n"
            "class AuthServiceImpl:\n"
            "    async def create_challenge(self, request, context):\n"
            "        await context.abort(\n"
            "            grpc.StatusCode.RESOURCE_EXHAUSTED, 'overloaded')\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/service.py")
        assert "GRPC-001" in rules_of(report)

    def test_clean_funnel_and_other_codes(self):
        src = (
            "import grpc\n"
            "class AuthServiceImpl:\n"
            "    async def _abort_exhausted(self, context, msg, retry_after_s):\n"
            "        await context.abort(\n"
            "            grpc.StatusCode.RESOURCE_EXHAUSTED, msg,\n"
            "            trailing_metadata=(('cpzk-retry-after-ms', '50'),))\n"
            "    async def handler(self, request, context):\n"
            "        await self._abort_exhausted(context, 'overloaded', 0.05)\n"
            "        await context.abort(grpc.StatusCode.INVALID_ARGUMENT, 'bad')\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/service.py")
        assert "GRPC-001" not in rules_of(report)


# -- JAX-001 ------------------------------------------------------------------


class TestJAX001:
    def test_true_positive_impure_body(self):
        src = (
            "import jax, time\n"
            "@jax.jit\n"
            "def kernel(x):\n"
            "    return x * time.time()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "JAX-001" in rules_of(report)

    def test_true_positive_python_rng(self):
        src = (
            "import jax, random\n"
            "from functools import partial\n"
            "@partial(jax.jit, static_argnums=(0,))\n"
            "def kernel(n, x):\n"
            "    return x + random.random()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "JAX-001" in rules_of(report)

    def test_true_positive_bad_static_argnames(self):
        src = (
            "import jax\n"
            "from functools import partial\n"
            "@partial(jax.jit, static_argnames=('missing',))\n"
            "def kernel(n, x):\n"
            "    return x * n\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "JAX-001" in rules_of(report)

    def test_true_positive_bad_static_argnums(self):
        src = (
            "import jax\n"
            "def kernel(x):\n"
            "    return x\n"
            "jitted = jax.jit(kernel, static_argnums=(3,))\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "JAX-001" in rules_of(report)

    def test_clean_pure_kernel(self):
        src = (
            "import jax\n"
            "import jax.numpy as jnp\n"
            "from functools import partial\n"
            "@partial(jax.jit, static_argnames=('n',))\n"
            "def kernel(n, x):\n"
            "    key = jax.random.PRNGKey(0)\n"
            "    return jnp.sum(x) * n + jax.random.uniform(key)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "JAX-001" not in rules_of(report)

    def test_clean_host_function_uses_clock(self):
        src = "import time\ndef host():\n    return time.time()\n"
        report = analyze_source(src, path="cpzk_tpu_torch/ops/fx.py")
        assert "JAX-001" not in rules_of(report)


# -- execution-context inference ----------------------------------------------


class TestContextInference:
    """The interprocedural layer the context rules read: spawn-site
    seeding + caller->callee propagation."""

    @staticmethod
    def contexts_of(src: str) -> dict:
        from cpzk_tpu_torch.analysis.engine import parse_module

        mod = parse_module(src, "cpzk_tpu_torch/server/fx.py")
        return {
            info.qualname: set(info.contexts)
            for info in mod.contexts.values()
        }

    def test_thread_target_and_propagation(self):
        ctx = self.contexts_of(
            "import threading\n"
            "class Lane:\n"
            "    def start(self):\n"
            "        threading.Thread(target=self._loop).start()\n"
            "    def _loop(self):\n"
            "        self._post()\n"
            "    def _post(self):\n"
            "        pass\n"
        )
        assert "thread" in ctx["Lane._loop"]
        assert "thread" in ctx["Lane._post"]  # propagated through the call
        assert "thread" not in ctx["Lane.start"]

    def test_to_thread_and_run_in_executor_targets(self):
        ctx = self.contexts_of(
            "import asyncio\n"
            "async def handler(loop):\n"
            "    def work():\n"
            "        pass\n"
            "    def work2():\n"
            "        pass\n"
            "    await asyncio.to_thread(work)\n"
            "    await loop.run_in_executor(None, work2)\n"
        )
        assert "thread" in ctx["handler.work"]
        assert "thread" in ctx["handler.work2"]

    def test_spawn_target_is_process_context(self):
        ctx = self.contexts_of(
            "import multiprocessing\n"
            "def child():\n"
            "    helper()\n"
            "def helper():\n"
            "    pass\n"
            "def spawn():\n"
            "    ctx = multiprocessing.get_context('spawn')\n"
            "    ctx.Process(target=child).start()\n"
        )
        assert "process" in ctx["child"]
        assert "process" in ctx["helper"]  # propagated

    def test_callback_runs_on_the_loop(self):
        """A callable registered through call_soon_threadsafe is seeded
        event-loop — the sanctioned bridge's callback is loop context."""
        ctx = self.contexts_of(
            "import threading\n"
            "def worker(loop, fut):\n"
            "    def deliver():\n"
            "        fut.set_result(1)\n"
            "    loop.call_soon_threadsafe(deliver)\n"
            "threading.Thread(target=worker).start()\n"
        )
        assert "thread" in ctx["worker"]
        assert ctx["worker.deliver"] == {"event-loop"}

    def test_async_defs_absorb_no_thread_context(self):
        """Calling an async def from a thread builds a coroutine; THREAD
        must not flow into it."""
        ctx = self.contexts_of(
            "import threading\n"
            "async def coro():\n"
            "    pass\n"
            "def worker():\n"
            "    coro()\n"
            "threading.Thread(target=worker).start()\n"
        )
        assert ctx["coro"] == {"event-loop"}

    def test_nested_def_resolution_is_lexical(self):
        ctx = self.contexts_of(
            "import threading\n"
            "def outer():\n"
            "    def run():\n"
            "        pass\n"
            "    threading.Thread(target=run).start()\n"
        )
        assert "thread" in ctx["outer.run"]


# -- THREAD-001 ---------------------------------------------------------------


class TestTHREAD001:
    def test_true_positive_thread_settles_future(self):
        src = (
            "import threading\n"
            "class Lane:\n"
            "    def start(self):\n"
            "        threading.Thread(target=self._loop).start()\n"
            "    def _loop(self):\n"
            "        self._post()\n"
            "    def _post(self):\n"
            "        self.fut.set_result(1)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        msgs = [f.message for f in report.findings if f.rule == "THREAD-001"]
        assert len(msgs) == 1
        assert "set_result" in msgs[0] and "call_soon_threadsafe" in msgs[0]

    def test_true_positive_to_thread_schedules_task(self):
        src = (
            "import asyncio\n"
            "async def handler(self):\n"
            "    def work():\n"
            "        asyncio.ensure_future(self.job())\n"
            "    await asyncio.to_thread(work)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "THREAD-001" in rules_of(report)

    def test_clean_call_soon_threadsafe_bridge(self):
        """The dispatch lane's exact posting pattern: the bridge call is
        sanctioned and the callback is event-loop context."""
        src = (
            "import threading\n"
            "class Lane:\n"
            "    def start(self):\n"
            "        threading.Thread(target=self._post).start()\n"
            "    def _post(self):\n"
            "        def _resolve():\n"
            "            self.fut.set_result(1)\n"
            "        self.loop.call_soon_threadsafe(_resolve)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "THREAD-001" not in rules_of(report)

    def test_clean_thread_owned_loop(self):
        """The start_in_thread bootstrap: a loop the thread itself
        created is driven with call_soon legitimately."""
        src = (
            "import asyncio, threading\n"
            "def start_in_thread(self):\n"
            "    def run():\n"
            "        loop = asyncio.new_event_loop()\n"
            "        loop.call_soon(self.start)\n"
            "        loop.run_forever()\n"
            "    threading.Thread(target=run).start()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "THREAD-001" not in rules_of(report)

    def test_clean_event_loop_context_untouched(self):
        src = (
            "async def handler(self):\n"
            "    self.fut.set_result(1)\n"
            "def plain(self):\n"
            "    self.fut.set_result(1)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "THREAD-001" not in rules_of(report)


# -- FUNNEL-001 ---------------------------------------------------------------


class TestFUNNEL001:
    def test_true_positive_direct_shard_write(self):
        src = (
            "class ServerState:\n"
            "    async def bad(self, uid, data):\n"
            "        shard = self._shard_for_user(uid)\n"
            "        async with shard.lock:\n"
            "            shard._sessions[uid] = data\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/state.py")
        msgs = [f.message for f in report.findings if f.rule == "FUNNEL-001"]
        assert len(msgs) == 1
        assert "_session_insert" in msgs[0]

    def test_true_positive_registry_alias_pop(self):
        """The sweep's ternary alias shape must not hide a mutation."""
        src = (
            "class ServerState:\n"
            "    async def bad(self, key, is_sessions):\n"
            "        for shard in self._shards:\n"
            "            registry = (\n"
            "                shard._sessions if is_sessions\n"
            "                else shard._challenges\n"
            "            )\n"
            "            registry.pop(key, None)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/state.py")
        assert "FUNNEL-001" in rules_of(report)

    def test_true_positive_del_through_self(self):
        src = (
            "class ServerState:\n"
            "    async def bad(self, uid):\n"
            "        del self._users[uid]\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/state.py")
        assert "FUNNEL-001" in rules_of(report)

    def test_clean_funnels_and_reads(self):
        src = (
            "class ServerState:\n"
            "    def __init__(self):\n"
            "        self._users = {}\n"
            "    def _session_insert(self, shard, data):\n"
            "        shard._sessions[data.token] = data\n"
            "    def _session_remove(self, shard, token):\n"
            "        return shard._sessions.pop(token, None)\n"
            "    async def good(self, uid, data):\n"
            "        shard = self._shard_for_user(uid)\n"
            "        async with shard.lock:\n"
            "            self._session_insert(shard, data)\n"
            "            return shard._sessions.get(uid)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/state.py")
        assert "FUNNEL-001" not in rules_of(report)

    def test_other_classes_out_of_scope(self):
        src = (
            "class Cache:\n"
            "    def put(self, k, v):\n"
            "        self._sessions[k] = v\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/batching.py")
        assert "FUNNEL-001" not in rules_of(report)

    def test_real_state_self_hosts(self):
        """The live ServerState routes every registry mutation through
        the six funnels — zero FUNNEL-001 findings, no waivers needed."""
        report = analyze_paths(
            [os.path.join(PKG, "server", "state.py")], rules=["FUNNEL-001"]
        )
        assert [f.render() for f in report.findings] == []


# -- PROC-001 -----------------------------------------------------------------


class TestPROC001:
    def test_true_positive_bound_method_target(self):
        src = (
            "import multiprocessing\n"
            "class Sup:\n"
            "    def spawn(self):\n"
            "        ctx = multiprocessing.get_context('spawn')\n"
            "        ctx.Process(target=self._run).start()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        msgs = [f.message for f in report.findings if f.rule == "PROC-001"]
        assert len(msgs) == 1 and "bound" in msgs[0]

    def test_true_positive_nested_def_target(self):
        src = (
            "import multiprocessing\n"
            "def spawn():\n"
            "    def child():\n"
            "        pass\n"
            "    multiprocessing.Process(target=child).start()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "PROC-001" in rules_of(report)

    def test_true_positive_lambda_target(self):
        src = (
            "import multiprocessing\n"
            "multiprocessing.Process(target=lambda: None).start()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "PROC-001" in rules_of(report)

    def test_true_positive_unsafe_args(self):
        src = (
            "import multiprocessing, threading\n"
            "def child(x, y):\n"
            "    pass\n"
            "class Sup:\n"
            "    def spawn(self):\n"
            "        lock = threading.Lock()\n"
            "        ctx = multiprocessing.get_context('spawn')\n"
            "        ctx.Process(target=child, args=(lock, self)).start()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        msgs = [f.message for f in report.findings if f.rule == "PROC-001"]
        assert len(msgs) == 2
        assert any("lock" in m for m in msgs)
        assert any("`self`" in m for m in msgs)

    def test_clean_module_level_target_plain_args(self):
        """The real ingest spawn shape: module-level target, primitives,
        attribute reads (self.host is a value, not the instance)."""
        src = (
            "import multiprocessing\n"
            "def run_shard(i, path, opts):\n"
            "    pass\n"
            "class Sup:\n"
            "    def spawn(self, index):\n"
            "        ctx = multiprocessing.get_context('spawn')\n"
            "        ctx.Process(\n"
            "            target=run_shard,\n"
            "            args=(index, self.uds_path, {'host': self.host}),\n"
            "        ).start()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "PROC-001" not in rules_of(report)

    def test_real_ingest_self_hosts(self):
        report = analyze_paths(
            [os.path.join(PKG, "server", "ingest.py")], rules=["PROC-001"]
        )
        assert [f.render() for f in report.findings] == []


# -- FRAME-001 ----------------------------------------------------------------


class TestFRAME001:
    TP = (
        "import struct, zlib\n"
        "_H = struct.Struct('>II')\n"
        "def frame(p: bytes) -> bytes:\n"
        "    crc = zlib.crc32(p) & 0xFFFFFFFF\n"
        "    return _H.pack(len(p), crc) + p\n"
    )

    def test_true_positive_hand_rolled_frame(self):
        report = analyze_source(self.TP, path="cpzk_tpu_torch/server/fx.py")
        msgs = [f.message for f in report.findings if f.rule == "FRAME-001"]
        # the private header declaration AND the pack-with-crc are each
        # findings (reverting the ingest refactor re-fails on both)
        assert len(msgs) == 2
        assert any("frame_payload" in m for m in msgs)
        assert any("'>II'" in m for m in msgs)

    def test_wal_itself_is_the_canonical_home(self):
        report = analyze_source(self.TP, path="cpzk_tpu_torch/durability/wal.py")
        assert "FRAME-001" not in rules_of(report)

    def test_clean_non_framing_crc(self):
        """Whole-object CRCs (segment checksums, shard hashes) that never
        enter a packed header are out of scope."""
        src = (
            "import zlib\n"
            "def shard_index(uid: str, n: int) -> int:\n"
            "    return zlib.crc32(uid.encode()) % n\n"
            "def seg_crc(frames: bytes) -> int:\n"
            "    return zlib.crc32(frames) & 0xFFFFFFFF\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/replication/fx.py")
        assert "FRAME-001" not in rules_of(report)

    def test_real_ingest_uses_shared_helpers(self):
        """The FRAME-001 fix: reverting server/ingest.py to
        its hand-rolled _HEADER re-fails here (and in the self-host)."""
        report = analyze_paths(
            [os.path.join(PKG, "server", "ingest.py")], rules=["FRAME-001"]
        )
        assert [f.render() for f in report.findings] == []

    def test_shared_helpers_are_byte_identical(self):
        """pack_frame rides wal.frame_payload — one framing contract."""
        from cpzk_tpu_torch.durability.wal import frame_payload, iter_frames
        from cpzk_tpu_torch.server.ingest import pack_frame

        payload = b'{"seq":1,"type":"x"}'
        assert pack_frame(payload) == frame_payload(payload)
        rec, valid = iter_frames(frame_payload(payload))
        assert rec == [{"seq": 1, "type": "x"}]
        assert valid == len(frame_payload(payload))


# -- WAIVER-002 ---------------------------------------------------------------


class TestWAIVER002:
    def test_stale_waiver_is_a_finding(self):
        src = "x = 1  # cpzk-lint: disable=CT-001 -- nothing fires here\n"
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert [f.rule for f in report.findings] == ["WAIVER-002"]
        assert "stale" in report.findings[0].message

    def test_live_waiver_is_not_stale(self):
        src = (
            "import asyncio\n"
            "asyncio.create_task(f())  "
            "# cpzk-lint: disable=ASYNC-002 -- fixture: live\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_unknown_rule_id_is_stale(self):
        src = "x = 1  # cpzk-lint: disable=NO-SUCH-RULE -- typo'd id\n"
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert [f.rule for f in report.findings] == ["WAIVER-002"]

    def test_mixed_waiver_reports_only_the_stale_id(self):
        src = (
            "import asyncio\n"
            "asyncio.create_task(f())  "
            "# cpzk-lint: disable=ASYNC-002,CT-001 -- one live, one stale\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert [f.rule for f in report.findings] == ["WAIVER-002"]
        assert "CT-001" in report.findings[0].message
        assert "ASYNC-002" not in report.findings[0].message

    def test_rules_filter_cannot_judge_staleness(self):
        """A --rules run that skipped the waived rule must not call its
        waiver stale (the rule never got a chance to fire)."""
        from cpzk_tpu_torch.analysis.engine import _analyze

        src = "x = 1  # cpzk-lint: disable=CT-001 -- fixture\n"
        report = _analyze(
            [(src, "cpzk_tpu_torch/server/fx.py")], ["ASYNC-002", "WAIVER-002"]
        )
        assert report.findings == []

    def test_waiver_002_cannot_be_waived(self):
        """Emitted by the engine after waiver matching — a disable
        comment cannot suppress its own staleness."""
        src = (
            "x = 1  "
            "# cpzk-lint: disable=CT-001,WAIVER-002 -- try to self-excuse\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "WAIVER-002" in [f.rule for f in report.findings]

    def test_docstring_mention_is_not_a_waiver(self):
        """The tokenize-based comment scan: waiver syntax quoted inside a
        string/docstring (the docs do) must not register at all."""
        src = (
            '"""Write `# cpzk-lint: disable=CT-001 -- why` inline."""\n'
            "MSG = 'use # cpzk-lint: disable=LOCK-001 -- reason'\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []
        assert report.waivers == []

    def test_real_tree_has_no_stale_waivers(self, tree_report):
        report = tree_report
        stale = [w.render() for w in report.waivers if w.stale]
        assert stale == []
        assert all(w.reason for w in report.waivers)

    def test_audit_waivers_cli(self):
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", PKG,
             "--audit-waivers"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "waivers (0 stale)" in proc.stdout
        assert "state.py" in proc.stdout  # the documented LOCK-001 trio
        assert "active (" in proc.stdout

    def test_audit_waivers_cli_exits_one_on_stale(self, tmp_path):
        bad = tmp_path / "cpzk_tpu_torch" / "server" / "fx.py"
        bad.parent.mkdir(parents=True)
        bad.write_text("x = 1  # cpzk-lint: disable=CT-001 -- stale\n")
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", str(bad),
             "--audit-waivers"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 1
        assert "STALE" in proc.stdout


# -- waivers ------------------------------------------------------------------


class TestWaivers:
    BAD_LINE = "import asyncio\nasyncio.create_task(f())"

    def test_waiver_with_reason_suppresses(self):
        src = (
            "import asyncio\n"
            "asyncio.create_task(f())  "
            "# cpzk-lint: disable=ASYNC-002 -- fixture: lifetime managed by caller\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []
        assert [f.rule for f in report.waived] == ["ASYNC-002"]

    def test_waiver_without_reason_is_a_finding(self):
        src = (
            "import asyncio\n"
            "asyncio.create_task(f())  # cpzk-lint: disable=ASYNC-002\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        # the original finding IS suppressed, but the bare waiver is its
        # own (unwaivable) finding — suppressions always carry a why
        assert [f.rule for f in report.findings] == ["WAIVER-001"]

    def test_waiver_wrong_rule_does_not_suppress(self):
        src = (
            "import asyncio\n"
            "asyncio.create_task(f())  # cpzk-lint: disable=CT-001 -- wrong id\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ASYNC-002" in rules_of(report)

    def test_function_scope_waiver_on_def_line(self):
        src = (
            "import asyncio\n"
            "# cpzk-lint: disable=ASYNC-002 -- fixture: fire-and-forget by design\n"
            "async def f():\n"
            "    asyncio.create_task(a())\n"
            "    asyncio.create_task(b())\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []
        assert len(report.waived) == 2

    def test_comment_only_waiver_covers_next_line(self):
        src = (
            "import asyncio\n"
            "# cpzk-lint: disable=ASYNC-002 -- fixture: covered next line\n"
            "asyncio.create_task(f())\n"
            "asyncio.create_task(g())\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert len(report.findings) == 1  # only the uncovered second spawn
        assert len(report.waived) == 1


# -- AWAIT-001 (guard staleness across awaits: the live-split bug shape) -----


class TestAWAIT001:
    PRE_FIX = (
        # the exact pre-fix VerifyProof shape: ownership checked at
        # entry, handler parks in the batcher, mints on a stale verdict
        "async def verify_proof(self, request):\n"
        "    if not self.fleet.owns(request.user_id):\n"
        "        return self._redirect_abort(request)\n"
        "    ok = await self.batcher.submit(request)\n"
        "    return await self.state.create_session(request.user_id, ok)\n"
    )

    def test_true_positive_pre_fix_verify_proof_shape(self):
        report = analyze_source(self.PRE_FIX, path="cpzk_tpu_torch/server/fx.py")
        assert rules_of(report) == ["AWAIT-001"]
        assert "await" in report.findings[0].message

    def test_post_fix_wrong_partition_handler_is_clean(self):
        # the shipped fix: the mutation re-fences inside its shard lock
        # and the call site catches WrongPartition -> redirect
        src = (
            "from cpzk_tpu_torch import errors\n"
            "async def verify_proof(self, request):\n"
            "    if not self.fleet.owns(request.user_id):\n"
            "        return self._redirect_abort(request)\n"
            "    ok = await self.batcher.submit(request)\n"
            "    try:\n"
            "        return await self.state.create_session(\n"
            "            request.user_id, ok)\n"
            "    except errors.WrongPartition:\n"
            "        return self._redirect_abort(request)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_guard_reread_after_await_is_clean(self):
        src = (
            "async def verify_proof(self, request):\n"
            "    if not self.fleet.owns(request.user_id):\n"
            "        return self._redirect_abort(request)\n"
            "    ok = await self.batcher.submit(request)\n"
            "    if not self.fleet.owns(request.user_id):\n"
            "        return self._redirect_abort(request)\n"
            "    return await self.state.create_session(request.user_id, ok)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_no_await_between_guard_and_mutation_is_clean(self):
        # the register_batch shape: guard re-read synchronously in the
        # same iteration, nothing suspends in between
        src = (
            "async def register(self, request):\n"
            "    if not self.fleet.owns(request.user_id):\n"
            "        return self._redirect_abort(request)\n"
            "    return await self.state.register_user(request.user_id)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_waiver_suppresses_and_stale_waiver_fires(self):
        waived = self.PRE_FIX.replace(
            "    ok = await self.batcher.submit(request)\n",
            "    ok = await self.batcher.submit(request)\n"
            "    # cpzk-lint: disable=AWAIT-001 -- fixture: callee re-fences\n",
        )
        report = analyze_source(waived, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []
        assert [f.rule for f in report.waived] == ["AWAIT-001"]
        stale = (
            "# cpzk-lint: disable=AWAIT-001 -- fixture: nothing fires here\n"
            "async def quiet(self):\n"
            "    return 1\n"
        )
        report = analyze_source(stale, path="cpzk_tpu_torch/server/fx.py")
        assert [f.rule for f in report.findings] == ["WAIVER-002"]


# -- ACK-001 (journal append must dominate the ack) ---------------------------


class TestACK001:
    def test_true_positive_ack_before_durable(self):
        src = (
            "class ServerState:\n"
            "    async def register_user(self, user_id, record):\n"
            "        shard = self._shard(user_id)\n"
            "        async with shard.lock:\n"
            "            self._fence(user_id)\n"
            "            self._user_insert(user_id, record)\n"
            "        return True\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert rules_of(report) == ["ACK-001"]

    def test_journal_then_sync_before_ack_is_clean(self):
        # the real funnel discipline: append under the shard lock, fsync
        # after it is released, ack last
        src = (
            "class ServerState:\n"
            "    async def register_user(self, user_id, record):\n"
            "        shard = self._shard(user_id)\n"
            "        async with shard.lock:\n"
            "            self._fence(user_id)\n"
            "            self._user_insert(user_id, record)\n"
            "            rec = self._journal_append(record)\n"
            "        await self._journal_sync()\n"
            "        return rec\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_fall_off_the_end_counts_as_an_ack(self):
        # returning None to an awaiting RPC acknowledges it just as much
        src = (
            "class ServerState:\n"
            "    async def revoke_session(self, user_id, sid):\n"
            "        shard = self._shard(user_id)\n"
            "        async with shard.lock:\n"
            "            self._fence(user_id)\n"
            "            self._session_remove(user_id, sid)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert rules_of(report) == ["ACK-001"]

    def test_set_result_is_an_ack(self):
        src = (
            "class ServerState:\n"
            "    async def register_user(self, user_id, fut, record):\n"
            "        shard = self._shard(user_id)\n"
            "        async with shard.lock:\n"
            "            self._fence(user_id)\n"
            "            self._user_insert(user_id, record)\n"
            "            fut.set_result(True)\n"
            "        await self._journal_sync()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "ACK-001" in rules_of(report)


# -- FENCE-001 (user-keyed mutations re-check ownership under the lock) -------


class TestFENCE001:
    def test_true_positive_unfenced_funnel_in_lock(self):
        src = (
            "class ServerState:\n"
            "    async def register_user(self, user_id, record):\n"
            "        shard = self._shard(user_id)\n"
            "        async with shard.lock:\n"
            "            self._user_insert(user_id, record)\n"
            "            rec = self._journal_append(record)\n"
            "        await self._journal_sync()\n"
            "        return rec\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert rules_of(report) == ["FENCE-001"]

    def test_true_positive_funnel_outside_any_lock(self):
        src = (
            "class ServerState:\n"
            "    async def register_user(self, user_id, record):\n"
            "        self._user_insert(user_id, record)\n"
            "        rec = self._journal_append(record)\n"
            "        await self._journal_sync()\n"
            "        return rec\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "FENCE-001" in rules_of(report)
        assert "lock" in report.findings[0].message

    def test_fence_inside_same_lock_is_clean(self):
        src = (
            "class ServerState:\n"
            "    async def register_user(self, user_id, record):\n"
            "        shard = self._shard(user_id)\n"
            "        async with shard.lock:\n"
            "            self._fence(user_id)\n"
            "            self._user_insert(user_id, record)\n"
            "            rec = self._journal_append(record)\n"
            "        await self._journal_sync()\n"
            "        return rec\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_fence_alias_is_tracked(self):
        # the create_sessions shape: the bound method is hoisted once
        # and called per entry inside the lock
        src = (
            "class ServerState:\n"
            "    async def create_sessions(self, entries):\n"
            "        fence = self.owner_fence\n"
            "        shard = self._shard(0)\n"
            "        async with shard.lock:\n"
            "            for user_id, rec in entries:\n"
            "                fence(user_id)\n"
            "                self._session_insert(user_id, rec)\n"
            "                self._journal_append(rec)\n"
            "        await self._journal_sync()\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []

    def test_other_classes_are_out_of_scope(self):
        # the fence contract is ServerState's; a test double reusing the
        # funnel names must not fire
        src = (
            "class FakeStore:\n"
            "    async def register_user(self, user_id, record):\n"
            "        self._user_insert(user_id, record)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert "FENCE-001" not in rules_of(report)

    def test_waiver_suppresses(self):
        src = (
            "class ServerState:\n"
            "    # cpzk-lint: disable=FENCE-001,ACK-001 -- fixture: boot path\n"
            "    async def register_user(self, user_id, record):\n"
            "        self._user_insert(user_id, record)\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert report.findings == []
        assert {f.rule for f in report.waived} == {"FENCE-001", "ACK-001"}


# -- report contract ----------------------------------------------------------


class TestReportContract:
    def test_json_schema_stable(self):
        """Drift guard: the CI artifact's consumers pin these keys.
        Version 2 added the ``waivers`` audit list (WAIVER-002)."""
        doc = analyze_source("x = 1\n").to_dict()
        assert sorted(doc) == [
            "files", "findings", "rule_ids", "schema_version", "summary",
            "tool", "waived", "waivers",
        ]
        assert doc["schema_version"] == 2
        assert doc["tool"] == "cpzk-lint"
        assert sorted(doc["summary"]) == ["findings", "waived"]
        waivers = analyze_source(
            "import asyncio\n"
            "asyncio.create_task(f())  "
            "# cpzk-lint: disable=ASYNC-002 -- fixture: schema pin\n",
            path="cpzk_tpu_torch/server/fx.py",
        ).to_dict()["waivers"]
        assert sorted(waivers[0]) == [
            "line", "path", "reason", "rules", "stale", "waived",
        ]
        bad = analyze_source(
            "import asyncio\nasyncio.create_task(f())\n",
            path="cpzk_tpu_torch/server/fx.py",
        ).to_dict()
        assert sorted(bad["findings"][0]) == [
            "col", "line", "message", "path", "rule",
        ]

    def test_registry_has_the_promised_rule_pack(self):
        for rule_id in CORE_RULES + ["WAIVER-001", "WAIVER-002", "PARSE-001"]:
            assert rule_id in REGISTRY, rule_id
        assert all_rule_ids() == sorted(REGISTRY)

    def test_rules_documented_in_security_md(self):
        """Docs drift guard: every registered rule id appears in
        docs/security.md's enforced-invariants section, and no documented
        CT/LEAK/LOCK/ASYNC/GRPC/JAX id is missing from the registry."""
        with open(os.path.join(REPO, "docs", "security.md")) as f:
            doc = f.read()
        for rule_id in all_rule_ids():
            assert rule_id in doc, f"{rule_id} missing from docs/security.md"

    def test_parse_error_is_a_finding_not_a_crash(self):
        report = analyze_source("def f(:\n")
        assert [f.rule for f in report.findings] == ["PARSE-001"]

    def test_rule_filter(self):
        src = (
            "import asyncio, time\n"
            "async def f():\n"
            "    time.sleep(1)\n"
            "    asyncio.create_task(g())\n"
        )
        report = analyze_source(src, path="cpzk_tpu_torch/server/fx.py")
        assert set(rules_of(report)) == {"ASYNC-001", "ASYNC-002"}
        from cpzk_tpu_torch.analysis.engine import _analyze

        only = _analyze([(src, "cpzk_tpu_torch/server/fx.py")], ["ASYNC-001"])
        assert rules_of(only) == ["ASYNC-001"]


# -- output formats (--format text|json|sarif) --------------------------------


class TestOutputFormats:
    BAD = "import asyncio\nasyncio.create_task(f())\n"

    def _run(self, *argv, cwd=REPO):
        return subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", *argv],
            capture_output=True, text=True, cwd=cwd,
        )

    def _bad_file(self, tmp_path):
        bad = tmp_path / "cpzk_tpu_torch" / "server" / "bad.py"
        bad.parent.mkdir(parents=True)
        bad.write_text(self.BAD)
        return bad

    def test_sarif_document_shape(self):
        doc = analyze_source(
            self.BAD, path="cpzk_tpu_torch/server/fx.py"
        ).to_sarif()
        assert doc["version"] == "2.1.0"
        run = doc["runs"][0]
        assert run["tool"]["driver"]["name"] == "cpzk-lint"
        rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
        assert set(all_rule_ids()) <= rule_ids
        results = run["results"]
        assert results, "expected the ASYNC-002 finding as a result"
        res = results[0]
        assert res["ruleId"] == "ASYNC-002"
        assert res["level"] == "error"
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"] == "cpzk_tpu_torch/server/fx.py"
        assert loc["region"]["startLine"] == 2
        assert loc["region"]["startColumn"] >= 1  # SARIF is 1-based

    def test_sarif_waived_findings_are_suppressed_results(self):
        src = (
            "import asyncio\n"
            "asyncio.create_task(f())  "
            "# cpzk-lint: disable=ASYNC-002 -- fixture: sarif suppression\n"
        )
        doc = analyze_source(src, path="cpzk_tpu_torch/server/fx.py").to_sarif()
        results = doc["runs"][0]["results"]
        assert len(results) == 1
        assert results[0]["suppressions"] == [{"kind": "inSource"}]

    def test_cli_format_sarif_parses_and_exit_codes_unchanged(
        self, tmp_path
    ):
        bad = self._bad_file(tmp_path)
        proc = self._run(str(bad), "--format", "sarif")
        assert proc.returncode == 1  # findings still gate, whatever format
        doc = json.loads(proc.stdout)
        assert doc["version"] == "2.1.0"
        clean = self._run(PKG, "--format", "sarif")
        assert clean.returncode == 0, clean.stdout + clean.stderr
        results = json.loads(clean.stdout)["runs"][0]["results"]
        # the tree's reasoned waivers ride along as suppressed results;
        # nothing may be live
        assert [r for r in results if not r.get("suppressions")] == []
        assert all(
            r["suppressions"] == [{"kind": "inSource"}] for r in results
        )

    def test_cli_json_flag_is_an_alias_for_format_json(self, tmp_path):
        bad = self._bad_file(tmp_path)
        via_alias = self._run(str(bad), "--json")
        via_format = self._run(str(bad), "--format", "json")
        assert via_alias.returncode == via_format.returncode == 1
        assert json.loads(via_alias.stdout) == json.loads(via_format.stdout)

    def test_cli_default_output_is_unchanged_human_text(self, tmp_path):
        bad = self._bad_file(tmp_path)
        proc = self._run(str(bad))
        assert proc.returncode == 1
        assert "ASYNC-002" in proc.stdout
        with pytest.raises(json.JSONDecodeError):
            json.loads(proc.stdout)


# -- redaction guard (secret-type reprs) --------------------------------------


class TestRedactionGuard:
    @pytest.fixture()
    def secret_scalar(self):
        from cpzk_tpu_torch.core.ristretto import Scalar

        return Scalar(0x1F2E3D4C5B6A79880102030405060708090A0B0C0D0E0F1011121314151617)

    def _assert_redacted(self, obj, scalar):
        from cpzk_tpu_torch.core.scalars import sc_to_bytes

        encodings = {
            f"{scalar.value:x}",
            f"{scalar.value:064x}",
            str(scalar.value),
            sc_to_bytes(scalar.value).hex(),
        }
        for text in (repr(obj), str(obj), f"{obj}"):
            low = text.lower()
            for enc in encodings:
                assert enc.lower() not in low, (
                    f"secret encoding leaked through {type(obj).__name__} repr"
                )
            assert "redacted" in low

    def test_witness_repr_redacts(self, secret_scalar):
        from cpzk_tpu_torch.protocol.gadgets import Witness

        self._assert_redacted(Witness(secret_scalar), secret_scalar)

    def test_nonce_repr_redacts(self, secret_scalar):
        from cpzk_tpu_torch.protocol.prover import Nonce

        self._assert_redacted(Nonce(secret_scalar), secret_scalar)

    def test_response_repr_redacts(self, secret_scalar):
        from cpzk_tpu_torch.protocol.gadgets import Response

        self._assert_redacted(Response(secret_scalar), secret_scalar)


# -- the port against the reference ------------------------------------------


#: Fixture sources of the cases above, each at every plane a rule keys on.
PARITY_SOURCES = {
    "sharded_state": FIXTURE_SHARDED,
    "state": FIXTURE_STATE,
    "ct002": TestCT002.TP,
    "frame": TestFRAME001.TP,
    "await_pre_fix": TestAWAIT001.PRE_FIX,
    "async_mix": (
        "import asyncio, time, threading, multiprocessing\n"
        "async def f(fut):\n"
        "    time.sleep(1)\n"
        "    open('x').read()\n"
        "    asyncio.create_task(g())\n"
        "def worker(fut):\n"
        "    fut.set_result(1)\n"
        "threading.Thread(target=worker).start()\n"
        "multiprocessing.Process(target=lambda: 0).start()\n"
    ),
}
PARITY_PATHS = (
    "cpzk_tpu_torch/server/state.py", "cpzk_tpu_torch/server/fx.py",
    "cpzk_tpu_torch/core/fx.py", "cpzk_tpu_torch/ops/fx.py",
    "cpzk_tpu_torch/durability/wal.py", "cpzk_tpu_torch/client/fx.py", "fx.py",
)


class TestParity:
    @pytest.mark.parametrize("name", sorted(PARITY_SOURCES))
    def test_fixture_sources_agree_at_every_plane(self, name):
        """Both analysers give the same lists on one fixture at each
        plane, over every rule and one rule at a time."""
        src = PARITY_SOURCES[name]
        fired = set()
        for path in PARITY_PATHS:
            fired.update(rules_of(analyze_source(src, path=path)))
            for rule_id in all_rule_ids():
                analyze_source(src, path=path, rules=[rule_id])
        assert fired, f"fixture {name} fired no rule at any plane"

    def test_port_tree_agrees_with_the_reference_on_a_renamed_copy(self, tmp_path,
                                                                   tree_report):
        """The reference's analyser keys its planes on a directory named
        ``cpzk_tpu``: over a copy of the port placed there it must report
        exactly what the port's analyser reports over the port."""
        import shutil

        copy = tmp_path / "cpzk_tpu"
        shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
            "_build", "__pycache__", "*.so", "*.lock"))
        reference = reference_analyze_paths([str(copy)])
        assert reference.files == tree_report.files

        def rows(report, root):
            return sorted((os.path.relpath(f.path, root), f.rule, f.line, f.col, f.message)
                          for f in report.findings + report.waived)

        assert rows(reference, copy) == rows(tree_report, PKG)
        assert not reference.findings and len(reference.waived) == len(tree_report.waived)


class TestPortSelfHost:
    def test_waived_findings_are_the_documented_ones(self, tree_report):
        """The port's waived findings: LOCK-001, ACK-001 and FENCE-001 in
        server/state.py, AWAIT-001 in server/service.py; none stale."""
        assert tree_report.findings == []
        where = {(f.rule, os.path.relpath(f.path, PKG)) for f in tree_report.waived}
        assert where == {
            ("LOCK-001", "server/state.py"), ("ACK-001", "server/state.py"),
            ("FENCE-001", "server/state.py"), ("AWAIT-001", "server/service.py"),
        }
        assert [w for w in tree_report.waivers if w.stale] == []

    def test_cli_default_path_is_the_port(self):
        """With no path the CLI lints ``cpzk_tpu_torch`` and exits 0."""
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", "--json"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["files"] > 50 and doc["summary"]["findings"] == 0
        assert all(f["path"].startswith("cpzk_tpu_torch") for f in doc["waived"])

    def test_cli_exit_two_on_unknown_rule(self):
        proc = subprocess.run(
            [sys.executable, "-m", "cpzk_tpu_torch.analysis", PKG, "--rules", "NOPE-001"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 2
