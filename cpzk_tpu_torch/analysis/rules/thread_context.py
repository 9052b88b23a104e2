"""THREAD-001: asyncio objects are settled/scheduled only on their loop.

Every asyncio primitive is single-threaded by contract: ``Future.set_result``
/ ``set_exception``, ``loop.call_soon`` / ``call_later`` / ``call_at``,
``create_task`` / ``ensure_future``, and ``Queue.put_nowait`` all assume
they run on the owning event loop's thread.  Called from a lane thread
(``server/dispatch.py``'s prep/device pair), a WAL/snapshot worker, or a
spawned ingest process, they race the loop's internals — the failure is
a silent lost wakeup or a cross-thread callback list corruption, not an
exception.  The one sanctioned bridge is
``loop.call_soon_threadsafe(...)`` (and ``run_coroutine_threadsafe``),
which is exactly how the dispatch lane posts results back.

This rule reads the execution-context inference
(:mod:`cpzk_tpu_torch.analysis.contexts`): any function reachable from a
thread or process spawn site is scanned for the unsafe calls above.
Three carve-outs keep the sanctioned patterns clean:

- the bridge calls themselves (``call_soon_threadsafe``,
  ``run_coroutine_threadsafe``, ``asyncio.run``) are never findings;
- a callable registered THROUGH ``call_soon_threadsafe`` runs on the
  loop, so the context pass seeds it event-loop and it is not scanned;
- a loop the thread itself created (a local bound from
  ``asyncio.new_event_loop()``) is owned by that thread — driving it
  with ``call_soon`` / ``run_until_complete`` before ``run_forever`` is
  the standard ``start_in_thread`` bootstrap (``LaneRouter``,
  ``OpsPlane``) and is exempt.
"""

from __future__ import annotations

import ast

from ..contexts import PROCESS, THREAD, call_name
from ..engine import Finding, Module, Rule, register

#: Calls that mutate asyncio state and are only legal on the owning loop.
UNSAFE_ASYNCIO_CALLS = frozenset({
    "set_result", "set_exception",
    "call_soon", "call_later", "call_at",
    "create_task", "ensure_future",
    "put_nowait",
})
#: The sanctioned thread->loop bridges (never findings, and the context
#: pass seeds their callbacks as event-loop context).
SAFE_BRIDGES = frozenset({
    "call_soon_threadsafe", "run_coroutine_threadsafe", "run",
})
#: Constructors whose result is a loop OWNED by the creating thread.
_LOOP_FACTORIES = frozenset({"new_event_loop"})


def _receiver_root(func: ast.expr) -> str | None:
    """Root name of the call receiver (``loop.call_soon`` -> ``loop``)."""
    node = func
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


@register
class AsyncioFromThread(Rule):
    id = "THREAD-001"
    summary = (
        "asyncio futures/loops/queues are only touched from worker-thread "
        "context via loop.call_soon_threadsafe"
    )
    rationale = (
        "asyncio objects are not thread-safe: settling a Future or "
        "scheduling a callback from a lane/worker thread races the "
        "event loop's internals and loses wakeups silently; post results "
        "through loop.call_soon_threadsafe (the dispatch lane's contract)"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for node, info in module.contexts.items():
            if info.is_async:
                continue
            hot = info.contexts & {THREAD, PROCESS}
            if not hot:
                continue
            self._scan(module, node, sorted(hot), out)
        return out

    def _scan(self, module: Module, func, hot: list[str],
              out: list[Finding]) -> None:
        owned_loops: set[str] = set()

        def visit(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
                ):
                    continue  # nested defs carry their own contexts
                if isinstance(child, ast.Assign) and isinstance(
                    child.value, ast.Call
                ):
                    # loop = asyncio.new_event_loop(): thread-owned loop
                    if call_name(child.value.func) in _LOOP_FACTORIES:
                        for t in child.targets:
                            if isinstance(t, ast.Name):
                                owned_loops.add(t.id)
                if isinstance(child, ast.Call):
                    name = call_name(child.func)
                    if (
                        name in UNSAFE_ASYNCIO_CALLS
                        and name not in SAFE_BRIDGES
                        and _receiver_root(child.func) not in owned_loops
                    ):
                        out.append(self.finding(
                            module, child,
                            f"{func.name} runs in {'/'.join(hot)} context "
                            f"and calls .{name}() on an asyncio object; "
                            "post through loop.call_soon_threadsafe(...) "
                            "(or run_coroutine_threadsafe) instead",
                        ))
                visit(child)

        visit(func)
