"""ASYNC-001 / ASYNC-002: event-loop hygiene in the host serving planes.

ASYNC-001 — a blocking primitive (``time.sleep``, ``os.fsync``, sync
file I/O, ``subprocess``, ``input``) called directly inside an ``async
def`` stalls the whole event loop: every concurrent RPC, the batcher's
dispatch window, and the health service all freeze behind it.  Blocking
work belongs on a worker thread (``asyncio.to_thread`` /
``run_in_executor``); passing the callable there is fine — only direct
*calls* are flagged.  Nested sync ``def`` helpers are judged by the
execution-context inference (:mod:`cpzk_tpu_torch.analysis.contexts`): one
shipped to a thread (the standard pattern, e.g.
``ServerState.snapshot``'s ``write()``) is exempt, while one the async
body calls inline provably runs ON the loop and is scanned too — the
helper indirection no longer hides the stall.

ASYNC-002 — ``asyncio.create_task`` / ``ensure_future`` results that are
immediately discarded are garbage-collectable mid-flight (the event loop
keeps only a weak reference) and their exceptions are silently dropped.
Every spawned task must be retained: bound to a name/attribute, added to
a set, or awaited.
"""

from __future__ import annotations

import ast

from ..contexts import EVENT_LOOP, PROCESS, THREAD
from ..engine import Finding, Module, Rule, dotted_parts, register

#: Planes whose async defs feed the serving event loop.  ``observability``
#: joined when the ops plane's HTTP handler loop moved onto the serving
#: event loop: a blocking call in a /statusz render would
#: stall every RPC exactly like one in a handler would.
ASYNC_PLANES = frozenset(
    {"server", "client", "durability", "admission", "observability"}
)

#: Dotted-call prefixes that block the calling thread.
BLOCKING_PREFIXES: tuple[tuple[str, ...], ...] = (
    ("time", "sleep"),
    ("os", "fsync"),
    ("os", "fdatasync"),
    ("os", "system"),
    ("subprocess",),
    ("socket", "create_connection"),
)
#: Bare names that block (sync file I/O, terminal reads).
BLOCKING_NAMES = frozenset({"open", "input"})


def _blocking_reason(call: ast.Call) -> str | None:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in BLOCKING_NAMES:
            return f"{func.id}()"
        return None
    parts = dotted_parts(func)
    if not parts:
        return None
    for prefix in BLOCKING_PREFIXES:
        if tuple(parts[: len(prefix)]) == prefix:
            return ".".join(parts) + "()"
    return None


@register
class BlockingInAsync(Rule):
    id = "ASYNC-001"
    summary = "no blocking calls inside async def bodies in the serving planes"
    rationale = (
        "a sync sleep/fsync/open/subprocess inside an async handler "
        "freezes the event loop for every concurrent RPC; route it "
        "through asyncio.to_thread / run_in_executor"
    )

    def check(self, module: Module) -> list[Finding]:
        if module.plane not in ASYNC_PLANES:
            return []
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.AsyncFunctionDef):
                self._check_async_body(module, node, out)
        return out

    def _check_async_body(
        self, module: Module, func: ast.AsyncFunctionDef, out: list[Finding]
    ) -> None:
        def scan(node: ast.AST, where: str) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.AsyncFunctionDef, ast.Lambda)):
                    # nested async defs are visited by the outer ast.walk
                    # pass in check(); lambdas are callbacks, not calls
                    continue
                if isinstance(child, ast.FunctionDef):
                    # nested sync def: exempt when it runs on a worker
                    # thread (a to_thread / Thread target — the inference
                    # seeded it THREAD), scanned when the async body
                    # provably calls it inline on the loop
                    ctx = module.func_contexts(child)
                    if EVENT_LOOP in ctx and not ctx & {THREAD, PROCESS}:
                        scan(
                            child,
                            f"`{child.name}` (called inline from `async "
                            f"def {func.name}`)",
                        )
                    continue
                if isinstance(child, ast.Call):
                    reason = _blocking_reason(child)
                    if reason is not None:
                        out.append(self.finding(
                            module, child,
                            f"blocking {reason} inside {where} stalls the "
                            "event loop; wrap it in asyncio.to_thread(...)",
                        ))
                scan(child, where)

        scan(func, f"`async def {func.name}`")


@register
class OrphanedTask(Rule):
    id = "ASYNC-002"
    summary = "create_task/ensure_future results must be retained"
    rationale = (
        "the event loop holds only a weak reference to spawned tasks: a "
        "discarded handle can be garbage-collected mid-flight and its "
        "exception is silently dropped — keep the handle and await or "
        "cancel it"
    )

    SPAWNERS = frozenset({"create_task", "ensure_future"})

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Expr):
                continue
            value = node.value
            if isinstance(value, ast.Await):
                continue  # awaiting retains the task to completion
            if isinstance(value, ast.Call) and self._is_spawn(value):
                out.append(self.finding(
                    module, value,
                    "task handle discarded: bind the result of "
                    f"{_spawn_name(value)}() and await or cancel it "
                    "(or add it to a set with a done-callback discard)",
                ))
        # `_ = create_task(...)` is the same orphan in disguise
        for node in ast.walk(module.tree):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_"
                and isinstance(node.value, ast.Call)
                and self._is_spawn(node.value)
            ):
                out.append(self.finding(
                    module, node.value,
                    "task handle bound to `_` is still discarded: keep a "
                    "real reference and await or cancel it",
                ))
        return out

    def _is_spawn(self, call: ast.Call) -> bool:
        return _spawn_name(call) in self.SPAWNERS


def _spawn_name(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""
