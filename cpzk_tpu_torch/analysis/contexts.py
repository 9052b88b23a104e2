"""Execution-context inference: which context(s) can run each function.

The serving plane spans four execution contexts — the asyncio event
loop, the persistent prep/device lane threads (``server/dispatch.py``),
spawn-context ingest processes (``server/ingest.py``), and the
WAL/snapshot worker threads — and the correctness contracts differ per
context: an asyncio ``Future`` may only be settled on its event loop, a
``multiprocessing`` spawn target must be picklable, a blocking call is
fine on a worker thread but fatal on the loop.  This pass gives the rule
pack that vocabulary.  It builds an **intra-module call graph** and
classifies every function by the contexts that can reach it:

- :data:`EVENT_LOOP` — runs on an asyncio event loop.  Seeded by every
  ``async def``, and by callables handed to the loop-callback APIs
  (``call_soon_threadsafe``, ``call_soon``, ``call_later``, ``call_at``)
  — ``call_soon_threadsafe`` is exactly the sanctioned bridge THREAD-001
  exists to enforce, so its callback is event-loop context by
  construction.
- :data:`THREAD` — runs on a worker thread.  Seeded by
  ``threading.Thread(target=...)``, ``asyncio.to_thread(...)``, and
  ``run_in_executor(...)`` targets.
- :data:`PROCESS` — runs in a spawned child process.  Seeded by
  ``multiprocessing`` / spawn-context ``Process(target=...)`` targets.

Contexts then propagate caller -> callee over resolved calls, with two
deliberate exceptions: THREAD/PROCESS never flow **into** an ``async
def`` (calling one from a thread only builds a coroutine object — the
thread would still need ``run_coroutine_threadsafe`` to run it, which is
its own sanctioned bridge), and nothing flows through the spawn/bridge
calls themselves (their callable argument is seeded, not called).

Call resolution is deliberately conservative — the same trade the taint
pass makes (``engine.py`` docstring).  An edge exists only for:

- ``f(...)`` where ``f`` is a nested ``def`` in the lexical scope chain
  or a module-level ``def``;
- ``self.m(...)`` / ``cls.m(...)`` for a method of the enclosing class;
- ``ClassName.m(...)`` for a class defined in the same module.

A generic ``obj.attr(...)`` never resolves: following every ``.append``
or ``.get`` by bare name would smear thread context across unrelated
classes and turn the context-sensitive rules into noise.  The graph is
per-module (the engine analyzes one file at a time); every contract the
context rules enforce today — lane-thread result posting, spawn-target
hygiene — lives inside one module by design, and docs/security.md
documents the module boundary as the inference horizon.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

#: Context tags (values appear in findings and tests).
EVENT_LOOP = "event-loop"
THREAD = "thread"
PROCESS = "process"

#: Spawn APIs whose callable argument runs on a worker thread:
#: name -> index of the callable positional argument (``target=`` kwarg
#: always wins for Thread/Process).
_THREAD_SPAWNERS = {"to_thread": 0, "run_in_executor": 1, "Thread": None}
_PROCESS_SPAWNERS = {"Process": None}
#: Loop-callback APIs: the callable argument runs on the event loop.
_LOOP_CALLBACK_ARG = {
    "call_soon_threadsafe": 0,
    "call_soon": 0,
    "call_later": 1,
    "call_at": 1,
}


def call_name(func: ast.expr) -> str:
    """Last dotted segment of a call target (``a.b.c`` -> ``c``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


@dataclass
class FuncInfo:
    """One function (or method) definition and its inferred contexts."""

    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str
    is_async: bool
    parent: "FuncInfo | None" = None      # lexically enclosing function
    cls: str | None = None                # enclosing class name, if a method
    children: dict[str, "FuncInfo"] = field(default_factory=dict)
    contexts: set[str] = field(default_factory=set)
    calls: list["FuncInfo"] = field(default_factory=list)


class ContextInference:
    """Collect functions, seed contexts at spawn sites, propagate."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.functions: list[FuncInfo] = []
        self.by_node: dict[ast.AST, FuncInfo] = {}
        self.module_funcs: dict[str, FuncInfo] = {}
        #: class name -> {method name -> FuncInfo}
        self.methods: dict[str, dict[str, FuncInfo]] = {}

    # -- collection ----------------------------------------------------------

    def _collect(
        self, body: list[ast.stmt], parent: FuncInfo | None,
        cls: str | None, prefix: str,
    ) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{stmt.name}" if prefix else stmt.name
                info = FuncInfo(
                    node=stmt, qualname=qual,
                    is_async=isinstance(stmt, ast.AsyncFunctionDef),
                    parent=parent, cls=cls,
                )
                if info.is_async:
                    info.contexts.add(EVENT_LOOP)
                self.functions.append(info)
                self.by_node[stmt] = info
                if parent is not None:
                    parent.children[stmt.name] = info
                elif cls is not None:
                    self.methods.setdefault(cls, {})[stmt.name] = info
                else:
                    self.module_funcs[stmt.name] = info
                self._collect(stmt.body, info, cls, qual + ".")
            elif isinstance(stmt, ast.ClassDef):
                self._collect(
                    stmt.body, None, stmt.name, f"{prefix}{stmt.name}.",
                )
            else:
                # defs nested in plain compound statements (if/try/with)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        self._collect(sub, parent, cls, prefix)
                for handler in getattr(stmt, "handlers", []) or []:
                    self._collect(handler.body, parent, cls, prefix)

    # -- resolution ----------------------------------------------------------

    def resolve(
        self, expr: ast.expr, scope: FuncInfo | None
    ) -> FuncInfo | None:
        """The function ``expr`` names, or None.  Conservative on purpose
        — see the module docstring for the resolution table."""
        if isinstance(expr, ast.Name):
            # lexical chain: nested defs of the enclosing functions first
            walk = scope
            while walk is not None:
                if expr.id in walk.children:
                    return walk.children[expr.id]
                walk = walk.parent
            return self.module_funcs.get(expr.id)
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            root = expr.value.id
            if root in ("self", "cls") and scope is not None and scope.cls:
                return self.methods.get(scope.cls, {}).get(expr.attr)
            if root in self.methods:  # ClassName.method
                return self.methods[root].get(expr.attr)
        return None

    # -- seeding -------------------------------------------------------------

    def _spawn_target(self, call: ast.Call, pos: int | None) -> ast.expr | None:
        """The callable argument of a spawn/bridge call: the ``target=``
        keyword for Thread/Process (positional never carries it there),
        else the given positional index."""
        if pos is None:
            for kw in call.keywords:
                if kw.arg == "target":
                    return kw.value
            return None
        if len(call.args) > pos:
            return call.args[pos]
        return None

    def _seed(self) -> None:
        # every Call in the module once, attributed to its enclosing
        # function through a node -> scope map built in one walk
        scope_of: dict[ast.AST, FuncInfo | None] = {}

        def assign_scopes(node: ast.AST, scope: FuncInfo | None) -> None:
            for child in ast.iter_child_nodes(node):
                child_scope = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    child_scope = self.by_node.get(child, scope)
                scope_of[child] = child_scope
                assign_scopes(child, child_scope)

        assign_scopes(self.tree, None)
        for node, scope in scope_of.items():
            if isinstance(node, ast.Call):
                self._seed_call(node, scope)
                self._edge_call(node, scope)

    def _seed_call(self, call: ast.Call, scope: FuncInfo | None) -> None:
        name = call_name(call.func)
        if name in _THREAD_SPAWNERS:
            target = self._spawn_target(call, _THREAD_SPAWNERS[name])
            info = self.resolve(target, scope) if target is not None else None
            if info is not None:
                info.contexts.add(THREAD)
        if name in _PROCESS_SPAWNERS:
            target = self._spawn_target(call, _PROCESS_SPAWNERS[name])
            info = self.resolve(target, scope) if target is not None else None
            if info is not None:
                info.contexts.add(PROCESS)
        if name in _LOOP_CALLBACK_ARG:
            pos = _LOOP_CALLBACK_ARG[name]
            if len(call.args) > pos:
                info = self.resolve(call.args[pos], scope)
                if info is not None:
                    info.contexts.add(EVENT_LOOP)

    def _edge_call(self, call: ast.Call, scope: FuncInfo | None) -> None:
        if scope is None:
            return
        callee = self.resolve(call.func, scope)
        if callee is not None and callee is not scope:
            scope.calls.append(callee)

    # -- propagation ---------------------------------------------------------

    def _propagate(self) -> None:
        """Fixed point: caller contexts flow to sync callees.  THREAD and
        PROCESS never enter an ``async def`` (see module docstring)."""
        changed = True
        while changed:
            changed = False
            for f in self.functions:
                for callee in f.calls:
                    flow = set(f.contexts)
                    if callee.is_async:
                        flow -= {THREAD, PROCESS}
                    if not flow <= callee.contexts:
                        callee.contexts |= flow
                        changed = True

    def run(self) -> dict[ast.AST, "FuncInfo"]:
        try:
            self._collect(self.tree.body, None, None, "")
            self._seed()
            self._propagate()
        except RecursionError:  # pathological nesting: degrade, don't crash
            pass
        return self.by_node
