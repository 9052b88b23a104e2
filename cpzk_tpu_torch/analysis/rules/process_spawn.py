"""PROC-001: spawn-context Process targets and args must survive pickling.

The ingest fleet (``server/ingest.py``) spawns its listener shards with
the **spawn** multiprocessing context — the only start method that is
safe under an asyncio parent (fork duplicates the event loop, lock
states, and gRPC's internal threads mid-flight).  Spawn pickles the
target callable and every argument into the child.  That contract has
two failure shapes, both discovered at runtime in the child, not at the
call site:

- an **unpicklable target**: a lambda, a nested ``def`` (pickled by
  qualified name — unreachable from the child), or a bound method whose
  instance drags the whole parent object graph (the supervisor holds
  asyncio servers, sockets, and tasks) into the pickle;
- **spawn-unsafe arguments**: locks/conditions/semaphores, event loops,
  sockets, or open file objects — either unpicklable outright or, worse,
  picklable-but-meaningless in the child (a ``threading.Lock`` state).

This rule checks every ``Process(target=..., args=...)`` call site
lexically: the target must resolve to a module-level function, and no
argument may be ``self`` or a local that was bound from a known
spawn-unsafe constructor (``threading.Lock`` / ``RLock`` / ``Condition``
/ ``Semaphore`` / ``Event``, ``asyncio.get_event_loop`` /
``get_running_loop`` / ``new_event_loop``, ``socket.socket`` /
``create_connection``, ``open`` / ``os.open``) or such a constructor
called inline.  Primitives, strings, dicts of config values — the shape
``run_shard`` takes — pass untouched.
"""

from __future__ import annotations

import ast

from ..contexts import ContextInference, FuncInfo, call_name
from ..engine import Finding, Module, Rule, register

#: Constructor call names whose results must never cross a spawn boundary.
UNSAFE_CONSTRUCTORS = frozenset({
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore", "Event",
    "get_event_loop", "get_running_loop", "new_event_loop",
    "socket", "create_connection", "socketpair",
    "open",
})
_UNSAFE_KIND = {
    "Lock": "lock", "RLock": "lock", "Condition": "lock",
    "Semaphore": "lock", "BoundedSemaphore": "lock", "Event": "lock",
    "get_event_loop": "event loop", "get_running_loop": "event loop",
    "new_event_loop": "event loop",
    "socket": "socket", "create_connection": "socket",
    "socketpair": "socket",
    "open": "open file",
}


@register
class SpawnSafeProcess(Rule):
    id = "PROC-001"
    summary = (
        "multiprocessing Process targets are module-level functions with "
        "picklable, spawn-safe args"
    )
    rationale = (
        "spawn pickles the target and every arg into the child: lambdas/"
        "nested defs/bound methods fail (or drag the parent's asyncio "
        "graph along), and locks/sockets/loops/open fds are meaningless "
        "on the other side — the failure surfaces in the child at "
        "runtime, not at the call site"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        inference = module.inference
        if inference is None:  # direct-constructed Module (tests)
            inference = ContextInference(module.tree)
            inference.run()
        # node -> enclosing FuncInfo, for resolving nested-def targets
        scope_of: dict[ast.AST, FuncInfo | None] = {}

        def assign_scopes(node: ast.AST, scope: FuncInfo | None) -> None:
            for child in ast.iter_child_nodes(node):
                child_scope = scope
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    child_scope = inference.by_node.get(child, scope)
                scope_of[child] = child_scope
                assign_scopes(child, child_scope)

        assign_scopes(module.tree, None)

        # local name -> unsafe kind, per enclosing function (lexical scan
        # in source order is enough: spawn sites follow their bindings)
        unsafe_locals: dict[tuple[int, str], str] = {}
        for node, scope in scope_of.items():
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                name = call_name(node.value.func)
                if name in UNSAFE_CONSTRUCTORS:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            unsafe_locals[(id(scope), t.id)] = (
                                _UNSAFE_KIND[name]
                            )

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            if call_name(node.func) != "Process":
                continue
            self._check_spawn(module, node, inference, scope_of, unsafe_locals, out)
        return out

    def _check_spawn(
        self, module: Module, call: ast.Call, inference: ContextInference,
        scope_of: dict, unsafe_locals: dict, out: list[Finding],
    ) -> None:
        scope = scope_of.get(call)
        target = None
        arg_exprs: list[ast.expr] = []
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
            elif kw.arg in ("args", "kwargs"):
                arg_exprs.append(kw.value)

        if target is not None:
            self._check_target(module, call, target, inference, scope, out)
        for expr in arg_exprs:
            self._check_args(module, expr, scope, unsafe_locals, out)

    def _check_target(
        self, module: Module, call: ast.Call, target: ast.expr,
        inference: ContextInference, scope, out: list[Finding],
    ) -> None:
        if isinstance(target, ast.Lambda):
            out.append(self.finding(
                module, call,
                "Process target is a lambda — spawn pickles the target "
                "by qualified name and a lambda has none; hoist it to a "
                "module-level function",
            ))
            return
        if isinstance(target, ast.Attribute):
            # self.method / obj.method: the bound instance rides the pickle
            out.append(self.finding(
                module, call,
                f"Process target `{ast.unparse(target)}` is a bound "
                "method — spawn pickles the whole instance (locks, "
                "sockets, event loops included); use a module-level "
                "function taking plain-data args",
            ))
            return
        if isinstance(target, ast.Name):
            info = inference.resolve(target, scope)
            if info is not None and info.parent is not None:
                out.append(self.finding(
                    module, call,
                    f"Process target `{target.id}` is a nested def — "
                    "spawn pickles by qualified name, which the child "
                    "cannot import; hoist it to module level",
                ))

    def _check_args(
        self, module: Module, expr: ast.expr, scope,
        unsafe_locals: dict, out: list[Finding],
    ) -> None:
        # `self.host` is a plain attribute READ (the value pickles on its
        # own) — only a bare `self` element ships the instance.  Collect
        # the attribute-root Name nodes so they are skipped below.
        attr_roots = {
            id(sub.value)
            for sub in ast.walk(expr)
            if isinstance(sub, ast.Attribute) and isinstance(sub.value, ast.Name)
        }
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and id(sub) not in attr_roots:
                if sub.id == "self":
                    out.append(self.finding(
                        module, sub,
                        "Process args include `self` — spawn pickles the "
                        "whole instance and every unpicklable thing it "
                        "holds; pass the plain-data fields instead",
                    ))
                else:
                    kind = unsafe_locals.get((id(scope), sub.id))
                    if kind is not None:
                        out.append(self.finding(
                            module, sub,
                            f"Process args include `{sub.id}`, a {kind} — "
                            "spawn-unsafe across the process boundary; "
                            "pass plain data and rebuild it in the child",
                        ))
            elif isinstance(sub, ast.Call):
                name = call_name(sub.func)
                if name in UNSAFE_CONSTRUCTORS:
                    out.append(self.finding(
                        module, sub,
                        f"Process args construct a {_UNSAFE_KIND[name]} "
                        "inline — spawn-unsafe across the process "
                        "boundary; pass plain data and rebuild it in "
                        "the child",
                    ))
