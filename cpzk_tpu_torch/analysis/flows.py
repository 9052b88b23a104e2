"""Await-point dataflow for the async-atomicity rules (cpzk-lint v3).

The v2 execution-context inference (``contexts.py``) answers *where* a
function runs (event loop, worker thread, spawned process).  This pass
answers *when* its effects happen relative to the event loop's
suspension points: for every function it records an ordered stream of
the events the atomicity rules care about —

- ``guard``   — an ownership/admission read whose verdict licenses later
  work: ``owns()`` / ``_check_owner`` / ``_wrong_partition*`` /
  admission ``_admit``-style verdicts, an epoch comparison, or a
  write-time fence call (``self._fence`` / ``owner_fence`` or a local
  alias bound from ``.owner_fence`` — those additionally carry
  ``is_fence``);
- ``await``   — a suspension point: any ``await`` expression, including
  ``async with`` / ``async for`` protocol entries.  Every other handler
  on the loop can run here, and in particular a live split's
  export→copy→map-flip can land here (the live-split bug window);
- ``mutate``  — a user-keyed state mutation: one of ``ServerState``'s
  six insert/remove funnels (``is_funnel``) or a public mutator
  (``register_user`` / ``create_challenge`` / ``create_session[s]`` /
  ``revoke_session``);
- ``journal`` — a durability event: ``_journal_append`` /
  ``_journal_sync`` or an ``append*``/``sync`` call on a
  journal/WAL-named receiver;
- ``ack``     — a path out of the function that a caller observes as
  success: an explicit ``return``, a ``Future.set_result``, or the
  synthesized fall-off-the-end event (``name == "end"``).

Each event also carries the region facts the rules need: ``lock`` (the
id of the innermost enclosing ``with``/``async with`` acquiring a
``*lock`` attribute — two events share a lock section iff their ``lock``
values match), and ``wp`` (lexically inside a ``try`` whose handlers
catch ``WrongPartition`` — call-site evidence that the mutation's
write-time fence outcome is handled).

The walk is a linearization: statements and expressions are visited in
source order and branch structure is flattened, the same approximation
every other cpzk-lint rule makes.  An ``await`` wrapping a call is
ordered against that call's own event by when its verdict/effect
happens: ``await guard()`` emits ``await`` then ``guard`` (the verdict
is only fresh as of resumption), while ``await mutator()`` emits
``mutate`` then ``await`` (the callee is entered at the call; the
suspension matters only to *later* statements).

The horizon is the module boundary, like the context inference: nested
``def``s get their own flow and are not inlined.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

#: Ownership/admission guard reads (verdict licenses later work).
GUARD_CALLS = frozenset({
    "owns", "_check_owner", "_wrong_partition", "_wrong_partition_counted",
    "_admit", "admit", "check_admission",
})

#: Write-time fence reads — guards that additionally satisfy FENCE-001's
#: in-lock re-check and AWAIT-001's post-await re-check.
FENCE_CALLS = frozenset({"_fence", "owner_fence"})

#: ServerState's six mutation funnels (the FUNNEL-001 surface).
FUNNEL_CALLS = frozenset({
    "_user_insert", "_user_remove",
    "_session_insert", "_session_remove",
    "_challenge_insert", "_challenge_remove",
})

#: Public user-keyed mutators (ack-bearing; fence re-checked inside, so a
#: cross-module caller must handle ``WrongPartition`` at the call site).
MUTATOR_CALLS = frozenset({
    "register_user", "create_challenge", "create_session",
    "create_sessions", "revoke_session",
})

#: Durability events: the journal funnel and its sync barrier.
JOURNAL_CALLS = frozenset({"_journal_append", "_journal_sync"})

#: Receiver-name fragments that mark an ``append*``/``sync`` call as a
#: WAL/journal write (``self.journal.append``, ``wal.append_frames``).
JOURNAL_RECEIVERS = ("journal", "wal")


@dataclass
class FlowEvent:
    """One ordered event in a function's await-point dataflow."""

    kind: str               # guard | await | mutate | journal | ack
    name: str               # call/attr name, "return", "end", "epoch-compare"
    node: ast.AST
    order: int
    lock: int | None = None  # id of the innermost enclosing lock-with
    wp: bool = False         # inside a try that catches WrongPartition
    is_fence: bool = False   # guard that is a write-time fence re-check
    is_funnel: bool = False  # mutate through one of the six funnels


@dataclass
class FuncFlow:
    """The ordered event stream of one function definition."""

    node: ast.AST
    name: str
    qualname: str
    cls: str | None          # enclosing class name, if any
    is_async: bool
    events: list[FlowEvent] = field(default_factory=list)

    def of_kind(self, kind: str) -> list[FlowEvent]:
        return [e for e in self.events if e.kind == kind]

    @property
    def has_fence(self) -> bool:
        return any(e.is_fence for e in self.events)


def _call_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _receiver_name(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Attribute):
        v = f.value
        if isinstance(v, ast.Name):
            return v.id
        if isinstance(v, ast.Attribute):
            return v.attr
    return None


def _is_lock_acquire(expr: ast.expr) -> bool:
    """``with``/``async with`` item that takes a lock: any attribute (or
    bare name) that is ``lock`` or ends in ``_lock``, optionally called
    (``lock.acquire()`` style context managers are out of scope)."""
    if isinstance(expr, ast.Attribute):
        return expr.attr == "lock" or expr.attr.endswith("_lock")
    if isinstance(expr, ast.Name):
        return expr.id == "lock" or expr.id.endswith("_lock")
    return False


def _catches_wrong_partition(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return False
    for node in ast.walk(t):
        if isinstance(node, ast.Name) and node.id == "WrongPartition":
            return True
        if isinstance(node, ast.Attribute) and node.attr == "WrongPartition":
            return True
    return False


def _epoch_compare(node: ast.Compare) -> bool:
    """A comparison reading an epoch — the lease-fencing guard shape."""
    for side in [node.left, *node.comparators]:
        if isinstance(side, ast.Attribute) and (
            side.attr == "epoch" or side.attr.endswith("_epoch")
        ):
            return True
        if isinstance(side, ast.Name) and (
            side.id == "epoch" or side.id.endswith("_epoch")
        ):
            return True
    return False


class _FuncWalker:
    """Builds one function's event stream (linearized, region-tracked)."""

    def __init__(self, flow: FuncFlow):
        self.flow = flow
        self._order = 0
        self._lock: list[int] = []       # stack of with-node ids
        self._wp_depth = 0
        self._fence_aliases: set[str] = set()

    # -- emission ----------------------------------------------------------

    def _emit(self, kind: str, name: str, node: ast.AST, **flags) -> None:
        self._order += 1
        self.flow.events.append(FlowEvent(
            kind=kind, name=name, node=node, order=self._order,
            lock=self._lock[-1] if self._lock else None,
            wp=self._wp_depth > 0,
            **flags,
        ))

    def _classify_call(self, call: ast.Call) -> None:
        name = _call_name(call)
        if name is None:
            return
        if name in FENCE_CALLS or name in self._fence_aliases:
            self._emit("guard", name, call, is_fence=True)
        elif name in GUARD_CALLS:
            self._emit("guard", name, call)
        elif name in FUNNEL_CALLS:
            self._emit("mutate", name, call, is_funnel=True)
        elif name in MUTATOR_CALLS:
            self._emit("mutate", name, call)
        elif name in JOURNAL_CALLS:
            self._emit("journal", name, call)
        elif name in ("append", "append_frames", "sync") and any(
            frag in (_receiver_name(call) or "").lower()
            for frag in JOURNAL_RECEIVERS
        ):
            self._emit("journal", name, call)
        elif name in ("set_result", "set_exception"):
            self._emit("ack", name, call)

    # -- expressions -------------------------------------------------------

    def expr(self, node: ast.expr | None) -> None:
        if node is None:
            return
        if isinstance(node, ast.Await):
            value = node.value
            if isinstance(value, ast.Call):
                name = _call_name(value)
                for arg in value.args:
                    self.expr(arg)
                for kw in value.keywords:
                    self.expr(kw.value)
                if name in FUNNEL_CALLS or name in MUTATOR_CALLS:
                    # the callee is entered at the call; the suspension
                    # only matters to later statements
                    self._classify_call(value)
                    self._emit("await", name or "await", node)
                else:
                    # a verdict is only fresh as of resumption
                    self._emit("await", name or "await", node)
                    self._classify_call(value)
                return
            self.expr(value)
            self._emit("await", "await", node)
            return
        if isinstance(node, ast.Call):
            self.expr(node.func if not isinstance(
                node.func, (ast.Name, ast.Attribute)) else None)
            for arg in node.args:
                self.expr(arg)
            for kw in node.keywords:
                self.expr(kw.value)
            self._classify_call(node)
            return
        if isinstance(node, ast.Compare):
            self.expr(node.left)
            for c in node.comparators:
                self.expr(c)
            if _epoch_compare(node):
                self._emit("guard", "epoch-compare", node)
            return
        if isinstance(node, (ast.Lambda,)):
            return  # separate execution, not part of this flow
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self.expr(child)

    # -- statements --------------------------------------------------------

    def _note_fence_alias(self, stmt: ast.stmt) -> None:
        """``fence = self.owner_fence`` binds a local fence alias whose
        later call is a fence event (the create_sessions shape)."""
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            return
        t, v = stmt.targets[0], stmt.value
        if (
            isinstance(t, ast.Name)
            and isinstance(v, ast.Attribute)
            and v.attr == "owner_fence"
        ):
            self._fence_aliases.add(t.id)

    def stmts(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self.stmt(stmt)

    def stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs get their own flow
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            took_lock = False
            for item in stmt.items:
                self.expr(item.context_expr)
                if _is_lock_acquire(item.context_expr):
                    took_lock = True
            if isinstance(stmt, ast.AsyncWith):
                self._emit("await", "async-with", stmt)
            if took_lock:
                self._lock.append(id(stmt))
            self.stmts(stmt.body)
            if took_lock:
                self._lock.pop()
            return
        if isinstance(stmt, ast.Try):
            wp = any(_catches_wrong_partition(h) for h in stmt.handlers)
            if wp:
                self._wp_depth += 1
            self.stmts(stmt.body)
            self.stmts(stmt.orelse)
            if wp:
                self._wp_depth -= 1
            for h in stmt.handlers:
                self.stmts(h.body)
            self.stmts(stmt.finalbody)
            return
        if isinstance(stmt, ast.Return):
            self.expr(stmt.value)
            self._emit("ack", "return", stmt)
            return
        if isinstance(stmt, (ast.AsyncFor,)):
            self.expr(stmt.iter)
            self._emit("await", "async-for", stmt)
            self.stmts(stmt.body)
            self.stmts(stmt.orelse)
            return
        self._note_fence_alias(stmt)
        # expressions attached directly to this statement, in eval order
        for fname in ("test", "iter", "value", "exc"):
            sub = getattr(stmt, fname, None)
            if isinstance(sub, ast.expr):
                self.expr(sub)
        # compound bodies, linearized
        for fname in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, fname, None)
            if isinstance(sub, list):
                self.stmts(sub)


class FlowPass:
    """Builds :class:`FuncFlow` for every function definition in a tree."""

    def __init__(self, tree: ast.Module):
        self.tree = tree

    def run(self) -> dict[ast.AST, FuncFlow]:
        out: dict[ast.AST, FuncFlow] = {}
        self._walk(self.tree.body, cls=None, prefix="", out=out)
        return out

    def _walk(
        self, body: list[ast.stmt], cls: str | None, prefix: str,
        out: dict[ast.AST, FuncFlow],
    ) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                self._walk(
                    stmt.body, cls=stmt.name,
                    prefix=f"{prefix}{stmt.name}.", out=out,
                )
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                flow = FuncFlow(
                    node=stmt, name=stmt.name,
                    qualname=f"{prefix}{stmt.name}", cls=cls,
                    is_async=isinstance(stmt, ast.AsyncFunctionDef),
                )
                walker = _FuncWalker(flow)
                walker.stmts(stmt.body)
                if not isinstance(stmt.body[-1], (ast.Return, ast.Raise)):
                    walker._emit("ack", "end", stmt)
                out[stmt] = flow
                # nested defs (helpers, wrappers) get their own flows
                self._walk(
                    stmt.body, cls=cls,
                    prefix=f"{prefix}{stmt.name}.", out=out,
                )
        return
