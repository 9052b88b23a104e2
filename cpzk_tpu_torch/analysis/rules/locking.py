"""LOCK-001: ServerState registry mutations stay inside the owning lock.

``ServerState`` splits its five registries into independently-locked
shards keyed by user hash (see its module docstring — the reference's
five RwLocks deadlock under inconsistent ordering; the pre-shard design's
single global lock serialized distinct users).  That design only holds if
every mutation site takes the OWNING shard's lock; Rust's ``MutexGuard``
proves it in types, here it is one forgotten ``async with shard.lock``
away from a lost update.  This rule walks every method of any class named
``ServerState`` (real or fixture) and flags mutations of the protected
maps — reached through ``self`` (the legacy single-lock shape) or through
a *shard alias* (a local bound from ``self._shards[...]``,
``self._shard_for_user(...)``, or ``for shard in self._shards``) — and
WAL appends, whose ordering contract is "append under the mutating
shard's lock", that are not lexically inside a ``with`` holding the right
lock:

- ``self._users[...] = ...``        needs ``with self._lock``;
- ``shard._users[...] = ...``       needs ``with shard.lock`` for that
  SAME alias — holding shard A's lock does not license mutating shard B;
- ``self._journal_append(...)``     needs any held state/shard lock (the
  append itself has no owning shard; the contract is that it happens
  inside the mutation's critical section).

``__init__`` is exempt (the instance is not yet shared).  The documented
single-threaded boot paths (``replay_journal_record``, ``restore``) and
the append funnel carry inline waivers with their reasons rather than an
engine special case.
"""

from __future__ import annotations

import ast

from ..engine import Finding, Module, Rule, register

#: The five registries the shard locks guard, plus the journal hook.
PROTECTED_ATTRS = frozenset({
    "_users", "_sessions", "_challenges", "_user_challenges",
    "_user_sessions",
})
#: Container methods that mutate in place.
MUTATORS = frozenset({
    "pop", "popitem", "setdefault", "clear", "update", "append", "remove",
    "extend", "insert", "add", "discard",
})
#: The maps whose .get()/.setdefault() hand back a *mutable member list*
#: — an alias to protected state, unlike the dataclass values in _users.
CONTAINER_MAPS = frozenset({"_user_challenges", "_user_sessions"})
#: Journal-append calls (WAL order must equal application order, which
#: only holds when the append happens under the mutating shard's lock).
JOURNAL_CALLS = frozenset({"_journal_append"})
#: self-attribute accesses that yield a shard: ``self._shards[i]`` and
#: calls of ``self._shard_for_user(...)`` / any ``self._shard*`` helper.
SHARDS_ATTR = "_shards"


def _is_self_attr(node: ast.expr, attrs: frozenset[str]) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and node.attr in attrs
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


def _shard_expr_source(node: ast.expr) -> bool:
    """Whether ``node`` evaluates to a shard: ``self._shards[...]`` or a
    ``self._shard*(...)`` helper call."""
    if (
        isinstance(node, ast.Subscript)
        and _is_self_attr(node.value, frozenset({SHARDS_ATTR}))
    ):
        return True
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr.startswith("_shard")
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == "self"
    ):
        return True
    return False


@register
class StateLockDiscipline(Rule):
    id = "LOCK-001"
    summary = (
        "ServerState map mutations and WAL appends only under the owning "
        "state/shard lock"
    )
    rationale = (
        "per-shard asyncio locks guard the five registries by design; a "
        "mutation outside the owning shard's lock (or under another "
        "shard's) reorders against concurrent handlers and desyncs the "
        "WAL from in-memory application order"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and node.name == "ServerState":
                for item in node.body:
                    if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        if item.name == "__init__":
                            continue
                        self._check_method(module, item, out)
        return out

    def _check_method(
        self, module: Module,
        func: ast.FunctionDef | ast.AsyncFunctionDef,
        out: list[Finding],
    ) -> None:
        aliases: set[str] = set()        # locals aliasing a protected container
        shard_aliases: set[str] = set()  # locals bound to a StateShard
        # alias name -> owning lock name ("self" or a shard alias): member
        # lists pulled out of a shard's container map are owned by that
        # shard's lock
        alias_owner: dict[str, str] = {}

        def owner_of(expr: ast.expr) -> str | None:
            """The lock owner guarding ``expr`` when it is protected state:
            "self", a shard alias name, or None (not protected)."""
            if _is_self_attr(expr, PROTECTED_ATTRS):
                return "self"
            if (
                isinstance(expr, ast.Attribute)
                and expr.attr in PROTECTED_ATTRS
                and isinstance(expr.value, ast.Name)
                and expr.value.id in shard_aliases
            ):
                return expr.value.id
            if isinstance(expr, ast.Name) and expr.id in aliases:
                return alias_owner.get(expr.id, "self")
            return None

        def note_alias(stmt: ast.stmt) -> None:
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                # for shard in self._shards: ...
                if (
                    isinstance(stmt.target, ast.Name)
                    and _is_self_attr(stmt.iter, frozenset({SHARDS_ATTR}))
                ):
                    shard_aliases.add(stmt.target.id)
                return
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                return
            target = stmt.targets[0]
            if not isinstance(target, ast.Name):
                return
            value = stmt.value
            # shard = self._shards[i] / self._shard_for_user(uid)
            if _shard_expr_source(value):
                shard_aliases.add(target.id)
                return
            # per_user = self._user_sessions  (whole-map alias, legacy)
            if _is_self_attr(value, PROTECTED_ATTRS):
                aliases.add(target.id)
                alias_owner[target.id] = "self"
            # per_user = <owner>._user_sessions.setdefault/get(...)  (member
            # list — owned by whichever lock guards the container map)
            elif (
                isinstance(value, ast.Call)
                and isinstance(value.func, ast.Attribute)
                and value.func.attr in ("get", "setdefault")
                and isinstance(value.func.value, ast.Attribute)
                and value.func.value.attr in CONTAINER_MAPS
                and isinstance(value.func.value.value, ast.Name)
                and (
                    value.func.value.value.id == "self"
                    or value.func.value.value.id in shard_aliases
                )
            ):
                aliases.add(target.id)
                alias_owner[target.id] = (
                    "self"
                    if value.func.value.value.id == "self"
                    else value.func.value.value.id
                )

        def mutation_of(stmt_or_expr: ast.AST) -> tuple[str, str] | None:
            """(description, required lock owner) when the node mutates
            protected state, else None.  Owner "*" means any held state
            lock satisfies the contract (journal appends)."""
            node = stmt_or_expr
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign) else [node.target]
                )
                for t in targets:
                    if _is_self_attr(t, PROTECTED_ATTRS):
                        return f"rebinds self.{t.attr}", "self"
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr in PROTECTED_ATTRS
                        and isinstance(t.value, ast.Name)
                        and t.value.id in shard_aliases
                    ):
                        return f"rebinds {t.value.id}.{t.attr}", t.value.id
                    if isinstance(t, ast.Subscript):
                        owner = owner_of(t.value)
                        if owner is not None:
                            return "subscript-assigns into a protected map", owner
            if isinstance(node, ast.Delete):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        owner = owner_of(t.value)
                        if owner is not None:
                            return "deletes from a protected map", owner
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute):
                    if f.attr in MUTATORS:
                        owner = owner_of(f.value)
                        if owner is not None:
                            return (
                                f"calls .{f.attr}() on a protected container",
                                owner,
                            )
                    if (
                        f.attr in JOURNAL_CALLS
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                    ):
                        return "appends to the journal", "*"
                    if (
                        f.attr == "append"
                        and _is_self_attr(f.value, frozenset({"journal"}))
                    ):
                        return "appends to the journal", "*"
            return None

        def own_exprs(stmt: ast.stmt) -> list[ast.expr]:
            """Expression trees attached directly to this statement —
            expressions cannot contain statements, so scanning them never
            leaks into a nested (possibly locked) block."""
            if isinstance(stmt, ast.Expr):
                return [stmt.value]
            if isinstance(stmt, (ast.Assign, ast.AugAssign)):
                return [stmt.value]
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                return [stmt.value]
            if isinstance(stmt, (ast.If, ast.While)):
                return [stmt.test]
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                return [stmt.iter]
            if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                return [stmt.exc]
            return []

        def locks_of(stmt: ast.With | ast.AsyncWith) -> set[str]:
            """Lock owners this with-statement acquires: "self" for
            ``self.*_lock``, the alias name for ``<shard>.lock``."""
            owners: set[str] = set()
            for item in stmt.items:
                e = item.context_expr
                if (
                    isinstance(e, ast.Attribute)
                    and isinstance(e.value, ast.Name)
                ):
                    if e.value.id == "self" and e.attr.endswith("_lock"):
                        owners.add("self")
                    elif (
                        e.value.id in shard_aliases
                        and (e.attr == "lock" or e.attr.endswith("_lock"))
                    ):
                        owners.add(e.value.id)
            return owners

        def check_node(stmt: ast.stmt, held: frozenset[str]) -> bool:
            """Flag the statement if it mutates outside the owning lock;
            returns whether a finding was emitted."""
            hit = mutation_of(stmt)
            if hit is None:
                for expr in own_exprs(stmt):
                    for sub in ast.walk(expr):
                        if isinstance(sub, ast.Call):
                            hit = mutation_of(sub)
                            if hit is not None:
                                break
                    if hit is not None:
                        break
            if hit is None:
                return False
            desc, owner = hit
            if owner == "*":
                ok = bool(held)
                want = "a state/shard lock"
            else:
                ok = owner in held
                want = (
                    "`with self._lock`" if owner == "self"
                    else f"`with {owner}.lock`"
                )
            if ok:
                return False
            out.append(self.finding(
                module, stmt,
                f"{func.name} {desc} outside {want} — take the owning "
                "lock (or waive with the documented reason if provably "
                "single-threaded)",
            ))
            return True

        def walk(stmts: list[ast.stmt], held: frozenset[str]) -> None:
            for stmt in stmts:
                note_alias(stmt)
                if isinstance(stmt, (ast.With, ast.AsyncWith)):
                    walk(stmt.body, held | locks_of(stmt))
                    continue
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue  # nested helpers are checked where they run
                if check_node(stmt, held):
                    continue
                # recurse into compound statements, preserving lock state
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, attr, None)
                    if sub:
                        walk(sub, held)
                for handler in getattr(stmt, "handlers", []) or []:
                    walk(handler.body, held)

        walk(func.body, frozenset())
