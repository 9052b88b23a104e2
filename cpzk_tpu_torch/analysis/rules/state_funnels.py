"""FUNNEL-001: ServerState registry mutations route through the funnels.

The sharded state rebuilt ``server/state.py`` around six **mutation funnels** —
``_user_insert`` / ``_user_remove`` / ``_session_insert`` /
``_session_remove`` / ``_challenge_insert`` / ``_challenge_remove`` —
and three pieces of derived state now depend on every mutation passing
through them: the O(1) capacity counters (``_n_users`` etc.), the
per-shard expiry time-wheels, and the per-user-list churn cleanup.  A
direct write like ``shard._sessions[token] = data`` keeps serving
happily while the wheel never learns the entry exists — it is then
never swept (a slow leak) or swept wrong (a session expiring while the
cap counter still counts it).  That desynchronization is silent by
construction, which is exactly the class of invariant this analyzer
exists to pin.

The rule walks every method of any class named ``ServerState`` (real or
fixture) and flags dict-level mutations — subscript assignment, ``del``,
``.pop`` / ``.popitem`` / ``.clear`` / ``.update`` / ``.setdefault`` —
of the three wheel-and-counter-backed registries (``_users``,
``_sessions``, ``_challenges``), reached through ``self``, a shard alias
(``shard = self._shards[i]`` / ``self._shard_for_user(...)`` / ``for
shard in self._shards``), or a registry alias (``registry =
shard._sessions``).  The funnel methods themselves and ``__init__`` are
the only exempt scopes — they ARE the funnel.  The per-user index lists
(``_user_challenges`` / ``_user_sessions``) are deliberately out of
scope: the live contract is "inserts manual under the shard lock,
removals funneled", and LOCK-001 already guards their lock discipline.
"""

from __future__ import annotations

import ast

from ..engine import Finding, Module, Rule, register
from .locking import SHARDS_ATTR, _is_self_attr, _shard_expr_source

#: The wheel-and-counter-backed registries (see module docstring).
FUNNELED_MAPS = frozenset({"_users", "_sessions", "_challenges"})
#: The funnels — the ONLY scopes allowed to mutate the maps directly.
FUNNEL_METHODS = frozenset({
    "_user_insert", "_user_remove",
    "_session_insert", "_session_remove",
    "_challenge_insert", "_challenge_remove",
    "__init__",
})
#: Dict methods that mutate in place.
DICT_MUTATORS = frozenset({
    "pop", "popitem", "clear", "update", "setdefault",
})

_FUNNEL_FOR = {
    "_users": "_user_insert/_user_remove",
    "_sessions": "_session_insert/_session_remove",
    "_challenges": "_challenge_insert/_challenge_remove",
}


@register
class StateMutationFunnel(Rule):
    id = "FUNNEL-001"
    summary = (
        "ServerState registry mutations go through the _*_insert/_*_remove "
        "funnels"
    )
    rationale = (
        "the capacity counters, expiry time-wheels, and per-user-list "
        "cleanup are maintained ONLY by the six mutation funnels; a "
        "direct registry write desynchronizes the time wheel silently — "
        "the entry is never swept (leak) or the counter drifts from the "
        "map (cap lies)"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and node.name == "ServerState":
                for item in node.body:
                    if (
                        isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name not in FUNNEL_METHODS
                    ):
                        self._check_method(module, item, out)
        return out

    def _check_method(
        self, module: Module,
        func: ast.FunctionDef | ast.AsyncFunctionDef,
        out: list[Finding],
    ) -> None:
        shard_aliases: set[str] = set()
        #: registry-alias name -> registry attr it aliases
        map_aliases: dict[str, str] = {}

        def registry_of(expr: ast.expr) -> str | None:
            """The funneled registry ``expr`` denotes, or None."""
            if _is_self_attr(expr, FUNNELED_MAPS):
                return expr.attr
            if (
                isinstance(expr, ast.Attribute)
                and expr.attr in FUNNELED_MAPS
                and isinstance(expr.value, ast.Name)
                and expr.value.id in shard_aliases
            ):
                return expr.attr
            if isinstance(expr, ast.Name):
                return map_aliases.get(expr.id)
            return None

        def note_alias(stmt: ast.stmt) -> None:
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
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
            if _shard_expr_source(value):
                shard_aliases.add(target.id)
                return
            # registry = shard._sessions (or the ternary sweep form:
            # shard._session_X if cond else shard._challenge_X)
            candidates = (
                [value.body, value.orelse]
                if isinstance(value, ast.IfExp) else [value]
            )
            for cand in candidates:
                reg = registry_of(cand)
                if reg is not None:
                    map_aliases[target.id] = reg
                    return

        def flag(node: ast.AST, reg: str, what: str) -> None:
            out.append(self.finding(
                module, node,
                f"{func.name} {what} {reg} directly, bypassing the "
                f"{_FUNNEL_FOR[reg]} funnel — the expiry wheel and "
                "capacity counter silently desynchronize; route the "
                "mutation through the funnel",
            ))

        def visit(node: ast.AST) -> None:
            """Source-order traversal so aliases are noted before use."""
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    note_alias(child)
                if isinstance(child, (ast.Assign, ast.AugAssign)):
                    targets = (
                        child.targets if isinstance(child, ast.Assign)
                        else [child.target]
                    )
                    for t in targets:
                        if isinstance(t, ast.Subscript):
                            reg = registry_of(t.value)
                            if reg is not None:
                                flag(child, reg, "subscript-assigns into")
                elif isinstance(child, ast.Delete):
                    for t in child.targets:
                        if isinstance(t, ast.Subscript):
                            reg = registry_of(t.value)
                            if reg is not None:
                                flag(child, reg, "deletes from")
                elif isinstance(child, ast.Call):
                    f = child.func
                    if isinstance(f, ast.Attribute) and f.attr in DICT_MUTATORS:
                        reg = registry_of(f.value)
                        if reg is not None:
                            flag(child, reg, f"calls .{f.attr}() on")
                visit(child)

        visit(func)
