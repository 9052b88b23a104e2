"""JAX-001: jit-compiled functions must be pure and correctly staged.

``jax.jit`` traces a function ONCE per input shape and replays the
compiled program forever after: a ``time.time()`` / ``random.random()``
/ ``os.urandom()`` call inside the body is baked in as a constant, and a
mutated global silently stops updating — classic trace-time bugs that
pass a single-call unit test.  ``static_argnames`` naming a parameter
that does not exist is similarly silent: jax ignores it and the argument
is traced, churning one compilation per distinct value.  (This is also
the security boundary in docs/security.md: the TPU never generates
protocol randomness — α/β come from the host CSPRNG.)
"""

from __future__ import annotations

import ast

from ..engine import Finding, Module, Rule, dotted_parts, register

#: Dotted-call prefixes whose results are trace-time constants (or host
#: side effects) inside a jitted body.  ``jax.random`` is fine — it is
#: functional; only the *Python* RNG/clock families are banned.
IMPURE_PREFIXES: tuple[tuple[str, ...], ...] = (
    ("random",),
    ("np", "random"),
    ("numpy", "random"),
    ("os", "urandom"),
    ("secrets",),
    ("time",),
    ("datetime",),
)


def _jit_decoration(dec: ast.expr) -> ast.Call | bool | None:
    """None = not a jit decorator; True = bare ``@jax.jit``; a Call node =
    the configured form carrying static_arg* kwargs."""
    parts = dotted_parts(dec)
    if parts and parts[-1] == "jit":
        return True
    if isinstance(dec, ast.Call):
        fparts = dotted_parts(dec.func)
        if fparts and fparts[-1] == "jit":
            return dec
        if fparts and fparts[-1] == "partial":
            for arg in dec.args:
                aparts = dotted_parts(arg)
                if aparts and aparts[-1] == "jit":
                    return dec
    return None


def _static_kwargs(call: ast.Call) -> tuple[list[str] | None, list[int] | None]:
    """(static_argnames, static_argnums) literals, None when absent or
    non-literal (then unverifiable — not a finding)."""
    names: list[str] | None = None
    nums: list[int] | None = None
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            names = _str_literals(kw.value)
        elif kw.arg == "static_argnums":
            nums = _int_literals(kw.value)
    return names, nums


def _str_literals(node: ast.expr) -> list[str] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            out.append(e.value)
        return out
    return None


def _int_literals(node: ast.expr) -> list[int] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if not (
                isinstance(e, ast.Constant)
                and isinstance(e.value, int)
                and not isinstance(e.value, bool)
            ):
                return None
            out.append(e.value)
        return out
    return None


def _param_names(func: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = func.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


@register
class JitPurity(Rule):
    id = "JAX-001"
    summary = "jit bodies stay pure; static_argnames/nums name real parameters"
    rationale = (
        "jax.jit traces once and replays: Python RNG/clock calls become "
        "baked-in constants, global mutation stops happening, and a "
        "misspelled static_argnames is silently ignored (one "
        "recompilation per value)"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, node)

        # decorator form
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                jit = _jit_decoration(dec)
                if jit is None:
                    continue
                if isinstance(jit, ast.Call):
                    self._check_static_args(module, jit, node, out)
                self._check_purity(module, node, out)

        # call form: jax.jit(fn, ...) with fn resolvable in this module
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            fparts = dotted_parts(node.func)
            if not fparts or fparts[-1] != "jit":
                continue
            names, nums = _static_kwargs(node)
            target = None
            if node.args and isinstance(node.args[0], ast.Name):
                target = defs.get(node.args[0].id)
            if target is not None:
                self._check_static_args(module, node, target, out)
                self._check_purity(module, target, out)
            elif names or nums:
                # unresolvable target with static args: nothing to verify
                pass
        return out

    def _check_static_args(
        self, module: Module, call: ast.Call,
        func: ast.FunctionDef | ast.AsyncFunctionDef, out: list[Finding],
    ) -> None:
        params = _param_names(func)
        names, nums = _static_kwargs(call)
        if names is not None:
            for n in names:
                if n not in params:
                    out.append(self.finding(
                        module, call,
                        f"static_argnames names {n!r}, which is not a "
                        f"parameter of {func.name}() — jax silently "
                        "ignores it and retraces per value",
                    ))
        if nums is not None:
            has_vararg = func.args.vararg is not None
            for i in nums:
                if i < 0 or (i >= len(params) and not has_vararg):
                    out.append(self.finding(
                        module, call,
                        f"static_argnums index {i} is out of range for "
                        f"{func.name}() ({len(params)} parameters)",
                    ))

    def _check_purity(
        self, module: Module,
        func: ast.FunctionDef | ast.AsyncFunctionDef, out: list[Finding],
    ) -> None:
        for sub in ast.walk(func):
            if isinstance(sub, ast.Global):
                out.append(self.finding(
                    module, sub,
                    f"`global` mutation inside jitted {func.name}() "
                    "happens at trace time only — thread state through "
                    "arguments and return values",
                ))
            elif isinstance(sub, ast.Call):
                parts = dotted_parts(sub.func)
                if not parts:
                    continue
                if parts[0] in ("jax", "jnp"):  # jax.random etc. is functional
                    continue
                for prefix in IMPURE_PREFIXES:
                    if tuple(parts[: len(prefix)]) == prefix:
                        dotted = ".".join(parts)
                        out.append(self.finding(
                            module, sub,
                            f"{dotted}() inside jitted {func.name}() is "
                            "evaluated once at trace time and baked into "
                            "the compiled program; draw randomness/clocks "
                            "on the host and pass them in",
                        ))
                        break
