"""cpzk-lint core: module loading, inline waivers, and secret-taint dataflow.

The framework the rule pack (:mod:`cpzk_tpu_torch.analysis.rules`) plugs into.
Three layers:

- **Module loading** — walk the given paths for ``.py`` files (skipping
  ``_gen`` and caches), parse each into a :class:`Module` carrying the
  AST, source lines, the inline waivers, and the plane (the first package
  directory under ``cpzk_tpu_torch``, which scopes plane-specific rules like
  CT-002 and ASYNC-001).  A file ``ast.parse`` rejects becomes a single
  ``PARSE-001`` finding, never a crash — the fuzz harness
  (``fuzz/fuzz_lint.py``) holds "never raise on any input" as an
  invariant.

- **Waivers** — ``# cpzk-lint: disable=RULE-ID[,RULE-ID] -- <reason>``.
  A waiver on a statement line covers findings on that line; on a
  comment-only line it covers the next code line; on a ``def`` / ``class``
  line it covers the whole body (how a documented single-threaded
  exception like ``ServerState.replay_journal_record`` waives LOCK-001
  once instead of per-statement).  The reason is **mandatory**: a waiver
  without one is itself a ``WAIVER-001`` finding, so suppressions always
  carry their justification in the diff.

- **Secret taint** — a forward, per-function dataflow pass seeded from
  the protocol's named secret types (``Witness``, ``Nonce``,
  ``Response``), KDF outputs (``password_to_scalar`` /
  ``hash_secret_raw``), and ``password*``/``secret*`` parameters.  Three
  kinds are tracked: ``OBJ`` (a secret wrapper object), ``SCALAR`` (a
  :class:`~cpzk_tpu_torch.core.ristretto.Scalar` holding secret material —
  its ``__eq__`` is constant-time, so comparing two is fine), and
  ``RAW`` (bytes/int/str derived from a secret — the kind CT-001 and
  LEAK-001 fire on).  Taint propagates through arithmetic, subscripts,
  f-strings, known scalar-ring helpers, and generic calls; a small
  sanitizer set (``hmac.compare_digest``, ``len`` …) declassifies.

- **Execution contexts** — an interprocedural (per-module) pass
  (:mod:`.contexts`) builds a call graph, seeds contexts at spawn sites
  (``threading.Thread(target=)``, ``to_thread``, ``run_in_executor``,
  ``multiprocessing`` spawn targets, loop-callback registrations), and
  propagates them caller -> callee.  The context-sensitive rules
  (THREAD-001, PROC-001) read the result through
  :meth:`Module.func_info`; ASYNC-001 uses it to follow blocking calls
  into nested helpers that provably run on the event loop.

The taint analysis is intentionally intra-procedural and heuristic: it
will not follow taint across call boundaries (the context pass is the
one interprocedural layer, and it stops at the module boundary).  That
is the right trade for a lint gate — rules fire on the patterns
hand review actually misses (a ``==`` on secret bytes, a secret in an
f-string log, a map mutation outside the state lock, a Future settled
from a lane thread) with near-zero false positives on this codebase,
enforced by the self-hosted zero-findings test in
``tests/test_torch_static_analysis.py``.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from .contexts import ContextInference, FuncInfo
from .flows import FlowPass, FuncFlow  # noqa: F401 (re-export for rules)

# -- findings -----------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


# -- waivers ------------------------------------------------------------------

WAIVER_RE = re.compile(
    r"#\s*cpzk-lint:\s*disable=([A-Za-z0-9_\-, ]+?)\s*(?:--\s*(\S.*))?$"
)


@dataclass
class Waiver:
    """One inline ``# cpzk-lint: disable=...`` comment."""

    line: int                      # physical line of the comment
    rules: tuple[str, ...]
    reason: str | None
    span: tuple[int, int] = (0, 0)  # inclusive line range it covers

    def covers(self, rule: str, line: int) -> bool:
        return rule in self.rules and self.span[0] <= line <= self.span[1]


def _comment_lines(source: str) -> dict[int, str] | None:
    """Line -> text for every REAL comment token, via ``tokenize`` — a
    waiver spelled inside a string literal or docstring (the docs quote
    the syntax verbatim) must not register as a live waiver, which the
    historical line-regex scan could not distinguish.  ``None`` when the
    source does not tokenize (the regex fallback handles it)."""
    import io
    import tokenize

    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError, ValueError):
        return None
    return out


def _parse_waivers(source: str, tree: ast.AST) -> list[Waiver]:
    """Extract waivers and resolve the line span each one covers."""
    lines = source.splitlines()
    comments = _comment_lines(source)
    # def/class lines -> (start, end) body span, for whole-scope waivers
    scope_spans: dict[int, tuple[int, int]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            scope_spans[node.lineno] = (node.lineno, node.end_lineno or node.lineno)
            # decorators shift node.lineno to the `def`; map those lines too
            for dec in node.decorator_list:
                scope_spans.setdefault(
                    dec.lineno, (dec.lineno, node.end_lineno or node.lineno)
                )
    out: list[Waiver] = []
    for i, text in enumerate(lines, start=1):
        if comments is not None:
            m = WAIVER_RE.search(comments.get(i, ""))
        else:  # untokenizable source: the historical whole-line scan
            m = WAIVER_RE.search(text)
        if m is None:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2).strip() if m.group(2) else None
        target = i
        if text.lstrip().startswith("#"):
            # comment-only line: the waiver targets the next code line
            j = i + 1
            while j <= len(lines) and (
                not lines[j - 1].strip() or lines[j - 1].lstrip().startswith("#")
            ):
                j += 1
            target = j
        span = scope_spans.get(target, (target, target))
        out.append(Waiver(line=i, rules=rules, reason=reason, span=span))
    return out


# -- secret taint -------------------------------------------------------------

#: Taint kinds, ordered by "rawness" — combining taints takes the max.
OBJ = "obj"        # a secret wrapper instance (Witness / Nonce / Response)
SCALAR = "scalar"  # a Scalar holding secret material (ct __eq__ is safe)
RAW = "raw"        # bytes / int / str derived from a secret

_KIND_ORDER = {OBJ: 0, SCALAR: 1, RAW: 2}

SECRET_TYPES = frozenset({"Witness", "Nonce", "Response"})
#: Attribute names that conventionally hold a secret wrapper (self.witness).
SECRET_ATTRS = frozenset({"witness", "nonce"})
#: Wrapper internals: Nonce._k, Witness._x, Response._s / .s
SECRET_FIELDS = frozenset({"s", "_s", "_k", "_x"})
SECRET_PARAM_RE = re.compile(r"^(password|passwd|secret)")

#: KDF outputs: scalar-typed vs raw-byte results.
KDF_SCALAR_FUNCS = frozenset({"password_to_scalar"})
KDF_RAW_FUNCS = frozenset({"hash_secret_raw", "_argon2id"})

#: Scalar-ring helpers: Ristretto255.* return Scalar, sc_* return raw ints.
SCALAR_OPS_SCALAR = frozenset({
    "scalar_add", "scalar_sub", "scalar_mul_scalar", "scalar_negate",
    "scalar_invert",
})
SCALAR_OPS_RAW = frozenset({
    "sc_add", "sc_sub", "sc_mul", "sc_neg", "sc_invert",
    "sc_from_bytes_canonical", "sc_from_bytes_mod_order_wide",
})
TO_RAW_FUNCS = frozenset({
    "sc_to_bytes", "scalar_to_bytes", "bytes", "bytearray", "int", "str",
    "repr", "format",
})
TO_RAW_METHODS = frozenset({"to_bytes", "hex", "encode", "digest", "hexdigest"})
#: Calls whose result is never secret even with tainted arguments.
SANITIZERS = frozenset({
    "compare_digest", "len", "isinstance", "type", "id", "range", "bool",
})


def _max_kind(*kinds: str | None) -> str | None:
    best: str | None = None
    for k in kinds:
        if k is not None and (best is None or _KIND_ORDER[k] > _KIND_ORDER[best]):
            best = k
    return best


def _call_name(func: ast.expr) -> str:
    """Last dotted segment of a call target (``a.b.c(...)`` -> ``c``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def dotted_parts(node: ast.expr) -> list[str]:
    """``a.b.c`` -> ["a", "b", "c"]; [] when the chain has a non-name root."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


class TaintPass:
    """Single forward pass annotating every expression with its taint kind.

    Results land in ``self.kinds`` keyed by AST node identity; rules read
    them through :meth:`Module.kind`.  Branches are merged optimistically
    (both arms update one shared environment) — sound enough for lint.
    """

    def __init__(self) -> None:
        self.kinds: dict[ast.AST, str] = {}

    def run(self, tree: ast.AST) -> dict[ast.AST, str]:
        self._exec_body(getattr(tree, "body", []), {})
        return self.kinds

    # -- statements ----------------------------------------------------------

    def _exec_body(self, body: list[ast.stmt], env: dict[str, str]) -> None:
        for stmt in body:
            self._exec(stmt, env)

    def _seed_params(
        self, node: ast.FunctionDef | ast.AsyncFunctionDef, env: dict[str, str]
    ) -> None:
        args = node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if SECRET_PARAM_RE.match(a.arg):
                env[a.arg] = RAW
            elif a.annotation is not None:
                ann = dotted_parts(a.annotation)
                if ann and ann[-1] in SECRET_TYPES:
                    env[a.arg] = OBJ

    def _exec(self, stmt: ast.stmt, env: dict[str, str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = dict(env)  # nested defs inherit the enclosing taint
            self._seed_params(stmt, inner)
            self._exec_body(stmt.body, inner)
        elif isinstance(stmt, ast.ClassDef):
            self._exec_body(stmt.body, {})
        elif isinstance(stmt, ast.Assign):
            kind = self._eval(stmt.value, env)
            for target in stmt.targets:
                self._bind(target, kind, env)
        elif isinstance(stmt, ast.AnnAssign):
            kind = self._eval(stmt.value, env) if stmt.value is not None else None
            ann = dotted_parts(stmt.annotation)
            if ann and ann[-1] in SECRET_TYPES:
                kind = _max_kind(kind, OBJ)
            self._bind(stmt.target, kind, env)
        elif isinstance(stmt, ast.AugAssign):
            kind = _max_kind(
                self._eval(stmt.value, env), self._eval(stmt.target, env)
            )
            self._bind(stmt.target, kind, env)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            kind = self._eval(stmt.iter, env)
            self._bind(stmt.target, kind, env)
            self._exec_body(stmt.body, env)
            self._exec_body(stmt.orelse, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                kind = self._eval(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, kind, env)
            self._exec_body(stmt.body, env)
        elif isinstance(stmt, ast.If):
            self._eval(stmt.test, env)
            self._exec_body(stmt.body, env)
            self._exec_body(stmt.orelse, env)
        elif isinstance(stmt, ast.While):
            self._eval(stmt.test, env)
            self._exec_body(stmt.body, env)
            self._exec_body(stmt.orelse, env)
        elif isinstance(stmt, ast.Try):
            self._exec_body(stmt.body, env)
            for handler in stmt.handlers:
                self._exec_body(handler.body, env)
            self._exec_body(stmt.orelse, env)
            self._exec_body(stmt.finalbody, env)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self._eval(stmt.value, env)
        elif isinstance(stmt, ast.Expr):
            self._eval(stmt.value, env)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self._eval(stmt.exc, env)
        elif isinstance(stmt, ast.Assert):
            self._eval(stmt.test, env)
            if stmt.msg is not None:
                self._eval(stmt.msg, env)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._eval(t, env)
        # Import / Global / Pass / Break / Continue: no taint flow

    def _bind(self, target: ast.expr, kind: str | None, env: dict[str, str]) -> None:
        if isinstance(target, ast.Name):
            if kind is None:
                env.pop(target.id, None)  # rebinding declassifies
            else:
                env[target.id] = kind
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, kind, env)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, kind, env)
        # attribute / subscript stores: reads go through SECRET_ATTRS

    # -- expressions ---------------------------------------------------------

    def _eval(self, node: ast.expr | None, env: dict[str, str]) -> str | None:
        if node is None:
            return None
        kind = self._eval_inner(node, env)
        if kind is not None:
            self.kinds[node] = kind
        return kind

    def _eval_inner(self, node: ast.expr, env: dict[str, str]) -> str | None:
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self._eval(node.value, env)
            if node.attr in SECRET_ATTRS:
                return OBJ
            if base == OBJ:
                # OBJ taint flows ONLY through the secret accessors: a
                # wrapper's other attributes (prover.statement, methods)
                # are public by design
                return SCALAR if node.attr in SECRET_FIELDS else None
            if base == SCALAR:
                return RAW if node.attr == "value" else None
            return base  # RAW: fields/slices of raw secrets stay secret
        if isinstance(node, ast.Call):
            return self._eval_call(node, env)
        if isinstance(node, ast.BinOp):
            left = self._eval(node.left, env)
            right = self._eval(node.right, env)
            return _max_kind(left, right)
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand, env)
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self._eval(v, env)
            return None  # a bool result is not itself secret
        if isinstance(node, ast.Compare):
            self._eval(node.left, env)
            for c in node.comparators:
                self._eval(c, env)
            return None
        if isinstance(node, ast.Subscript):
            kind = self._eval(node.value, env)
            self._eval(node.slice, env)
            return kind
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return _max_kind(*(self._eval(e, env) for e in node.elts))
        if isinstance(node, ast.Dict):
            kinds = [self._eval(v, env) for v in node.values if v is not None]
            for k in node.keys:
                if k is not None:
                    kinds.append(self._eval(k, env))
            return _max_kind(*kinds)
        if isinstance(node, ast.JoinedStr):
            tainted = None
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    k = self._eval(v.value, env)
                    if k is not None:
                        self.kinds[v] = k
                    tainted = _max_kind(tainted, k)
            return RAW if tainted is not None else None
        if isinstance(node, ast.IfExp):
            self._eval(node.test, env)
            return _max_kind(self._eval(node.body, env), self._eval(node.orelse, env))
        if isinstance(node, ast.Await):
            return self._eval(node.value, env)
        if isinstance(node, ast.Starred):
            return self._eval(node.value, env)
        if isinstance(node, ast.NamedExpr):
            kind = self._eval(node.value, env)
            self._bind(node.target, kind, env)
            return kind
        if isinstance(node, ast.Lambda):
            self._eval(node.body, dict(env))
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            inner = dict(env)
            for gen in node.generators:
                kind = self._eval(gen.iter, inner)
                self._bind(gen.target, kind, inner)
                for cond in gen.ifs:
                    self._eval(cond, inner)
            return self._eval(node.elt, inner)
        if isinstance(node, ast.DictComp):
            inner = dict(env)
            for gen in node.generators:
                kind = self._eval(gen.iter, inner)
                self._bind(gen.target, kind, inner)
                for cond in gen.ifs:
                    self._eval(cond, inner)
            return _max_kind(self._eval(node.key, inner), self._eval(node.value, inner))
        if isinstance(node, ast.FormattedValue):
            return self._eval(node.value, env)
        return None

    def _eval_call(self, node: ast.Call, env: dict[str, str]) -> str | None:
        name = _call_name(node.func)
        recv_kind = None
        if isinstance(node.func, ast.Attribute):
            recv_kind = self._eval(node.func.value, env)
        arg_kinds = [self._eval(a, env) for a in node.args]
        arg_kinds += [self._eval(kw.value, env) for kw in node.keywords]
        any_arg = _max_kind(*arg_kinds)

        if name in SANITIZERS:
            return None
        if name in SECRET_TYPES:
            return OBJ
        if name in KDF_SCALAR_FUNCS:
            return SCALAR
        if name in KDF_RAW_FUNCS:
            return RAW
        if recv_kind == OBJ and name in ("secret", "k"):
            return SCALAR
        if name in SCALAR_OPS_SCALAR and any_arg is not None:
            return SCALAR
        if name in SCALAR_OPS_RAW and any_arg is not None:
            return RAW
        if name == "Scalar" and any_arg is not None:
            return SCALAR
        if name in TO_RAW_FUNCS and any_arg is not None:
            return RAW
        if name in TO_RAW_METHODS and _max_kind(recv_kind, any_arg) is not None:
            return RAW
        # Generic propagation: a call over SCALAR/RAW inputs yields a RAW
        # secret (hash of a secret, arithmetic on one...).  OBJ inputs do
        # NOT propagate: passing a Witness to a constructor (Prover(...))
        # must not taint the receiver's public surface — only the named
        # accessors above extract the secret.
        kinds = [recv_kind, *arg_kinds]
        if any(k in (SCALAR, RAW) for k in kinds):
            return RAW
        return None


# -- modules ------------------------------------------------------------------


@dataclass
class Module:
    """One parsed source file plus its lint-relevant metadata."""

    path: str
    source: str
    tree: ast.Module
    waivers: list[Waiver] = field(default_factory=list)
    taint: dict[ast.AST, str] = field(default_factory=dict)
    #: function node -> FuncInfo (execution contexts + call edges)
    contexts: dict[ast.AST, FuncInfo] = field(default_factory=dict)
    #: the inference pass itself (rules reuse its resolver/scope maps)
    inference: ContextInference | None = None
    #: function node -> FuncFlow (await-point event streams, cpzk-lint v3)
    flows: dict[ast.AST, "FuncFlow"] = field(default_factory=dict)

    @property
    def plane(self) -> str:
        """First package directory under ``cpzk_tpu_torch`` ("core", "server",
        ...), or "" for files outside the package."""
        parts = self.path.replace(os.sep, "/").split("/")
        if "cpzk_tpu_torch" in parts:
            i = parts.index("cpzk_tpu_torch")
            if i + 2 <= len(parts) - 1:
                return parts[i + 1]
        return ""

    @property
    def filename(self) -> str:
        return os.path.basename(self.path)

    def kind(self, node: ast.AST) -> str | None:
        """Taint kind of an expression node (None = untainted)."""
        return self.taint.get(node)

    def any_tainted(self, node: ast.AST) -> str | None:
        """Max taint kind across ``node`` and its descendants."""
        best = self.taint.get(node)
        for sub in ast.walk(node):
            best = _max_kind(best, self.taint.get(sub))
        return best

    def func_info(self, node: ast.AST) -> FuncInfo | None:
        """Context info for a function-def node (None for non-functions)."""
        return self.contexts.get(node)

    def func_contexts(self, node: ast.AST) -> frozenset[str]:
        """Inferred execution contexts of a function-def node."""
        info = self.contexts.get(node)
        return frozenset(info.contexts) if info is not None else frozenset()


def parse_module(source: str, path: str) -> Module | Finding:
    """Parse one source file; a syntax error becomes a PARSE-001 finding."""
    try:
        tree = ast.parse(source)
    except (SyntaxError, ValueError) as e:
        line = getattr(e, "lineno", 1) or 1
        return Finding("PARSE-001", path, line, 0, f"file does not parse: {e.msg if hasattr(e, 'msg') else e}")
    mod = Module(path=path, source=source, tree=tree)
    mod.waivers = _parse_waivers(source, tree)
    mod.taint = TaintPass().run(tree)
    mod.inference = ContextInference(tree)
    mod.contexts = mod.inference.run()
    mod.flows = FlowPass(tree).run()
    return mod


def collect_files(paths: list[str]) -> list[str]:
    """All ``.py`` files under ``paths`` (skipping generated/cache dirs)."""
    skip_dirs = {"_gen", "__pycache__", ".git"}
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        if not os.path.isdir(p):
            # a typo'd path exiting 0 would be a silently green gate
            raise FileNotFoundError(f"no such file or directory: {p}")
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in skip_dirs)
            for f in sorted(files):
                if f.endswith(".py"):
                    out.append(os.path.join(root, f))
    return out


# -- rules + runner -----------------------------------------------------------


class Rule:
    """One lint rule.  Subclasses set ``id``/``summary``/``rationale`` and
    implement :meth:`check`."""

    id: str = ""
    summary: str = ""
    rationale: str = ""

    def check(self, module: Module) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(
            self.id, module.path,
            getattr(node, "lineno", 1), getattr(node, "col_offset", 0),
            message,
        )


REGISTRY: dict[str, Rule] = {}


def register(rule_cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to the global registry."""
    inst = rule_cls()
    if not inst.id:
        raise ValueError(f"rule {rule_cls.__name__} has no id")
    REGISTRY[inst.id] = inst
    return rule_cls


def all_rule_ids() -> list[str]:
    _load_rules()
    return sorted(REGISTRY)


_RULES_LOADED = False


def _load_rules() -> None:
    """Import the rule pack exactly once (registration side effects)."""
    global _RULES_LOADED
    if not _RULES_LOADED:
        from . import rules  # noqa: F401
        _RULES_LOADED = True


@dataclass
class WaiverAudit:
    """One live waiver's audit row (the ``--audit-waivers`` surface and
    the ``waivers`` key of the JSON report)."""

    path: str
    line: int
    rules: tuple[str, ...]
    reason: str | None
    waived: int                      # findings this waiver suppressed
    stale: tuple[str, ...] = ()      # waived rule ids that never fired

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "rules": list(self.rules),
            "reason": self.reason,
            "waived": self.waived,
            "stale": list(self.stale),
        }

    def render(self) -> str:
        status = (
            f"STALE: {','.join(self.stale)} would not fire"
            if self.stale else f"active ({self.waived} waived)"
        )
        reason = self.reason or "<NO REASON>"
        return (
            f"{self.path}:{self.line}: disable={','.join(self.rules)} "
            f"-- {reason} [{status}]"
        )


@dataclass
class Report:
    """One analysis run: active findings, waived findings, file count,
    and the waiver audit."""

    findings: list[Finding] = field(default_factory=list)
    waived: list[Finding] = field(default_factory=list)
    waivers: list[WaiverAudit] = field(default_factory=list)
    files: int = 0

    def to_dict(self) -> dict:
        """The ``--json`` document.  Schema-stable: the drift-guard test in
        tests/test_torch_static_analysis.py pins these keys.  Version 2 added
        the ``waivers`` audit list (WAIVER-002)."""
        return {
            "schema_version": 2,
            "tool": "cpzk-lint",
            "rule_ids": all_rule_ids(),
            "files": self.files,
            "findings": [f.to_dict() for f in self.findings],
            "waived": [f.to_dict() for f in self.waived],
            "waivers": [w.to_dict() for w in self.waivers],
            "summary": {
                "findings": len(self.findings),
                "waived": len(self.waived),
            },
        }

    def to_sarif(self) -> dict:
        """The ``--format sarif`` document (SARIF 2.1.0, minimal profile)
        so CI can annotate PRs.  Waived findings are carried with
        ``suppressions`` so annotation UIs hide them by default; exit
        codes and the human/text output are unaffected."""
        _load_rules()
        rules = [
            {
                "id": rule_id,
                "shortDescription": {"text": REGISTRY[rule_id].summary},
                "fullDescription": {"text": REGISTRY[rule_id].rationale},
            }
            for rule_id in all_rule_ids()
        ]

        def result(f: Finding, suppressed: bool) -> dict:
            row = {
                "ruleId": f.rule,
                "level": "error",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path.replace(os.sep, "/"),
                        },
                        "region": {
                            "startLine": max(1, f.line),
                            "startColumn": max(1, f.col + 1),
                        },
                    },
                }],
            }
            if suppressed:
                row["suppressions"] = [{"kind": "inSource"}]
            return row

        return {
            "$schema": (
                "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json"
            ),
            "version": "2.1.0",
            "runs": [{
                "tool": {
                    "driver": {
                        "name": "cpzk-lint",
                        "informationUri": (
                            "https://github.com/kobby-pentangeli/"
                            "chaum-pedersen-zkp"
                        ),
                        "rules": rules,
                    },
                },
                "results": (
                    [result(f, False) for f in self.findings]
                    + [result(f, True) for f in self.waived]
                ),
            }],
        }


def analyze_source(
    source: str, path: str = "cpzk_tpu_torch/fixture.py",
    rules: list[str] | None = None,
) -> Report:
    """Analyze one in-memory source blob (the fixture-test entry point).
    ``path`` is virtual and drives plane-scoped rules."""
    return _analyze([(source, path)], rules)


def analyze_paths(paths: list[str], rules: list[str] | None = None) -> Report:
    """Analyze files/directories on disk (the CLI entry point)."""
    blobs: list[tuple[str, str]] = []
    for path in collect_files(paths):
        with open(path, encoding="utf-8", errors="replace") as f:
            blobs.append((f.read(), os.path.relpath(path)))
    return _analyze(blobs, rules)


def _analyze(blobs: list[tuple[str, str]], rules: list[str] | None) -> Report:
    _load_rules()
    active = [
        REGISTRY[r] for r in (rules if rules is not None else sorted(REGISTRY))
        if r in REGISTRY
    ]
    active_ids = {r.id for r in active}
    report = Report(files=len(blobs))
    want_waiver_rule = rules is None or "WAIVER-001" in (rules or [])
    want_stale_rule = rules is None or "WAIVER-002" in (rules or [])
    for source, path in blobs:
        mod = parse_module(source, path)
        if isinstance(mod, Finding):
            report.findings.append(mod)
            continue
        raw: list[Finding] = []
        for rule in active:
            try:
                raw.extend(rule.check(mod))
            except Exception as e:  # a rule bug must not kill the whole run
                raw.append(Finding(
                    rule.id, mod.path, 1, 0,
                    f"internal rule error (treat as a finding): {e!r}",
                ))
        waived_count: dict[int, int] = {}
        for f in raw:
            waiver = next(
                (w for w in mod.waivers if w.covers(f.rule, f.line)), None
            )
            if waiver is not None:
                report.waived.append(f)
                waived_count[waiver.line] = waived_count.get(waiver.line, 0) + 1
            else:
                report.findings.append(f)
        for w in mod.waivers:
            if want_waiver_rule and w.reason is None:
                report.findings.append(Finding(
                    "WAIVER-001", mod.path, w.line, 0,
                    "waiver without a reason: write "
                    "`# cpzk-lint: disable=RULE-ID -- <why>`",
                ))
            # WAIVER-002: a waived rule that no longer fires anywhere in
            # the waiver's span is stale — the code it excused is gone (or
            # changed), so the suppression must not outlive it.  Judged
            # only for rules that actually ran this pass (a --rules filter
            # that skipped the rule cannot call its waiver stale); a rule
            # id no registered rule answers to can never fire and is
            # always stale on a full run.
            stale: list[str] = []
            for rid in w.rules:
                if rid in active_ids:
                    if not any(
                        f.rule == rid and w.span[0] <= f.line <= w.span[1]
                        for f in raw
                    ):
                        stale.append(rid)
                elif rules is None and rid not in REGISTRY:
                    stale.append(rid)
            if stale and want_stale_rule:
                report.findings.append(Finding(
                    "WAIVER-002", mod.path, w.line, 0,
                    f"stale waiver: {', '.join(stale)} would not fire on "
                    "the waived lines — delete the disable comment (or "
                    "fix its rule id)",
                ))
            report.waivers.append(WaiverAudit(
                path=mod.path, line=w.line, rules=w.rules, reason=w.reason,
                waived=waived_count.get(w.line, 0),
                stale=tuple(stale) if want_stale_rule else (),
            ))
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    report.waived.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    report.waivers.sort(key=lambda w: (w.path, w.line))
    return report
