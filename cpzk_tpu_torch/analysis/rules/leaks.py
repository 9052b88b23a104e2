"""LEAK-001: secret taint must never reach an observable text sink.

The reference wipes witnesses with ``zeroize`` and never formats them;
our port documents "secrets are never logged" in docs/security.md.  This
rule enforces it: any secret-tainted expression flowing into logging,
string formatting, exception messages, trace-ring events, metric label
values, or stdout is a finding — each of those surfaces persists or
transmits the text far outside the process's trust boundary.
"""

from __future__ import annotations

import ast

from ..engine import Finding, Module, Rule, dotted_parts, register

LOG_METHODS = frozenset({
    "debug", "info", "warning", "warn", "error", "exception", "critical",
    "log",
})
#: Receiver names that identify a logging call (log.info, logger.debug,
#: logging.warning); keeps `resp.error(...)`-style calls out of scope.
LOG_RECEIVERS = frozenset({"log", "logger", "logging"})


def _is_log_call(node: ast.Call) -> bool:
    if not isinstance(node.func, ast.Attribute) or node.func.attr not in LOG_METHODS:
        return False
    parts = dotted_parts(node.func.value)
    if not parts:
        return False
    root = parts[0]
    leaf = parts[-1]
    return (
        root in LOG_RECEIVERS
        or leaf in LOG_RECEIVERS
        or root.endswith("logger")
        or (root == "logging" or leaf.startswith("getLogger"))
    )


@register
class SecretLeak(Rule):
    id = "LEAK-001"
    summary = "secret taint must not reach logs, formatting, exceptions, traces, or metric labels"
    rationale = (
        "a witness/nonce/response or KDF output formatted into a log "
        "line, exception message, trace event, or metric label leaves "
        "the process (log shippers, trace rings, Prometheus scrapes) and "
        "cannot be unleaked"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        seen: set[tuple[int, int]] = set()

        def flag(node: ast.AST, what: str) -> None:
            key = (getattr(node, "lineno", 1), getattr(node, "col_offset", 0))
            if key in seen:
                return
            seen.add(key)
            out.append(self.finding(
                module, node,
                f"secret-derived value reaches {what}; redact it (log a "
                "length/fingerprint, never the encoding)",
            ))

        def any_tainted_arg(call: ast.Call) -> bool:
            # top-level kinds only: `len(password)` evaluates through the
            # sanitizer list to untainted, while `str(password)` stays RAW
            return any(
                module.kind(a) is not None for a in call.args
            ) or any(
                module.kind(kw.value) is not None for kw in call.keywords
            )

        for node in ast.walk(module.tree):
            # f"...{secret}..."
            if isinstance(node, ast.FormattedValue):
                if module.kind(node.value) is not None:
                    flag(node, "an f-string")
                continue
            # "..." % secret
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod):
                if (
                    isinstance(node.left, ast.Constant)
                    and isinstance(node.left.value, str)
                    and module.kind(node.right) is not None
                ):
                    flag(node, "%-formatting")
                continue
            if isinstance(node, ast.Raise):
                if node.exc is not None and module.kind(node.exc) is not None:
                    flag(node, "an exception message")
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            attr = func.attr if isinstance(func, ast.Attribute) else ""
            name = func.id if isinstance(func, ast.Name) else ""
            if _is_log_call(node) and any_tainted_arg(node):
                flag(node, "a logging call")
            elif attr == "format" and any_tainted_arg(node):
                flag(node, "str.format()")
            elif attr == "record_event" and any_tainted_arg(node):
                flag(node, "a Tracer.record_event trace event")
            elif attr == "labels" and any_tainted_arg(node):
                flag(node, "a metric label value")
            elif name == "print" and any_tainted_arg(node):
                flag(node, "stdout via print()")
        return out
