"""CT-001 / CT-002: constant-time discipline on secret-tainted values.

The reference crate gets these structurally from ``subtle``: secret
comparisons go through ``ConstantTimeEq`` and the compiler has no reason
to branch on secret bits.  The Python port documents the same rules in
docs/security.md; these two rules make them machine-checked.
"""

from __future__ import annotations

import ast

from ..engine import RAW, Finding, Module, Rule, register

#: Planes where ANY secret-dependent branching is banned (CT-002): the
#: protocol math itself.  Host planes (server/client) branch on public
#: request data constantly and are covered by CT-001/LEAK-001 instead.
CT_BRANCH_PLANES = frozenset({"core", "protocol"})


@register
class VartimeEquality(Rule):
    id = "CT-001"
    summary = "equality on secret-derived bytes/ints must be constant-time"
    rationale = (
        "`==` on bytes/int short-circuits on the first differing "
        "byte/limb — a remote timing oracle on the secret; compare via "
        "hmac.compare_digest (or Scalar.__eq__, which already does)"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Compare):
                continue
            if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
                continue
            sides = [node.left, *node.comparators]
            if any(module.kind(s) == RAW for s in sides):
                out.append(self.finding(
                    module, node,
                    "variable-time == / != on a secret-derived value; use "
                    "hmac.compare_digest on canonical encodings (or compare "
                    "Scalar objects, whose __eq__ is constant-time)",
                ))
        return out


@register
class SecretBranch(Rule):
    id = "CT-002"
    summary = "no secret-dependent branching in core/ and protocol/"
    rationale = (
        "an if/while/short-circuit whose condition depends on secret "
        "material makes execution time a function of the secret; the "
        "protocol planes must stay branchless on witnesses, nonces, and "
        "responses (docs/security.md constant-time discipline)"
    )

    def check(self, module: Module) -> list[Finding]:
        if module.plane not in CT_BRANCH_PLANES:
            return []
        out: list[Finding] = []
        seen: set[tuple[int, int]] = set()

        def flag(test: ast.expr, what: str) -> None:
            if module.any_tainted(test) is None:
                return
            key = (test.lineno, test.col_offset)
            if key in seen:
                return
            seen.add(key)
            out.append(self.finding(
                module, test,
                f"secret-dependent {what}: rewrite branchless (masked "
                "select / unconditional compute) or hoist the decision to "
                "public data",
            ))

        for node in ast.walk(module.tree):
            if isinstance(node, ast.If):
                flag(node.test, "if condition")
            elif isinstance(node, ast.While):
                flag(node.test, "while condition")
            elif isinstance(node, ast.IfExp):
                flag(node.test, "conditional expression")
            elif isinstance(node, ast.Assert):
                flag(node.test, "assert condition")
            elif isinstance(node, ast.BoolOp):
                for value in node.values[:-1]:
                    # every operand but the last can short-circuit
                    if module.any_tainted(value) is not None:
                        flag(value, "short-circuit operand")
        return out
