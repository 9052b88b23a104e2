"""GRPC-001: RESOURCE_EXHAUSTED aborts route through ``_abort_exhausted``.

The overload pushback contract: EVERY shed path answers with
``cpzk-retry-after-ms`` trailing metadata so uninstrumented retry loops
spread out instead of hammering an overloaded server (gRFC A6).  The
single funnel is ``AuthServiceImpl._abort_exhausted``; a handler calling
``context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, ...)`` directly
reintroduces a bare "try again whenever" rejection.  This rule makes the
funnel structural: any ``.abort(...)`` whose arguments mention
``RESOURCE_EXHAUSTED`` outside the funnel function is a finding.
"""

from __future__ import annotations

import ast

from ..engine import Finding, Module, Rule, register

FUNNEL = "_abort_exhausted"


@register
class ExhaustedAbortFunnel(Rule):
    id = "GRPC-001"
    summary = "RESOURCE_EXHAUSTED aborts must go through _abort_exhausted"
    rationale = (
        "every shed path promises cpzk-retry-after-ms pushback metadata "
        "(PR-4 overload contract); a direct RESOURCE_EXHAUSTED abort "
        "ships a rejection without it"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        self._walk(module, module.tree, in_funnel=False, out=out)
        return out

    def _walk(
        self, module: Module, node: ast.AST, in_funnel: bool, out: list[Finding]
    ) -> None:
        for child in ast.iter_child_nodes(node):
            child_in_funnel = in_funnel
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                child_in_funnel = child.name == FUNNEL
            if (
                not child_in_funnel
                and isinstance(child, ast.Call)
                and isinstance(child.func, ast.Attribute)
                and child.func.attr == "abort"
                and self._mentions_exhausted(child)
            ):
                out.append(self.finding(
                    module, child,
                    "direct RESOURCE_EXHAUSTED abort bypasses "
                    f"{FUNNEL}() and ships no cpzk-retry-after-ms "
                    f"pushback; call self.{FUNNEL}(context, msg, "
                    "retry_after_s) instead",
                ))
            self._walk(module, child, child_in_funnel, out)

    @staticmethod
    def _mentions_exhausted(call: ast.Call) -> bool:
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Attribute) and sub.attr == "RESOURCE_EXHAUSTED":
                    return True
                if isinstance(sub, ast.Name) and sub.id == "RESOURCE_EXHAUSTED":
                    return True
        return False
