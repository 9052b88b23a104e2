"""cpzk-lint rule pack: one module per discipline, one visitor per rule.

Importing this package registers every rule with
:data:`cpzk_tpu_torch.analysis.engine.REGISTRY`.  ``PARSE-001`` and
``WAIVER-001`` are emitted by the engine itself (a file that does not
parse, a waiver without a reason); they are registered here as
documentation-only entries so the rule inventory — the CLI's
``--list-rules``, the JSON report's ``rule_ids``, and the
docs/security.md drift guard — names every id a report can contain.
"""

from __future__ import annotations

from ..engine import Module, Rule, register
from . import (  # noqa: F401  (import-for-registration)
    async_discipline,
    atomicity,
    constant_time,
    framing,
    grpc_abort,
    jax_purity,
    leaks,
    locking,
    process_spawn,
    state_funnels,
    thread_context,
)


@register
class ParseRule(Rule):
    id = "PARSE-001"
    summary = "source file must parse"
    rationale = (
        "an unparseable file is invisible to every other rule, so it is "
        "itself a finding rather than a crash or a silent skip"
    )

    def check(self, module: Module):  # emitted by the engine's loader
        return []


@register
class WaiverRule(Rule):
    id = "WAIVER-001"
    summary = "inline waivers must carry a reason"
    rationale = (
        "`# cpzk-lint: disable=RULE-ID -- <why>` keeps every suppression "
        "justified in the diff; a bare disable is itself a finding and "
        "cannot be waived"
    )

    def check(self, module: Module):  # emitted by the engine's waiver scan
        return []


@register
class StaleWaiverRule(Rule):
    id = "WAIVER-002"
    summary = "inline waivers must still suppress a live finding"
    rationale = (
        "a disable comment whose rule would no longer fire on the waived "
        "lines excuses code that is gone — stale suppressions hide the "
        "NEXT violation someone writes under them; delete the comment "
        "(audit with --audit-waivers).  Like WAIVER-001, it cannot be "
        "waived"
    )

    def check(self, module: Module):  # emitted by the engine's waiver scan
        return []
