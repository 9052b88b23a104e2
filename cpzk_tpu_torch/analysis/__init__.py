"""cpzk-lint: AST-based invariant analyzer for this codebase's security
and concurrency discipline.

The reference crate enforces its safety properties structurally —
``subtle::ConstantTimeEq``, ``zeroize``, the borrow checker.  The Python
port documents the same rules (docs/security.md); this package makes
them machine-checked and self-hosted: tier-1 runs the analyzer over the
whole tree and asserts zero findings, so every future PR is gated
without needing CI.

Rule pack (see docs/security.md "Mechanically enforced invariants"):

- **CT-001** — equality on secret-derived bytes/ints must be constant-time
- **CT-002** — no secret-dependent branching in ``core/`` / ``protocol/``
- **LEAK-001** — secret taint never reaches logs/format/exceptions/traces/labels
- **LOCK-001** — ``ServerState`` map mutations + WAL appends under ``self._lock``
- **ASYNC-001** — no blocking calls in serving-plane ``async def`` bodies
- **ASYNC-002** — spawned task handles must be retained
- **GRPC-001** — RESOURCE_EXHAUSTED aborts route through ``_abort_exhausted``
- **JAX-001** — jit purity + real ``static_argnames``/``static_argnums``
- **THREAD-001** — asyncio objects untouched from thread/process context
  except via ``loop.call_soon_threadsafe`` (execution-context inference)
- **FUNNEL-001** — ``ServerState`` registry mutations ride the
  ``_*_insert``/``_*_remove`` funnels (wheel/counter consistency)
- **PROC-001** — spawn ``Process`` targets are module-level with
  picklable, spawn-safe args
- **FRAME-001** — length+CRC framing only via the shared WAL helpers
- **WAIVER-001** / **WAIVER-002** / **PARSE-001** — waivers need reasons
  and must stay live; files must parse

Run: ``python -m cpzk_tpu_torch.analysis cpzk_tpu_torch/`` (``--json`` for the
machine-readable report, ``--audit-waivers`` for every suppression with
its liveness).  Waive a finding inline with
``# cpzk-lint: disable=RULE-ID -- <reason>`` (the reason is mandatory,
and the waiver must keep suppressing a live finding — WAIVER-002).
"""

from __future__ import annotations

from .engine import (
    REGISTRY,
    Finding,
    Module,
    Report,
    Rule,
    all_rule_ids,
    analyze_paths,
    analyze_source,
    parse_module,
    register,
)

__all__ = [
    "REGISTRY",
    "Finding",
    "Module",
    "Report",
    "Rule",
    "all_rule_ids",
    "analyze_paths",
    "analyze_source",
    "parse_module",
    "register",
]
