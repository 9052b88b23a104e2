"""AWAIT-001 / ACK-001 / FENCE-001: async-atomicity and ack-ordering.

The last two robustness PRs each shipped an interleaving bug that only
hand review caught, and both were instances of mechanical bug classes:

- **The live-split bug**: ``verify_proof`` checked ownership at entry,
  awaited the batcher, then minted the session — a live split's
  export→copy→map-flip runs synchronously on the event loop and can
  land inside *any* await, so the mint acked a write on a partition
  that no longer owned the user, and the drain then dropped it.  Fixed
  by the write-time owner fence (``ServerState.owner_fence``) re-checked
  inside the shard lock, with the handler answering
  ``errors.WrongPartition`` with the standard redirect.
- **The handover bug**: ordering a protocol step wrong
  relative to the fence/ack watermark — a fenced primary serving
  challenges locally stranded every in-flight login for the drain
  window.

These rules machine-check the repaired shapes over the await-point
dataflow (``analysis/flows.py``, the v3 extension of the execution-
context inference):

``AWAIT-001`` — a guard read (``owns()`` / ``_check_owner`` /
``_wrong_partition*`` / an admission verdict / an epoch compare /
a fence call) followed by a suspension point followed by a user-keyed
mutation the guard licensed, with no re-check after the last await.
Accepted evidence that the mutation re-verifies at write time: a fence
or guard re-read after the last await before the mutation; the call
site lexically inside a ``try`` that catches ``WrongPartition`` (the
callee's write-time fence outcome is handled — the repaired handler
shape); or an in-module callee whose own flow contains a fence event.

``ACK-001`` — in any ``async def`` that mutates through one of
``ServerState``'s six insert/remove funnels, every acknowledgement the
caller can observe (an explicit ``return`` after the mutation, a
``Future.set_result``, or falling off the end) must be dominated by a
journal event (``_journal_append`` / ``_journal_sync`` / an ``append``
on a journal/WAL receiver) that follows the last funnel call —
acked-before-durable is unreachable by construction.

``FENCE-001`` — every funnel call inside an ``async`` method of a class
named ``ServerState`` must have a write-time fence re-check
(``self._fence(...)`` / ``owner_fence``) *earlier in the same
lock-acquiring ``with`` block*.  Reads and ``consume_challenges`` stay
unfenced on purpose and carry explicit waivers with the live-split
rationale: removing a stale copy the split already exported cannot lose
an acknowledged write, and leaving the consume unfenced lets an
in-flight login retry at the new owner with its challenge intact there.

Like every cpzk-lint rule the analysis is a per-module linearization —
branch structure is flattened and the horizon is the module boundary.
"""

from __future__ import annotations

import ast

from ..engine import Finding, Module, Rule, register
from ..flows import FuncFlow


def _inmodule_fenced(module: Module, callee: str) -> bool:
    """Whether a call target resolves to a function in this module whose
    own flow re-checks the fence (covers in-module mutator wrappers)."""
    for flow in module.flows.values():
        if flow.name == callee and flow.has_fence:
            return True
    return False


@register
class AwaitAtomicity(Rule):
    id = "AWAIT-001"
    summary = (
        "no user-keyed mutation on a guard read that an await has "
        "invalidated — re-check ownership at write time"
    )
    rationale = (
        "a live split's export→copy→map-flip (and a handover's write "
        "fence) runs between awaits, so an ownership/admission/epoch "
        "verdict read before a suspension point is stale when the "
        "handler resumes — exactly the PR 16 VerifyProof bug, where the "
        "batcher await straddled the flip and the mint acked a write "
        "the partition no longer owned.  Re-check inside the shard lock "
        "(owner_fence/_fence), re-run the guard after the last await, "
        "or handle errors.WrongPartition at the mutation call site"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for flow in module.flows.values():
            if not flow.is_async:
                continue
            self._check_flow(module, flow, out)
        return out

    def _check_flow(
        self, module: Module, flow: FuncFlow, out: list[Finding]
    ) -> None:
        events = flow.events
        for m in events:
            if m.kind != "mutate":
                continue
            awaits_before = [
                a for a in events if a.kind == "await" and a.order < m.order
            ]
            if not awaits_before:
                continue
            a_last = awaits_before[-1]
            licensed = [
                g for g in events
                if g.kind == "guard" and g.order < a_last.order
            ]
            if not licensed:
                continue  # nothing licensed the mutation before the await
            rechecked = any(
                g.kind == "guard" and a_last.order < g.order < m.order
                for g in events
            )
            if rechecked or m.wp:
                continue
            if _inmodule_fenced(module, m.name):
                continue
            g = licensed[-1]
            out.append(self.finding(
                module, m.node,
                f"{flow.name} mutates user-keyed state via {m.name}() "
                f"after an await (line {a_last.node.lineno}) that "
                f"invalidated the {g.name} guard read at line "
                f"{g.node.lineno} — a live split's map flip can land in "
                "that await; re-check ownership after the await "
                "(owner_fence/_fence inside the shard lock) or handle "
                "errors.WrongPartition at this call",
            ))


@register
class AckAfterDurable(Rule):
    id = "ACK-001"
    summary = (
        "a funnel mutation's journal append/sync must dominate every "
        "acknowledgement path out of the function"
    )
    rationale = (
        "the durability contract acks a mutation only after its WAL "
        "record is appended (under the mutating shard's lock) and "
        "synced — a return or Future.set_result that a caller can "
        "observe before the journal event acknowledges a write a crash "
        "can still lose, which the zero-acked-write-loss invariant "
        "(chaos suite, model checker) forbids by construction"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for flow in module.flows.values():
            if not flow.is_async:
                continue
            funnels = [e for e in flow.events if e.is_funnel]
            if not funnels:
                continue
            for ack in flow.events:
                if ack.kind != "ack":
                    continue
                mutated = [f for f in funnels if f.order < ack.order]
                if not mutated:
                    continue
                m_last = mutated[-1]
                journaled = any(
                    e.kind == "journal"
                    and m_last.order < e.order < ack.order
                    for e in flow.events
                )
                if journaled:
                    continue
                how = (
                    "falls off the end" if ack.name == "end"
                    else f"acks via {ack.name}" if ack.name != "return"
                    else "returns"
                )
                out.append(self.finding(
                    module, ack.node if ack.name != "end" else m_last.node,
                    f"{flow.name} {how} after the {m_last.name}() "
                    f"mutation at line {m_last.node.lineno} with no "
                    "journal append/sync in between — acked-before-"
                    "durable; append the record under the shard lock "
                    "and await _journal_sync() before acknowledging",
                ))
        return out


@register
class WriteFence(Rule):
    id = "FENCE-001"
    summary = (
        "ServerState funnel mutations carry the owner_fence re-check "
        "inside their shard-lock section"
    )
    rationale = (
        "the entry-point ownership check alone cannot fence multi-await "
        "handlers across a live split's map flip (PR 16): only a fence "
        "re-checked synchronously inside the shard lock, in the same "
        "critical section as the mutation, is totally ordered against "
        "the flip.  Reads and consume_challenges stay unfenced on "
        "purpose (waived with the rationale): removing a stale copy the "
        "split already exported cannot lose an acked write, and an "
        "unfenced consume lets an in-flight login retry at the new "
        "owner with its challenge intact there"
    )

    def check(self, module: Module) -> list[Finding]:
        out: list[Finding] = []
        for flow in module.flows.values():
            if not flow.is_async or flow.cls != "ServerState":
                continue
            for m in flow.events:
                if not m.is_funnel:
                    continue
                if m.lock is None:
                    out.append(self.finding(
                        module, m.node,
                        f"{flow.name} calls {m.name}() outside any "
                        "lock-acquiring with-block — the write-time "
                        "owner fence must run inside the mutating "
                        "shard's lock section (PR 16)",
                    ))
                    continue
                fenced = any(
                    e.is_fence and e.lock == m.lock and e.order < m.order
                    for e in flow.events
                )
                if fenced:
                    continue
                out.append(self.finding(
                    module, m.node,
                    f"{flow.name} calls {m.name}() with no owner_fence/"
                    "_fence re-check earlier in the same shard-lock "
                    "section — a handler resuming after a live split's "
                    "map flip acks a write this partition no longer "
                    "owns (PR 16); call self._fence(user_id) under the "
                    "lock before the funnel, or waive with the "
                    "documented read/consume rationale",
                ))
        return out
