"""Explicit-state model checking for the fence/handover/split protocols.

The static rules (AWAIT-001/ACK-001/FENCE-001) check *code shapes*; this
module checks the *protocols themselves*: small hand-written state
machines of the three distributed-operations protocols this repo ships,
explored exhaustively (BFS over every interleaving of protocol steps,
client actions, and crash points) in the spirit of TLA+-style explicit-
state checking — no external dependencies, states are flat dicts, a
counterexample is a readable step-by-step interleaving.

The three models, each faithful to its implementation and to the chaos
suite's crash-point semantics:

- :class:`FailoverModel` — lease failover + epoch fencing (the replication plane):
  sync-barrier replication, lease expiry on death or partition, standby
  promotion at epoch+1, stale-epoch ship fencing, and the
  ``REPLICATION_CRASH_POINTS`` (``pre_ship`` / ``mid_segment`` /
  ``pre_promote``).
- :class:`SplitModel` — the live split's decide/commit/rollback with
  the write-time owner fence (the split plane): atomic export→copy→map-flip, a
  multi-await VerifyProof-shaped handler that can straddle the flip,
  crash-resume at every ``FLEET_CRASH_POINTS`` stage, and the drain
  that destroys the source's stale copies.
- :class:`HandoverModel` — the coordinated handover incl. the challenge
  create/consume redirect (the handover plane): fence → ship-tail-at-watermark →
  promote → deposed, abort-to-serving on every pre-promote crash
  (``HANDOVER_CRASH_POINTS``), and a login flow (mint + consume) that
  must never strand.

Invariants (checked in every reachable state):

- **no-split-brain** — never two epoch-equal primaries accepting
  (acking) writes;
- **no-acked-write-loss** — an acknowledged write exists on the node
  that owns it, across every crash point in the ``FaultPlan``
  registries;
- **no-stranded-login** — every minted, unconsumed challenge is
  consumable on some node that serves (or will again serve) it.

**Validated by mutation**: re-introducing the two bugs the last
robustness PRs actually shipped must each produce a counterexample —
``--model split --mutate drop_write_fence`` (the live-split bug: the mint after the
batcher await acks onto a stale copy the drain then destroys) and
``--model handover --mutate serve_fenced_challenges`` (the handover bug: a fenced
primary minting challenges locally strands the login once the standby
is promoted).  CI runs both with ``--expect-violation``.

CLI::

    python -m cpzk_tpu_torch.analysis.model [--model all|failover|split|handover]
        [--mutate NAME] [--expect-violation] [--max-states N]
        [--max-depth N] [--list] [--quiet]

Exit codes: 0 — every requested model clean (or a counterexample found
under ``--expect-violation``); 1 — violation (or an expected violation
that did not appear); 2 — usage error.  See docs/operations.md for the
counterexample reading guide.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import deque
from dataclasses import dataclass, field

from ..resilience.faults import (
    FLEET_CRASH_POINTS,
    HANDOVER_CRASH_POINTS,
    REPLICATION_CRASH_POINTS,
)

#: Bounded client traffic per model run — two writes is enough to
#: distinguish "acked prefix" from "everything" in every protocol here.
MAX_WRITES = 2

State = dict
Frozen = tuple


def freeze(state: State) -> Frozen:
    return tuple(sorted(state.items()))


def thaw(frozen: Frozen) -> State:
    return dict(frozen)


class Model:
    """One protocol state machine.  Subclasses define ``initial()``,
    ``actions(state)`` (yielding ``(label, next_state)``), and
    ``invariants()`` (``(name, predicate)`` pairs).  ``crash_points``
    names the FaultPlan registry entries this model explores — each must
    appear as a ``crash:<point>`` transition label (the drift guard in
    tests/test_torch_model_checker.py holds the registries to this)."""

    name = ""
    description = ""
    crash_points: tuple[str, ...] = ()
    #: mutation name -> the bug it re-introduces (for --list and errors)
    mutations: dict[str, str] = {}

    def __init__(self, mutation: str | None = None):
        if mutation is not None and mutation not in self.mutations:
            known = ", ".join(sorted(self.mutations)) or "none"
            raise ValueError(
                f"model {self.name!r} has no mutation {mutation!r} "
                f"(known: {known})"
            )
        self.mutation = mutation

    def initial(self) -> State:
        raise NotImplementedError

    def actions(self, s: State) -> list[tuple[str, State]]:
        raise NotImplementedError

    def invariants(self) -> list[tuple[str, "callable"]]:
        raise NotImplementedError

    def render(self, s: State) -> str:
        return " ".join(f"{k}={v}" for k, v in sorted(s.items()))


@dataclass
class Violation:
    invariant: str
    state: Frozen
    #: the interleaving from the initial state: (label, state) per step;
    #: step 0 is ("initial", initial_state)
    trace: list[tuple[str, Frozen]]


@dataclass
class CheckResult:
    model: Model
    states: int = 0
    transitions: int = 0
    depth: int = 0
    elapsed_s: float = 0.0
    complete: bool = False       # frontier exhausted within the bounds
    labels: set = field(default_factory=set)
    violation: Violation | None = None

    @property
    def ok(self) -> bool:
        return self.violation is None


def check(
    model: Model, max_states: int = 500_000, max_depth: int = 500,
) -> CheckResult:
    """Exhaustive BFS over the model's reachable states.  Stops at the
    first invariant violation (BFS order makes the counterexample a
    shortest trace) or when the frontier is exhausted."""
    t0 = time.monotonic()
    result = CheckResult(model=model)
    invs = model.invariants()

    def violated(fs: Frozen) -> str | None:
        s = thaw(fs)
        for name, pred in invs:
            if not pred(s):
                return name
        return None

    init = freeze(model.initial())
    parents: dict[Frozen, tuple[Frozen, str] | None] = {init: None}
    depth_of = {init: 0}
    queue: deque[Frozen] = deque([init])
    result.states = 1

    def trace_to(fs: Frozen) -> list[tuple[str, Frozen]]:
        steps: list[tuple[str, Frozen]] = []
        cur: Frozen | None = fs
        while cur is not None:
            link = parents[cur]
            if link is None:
                steps.append(("initial", cur))
                break
            prev, label = link
            steps.append((label, cur))
            cur = prev
        steps.reverse()
        return steps

    bad = violated(init)
    if bad is not None:
        result.violation = Violation(bad, init, trace_to(init))
        result.elapsed_s = time.monotonic() - t0
        return result

    complete = True
    while queue:
        fs = queue.popleft()
        d = depth_of[fs]
        result.depth = max(result.depth, d)
        if d >= max_depth:
            complete = False
            continue
        for label, nxt in model.actions(thaw(fs)):
            result.transitions += 1
            result.labels.add(label)
            nfs = freeze(nxt)
            if nfs in parents:
                continue
            if len(parents) >= max_states:
                complete = False
                continue
            parents[nfs] = (fs, label)
            depth_of[nfs] = d + 1
            result.states += 1
            bad = violated(nfs)
            if bad is not None:
                result.violation = Violation(bad, nfs, trace_to(nfs))
                result.elapsed_s = time.monotonic() - t0
                return result
            queue.append(nfs)
    result.complete = complete
    result.elapsed_s = time.monotonic() - t0
    return result


def render_trace(result: CheckResult) -> str:
    """A counterexample as a readable step-by-step interleaving (the
    format the docs/operations.md reading guide documents)."""
    v = result.violation
    model = result.model
    if v is None:
        return (
            f"model {model.name!r}: no counterexample — {result.states} "
            f"states, {result.transitions} transitions, depth "
            f"{result.depth}, invariants hold"
        )
    lines = [
        f"counterexample: invariant '{v.invariant}' violated in model "
        f"'{model.name}'"
        + (f" (mutation: {model.mutation})" if model.mutation else ""),
        f"  shortest trace, {len(v.trace) - 1} steps:",
    ]
    prev: State | None = None
    for i, (label, fs) in enumerate(v.trace):
        s = thaw(fs)
        if prev is None:
            lines.append(f"  step {i}: {label}")
            lines.append(f"      {model.render(s)}")
        else:
            changed = {
                k: v2 for k, v2 in s.items() if prev.get(k) != v2
            }
            delta = (
                " ".join(f"{k}={v2}" for k, v2 in sorted(changed.items()))
                or "(no state change)"
            )
            lines.append(f"  step {i}: {label}")
            lines.append(f"      -> {delta}")
        prev = s
    lines.append(f"  violated: {v.invariant}")
    lines.append(f"      full state: {model.render(thaw(v.state))}")
    return "\n".join(lines)


# -- model 1: lease failover + epoch fencing ---------------------------------


class FailoverModel(Model):
    """Primary/standby pair under sync-barrier replication.

    A write is acknowledged only after the standby applied it (the
    ``attach_replication_barrier`` contract), the standby promotes at
    ``epoch+1`` when the lease expires (primary dead OR partitioned),
    and a healed old primary's ships and renewals are answered
    ``fenced: stale epoch`` — after which it stops acking.  The crash
    points are the REPLICATION registry: ``pre_ship`` (primary dies
    before a segment leaves), ``mid_segment`` (torn segment, rejected
    whole), ``pre_promote`` (standby dies at the promotion decision —
    a retried promote must succeed)."""

    name = "failover"
    description = "lease failover + epoch fencing"
    crash_points = REPLICATION_CRASH_POINTS
    mutations = {}

    def initial(self) -> State:
        return {
            "p_alive": True,      # primary process up
            "p_conn": True,       # primary reachable from the standby
            "p_fenced": False,    # primary observed a stale-epoch answer
            "p_epoch": 1,
            "p_log": 0,           # writes applied on the primary
            "p_known": 0,         # standby-applied seq the primary knows
            "acked": 0,           # writes acknowledged to clients
            "s_applied": 0,       # writes applied on the standby
            "s_role": "standby",
            "s_epoch": 1,
            "s_rebooted": False,  # pre_promote crash happened (retry ok)
            "lease_expired": False,
        }

    def actions(self, s: State) -> list[tuple[str, State]]:
        out: list[tuple[str, State]] = []

        def step(label: str, **upd) -> None:
            out.append((label, {**s, **upd}))

        p_serving = s["p_alive"] and not s["p_fenced"]
        # clients write to the primary while it serves (a partitioned
        # primary still appends — the sync barrier withholds the ack)
        if p_serving and s["p_log"] < MAX_WRITES:
            step("client:write", p_log=s["p_log"] + 1)
        # replication: ship the next unapplied write to the standby
        if p_serving and s["p_conn"] and s["p_log"] > s["s_applied"]:
            if s["p_epoch"] >= s["s_epoch"]:
                step(
                    "repl:ship",
                    s_applied=s["s_applied"] + 1,
                    p_known=s["s_applied"] + 1,
                )
            else:
                # promoted standby fences the stale epoch; the primary
                # observes it and stops acking (shipper.fenced)
                step("repl:fenced", p_fenced=True)
            step("crash:pre_ship", p_alive=False)
            step("crash:mid_segment", p_alive=False)
        # the sync barrier: ack only writes the primary KNOWS the
        # standby applied (knowledge travels with ship acks)
        if p_serving and s["acked"] < min(s["p_log"], s["p_known"]):
            step("client:ack", acked=s["acked"] + 1)
        # the network partitions (renewals stop) or heals
        if s["p_alive"] and s["p_conn"]:
            step("net:partition", p_conn=False)
        if s["p_alive"] and not s["p_conn"]:
            step("net:heal", p_conn=True)
        # lease expiry: primary dead or unreachable
        if not s["lease_expired"] and (not s["p_alive"] or not s["p_conn"]):
            step("lease:expire", lease_expired=True)
        # promotion (and the standby-side crash at the decision)
        if s["lease_expired"] and s["s_role"] == "standby":
            step(
                "standby:promote",
                s_role="primary", s_epoch=s["p_epoch"] + 1,
            )
            if not s["s_rebooted"]:
                step("crash:pre_promote", s_rebooted=True)
        # the promoted standby serves new writes itself (bounded with
        # the same budget; they apply locally so nothing can be lost)
        if s["s_role"] == "primary" and s["s_applied"] < MAX_WRITES:
            step("client:write_new_primary", s_applied=s["s_applied"] + 1)
        return out

    def invariants(self):
        def no_split_brain(s: State) -> bool:
            p_acking = s["p_alive"] and s["p_conn"] and not s["p_fenced"]
            s_acking = s["s_role"] == "primary"
            return not (p_acking and s_acking and s["p_epoch"] == s["s_epoch"])

        def acked_writes_survive(s: State) -> bool:
            # every acked write is applied on the standby — so promotion
            # at any crash point serves the full acked prefix
            return s["acked"] <= s["s_applied"]

        def promote_bumps_epoch(s: State) -> bool:
            return s["s_role"] != "primary" or s["s_epoch"] > s["p_epoch"]

        return [
            ("no-split-brain", no_split_brain),
            ("no-acked-write-loss", acked_writes_survive),
            ("promotion-bumps-epoch", promote_bumps_epoch),
        ]


# -- model 2: live split + write-time owner fence -----------------------------


class SplitModel(Model):
    """The live split against one multi-await handler.

    The split runner walks idle → manifest → (atomic export→copy→flip)
    → drain → finish; a VerifyProof-shaped handler checks ownership at
    entry, suspends in the batcher, then mints — the mint's write-time
    fence (checked synchronously inside the shard lock) is what keeps
    an interleaved flip from acking onto the source's stale copy that
    the drain then destroys.  A crash at any FLEET_CRASH_POINTS stage
    leaves the standard resumable manifest; ``recover:resume`` is the
    offline ``fleet split`` completion.

    Mutation ``drop_write_fence`` re-introduces the live-split bug: the mint
    after the batcher await no longer re-checks ownership."""

    name = "split"
    description = "live split decide/commit/rollback + write fence"
    crash_points = FLEET_CRASH_POINTS
    mutations = {
        "drop_write_fence": (
            "the live-split bug: the post-await session mint skips the write-time "
            "owner fence, acking onto the source's stale copy"
        ),
    }

    def initial(self) -> State:
        return {
            "stage": "idle",      # split file-state (manifest/copy/flip)
            "crashed": False,     # the source daemon died at a crash point
            "owner": "S",         # partition-map owner of the moved user
            "h": "start",         # the in-flight VerifyProof handler
            "acked": False,       # the handler's mint was acknowledged
            "home": "none",       # where the acked record lives (S or T)
            "lost": False,        # an acked record was destroyed
        }

    def actions(self, s: State) -> list[tuple[str, State]]:
        out: list[tuple[str, State]] = []

        def step(label: str, **upd) -> None:
            out.append((label, {**s, **upd}))

        # -- the handler (runs on the source daemon's event loop) ----------
        if not s["crashed"]:
            if s["h"] == "start":
                if s["owner"] == "S":
                    step("handler:check_owner", h="checked")
                else:
                    step("handler:entry_redirect", h="redirected")
            elif s["h"] == "checked":
                step("handler:await_batcher", h="awaiting")
            elif s["h"] == "awaiting":
                if self.mutation == "drop_write_fence":
                    # the bug: mint without re-checking ownership — the
                    # record lands in the source's store regardless
                    step("handler:mint_unfenced", h="acked",
                         acked=True, home="S")
                elif s["owner"] == "S":
                    step("handler:mint_fenced_ok", h="acked",
                         acked=True, home="S")
                else:
                    # owner_fence inside the shard lock: WrongPartition,
                    # answered with the standard redirect — no ack
                    step("handler:fence_redirect", h="redirected")

        # -- the split runner (live; no awaits inside the cut) -------------
        if not s["crashed"]:
            if s["stage"] == "idle":
                step("split:start", stage="manifest")
                step("crash:pre_manifest", crashed=True, h=_dead(s))
            elif s["stage"] == "manifest":
                step(
                    "split:cut", stage="flipped", owner="T",
                    home="T" if s["home"] == "S" else s["home"],
                )
                step("crash:pre_copy", crashed=True, h=_dead(s))
                step("crash:mid_copy", crashed=True, stage="mid_copy",
                     h=_dead(s))
                step("crash:pre_flip", crashed=True, stage="copied",
                     h=_dead(s))
            elif s["stage"] == "flipped":
                step(
                    "split:drain", stage="drained",
                    lost=s["lost"] or (s["acked"] and s["home"] == "S"),
                )
                step("crash:pre_drain", crashed=True, h=_dead(s))
            elif s["stage"] == "drained":
                step("split:finish", stage="done")
                step("crash:pre_finish", crashed=True, h=_dead(s))

        # -- crash-resume: the offline `fleet split` completion ------------
        if s["crashed"]:
            if s["stage"] == "idle":
                # pre_manifest: nothing armed; reboot serves as before
                step("recover:reboot", crashed=False)
            elif s["stage"] in ("manifest", "mid_copy", "copied"):
                # manifest exists: resume (re)copies from the source's
                # durable store — which holds every acked record — then
                # flips, drains, finishes
                step(
                    "recover:resume", crashed=False, stage="done",
                    owner="T",
                    home="T" if s["home"] == "S" else s["home"],
                )
            elif s["stage"] in ("flipped", "drained"):
                # post-flip: resume completes drain + finish; the drain
                # destroys the source's stale copies
                step(
                    "recover:resume", crashed=False, stage="done",
                    lost=s["lost"] or (
                        s["stage"] == "flipped"
                        and s["acked"] and s["home"] == "S"
                    ),
                )
        return out

    def invariants(self):
        def no_acked_write_loss(s: State) -> bool:
            return not s["lost"]

        def acked_on_owner(s: State) -> bool:
            # an acknowledged write lives on the partition that owns the
            # user — a mint onto a stale copy violates this immediately,
            # before the drain even destroys it
            return (not s["acked"]) or s["lost"] or s["home"] == s["owner"]

        return [
            ("no-acked-write-loss", no_acked_write_loss),
            ("acked-on-owner", acked_on_owner),
        ]


def _dead(s: State) -> str:
    """A daemon crash kills the in-flight handler; a delivered ack stays
    delivered (the client already has it)."""
    return "acked" if s["h"] == "acked" else "dead"


# -- model 3: coordinated handover + challenge redirect -----------------------


class HandoverModel(Model):
    """Coordinated primary→standby handover against one login flow.

    The primary walks serving → fenced → tail_shipped → promote →
    deposed; every pre-promote crash point aborts back to serving with
    the fence rolled back (degrading to ordinary lease failover), and
    ``post_handover_promote`` leaves the standby promoted and the old
    primary deposed.  Challenges minted on the serving primary are on
    the standby too (the sync ack barrier); a *fenced* primary must
    redirect challenge traffic — the handover bug (mutation
    ``serve_fenced_challenges``) is minting locally instead, which
    strands the login: the challenge is beyond the fence watermark, so
    the promoted standby never has it and the deposed primary never
    serves the consume."""

    name = "handover"
    description = (
        "coordinated handover incl. challenge create/consume redirect"
    )
    crash_points = HANDOVER_CRASH_POINTS
    mutations = {
        "serve_fenced_challenges": (
            "the handover bug: a fenced primary serves challenge mints locally "
            "instead of redirecting, stranding in-flight logins"
        ),
    }

    def initial(self) -> State:
        return {
            "p": "serving",       # serving|fenced|tail_shipped|deposed
            "p_crashed": False,
            "p_epoch": 1,
            "s_role": "standby",
            "s_epoch": 1,
            "minted": False,      # the login's challenge was minted
            "ch_on_p": False,
            "ch_on_s": False,
            "consumed": False,    # the login completed
            "w_acked": False,     # one ordinary write, for ack-loss
            "w_on_s": False,
        }

    def actions(self, s: State) -> list[tuple[str, State]]:
        out: list[tuple[str, State]] = []

        def step(label: str, **upd) -> None:
            out.append((label, {**s, **upd}))

        p_up = not s["p_crashed"]
        # -- the handover protocol (primary side) --------------------------
        if p_up and s["s_role"] == "standby":
            if s["p"] == "serving":
                step("handover:fence", p="fenced")
                step("crash:pre_handover_fence")  # nothing armed: no-op
            elif s["p"] == "fenced":
                step("handover:ship_tail", p="tail_shipped")
                # abort: fence rolled back, pair unchanged
                step("crash:post_handover_fence", p="serving")
            elif s["p"] == "tail_shipped":
                step(
                    "handover:promote", p="deposed",
                    s_role="primary", s_epoch=s["p_epoch"] + 1,
                )
                step("crash:pre_handover_promote", p="serving")
                step("crash:pre_handover_ack", p="serving")
                step(
                    "crash:post_handover_promote", p="deposed",
                    p_crashed=True,
                    s_role="primary", s_epoch=s["p_epoch"] + 1,
                )
        # an unplanned death mid-operation degrades to lease failover
        if p_up and s["p"] in ("serving", "fenced"):
            step("die:primary", p_crashed=True)
        if s["p_crashed"] and s["s_role"] == "standby":
            step(
                "failover:promote",
                s_role="primary", s_epoch=s["p_epoch"] + 1,
            )

        # -- the login flow (one challenge, mint then consume) -------------
        if not s["minted"]:
            if p_up and s["p"] == "serving" and s["s_role"] == "standby":
                # sync barrier: the mint ack implies the standby has it
                step("client:mint", minted=True, ch_on_p=True, ch_on_s=True)
            elif p_up and s["p"] == "fenced":
                if self.mutation == "serve_fenced_challenges":
                    # the bug: minted beyond the fence watermark — the
                    # shipped tail will never carry it to the standby
                    step("client:mint_on_fenced", minted=True, ch_on_p=True)
                # fixed behavior: _wrong_partition redirects BEFORE the
                # create — the client retries at the new primary
            elif s["s_role"] == "primary":
                step("client:mint", minted=True, ch_on_s=True)
        if s["minted"] and not s["consumed"]:
            if p_up and s["p"] == "serving" and s["ch_on_p"]:
                step("client:consume", consumed=True)
            elif s["s_role"] == "primary" and s["ch_on_s"]:
                step("client:consume", consumed=True)

        # -- one ordinary acked write, for the ack-loss invariant ----------
        if not s["w_acked"]:
            if p_up and s["p"] == "serving" and s["s_role"] == "standby":
                step("client:write", w_acked=True, w_on_s=True)
            elif s["s_role"] == "primary":
                step("client:write", w_acked=True, w_on_s=True)
        return out

    def invariants(self):
        def no_split_brain(s: State) -> bool:
            p_accepting = not s["p_crashed"] and s["p"] == "serving"
            return not (
                p_accepting and s["s_role"] == "primary"
                and s["s_epoch"] <= s["p_epoch"]
            ) and not (p_accepting and s["s_role"] == "primary")

        def no_acked_write_loss(s: State) -> bool:
            return (not s["w_acked"]) or s["w_on_s"] or (
                not s["p_crashed"] and s["p"] in ("serving", "fenced")
            )

        def no_stranded_login(s: State) -> bool:
            if not s["minted"] or s["consumed"]:
                return True
            # the primary serves (or can abort back to serving) its copy
            p_can_serve = not s["p_crashed"] and s["p"] != "deposed"
            # the standby serves its copy now or after promotion
            consumable = (
                (s["ch_on_p"] and p_can_serve) or s["ch_on_s"]
            )
            return consumable

        return [
            ("no-split-brain", no_split_brain),
            ("no-acked-write-loss", no_acked_write_loss),
            ("no-stranded-login", no_stranded_login),
        ]


MODELS: dict[str, type[Model]] = {
    m.name: m for m in (FailoverModel, SplitModel, HandoverModel)
}


# -- CLI ----------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cpzk-model",
        description="explicit-state model checker for the fence/"
        "handover/split protocols (BFS over every interleaving)",
    )
    p.add_argument(
        "--model", default="all",
        choices=("all", *sorted(MODELS)),
        help="which protocol model to check (default: all)",
    )
    p.add_argument(
        "--mutate", default=None, metavar="NAME",
        help="re-introduce a known bug into the model (requires a "
        "single --model); see --list",
    )
    p.add_argument(
        "--expect-violation", action="store_true",
        help="invert the exit code: succeed only if a counterexample "
        "is found (the mutation-validation mode CI runs)",
    )
    p.add_argument("--max-states", type=int, default=500_000)
    p.add_argument("--max-depth", type=int, default=500)
    p.add_argument(
        "--list", action="store_true",
        help="list models, their crash points and mutations, and exit",
    )
    p.add_argument(
        "--quiet", action="store_true",
        help="suppress per-model statistics (violations still print)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list:
        for name in sorted(MODELS):
            cls = MODELS[name]
            print(f"{name}: {cls.description}")
            print(f"  crash points: {', '.join(cls.crash_points)}")
            for mut, desc in sorted(cls.mutations.items()):
                print(f"  mutation {mut}: {desc}")
        return 0
    if args.mutate is not None and args.model == "all":
        print(
            "--mutate requires a single --model "
            "(the mutation names a specific protocol bug)",
            file=sys.stderr,
        )
        return 2
    names = sorted(MODELS) if args.model == "all" else [args.model]
    worst = 0
    for name in names:
        try:
            model = MODELS[name](mutation=args.mutate)
        except ValueError as e:
            print(f"cpzk-model: {e}", file=sys.stderr)
            return 2
        result = check(
            model, max_states=args.max_states, max_depth=args.max_depth,
        )
        if result.violation is not None:
            print(render_trace(result))
            if not args.expect_violation:
                worst = max(worst, 1)
        else:
            if not args.quiet:
                print(
                    f"model {name}: {result.states} states, "
                    f"{result.transitions} transitions, depth "
                    f"{result.depth}, "
                    f"{'exhaustive' if result.complete else 'BOUNDED'}, "
                    f"invariants hold ({result.elapsed_s:.2f}s)"
                )
            if args.expect_violation:
                print(
                    f"model {name}: expected a counterexample under "
                    f"mutation {args.mutate!r} but every invariant held "
                    "— the checker would miss the bug this mutation "
                    "re-introduces",
                    file=sys.stderr,
                )
                worst = max(worst, 1)
            if not result.complete and not args.expect_violation:
                print(
                    f"model {name}: exploration hit the "
                    f"--max-states/--max-depth bound before exhausting "
                    "the state space — raise the bounds",
                    file=sys.stderr,
                )
                worst = max(worst, 1)
    return worst


if __name__ == "__main__":
    sys.exit(main())
