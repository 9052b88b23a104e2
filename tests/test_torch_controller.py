"""Twins of ``tests/test_controller.py`` for the port's fleet controller
(``cpzk_tpu_torch/fleet/controller.py``), class by class under the
reference's names: the split, lane and admission decision matrices driven
through ``decide`` with hand-built ``Signals`` and a fake clock, the
dry-run parity contract, the live actuators and their rollback, the live
split (also under concurrent traffic), the write-time owner fence, signal
collection, the ingest crash-loop guard, the client's herd damping and the
``[controller]`` config surface.  The four full-scale storm legs stay
``slow``, as in the reference, and run in process here.

Beyond the twins: the port's controller and the reference's, fed the same
seeded signal stream on the same clock, make the same decisions; and a
live split that moves more users than the default capacity cap keeps every
one of them.
"""

import asyncio
import os
import random

import pytest

from cpzk_tpu_torch import Parameters, Prover, SecureRng, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.fleet import FleetRouter, PartitionMap
from cpzk_tpu_torch.fleet.controller import (
    ACTION_ADMISSION_RESTORE,
    ACTION_ADMISSION_SHRINK,
    ACTION_LANE_DRAIN,
    ACTION_LANE_READMIT,
    ACTION_SPLIT,
    DECISION_EVENT,
    FleetController,
    Signals,
    run_live_split,
)
from cpzk_tpu_torch.fleet.split import SplitError, manifest_path
from cpzk_tpu_torch.observability import get_tracer
from cpzk_tpu_torch.server import metrics
from cpzk_tpu_torch.server.config import ControllerSettings, ServerConfig
from cpzk_tpu_torch.server.state import ServerState, UserData

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

rng = SecureRng()
params = Parameters.new()


def run(coro):
    return asyncio.run(coro)


def make_statement():
    return Prover(params, Witness(Ristretto255.random_scalar(rng))).statement


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracer = get_tracer()
    tracer.clear()
    yield
    tracer.clear()


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def make_controller(clock=None, **overrides) -> FleetController:
    """A planeless controller for decide()-level tests: signals are
    injected, actuators never run (decide does not act)."""
    defaults = dict(
        enabled=True, dry_run=True, act_ticks=3, clear_ticks=2,
        split_user_threshold=100, split_lock_wait_ms=50.0,
        split_target_address="127.0.0.1:9", split_cooldown_s=600.0,
        lane_open_after_s=10.0, lane_cooldown_s=30.0,
        admission_cooldown_s=15.0,
    )
    defaults.update(overrides)
    settings = ControllerSettings(**defaults)
    return FleetController(settings, clock=clock or FakeClock(), wall=lambda: 0.0)


def lane(label, breaker="closed", drained=False, pending=0):
    return {"lane": label, "breaker": breaker, "drained": drained,
            "pending": pending}


# --- split hysteresis + cooldown ---------------------------------------------


class TestSplitDecision:
    def test_needs_act_ticks_consecutive_hot_ticks(self):
        c = make_controller()
        hot = Signals(users=150, lock_wait_ms=0.0)
        assert c.decide(hot) == []
        assert c.decide(hot) == []
        out = c.decide(hot)
        assert [d.action for d in out] == [ACTION_SPLIT]
        assert out[0].veto is None
        assert "users 150 >= 100" in out[0].reason

    def test_cold_tick_resets_the_hot_streak(self):
        c = make_controller()
        hot = Signals(users=150)
        cold = Signals(users=10)
        c.decide(hot); c.decide(hot)
        assert c.decide(cold) == []           # streak broken
        c.decide(hot); c.decide(hot)
        assert c.decide(hot)[0].action == ACTION_SPLIT

    def test_lock_wait_trigger(self):
        c = make_controller(split_user_threshold=0)
        hot = Signals(users=5, lock_wait_ms=80.0)
        c.decide(hot); c.decide(hot)
        out = c.decide(hot)
        assert out[0].action == ACTION_SPLIT
        assert "lock_wait 80.0ms >= 50.0ms" in out[0].reason

    def test_cooldown_blocks_the_next_eligible_split(self):
        clock = FakeClock()
        c = make_controller(clock, act_ticks=1)
        assert c.decide(Signals(users=150))[0].veto is None
        out = c.decide(Signals(users=150))
        assert out[0].veto == "cooldown"
        clock.advance(601.0)
        assert c.decide(Signals(users=150))[0].veto is None

    def test_unarmed_controller_never_proposes_a_split(self):
        c = make_controller(split_user_threshold=0, split_lock_wait_ms=0.0)
        for _ in range(5):
            assert c.decide(Signals(users=10 ** 9, lock_wait_ms=1e9)) == []

    def test_never_split_during_promotion(self):
        c = make_controller(act_ticks=1)
        out = c.decide(Signals(users=150, promoting=True))
        assert out[0].action == ACTION_SPLIT
        assert out[0].veto == "promotion"

    def test_never_split_over_an_unfinished_manifest(self):
        c = make_controller(act_ticks=1)
        out = c.decide(Signals(users=150, manifest=True))
        assert out[0].veto == "split-manifest"

    def test_vetoed_split_does_not_arm_the_cooldown(self):
        c = make_controller(act_ticks=1)
        assert c.decide(Signals(users=150, promoting=True))[0].veto == "promotion"
        # promotion over: the very next eligible intent acts (no cooldown
        # was burned on the vetoed one)
        assert c.decide(Signals(users=150))[0].veto is None


# --- lane drain / re-admit hysteresis ----------------------------------------


class TestLaneDecision:
    def test_open_must_persist_before_drain(self):
        clock = FakeClock()
        c = make_controller(clock)
        assert c.decide(Signals(lanes=[lane("0", "open")])) == []
        clock.advance(5.0)
        assert c.decide(Signals(lanes=[lane("0", "open")])) == []
        clock.advance(6.0)  # 11s total >= lane_open_after_s
        out = c.decide(Signals(lanes=[lane("0", "open")]))
        assert [d.action for d in out] == [ACTION_LANE_DRAIN]
        assert out[0].target == "0"
        assert out[0].veto is None

    def test_breaker_reclose_resets_open_persistence(self):
        clock = FakeClock()
        c = make_controller(clock)
        c.decide(Signals(lanes=[lane("0", "open")]))
        clock.advance(8.0)
        c.decide(Signals(lanes=[lane("0", "closed")]))  # recovered
        clock.advance(8.0)
        # re-opened: persistence clock starts over
        assert c.decide(Signals(lanes=[lane("0", "open")])) == []

    def test_readmit_needs_closed_ticks_and_cooldown(self):
        clock = FakeClock()
        c = make_controller(clock, lane_open_after_s=1.0)
        clock.advance(2.0)
        c.decide(Signals(lanes=[lane("0", "open")]))
        clock.advance(2.0)
        assert c.decide(Signals(lanes=[lane("0", "open")]))[0].action == \
            ACTION_LANE_DRAIN
        # drained now; breaker closes through probes but the cooldown
        # has not elapsed
        drained = [lane("0", "closed", drained=True)]
        assert c.decide(Signals(lanes=drained)) == []
        assert c.decide(Signals(lanes=drained)) == []
        clock.advance(31.0)  # past lane_cooldown_s; 2 closed ticks seen
        out = c.decide(Signals(lanes=drained))
        assert [d.action for d in out] == [ACTION_LANE_READMIT]
        assert out[0].veto is None

    def test_still_open_drained_lane_never_readmits(self):
        clock = FakeClock()
        c = make_controller(clock, lane_open_after_s=1.0)
        clock.advance(2.0)
        c.decide(Signals(lanes=[lane("0", "open")]))
        clock.advance(2.0)
        c.decide(Signals(lanes=[lane("0", "open")]))
        clock.advance(100.0)
        for _ in range(10):
            assert c.decide(
                Signals(lanes=[lane("0", "open", drained=True)])
            ) == []


# --- admission bias ----------------------------------------------------------


class FakeAdmission:
    def __init__(self, cap=3.0):
        self.level_cap = cap
        self.calls = []

    def set_level_cap(self, cap):
        self.level_cap = cap
        self.calls.append(cap)
        return cap


class TestAdmissionDecision:
    def test_paging_shrinks_after_act_ticks(self):
        c = make_controller()
        c.admission = FakeAdmission()
        paging = Signals(paging=True)
        assert c.decide(paging) == []
        assert c.decide(paging) == []
        out = c.decide(paging)
        assert [d.action for d in out] == [ACTION_ADMISSION_SHRINK]
        assert out[0].detail == {"cap": 3.0, "new_cap": 2.0}

    def test_clear_restores_after_clear_ticks(self):
        clock = FakeClock()
        c = make_controller(clock)
        c.admission = FakeAdmission(cap=2.0)
        clear = Signals(paging=False)
        assert c.decide(clear) == []
        out = c.decide(clear)
        assert [d.action for d in out] == [ACTION_ADMISSION_RESTORE]
        assert out[0].detail == {"cap": 2.0, "new_cap": 3.0}

    def test_shrink_floor_is_the_verify_tier(self):
        c = make_controller(act_ticks=1)
        c.admission = FakeAdmission(cap=1.0)  # already at MIN_LEVEL
        for _ in range(5):
            assert c.decide(Signals(paging=True)) == []

    def test_full_cap_never_restores(self):
        c = make_controller(clear_ticks=1)
        c.admission = FakeAdmission(cap=3.0)
        for _ in range(5):
            assert c.decide(Signals(paging=False)) == []

    def test_admission_cooldown_spaces_shrinks(self):
        clock = FakeClock()
        c = make_controller(clock, act_ticks=1)
        c.admission = FakeAdmission()
        assert c.decide(Signals(paging=True))[0].veto is None
        c.admission.level_cap = 2.0
        assert c.decide(Signals(paging=True))[0].veto == "cooldown"
        clock.advance(16.0)
        assert c.decide(Signals(paging=True))[0].veto is None


# --- single-action rail ------------------------------------------------------


class TestSingleActionRail:
    def test_second_armed_decision_same_tick_waits(self):
        clock = FakeClock()
        c = make_controller(clock, lane_open_after_s=1.0, act_ticks=1)
        c.admission = FakeAdmission()
        # warm the lane-open persistence
        c.decide(Signals(lanes=[lane("0", "open")]))
        clock.advance(2.0)
        # this tick arms BOTH a lane drain and an admission shrink
        out = c.decide(Signals(lanes=[lane("0", "open")], paging=True))
        assert [d.action for d in out] == [
            ACTION_LANE_DRAIN, ACTION_ADMISSION_SHRINK,
        ]
        assert out[0].veto is None
        assert out[1].veto == "single-action"

    def test_runner_up_keeps_eligibility_and_fires_next_tick(self):
        """REGRESSION (review): only the SELECTED action of a tick may
        consume its cooldown + hysteresis.  The runner-up vetoed as
        ``single-action`` never ran — if arming had already stamped its
        cooldown and reset its hot streak (as it once did inside the
        ``_decide_*`` helpers), the deferred action would re-pay a full
        cooldown plus ``act_ticks`` of re-accumulation for nothing."""
        clock = FakeClock()
        c = make_controller(clock, lane_open_after_s=1.0, act_ticks=2)
        c.admission = FakeAdmission()
        # warm both triggers: paging hot tick 1 of 2, lane-open persistence
        c.decide(Signals(lanes=[lane("0", "open")], paging=True))
        clock.advance(2.0)
        out = c.decide(Signals(lanes=[lane("0", "open")], paging=True))
        assert [d.action for d in out] == [
            ACTION_LANE_DRAIN, ACTION_ADMISSION_SHRINK,
        ]
        assert out[0].veto is None
        assert out[1].veto == "single-action"
        # the vetoed shrink consumed NOTHING: no admission cooldown was
        # stamped, its hot streak survived — it fires on the very next
        # tick instead of waiting out 15 s + 2 fresh hot ticks
        out = c.decide(Signals(paging=True))
        assert [d.action for d in out] == [ACTION_ADMISSION_SHRINK]
        assert out[0].veto is None

    def test_action_in_flight_vetoes_everything(self):
        clock = FakeClock()
        c = make_controller(clock, act_ticks=1, lane_open_after_s=1.0)
        c.admission = FakeAdmission()
        c.decide(Signals(lanes=[lane("0", "open")]))
        clock.advance(2.0)
        c.acting = True
        out = c.decide(
            Signals(users=150, lanes=[lane("0", "open")], paging=True)
        )
        assert len(out) == 3
        assert all(d.veto == "action-in-flight" for d in out)


# --- dry-run parity ----------------------------------------------------------


class FakeRouter:
    def __init__(self, lanes):
        self.rows = lanes
        self.drained = []
        self.readmitted = []

    def lane_states(self):
        return [dict(r) for r in self.rows]

    def drain_lane(self, label):
        self.drained.append(label)
        for r in self.rows:
            if r["lane"] == label:
                r["drained"] = True
        return True

    def readmit_lane(self, label):
        self.readmitted.append(label)
        for r in self.rows:
            if r["lane"] == label:
                r["drained"] = False
        return True


def _scripted(c: FleetController, script):
    """Run tick() over a list of Signals, injecting each via collect."""
    rows = []
    for sig in script:
        c.collect = lambda s=sig: s  # type: ignore[method-assign]
        rows.extend(run(c.tick()))
    return rows


class TestDryRunParity:
    def _script(self):
        hot = lambda: Signals(lanes=[lane("0", "open")], paging=True)  # noqa: E731
        return [hot() for _ in range(6)]

    def test_identical_decision_stream_no_action(self):
        """The parity contract: fed the SAME signal stream on the same
        clock, a dry-run controller and a live controller emit identical
        decisions (action, target, reason, veto) — only ``dry_run`` /
        ``fired`` differ, and only the live one calls an actuator."""
        script = [
            Signals(lanes=[lane("0", "open")], paging=True),
            Signals(lanes=[lane("0", "open")], paging=True),
            Signals(lanes=[lane("0", "open")], paging=False),
            Signals(lanes=[lane("0", "closed")], paging=False),
        ]
        # the admission cap is itself a signal the live actuator mutates,
        # so parity requires pinning the plane: this fake records the
        # actuator calls without changing what the next tick reads
        class PinnedAdmission(FakeAdmission):
            def set_level_cap(self, cap):
                self.calls.append(cap)
                return cap

        decided = {}
        routers = {}
        admissions = {}
        for mode in (True, False):
            clock = FakeClock()
            c = make_controller(
                clock, dry_run=mode, act_ticks=1, lane_open_after_s=1.0,
            )
            router = FakeRouter([lane("0", "open")])
            c.router = router
            c.admission = PinnedAdmission()
            routers[mode] = router
            admissions[mode] = c.admission
            out = []
            for sig in script:
                clock.advance(2.0)
                c.collect = lambda s=sig: s  # type: ignore[method-assign]
                out.extend(run(c.tick()))
            decided[mode] = out
        dry, live = decided[True], decided[False]
        # same decisions in the same order, modulo the mode markers
        assert [(d.action, d.target, d.reason, d.veto) for d in dry] == \
            [(d.action, d.target, d.reason, d.veto) for d in live]
        assert len(dry) > 0
        assert all(d.dry_run for d in dry)
        assert not any(d.dry_run for d in live)
        # dry run provably took no action...
        assert routers[True].drained == []
        assert admissions[True].calls == []
        assert not any(d.fired for d in dry)
        # ...while live mode drove the actuators
        assert routers[False].drained == ["0"]
        assert admissions[False].calls != []
        assert any(d.fired for d in live)

    def test_decision_events_flow_in_both_modes(self):
        for mode in (True, False):
            get_tracer().clear()
            clock = FakeClock()
            c = make_controller(
                clock, dry_run=mode, act_ticks=1, lane_open_after_s=1.0,
            )
            c.router = FakeRouter([lane("0", "open")])
            clock.advance(2.0)
            run(c.tick())
            clock.advance(2.0)
            run(c.tick())
            events = [
                t for t in get_tracer().completed()
                if t.name == DECISION_EVENT
            ]
            assert events, f"no decision events in dry_run={mode}"
            attrs = events[-1].spans[0].attrs
            assert attrs["action"] == ACTION_LANE_DRAIN
            assert attrs["dry_run"] is mode
            assert attrs["fired"] is (not mode)

    def test_status_ring_is_bounded(self):
        c = make_controller(act_ticks=1, decision_ring=4, lane_open_after_s=0.1)
        c.acting = True  # every decision vetoes, none mutate lanes
        clock = c._clock
        for i in range(10):
            c.collect = lambda i=i: Signals(  # type: ignore[method-assign]
                users=150, manifest=True,
            )
            run(c.tick())
        s = c.status()
        assert len(s["decisions"]) <= 4
        assert s["ticks"] == 10


# --- live actuators through tick() -------------------------------------------


class TestLiveActuation:
    def test_lane_drain_then_readmit_through_real_tick(self):
        clock = FakeClock()
        c = make_controller(
            clock, dry_run=False, act_ticks=1, clear_ticks=1,
            lane_open_after_s=1.0, lane_cooldown_s=5.0,
        )
        router = FakeRouter([lane("0", "open"), lane("1", "closed")])
        c.router = router
        run(c.tick())          # open seen, persistence starts
        clock.advance(2.0)
        run(c.tick())          # drain fires
        assert router.drained == ["0"]
        assert c.status()["drained_lanes"] == ["0"]
        # brownout ends: breaker re-closes via its probe traffic
        router.rows[0]["breaker"] = "closed"
        clock.advance(6.0)     # past lane_cooldown_s
        run(c.tick())          # closed tick #1 == clear_ticks -> readmit
        assert router.readmitted == ["0"]
        assert c.status()["drained_lanes"] == []

    def test_admission_cap_applied_and_restored(self):
        clock = FakeClock()
        c = make_controller(
            clock, dry_run=False, act_ticks=1, clear_ticks=1,
            admission_cooldown_s=1.0,
        )
        c.admission = FakeAdmission()
        c.collect = lambda: Signals(paging=True)  # type: ignore[method-assign]
        run(c.tick())
        assert c.admission.calls == [2.0]
        clock.advance(2.0)
        run(c.tick())
        assert c.admission.calls == [2.0, 1.0]
        clock.advance(2.0)
        c.collect = lambda: Signals(paging=False)  # type: ignore[method-assign]
        run(c.tick())
        assert c.admission.calls == [2.0, 1.0, 2.0]

    def test_actuator_error_surfaces_as_veto_and_releases_the_rail(self):
        clock = FakeClock()
        c = make_controller(clock, dry_run=False, act_ticks=1,
                            lane_open_after_s=1.0)

        class BoomRouter(FakeRouter):
            def drain_lane(self, label):
                raise RuntimeError("boom")

        c.router = BoomRouter([lane("0", "open")])
        run(c.tick())
        clock.advance(2.0)
        out = run(c.tick())
        assert out[0].veto.startswith("actuator-error")
        assert not out[0].fired
        assert c.acting is False

    def test_drain_error_rolls_back_and_retries_after_short_backoff(self):
        """REGRESSION (review): an actuator exception must give back the
        cooldown + bookkeeping the commit consumed — the drain never
        happened, so the lane must not read as drained, and the retry
        waits ``error_backoff_s``, not a full action cooldown."""
        clock = FakeClock()
        c = make_controller(clock, dry_run=False, act_ticks=1,
                            lane_open_after_s=1.0, error_backoff_s=5.0)

        class FlakyRouter(FakeRouter):
            broken = True

            def drain_lane(self, label):
                if self.broken:
                    raise RuntimeError("boom")
                return super().drain_lane(label)

        router = FlakyRouter([lane("0", "open")])
        c.router = router
        run(c.tick())                     # open seen, persistence starts
        clock.advance(2.0)
        out = run(c.tick())               # drain fires, actuator raises
        assert out[0].veto.startswith("actuator-error")
        # rollback: the lane is NOT drained, its open persistence survived
        assert c.status()["drained_lanes"] == []
        # ... and the retry is gated on the SHORT error backoff: armed
        # (persistence intact) but cooled within the window
        clock.advance(1.0)
        assert run(c.tick())[0].veto == "cooldown"
        clock.advance(5.0)                # past error_backoff_s
        router.broken = False
        out = run(c.tick())
        assert out[0].fired
        assert router.drained == ["0"]
        assert c.status()["drained_lanes"] == ["0"]

    def test_readmit_error_keeps_the_lane_tracked_as_drained(self):
        clock = FakeClock()
        c = make_controller(clock, dry_run=False, act_ticks=1,
                            clear_ticks=1, lane_open_after_s=1.0,
                            lane_cooldown_s=5.0, error_backoff_s=3.0)

        class FlakyRouter(FakeRouter):
            broken = False

            def readmit_lane(self, label):
                if self.broken:
                    raise RuntimeError("boom")
                return super().readmit_lane(label)

        router = FlakyRouter([lane("0", "open")])
        c.router = router
        run(c.tick())
        clock.advance(2.0)
        run(c.tick())                     # drain fires for real
        assert router.drained == ["0"]
        router.rows[0]["breaker"] = "closed"
        router.broken = True
        clock.advance(6.0)                # past lane_cooldown_s
        out = run(c.tick())               # readmit fires, actuator raises
        assert out[0].veto.startswith("actuator-error")
        # rollback: the lane is STILL drained (the readmit never happened
        # in the router) — forgetting it here would strand it forever
        assert c.status()["drained_lanes"] == ["0"]
        clock.advance(4.0)                # past error_backoff_s
        router.broken = False
        out = run(c.tick())
        assert out[0].fired
        assert router.readmitted == ["0"]
        assert c.status()["drained_lanes"] == []

    def test_split_error_backs_off_short_not_the_full_cooldown(self):
        """A transient split-actuator failure must not burn the 600 s
        split cooldown: the rollback restores the hot streak and arms
        only ``error_backoff_s``."""
        clock = FakeClock()
        c = make_controller(clock, dry_run=False, act_ticks=2,
                            error_backoff_s=5.0)
        # no fleet attached: the split actuator raises on first touch
        c.collect = lambda: Signals(users=150)  # type: ignore[method-assign]
        assert run(c.tick()) == []        # hot tick 1 of 2
        out = run(c.tick())               # hot tick 2: fires, raises
        assert out[0].veto.startswith("actuator-error")
        assert c._split_hot == 2          # rollback kept the streak
        clock.advance(1.0)
        assert run(c.tick())[0].veto == "cooldown"
        clock.advance(5.0)                # past error_backoff_s — 594 s
                                          # BEFORE split_cooldown_s would
                                          # have released it
        out = run(c.tick())
        assert out[0].veto.startswith("actuator-error")  # retried


# --- the live split (fast storm leg: split under concurrent traffic) ---------


async def _seed_live(n_users: int):
    state = ServerState()
    for i in range(n_users):
        await state.register_user(
            UserData(f"user-{i:03d}", make_statement(), 1)
        )
    return state


class TestLiveSplit:
    N = 30

    def test_live_split_disjoint_exhaustive(self, tmp_path):
        async def main():
            from cpzk_tpu_torch.durability.recovery import recover_state

            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            state = await _seed_live(self.N)
            fleet = FleetRouter(PartitionMap.load(map_path), 0,
                                map_path=map_path)
            report = await run_live_split(
                map_path=map_path, source=0, new_address="127.0.0.1:2",
                state=state, fleet=fleet, segment_bytes=512,
            )
            assert report["new_version"] == 2
            assert report["moved_users"] == report["dropped_users"] > 0
            assert fleet.map.version == 2  # adopted in-process
            tgt = ServerState()
            await recover_state(
                tgt, report["target_state_file"],
                report["target_state_file"] + ".wal",
            )
            newmap = PartitionMap.load(map_path)
            live = {u for sh in state._shards for u in sh._users}
            moved = {u for sh in tgt._shards for u in sh._users}
            assert not (live & moved)
            assert live | moved == {f"user-{i:03d}" for i in range(self.N)}
            for uid in live:
                assert newmap.partition_for(uid).index == 0
            for uid in moved:
                assert newmap.partition_for(uid).index == 1
            assert not os.path.exists(manifest_path(map_path))

        run(main())

    def test_live_split_refuses_over_existing_manifest(self, tmp_path):
        async def main():
            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            with open(manifest_path(map_path), "w") as f:
                f.write("{}")
            state = await _seed_live(4)
            with pytest.raises(SplitError, match="manifest already exists"):
                await run_live_split(
                    map_path=map_path, source=0,
                    new_address="127.0.0.1:2", state=state,
                )

        run(main())

    def test_split_under_concurrent_traffic_zero_acked_loss(self, tmp_path):
        """The fast leg of the storm scenario: registrations keep landing
        while the controller splits the partition live.  Every
        acknowledged write must exist on exactly one partition
        afterwards — the no-await critical section makes this structural,
        and this test would catch anyone adding an await to it."""

        async def main():
            from cpzk_tpu_torch.durability.recovery import recover_state

            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            state = await _seed_live(self.N)
            fleet = FleetRouter(PartitionMap.load(map_path), 0,
                                map_path=map_path)
            acked: list[str] = []
            redirected: list[str] = []
            stop = asyncio.Event()

            async def traffic():
                # the daemon's service layer checks ownership against the
                # live map BEFORE touching state (a non-owned user gets a
                # redirect, never an ack) — emulate that gate here, so an
                # "ack" below means what the daemon's ack means
                i = self.N
                stmt = make_statement()  # one statement: cheap loop
                while not stop.is_set():
                    uid = f"user-{i:03d}"
                    if fleet.map.partition_for(uid).index == fleet.self_index:
                        await state.register_user(UserData(uid, stmt, 1))
                        acked.append(uid)  # acknowledged
                    else:
                        redirected.append(uid)
                    i += 1
                    await asyncio.sleep(0)

            writer = asyncio.create_task(traffic())
            await asyncio.sleep(0.05)
            report = await run_live_split(
                map_path=map_path, source=0, new_address="127.0.0.1:2",
                state=state, fleet=fleet, segment_bytes=512,
            )
            await asyncio.sleep(0.05)
            stop.set()
            await writer
            tgt = ServerState()
            await recover_state(
                tgt, report["target_state_file"],
                report["target_state_file"] + ".wal",
            )
            live = {u for sh in state._shards for u in sh._users}
            moved = {u for sh in tgt._shards for u in sh._users}
            assert not (live & moved)
            # ZERO acked-write loss: every acknowledged registration
            # exists on exactly one partition afterwards
            lost = [u for u in acked if u not in live and u not in moved]
            assert lost == [], f"acked writes lost: {lost[:5]}"
            assert len(acked) > 0
            # the flip happened mid-traffic: some post-flip writes were
            # redirected to the new owner (proves the gate saw v2 live)
            assert len(redirected) > 0

        run(main())

    def test_controller_fires_the_live_split(self, tmp_path):
        """End to end through tick(): signals over threshold for
        act_ticks ticks -> a real in-process split, visible in the
        decision ring and the fleet map."""

        async def main():
            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            state = await _seed_live(self.N)
            fleet = FleetRouter(PartitionMap.load(map_path), 0,
                                map_path=map_path)
            clock = FakeClock()
            c = FleetController(
                ControllerSettings(
                    enabled=True, dry_run=False, act_ticks=2,
                    split_user_threshold=10,
                    split_target_address="127.0.0.1:2",
                ),
                state=state, fleet=fleet, clock=clock, wall=lambda: 0.0,
                segment_bytes=512,
            )
            labels = {"action": "split", "outcome": "fired"}
            before = metrics.read("fleet.controller.decisions",
                                  labels=labels)
            assert await c.tick() == []     # hot tick 1 of 2
            out = await c.tick()            # hot tick 2: split fires
            assert [d.action for d in out] == [ACTION_SPLIT]
            assert out[0].fired
            assert out[0].detail["report"]["new_version"] == 2
            assert fleet.map.version == 2
            assert metrics.read("fleet.controller.decisions",
                                labels=labels) == before + 1
            remaining = sum(r["users"] for r in state.shard_stats())
            assert 0 < remaining < self.N
            # the next hot streak is cooled down AND manifest-free
            assert (await c.tick()) == []  # streak restarted post-fire
            clock.advance(1.0)
            out = await c.tick()
            assert out and out[0].veto == "cooldown"

        run(main())

    def test_owner_fence_blocks_writer_straddling_the_flip(self, tmp_path):
        """REGRESSION (review): a handler that checked ownership at entry,
        awaited (verify_proof parks on the dynamic batcher), and only then
        minted its session could land the write AFTER the split's map
        flip — on the source's post-export state, where ``drop_users``
        discards it while the client holds a success and a token valid on
        NEITHER partition.  With the write-time owner fence installed the
        late write raises ``WrongPartition`` INSTEAD of acking: the
        client gets a redirect and retries at the new owner — an
        acknowledged write is never silently lost."""

        async def main():
            from cpzk_tpu_torch.errors import InvalidParams, WrongPartition

            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            state = await _seed_live(self.N)
            fleet = FleetRouter(PartitionMap.load(map_path), 0,
                                map_path=map_path)

            def owns(uid):
                return fleet.map.partition_for(uid).index == fleet.self_index

            # the daemon's fence: ownership under the LIVE map, re-asked
            # synchronously at write time
            state.attach_owner_fence(
                lambda uid: None if owns(uid)
                else f"wrong partition: user '{uid}' moved"
            )
            # pick a seeded user the split WILL move: the successor map
            # is a pure function of (current map, source, new address)
            successor, _ = fleet.map.split(0, "127.0.0.1:2")
            moving = next(
                f"user-{i:03d}" for i in range(self.N)
                if successor.partition_for(f"user-{i:03d}").index == 1
            )
            tok = state.tag_session_token(moving, "t" * 40)
            in_await = asyncio.Event()
            resume = asyncio.Event()

            async def straddling_handler():
                assert owns(moving)        # entry check passes pre-flip...
                in_await.set()
                await resume.wait()        # ...the batcher await, during
                                           # which the flip lands...
                await state.create_session(tok, moving)  # ...the late write

            writer = asyncio.create_task(straddling_handler())
            await in_await.wait()
            report = await run_live_split(
                map_path=map_path, source=0, new_address="127.0.0.1:2",
                state=state, fleet=fleet, segment_bytes=512,
            )
            assert report["moved_users"] > 0
            assert not owns(moving)        # the flip took it away
            resume.set()
            with pytest.raises(WrongPartition, match="wrong partition"):
                await writer               # the ack NEVER happens
            # ...and the fenced write left no trace: the token is invalid
            # on the source (and was never exported, so it exists on the
            # target only if the client retries there — honestly)
            with pytest.raises(InvalidParams):
                await state.validate_session(tok)

        run(main())


# --- the write-time partition-ownership fence (ServerState.owner_fence) ------


class TestOwnerFence:
    """State-level contract: every acknowledged user-keyed mutation
    re-checks ownership INSIDE the shard lock, in the same synchronous
    section as the mutation; reads and challenge consumes stay unfenced
    on purpose (removing or reading a stale copy the split already
    exported cannot lose an acknowledged write)."""

    @staticmethod
    def _only(owner_uid):
        return lambda uid: (
            None if uid == owner_uid
            else f"wrong partition: user '{uid}' is not owned here"
        )

    def test_fence_rejects_every_acked_mutation(self):
        async def main():
            from cpzk_tpu_torch.errors import WrongPartition

            state = ServerState()
            stmt = make_statement()
            await state.register_user(UserData("mine", stmt, 1))
            await state.register_user(UserData("moved", stmt, 1))
            tok = state.tag_session_token("moved", "s" * 40)
            await state.create_session(tok, "moved")
            state.attach_owner_fence(self._only("mine"))

            # register_user — fenced BEFORE the duplicate check, so a
            # stale post-flip copy answers redirect, not "already
            # registered"
            with pytest.raises(WrongPartition):
                await state.register_user(UserData("moved", stmt, 1))
            with pytest.raises(WrongPartition):
                await state.register_user(UserData("stranger", stmt, 1))
            assert "stranger" not in state._users
            # create_challenge
            with pytest.raises(WrongPartition):
                await state.create_challenge(
                    "moved", state.tag_challenge_id("moved", b"c" * 32)
                )
            # create_session — the scalar wrapper raises, the bulk form
            # reports the same message per-pair
            with pytest.raises(WrongPartition):
                await state.create_session(
                    state.tag_session_token("moved", "u" * 40), "moved"
                )
            msgs = await state.create_sessions([
                (state.tag_session_token("moved", "v" * 40), "moved"),
                (state.tag_session_token("mine", "w" * 40), "mine"),
            ])
            assert msgs[0].startswith("wrong partition")
            assert msgs[1] is None
            # revoke_session — revoking only the stale copy would ack a
            # revoke the new owner never saw
            with pytest.raises(WrongPartition):
                await state.revoke_session(tok)
            assert await state.validate_session(tok) == "moved"

        run(main())

    def test_consume_and_reads_stay_unfenced(self):
        async def main():
            state = ServerState()
            await state.register_user(UserData("moved", make_statement(), 1))
            cid = state.tag_challenge_id("moved", b"c" * 32)
            await state.create_challenge("moved", cid)
            tok = state.tag_session_token("moved", "t" * 40)
            await state.create_session(tok, "moved")
            # flip: this daemon owns nothing any more
            state.attach_owner_fence(lambda uid: "wrong partition: flipped")
            # an in-flight login still consumes its (stale) challenge —
            # the exported copy at the new owner is untouched, so the
            # retry there succeeds — and a held token still validates
            got = await state.consume_challenge(cid)
            assert got.user_id == "moved"
            assert await state.validate_session(tok) == "moved"

        run(main())

    def test_fenced_mutation_never_reaches_the_journal(self):
        async def main():
            from cpzk_tpu_torch.errors import WrongPartition

            class FakeWal:
                def __init__(self):
                    self.records = []
                    self.seq = 0

                def append(self, rtype, payload):
                    self.records.append(rtype)
                    self.seq += 1

                def needs_sync(self):
                    return False

            state = ServerState()
            wal = FakeWal()
            state.attach_journal(wal)
            state.attach_owner_fence(lambda uid: "wrong partition: flipped")
            with pytest.raises(WrongPartition):
                await state.register_user(UserData("u", make_statement(), 1))
            msgs = await state.create_sessions(
                [(state.tag_session_token("u", "t" * 40), "u")]
            )
            assert msgs[0].startswith("wrong partition")
            # no WAL trace: replay/standby apply can never resurrect a
            # write that was never acknowledged
            assert wal.records == []

        run(main())


# --- dry-run controller against real planes (signal collection) --------------


class TestCollect:
    def test_collect_reads_state_slo_and_manifest(self, tmp_path):
        async def main():
            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            state = await _seed_live(8)
            fleet = FleetRouter(PartitionMap.load(map_path), 0,
                                map_path=map_path)

            class FakeSlo:
                def snapshot(self):
                    return {"rpcs": {"VerifyProof": {"paging": ["fast"]}}}

            c = FleetController(
                ControllerSettings(enabled=True),
                state=state, fleet=fleet, slo=FakeSlo(),
            )
            sig = c.collect()
            assert sig.users == 8
            assert sig.paging is True
            assert sig.manifest is False
            assert sig.promoting is False
            with open(manifest_path(map_path), "w") as f:
                f.write("{}")
            assert c.collect().manifest is True

        run(main())

    def test_collect_standby_reports_promoting(self):
        class FakeReplica:
            role = "standby"

        c = FleetController(ControllerSettings(), replica=FakeReplica())
        assert c.collect().promoting is True


# --- ingest crash-loop guard (fast leg of the crash-loop storm) --------------


class TestIngestCrashloopGuard:
    def _bare_supervisor(self, **kw):
        """IngestSupervisor death-handling state without the heavyweight
        __init__ (no pb2, no sockets): exactly the fields
        _on_shard_death and the respawn scheduler touch."""
        from cpzk_tpu_torch.server.ingest import IngestSupervisor

        sup = IngestSupervisor.__new__(IngestSupervisor)
        sup.backoff_base_s = kw.get("backoff_base_s", 0.5)
        sup.backoff_max_s = kw.get("backoff_max_s", 30.0)
        sup.crashloop_deaths = kw.get("crashloop_deaths", 5)
        sup.crashloop_window_s = kw.get("crashloop_window_s", 60.0)
        sup._death_times = {}
        sup._respawn_at = {}
        sup._procs = {}
        sup._backoff_rng = random.Random(7)
        sup.shards = 1
        sup.respawns = 0
        sup.shard_stats = {0: {"shard": 0, "pid": None, "connected": False,
                               "respawns": 0, "crashloop": False}}
        return sup

    def test_backoff_ceiling_doubles_per_death(self):
        sup = self._bare_supervisor()
        sup._backoff_rng.uniform = lambda a, b: b  # pin jitter to ceiling
        delays = []
        for i in range(4):
            sup._on_shard_death(0, 111, -9, now=100.0 + i)
            delays.append(sup._respawn_at[0] - (100.0 + i))
            del sup._respawn_at[0]
        assert delays == [0.5, 1.0, 2.0, 4.0]

    def test_backoff_is_capped(self):
        sup = self._bare_supervisor(backoff_max_s=3.0, crashloop_deaths=99)
        sup._backoff_rng.uniform = lambda a, b: b
        for i in range(8):
            sup._on_shard_death(0, 111, -9, now=100.0 + i)
            delay = sup._respawn_at.pop(0) - (100.0 + i)
            assert delay <= 3.0

    def test_crashloop_gives_up_and_marks_statusz(self):
        sup = self._bare_supervisor(crashloop_deaths=3, crashloop_window_s=60)
        before = metrics.read("ingest.shard.crashloop")
        for i in range(3):
            sup._respawn_at.pop(0, None)
            sup._on_shard_death(0, 111, -9, now=100.0 + i)
        assert sup.shard_stats[0]["crashloop"] is True
        assert 0 not in sup._respawn_at            # never respawned again
        assert metrics.read("ingest.shard.crashloop") == before + 1
        assert sup.status()["crashloop_shards"] == 1

    def test_slow_deaths_outside_window_never_trip_the_guard(self):
        sup = self._bare_supervisor(crashloop_deaths=3, crashloop_window_s=10)
        for i in range(6):
            sup._respawn_at.pop(0, None)
            sup._on_shard_death(0, 111, -9, now=100.0 + 20.0 * i)
        assert sup.shard_stats[0]["crashloop"] is False
        assert 0 in sup._respawn_at


# --- client herd damping (fast leg of the herd-reconnect storm) --------------


class TestClientHerdDamping:
    def test_refresh_single_flight_coalesces(self):
        from cpzk_tpu_torch.client.rpc import AuthClient

        async def main():
            pmap = PartitionMap.uniform(["127.0.0.1:1"])
            fetches = []

            async def fetch():
                fetches.append(1)
                await asyncio.sleep(0.02)
                return dataclass_replace_version(pmap, 5)

            client = AuthClient(
                "127.0.0.1:1", partition_map=pmap, map_refresh=fetch,
                refresh_jitter_s=0.0,
            )
            try:
                results = await asyncio.gather(
                    *[client._refresh_map() for _ in range(20)]
                )
                assert len(fetches) == 1       # one shared in-flight fetch
                assert client.refresh_coalesced == 19
                assert any(results)
                assert client.partition_map.version == 5
                # within the min interval: answered from the last fetch
                assert await client._refresh_map() is False
                assert len(fetches) == 1
            finally:
                await client.close()

        run(main())

    def test_reconnect_damping_spreads_the_herd(self):
        from cpzk_tpu_torch.client.rpc import AuthClient

        async def main():
            client = AuthClient("127.0.0.1:1", reconnect_damp_s=0.05)
            try:
                loop = asyncio.get_running_loop()
                client._mark_down("127.0.0.1:1")
                t0 = loop.time()
                await client._damp_reconnect("127.0.0.1:1")
                assert client.reconnects_damped == 1
                # the mark cleared: steady-state traffic is never taxed
                await client._damp_reconnect("127.0.0.1:1")
                assert client.reconnects_damped == 1
            finally:
                await client.close()

        run(main())

    def test_stale_down_mark_is_ignored(self):
        from cpzk_tpu_torch.client.rpc import AuthClient

        async def main():
            client = AuthClient("127.0.0.1:1", reconnect_damp_s=0.01)
            try:
                loop = asyncio.get_running_loop()
                client._addr_down["127.0.0.1:1"] = loop.time() - 10.0
                await client._damp_reconnect("127.0.0.1:1")
                assert client.reconnects_damped == 0
                assert "127.0.0.1:1" not in client._addr_down
            finally:
                await client.close()

        run(main())


def dataclass_replace_version(pmap: PartitionMap, version: int) -> PartitionMap:
    return PartitionMap(version, pmap.partitions)


# --- config surface ----------------------------------------------------------


class TestControllerConfig:
    def test_env_overrides(self, monkeypatch):
        monkeypatch.setenv("SERVER_CONTROLLER_ENABLED", "true")
        monkeypatch.setenv("SERVER_CONTROLLER_DRY_RUN", "false")
        monkeypatch.setenv("SERVER_CONTROLLER_TICK_INTERVAL_MS", "250")
        monkeypatch.setenv("SERVER_CONTROLLER_SPLIT_USER_THRESHOLD", "5000")
        monkeypatch.setenv(
            "SERVER_CONTROLLER_SPLIT_TARGET_ADDRESS", "10.0.0.9:50051"
        )
        cfg = ServerConfig.from_env()
        assert cfg.controller.enabled is True
        assert cfg.controller.dry_run is False
        assert cfg.controller.tick_interval_ms == 250.0
        assert cfg.controller.split_user_threshold == 5000
        assert cfg.controller.split_target_address == "10.0.0.9:50051"

    def test_armed_split_without_target_rejected(self):
        cfg = ServerConfig()
        cfg.controller.enabled = True
        cfg.controller.split_user_threshold = 1000
        with pytest.raises(ValueError, match="split_target_address"):
            cfg.validate()

    def test_bad_hysteresis_rejected(self):
        cfg = ServerConfig()
        cfg.controller.act_ticks = 0
        with pytest.raises(ValueError, match="act_ticks"):
            cfg.validate()

    def test_error_backoff_env_override_and_validation(self, monkeypatch):
        monkeypatch.setenv("SERVER_CONTROLLER_ERROR_BACKOFF_S", "7.5")
        cfg = ServerConfig.from_env()
        assert cfg.controller.error_backoff_s == 7.5
        cfg = ServerConfig()
        cfg.controller.error_backoff_s = -1.0
        with pytest.raises(ValueError, match="cooldowns cannot be negative"):
            cfg.validate()

    def test_controller_config_keys_documented(self):
        """CI drift guard (pattern from test_opsplane.py): every
        [controller] knob ships in the TOML example, the .env example,
        and the operations-doc knob inventory."""
        import dataclasses
        import re
        from pathlib import Path

        root = Path(ROOT)
        docs = (root / "docs" / "operations.md").read_text()
        toml_text = (root / "config" / "server.toml.example").read_text()
        env_text = (root / ".env.example").read_text()
        keys = [f.name for f in dataclasses.fields(ControllerSettings)]
        assert keys
        m = re.search(r"^\[controller\]$", toml_text, re.M)
        assert m, "[controller] section missing from server.toml.example"
        body = toml_text[m.end():].split("\n[", 1)[0]
        for key in keys:
            assert re.search(rf"^{key}\s*=", body, re.M), (
                f"[controller] key {key!r} missing from server.toml.example"
            )
            assert f"SERVER_CONTROLLER_{key.upper()}" in env_text, (
                f"SERVER_CONTROLLER_{key.upper()} missing from .env.example"
            )
            assert f"`controller.{key}`" in docs, (
                f"`controller.{key}` missing from the docs/operations.md "
                "knob inventory"
            )




# --- the port's decisions against the reference's ------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_decision_stream_matches_the_reference(seed):
    """Both packages' controllers, fed the same seeded stream of signals
    (users, lock wait, lane breakers and drains, paging, manifests,
    promotion) on the same clock, make the same decisions tick by tick:
    action, target, reason, veto, dry-run flag and detail."""
    import random as _random

    from cpzk_tpu.fleet.controller import FleetController as JFleetController
    from cpzk_tpu.fleet.controller import Signals as JSignals
    from cpzk_tpu.server.config import ControllerSettings as JControllerSettings

    knobs = dict(enabled=True, dry_run=True, act_ticks=2, clear_ticks=2,
                 split_user_threshold=100, split_lock_wait_ms=50.0,
                 split_target_address="127.0.0.1:9", split_cooldown_s=20.0,
                 lane_open_after_s=3.0, lane_cooldown_s=5.0, admission_cooldown_s=4.0)
    port_clock, ref_clock = FakeClock(), FakeClock()
    port = FleetController(ControllerSettings(**knobs), clock=port_clock, wall=lambda: 0.0)
    ref = JFleetController(JControllerSettings(**knobs), clock=ref_clock, wall=lambda: 0.0)
    port.admission, ref.admission = FakeAdmission(), FakeAdmission()
    gen = _random.Random(seed)
    rows = []
    for _ in range(60):
        sig = dict(
            users=gen.choice([None, 50, 120, 150]),
            lock_wait_ms=gen.choice([None, 0.0, 60.0]),
            lanes=[lane(str(k), gen.choice(["closed", "closed", "open", "half_open"]),
                        gen.random() < 0.3, gen.randrange(5)) for k in range(3)],
            paging=gen.choice([None, False, True]),
            manifest=gen.random() < 0.1, promoting=gen.random() < 0.1)
        dt = gen.choice([0.5, 1.0, 2.5])
        port_clock.advance(dt)
        ref_clock.advance(dt)
        got = [d.row() for d in port.decide(Signals(**sig))]
        want = [d.row() for d in ref.decide(JSignals(**sig))]
        assert got == want
        rows.extend(got)
    assert len({r["action"] for r in rows}) >= 2


def test_live_split_keeps_users_past_the_default_capacity(tmp_path):
    """A live split that moves more users than ``MAX_TOTAL_USERS`` (the
    default cap of a fresh ``ServerState``) keeps every one: the new
    partition takes the source's capacity caps (with the default caps the
    copy skipped every record past them, and the drain then dropped users
    it never received)."""
    from cpzk_tpu_torch.durability.recovery import recover_state
    from cpzk_tpu_torch.server.state import MAX_TOTAL_USERS

    n = 2 * MAX_TOTAL_USERS + 2_000

    async def main():
        map_path = str(tmp_path / "map.json")
        PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
        state = ServerState(max_users=n)
        stmt = make_statement()
        await state.register_users([UserData(f"user-{i:05d}", stmt, 1) for i in range(n)])
        fleet = FleetRouter(PartitionMap.load(map_path), 0, map_path=map_path)
        report = await run_live_split(
            map_path=map_path, source=0, new_address="127.0.0.1:2",
            state=state, fleet=fleet, segment_bytes=1 << 20)
        assert report["moved_users"] > MAX_TOTAL_USERS
        tgt = ServerState(max_users=n)
        await recover_state(tgt, report["target_state_file"],
                            report["target_state_file"] + ".wal")
        live = {u for sh in state._shards for u in sh._users}
        moved = {u for sh in tgt._shards for u in sh._users}
        assert len(moved) == report["moved_users"]
        assert not (live & moved) and len(live | moved) == n
        assert report["critical_section_s"] > 0

    run(main())


_CPU_LAUNCHER = (
    "import asyncio, sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from cpzk_tpu_torch.server.__main__ import amain, parse_args\n"
    "asyncio.run(amain(parse_args(sys.argv[1:]), device='cpu'))\n"
)


def test_controller_phase_rehearsal(tmp_path, monkeypatch):
    """``chip_smoke.py``'s ``controller`` phase through its ``launcher``
    seam, on the kernels' plain versions: 6000 users registered at A in
    calls of 50, the live controller splitting at 1000 while A serves, B
    booted from the split's files, 24 logins at each partition through a
    client holding the old map; the phase's own checks (one fired split,
    exact verdicts, every user at exactly its owner in the final
    snapshots) must hold."""
    import runpy
    import sys

    monkeypatch.chdir(tmp_path)  # the daemons' logs land in ./chiprun_out
    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                           run_name="chip_smoke_rehearsal")
    _, corpus, provers = smoke["make_corpus"](16, smoke["SeededRng"](1))
    out = smoke["controller_phase"](corpus, provers, 6000, 1000, 24, 50,
                                    launcher=[sys.executable, "-c", _CPU_LAUNCHER],
                                    on_card=False)
    assert out["decisions"]["counts"].get("split/fired") == 1
    assert out["split"]["moved_users"] == out["b_restored_users"] > 0
    assert out["register"]["redirected_after_flip"] == out["reregister"]["users"] > 0
    assert out["final"] == {"a_users": out["final"]["a_users"],
                            "b_users": 6000 - out["final"]["a_users"], "at_both": 0,
                            "misplaced": 0, "missing": 0,
                            "acked_before_b": out["register"]["acknowledged"]}
    assert out["logins"]["b"]["redirects"] >= 1
    for wave in out["logins"].values():
        assert wave["sessions"] == wave["valid"] and wave["entries"] == 24


# --- full-scale storm legs (slow, as in the reference), in process -------------


@pytest.mark.slow
class TestStormSuiteFullScale:
    """The reference's four failure storms at a larger scale than the fast
    legs above, on the port's planes in process: the herd coalescing its
    map refreshes, a brownout drained and readmitted through a real lane
    router, a live split under sustained writes, and the ingest crash-loop
    guard."""

    def test_storm_herd_full_scale(self):
        from cpzk_tpu_torch.client.rpc import AuthClient

        async def main():
            pmap = PartitionMap.uniform(["127.0.0.1:1"])
            fetches = []

            async def fetch():
                fetches.append(1)
                await asyncio.sleep(0.05)
                return dataclass_replace_version(pmap, 7)

            clients = [AuthClient("127.0.0.1:1", partition_map=pmap, map_refresh=fetch,
                                  refresh_jitter_s=0.0) for _ in range(8)]
            try:
                for client in clients:
                    await asyncio.gather(*[client._refresh_map() for _ in range(2500)])
                assert len(fetches) == len(clients)
                assert all(c.refresh_coalesced == 2499 for c in clients)
                assert all(c.partition_map.version == 7 for c in clients)
            finally:
                for client in clients:
                    await client.close()

        run(main())

    def test_storm_brownout_full_scale(self):
        from cpzk_tpu_torch.protocol.batch import CpuBackend
        from cpzk_tpu_torch.server.router import LaneRouter
        from test_torch_dispatch_lane import make_entries

        class Browning(CpuBackend):
            sick = False

            def verify_each(self, rows):
                if self.sick:
                    raise RuntimeError("brownout")
                return super().verify_each(rows)

        async def main():
            lanes = [CpuBackend(), Browning()]
            router = LaneRouter(lanes, recovery_after_s=0.3)
            c = FleetController(
                ControllerSettings(enabled=True, dry_run=False, act_ticks=1, clear_ticks=2,
                                   lane_open_after_s=0.2, lane_cooldown_s=0.2),
                router=router)
            router.start()
            entries = make_entries(2)
            verified = 0
            lanes[1].sick = True
            for step in range(120):
                try:
                    assert await router.submit(entries, None) == [None, None]
                    verified += 1
                except RuntimeError:
                    pass
                await c.tick()
                if step == 40:
                    lanes[1].sick = False
                await asyncio.sleep(0.02)
            await router.stop()
            fired = [d.action for d in c.decisions if d.fired]
            assert fired.count(ACTION_LANE_DRAIN) >= 1
            assert fired.count(ACTION_LANE_READMIT) >= 1
            assert verified > 0
            assert router.lane_states()[1]["drained"] is False

        run(main())

    def test_storm_split_full_scale(self, tmp_path):
        from cpzk_tpu_torch.durability.recovery import recover_state

        async def main():
            map_path = str(tmp_path / "map.json")
            PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            state = ServerState(max_users=10**6)
            stmt = make_statement()
            await state.register_users([UserData(f"user-{i:05d}", stmt, 1)
                                        for i in range(5000)])
            fleet = FleetRouter(PartitionMap.load(map_path), 0, map_path=map_path)
            acked, redirected = [], []
            stop = asyncio.Event()

            async def traffic():
                i = 5000
                while not stop.is_set():
                    uid = f"user-{i:05d}"
                    if fleet.map.partition_for(uid).index == fleet.self_index:
                        await state.register_user(UserData(uid, stmt, 1))
                        acked.append(uid)
                    else:
                        redirected.append(uid)
                    i += 1
                    await asyncio.sleep(0)

            writer = asyncio.create_task(traffic())
            await asyncio.sleep(0.2)
            report = await run_live_split(map_path=map_path, source=0,
                                          new_address="127.0.0.1:2", state=state,
                                          fleet=fleet)
            await asyncio.sleep(0.2)
            stop.set()
            await writer
            tgt = ServerState(max_users=10**6)
            await recover_state(tgt, report["target_state_file"],
                                report["target_state_file"] + ".wal")
            live = {u for sh in state._shards for u in sh._users}
            moved = {u for sh in tgt._shards for u in sh._users}
            assert not (live & moved)
            assert [u for u in acked if u not in live | moved] == []
            assert acked and redirected and fleet.map.version == 2

        run(main())

    def test_storm_crashloop_full_scale(self):
        guard = TestIngestCrashloopGuard()
        sup = guard._bare_supervisor(crashloop_deaths=5, crashloop_window_s=60)
        before = metrics.read("ingest.shard.crashloop")
        t = 100.0
        for _ in range(5):
            sup._respawn_at.pop(0, None)
            sup._on_shard_death(0, 111, -9, now=t)
            t += 1.0
        assert sup.shard_stats[0]["crashloop"] is True
        assert 0 not in sup._respawn_at
        assert metrics.read("ingest.shard.crashloop") == before + 1
