"""Twins of ``tests/test_router.py`` for the port's multi-device serving
plane (``cpzk_tpu_torch/server/router.py``): deadline-aware placement over
per-device dispatch lanes, per-lane breaker isolation, the ``lanes = 1``
structural fast path, drain-then-join shutdown across lanes, the
big-batch mesh lane, the audit pipeline's router fan-out, the mesh and
lane device resolution, the ``/statusz`` lane rows and the ``[tpu]``
knobs, case by case under the reference's names.

The placement cases drive the reference's ``LaneRouter`` and the port's
with the same lane signals and require the same picks.  The three cases
that check the reference's jit-cache keys per device check the port's
counterpart instead: every lane launches on its own device under
``device_scope``, and the prewarm visits every lane device.  The audit
cases require the routed report to be the same bytes as the single-lane
replay and as the reference's.  Lanes run on ``CpuBackend``, or on
``TorchBackend`` over explicit CPU device lists (the kernels' plain
versions).
"""

import asyncio
import json
import pathlib
import re
import threading

import pytest
import torch

from cpzk_tpu.protocol.batch import CpuBackend as JCpuBackend
from cpzk_tpu.server.router import LaneRouter as JLaneRouter
from cpzk_tpu_torch.observability import get_flight_recorder
from cpzk_tpu_torch.ops import backend as backend_mod
from cpzk_tpu_torch.protocol.batch import CpuBackend
from cpzk_tpu_torch.server.batching import DynamicBatcher
from cpzk_tpu_torch.server.dispatch import LaneStopped
from cpzk_tpu_torch.server.router import MESH_LANE, LaneRouter

from test_torch_dispatch_lane import ExplodingBackend, RecordingBackend, make_entries

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    rec = get_flight_recorder()
    rec.clear()
    yield
    rec.clear()


class SlowBackend(RecordingBackend):
    """CPU oracle with a fixed per-call delay (a slow device)."""

    @property
    def calls(self) -> int:
        return len(self.sizes)


def both_routers(k: int):
    """The reference's router and the port's, over k host lanes each."""
    return (JLaneRouter([JCpuBackend() for _ in range(k)]),
            LaneRouter([CpuBackend() for _ in range(k)]))


# --- placement ---------------------------------------------------------------


def test_placement_prefers_least_backlogged_lane():
    """Skewed lane depths: a new batch lands on the lane with the shortest
    predicted completion, in both packages."""
    for router in both_routers(3):
        for slot, pending in zip(router._slots, (500, 3, 900), strict=True):
            slot.pending = pending
            slot.drain_rate = 100.0
        slot, probe = router._pick(4)
        assert not probe
        assert slot is router._slots[1]


def test_placement_is_drain_rate_aware():
    """Equal depths, unequal drain rates: the faster lane wins in both
    packages, stable across the rotating tie-break."""
    for router in both_routers(2):
        for slot, rate in zip(router._slots, (10.0, 1000.0), strict=True):
            slot.pending = 200
            slot.drain_rate = rate
        for _ in range(4):
            slot, _ = router._pick(4)
            assert slot is router._slots[1]


def test_placement_spreads_cold_lanes():
    """Cold start: the rotating tie-break spreads batches, and both
    packages pick the same lanes in the same order."""
    picks = []
    for router in both_routers(4):
        order = []
        for _ in range(8):
            slot, _ = router._pick(1)
            slot.pending += 1
            order.append(slot.label)
        assert len(set(order)) >= 3, order
        picks.append(order)
    assert picks[0] == picks[1]


def test_router_serves_across_all_lanes():
    """Sustained load through the batcher lands dispatches on every lane,
    and every flight record carries its lane index."""
    router = LaneRouter([CpuBackend() for _ in range(3)])

    async def main():
        batcher = DynamicBatcher(CpuBackend(), max_batch=4, window_ms=1.0,
                                 max_queue=10_000, router=router)
        batcher.start()
        waves = [make_entries(4) for _ in range(9)]
        results = await asyncio.gather(*[batcher.submit_many(w) for w in waves])
        status = router.status()
        await batcher.stop()
        return results, status

    results, status = run(main())
    assert all(r == [None] * 4 for r in results)
    assert [row["dispatches"] > 0 for row in status["lanes"]] == [True] * 3
    assert sum(row["dispatches"] for row in status["lanes"]) == 9
    assert {rec.lane for rec in get_flight_recorder().snapshot()} == {0, 1, 2}


# --- per-lane breaker --------------------------------------------------------


def test_sick_lane_degrades_only_itself_and_readmits():
    """A raising backend in lane 2 errors only the batch placed on it
    before its breaker opens; the other lanes settle with zero errors;
    after the cooldown the next batch probes lane 2 and re-admits it.  The
    cooldown runs on the router's injected clock, which only the test
    advances, so no batch can probe lane 2 early on a slow or loaded host."""
    sick = ExplodingBackend(explode_times=1)
    now = [0.0]
    router = LaneRouter([CpuBackend(), CpuBackend(), sick, CpuBackend()],
                        recovery_after_s=0.05, clock=lambda: now[0])

    async def main():
        router.start()
        errors = 0
        for _ in range(12):
            try:
                assert await router.submit(make_entries(2), None) == [None, None]
            except RuntimeError:
                errors += 1
            if errors:
                break
        assert errors == 1, "lane 2 never drew a batch"
        assert router.status()["lanes"][2]["breaker"] == "open"
        for _ in range(8):
            assert await router.submit(make_entries(2), None) == [None, None]
        assert sick.calls == 1
        assert [router.status()["lanes"][i]["errors"] for i in (0, 1, 3)] == [0, 0, 0]
        now[0] += 0.06
        for _ in range(8):
            assert await router.submit(make_entries(2), None) == [None, None]
            if router.status()["lanes"][2]["breaker"] == "closed":
                break
        status = router.status()["lanes"][2]
        assert status["breaker"] == "closed" and status["probes"] == 1
        assert sick.calls >= 2
        await router.stop()

    run(main())


def test_all_lanes_open_still_routes():
    """Every breaker OPEN is not a dead server: the batch is placed
    anyway."""
    router = LaneRouter([ExplodingBackend()], recovery_after_s=1000.0)

    async def main():
        router.start()
        with pytest.raises(RuntimeError):
            await router.submit(make_entries(2), None)
        assert router.status()["lanes"][0]["breaker"] == "open"
        with pytest.raises(RuntimeError):
            await router.submit(make_entries(2), None)
        await router.stop()

    run(main())


# --- lanes = 1 structural fast path ------------------------------------------


def test_single_lane_config_never_constructs_a_router(monkeypatch):
    """``[tpu] lanes = 1`` keeps the single-lane path: ``build_backend``
    never constructs a LaneRouter, the batcher has no router, batches
    verify as before, and flight records carry no lane index."""
    from cpzk_tpu_torch.server import TpuSettings, build_backend
    from cpzk_tpu_torch.server import router as router_mod

    def boom(*a, **k):  # noqa: ARG001
        raise AssertionError("LaneRouter constructed on the lanes=1 path")

    monkeypatch.setattr(router_mod.LaneRouter, "__init__", boom)
    backend, batcher = build_backend(TpuSettings(backend="tpu", lanes=1), device="cpu")
    assert batcher is not None and batcher.router is None

    async def main():
        batcher.start()
        results = await batcher.submit_many(make_entries(2))
        await batcher.stop()
        return results

    assert run(main()) == [None, None]
    assert {r.lane for r in get_flight_recorder().snapshot()} == {None}


# --- shutdown ----------------------------------------------------------------


def test_router_stop_resolves_every_future_across_lanes():
    """Drain-then-join over N lanes: stop() resolves every accepted future
    exactly once with real results and refuses new work."""
    backends = [SlowBackend(delay_s=0.03) for _ in range(3)]
    router = LaneRouter(backends)

    async def main():
        router.start()
        futs = [router.submit(make_entries(2), None) for _ in range(6)]
        stop_task = asyncio.ensure_future(router.stop())
        await asyncio.sleep(0)
        with pytest.raises(LaneStopped):
            router.submit(make_entries(1), None)
        await stop_task
        assert all(f.done() for f in futs), "stop() returned before drain"
        return await asyncio.gather(*futs)

    assert run(main()) == [[None, None]] * 6
    assert sum(b.calls for b in backends) == 6


# --- mesh path ---------------------------------------------------------------


def test_mesh_threshold_routes_big_batches_to_the_mesh_lane():
    """Batches at or above ``mesh_threshold`` take the mesh lane; smaller
    ones stay on the per-device lanes."""
    mesh = RecordingBackend()
    lanes = [RecordingBackend(), RecordingBackend()]
    router = LaneRouter(lanes, mesh_backend=mesh, mesh_threshold=8)

    async def main():
        router.start()
        big = await router.submit(make_entries(8), None)
        small = await router.submit(make_entries(2), None)
        status = router.status()
        await router.stop()
        return big, small, status

    big, small, status = run(main())
    assert big == [None] * 8 and small == [None] * 2
    assert mesh.sizes == [8]
    assert sum(len(b.sizes) for b in lanes) == 1
    assert status["mesh"]["dispatches"] == 1 and status["mesh"]["lane"] == MESH_LANE
    assert status["mesh_threshold"] == 8
    assert {rec.lane for rec in get_flight_recorder().snapshot()} == set()


def test_mesh_lane_breaker_falls_back_to_per_device_lanes():
    """A mesh blow-up opens the mesh breaker: the next big batch routes
    per device."""
    lanes = [RecordingBackend(), RecordingBackend()]
    router = LaneRouter(lanes, mesh_backend=ExplodingBackend(), mesh_threshold=4,
                        recovery_after_s=1000.0)

    async def main():
        router.start()
        with pytest.raises(RuntimeError):
            await router.submit(make_entries(4), None)
        ok = await router.submit(make_entries(4), None)
        status = router.status()
        await router.stop()
        return ok, status

    ok, status = run(main())
    assert ok == [None] * 4
    assert status["mesh"]["breaker"] == "open"
    assert sum(len(b.sizes) for b in lanes) == 1


# --- audit through the router ------------------------------------------------


def test_audit_router_digest_identical_to_single_lane(tmp_path):
    """The port's replay through the LaneRouter gives the same signed
    report bytes as its single-lane replay and as the reference's routed
    replay (host lanes; the card's routed replay is
    ``tests/test_torch_audit.py``'s)."""
    from cpzk_tpu.audit.__main__ import main as j_audit_main
    from cpzk_tpu.audit.pipeline import run_audit as j_run_audit
    from cpzk_tpu_torch.audit.pipeline import run_audit

    log = str(tmp_path / "p.log")
    assert j_audit_main(["generate", "--n", "60", "--out", log, "--users", "4",
                         "--reject-frac", "0.1", "--mismatch-frac", "0.05"]) == 0
    key = str(tmp_path / "shared.key")
    rep1 = run_audit(log, str(tmp_path / "single.json"), key_path=key, quantum=16, lanes=1,
                     backend="cpu")
    rep2 = run_audit(log, str(tmp_path / "routed.json"), key_path=key, quantum=16, lanes=3,
                     backend="cpu")
    j_run_audit(log, str(tmp_path / "ref.json"), key_path=key, quantum=16, lanes=3,
                backend="cpu")
    assert rep1["totals"]["mismatched"] > 0
    assert rep1["digest"] == rep2["digest"] and rep1["totals"] == rep2["totals"]
    single = (tmp_path / "single.json").read_bytes()
    assert single == (tmp_path / "routed.json").read_bytes()
    assert single == (tmp_path / "ref.json").read_bytes()


def test_audit_cli_accepts_lanes(tmp_path):
    """``audit run --lanes 2`` replays and its report verifies, and so does
    the reference's CLI on the port's report."""
    from cpzk_tpu.audit.__main__ import main as j_audit_main
    from cpzk_tpu_torch.audit.__main__ import main as audit_main

    log = str(tmp_path / "c.log")
    assert audit_main(["generate", "--n", "12", "--out", log]) == 0
    report = str(tmp_path / "c.json")
    assert audit_main(["run", "--log", log, "--report", report, "--quantum", "5",
                       "--lanes", "2", "--quiet", "--backend", "cpu"]) == 0
    assert audit_main(["verify-report", "--report", report]) == 0
    assert j_audit_main(["verify-report", "--report", report]) == 0


# --- per-device pinning and prewarm ------------------------------------------


class _Recorder:
    """Stands in for ``torch.cuda.device`` on a host without CUDA: records
    the device each entered scope pins, and keeps each thread's stack of
    open scopes (``current()`` is the innermost one, None outside)."""

    def __init__(self):
        self.entered: list = []
        self._open = threading.local()

    def current(self):
        stack = getattr(self._open, "stack", [])
        return stack[-1] if stack else None

    def __call__(self, device):
        recorder = self

        class Scope:
            def __enter__(self):
                recorder.entered.append((threading.current_thread().name, str(device)))
                if not hasattr(recorder._open, "stack"):
                    recorder._open.stack = []
                recorder._open.stack.append(str(device))

            def __exit__(self, *exc):
                recorder._open.stack.pop()
                return False

        return Scope()


def test_prewarm_keys_are_device_scoped(monkeypatch):
    """Counterpart of the reference's per-device jit keys (the port
    compiles nothing per shape): ``build_backend`` with two lanes prewarms
    every lane device, once each, and pins one ``TorchBackend`` to each
    lane's device."""
    from cpzk_tpu_torch.server import TpuSettings, build_backend

    visited = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(backend_mod, "prewarm",
                        lambda quanta, device=None: visited.append((quanta, str(device))) or {})
    backend, batcher = build_backend(TpuSettings(backend="tpu", lanes=-1,
                                                 prewarm_quanta="6,8"))
    assert visited == [([6, 8], "cuda:0"), ([6, 8], "cuda:1")]
    assert [s.lane._backend.device for s in batcher.router._slots] == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert backend is batcher.router._slots[0].lane._backend


def test_prewarm_zero_compiles_on_lane_n_gt_0(monkeypatch):
    """Counterpart of the reference's lane N>0 first-dispatch check: every
    lane, lane 1 included, runs its backend calls on its own device thread
    inside ``torch.cuda.device`` of its own device; and with the kernels'
    plain versions, every tensor a lane's kernel is given lies on that
    lane's device."""
    from cpzk_tpu_torch.ops import verify as verify_mod
    from cpzk_tpu_torch.ops.backend import TorchBackend

    scopes = _Recorder()
    seen = []
    monkeypatch.setattr(torch.cuda, "device", scopes)

    def each(self, rows):
        seen.append((threading.current_thread().name, str(self.device), scopes.current()))
        return [True] * len(rows)

    with monkeypatch.context() as m:
        m.setattr(TorchBackend, "_verify_each", each)
        m.setattr(TorchBackend, "prefers_combined", False)
        devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
        router = LaneRouter([TorchBackend(device=d) for d in devices], devices=devices)

        async def main():
            router.start()
            results = await asyncio.gather(*[router.submit(make_entries(2), None)
                                             for _ in range(6)])
            await router.stop()
            return results

        assert run(main()) == [[None, None]] * 6
    assert {d for _, d, _ in seen} == {"cuda:0", "cuda:1"}, seen
    for thread, dev, scope in seen:
        assert thread == f"cpzk-lane{dev[-1]}-device" and scope == dev, seen
    assert scopes.current() is None

    made = []
    kernel = verify_mod.verify_each_kernel

    def recording(g, h, y1, *rest, **kw):
        made.append((threading.current_thread().name,
                     {str(t.device) for t in (*g, *h, *y1, *rest[-2:], *kw.values())}))
        return kernel(g, h, y1, *rest, **kw)

    monkeypatch.setattr(verify_mod, "verify_each_kernel", recording)
    backends = [TorchBackend(device="cpu"), TorchBackend(device=torch.device("cpu"))]
    for b in backends:
        b.prefers_combined = False
    router = LaneRouter(backends, devices=[b.device for b in backends])

    async def real():
        router.start()
        results = await asyncio.gather(*[router.submit(make_entries(2), None)
                                         for _ in range(4)])
        await router.stop()
        return results

    assert run(real()) == [[None, None]] * 4
    assert {t for t, _ in made} <= {"cpzk-lane0-device", "cpzk-lane1-device"} and made
    for thread, devs in made:
        assert devs == {str(backends[int(thread[9])].device)}, made


def test_device_scope_suffixes_jit_keys(monkeypatch):
    """Counterpart of the reference's device-suffixed jit keys:
    ``device_scope`` enters ``torch.cuda.device`` of a card on the calling
    thread only, nests and restores; ``None`` and host devices are no-ops."""
    scopes = _Recorder()
    monkeypatch.setattr(torch.cuda, "device", scopes)
    with backend_mod.device_scope(None), backend_mod.device_scope("cpu"):
        assert scopes.current() is None
    other = []
    with backend_mod.device_scope("cuda:1"):
        assert scopes.current() == "cuda:1"
        worker = threading.Thread(target=lambda: other.append(scopes.current()))
        worker.start()
        worker.join()
        with backend_mod.device_scope(torch.device("cuda", 0)):
            assert scopes.current() == "cuda:0"
        assert scopes.current() == "cuda:1"
    assert other == [None]
    assert scopes.current() is None
    assert [d for _, d in scopes.entered] == ["cuda:1", "cuda:0"]


def test_tpu_backend_rejects_device_plus_mesh():
    from cpzk_tpu_torch.ops.backend import TorchBackend

    with pytest.raises(ValueError, match="mesh"):
        TorchBackend(mesh_devices=0, device="cpu")
    with pytest.raises(ValueError, match="mesh_devices"):
        TorchBackend(devices=["cpu", "cpu"])


# --- mesh validation ---------------------------------------------------------


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_resolve_mesh_devices_rejects_overcommit(monkeypatch, cards):
    """Asking for more devices than exist raises a ValueError naming both
    numbers, over the local CUDA cards or an explicit list; inside the
    bounds the reference's semantics hold."""
    from cpzk_tpu_torch.parallel import resolve_lane_devices, resolve_mesh_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    n = cards
    with pytest.raises(ValueError, match=rf"mesh_devices={n + 7}.*{n} visible"):
        resolve_mesh_devices(n + 7)
    with pytest.raises(ValueError, match=rf"lanes={n + 7}"):
        resolve_lane_devices(n + 7)
    with pytest.raises(ValueError, match=r"mesh_devices=3 exceeds the 2 visible device"):
        resolve_mesh_devices(3, ["cpu", "cpu"])
    assert resolve_mesh_devices(None) is None
    assert resolve_mesh_devices(1) is None
    assert resolve_lane_devices(1) is None
    if n <= 1:
        assert resolve_mesh_devices(0) is None
        assert resolve_lane_devices(-1) is None
    else:
        assert [str(d) for d in resolve_mesh_devices(0)] == [f"cuda:{i}" for i in range(n)]
        assert resolve_lane_devices(-1) == [torch.device("cuda", i) for i in range(n)]
    assert resolve_lane_devices(2, ["cpu", "cpu"]) == [torch.device("cpu")] * 2


# --- statusz rows ------------------------------------------------------------


def test_statusz_carries_per_lane_rows():
    from cpzk_tpu_torch.observability.opsplane import OpsSources

    router = LaneRouter([CpuBackend(), CpuBackend()])

    async def main():
        batcher = DynamicBatcher(CpuBackend(), max_batch=4, window_ms=1.0, router=router)
        batcher.start()
        await batcher.submit_many(make_entries(3))
        doc = OpsSources(batcher=batcher).statusz()
        await batcher.stop()
        return doc

    rows = run(main())["lanes"]["lanes"]
    assert len(rows) == 2 and {row["lane"] for row in rows} == {"0", "1"}
    assert all(row["breaker"] == "closed" for row in rows)
    assert sum(row["dispatches"] for row in rows) == 1

    async def single():
        return OpsSources(batcher=DynamicBatcher(CpuBackend(), max_batch=4,
                                                 window_ms=1.0)).statusz()

    assert run(single())["lanes"] is None


# --- config knobs ------------------------------------------------------------


def test_lanes_config_env_layering_and_validation(monkeypatch):
    from cpzk_tpu_torch.server.config import ServerConfig

    monkeypatch.setenv("SERVER_TPU_LANES", "-1")
    monkeypatch.setenv("SERVER_TPU_MESH_THRESHOLD", "32768")
    cfg = ServerConfig()
    cfg._merge_env()
    assert cfg.tpu.lanes == -1 and cfg.tpu.mesh_threshold == 32768
    cfg.validate()
    for field, value in (("lanes", 0), ("lanes", -2), ("mesh_threshold", -1)):
        cfg = ServerConfig()
        setattr(cfg.tpu, field, value)
        with pytest.raises(ValueError, match=field):
            cfg.validate()
    cfg = ServerConfig()
    cfg.tpu.mesh_threshold = 1000
    cfg.tpu.lanes = 1
    with pytest.raises(ValueError, match="mesh_threshold"):
        cfg.validate()
    cfg.tpu.lanes = -1
    cfg.validate()


def test_lanes_config_keys_documented():
    """The multi-device serving knobs the port reads ship in the TOML
    example, the .env example and the operations-doc knob inventory."""
    from cpzk_tpu_torch.server.config import TpuSettings

    toml_text = (ROOT / "config" / "server.toml.example").read_text()
    m = re.search(r"^\[tpu\]$", toml_text, re.M)
    assert m
    section = toml_text[m.end():].split("\n[", 1)[0]
    env_text = (ROOT / ".env.example").read_text()
    docs = (ROOT / "docs" / "operations.md").read_text()
    for key in ("lanes", "mesh_threshold"):
        assert hasattr(TpuSettings(), key)
        assert re.search(rf"^{key}\s*=", section, re.M), key
        assert f"SERVER_TPU_{key.upper()}" in env_text, key
        assert f"`tpu.{key}`" in docs, key


def test_perf_entry_lanes_is_a_config_key(tmp_path):
    """The port's perf gate keys entries by lane count: an 8-lane entry
    never gates against the 1-lane baseline, and snapshots round-trip."""
    from cpzk_tpu_torch.observability.perf import (
        PerfEntry,
        compare_entries,
        load_snapshot,
        write_snapshot,
    )

    old = [PerfEntry("e2e_curve.grpc", "cpu", 256, 1000.0, "proofs/s")]
    new = [PerfEntry("e2e_curve.grpc", "cpu", 256, 990.0, "proofs/s"),
           PerfEntry("e2e_curve.grpc", "cpu", 256, 10.0, "proofs/s", lanes=8)]
    report = compare_entries(old, new, threshold=0.35)
    assert report["passed"], report
    assert report["only_new"] == [("e2e_curve.grpc", "cpu", 256, "proofs/s", 8, "python")]
    path = str(tmp_path / "snap.json")
    write_snapshot(path, new)
    assert sorted(e.key() for e in load_snapshot(path)) == sorted(e.key() for e in new)
    raw = json.loads(pathlib.Path(path).read_text())
    assert sorted((e.get("lanes") for e in raw["entries"]), key=str) == [8, None]


def test_launch_counts_are_exact_across_threads():
    """Lanes and mesh slices launch from several threads at once: with a
    short switch interval and more threads than cores, every launch is
    counted once in the kernel module's ``LAUNCHES`` and once in the
    launching thread's ``thread_launches`` tally."""
    import sys

    from cpzk_tpu_torch.ops import point_kernels as pk

    counts = {"k": 0}
    tallies = []
    n_threads, per_thread = 32, 2000

    def work():
        with pk.thread_launches() as tally:
            for _ in range(per_thread):
                pk.count_launch(counts, "k")
        tallies.append(dict(tally))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert counts["k"] == n_threads * per_thread
    assert tallies == [{"k": per_thread}] * n_threads
