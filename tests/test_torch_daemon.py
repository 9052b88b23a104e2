"""The port's daemon (``python -m cpzk_tpu_torch.server``): twins of the
reference cases that waited for it, and its own boot, refusal, restore,
sweep and shutdown behaviour.

Twins (held against the reference where it answers the same question):
``test_observability.py`` (the /tracez command, the config section, the
configure call, the JSON formatter, and the REPL and JSON-log parts of the
end-to-end trace), ``test_flightrec.py`` (the /flightrec and /profile
commands, the flight-ring config and configure),
``test_chaos.py::test_status_repl_reports_breaker_state``, the three
config cases of ``test_wire.py``,
``test_state_snapshot.py::test_state_file_config_layering`` and
``test_dispatch_lane.py::test_prewarm_quanta_config_env_and_validation``.

The daemon's card path runs here on the CUDA kernels' plain versions
(``amain(..., device="cpu")``) in a subprocess; ``chip_smoke.py`` drives
the same path on an H100.
"""

import asyncio
import dataclasses
import json
import logging
import os
import pathlib
import re
import time
import urllib.request

import grpc
import numpy as np
import pytest

import cpzk_tpu as J
from cpzk_tpu.client import AuthClient
from cpzk_tpu.server import __main__ as j_main
from cpzk_tpu.server.config import ServerConfig as JServerConfig
from cpzk_tpu.server.state import ServerState as JServerState
from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.observability import (
    JsonLogFormatter,
    RequestContext,
    current_context,
    get_flight_recorder,
    get_tracer,
)
from cpzk_tpu_torch.observability.flightrec import FlightRecord
from cpzk_tpu_torch.protocol.batch import BatchVerifier, CpuBackend, FailoverBackend
from cpzk_tpu_torch.resilience import BreakerState
from cpzk_tpu_torch.resilience.faults import FaultInjectionBackend, FaultPlan
from cpzk_tpu_torch.server import __main__ as t_main
from cpzk_tpu_torch.server.batching import DynamicBatcher
from cpzk_tpu_torch.server.config import (
    ObservabilitySettings,
    RateLimiter,
    ServerConfig,
    ServerSettings,
)
from cpzk_tpu_torch.server.service import serve
from cpzk_tpu_torch.server.state import ServerState, UserData
from torch_daemon_harness import Daemon

ROOT = pathlib.Path(__file__).resolve().parent.parent
STAGES = {"queue_wait", "pad_and_pack", "device_dispatch", "unpack"}


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _fresh_rings():
    """Both packages' trace rings start empty (the reference's is
    process-global too, and tests of other files share the worker)."""
    from cpzk_tpu.observability import get_tracer as j_get_tracer

    tracer = get_tracer()
    prev_slow = tracer.slow_request_s
    tracer.clear()
    j_get_tracer().clear()
    get_flight_recorder().clear()
    yield
    tracer.clear()
    tracer.slow_request_s = prev_slow
    get_flight_recorder().clear()


@pytest.fixture()
def clean_env(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
    return tmp_path


# --- the REPL --------------------------------------------------------------------


def test_tracez_command_empty_and_bad_arg():
    async def main(handle, state):
        out_empty, _ = await handle("/tracez", state)
        out_bad, _ = await handle("/tracez banana", state)
        return out_empty, out_bad

    out_empty, out_bad = run(main(t_main.handle_command, ServerState()))
    assert "no completed traces" in out_empty
    assert "usage: /tracez" in out_bad
    assert run(main(j_main.handle_command, JServerState())) == (out_empty, out_bad)


def test_flightrec_command_empty_and_populated():
    async def main():
        state = ServerState()
        out_empty, _ = await t_main.handle_command("/flightrec", state)
        get_flight_recorder().record(
            FlightRecord(batch=12, lanes=16, occupancy=0.75,
                         stages_s={"execute": 0.002}, wall_s=0.002)
        )
        out, quit_ = await t_main.handle_command("/flightrec 5", state)
        out_bad, _ = await t_main.handle_command("/flightrec banana", state)
        return out_empty, out, quit_, out_bad

    out_empty, out, quit_, out_bad = run(main())
    assert "no recorded batches" in out_empty
    assert not quit_
    assert "n=12" in out and "occ=0.75" in out and "gap=" in out
    assert "usage: /flightrec" in out_bad


def test_profile_command_capture_and_guard(tmp_path):
    from cpzk_tpu_torch.observability import flightrec as fr

    logdir = str(tmp_path / "trace")

    async def main():
        state = ServerState()
        usage, _ = await t_main.handle_command("/profile", state)
        bad, _ = await t_main.handle_command("/profile banana", state)
        out, _ = await t_main.handle_command(f"/profile 0.05 {logdir}", state)
        return usage, bad, out

    usage, bad, out = run(main())
    assert "usage: /profile" in usage
    assert "usage: /profile" in bad
    assert logdir in out and "torch.profiler" in out and "Chrome trace" in out
    assert list(pathlib.Path(logdir).glob("cpzk-trace-*.json"))
    assert fr.profile_active() is None  # capture closed

    # concurrent-capture guard: second start is refused, not corrupting
    assert fr.start_profile(str(tmp_path / "a"))
    try:
        assert not fr.start_profile(str(tmp_path / "b"))
        assert fr.profile_active() == str(tmp_path / "a")
    finally:
        assert fr.stop_profile() == str(tmp_path / "a")
    assert fr.stop_profile() is None


def _make_proofs(n):
    rng = SecureRng()
    params = Parameters.new()
    out = []
    for _ in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        out.append((prover.statement, prover.prove_with_transcript(rng, Transcript())))
    return params, out


def test_status_repl_reports_breaker_state():
    fault = FaultInjectionBackend(CpuBackend(), FaultPlan().fail_after(0))
    backend = FailoverBackend(fault, CpuBackend(), recovery_after_s=None)

    async def main():
        state = ServerState()
        out, _ = await t_main.handle_command("/status", state, backend)
        assert "backend=closed" in out

        params, proofs = _make_proofs(2)
        bv = BatchVerifier(backend=backend)
        for st, pr in proofs:
            bv.add(params, st, pr)
        await asyncio.to_thread(bv.verify, SecureRng())
        out, _ = await t_main.handle_command("/status", state, backend)
        assert "backend=open" in out and "degraded_for=" in out

        out, _ = await t_main.handle_command("/reset", state, backend)
        assert "re-armed" in out
        assert backend.state is BreakerState.CLOSED

        # no failover backend to report (the daemon serves the card bare)
        out, _ = await t_main.handle_command("/status", state, None)
        assert "backend=" not in out

    run(main())


@pytest.mark.parametrize("cmd", [
    "/overload", "/persist", "/audit", "/replication", "/fleet", "/controller",
    "/promote", "/handover", "/users", "/sessions", "/challenges", "/cleanup",
    "/reset", "/status", "/quit", "/nope", "hello", "",
])
def test_commands_answer_as_the_reference_with_subsystems_off(cmd):
    """With its subsystems off (no durability, audit, replication, fleet
    or controller), every command answers with the reference's text, and
    the state commands alike."""

    async def main():
        return (await t_main.handle_command(cmd, ServerState()),
                await j_main.handle_command(cmd, JServerState()))

    port, ref = run(main())
    assert port == ref


def test_controller_command_answers_as_the_reference():
    """``/controller`` with a fleet controller: each package's controller,
    fed the same lane signals on the same clock (one lane's breaker OPEN
    past ``lane_open_after_s``, dry-run), renders the same mode line and
    decision rows."""
    from cpzk_tpu.fleet.controller import FleetController as JFleetController
    from cpzk_tpu.server.config import ControllerSettings as JControllerSettings
    from cpzk_tpu_torch.fleet.controller import FleetController
    from cpzk_tpu_torch.server.config import ControllerSettings

    class Lanes:
        def __init__(self):
            self.breaker = "open"

        def lane_states(self):
            return [{"lane": "0", "breaker": "closed", "drained": False, "pending": 0},
                    {"lane": "1", "breaker": self.breaker, "drained": False,
                     "pending": 3}]

    t = [100.0]
    knobs = dict(enabled=True, dry_run=True, lane_open_after_s=1.0)
    port = FleetController(ControllerSettings(**knobs), router=Lanes(),
                           clock=lambda: t[0], wall=lambda: 0.0)
    ref = JFleetController(JControllerSettings(**knobs), router=Lanes(),
                           clock=lambda: t[0], wall=lambda: 0.0)

    async def main():
        out = []
        for _ in range(3):
            await port.tick()
            await ref.tick()
            t[0] += 0.6
            out.append((await t_main.handle_command("/controller", ServerState(),
                                                     controller=port),
                        await j_main.handle_command("/ctl", JServerState(),
                                                    controller=ref)))
        return out

    rows = run(main())
    assert [p for p, _ in rows] == [r for _, r in rows]
    assert "(no decisions yet)" in rows[0][0][0]
    assert "lane_drain 1 [dry-run]" in rows[-1][0][0]


# --- the config sections ----------------------------------------------------------


def test_observability_config_env(monkeypatch):
    monkeypatch.setenv("SERVER_OBSERVABILITY_JSON_LOGS", "true")
    monkeypatch.setenv("SERVER_OBS_SLOW_REQUEST_MS", "250")
    monkeypatch.setenv("SERVER_OBSERVABILITY_TRACE_RING", "32")
    monkeypatch.setenv("SERVER_OBS_LATENCY_BUCKETS_MS", "1, 5, 10")
    cfg, ref = ServerConfig(), JServerConfig()
    cfg._merge_env()
    ref._merge_env()
    assert cfg.observability.json_logs is True
    assert cfg.observability.slow_request_ms == 250.0
    assert cfg.observability.trace_ring == 32
    assert cfg.observability.parsed_buckets() == [0.001, 0.005, 0.01]
    assert dataclasses.asdict(cfg.observability) == dataclasses.asdict(ref.observability)
    cfg.validate()


def test_observability_config_validation():
    for key, value in (("trace_ring", 0), ("slow_request_ms", -5),
                       ("latency_buckets_ms", "10,5,1"),
                       ("latency_buckets_ms", "abc")):
        cfg, ref = ServerConfig(), JServerConfig()
        setattr(cfg.observability, key, value)
        setattr(ref.observability, key, value)
        with pytest.raises(ValueError) as err:
            cfg.validate()
        with pytest.raises(ValueError) as ref_err:
            ref.validate()
        assert str(err.value) == str(ref_err.value)


def test_configure_applies_settings():
    from cpzk_tpu_torch.observability import configure

    tracer = get_tracer()
    try:
        configure(ObservabilitySettings(slow_request_ms=-1, trace_ring=8))
        assert tracer.slow_request_s is None
        configure(ObservabilitySettings(slow_request_ms=500, trace_ring=8))
        assert tracer.slow_request_s == 0.5
    finally:
        tracer.configure(capacity=256, slow_request_s=1.0)


def test_flightrec_config_env_and_validation(monkeypatch):
    monkeypatch.setenv("SERVER_OBSERVABILITY_FLIGHT_RING", "16")
    monkeypatch.setenv("SERVER_OBS_COMPILE_STORM_THRESHOLD", "3")
    cfg = ServerConfig()
    cfg._merge_env()
    assert cfg.observability.flight_ring == 16
    assert cfg.observability.compile_storm_threshold == 3
    cfg.validate()

    for key in ("flight_ring", "compile_storm_threshold"):
        cfg, ref = ServerConfig(), JServerConfig()
        setattr(cfg.observability, key, 0)
        setattr(ref.observability, key, 0)
        with pytest.raises(ValueError) as err:
            cfg.validate()
        with pytest.raises(ValueError) as ref_err:
            ref.validate()
        assert str(err.value) == str(ref_err.value)


def test_configure_applies_flight_ring():
    """The flight ring takes its capacity; the compile-storm threshold is
    accepted and has nothing to act on (PyTorch compiles nothing per batch
    shape)."""
    from cpzk_tpu_torch.observability import configure

    rec = get_flight_recorder()
    try:
        configure(ObservabilitySettings(flight_ring=3, compile_storm_threshold=2))
        for i in range(6):
            rec.record(FlightRecord(batch=i))
        assert [r.batch for r in rec.snapshot()] == [3, 4, 5]
    finally:
        configure(ObservabilitySettings())


def test_perf_entry_wire_is_a_config_key(tmp_path):
    """``wire`` is a perf-gate config-key component — old baselines load
    as ``wire="python"``, native-wire entries never gate against them, and
    the field serializes only when != python; a snapshot written by either
    package loads in the other."""
    from cpzk_tpu.observability import perf as j_perf
    from cpzk_tpu_torch.observability.perf import (
        PerfEntry,
        compare_entries,
        load_snapshot,
        write_snapshot,
    )

    old = [PerfEntry("e2e_curve.stream", "cpu", 65536, 2815.0, "proofs/s")]
    new = [
        PerfEntry("e2e_curve.stream", "cpu", 65536, 2800.0, "proofs/s"),
        PerfEntry("e2e_curve.stream", "cpu", 65536, 10.0, "proofs/s",
                  wire="native"),
    ]
    report = compare_entries(old, new, threshold=0.35)
    assert report["passed"], report  # the native entry is only_new
    assert report["only_new"] == [
        ("e2e_curve.stream", "cpu", 65536, "proofs/s", 1, "native")
    ]
    path = str(tmp_path / "snap.json")
    write_snapshot(path, new)
    loaded = load_snapshot(path)
    assert sorted(e.key() for e in loaded) == sorted(e.key() for e in new)
    raw = json.loads(pathlib.Path(path).read_text())
    assert sorted(
        (e.get("wire") for e in raw["entries"]), key=str
    ) == [None, "native"]
    assert sorted(e.key() for e in j_perf.load_snapshot(path)) == sorted(
        e.key() for e in new)


def test_server_config_layering_and_validation(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    cfg = ServerConfig.from_env()
    assert cfg.server.wire == "native"
    assert cfg.server.ingest_shards == 1

    (tmp_path / "server.toml").write_text(
        '[server]\nwire = "python"\ningest_shards = 4\n'
    )
    monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
    cfg = ServerConfig.from_env()
    assert cfg.server.wire == "python"
    assert cfg.server.ingest_shards == 4
    cfg.validate()
    monkeypatch.setenv("SERVER_WIRE", "NATIVE")
    monkeypatch.setenv("SERVER_INGEST_SHARDS", "2")
    cfg = ServerConfig.from_env()
    assert cfg.server.wire == "native"
    assert cfg.server.ingest_shards == 2
    assert dataclasses.asdict(cfg.server) == dataclasses.asdict(
        JServerConfig.from_env().server)

    def refused(mutate, match):
        bad, ref = ServerConfig(), JServerConfig()
        mutate(bad)
        mutate(ref)
        with pytest.raises(ValueError, match=match) as err:
            bad.validate()
        with pytest.raises(ValueError) as ref_err:
            ref.validate()
        assert str(err.value) == str(ref_err.value)

    refused(lambda c: setattr(c.server, "wire", "rust"), "server.wire")
    refused(lambda c: setattr(c.server, "ingest_shards", 0), "ingest_shards")
    refused(lambda c: setattr(c.server, "ingest_shards", 65), "ingest_shards")

    def standby(c):
        c.server.ingest_shards = 2
        c.state_file = "/tmp/x.json"
        c.durability.enabled = True
        c.replication.enabled = True
        c.replication.role = "standby"

    refused(standby, "ingest_shards")


def test_server_config_keys_documented():
    """Every [server] knob of the port ships in the TOML example, the .env
    example, and the operations-doc knob inventory."""
    keys = [f.name for f in dataclasses.fields(ServerSettings)]
    assert keys
    toml_text = (ROOT / "config" / "server.toml.example").read_text()
    m = re.search(r"^\[server\]$", toml_text, re.M)
    assert m, "[server] section missing from config/server.toml.example"
    section = toml_text[m.end():].split("\n[", 1)[0]
    env_text = (ROOT / ".env.example").read_text()
    docs = (ROOT / "docs" / "operations.md").read_text()
    for key in keys:
        assert re.search(rf"^{key}\s*=", section, re.M), key
        assert f"SERVER_{key.upper()}" in env_text, key
        assert f"`server.{key}`" in docs, key


def test_state_file_config_layering(tmp_path, monkeypatch):
    """state_file resolves through the same precedence chain as every
    other knob (TOML < env < CLI)."""
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    assert ServerConfig.from_env().state_file == ""
    monkeypatch.setenv("SERVER_STATE_FILE", "/tmp/a.json")
    assert ServerConfig.from_env().state_file == "/tmp/a.json"
    args = t_main.parse_args(["--state-file", "/tmp/b.json"])
    assert t_main.resolve_config(args).state_file == "/tmp/b.json"


def test_prewarm_quanta_config_env_and_validation(monkeypatch):
    monkeypatch.setenv("SERVER_TPU_PREWARM_QUANTA", "16, 4096")
    cfg = ServerConfig()
    cfg._merge_env()
    assert cfg.tpu.prewarm_quanta == "16, 4096"
    assert cfg.tpu.parsed_prewarm_quanta() == [16, 4096]
    cfg.validate()

    cfg = ServerConfig()
    cfg.tpu.prewarm_quanta = "banana"
    with pytest.raises(ValueError, match="prewarm_quanta"):
        cfg.validate()
    cfg = ServerConfig()
    cfg.tpu.prewarm_quanta = "0,16"
    with pytest.raises(ValueError, match="positive"):
        cfg.validate()
    cfg = ServerConfig()
    cfg.tpu.prewarm_quanta = ""
    assert cfg.tpu.parsed_prewarm_quanta() == []
    cfg.validate()


# --- the trace end to end: the REPL and the JSON log -------------------------------


class _CaptureJson(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines: list[str] = []
        self.setFormatter(JsonLogFormatter())

    def emit(self, record):
        self.lines.append(self.format(record))


def test_json_formatter_pulls_contextvar_trace_id():
    ctx = RequestContext()
    token = current_context.set(ctx)
    try:
        record = logging.LogRecord(
            "test", logging.INFO, __file__, 1, "hello %s", ("world",), None
        )
        data = json.loads(JsonLogFormatter().format(record))
    finally:
        current_context.reset(token)
    assert data["message"] == "hello world"
    assert data["trace_id"] == ctx.trace_id
    assert data["level"] == "INFO"
    assert data["logger"] == "test"


def test_verify_proof_trace_repl_and_json_log():
    """The REPL and JSON-log parts of the reference's end-to-end trace:
    VerifyProofs served through the batcher show in ``/tracez`` with their
    stage spans, and the JSON log lines carry the same trace ids."""
    tracer = get_tracer()
    tracer.slow_request_s = 0.0  # log every request
    capture = _CaptureJson()
    rpc_logger = logging.getLogger("cpzk_tpu_torch.observability.rpc")
    rpc_logger.addHandler(capture)
    rng = J.SecureRng()
    params = J.Parameters.new()

    async def register_and_prove(client, user):
        prover = J.Prover(params, J.Witness(J.Ristretto255.random_scalar(rng)))
        eb = J.Ristretto255.element_to_bytes
        resp = await client.register(user, eb(prover.statement.y1), eb(prover.statement.y2))
        assert resp.success
        ch = await client.create_challenge(user)
        t = J.Transcript()
        t.append_context(bytes(ch.challenge_id))
        return bytes(ch.challenge_id), prover.prove_with_transcript(rng, t).to_bytes()

    async def main():
        state = ServerState()
        batcher = DynamicBatcher(CpuBackend(), max_batch=64, window_ms=20.0)
        server, port = await serve(state, RateLimiter(10_000, 10_000),
                                   port=0, backend=CpuBackend(), batcher=batcher)
        try:
            async with AuthClient(f"127.0.0.1:{port}") as client:
                users = [f"trace{i}" for i in range(3)]
                pairs = [await register_and_prove(client, u) for u in users]
                resps = await asyncio.gather(*[
                    client.verify_proof(u, cid, pf)
                    for u, (cid, pf) in zip(users, pairs)])
                assert all(r.success for r in resps)
            return await t_main.handle_command("/tracez", state)
        finally:
            await batcher.stop()
            await server.stop(None)

    try:
        tracez_out, quit_ = run(main())
    finally:
        rpc_logger.removeHandler(capture)

    verify_traces = [t for t in tracer.completed() if t.name == "VerifyProof"]
    assert len(verify_traces) == 3
    for tr in verify_traces:
        assert tr.status == "success"
        assert STAGES <= set(tr.span_names()), tr.span_names()
    assert not quit_
    assert "VerifyProof" in tracez_out and "device_dispatch=" in tracez_out
    for tr in verify_traces:
        assert tr.trace_id[:16] in tracez_out
    logged = [json.loads(line) for line in capture.lines]
    verify_logs = [entry for entry in logged if entry.get("rpc") == "VerifyProof"]
    assert {entry["trace_id"] for entry in verify_logs} == {
        t.trace_id for t in verify_traces}
    for entry in verify_logs:
        assert entry["outcome"] == "success"
        assert "queue_wait" in entry["stages_ms"]


# --- boot: refusals, restore, sweeps ------------------------------------------------


@pytest.mark.parametrize("section,env", [
    ("replication", {"SERVER_DURABILITY_ENABLED": "1", "SERVER_STATE_FILE": "s.json",
                     "SERVER_REPLICATION_ENABLED": "1",
                     "SERVER_REPLICATION_ROLE": "standby",
                     "SERVER_REPLICATION_PEER": "127.0.0.1:1"}),
    ("fleet", {"SERVER_FLEET_ENABLED": "1", "SERVER_FLEET_MAP_PATH": "m.json",
               "SERVER_FLEET_PARTITION": "0"}),
    ("controller", {"SERVER_CONTROLLER_ENABLED": "1",
                    "SERVER_CONTROLLER_TICK_INTERVAL_MS": "50",
                    "SERVER_OPSPLANE_ENABLED": "1", "SERVER_OPSPLANE_PORT": "0"}),
])
def test_ported_section_boots(clean_env, monkeypatch, section, env):
    """The reference's ``[replication]``, ``[fleet]`` and ``[controller]``
    configs boot the port's daemon, which the earlier slices refused: a
    replication standby refuses auth RPCs until promoted, a one-partition
    map serves, and the fleet controller ticks in dry-run beside a serving
    daemon, its block in ``/statusz``."""
    from cpzk_tpu_torch.fleet import PartitionMap
    from cpzk_tpu_torch.client import AuthClient as TAuthClient
    from cpzk_tpu_torch.client.__main__ import do_login, do_register
    from torch_daemon_harness import Daemon

    PartitionMap.uniform(["127.0.0.1:1"]).store(str(clean_env / "m.json"))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    j_main.resolve_config(j_main.parse_args([]))  # valid for the reference
    daemon = Daemon("port", clean_env / "daemon", '[tpu]\nbackend = "cpu"\n',
                    env={**env, "SERVER_FLEET_MAP_PATH": str(clean_env / "m.json")})
    try:
        daemon.wait_listening()

        async def drive():
            async with TAuthClient(f"127.0.0.1:{daemon.port}") as client:
                if section == "replication":
                    with pytest.raises(grpc.aio.AioRpcError) as exc:
                        await client.create_challenge("alice")
                    return exc.value.code().name, exc.value.details()
                return (await do_register(client, "alice", "pw"),
                        await do_login(client, "alice", "pw"))

        got = run(drive())
        if section == "replication":
            assert got == ("UNAVAILABLE",
                           "standby replica: not promoted (writes go to the primary)")
            assert "replication standby: epoch=1 applied_seq=0" in daemon.logs()
        elif section == "controller":
            assert "Registered" in got[0] and "Login OK" in got[1], got
            assert "fleet controller DRY-RUN (decisions only)" in daemon.logs()
            deadline = time.monotonic() + 30
            while True:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{daemon.ops_port}/statusz", timeout=10) as r:
                    block = json.loads(r.read())["controller"]
                if block["ticks"] > 0 or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
            assert block["enabled"] is True and block["dry_run"] is True
            assert block["ticks"] > 0 and block["decisions"] == []
        else:
            assert "Registered" in got[0] and "Login OK" in got[1], got
            assert "fleet routing enabled: partition 0/1" in daemon.logs()
        assert daemon.terminate() == 0
    finally:
        daemon.kill()


def test_card_backend_without_cuda_fails_at_boot(clean_env, monkeypatch):
    """``backend = "tpu"`` (the default) with no CUDA: an error at boot,
    never a daemon serving on the host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = t_main.parse_args(["--no-repl", "--port", "0"])
    assert t_main.resolve_config(args).tpu.backend == "tpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(t_main.amain(args))


@pytest.mark.parametrize("role", ["standby", "primary"])
def test_replication_daemon_without_cuda_fails_at_boot(clean_env, monkeypatch, role):
    """A replication standby serves the card as a primary does, so that
    its promotion pays no kernel load: with no CUDA either role stops at
    boot, before anything listens, never serving (or promoting) on the
    host."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for key, value in {"SERVER_DURABILITY_ENABLED": "1", "SERVER_STATE_FILE": "s.json",
                       "SERVER_REPLICATION_ENABLED": "1", "SERVER_REPLICATION_ROLE": role,
                       "SERVER_REPLICATION_PEER": "127.0.0.1:1"}.items():
        monkeypatch.setenv(key, value)
    args = t_main.parse_args(["--no-repl", "--port", "0"])
    assert t_main.resolve_config(args).tpu.backend == "tpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(t_main.amain(args))


def test_load_state_quarantines_corrupt_snapshot(tmp_path):
    path = tmp_path / "state.json"
    path.write_text('{"version": 1, "users": [')  # torn write
    cfg = ServerConfig()
    cfg.state_file = str(path)

    state, durability = run(t_main.load_state(cfg))
    assert durability is None
    assert run(state.user_count()) == 0
    assert not path.exists()
    quarantined = list(tmp_path.glob("state.json.corrupt-*"))
    assert len(quarantined) == 1
    assert quarantined[0].stat().st_mode & 0o777 == 0o600


def test_load_state_restores_and_sizes_from_config(tmp_path):
    path = str(tmp_path / "state.json")
    params, proofs = _make_proofs(2)

    async def write():
        st = ServerState()
        for i, (statement, _) in enumerate(proofs):
            await st.register_user(UserData(f"u{i}", statement, 1))
        await st.create_session("tok", "u0")
        assert await st.snapshot(path)

    run(write())
    cfg = ServerConfig()
    cfg.state_file = path
    cfg.replication.shards = 4
    state, _ = run(t_main.load_state(cfg))
    assert (run(state.user_count()), run(state.session_count())) == (2, 1)
    assert state.num_shards == 4


def test_cleanup_sweep_checkpoints_and_freezes(tmp_path, monkeypatch):
    """Each sweep expires, checkpoints to the state file, then freezes the
    surviving graph out of the collector's scans."""
    freezes = []
    monkeypatch.setattr(t_main, "CLEANUP_INTERVAL_SECONDS", 0.05)
    monkeypatch.setattr(t_main.gc, "freeze", lambda: freezes.append(time.monotonic()))
    path = tmp_path / "state.json"
    params, proofs = _make_proofs(1)

    async def main():
        state = ServerState()
        await state.register_user(UserData("u0", proofs[0][0], 1))
        stop = asyncio.Event()
        task = asyncio.create_task(t_main.cleanup_supervisor(state, stop, str(path)))
        deadline = time.monotonic() + 10
        while len(freezes) < 2 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        stop.set()
        await task

    run(main())
    assert len(freezes) >= 2
    assert path.exists() and path.stat().st_mode & 0o777 == 0o600


# --- the daemon on the card's path (plain versions on the CPU) ---------------------


def _http(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.read().decode()


def test_daemon_serves_logins_on_the_card_path_and_restores(tmp_path):
    """``backend = "tpu"`` through ``amain`` (here on the kernels' plain
    versions): a login batch answers exactly, the replay is refused, the
    flight recorder shows the batch with a device interval, no failover
    exists, SIGTERM exits 0 with a snapshot, and a second daemon on the
    same state file restores the users and logs one in."""
    state_file = tmp_path / "state.json"
    toml = (
        f'state_file = "{state_file}"\n'
        '[tpu]\nbackend = "tpu"\nbatch_max = 64\nbatch_window_ms = 50.0\n'
        "[rate_limit]\nrequests_per_minute = 1000000\nburst = 100000\n"
        "[opsplane]\nenabled = true\nport = 0\n"
    )
    rng = np.random.default_rng(3)

    class Rng:
        def fill_bytes(self, n):
            return rng.bytes(n)

    gen = Rng()
    params = J.Parameters.new()
    provers = [J.Prover(params, J.Witness(J.Ristretto255.random_scalar(gen)))
               for _ in range(6)]
    ids = [f"d{i}" for i in range(6)]
    eb = J.Ristretto255.element_to_bytes

    async def logins(port, replay: bool):
        async with AuthClient(f"127.0.0.1:{port}") as client:
            if replay:
                resp = await client.register_batch(
                    ids, [eb(p.statement.y1) for p in provers],
                    [eb(p.statement.y2) for p in provers])
                assert all(r.success for r in resp.results)
            cids, proofs = [], []
            for uid, p in zip(ids, provers):
                cid = bytes((await client.create_challenge(uid)).challenge_id)
                t = J.Transcript()
                t.append_context(cid if uid != "d2" else b"elsewhere")
                cids.append(cid)
                proofs.append(p.prove_with_transcript(gen, t).to_bytes())
            proofs[4] = proofs[4][:5] + b"\xff" * 32 + proofs[4][37:]
            resp = await client.verify_proof_batch(ids, cids, proofs)
            got = [(r.success, r.message, bool(r.session_token)) for r in resp.results]
            again = None
            if replay:
                again = await client.verify_proof_batch(ids, cids, proofs)
                again = [(r.success, r.message) for r in again.results]
            return got, again

    daemon = Daemon("port", tmp_path / "a", toml,
                    env={"CPZK_CLEANUP_INTERVAL_S": "1"}).wait_listening()
    try:
        assert daemon.ops_port is not None
        got, again = run(logins(daemon.port, replay=True))
        fail = (False, "Authentication failed", False)
        bad = (False, "Invalid proof: Bytes do not represent a valid Ristretto point", False)
        ok = [(True, f"User '{uid}' authenticated successfully", True) for uid in ids]
        assert got == [ok[0], ok[1], fail, ok[3], bad, ok[5]], got
        assert again == [(False, "Authentication failed")] * 6
        flight = json.loads(_http(daemon.ops_port, "/flightrec"))
        batches = [r for r in flight["records"] if r["backend"] == "torch"]
        assert sum(r["batch"] for r in batches) == 6  # the undecodable one fails in the batch
        assert all(r["device_interval_s"] > 0 for r in batches)
        text = _http(daemon.ops_port, "/metrics")
        assert "tpu_backend_failover" not in text or re.search(
            r"^tpu_backend_failover_total 0\.0$", text, re.M)
        statusz = json.loads(_http(daemon.ops_port, "/statusz"))
        assert statusz["breaker"] is None  # the card served bare
        assert statusz["shards"]["users"] == 6
        time.sleep(1.5)  # one sweep: checkpoint + freeze
    finally:
        rc = daemon.terminate()
    assert rc == 0, daemon.logs()[-3000:]
    assert "state snapshot written" in daemon.logs()
    assert state_file.exists()

    daemon = Daemon("port", tmp_path / "b", toml).wait_listening()
    try:
        assert "restored state snapshot: 6 users, 4 sessions" in daemon.logs()
        got, _ = run(logins(daemon.port, replay=False))
        assert [g[0] for g in got] == [True, True, False, True, False, True]
    finally:
        assert daemon.terminate() == 0
