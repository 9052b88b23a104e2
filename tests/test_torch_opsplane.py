"""Twins of ``tests/test_opsplane.py`` for the port's ops plane
(``cpzk_tpu_torch/observability/opsplane.py``), SLO engine and the
``[opsplane]``/``[slo]`` config surface.

``test_statusz_e2e_with_replication_and_audit`` is held in three parts:
its admission and durability blocks in
``test_statusz_e2e_with_admission_and_durability``, its audit block in
``test_statusz_e2e_with_audit`` (driven by the port's client) and its
replication half in ``test_statusz_e2e_with_replication``; the first two
also hold the blocks of a daemon without ``[replication]`` and
``[fleet]`` (null, and a 404 at ``/partitionmap``).  The port's metrics live in its own
registry, so the exposition tests read only the port's families.  The
daemon cases boot ``python -m cpzk_tpu_torch.server --backend cpu``; the
client side of the gRPC cases is the reference's ``AuthClient``.
"""

import asyncio
import dataclasses
import json
import logging
import os
import pathlib
import re
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

import cpzk_tpu as J
from cpzk_tpu.client import AuthClient
from cpzk_tpu.server.config import ServerConfig as JServerConfig
from cpzk_tpu_torch.observability import get_tracer
from cpzk_tpu_torch.observability.flightrec import FlightRecord, get_flight_recorder
from cpzk_tpu_torch.observability.opsplane import ENDPOINTS, OpsPlane, OpsSources
from cpzk_tpu_torch.observability.slo import RPC_CLASSES, SloEngine
from cpzk_tpu_torch.protocol.batch import CpuBackend
from cpzk_tpu_torch.server import metrics
from cpzk_tpu_torch.server.config import (
    OpsplaneSettings,
    RateLimiter,
    ServerConfig,
    SloSettings,
)
from cpzk_tpu_torch.server.service import serve
from cpzk_tpu_torch.server.state import _LOCK_WAIT_STRIDE, ServerState, StateShard

ROOT = pathlib.Path(__file__).resolve().parent.parent
EB = J.Ristretto255.element_to_bytes

rng = J.SecureRng()
params = J.Parameters.new()


def run(coro):
    return asyncio.run(coro)


def http_get(port: int, path: str, timeout: float = 10.0):
    """(status, content_type, body bytes) — raises on transport errors,
    returns the error status for HTTP-level failures."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout
        ) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


async def aget(port: int, path: str):
    return await asyncio.to_thread(http_get, port, path)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def daemon_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env["SERVER_CONFIG_PATH"] = str(tmp_path / "no-such.toml")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


# --- exposition parity ---------------------------------------------------------


def test_exposition_contains_every_registered_family():
    """Every (kind, name) in the port's facade registry renders into the
    exposition text on the prometheus backing (the in-process one)."""
    metrics.counter("opsx.count").inc(3)
    metrics.gauge("opsx.depth").set(7)
    metrics.histogram("opsx.dur").observe(0.5)
    metrics.counter("opsx.labeled", labelnames=("rpc",)).labels(rpc="A").inc()
    text = metrics.render_exposition()
    for _kind, name in metrics.registered():
        assert metrics._sanitize(name) in text, name
    assert text.rstrip().endswith("# EOF")
    assert "# TYPE opsx_count counter" in text
    assert "# TYPE opsx_depth gauge" in text
    assert "# TYPE opsx_dur histogram" in text
    assert re.search(r'opsx_labeled(?:_total)?\{rpc="A"\} 1\.0', text)


_NOOP_PARITY_SCRIPT = """
import importlib.abc, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if fullname.split(".")[0] == "prometheus_client":
            raise ImportError("blocked")
        return None

sys.meta_path.insert(0, _Block())

from cpzk_tpu_torch.server import metrics

assert metrics.HAVE_PROMETHEUS is False
metrics.counter("opsx.count").inc(3)
metrics.gauge("opsx.depth").set(7)
metrics.histogram("opsx.dur").observe(0.5)
metrics.counter("opsx.labeled", labelnames=("rpc",)).labels(rpc="A").inc()
text = metrics.render_exposition()
for _kind, name in metrics.registered():
    assert metrics._sanitize(name) in text, name
assert "opsx_count_total 3.0" in text
assert "opsx_depth 7.0" in text
assert "opsx_dur_count 1.0" in text and "opsx_dur_sum 0.5" in text
assert 'opsx_labeled_total{rpc="A"} 1.0' in text
assert text.rstrip().endswith("# EOF")

import asyncio, urllib.request
from cpzk_tpu_torch.observability.opsplane import OpsPlane, OpsSources

async def main():
    plane = OpsPlane(OpsSources(), port=0)
    port = await plane.start()
    def get():
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10
        ) as r:
            return r.status, r.read().decode()
    status, body = await asyncio.to_thread(get)
    assert status == 200
    for _kind, name in metrics.registered():
        assert metrics._sanitize(name) in body, name
    await plane.stop()

asyncio.run(main())
assert not any(m.split(".")[0] in ("jax", "jaxlib", "cpzk_tpu") for m in sys.modules)
print("NOOP-EXPOSITION-OK")
"""


def test_exposition_parity_without_prometheus_subprocess():
    """The no-prometheus backing renders the identical family set —
    including over real HTTP through the ops plane."""
    result = subprocess.run(
        [sys.executable, "-c", _NOOP_PARITY_SCRIPT],
        capture_output=True, text=True, cwd=str(ROOT), env=dict(os.environ),
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert "NOOP-EXPOSITION-OK" in result.stdout


def test_kernel_launch_counts_exposed_when_loaded():
    """A scrape refreshes ``tpu.kernel.launches{kernel}`` from the CUDA
    kernels' launch counts, so another process (``chip_smoke.py``'s
    daemon phase) can read what the served traffic launched."""
    from cpzk_tpu_torch.ops import point_kernels as pk

    saved = dict(pk.LAUNCHES)
    try:
        pk.LAUNCHES.update(point_add=7, point_double_k=3)
        OpsSources().refresh_gauges()
        assert metrics.read("tpu.kernel.launches", "g",
                            labels={"kernel": "point_add"}) == 7.0
        assert metrics.read("tpu.kernel.launches", "g",
                            labels={"kernel": "point_double_k"}) == 3.0
        assert 'tpu_kernel_launches{kernel="point_add"} 7.0' in metrics.render_exposition()
    finally:
        pk.LAUNCHES.update(saved)


def test_scalar_and_msm_kernel_launch_counts_exposed_when_loaded():
    """The scrape reads every kernel module's counts (the scalar and MSM
    kernels too), each from ``sys.modules`` only."""
    from cpzk_tpu_torch.ops import msm_kernels as mk, scalar_kernels as sk

    saved = dict(sk.LAUNCHES), dict(mk.LAUNCHES)
    try:
        sk.LAUNCHES.update(rlc_scalars=2, scalar_recode=5)
        mk.LAUNCHES.update(msm_bucket=11, msm_window_reduce=13)
        OpsSources().refresh_gauges()
        for name, count in (("rlc_scalars", 2), ("scalar_recode", 5), ("msm_bucket", 11),
                            ("msm_window_reduce", 13)):
            assert metrics.read("tpu.kernel.launches", "g", labels={"kernel": name}) == count
        assert 'tpu_kernel_launches{kernel="msm_bucket"} 11.0' in metrics.render_exposition()
    finally:
        sk.LAUNCHES.update(saved[0])
        mk.LAUNCHES.update(saved[1])


def test_prover_and_keccak_kernel_launch_counts_exposed_when_loaded():
    """The batch prover's, the Keccak chain's and the wide reduction's
    counts reach the scrape like every other kernel's."""
    from cpzk_tpu_torch.ops import keccak_kernels as kk, prove_kernels as pvk
    from cpzk_tpu_torch.ops import scalar_kernels as sk

    saved = dict(kk.LAUNCHES), dict(pvk.LAUNCHES), dict(sk.LAUNCHES)
    try:
        kk.LAUNCHES.update(keccak_chain=3)
        pvk.LAUNCHES.update(comb_tables=2, commitments=7)
        sk.LAUNCHES.update(reduce_wide=5)
        OpsSources().refresh_gauges()
        for name, count in (("keccak_chain", 3), ("comb_tables", 2), ("commitments", 7),
                            ("reduce_wide", 5)):
            assert metrics.read("tpu.kernel.launches", "g", labels={"kernel": name}) == count
        assert 'tpu_kernel_launches{kernel="commitments"} 7.0' in metrics.render_exposition()
    finally:
        kk.LAUNCHES.update(saved[0])
        pvk.LAUNCHES.update(saved[1])
        sk.LAUNCHES.update(saved[2])


def test_kernel_launch_gauge_reads_any_loaded_kernel_module(monkeypatch):
    """Which modules the scrape exports is not a list: any loaded module of
    the ``ops`` package with a ``LAUNCHES`` dict, and no module outside
    it."""
    import types

    inside = types.ModuleType("cpzk_tpu_torch.ops.later_kernels")
    inside.LAUNCHES = {"later_kernel": 17}
    outside = types.ModuleType("elsewhere_kernels")
    outside.LAUNCHES = {"elsewhere_kernel": 19}
    monkeypatch.setitem(sys.modules, inside.__name__, inside)
    monkeypatch.setitem(sys.modules, outside.__name__, outside)
    OpsSources().refresh_gauges()
    assert metrics.read("tpu.kernel.launches", "g", labels={"kernel": "later_kernel"}) == 17
    assert 'kernel="elsewhere_kernel"' not in metrics.render_exposition()


def test_card_memory_gauge_only_where_cuda_is_initialized(monkeypatch):
    """Each daemon on a shared card reports the memory its own PyTorch
    allocator holds (``tpu.device.memory_reserved_bytes``), read at scrape
    time and only where CUDA is initialized: a host-only process (an
    ingest shard, ``backend = "cpu"``) exports nothing for it."""
    import types

    cold = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: False, memory_reserved=lambda: 1 / 0))
    monkeypatch.setitem(sys.modules, "torch", cold)
    OpsSources().refresh_gauges()  # never asks an uninitialized CUDA
    warm = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True, memory_reserved=lambda: 3 << 30))
    monkeypatch.setitem(sys.modules, "torch", warm)
    OpsSources().refresh_gauges()
    assert metrics.read("tpu.device.memory_reserved_bytes", "g") == float(3 << 30)


# --- one serializer for REPL / HTTP / SIGUSR2 ----------------------------------


def test_flightrec_dump_and_http_share_payload(tmp_path):
    rec = get_flight_recorder()
    rec.clear()
    rec.record(FlightRecord(batch=8, lanes=16, occupancy=0.5,
                            stages_s={"execute": 0.001}, wall_s=0.0011))
    payload = rec.payload()
    assert payload["schema"] == "cpzk-flightrec/1"
    path = tmp_path / "dump.json"
    rec.dump(str(path))
    dumped = json.loads(path.read_text())
    assert dumped["records"] == payload["records"]
    assert dumped["schema"] == payload["schema"]
    from cpzk_tpu_torch.observability import format_flightrec

    out = format_flightrec(payload)
    assert "#1" in out and "n=8" in out
    rec.clear()


def test_tracez_payload_roundtrips_repl_rendering():
    from cpzk_tpu_torch.observability import RequestContext, format_tracez

    tracer = get_tracer()
    tracer.clear()
    ctx = RequestContext()
    tracer.start(ctx, "OpsOp")
    tracer.add_span(ctx.trace_id, "queue_wait", 0.0, 0.002)
    tracer.finish(ctx.trace_id, "success")
    payload = tracer.payload()
    assert payload["schema"] == "cpzk-tracez/1"
    assert payload["traces"][0]["name"] == "OpsOp"
    assert payload["traces"][0]["spans"][0]["name"] == "queue_wait"
    out = format_tracez(payload)
    assert "OpsOp" in out and "queue_wait=2.00ms" in out
    tracer.clear()


# --- the HTTP server itself ----------------------------------------------------


def test_unknown_path_404_and_method_not_allowed():
    from cpzk_tpu.observability.opsplane import ENDPOINTS as J_ENDPOINTS

    assert ENDPOINTS == J_ENDPOINTS

    async def main():
        plane = OpsPlane(OpsSources(), port=0)
        port = await plane.start()
        try:
            status, ctype, body = await aget(port, "/definitely-not-a-path")
            assert status == 404 and "json" in ctype
            doc = json.loads(body)
            assert sorted(doc["endpoints"]) == sorted(ENDPOINTS)

            def post():
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/metrics", data=b"x",
                    method="POST",
                )
                try:
                    urllib.request.urlopen(req, timeout=10)
                except urllib.error.HTTPError as e:
                    return e.code
                return 200

            assert await asyncio.to_thread(post) == 405
            status, _, _ = await aget(port, "/slo")
            assert status == 404
            status, _, _ = await aget(port, "/partitionmap")
            assert status == 404  # no fleet source attached
        finally:
            await plane.stop()

    run(main())


def test_healthz_readiness_split():
    from cpzk_tpu_torch.server.service import HealthService

    async def main():
        health = HealthService()
        plane = OpsPlane(OpsSources(health=health), port=0)
        port = await plane.start()
        try:
            status, _, body = await aget(port, "/healthz")
            doc = json.loads(body)
            assert status == 200 and doc["live"] and doc["ready"]
            health.standby = True
            status, _, body = await aget(port, "/healthz")
            assert status == 200 and json.loads(body)["ready"] is False
            status, _, _ = await aget(port, "/healthz?service=readiness")
            assert status == 503
            health.standby = False
            health.serving = False
            status, _, _ = await aget(port, "/healthz")
            assert status == 503
        finally:
            await plane.stop()

    run(main())


def test_start_in_thread_serves_and_stops():
    plane = OpsPlane(OpsSources(role="audit"), port=0)
    port = plane.start_in_thread()
    try:
        status, _, body = http_get(port, "/healthz")
        assert status == 200
        assert json.loads(body)["live"] is True
        status, _, body = http_get(port, "/statusz")
        doc = json.loads(body)
        assert doc["role"] == "audit"
        # no subsystem attached: every control-plane block renders null
        for block in ("admission", "replication", "audit", "durability",
                      "fleet", "controller"):
            assert doc[block] is None, block
    finally:
        plane.stop_thread()
    with pytest.raises(OSError):
        http_get(port, "/healthz", timeout=2.0)


def test_statusz_e2e_with_admission_and_durability(tmp_path):
    """The admission and durability half of the reference's
    ``test_statusz_e2e_with_replication_and_audit``: a daemon-shaped
    stack (batcher + admission + snapshot/WAL durability) serves real
    logins, and /statusz fills the admission and durability blocks while
    the unported subsystems stay null."""
    from cpzk_tpu_torch.admission import AdmissionController
    from cpzk_tpu_torch.durability import DurabilityManager
    from cpzk_tpu_torch.server.batching import DynamicBatcher
    from cpzk_tpu_torch.server.config import AdmissionSettings, DurabilitySettings

    async def main():
        state = ServerState()
        mgr = DurabilityManager(state, DurabilitySettings(enabled=True),
                                str(tmp_path / "primary.json"))
        await mgr.recover()
        batcher = DynamicBatcher(CpuBackend(), max_batch=64, window_ms=5.0)
        admission = AdmissionController(AdmissionSettings(), batcher=batcher)
        server, port = await serve(
            state, RateLimiter(100_000, 100_000), port=0,
            batcher=batcher, admission=admission,
        )
        cfg = ServerConfig()
        sources = OpsSources(
            state=state, batcher=batcher, admission=admission, durability=mgr,
            health=server.health, service=server.auth_service,
            slo=SloEngine(cfg.slo), config_fingerprint=cfg.fingerprint(),
        )
        plane = OpsPlane(sources, port=0)
        ops_port = await plane.start()
        try:
            async with AuthClient(f"127.0.0.1:{port}") as client:
                provers = {}
                for i in range(4):
                    p = J.Prover(params, J.Witness(J.Ristretto255.random_scalar(rng)))
                    provers[f"ops-u{i}"] = p
                    resp = await client.register(
                        f"ops-u{i}", EB(p.statement.y1), EB(p.statement.y2))
                    assert resp.success
                for uid, p in provers.items():
                    ch = await client.create_challenge(uid)
                    t = J.Transcript()
                    t.append_context(bytes(ch.challenge_id))
                    resp = await client.verify_proof(
                        uid, ch.challenge_id,
                        p.prove_with_transcript(rng, t).to_bytes())
                    assert resp.success
            status, ctype, body = await aget(ops_port, "/statusz")
            assert status == 200 and "json" in ctype
            doc = json.loads(body)
            assert doc["batcher"]["queue_capacity"] == batcher.max_queue
            assert doc["shards"]["users"] == 4 and doc["shards"]["sessions"] == 4
            assert doc["dispatch"]["recorded_batches"] >= 1
            assert doc["admission"]["level"] > 0
            assert doc["admission"]["admitted_tiers"] == ["verify", "challenge", "register"]
            # 4 registrations, 4 challenges, 4 consumes, 4 sessions
            assert doc["durability"]["wal_seq"] == mgr.wal.seq == 16
            assert doc["durability"]["fsync_policy"] == "always"
            assert doc["health"] == {"live": True, "ready": True}
            # a daemon without [replication], [audit] and [fleet]
            for block in ("replication", "handover", "audit", "fleet", "controller"):
                assert doc[block] is None, block
            status, _, body = await aget(ops_port, "/partitionmap")
            assert status == 404 and "[fleet] is disabled" in json.loads(body)["error"]
        finally:
            await plane.stop()
            await batcher.stop()
            await server.stop(None)
            await mgr.close()

    run(main())


def test_statusz_e2e_with_audit(tmp_path):
    """The audit half of the reference's
    ``test_statusz_e2e_with_replication_and_audit``: a daemon-shaped stack
    (batcher + admission + the proof log) serves real logins through the
    port's client, and /statusz fills the audit block (one record per
    verify) while /metrics carries the proof-log families."""
    from cpzk_tpu_torch.admission import AdmissionController
    from cpzk_tpu_torch.audit import ProofLogWriter
    from cpzk_tpu_torch.client import AuthClient as TAuthClient
    from cpzk_tpu_torch.server.batching import DynamicBatcher
    from cpzk_tpu_torch.server.config import AdmissionSettings

    async def main():
        state = ServerState()
        batcher = DynamicBatcher(CpuBackend(), max_batch=64, window_ms=5.0)
        admission = AdmissionController(AdmissionSettings(), batcher=batcher)
        audit_log = ProofLogWriter(str(tmp_path / "proofs.log"))
        appends0 = metrics.read("audit.log.appends")
        server, port = await serve(
            state, RateLimiter(100_000, 100_000), port=0,
            batcher=batcher, admission=admission, audit_log=audit_log,
        )
        cfg = ServerConfig()
        sources = OpsSources(
            state=state, batcher=batcher, admission=admission, audit_log=audit_log,
            health=server.health, service=server.auth_service,
            slo=SloEngine(cfg.slo), config_fingerprint=cfg.fingerprint(),
        )
        plane = OpsPlane(sources, port=0)
        ops_port = await plane.start()
        try:
            async with TAuthClient(f"127.0.0.1:{port}") as client:
                provers = {}
                for i in range(4):
                    p = J.Prover(params, J.Witness(J.Ristretto255.random_scalar(rng)))
                    provers[f"ops-u{i}"] = p
                    resp = await client.register(
                        f"ops-u{i}", EB(p.statement.y1), EB(p.statement.y2))
                    assert resp.success
                for uid, p in provers.items():
                    ch = await client.create_challenge(uid)
                    t = J.Transcript()
                    t.append_context(bytes(ch.challenge_id))
                    resp = await client.verify_proof(
                        uid, ch.challenge_id,
                        p.prove_with_transcript(rng, t).to_bytes())
                    assert resp.success
            status, _, body = await aget(ops_port, "/statusz")
            assert status == 200
            doc = json.loads(body)
            # audit block: one record per verify
            assert doc["audit"]["seq"] == 4
            assert doc["audit"]["bytes"] > 0
            assert doc["audit"]["records_this_boot"] == 4
            # a daemon without [replication] and [fleet]
            for block in ("replication", "handover", "fleet", "controller"):
                assert doc[block] is None, block
            status, _, body = await aget(ops_port, "/partitionmap")
            assert status == 404 and "[fleet] is disabled" in json.loads(body)["error"]
            assert metrics.read("audit.log.appends") - appends0 == 4
            status, _, body = await aget(ops_port, "/metrics")
            assert status == 200 and b"audit_log_appends_total" in body
        finally:
            await plane.stop()
            await batcher.stop()
            await server.stop(None)
            audit_log.close()

    run(main())


def test_statusz_e2e_with_replication(tmp_path):
    """The replication half of the reference's
    ``test_statusz_e2e_with_replication_and_audit``: a daemon-shaped
    primary (batcher + admission + durability) shipping in sync mode to a
    real standby over gRPC serves logins through the port's client, and
    /statusz fills the replication block (primary, no lag, a fresh last
    ship) and the handover block, while /metrics carries the replication
    families and the ship-RTT and apply-lag histograms land."""
    from cpzk_tpu_torch.admission import AdmissionController
    from cpzk_tpu_torch.client import AuthClient as TAuthClient
    from cpzk_tpu_torch.durability import DurabilityManager
    from cpzk_tpu_torch.replication import SegmentShipper, StandbyReplica
    from cpzk_tpu_torch.server.batching import DynamicBatcher
    from cpzk_tpu_torch.server.config import (
        AdmissionSettings,
        DurabilitySettings,
        ReplicationSettings,
    )

    async def main():
        sstate = ServerState()
        smgr = DurabilityManager(sstate, DurabilitySettings(enabled=True),
                                 str(tmp_path / "standby.json"))
        await smgr.recover()
        replica = StandbyReplica(sstate, smgr, ReplicationSettings(
            enabled=True, role="standby", lease_ms=4000.0, renew_interval_ms=50.0,
            mode="sync", auto_promote=False))
        sserver, sport = await serve(sstate, RateLimiter(100_000, 100_000), port=0,
                                     backend=CpuBackend(), replica=replica)
        replica.start()
        pstate = ServerState()
        pmgr = DurabilityManager(pstate, DurabilitySettings(enabled=True),
                                 str(tmp_path / "primary.json"))
        await pmgr.recover()
        shipper = SegmentShipper(pstate, pmgr, ReplicationSettings(
            enabled=True, role="primary", peer=f"127.0.0.1:{sport}", lease_ms=4000.0,
            renew_interval_ms=50.0, mode="sync"))
        pmgr.attach_shipper(shipper)
        pstate.attach_replication_barrier(shipper.wait_replicated)
        batcher = DynamicBatcher(CpuBackend(), max_batch=64, window_ms=5.0)
        admission = AdmissionController(AdmissionSettings(), batcher=batcher)
        pserver, pport = await serve(pstate, RateLimiter(100_000, 100_000), port=0,
                                     batcher=batcher, admission=admission,
                                     replica=shipper)
        shipper.start()
        rtt0 = metrics.read_histogram("state.repl.ship_rtt")[0]
        lag0 = metrics.read_histogram("state.repl.apply_lag_seconds")[0]
        cfg = ServerConfig()
        sources = OpsSources(
            state=pstate, batcher=batcher, admission=admission, replication=shipper,
            durability=pmgr, health=pserver.health, service=pserver.auth_service,
            slo=SloEngine(cfg.slo), config_fingerprint=cfg.fingerprint(),
        )
        plane = OpsPlane(sources, port=0)
        ops_port = await plane.start()
        standby_plane = OpsPlane(OpsSources(state=sstate, replication=replica,
                                            durability=smgr, role="standby"), port=0)
        standby_ops = await standby_plane.start()
        try:
            async with TAuthClient(f"127.0.0.1:{pport}") as client:
                provers = {}
                for i in range(4):
                    p = J.Prover(params, J.Witness(J.Ristretto255.random_scalar(rng)))
                    provers[f"ops-u{i}"] = p
                    resp = await client.register(
                        f"ops-u{i}", EB(p.statement.y1), EB(p.statement.y2))
                    assert resp.success
                for uid, p in provers.items():
                    ch = await client.create_challenge(uid)
                    t = J.Transcript()
                    t.append_context(bytes(ch.challenge_id))
                    resp = await client.verify_proof(
                        uid, ch.challenge_id, p.prove_with_transcript(rng, t).to_bytes())
                    assert resp.success
            # sync mode: every acknowledged mutation is standby-applied
            assert shipper.acked_seq == pmgr.wal.seq == replica.applied_seq == 16
            status, _, body = await aget(ops_port, "/statusz")
            assert status == 200
            doc = json.loads(body)
            repl = doc["replication"]
            assert repl["role"] == "primary" and repl["mode"] == "sync"
            assert repl["lag_records"] == 0 and repl["wal_seq"] == repl["acked_seq"] == 16
            assert repl["last_ship_age_s"] is not None and not repl["fenced"]
            assert doc["handover"]["stage"] == "idle" and doc["handover"]["attempts"] == 0
            assert doc["durability"]["wal_seq"] == pmgr.wal.seq
            assert doc["shards"]["users"] == 4 and doc["shards"]["sessions"] == 4
            # the standby's view: applied up to the primary's head, unpromoted
            status, _, body = await aget(standby_ops, "/statusz")
            sdoc = json.loads(body)
            assert sdoc["replication"]["role"] == "standby"
            assert sdoc["replication"]["applied_seq"] == 16
            assert sdoc["handover"] is None
            assert metrics.read_histogram("state.repl.ship_rtt")[0] > rtt0
            assert metrics.read_histogram("state.repl.apply_lag_seconds")[0] > lag0
            status, _, body = await aget(ops_port, "/metrics")
            text = body.decode()
            for family in ("state_repl_role", "state_repl_ship_rtt",
                           "state_repl_segments_shipped", "state_repl_lag_records"):
                assert family in text, family
        finally:
            await plane.stop()
            await standby_plane.stop()
            await batcher.stop()
            await shipper.stop()
            await replica.stop()
            await pserver.stop(None)
            await sserver.stop(None)
            await pmgr.close()
            await smgr.close()

    run(main())


def test_statusz_reports_active_streams():
    """A live VerifyProofStream shows up as a per-stream /statusz row
    and in the auth.stream.active gauge, and unregisters on close."""

    async def main():
        state = ServerState()
        server, port = await serve(
            state, RateLimiter(10**9, 10**9), port=0, backend=CpuBackend(),
        )
        service = server.auth_service
        try:
            p = J.Prover(params, J.Witness(J.Ristretto255.random_scalar(rng)))
            async with AuthClient(f"127.0.0.1:{port}") as client:
                resp = await client.register(
                    "s-u0", EB(p.statement.y1), EB(p.statement.y2)
                )
                assert resp.success

                async def entry():
                    ch = await client.create_challenge("s-u0")
                    t = J.Transcript()
                    t.append_context(bytes(ch.challenge_id))
                    return ("s-u0", bytes(ch.challenge_id),
                            p.prove_with_transcript(rng, t).to_bytes())

                entries = [await entry(), await entry()]

                async def gen():
                    yield entries[0]
                    for _ in range(500):
                        if service.stream_stats()["active"] == 1:
                            break
                        await asyncio.sleep(0.01)
                    stats = service.stream_stats()
                    assert stats["active"] == 1
                    assert metrics.read("auth.stream.active", "g") == 1.0
                    yield entries[1]

                verdicts = [
                    v async for v in
                    client.verify_proof_stream(gen(), chunk=1)
                ]
                assert len(verdicts) == 2
                assert all(v.ok for v in verdicts)
            stats = service.stream_stats()
            assert stats["active"] == 0 and stats["streams"] == []
            assert metrics.read("auth.stream.active", "g") == 0.0
        finally:
            await server.stop(None)

    run(main())


# --- shard lock-wait sampling ----------------------------------------------------


def test_shard_lock_wait_is_stride_sampled():
    async def main():
        shard = StateShard()
        before = metrics.read_histogram("state.shard.lock_wait")[0]
        for _ in range(2 * _LOCK_WAIT_STRIDE):
            async with shard.lock:
                pass
        after = metrics.read_histogram("state.shard.lock_wait")[0]
        assert after - before == 2  # exactly 1-in-stride observed

    run(main())


def test_shard_stats_and_gauges():
    async def main():
        from cpzk_tpu_torch import Parameters, Prover, SecureRng, Witness
        from cpzk_tpu_torch.core.ristretto import Ristretto255
        from cpzk_tpu_torch.server.state import UserData

        state = ServerState(shards=4)
        trng = SecureRng()
        p = Prover(Parameters.new(), Witness(Ristretto255.random_scalar(trng)))
        await state.register_user(UserData("g-u0", p.statement, 1))
        stats = state.shard_stats()
        assert len(stats) == 4
        assert sum(s["users"] for s in stats) == 1
        state.export_shard_gauges()
        idx = str(state._shard_index("g-u0"))
        assert metrics.read(
            "state.shard.size", "g", labels={"shard": idx, "kind": "users"}
        ) == 1.0

    run(main())


# --- SLO engine ------------------------------------------------------------------


def _slo_drive(engine, clock, req, dur, ticks, dt, ok=0, fail=0,
               latency_s=None):
    for _ in range(ticks):
        clock[0] += dt
        if ok:
            req.labels(rpc="VerifyProof", outcome="success").inc(ok)
        if fail:
            req.labels(rpc="VerifyProof", outcome="failure").inc(fail)
        if latency_s is not None:
            dur.labels(rpc="VerifyProof").observe(latency_s)
        engine.tick()


def test_slo_burn_storm_pages_once_per_window_and_recovers(caplog):
    clock = [10_000.0]
    engine = SloEngine(SloSettings(), clock=lambda: clock[0])
    req = metrics.counter("rpc.requests", labelnames=("rpc", "outcome"))
    dur = metrics.histogram("rpc.duration", labelnames=("rpc",))
    tracer = get_tracer()
    tracer.clear()

    engine.tick()  # baseline sample
    _slo_drive(engine, clock, req, dur, ticks=10, dt=60.0, ok=600)
    view = engine.snapshot()["rpcs"]["VerifyProof"]
    assert view["windows"]["5m"]["burn_rate"] < 1.0
    assert view["error_budget_remaining"] == 1.0
    assert view["paging"] == []

    with caplog.at_level(logging.WARNING, "cpzk_tpu_torch.observability.slo"):
        _slo_drive(engine, clock, req, dur, ticks=5, dt=60.0,
                   ok=100, fail=100)
    view = engine.snapshot()["rpcs"]["VerifyProof"]
    assert view["windows"]["5m"]["burn_rate"] > engine.settings.fast_burn_threshold
    assert view["windows"]["1h"]["burn_rate"] > engine.settings.fast_burn_threshold
    assert "fast" in view["paging"]
    assert view["error_budget_remaining"] < 1.0
    assert metrics.read(
        "slo.burn_rate", "g", labels={"rpc": "VerifyProof", "window": "5m"}
    ) > engine.settings.fast_burn_threshold
    fast_warnings = [
        r for r in caplog.records if "SLO burn (fast)" in r.getMessage()
    ]
    assert len(fast_warnings) == 1
    events = [t for t in tracer.completed() if t.name == "slo_burn"]
    assert events and events[0].spans[0].attrs["rpc"] == "VerifyProof"

    _slo_drive(engine, clock, req, dur, ticks=100, dt=300.0, ok=1000)
    view = engine.snapshot()["rpcs"]["VerifyProof"]
    assert view["windows"]["5m"]["burn_rate"] == 0.0
    assert view["windows"]["6h"]["burn_rate"] < 1.0
    assert view["error_budget_remaining"] > 0.99
    assert view["paging"] == []
    tracer.clear()


def test_slo_latency_burn_component():
    clock = [50_000.0]
    settings = SloSettings(latency_ms="VerifyProof=100")
    engine = SloEngine(settings, clock=lambda: clock[0])
    assert engine.latency_ms["VerifyProof"] == 100.0
    req = metrics.counter("rpc.requests", labelnames=("rpc", "outcome"))
    dur = metrics.histogram("rpc.duration", labelnames=("rpc",))
    engine.tick()
    _slo_drive(engine, clock, req, dur, ticks=3, dt=60.0, ok=10,
               latency_s=0.4)
    view = engine.snapshot()["rpcs"]["VerifyProof"]
    w = view["windows"]["5m"]
    assert w["availability_burn"] == 0.0
    assert w["latency_burn"] == pytest.approx(4.0, rel=0.01)
    assert w["burn_rate"] == pytest.approx(4.0, rel=0.01)


def test_slo_known_burn_math():
    """1 failure in 1000 requests at a 99.9% target is burn exactly 1."""
    from cpzk_tpu.observability.slo import RPC_CLASSES as J_RPC_CLASSES

    clock = [90_000.0]
    engine = SloEngine(
        SloSettings(availability_target=0.999), clock=lambda: clock[0]
    )
    req = metrics.counter("rpc.requests", labelnames=("rpc", "outcome"))
    engine.tick()
    clock[0] += 60.0
    req.labels(rpc="CreateChallenge", outcome="success").inc(999)
    req.labels(rpc="CreateChallenge", outcome="failure").inc(1)
    engine.tick()
    view = engine.snapshot()["rpcs"]["CreateChallenge"]
    assert view["windows"]["5m"]["availability_burn"] == pytest.approx(
        1.0, rel=0.01
    )
    assert set(engine.snapshot()["rpcs"]) == set(RPC_CLASSES) == set(J_RPC_CLASSES)


# --- daemon: ops plane refuses to bind when disabled -----------------------------


def test_daemon_does_not_bind_opsplane_when_disabled(tmp_path):
    """[opsplane] enabled=false (the default) means NO HTTP listener —
    a real daemon boot, pinned by connection-refused on the configured
    ops port while gRPC is accepting."""
    grpc_port, ops_port = free_port(), free_port()
    env = daemon_env(tmp_path)
    env["SERVER_OPSPLANE_PORT"] = str(ops_port)
    proc = subprocess.Popen(
        [sys.executable, "-m", "cpzk_tpu_torch.server", "--no-repl",
         "--backend", "cpu", "--port", str(grpc_port)],
        cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            assert proc.poll() is None, "daemon died during boot"
            try:
                socket.create_connection(
                    ("127.0.0.1", grpc_port), timeout=0.5
                ).close()
                break
            except OSError:
                time.sleep(0.1)
        else:
            raise AssertionError("gRPC listener never came up")
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", ops_port), timeout=0.5)
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0


def test_daemon_metrics_fallback_without_prometheus(tmp_path):
    """--metrics with prometheus_client missing: the daemon serves the
    ops-plane text exposition on the metrics port, and says so."""
    shim = tmp_path / "prometheus_client.py"
    shim.write_text('raise ImportError("blocked for the fallback test")\n')
    grpc_port, metrics_port = free_port(), free_port()
    env = daemon_env(tmp_path)
    env["PYTHONPATH"] = f"{tmp_path}{os.pathsep}{env['PYTHONPATH']}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "cpzk_tpu_torch.server", "--no-repl",
         "--backend", "cpu", "--port", str(grpc_port),
         "--metrics", "--metrics-port", str(metrics_port)],
        cwd=str(tmp_path), env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            assert proc.poll() is None, proc.stderr.read()
            try:
                status, ctype, body = http_get(
                    metrics_port, "/metrics", timeout=0.5
                )
                break
            except OSError:
                time.sleep(0.1)
        else:
            raise AssertionError("fallback /metrics never came up")
        assert status == 200 and "text/plain" in ctype
        assert b"# EOF" in body
    finally:
        proc.terminate()
        try:
            _, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate(timeout=30)
    assert "prometheus_client is not installed" in err


# --- config surface --------------------------------------------------------------


def test_opsplane_slo_config_layering_and_env(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    cfg = ServerConfig.from_env()
    assert cfg.opsplane.enabled is False
    assert cfg.opsplane.port == 9092
    assert cfg.slo.availability_target == 0.999

    (tmp_path / "server.toml").write_text(
        "[opsplane]\nenabled = true\nport = 9192\n\n"
        '[slo]\navailability_target = 0.99\nlatency_ms = "VerifyProof=50"\n'
    )
    monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
    cfg = ServerConfig.from_env()
    assert cfg.opsplane.enabled is True and cfg.opsplane.port == 9192
    assert cfg.slo.availability_target == 0.99
    assert cfg.slo.parsed_latency_ms() == {"VerifyProof": 50.0}
    cfg.validate()

    monkeypatch.setenv("SERVER_OPSPLANE_PORT", "9292")
    monkeypatch.setenv("SERVER_SLO_FAST_BURN_THRESHOLD", "10")
    monkeypatch.setenv("SERVER_SLO_TICK_INTERVAL_MS", "250")
    cfg = ServerConfig.from_env()
    assert cfg.opsplane.port == 9292
    assert cfg.slo.fast_burn_threshold == 10.0
    assert cfg.slo.tick_interval_ms == 250.0
    cfg.validate()
    ref = JServerConfig.from_env()
    assert dataclasses.asdict(cfg.opsplane) == dataclasses.asdict(ref.opsplane)
    assert dataclasses.asdict(cfg.slo) == dataclasses.asdict(ref.slo)


def test_opsplane_slo_config_validation():
    for mutate, match in (
        (lambda c: setattr(c.opsplane, "port", 70000), "opsplane.port"),
        (lambda c: setattr(c.opsplane, "port", -1), "opsplane.port"),
        (lambda c: setattr(c.slo, "availability_target", 1.0),
         "availability_target"),
        (lambda c: setattr(c.slo, "availability_target", 0.0),
         "availability_target"),
        (lambda c: setattr(c.slo, "fast_burn_threshold", 0),
         "fast_burn_threshold"),
        (lambda c: setattr(c.slo, "slow_burn_threshold", -1),
         "slow_burn_threshold"),
        (lambda c: setattr(c.slo, "tick_interval_ms", 0),
         "tick_interval_ms"),
        (lambda c: setattr(c.slo, "latency_ms", "garbage"), "latency_ms"),
        (lambda c: setattr(c.slo, "latency_ms", "VerifyProof=-5"),
         "latency_ms"),
    ):
        cfg, ref = ServerConfig(), JServerConfig()
        mutate(cfg)
        mutate(ref)
        with pytest.raises(ValueError, match=match) as err:
            cfg.validate()
        with pytest.raises(ValueError) as ref_err:
            ref.validate()
        assert str(err.value) == str(ref_err.value)
    cfg = ServerConfig()
    cfg.opsplane.enabled = True
    cfg.opsplane.host = ""
    with pytest.raises(ValueError, match="host"):
        cfg.validate()
    cfg = ServerConfig()
    cfg.opsplane.port = 0
    cfg.validate()


def test_opsplane_slo_config_keys_documented():
    """Every [opsplane]/[slo] knob of the port ships in the TOML example,
    the .env example, and the operations-doc knob inventory (the files
    both packages read)."""
    docs = (ROOT / "docs" / "operations.md").read_text()
    toml_text = (ROOT / "config" / "server.toml.example").read_text()
    env_text = (ROOT / ".env.example").read_text()
    for section, cls in (
        ("opsplane", OpsplaneSettings), ("slo", SloSettings),
    ):
        keys = [f.name for f in dataclasses.fields(cls)]
        assert keys
        m = re.search(rf"^\[{section}\]$", toml_text, re.M)
        assert m, f"[{section}] section missing from server.toml.example"
        body = toml_text[m.end():].split("\n[", 1)[0]
        for key in keys:
            assert re.search(rf"^{key}\s*=", body, re.M), (
                f"[{section}] key {key!r} missing from server.toml.example"
            )
            assert f"SERVER_{section.upper()}_{key.upper()}" in env_text
            assert f"`{section}.{key}`" in docs


def test_config_fingerprint_stable_and_sensitive():
    a, b = ServerConfig(), ServerConfig()
    assert a.fingerprint() == b.fingerprint()
    assert len(a.fingerprint()) == 12
    b.opsplane.port = 9193
    assert a.fingerprint() != b.fingerprint()
    # the digest covers the same document as the reference's: equal
    # configs give equal fingerprints across the packages
    ref = JServerConfig()
    a.tpu.backend = ref.tpu.backend
    assert a.fingerprint() == ref.fingerprint()
