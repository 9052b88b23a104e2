"""Twins of ``tests/test_admission.py`` for the port's admission subsystem
(``cpzk_tpu_torch/admission/``) and retry policy
(``cpzk_tpu_torch/resilience/retry.py``).

The unit cases drive the reference's and the port's classes with the same
injected clocks, signals and seeded ``random.Random`` and require equal
decisions, levels and sleeps.  The gRPC cases run one scenario against
the reference's server and the port's (``tests/torch_grpc_twins.py``),
each with its own package's ``AdmissionController``, through the
reference's ``AuthClient`` (the port's client is not ported yet), and
require equal responses, status codes and ``cpzk-retry-after-ms``
trailers.  Beyond the twins: a client key forwarded through an ingest
shard is the peer's and the client's, never the shard's socket.
"""

import asyncio
import dataclasses
import os
import pathlib
import random
import re
import types

import grpc
import pytest

import cpzk_tpu.admission as j_adm
import cpzk_tpu.resilience.retry as j_retry
import cpzk_tpu.server.__main__ as j_main
import cpzk_tpu.server.config as j_config
import cpzk_tpu.server.metrics as j_metrics
import cpzk_tpu.server.state as j_state
import cpzk_tpu_torch.admission as t_adm
import cpzk_tpu_torch.resilience.retry as t_retry
import cpzk_tpu_torch.server.__main__ as t_main
import cpzk_tpu_torch.server.config as t_config
import cpzk_tpu_torch.server.metrics as t_metrics
import cpzk_tpu_torch.server.state as t_state
from cpzk_tpu.client import AuthClient
from torch_grpc_twins import twin_check

ROOT = pathlib.Path(__file__).resolve().parent.parent

SIDES = {
    "reference": types.SimpleNamespace(adm=j_adm, retry=j_retry, cfg=j_config,
                                       metrics=j_metrics, main=j_main, state=j_state),
    "port": types.SimpleNamespace(adm=t_adm, retry=t_retry, cfg=t_config,
                                  metrics=t_metrics, main=t_main, state=t_state),
}


def run(coro):
    return asyncio.run(coro)


def both(scenario):
    """``scenario(side)`` on the reference, then on the port: equal
    results required; returns the port's."""
    out = {name: scenario(side) for name, side in SIDES.items()}
    assert out["port"] == out["reference"]
    return out["port"]


def decision(r):
    return None if r is None else (r.reason, r.message, r.retry_after_s, r.tier)


# --- keyed token buckets -----------------------------------------------------


def test_keyed_buckets_admit_burst_then_throttle_and_refill():
    def scenario(side):
        t = [0.0]
        kb = side.adm.KeyedTokenBuckets(60, burst=3, max_keys=8, clock=lambda: t[0])
        out = [kb.check("a") for _ in range(4)] + [kb.check("b")]
        t[0] = 1.0
        return out + [kb.check("a"), kb.check("a")]

    out = both(scenario)
    assert out[:3] == [None] * 3 and out[3] == pytest.approx(1.0)
    assert out[4] is None and out[5] is None and out[6] is not None


def test_keyed_buckets_lru_bound_and_disabled_mode():
    def scenario(side):
        t = [0.0]
        kb = side.adm.KeyedTokenBuckets(60, burst=1, max_keys=4, clock=lambda: t[0])
        for i in range(100):
            kb.check(f"key-{i}")
        kb2 = side.adm.KeyedTokenBuckets(60, burst=5, max_keys=2, clock=lambda: t[0])
        kb2.check("old"), kb2.check("mid"), kb2.check("old"), kb2.check("new")
        off = side.adm.KeyedTokenBuckets(0, burst=1, max_keys=2, clock=lambda: t[0])
        offs = [off.check(f"k{i}") for i in range(50)]
        return (len(kb), kb.evictions, len(kb2), kb2.check("old"), set(offs),
                len(off), off.enabled)

    assert both(scenario) == (4, 96, 2, None, {None}, 0, False)


def test_client_key_prefers_metadata_tag_then_peer_host():
    class Ctx:
        def __init__(self, md, peer):
            self._md, self._peer = md, peer

        def invocation_metadata(self):
            return self._md

        def peer(self):
            return self._peer

    contexts = [
        Ctx([("cpzk-client-id", "alice")], "ipv4:1.2.3.4:55"),
        Ctx([("CPZK-Client-Id", b"bob")], ""),
        Ctx([], "ipv4:1.2.3.4:55001"),
        Ctx([], "ipv6:[::1]:55001"),
        Ctx([], "unix:/tmp/s.sock"),
        Ctx([("cpzk-client-id", "x" * 4096)], ""),
        object(),
    ]
    keys = both(lambda side: [side.adm.client_key(c) for c in contexts])
    assert keys[:5] == ["id:alice", "id:bob", "peer:ipv4:1.2.3.4", "peer:ipv6:[::1]",
                        "peer:unix:/tmp/s.sock"]
    assert len(keys[5]) <= 128 and keys[6] == "peer:unknown"
    assert (t_adm.CLIENT_ID_KEY, t_adm.RETRY_PUSHBACK_KEY) == (
        j_adm.CLIENT_ID_KEY, j_adm.RETRY_PUSHBACK_KEY)


# --- classification + adaptive controller ------------------------------------


def test_classify_tiers_and_totality():
    names = ["VerifyProof", "VerifyProofBatch", "CreateChallenge", "Register",
             "RegisterBatch", "", "Nope", None, 42, b"\xff\x00", object()]
    tiers = both(lambda side: [side.adm.classify(n) for n in names])
    assert tiers == [0, 0, 1, 2, 2, 2, 2, 2, 2, 2, 2]


def _controller(side, signals, clock, **kw):
    kw.setdefault("per_client_rpm", 0)
    kw.setdefault("adjust_interval_ms", 10.0)
    kw.setdefault("increase_step", 0.5)
    kw.setdefault("decrease_factor", 0.5)
    return side.adm.AdmissionController(
        side.cfg.AdmissionSettings(**kw), clock=clock, signals=signals)


def test_aimd_sheds_lowest_tier_first_and_recovers():
    def scenario(side):
        t = [0.0]
        sig = [(0.0, 0.0)]
        c = _controller(side, lambda: sig[0], lambda: t[0])
        trace = [c.level]

        def admit(rpc, advance=True):
            if advance:
                t[0] += 0.011
            trace.append((rpc, decision(c.admit(rpc, "k")), c.level))

        for rpc in ("Register", "CreateChallenge", "VerifyProof"):
            admit(rpc, advance=False)
        sig[0] = (0.95, 0.0)
        admit("Register")
        admit("CreateChallenge", advance=False)
        admit("VerifyProof", advance=False)
        admit("CreateChallenge")
        for _ in range(5):
            admit("VerifyProof")
        sig[0] = (0.1, 0.0)
        admit("VerifyProof")
        admit("CreateChallenge")
        admit("Register", advance=False)
        admit("Register")
        admit("Register")
        return trace

    trace = both(scenario)
    assert trace[0] == 3.0
    assert trace[4][1][0] == "priority" and trace[4][2] == 1.5
    assert trace[7][1][0] == "priority" and trace[7][2] == t_adm.MIN_LEVEL
    assert all(step[1] is None for step in trace[8:13])  # verify never shed
    assert trace[-3][1] is not None and trace[-2][1] is None
    assert trace[-1][2] == pytest.approx(3.0)


def test_queue_wait_signal_alone_triggers_shedding():
    def scenario(side):
        t = [0.0]
        c = _controller(side, lambda: (0.0, 0.2), lambda: t[0], target_queue_wait_ms=50.0)
        t[0] += 0.011
        return decision(c.admit("Register", "k")), c.level

    (reason, *_), level = both(scenario)
    assert reason == "priority" and level == 1.5


def test_hysteresis_band_freezes_level():
    def scenario(side):
        t = [0.0]
        c = _controller(side, lambda: (0.6, 0.0), lambda: t[0])
        c.level = 2.0
        for _ in range(5):
            t[0] += 0.011
            c.admit("VerifyProof", "k")
        return c.level

    assert both(scenario) == 2.0


def test_per_client_bucket_checked_before_priority():
    def scenario(side):
        t = [0.0]
        c = _controller(side, lambda: (0.0, 0.0), lambda: t[0], per_client_rpm=60,
                        per_client_burst=1)
        out = [decision(c.admit("VerifyProof", "hot")) for _ in range(2)]
        out.append(decision(c.admit("VerifyProof", "cold")))
        assert out[1][2] >= c.settings.retry_after_min_ms / 1000.0
        return out

    out = both(scenario)
    assert out[0] is None and out[1][0] == "per_client" and out[2] is None


def test_retry_after_sized_from_drain_rate():
    class FakeBatcher:
        window = 0.005
        max_batch = 64

        def __init__(self, depth, cap, rate):
            self._snap, self._rate = (depth, cap), rate

        def load_snapshot(self):
            return self._snap

        def drain_rate(self):
            return self._rate

    def scenario(side):
        s = side.cfg.AdmissionSettings(retry_after_min_ms=10, retry_after_max_ms=2000)
        out = []
        for batcher in (FakeBatcher(100, 256, 200.0), FakeBatcher(1, 256, 1e6),
                        FakeBatcher(10**6, 256, 1.0), FakeBatcher(5, 256, 0.0), None):
            c = side.adm.AdmissionController(s, batcher=batcher, clock=lambda: 0.0,
                                             signals=lambda: (0, 0))
            out.append(c.retry_after_s())
        return out

    out = both(scenario)
    assert out[:3] == [pytest.approx(0.5), pytest.approx(0.010), pytest.approx(2.0)]
    assert out[4] == pytest.approx(0.010)


# --- retry pushback (gRFC A6) ------------------------------------------------


def test_policy_sleep_prefers_pushback_over_jitter():
    def scenario(side):
        pol = side.retry.RetryPolicy(initial_backoff_s=0.05, max_backoff_s=1.0)
        rng = random.Random(0)
        out = [pol.sleep_s(1, pushback_ms=123.0, rng=rng),
               pol.sleep_s(5, pushback_ms=0.0, rng=rng),
               pol.sleep_s(1, pushback_ms=10**9, rng=rng)]
        return out + [pol.sleep_s(1, rng=rng) for _ in range(50)]

    out = both(scenario)
    assert out[0] == pytest.approx(0.123) and out[1] == 0.0
    assert out[2] == t_retry.MAX_PUSHBACK_S == j_retry.MAX_PUSHBACK_S
    assert all(0.0 <= s <= 0.05 for s in out[3:])


class PushbackRpcError(grpc.RpcError):
    def __init__(self, code, trailing=()):
        self._code, self._trailing = code, trailing

    def code(self):
        return self._code

    def details(self):
        return "shed"

    def trailing_metadata(self):
        return self._trailing


def test_client_honors_pushback_and_budget(monkeypatch):
    """The reference's client, holding each package's ``RetryPolicy`` and
    ``RetryBudget``, against each package's server: the sleeps are exactly
    the advertised pushback, negative pushback stops retrying, and the
    budget bounds the retries."""
    import cpzk_tpu.client.rpc as rpc_mod

    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)

    monkeypatch.setattr(rpc_mod, "asyncio", types.SimpleNamespace(sleep=fake_sleep))

    async def body(t):
        retry = SIDES[t.side].retry
        key = retry.RETRY_PUSHBACK_KEY
        client = AuthClient(f"127.0.0.1:{t.port}",
                            retry=retry.RetryPolicy(max_attempts=4, initial_backoff_s=5.0,
                                                    max_backoff_s=9.0),
                            retry_rng=random.Random(1))
        async with client:
            calls = {"n": 0}
            md = ((key, "217"),)

            async def shed_twice(request, timeout=None, metadata=None):
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise PushbackRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED, md)
                return object()

            sleeps.clear()
            client._stubs["CreateChallenge"] = shed_twice
            await client.create_challenge("someone")
            t.note(("shed twice", tuple(sleeps), calls["n"]))

            calls["n"] = 0
            sleeps.clear()

            async def shed_forever(request, timeout=None, metadata=None):
                calls["n"] += 1
                raise PushbackRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED, ((key, "-1"),))

            client._stubs["CreateChallenge"] = shed_forever
            t.note(await t.call(client.create_challenge("someone")))
            t.note(("do not retry", calls["n"], tuple(sleeps)))

            calls["n"] = 0
            sleeps.clear()
            client.retry = retry.RetryPolicy(
                max_attempts=10, initial_backoff_s=0.001, max_backoff_s=0.002,
                budget=retry.RetryBudget(tokens=2.0, token_ratio=0.0))

            async def shed_with_pushback(request, timeout=None, metadata=None):
                calls["n"] += 1
                raise PushbackRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED, md)

            client._stubs["CreateChallenge"] = shed_with_pushback
            t.note(await t.call(client.create_challenge("someone")))
            t.note(("budget", calls["n"], tuple(sleeps)))

    async def scenario(t):
        await t.start(client=False)
        try:
            await body(t)
        finally:
            await t.stop()

    obs = twin_check(scenario, seed=3)
    assert obs[0] == ("shed twice", (0.217, 0.217), 3)
    assert obs[2] == ("do not retry", 1, ())
    assert obs[4] == ("budget", 3, (0.217, 0.217))


def _trailer(err) -> float:
    trailing = {str(k).lower(): v for k, v in err.trailing_metadata()}
    return float(trailing[t_retry.RETRY_PUSHBACK_KEY])


def test_every_resource_exhausted_path_carries_pushback():
    async def body(t):
        t.note(await t.call(t.client.create_challenge("nobody")))  # NOT_FOUND, admitted
        err = await t.call(t.client.create_challenge("nobody"))
        assert isinstance(err, grpc.RpcError)
        assert err.code() == grpc.StatusCode.RESOURCE_EXHAUSTED and _trailer(err) >= 0
        t.note(("code", err.code().name, err.details()))

    async def scenario(t):
        await t.start(rate=60, burst=1)  # burst 1: the second RPC trips the bucket
        try:
            await body(t)
        finally:
            await t.stop()

    obs = twin_check(scenario, seed=4)
    assert obs[0][:2] == ("error", "NOT_FOUND")
    assert obs[1] == ("code", "RESOURCE_EXHAUSTED", "Rate limit exceeded")


def test_admission_rejection_carries_pushback_over_grpc():
    async def scenario(t):
        side = SIDES[t.side]
        controller = side.adm.AdmissionController(
            side.cfg.AdmissionSettings(per_client_rpm=60, per_client_burst=1))
        await t.start(client=False, admission=controller)
        try:
            async with AuthClient(f"127.0.0.1:{t.port}", client_id="hot-client") as client:
                t.note(await t.call(client.create_challenge("nobody")))
                err = await t.call(client.create_challenge("nobody"))
                assert err.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                assert "Per-client" in err.details() and _trailer(err) >= 0
                t.note(("shed", err.code().name, err.details()))
            async with AuthClient(f"127.0.0.1:{t.port}", client_id="polite-client") as other:
                t.note(await t.call(other.create_challenge("nobody")))
        finally:
            await t.stop()

    obs = twin_check(scenario, seed=5)
    assert obs[0][:2] == ("error", "NOT_FOUND") and obs[2][:2] == ("error", "NOT_FOUND")
    assert obs[1] == ("shed", "RESOURCE_EXHAUSTED", "Per-client rate limit exceeded")


# --- readiness split ---------------------------------------------------------


def test_readiness_not_serving_while_degraded_or_recovering():
    from cpzk_tpu.server.proto import load_health_pb2

    hpb2 = load_health_pb2()
    names = {v: k for k, v in hpb2.HealthCheckResponse.ServingStatus.items()}

    async def scenario(t):
        faults = t.module("resilience.faults")
        batch = t.module("protocol.batch")
        backend = batch.FailoverBackend(
            faults.FaultInjectionBackend(t.pkg.CpuBackend(), faults.FaultPlan().fail_after(0)),
            t.pkg.CpuBackend(), recovery_after_s=None)
        await t.start(backend=backend)
        server, client = t.server, t.client

        async def views(label):
            t.note((label, names[(await client.health_check()).status],
                    names[(await client.health_check(service="readiness")).status],
                    names[(await client.health_check(service="auth.AuthService")).status]))

        try:
            await views("healthy")
            server.health.recovering = True  # WAL recovery in flight
            await views("recovering")
            server.health.recovering = False
            backend.breaker.record_failure()
            assert backend.degraded
            await views("breaker open")
            backend.reset()
            await views("re-armed")
            server.health.serving = False
            await views("draining")
        finally:
            await t.stop()

    obs = twin_check(scenario, seed=6)
    assert obs == [("healthy", "SERVING", "SERVING", "SERVING"),
                   ("recovering", "SERVING", "NOT_SERVING", "NOT_SERVING"),
                   ("breaker open", "SERVING", "NOT_SERVING", "NOT_SERVING"),
                   ("re-armed", "SERVING", "SERVING", "SERVING"),
                   ("draining", "NOT_SERVING", "NOT_SERVING", "NOT_SERVING")]


# --- REPL /overload ----------------------------------------------------------


def test_overload_repl_command():
    def scenario(side):
        async def go():
            state = side.state.ServerState()
            off, quit_ = await side.main.handle_command("/overload", state, None, None, None)
            assert "admission control disabled" in off and not quit_
            t = [0.0]
            c = _controller(side, lambda: (0.0, 0.0), lambda: t[0], per_client_rpm=60,
                            per_client_burst=1)
            c.admit("VerifyProof", "a")
            c.admit("VerifyProof", "a")
            out, quit_ = await side.main.handle_command("/ov", state, None, None, c)
            assert not quit_
            return off, out

        return run(go())

    outs = {name: scenario(side) for name, side in SIDES.items()}
    # the shed counters are process-wide: compare the line up to them
    heads = {name: (off, out.split(" admitted=")[0]) for name, (off, out) in outs.items()}
    assert heads["port"] == heads["reference"]
    out = outs["port"][1]
    assert "level=3.00/3" in out and "admitting=verify+challenge+register" in out
    assert "clients=1/1024" in out
    assert re.search(r"shed\{client=\d+ priority=\d+ global=\d+\}", out)


# --- config: layering, validation, drift guard -------------------------------


def test_admission_config_layering_and_validation(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for key in [k for k in os.environ if k.startswith("SERVER_")]:
        monkeypatch.delenv(key)

    def scenario(side):
        monkeypatch.delenv("SERVER_CONFIG_PATH", raising=False)
        for key in ("SERVER_ADMISSION_PER_CLIENT_RPM", "SERVER_ADMISSION_HIGH_WATERMARK",
                    "SERVER_ADMISSION_ENABLED"):
            monkeypatch.delenv(key, raising=False)
        cfg = side.cfg.ServerConfig.from_env()
        notes = [dataclasses.asdict(cfg.admission)]
        cfg.validate()
        (tmp_path / "server.toml").write_text(
            "[admission]\nper_client_rpm = 120\nmax_clients = 64\ndecrease_factor = 0.25\n")
        monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
        cfg = side.cfg.ServerConfig.from_env()
        notes.append(dataclasses.asdict(cfg.admission))
        cfg.validate()
        monkeypatch.setenv("SERVER_ADMISSION_PER_CLIENT_RPM", "30")
        monkeypatch.setenv("SERVER_ADMISSION_HIGH_WATERMARK", "0.9")
        monkeypatch.setenv("SERVER_ADMISSION_ENABLED", "false")
        notes.append(dataclasses.asdict(side.cfg.ServerConfig.from_env().admission))
        for kw in (dict(per_client_rpm=-1), dict(per_client_burst=0), dict(max_clients=0),
                   dict(low_watermark=0.8, high_watermark=0.5), dict(high_watermark=1.5),
                   dict(target_queue_wait_ms=-1), dict(adjust_interval_ms=0),
                   dict(increase_step=0), dict(decrease_factor=1.0),
                   dict(retry_after_min_ms=100, retry_after_max_ms=50)):
            bad = side.cfg.ServerConfig()
            for key, value in kw.items():
                setattr(bad.admission, key, value)
            with pytest.raises(ValueError, match="admission") as exc:
                bad.validate()
            notes.append(str(exc.value))
        return notes

    notes = both(scenario)
    assert notes[0]["enabled"] is True and notes[0]["per_client_rpm"] == 0
    assert (notes[1]["per_client_rpm"], notes[1]["max_clients"],
            notes[1]["decrease_factor"]) == (120, 64, 0.25)
    assert (notes[2]["per_client_rpm"], notes[2]["high_watermark"],
            notes[2]["enabled"]) == (30, 0.9, False)


def test_rate_limit_validation_rejects_negatives():
    def scenario(side):
        out = []
        for field, value, match in (("requests_per_minute", 0, "cannot be zero"),
                                    ("requests_per_minute", -5, "cannot be negative"),
                                    ("burst", 0, "cannot be zero"),
                                    ("burst", -1, "cannot be negative")):
            bad = side.cfg.ServerConfig()
            setattr(bad.rate_limit, field, value)
            with pytest.raises(ValueError, match=match) as exc:
                bad.validate()
            out.append(str(exc.value))
        return out

    both(scenario)


def test_admission_config_keys_documented():
    """The port's ``[admission]`` keys and defaults are the reference's, so
    the reference's drift guard (TOML example, .env example, operations-doc
    knob inventory) covers them."""
    keys = [f.name for f in dataclasses.fields(t_config.AdmissionSettings)]
    assert keys == [f.name for f in dataclasses.fields(j_config.AdmissionSettings)]
    assert dataclasses.asdict(t_config.AdmissionSettings()) == dataclasses.asdict(
        j_config.AdmissionSettings())
    toml_text = (ROOT / "config" / "server.toml.example").read_text()
    m = re.search(r"^\[admission\]$", toml_text, re.M)
    assert m
    section = toml_text[m.end():].split("\n[", 1)[0]
    env_text = (ROOT / ".env.example").read_text()
    docs = (ROOT / "docs" / "operations.md").read_text()
    for key in keys:
        assert re.search(rf"^{key}\s*=", section, re.M), key
        assert f"SERVER_ADMISSION_{key.upper()}" in env_text, key
        assert f"`admission.{key}`" in docs, key


def test_admission_metrics_registered_and_typed():
    def scenario(side):
        t = [0.0]
        c = _controller(side, lambda: (0.0, 0.0), lambda: t[0], per_client_rpm=60,
                        per_client_burst=1)
        m = side.metrics
        before = (m.read("admission.admitted"), m.read("admission.shed.per_client"))
        c.admit("VerifyProof", "m1")
        c.admit("VerifyProof", "m1")
        after = (m.read("admission.admitted"), m.read("admission.shed.per_client"))
        assert m.read("admission.level", kind="g") >= t_adm.MIN_LEVEL
        assert m.read("admission.clients", kind="g") >= 1.0
        # the families this controller wrote (others depend on which tests
        # ran before in the process)
        touched = ("admission.admitted", "admission.shed.per_client",
                   "admission.level", "admission.clients")
        kinds = {name: kind for kind, name in m.registered() if name in touched}
        return tuple(a - b for a, b in zip(after, before)), kinds

    deltas, kinds = both(scenario)
    assert deltas == (1.0, 1.0)
    assert kinds == {"admission.admitted": "c", "admission.shed.per_client": "c",
                     "admission.level": "g", "admission.clients": "g"}
    # the port's families live in its own registry, beside the reference's
    assert t_metrics.PROM_REGISTRY is not None


# --- admission through the ingest shards -----------------------------------------


def test_client_key_through_an_ingest_shard_is_the_clients():
    """The dispatch process keys admission on what the shard forwarded —
    the client's ``cpzk-client-id`` or its peer host — never the shard's
    unix socket."""
    from cpzk_tpu_torch.server.ingest import ShardContext

    assert t_adm.client_key(ShardContext(
        [("cpzk-client-id", "alice")], "ipv4:127.0.0.1:40001", None)) == "id:alice"
    assert t_adm.client_key(ShardContext([], "ipv4:10.0.0.7:40001", None)) == (
        "peer:ipv4:10.0.0.7")
    assert t_adm.client_key(ShardContext([], "ipv6:[::1]:40002", None)) == "peer:ipv6:[::1]"
