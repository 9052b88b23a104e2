"""The port's client (``cpzk_tpu_torch/client/``) held against the
reference's:

- the gRPC twins of ``test_torch_integration.py``,
  ``test_torch_batch_grpc.py``, ``test_torch_streaming.py`` and
  ``test_torch_grpc_serving.py``, each run with the reference's and with
  the port's ``AuthClient`` against both packages' servers: all four runs
  must record the same observations (unary flows, batch RPCs, stream
  chunks, deadlines, overload sheds, retried trace metadata);
- retry pushback: the port's client with each package's ``RetryPolicy``
  sleeps exactly the advertised ``cpzk-retry-after-ms``, stops on a
  negative one, and spends the retry budget, as the reference's does;
- partition redirects: the port's client with a stale partition map
  converges on the reference's two-partition fleet in one redirect per
  attempt, charging the retry budget, as the reference's client does (the
  port's own fleet is held in ``tests/test_torch_fleet.py``);
- twins of ``tests/test_chaos.py``'s client cases
  (``test_client_retries_transient_codes_only_for_safe_rpcs``,
  ``test_client_without_policy_never_retries``) and of
  ``test_overload_storm_fairness_and_priority_ordering``, on the port's
  client, server and admission plane;
- the CLI: the ``stream`` subcommand and the REPL lines that need no
  password.

The port's servers are given ``CpuBackend`` (with no backend they mean the
card).
"""

import asyncio
import io
import json
import os
import random
import time
import types
from contextlib import redirect_stdout

import grpc
import pytest

import cpzk_tpu.client.rpc as j_rpc
import cpzk_tpu.resilience.retry as j_retry
import cpzk_tpu_torch.client.rpc as t_rpc
import cpzk_tpu_torch.resilience.retry as t_retry
import test_torch_batch_grpc as batch_twins
import test_torch_grpc_serving as serving_twins
import test_torch_integration as integration_twins
import test_torch_streaming as streaming_twins
from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.client import AuthClient
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.protocol.batch import CpuBackend
from cpzk_tpu_torch.resilience.retry import RetryBudget, RetryPolicy
from cpzk_tpu_torch.resilience.faults import FaultInjectionBackend, FaultPlan
from cpzk_tpu_torch.server import metrics
from cpzk_tpu_torch.server.batching import DynamicBatcher
from cpzk_tpu_torch.server.config import RateLimiter
from cpzk_tpu_torch.server.service import serve
from cpzk_tpu_torch.server.state import ServerState
from torch_grpc_twins import serving, twin_check

BOTH_CLIENTS = ("reference", "port")


def run(coro):
    return asyncio.run(coro)


# --- the gRPC twins, with both clients -------------------------------------------

CROSSED = (
    [(f"integration-{f.__name__}", serving(f), 11) for f in integration_twins.EXPECTED]
    + [(f"batch-{f.__name__}", serving(f), 23) for f in batch_twins.EXPECTED]
    + [(f"stream-{name}", entry[0], 53) for name, entry in streaming_twins.EXPECTED.items()]
    + [(f"serving-{name}", entry[0], 37) for name, entry in serving_twins.SCENARIOS.items()]
)


@pytest.mark.parametrize("name,scenario,seed", CROSSED, ids=[c[0] for c in CROSSED])
def test_both_clients_against_both_servers(name, scenario, seed):
    twin_check(scenario, seed=seed, clients=BOTH_CLIENTS)


# --- retry pushback --------------------------------------------------------------


class PushbackRpcError(grpc.RpcError):
    def __init__(self, code, trailing=()):
        self._code, self._trailing = code, trailing

    def code(self):
        return self._code

    def details(self):
        return "shed"

    def trailing_metadata(self):
        return self._trailing


def test_port_client_honors_pushback_and_budget(monkeypatch):
    """The twin of ``test_torch_admission.py::test_client_honors_pushback_and_budget``
    with the port's client beside the reference's: the sleeps are exactly
    the advertised pushback, negative pushback stops retrying, and the
    budget bounds the retries, against both servers."""
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)

    for mod in (j_rpc, t_rpc):
        monkeypatch.setattr(mod, "asyncio", types.SimpleNamespace(sleep=fake_sleep))
    retry_of = {"reference": j_retry, "port": t_retry}

    async def body(t):
        retry = retry_of[t.client_side]
        key = retry.RETRY_PUSHBACK_KEY
        client = t.AuthClient(
            f"127.0.0.1:{t.port}",
            retry=retry.RetryPolicy(max_attempts=4, initial_backoff_s=5.0, max_backoff_s=9.0),
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

    obs = twin_check(scenario, seed=3, clients=BOTH_CLIENTS)
    assert obs[0] == ("shed twice", (0.217, 0.217), 3)
    assert obs[2] == ("do not retry", 1, ())
    assert obs[4] == ("budget", 3, (0.217, 0.217))


# --- partition redirects on the reference's fleet ---------------------------------


def _statement(rng):
    prover = Prover(Parameters.new(), Witness(Ristretto255.random_scalar(rng)))
    eb = Ristretto255.element_to_bytes
    return prover, eb(prover.statement.y1), eb(prover.statement.y2)


def _uid_on(pmap, index: int) -> str:
    i = 0
    while pmap.partition_for(f"u{i}").index != index:
        i += 1
    return f"u{i}"


@pytest.mark.parametrize("client_side", BOTH_CLIENTS)
def test_client_redirects_on_the_reference_fleet(client_side):
    """On two reference servers behind a v1 map (their ``FleetRouter``s
    enforce ownership): a client routed by the map serves without a
    redirect; a stale one-partition map converges through one refresh and
    re-route per attempt; a redirect charges the retry budget, and an
    empty budget refuses the re-route.  Both clients, equal answers."""
    from cpzk_tpu.fleet import FleetRouter
    from cpzk_tpu.fleet import PartitionMap as JPartitionMap
    from cpzk_tpu.server.config import RateLimiter as JRateLimiter
    from cpzk_tpu.server.service import serve as j_serve
    from cpzk_tpu.server.state import ServerState as JServerState
    from cpzk_tpu_torch.fleet import PartitionMap as TPartitionMap

    client_cls, map_cls, retry = {
        "reference": (j_rpc.AuthClient, JPartitionMap, j_retry),
        "port": (AuthClient, TPartitionMap, t_retry),
    }[client_side]
    rng = SecureRng()

    async def main():
        states = [JServerState(), JServerState()]
        srv0, p0 = await j_serve(states[0], JRateLimiter(10**6, 10**6), port=0)
        srv1, p1 = await j_serve(states[1], JRateLimiter(10**6, 10**6), port=0)
        addrs = [f"127.0.0.1:{p0}", f"127.0.0.1:{p1}"]
        server_map = JPartitionMap.uniform(addrs)
        srv0.auth_service.fleet = FleetRouter(server_map, 0)
        srv1.auth_service.fleet = FleetRouter(server_map, 1)
        pmap = map_cls.uniform(addrs)
        assert pmap.digest == server_map.digest
        u1 = _uid_on(pmap, 1)
        notes = []
        try:
            prover, y1, y2 = _statement(rng)
            async with client_cls(partition_map=pmap) as c:
                notes.append((await c.register(u1, y1, y2)).success)
                notes.append(("redirects", c.redirects))
            notes.append(u1 in states[1]._users and u1 not in states[0]._users)

            stale = map_cls.uniform([addrs[0]])
            refreshes = []

            def refresh():
                refreshes.append(1)
                return map_cls.from_doc(pmap.to_doc())

            async with client_cls(partition_map=stale, map_refresh=refresh,
                                  refresh_jitter_s=0.0) as c2:
                cid = bytes((await c2.create_challenge(u1)).challenge_id)
                t = Transcript()
                t.append_context(cid)
                resp = await c2.verify_proof(u1, cid, prover.prove_with_transcript(
                    rng, t).to_bytes())
                notes.append((resp.success, bool(resp.session_token)))
                notes.append(("stale redirects", c2.redirects, bool(refreshes)))

            policy = retry.RetryPolicy(budget=retry.RetryBudget(tokens=10.0))
            async with client_cls(partition_map=stale, retry=policy) as c3:
                before = policy.budget.tokens
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c3.register(u1, b"\x00", b"\x00")
                notes.append(("charged", policy.budget.tokens < before, c3.redirects,
                              exc.value.code().name))
            drained = retry.RetryPolicy(budget=retry.RetryBudget(tokens=1.0))
            drained.budget._tokens = 0.5
            async with client_cls(partition_map=stale, retry=drained) as c4:
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c4.create_challenge(u1)
                trailers = {k: v for k, v in exc.value.trailing_metadata() or ()}
                notes.append(("refused", exc.value.code().name, c4.redirects,
                              trailers["cpzk-partition-map-version"],
                              trailers["cpzk-partition-owner"] == addrs[1]))
        finally:
            for s in (srv0, srv1):
                await s.stop(None)
        return notes

    notes = run(main())
    assert notes == [
        True, ("redirects", 0), True, (True, True), ("stale redirects", 2, True),
        ("charged", True, 1, "INVALID_ARGUMENT"),
        ("refused", "FAILED_PRECONDITION", 0, "1", True),
    ]


# --- test_chaos.py's client cases --------------------------------------------------


class FakeRpcError(grpc.RpcError):
    def __init__(self, code):
        self._code = code

    def code(self):
        return self._code


def _fast_policy(**kw):
    kw.setdefault("max_attempts", 4)
    kw.setdefault("initial_backoff_s", 0.001)
    kw.setdefault("max_backoff_s", 0.002)
    return RetryPolicy(**kw)


async def _statement_wire(user, rng, params):
    """(user_id, y1_wire, y2_wire) for a fresh keypair."""
    prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
    eb = Ristretto255.element_to_bytes
    return user, eb(prover.statement.y1), eb(prover.statement.y2)


async def _register_only(client, user, rng, params):
    resp = await client.register(*(await _statement_wire(user, rng, params)))
    assert resp.success


async def _register_and_prove(client, user, rng, params, tamper=False):
    prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
    eb = Ristretto255.element_to_bytes
    resp = await client.register(user, eb(prover.statement.y1), eb(prover.statement.y2))
    assert resp.success
    ch = await client.create_challenge(user)
    cid = bytes(ch.challenge_id)
    t = Transcript()
    t.append_context(b"wrong" if tamper else cid)
    return cid, prover.prove_with_transcript(rng, t).to_bytes()


def test_client_retries_transient_codes_only_for_safe_rpcs():
    async def main():
        state = ServerState()
        server, port = await serve(state, RateLimiter(10_000, 10_000), port=0,
                                   backend=CpuBackend())
        try:
            client = AuthClient(
                f"127.0.0.1:{port}",
                retry=_fast_policy(),
                retry_rng=random.Random(7),
            )
            async with client:
                rng = SecureRng()
                params = Parameters.new()

                # CreateChallenge: idempotent-safe, retried through UNAVAILABLE
                await _register_only(client, "retry-user", rng, params)
                attempts = {"n": 0}
                real = client._stubs["CreateChallenge"]

                async def flaky(request, timeout=None, metadata=None):
                    attempts["n"] += 1
                    if attempts["n"] <= 2:
                        raise FakeRpcError(grpc.StatusCode.UNAVAILABLE)
                    return await real(request, timeout=timeout, metadata=metadata)

                client._stubs["CreateChallenge"] = flaky
                resp = await client.create_challenge("retry-user")
                assert resp.challenge_id and attempts["n"] == 3

                # non-transient codes are not retried even on safe RPCs
                attempts["n"] = 10  # stub now always delegates
                denied = {"n": 0}

                async def denied_stub(request, timeout=None, metadata=None):
                    denied["n"] += 1
                    raise FakeRpcError(grpc.StatusCode.INVALID_ARGUMENT)

                client._stubs["Register"] = denied_stub
                with pytest.raises(grpc.RpcError):
                    await client.register("x", b"a", b"b")
                assert denied["n"] == 1

                # VerifyProof: NEVER retried (challenge consumed on first
                # receipt server-side; a resend cannot succeed)
                vattempts = {"n": 0}

                async def flaky_verify(request, timeout=None, metadata=None):
                    vattempts["n"] += 1
                    raise FakeRpcError(grpc.StatusCode.UNAVAILABLE)

                client._stubs["VerifyProof"] = flaky_verify
                with pytest.raises(grpc.RpcError):
                    await client.verify_proof("retry-user", b"c" * 32, b"p" * 8)
                assert vattempts["n"] == 1

                # budget exhaustion fails fast instead of retry-storming
                budget_client_attempts = {"n": 0}

                async def always_down(request, timeout=None, metadata=None):
                    budget_client_attempts["n"] += 1
                    raise FakeRpcError(grpc.StatusCode.UNAVAILABLE)

                client.retry = _fast_policy(
                    max_attempts=10, budget=RetryBudget(tokens=2.0, token_ratio=0.0)
                )
                client._stubs["CreateChallenge"] = always_down
                with pytest.raises(grpc.RpcError):
                    await client.create_challenge("retry-user")
                assert budget_client_attempts["n"] == 3  # initial + 2 budgeted
        finally:
            await server.stop(None)

    run(main())


def test_client_without_policy_never_retries():
    async def main():
        state = ServerState()
        server, port = await serve(state, RateLimiter(10_000, 10_000), port=0,
                                   backend=CpuBackend())
        try:
            async with AuthClient(f"127.0.0.1:{port}") as client:
                attempts = {"n": 0}

                async def down(request, timeout=None, metadata=None):
                    attempts["n"] += 1
                    raise FakeRpcError(grpc.StatusCode.UNAVAILABLE)

                client._stubs["CreateChallenge"] = down
                with pytest.raises(grpc.RpcError):
                    await client.create_challenge("nobody")
                assert attempts["n"] == 1
        finally:
            await server.stop(None)

    run(main())


def test_overload_storm_fairness_and_priority_ordering():
    """One hot client floods a server whose backend is slowed by fault
    injection while well-behaved clients run normal login flows.  The hot
    client is throttled FIRST (its own keyed bucket, not the shared one),
    well-behaved goodput stays at 100% of fair share, every shed carries
    retry pushback, and under forced overload the priority ordering holds:
    registrations and challenges shed while VerifyProof still
    authenticates.  The port's client, server and admission plane."""
    from cpzk_tpu_torch.admission import RETRY_PUSHBACK_KEY, AdmissionController
    from cpzk_tpu_torch.server.config import AdmissionSettings

    plan = FaultPlan(seed=11).latency(0.02, every=1)  # every batch slowed
    backend = FaultInjectionBackend(CpuBackend(), plan)
    settings = AdmissionSettings(
        per_client_rpm=60, per_client_burst=5,  # ~5-6 admits per burst
        adjust_interval_ms=20.0,
        increase_step=1.0, decrease_factor=0.5,
    )

    async def main():
        rng = SecureRng()
        params = Parameters.new()
        state = ServerState()
        batcher = DynamicBatcher(backend, max_batch=8, window_ms=5.0)
        controller = AdmissionController(settings, batcher=batcher)
        server, port = await serve(
            state, RateLimiter(1_000_000, 1_000_000), port=0,
            backend=backend, batcher=batcher, admission=controller,
        )
        try:
            # --- phase 1: the storm.  4 well-behaved clients each run a
            # full login flow (3 RPCs, under their burst) while one hot
            # client fires 60 concurrent RPCs (~12x its fair burst).
            good = [
                AuthClient(f"127.0.0.1:{port}", client_id=f"good-{i}")
                for i in range(4)
            ]
            hot = AuthClient(f"127.0.0.1:{port}", client_id="hot")

            async def good_flow(i, client):
                cid, pf = await _register_and_prove(
                    client, f"fair-user{i}", rng, params
                )
                return await client.verify_proof(f"fair-user{i}", cid, pf)

            async def hot_call():
                try:
                    await hot.create_challenge("no-such-user")
                    return "admitted"
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.RESOURCE_EXHAUSTED:
                        trailing = {
                            str(k).lower(): v
                            for k, v in (e.trailing_metadata() or ())
                        }
                        assert RETRY_PUSHBACK_KEY in trailing, (
                            "shed without retry pushback"
                        )
                        assert float(trailing[RETRY_PUSHBACK_KEY]) >= 0
                        return "shed"
                    assert e.code() == grpc.StatusCode.NOT_FOUND
                    return "admitted"

            results = await asyncio.gather(
                *[good_flow(i, c) for i, c in enumerate(good)],
                *[hot_call() for _ in range(60)],
            )
            good_resps, hot_outcomes = results[:4], results[4:]

            # well-behaved goodput: 100% of fair share (>= the 50% floor)
            assert all(r.success for r in good_resps)
            # the hot client was throttled, and throttled FIRST: its own
            # bucket shed it while every well-behaved RPC was admitted
            shed = hot_outcomes.count("shed")
            assert shed >= 40, hot_outcomes
            assert hot_outcomes.count("admitted") <= 20
            assert metrics.read("admission.shed.per_client") >= shed
            assert controller.level == pytest.approx(3.0)  # storm never
            # pushed the queue into overload: priority tier untouched

            # --- phase 2: priority ordering under forced overload.  A
            # pre-minted challenge must still verify while registrations
            # and challenge-creation shed.  Each assertion uses a FRESH
            # client id so the per-client buckets stay out of the way —
            # what's under test here is the adaptive tier alone.
            async with AuthClient(
                f"127.0.0.1:{port}", client_id="probe-setup"
            ) as setup:
                cid, pf = await _register_and_prove(
                    setup, "probe-user", rng, params
                )
            controller._signals = lambda: (0.95, 0.5)  # saturate
            async with AuthClient(
                f"127.0.0.1:{port}", client_id="probe-driver"
            ) as driver:
                deadline = time.monotonic() + 5.0
                while (
                    controller.level > 1.0 and time.monotonic() < deadline
                ):
                    await asyncio.sleep(0.025)
                    try:  # any RPC drives an AIMD adjustment
                        await driver.create_challenge("probe-user")
                    except grpc.RpcError:
                        pass
            assert controller.level == 1.0  # maximum shed

            async with AuthClient(
                f"127.0.0.1:{port}", client_id="probe-check"
            ) as probe:
                with pytest.raises(grpc.RpcError) as ei:
                    await probe.register(
                        *(await _statement_wire("probe-y", rng, params))
                    )
                assert ei.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                assert "register" in ei.value.details()
                with pytest.raises(grpc.RpcError) as ei:
                    await probe.create_challenge("probe-user")
                assert ei.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                assert "challenge" in ei.value.details()
                # ... but the in-flight login still completes: VerifyProof
                # is never rejected while lower tiers are being shed
                resp = await probe.verify_proof("probe-user", cid, pf)
                assert resp.success and resp.session_token
                assert metrics.read("admission.shed.priority") >= 2.0

                # --- phase 3: recovery.  Healthy signals re-admit tiers
                # bottom-up (additive increase), register last.
                controller._signals = lambda: (0.0, 0.0)
                deadline = time.monotonic() + 5.0
                while (
                    controller.level < 3.0 and time.monotonic() < deadline
                ):
                    await asyncio.sleep(0.025)
                    try:
                        await probe.verify_proof("probe-user", cid, pf)
                    except grpc.RpcError:
                        pass
                assert controller.level == pytest.approx(3.0)
                async with AuthClient(
                    f"127.0.0.1:{port}", client_id="probe-final"
                ) as fresh:
                    resp = await fresh.register(
                        *(await _statement_wire("probe-z", rng, params))
                    )
                    assert resp.success
        finally:
            for c in good:
                await c.close()
            await hot.close()
            await batcher.stop()
            await server.stop(None)

    run(main())


# --- the CLI -----------------------------------------------------------------------


def test_stream_subcommand_and_repl_lines(monkeypatch):
    """``python -m cpzk_tpu_torch.client stream`` (in process) registers
    ephemeral users and streams proofs through the port's server: its JSON
    line counts every proof verified and none rejected; the REPL's help,
    status and usage lines answer as the reference's."""
    import cpzk_tpu.client.__main__ as j_cli
    from cpzk_tpu_torch.client import __main__ as t_cli

    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)

    async def main():
        server, port = await serve(ServerState(), RateLimiter(10**9, 10**9), port=0,
                                   backend=CpuBackend())
        try:
            addr = f"127.0.0.1:{port}"
            args = t_cli.parse_args(["-s", addr, "stream", "--users", "4", "--proofs", "30",
                                     "--chunk", "8"])
            out = io.StringIO()
            with redirect_stdout(out):
                rc = await t_cli.stream_main(args)
            lines = {}
            async with AuthClient(addr) as tc, j_rpc.AuthClient(addr) as jc:
                for line in ("/help", "/status", "/login alice", "/bl a,b p", "/nope", "x"):
                    lines[line] = (await t_cli.handle_line(line, tc, addr),
                                   await j_cli.handle_line(line, jc, addr))
            return rc, json.loads(out.getvalue().strip().splitlines()[-1]), lines
        finally:
            await server.stop(None)

    rc, summary, lines = run(main())
    assert rc == 0
    assert summary["metric"] == "stream_cli" and summary["proofs"] == 30
    assert summary["verified"] == 30 and summary["rejected"] == 0 and summary["shed"] == 0
    for line, (port, ref) in lines.items():
        assert port == ref, line
