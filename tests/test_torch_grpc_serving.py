"""The port's gRPC service on its serving plane: twins of the reference's
gRPC cases about the batcher path, deadlines, overload, flight records,
deferred parsing and request tracing.

- ``tests/test_serving_tpu.py``: ``test_grpc_serving_through_batcher``
  and ``test_grpc_tpu_backend_end_to_end`` (the port side on
  ``build_backend(device="cpu")``, so the plain versions of both kernels
  lie on the path; the reference side serves through its ``CpuBackend``
  batcher, since the responses do not depend on the backend and the
  reference's own test covers its JAX backend);
- ``tests/test_chaos.py``: ``test_grpc_threads_rpc_deadline_into_batcher``,
  ``test_grpc_deadline_storm_never_reaches_device``,
  ``test_grpc_overload_shed_resource_exhausted``,
  ``test_health_stays_serving_while_degraded`` and
  ``test_chaos_device_loss_flap_recover_full_stack``;
- ``tests/test_flightrec.py``: ``test_grpc_e2e_stage_sum_matches_wall``;
- ``tests/test_deferred_parse.py``: the two gRPC differentials that report
  the exact parse error of a bad-point item, inline and through the
  batcher;
- ``tests/test_observability.py``: the end-to-end trace through the
  batcher (the ring and ``format_tracez``; the reference's JSON log
  formatter and REPL ``/tracez`` come with the daemon), the trace id kept
  across a client retry, and the failure paths' counters.

Each case runs one seeded scenario against both servers with the
reference's ``AuthClient`` and requires the recorded observations to
agree exactly; the checks each reference test makes on its own package's
tracer, flight recorder and metrics are made on each side's own and
recorded as observations too.

The reference's other cases of these files have twins elsewhere: the REPL
``/tracez`` and JSON-log parts of ``test_verify_proof_trace_end_to_end``
and ``test_chaos.py::test_status_repl_reports_breaker_state`` in
``tests/test_torch_daemon.py``; ``test_chaos.py``'s
``test_latency_spikes_do_not_trip_the_breaker`` in
``tests/test_torch_resilience.py``;
``test_overload_storm_fairness_and_priority_ordering``,
``test_client_retries_transient_codes_only_for_safe_rpcs`` and
``test_client_without_policy_never_retries`` in
``tests/test_torch_client.py``; and
``test_kill_primary_promote_login_zero_acknowledged_loss``,
``test_promotion_after_ship_crash_points`` and
``test_sigkill_primary_two_process_failover_zero_loss`` in
``tests/test_torch_replication.py``.
"""

import asyncio
import logging
import time

import grpc
import pytest

from torch_grpc_twins import norm, serving, twin_check

WINDOW_MS = 25.0


def cpu_batcher(max_batch=64, window_ms=WINDOW_MS, **kw):
    return lambda pkg: pkg.DynamicBatcher(pkg.CpuBackend(), max_batch=max_batch,
                                          window_ms=window_ms, **kw)


def recording_batcher(pkg):
    class RecordingBatcher(pkg.DynamicBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.dispatched_sizes = []

        async def _dispatch(self, take):
            self.dispatched_sizes.append(len(take))
            await super()._dispatch(take)

    return RecordingBatcher(pkg.CpuBackend(), max_batch=64, window_ms=WINDOW_MS)


# --- tests/test_serving_tpu.py ----------------------------------------------


async def grpc_serving_through_batcher(t):
    users = [f"user{i}" for i in range(5)]
    pairs = [await t.register_and_prove(u) for u in users]
    resps = await asyncio.gather(*[
        t.client.verify_proof(u, cid, pf) for u, (cid, pf) in zip(users, pairs)])
    t.note(*resps, ("coalesced", any(s > 1 for s in t.batcher.dispatched_sizes)))
    busers = [f"buser{i}" for i in range(5)]
    pairs2 = [await t.register_and_prove(u) for u in busers]
    t.note(await t.client.verify_proof_batch(
        busers, [cid for cid, _ in pairs2], [pf for _, pf in pairs2]))


async def grpc_device_backend_end_to_end(t):
    if t.side == "port":
        from cpzk_tpu_torch.ops.backend import TorchBackend
        from cpzk_tpu_torch.server import TpuSettings, build_backend

        backend, batcher = build_backend(
            TpuSettings(backend="tpu", batch_max=64, batch_window_ms=WINDOW_MS),
            device="cpu")
        assert type(backend) is TorchBackend
        await t.start(backend=backend, batcher=lambda pkg: batcher)
    else:
        await t.start(batcher=cpu_batcher())
    try:
        users = [f"tpuuser{i}" for i in range(3)]
        pairs = [await t.register_and_prove(u) for u in users]
        t.note(*await asyncio.gather(*[
            t.client.verify_proof(u, cid, pf) for u, (cid, pf) in zip(users, pairs)]))
    finally:
        await t.stop()


# --- tests/test_chaos.py -----------------------------------------------------


async def grpc_threads_rpc_deadline_into_batcher(t):
    captured = []
    orig_submit = t.batcher.submit

    async def spy(params_, statement, proof, context, deadline=None, trace_id=None):
        captured.append(deadline)
        return await orig_submit(params_, statement, proof, context,
                                 deadline=deadline, trace_id=trace_id)

    t.batcher.submit = spy
    cid, pf = await t.register_and_prove("dl-user")
    t0 = time.monotonic()
    t.note(await t.client.verify_proof("dl-user", cid, pf, timeout=30.0))
    cid2, pf2 = await t.register_and_prove("dl-user2")
    t.note(await t.client.verify_proof("dl-user2", cid2, pf2))  # no deadline
    t.note(("deadlines", len(captured), captured[0] is not None
            and 0.0 < captured[0] - t0 <= 30.5, captured[1] is None))


def row_counting_batcher(pkg):
    class RowCountingBackend(pkg.CpuBackend):
        def __init__(self):
            self.rows_verified = 0

        def verify_each(self, rows):
            self.rows_verified += len(rows)
            return super().verify_each(rows)

    return pkg.DynamicBatcher(RowCountingBackend(), max_batch=64, window_ms=400.0)


async def grpc_deadline_storm_never_reaches_device(t):
    users = [f"storm{i}" for i in range(4)]
    pairs = [await t.register_and_prove(u) for u in users]
    # 50 ms client deadlines against a 400 ms batch window: every RPC times
    # out on the client while it is queued
    resps = await asyncio.gather(*[
        t.client.verify_proof(u, cid, pf, timeout=0.05)
        for u, (cid, pf) in zip(users, pairs)], return_exceptions=True)
    t.note(*[(type(r).__name__ if not isinstance(r, grpc.RpcError) else r.code().name)
             for r in resps])
    await asyncio.sleep(0.6)  # the window drains the queue
    t.note(("rows verified", t.batcher.backend.rows_verified))
    cid, pf = await t.register_and_prove("calm")
    t.note(await t.client.verify_proof("calm", cid, pf, timeout=5.0))


async def grpc_overload_shed_resource_exhausted(t):
    users = [f"flood{i}" for i in range(6)]
    pairs = [await t.register_and_prove(u) for u in users]
    resps = await asyncio.gather(*[
        t.client.verify_proof(u, cid, pf) for u, (cid, pf) in zip(users, pairs)],
        return_exceptions=True)
    ok = [r for r in resps if not isinstance(r, Exception)]
    shed = [r for r in resps if isinstance(r, grpc.RpcError)]
    # how many are shed, and which members, depends on timing; what each
    # answer is does not, once the answer's own user is taken out of it (a
    # served login's message names its user)
    t.note(("all answered", len(ok) + len(shed) == 6, bool(ok), bool(shed)))
    t.note(("outcomes", tuple(sorted({
        repr(norm(r)).replace(u, "<user>") for u, r in zip(users, resps)
        if not isinstance(r, Exception) or isinstance(r, grpc.RpcError)}))))


async def _wave(t, tag, n=2, tamper=()):
    users = [f"{tag}{i}" for i in range(n)]
    pairs = []
    for i, u in enumerate(users):
        prover, resp = await t.register(u)
        assert resp.success, resp
        ch = await t.client.create_challenge(u)
        cid = bytes(ch.challenge_id)
        pairs.append((cid, t.prove(prover, b"tampered" if i in tamper else cid)))
    return await asyncio.gather(*[
        t.client.verify_proof(u, cid, pf) for u, (cid, pf) in zip(users, pairs)],
        return_exceptions=True)


async def health_stays_serving_while_degraded(t):
    faults = t.module("resilience.faults")
    fault = faults.FaultInjectionBackend(t.pkg.CpuBackend(), faults.FaultPlan().fail_after(0))
    backend = t.module("protocol.batch").FailoverBackend(
        fault, t.pkg.CpuBackend(), recovery_after_s=None)
    await t.start(backend=backend, batcher=lambda pkg: pkg.DynamicBatcher(
        backend, max_batch=64, window_ms=5.0))
    try:
        # >= 2 concurrent proofs: a single entry never reaches the backend
        t.note(*await _wave(t, "degraded"), ("degraded", backend.degraded))
        t.note(await t.client.health_check())
        await asyncio.sleep(0.05)
        t.note(*await _wave(t, "still-degraded"))
    finally:
        await t.stop()
    m = t.pkg.metrics
    t.note(("gauges", m.read("tpu.backend.state", kind="g"),
            m.read("tpu.backend.degraded_seconds", kind="g") >= 0.05))


async def chaos_device_loss_flap_recover_full_stack(t):
    """Batches 0 fail -> OPEN; 1 probe fails; 2 probe passes -> CLOSED;
    3 fails -> OPEN; 4 probe passes -> CLOSED; 5+ stable."""
    faults = t.module("resilience.faults")
    BreakerState = t.module("resilience.breaker").BreakerState
    fault = faults.FaultInjectionBackend(t.pkg.CpuBackend(),
                                         faults.FaultPlan(seed=5).fail_on(0, 1, 3))
    backend = t.module("protocol.batch").FailoverBackend(
        fault, t.pkg.CpuBackend(), recovery_after_s=0.05, probe_batch_max=8)
    expired_before = t.pkg.metrics.read("tpu.queue.expired")
    await t.start(backend=backend, rate=100_000, burst=100_000,
                  batcher=lambda pkg: pkg.DynamicBatcher(backend, max_batch=64, window_ms=15.0))
    states_seen, correct = set(), True
    try:
        for wave in range(12):
            resps = await _wave(t, f"w{wave}u", n=3, tamper={2})
            if wave == 0:
                t.note(*resps)
            # zero wrong results whatever the breaker's state: good proofs
            # authenticate, the tampered one never does
            correct &= (isinstance(resps[2], grpc.RpcError)
                        and resps[2].code() == grpc.StatusCode.PERMISSION_DENIED
                        and all(not isinstance(r, Exception) and r.success
                                and r.session_token for r in resps[:2]))
            states_seen.add(backend.state)
            if wave >= 5 and backend.state is BreakerState.CLOSED and fault.batches_seen >= 5:
                break
            await asyncio.sleep(0.08)  # serve the breaker's cooldown
        closed = (backend.state is BreakerState.CLOSED, not backend.degraded)
        before = fault.batches_seen
        final = await _wave(t, "finalwave")
        t.note(("waves correct", correct), ("stabilised", closed), *final,
               ("primary served", fault.batches_seen > before))
    finally:
        await t.stop()
    t.note(("faults", fault.faults_raised, BreakerState.OPEN in states_seen,
            t.pkg.metrics.read("tpu.queue.expired") - expired_before))


# --- tests/test_flightrec.py -------------------------------------------------


async def grpc_e2e_stage_sum_matches_wall(t):
    recorder = t.pkg.observability.get_flight_recorder()
    metrics = t.pkg.metrics
    recorder.clear()
    await t.start(batcher=cpu_batcher(max_batch=512, window_ms=5.0), rate=10**9, burst=10**9)
    try:
        n = 256
        users = await t.register_batch([f"fr{i}" for i in range(n)])
        for _wave in range(2):  # two waves: the second dispatch has a gap
            t.note(await t.client.verify_proof_batch(*await t.challenge_and_prove(users)))
            for s in list(t.state._sessions):
                await t.state.revoke_session(s)
    finally:
        await t.stop()
    records = recorder.snapshot()
    big = [r for r in records if r.batch >= n]
    t.note(("records", len(records) >= 2, bool(big)))
    for rec in big:
        t.note((rec.backend, rec.wall_s > 0,
                rec.stage_sum_s() == pytest.approx(rec.wall_s, rel=0.10),
                rec.stages_s.get("execute", 0.0) > 0.0,
                rec.stages_s.get("compile", 0.0) == 0.0,
                rec.stages_s.get("thread_hop", 0.0) >= 0.0,
                rec.occupancy))
    gap_count, gap_sum = metrics.read_histogram("tpu.dispatch.gap")
    t.note(("gap", gap_count >= 2.0, gap_sum >= 0.0,
            metrics.read("tpu.device.busy_fraction", "g") > 0.0,
            metrics.read("tpu.batch.occupancy", "g"),
            metrics.read("tpu.throughput.proofs_per_s", "g") >= 0.0,
            metrics.read_histogram("tpu.batch.thread_hop")[0] >= 2.0))


# --- tests/test_deferred_parse.py --------------------------------------------


async def grpc_batch_reports_exact_parse_error_for_bad_point(t):
    users = await t.register_users(3, f"dp-{t.batcher is not None}-")
    ids, cids, proofs = await t.challenge_and_prove(users)
    proofs[1] = proofs[1][:5] + b"\xff" * 32 + proofs[1][37:]
    t.note(await t.client.verify_proof_batch(ids, cids, proofs))
    t.note(("challenges", await t.state.challenge_count()))


# --- tests/test_observability.py ---------------------------------------------

STAGES = {"queue_wait", "pad_and_pack", "device_dispatch", "unpack"}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


async def verify_proof_trace_end_to_end(t):
    obs = t.pkg.observability
    tracer = obs.get_tracer()
    prev_slow = tracer.slow_request_s
    tracer.clear()
    tracer.slow_request_s = 0.0  # log every request
    capture = _Capture()
    logger = logging.getLogger(f"{t.pkg.service.__name__.split('.')[0]}.observability.rpc")
    logger.addHandler(capture)
    try:
        await t.start(batcher=cpu_batcher(window_ms=20.0))
        try:
            users = [f"trace{i}" for i in range(3)]
            pairs = [await t.register_and_prove(u) for u in users]
            t.note(*await asyncio.gather(*[
                t.client.verify_proof(u, cid, pf) for u, (cid, pf) in zip(users, pairs)]))
        finally:
            await t.stop()
    finally:
        logger.removeHandler(capture)
        tracer.slow_request_s = prev_slow
    traces = [tr for tr in tracer.completed() if tr.name == "VerifyProof"]
    t.note(("traces", len(traces)))
    for tr in traces:
        t.note((tr.status, tr.duration_s > 0, STAGES <= set(tr.span_names()),
                all(s.duration_s >= 0.0 for s in tr.spans)))
    tracez = obs.format_tracez(tracer.payload())
    t.note(("tracez", "VerifyProof" in tracez, "device_dispatch=" in tracez,
            all(tr.trace_id[:16] in tracez for tr in traces)))
    logged = [r for r in capture.records if getattr(r, "rpc", None) == "VerifyProof"]
    t.note(("logged", {r.trace_id for r in logged} == {tr.trace_id for tr in traces},
            sorted({r.outcome for r in logged}),
            all("queue_wait" in r.stages_ms for r in logged)))
    m = t.pkg.metrics
    t.note(("hist", m.read_histogram("tpu.batch.queue_wait")[0] >= 3,
            m.read_histogram("tpu.batch.host_time")[0] >= 1,
            m.read_histogram("tpu.batch.device_time", labels={"backend": "cpu"})[0] >= 1))
    tracer.clear()


async def trace_metadata_survives_retry(t):
    from cpzk_tpu.client import AuthClient
    from cpzk_tpu.resilience.retry import RetryBudget, RetryPolicy

    obs = t.pkg.observability
    tracer = obs.get_tracer()
    tracer.clear()
    service_mod = t.pkg.service
    ctx_mod = obs.context
    seen = []

    class FlakyService(service_mod.AuthServiceImpl):
        async def create_challenge(self, request, context):
            md = {k.lower(): v for k, v in context.invocation_metadata()}
            seen.append((md.get(ctx_mod.TRACE_ID_KEY), md.get(ctx_mod.ATTEMPT_KEY)))
            if len(seen) == 1:
                await context.abort(grpc.StatusCode.UNAVAILABLE, "flap")
            return await service_mod.AuthServiceImpl.create_challenge(self, request, context)

    state = t.pkg.ServerState()
    service = FlakyService(state, t.pkg.RateLimiter(10_000, 10_000),
                           backend=t.pkg.CpuBackend())
    server = grpc.aio.server()
    server.add_generic_rpc_handlers((service_mod.make_generic_handler(service),))
    port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    policy = RetryPolicy(max_attempts=3, initial_backoff_s=0.001, max_backoff_s=0.002,
                         budget=RetryBudget(tokens=10.0, token_ratio=0.1))
    try:
        async with AuthClient(f"127.0.0.1:{port}", retry=policy) as client:
            t.client = client
            _, resp = await t.register("retryer")
            t.note(resp, await client.create_challenge("retryer"))
            last = client.last_context
    finally:
        t.client = None
        await server.stop(None)
    (tid1, a1), (tid2, a2) = seen
    t.note(("attempts", len(seen), bool(tid1) and tid1 == tid2, (a1, a2),
            last.trace_id == tid1, last.attempt))
    done = [tr for tr in tracer.completed()
            if tr.name == "CreateChallenge" and tr.trace_id == tid1]
    t.note(("server trace", done[-1].attempt, done[-1].status))
    tracer.clear()


async def failure_paths_count_and_observe(t):
    m = t.pkg.metrics
    tracer = t.pkg.observability.get_tracer()
    tracer.clear()
    labels = {"rpc": "CreateChallenge", "outcome": "failure"}
    before = (m.read("auth.challenge.failure"),
              m.read_histogram("auth.challenge.duration")[0],
              m.read("rpc.requests", labels=labels))
    t.note(await t.call(t.client.create_challenge("ghost-user")))

    def observed():
        after = (m.read("auth.challenge.failure"),
                 m.read_histogram("auth.challenge.duration")[0],
                 m.read("rpc.requests", labels=labels))
        failed = any(tr.name == "CreateChallenge" and tr.status == "failure"
                     for tr in tracer.completed())
        return tuple(a - b for a, b in zip(after, before)), failed

    # the instrument decorator writes these in its ``finally``, which runs
    # after ``context.abort`` has already sent the status to the client:
    # wait (bounded) for that block before reading, as the reference's
    # test reads them only after stopping the server
    deadline = time.monotonic() + 5.0
    deltas, failed = observed()
    while (min(deltas) < 1.0 or not failed) and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
        deltas, failed = observed()
    t.note(("deltas", deltas))
    t.note(("failed trace", failed))
    tracer.clear()


SCENARIOS = {
    "grpc_serving_through_batcher": (
        serving(grpc_serving_through_batcher, batcher=recording_batcher),
        lambda obs: all(dict(o[1])["success"] for o in obs[:5])
        and obs[5] == ("coalesced", True)
        and all(dict(r[1])["success"] for r in dict(obs[6][1])["results"])),
    "grpc_tpu_backend_end_to_end": (
        grpc_device_backend_end_to_end,
        lambda obs: all(dict(o[1])["success"] and dict(o[1])["session_token"] for o in obs)),
    "grpc_threads_rpc_deadline_into_batcher": (
        serving(grpc_threads_rpc_deadline_into_batcher, batcher=cpu_batcher(window_ms=5.0)),
        lambda obs: obs[2] == ("deadlines", 2, True, True)),
    "grpc_deadline_storm_never_reaches_device": (
        serving(grpc_deadline_storm_never_reaches_device, batcher=row_counting_batcher),
        lambda obs: tuple(obs[:4]) == ("DEADLINE_EXCEEDED",) * 4
        and obs[4] == ("rows verified", 0) and dict(obs[5][1])["success"]),
    "grpc_overload_shed_resource_exhausted": (
        serving(grpc_overload_shed_resource_exhausted,
                batcher=cpu_batcher(window_ms=250.0, max_queue=2)),
        lambda obs: obs[0] == ("all answered", True, True, True)
        and any("RESOURCE_EXHAUSTED" in o and "Server overloaded" in o
                and "cpzk-retry-after-ms" in o for o in obs[1][1])),
    "health_stays_serving_while_degraded": (
        health_stays_serving_while_degraded,
        lambda obs: all(dict(o[1])["success"] for o in obs[:2])
        and obs[2] == ("degraded", True) and dict(obs[3][1]).get("status") == 1
        and all(dict(o[1])["success"] for o in obs[4:6])
        and obs[6] == ("gauges", 1.0, True)),
    "chaos_device_loss_flap_recover_full_stack": (
        chaos_device_loss_flap_recover_full_stack,
        lambda obs: obs[2][:2] == ("error", "PERMISSION_DENIED")
        and obs[3:5] == [("waves correct", True), ("stabilised", (True, True))]
        and all(dict(o[1])["success"] for o in obs[5:7])
        and obs[7] == ("primary served", True) and obs[8] == ("faults", 3, True, 0.0)),
    "grpc_e2e_stage_sum_matches_wall": (
        grpc_e2e_stage_sum_matches_wall,
        lambda obs: obs[2] == ("records", True, True)
        and all(o == ("cpu", True, True, True, True, True, 1.0) for o in obs[3:-1])
        and obs[-1] == ("gap", True, True, True, 1.0, True, True)),
    "grpc_batch_reports_exact_parse_error_for_bad_point": (
        serving(grpc_batch_reports_exact_parse_error_for_bad_point),
        lambda obs: [r.get("success", False) for r in
                     (dict(x[1]) for x in dict(obs[0][1])["results"])] == [True, False, True]
        and dict(dict(obs[0][1])["results"][1][1])["message"]
        == "Invalid proof: Bytes do not represent a valid Ristretto point"
        and obs[1] == ("challenges", 0)),
    "grpc_batcher_path_reports_exact_parse_error_for_bad_point": (
        serving(grpc_batch_reports_exact_parse_error_for_bad_point,
                batcher=cpu_batcher(window_ms=5.0)),
        lambda obs: dict(dict(obs[0][1])["results"][1][1])["message"]
        == "Invalid proof: Bytes do not represent a valid Ristretto point"
        and obs[1] == ("challenges", 0)),
    "verify_proof_trace_end_to_end": (
        verify_proof_trace_end_to_end,
        lambda obs: obs[3] == ("traces", 3)
        and all(o == ("success", True, True, True) for o in obs[4:7])
        and obs[7] == ("tracez", True, True, True)
        and obs[8] == ("logged", True, ("success",), True)
        and obs[9] == ("hist", True, True, True)),
    "trace_metadata_survives_retry": (
        trace_metadata_survives_retry,
        lambda obs: obs[2] == ("attempts", 2, True, ("1", "2"), True, 2)
        and obs[3] == ("server trace", 2, "success")),
    "failure_paths_count_and_observe": (
        serving(failure_paths_count_and_observe),
        lambda obs: obs[0][:2] == ("error", "NOT_FOUND")
        and obs[1] == ("deltas", (1.0, 1.0, 1.0)) and obs[2] == ("failed trace", True)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_grpc_serving_twin(name):
    scenario, expected = SCENARIOS[name]
    obs = twin_check(scenario, seed=37)
    assert expected(obs), obs
