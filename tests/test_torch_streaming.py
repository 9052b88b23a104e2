"""The port's ``VerifyProofStream``: twins of ``tests/test_streaming.py``
(verdict order and correctness, session minting, the inline path without
a batcher, single-use challenges, malformed chunks, per-entry deadline
shedding, a backend raise confined to its chunk, a client that disconnects
mid-stream, the two client iterators, the batcher's settled results, the
refusal on an unpromoted standby, and keyed admission charged per proof).

Each case runs one seeded scenario against the reference's server and the
port's with the reference's ``AuthClient`` and requires the verdicts,
messages, token shapes and the state counts the reference test reads to
agree exactly.
"""

import asyncio
import time

import grpc
import pytest

from cpzk_tpu import Parameters, Prover, Transcript, Witness
from cpzk_tpu.client import AuthClient
from cpzk_tpu.core.ristretto import Ristretto255
from torch_grpc_twins import PACKAGES, SeededRng, twin_check

USERS = 8


def cpu_batcher(max_batch=16, window_ms=1.0):
    return lambda pkg: pkg.DynamicBatcher(pkg.CpuBackend(), max_batch=max_batch,
                                          window_ms=window_ms)


def exploding_batcher(pkg):
    class ExplodingBackend(pkg.VerifierBackend):
        """Raises for the first batch, then verifies."""

        prefers_combined = False

        def __init__(self):
            self.calls = 0
            self._inner = pkg.CpuBackend()

        def verify_combined(self, rows, beta):  # pragma: no cover - unused
            raise AssertionError("prefers_combined is False")

        def verify_each(self, rows):
            self.calls += 1
            if self.calls <= 1:
                raise RuntimeError("injected device loss")
            return self._inner.verify_each(rows)

    return pkg.DynamicBatcher(ExplodingBackend(), max_batch=4, window_ms=1.0)


def streaming(body, batcher=cpu_batcher(), **start_kw):
    """A scenario: a server with ``USERS`` registered users, then ``body``."""

    async def scenario(t):
        await t.start(batcher=batcher, rate=10**9, burst=10**9, **start_kw)
        try:
            t.users = await t.register_batch([f"u{i}" for i in range(USERS)])
            await body(t)
        finally:
            await t.stop()

    return scenario


async def entries(t, n, corrupt=(), wrong_user=()):
    out = []
    for k in range(n):
        u = k % USERS
        user_id, prover = t.users[u]
        ch = await t.client.create_challenge(user_id)
        cid = bytes(ch.challenge_id)
        wire = t.prove(prover, cid)
        if k in corrupt:
            wire = wire[:-1] + bytes([wire[-1] ^ 1])
        uid = f"u{(u + 1) % USERS}" if k in wrong_user else user_id
        out.append((uid, cid, wire))
    return out


async def verdicts_ordered_and_correct(t):
    batch = await entries(t, 24, corrupt={3}, wrong_user={5})
    t.note(*[v async for v in t.client.verify_proof_stream(batch, chunk=7)])


async def mints_sessions_on_request(t):
    vs = [v async for v in t.client.verify_proof_stream(await entries(t, 6), mint_sessions=True)]
    t.note(*vs, ("sessions", await t.state.session_count()),
           ("user", await t.state.validate_session(vs[0].session_token)))


async def inline_cpu_path_without_batcher(t):
    batch = await entries(t, 5, corrupt={2})
    t.note(*[v async for v in t.client.verify_proof_stream(batch)])


async def consumes_challenges_single_use(t):
    batch = await entries(t, 3)
    t.note(*[v async for v in t.client.verify_proof_stream(batch)])
    t.note(*[v async for v in t.client.verify_proof_stream(batch)])  # resent


async def malformed_chunks_answered_not_fatal(t):
    pb2 = t.client.pb2
    max_chunk = t.pkg.service.MAX_STREAM_CHUNK
    call = t.client._stream_stub()
    await call.write(pb2.StreamVerifyRequest(  # mismatched arrays
        ids=[0, 1], user_ids=["u0"], challenge_ids=[b"x"], proofs=[b"y"]))
    n = max_chunk + 1  # an oversized chunk
    await call.write(pb2.StreamVerifyRequest(
        ids=list(range(n)), user_ids=["u0"] * n, challenge_ids=[b"x"] * n,
        proofs=[b"y"] * n))
    (uid, cid, wire), = await entries(t, 1)  # then a real login
    await call.write(pb2.StreamVerifyRequest(
        ids=[7], user_ids=[uid], challenge_ids=[cid], proofs=[wire]))
    await call.done_writing()
    resps = [r async for r in call]
    t.note(("max", max_chunk), *resps)


async def entry_deadline_sheds(t):
    t.note(*[v async for v in t.client.verify_proof_stream(await entries(t, 5))])
    t.note(("challenges", await t.state.challenge_count()))


async def backend_raise_confined_to_its_chunk(t):
    batch = await entries(t, 8)
    pb2 = t.client.pb2
    call = t.client._stream_stub()
    for lo in (0, 4):
        part = batch[lo:lo + 4]
        await call.write(pb2.StreamVerifyRequest(
            ids=list(range(lo, lo + 4)), user_ids=[e[0] for e in part],
            challenge_ids=[e[1] for e in part], proofs=[e[2] for e in part]))
        if lo == 0:  # settle chunk 1 first: no coalescing with chunk 2
            t.note(await call.read())
    await call.done_writing()
    t.note(await call.read(), await call.read() is grpc.aio.EOF, (await call.code()).name)


async def client_disconnect_mid_stream_leaks_no_futures(t):
    got = 0
    async for _v in t.client.verify_proof_stream(await entries(t, 16), chunk=4):
        got += 1
        break  # abandon mid-stream (the generator's finally cancels)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + 5.0
    while loop.time() < deadline and t.batcher.load_snapshot()[0]:
        await asyncio.sleep(0.02)
    t.note(("got", got), ("depth", t.batcher.load_snapshot()[0]))
    t.note(*[v async for v in t.client.verify_proof_stream(await entries(t, 3))])


async def chunk_iterator_and_verdict_iterator_agree(t):
    flat = [(v.id, v.ok) async for v in t.client.verify_proof_stream(
        await entries(t, 10, corrupt={4}), chunk=3)]
    chunked = []
    async for ids, succ, msgs, _toks, _push in t.client.verify_proof_stream_chunks(
            await entries(t, 10, corrupt={4}), chunk=3):
        chunked.extend(zip(ids, succ))
        t.note(("lens", len(ids) == len(succ) == len(msgs)))
    t.note(("flat", tuple(flat)), ("agree", chunked == flat))


def _verdicts(obs):
    return [dict(o[1]) for o in obs if o[0] == "verdict"]


EXPECTED = {
    "verdicts_ordered_and_correct": (
        streaming(verdicts_ordered_and_correct),
        lambda obs: [v["id"] for v in _verdicts(obs)] == list(range(24))
        and all((v["ok"], v["message"]) == (False, "Authentication failed")
                if v["id"] in (3, 5) else v["ok"] and v["session_token"] is None
                for v in _verdicts(obs))),
    "mints_sessions_on_request": (
        streaming(mints_sessions_on_request),
        lambda obs: all(v["ok"] and v["session_token"] for v in _verdicts(obs))
        and obs[-2:] == [("sessions", 6), ("user", "u0")]),
    "inline_cpu_path_without_batcher": (
        streaming(inline_cpu_path_without_batcher, batcher=None),
        lambda obs: [v["ok"] for v in _verdicts(obs)] == [True, True, False, True, True]),
    "consumes_challenges_single_use": (
        streaming(consumes_challenges_single_use),
        lambda obs: [v["ok"] for v in _verdicts(obs)] == [True] * 3 + [False] * 3
        and all(v["message"] == "Authentication failed" for v in _verdicts(obs)[3:])),
    "malformed_chunks_answered_not_fatal": (
        streaming(malformed_chunks_answered_not_fatal),
        lambda obs: len(obs) == 4
        and dict(obs[1][1])["success"] == (False, False)
        and "Mismatched array lengths" in dict(obs[1][1])["messages"][0]
        and not any(dict(obs[2][1])["success"])
        and "maximum" in dict(obs[2][1])["messages"][0]
        and dict(obs[3][1])["ids"] == (7,) and dict(obs[3][1])["success"] == (True,)),
    "entry_deadline_sheds": (
        streaming(entry_deadline_sheds, batcher=cpu_batcher(window_ms=20.0),
                  stream_entry_deadline_ms=0.01),
        lambda obs: len(_verdicts(obs)) == 5
        and all(not v["ok"] and v["message"] == "Deadline expired before verification"
                for v in _verdicts(obs))
        and obs[-1] == ("challenges", 0)),
    "backend_raise_confined_to_its_chunk": (
        streaming(backend_raise_confined_to_its_chunk, batcher=exploding_batcher),
        lambda obs: not any(dict(obs[0][1]).get("success", ()))
        and set(dict(obs[0][1])["messages"]) == {"Verification unavailable"}
        and all(dict(obs[1][1])["success"]) and obs[2:] == [True, "OK"]),
    "client_disconnect_mid_stream_leaks_no_futures": (
        streaming(client_disconnect_mid_stream_leaks_no_futures, batcher=cpu_batcher(8)),
        lambda obs: obs[:2] == [("got", 1), ("depth", 0)]
        and [v["ok"] for v in _verdicts(obs)] == [True] * 3),
    "chunk_iterator_and_verdict_iterator_agree": (
        streaming(chunk_iterator_and_verdict_iterator_agree),
        lambda obs: all(o == ("lens", True) for o in obs[:-2])
        and obs[-2] == ("flat", tuple((i, i != 4) for i in range(10)))
        and obs[-1] == ("agree", True)),
}


@pytest.mark.parametrize("name", list(EXPECTED))
def test_streaming_twin(name):
    scenario, expected = EXPECTED[name]
    obs = twin_check(scenario, seed=53)
    assert expected(obs), obs


def test_hot_streamer_shed_per_proof_with_pushback_stream_survives():
    """A hot streamer blows through its keyed bucket mid-stream: its
    over-budget entries get NOT-verdicts with a retry delay, the stream's
    trailers carry ``cpzk-retry-after-ms``, the stream survives, and a
    client with its own bucket is unaffected — each side with its own
    package's ``AdmissionController``."""

    async def direct_entries(t, n):
        # challenges minted straight into the state: the admission config
        # would shed the setup RPCs themselves
        out = []
        for k in range(n):
            user_id, prover = t.users[k % USERS]
            cid = t.state.tag_challenge_id(user_id, t.rng.fill_bytes(32))
            await t.state.create_challenge(user_id, cid)
            out.append((user_id, cid, t.prove(prover, cid)))
        return out

    async def scenario(t):
        adm, config = t.module("admission"), t.module("server.config")
        batcher = t.pkg.DynamicBatcher(t.pkg.CpuBackend(), max_batch=64, window_ms=1.0)
        admission = adm.AdmissionController(config.AdmissionSettings(
            per_client_rpm=60, per_client_burst=10, max_clients=16), batcher=batcher)
        await t.start(batcher=lambda pkg: batcher, rate=10**9, burst=10**9,
                      admission=admission)
        try:
            t.users = await t.register_batch([f"u{i}" for i in range(USERS)])
            entries = await direct_entries(t, 16)
            pb2 = t.client.pb2
            call = t.client._stream_stub(metadata=(("cpzk-client-id", "hot-streamer"),))
            await call.write(pb2.StreamVerifyRequest(
                ids=list(range(16)), user_ids=[e[0] for e in entries],
                challenge_ids=[e[1] for e in entries], proofs=[e[2] for e in entries]))
            await call.done_writing()
            resps = [r async for r in call]
            flat_ok = [ok for r in resps for ok in r.success]
            shed = [m for r in resps for ok, m in zip(r.success, r.messages) if not ok]
            trailing = {str(k): v for k, v in (await call.trailing_metadata() or ())}
            t.note(("admitted", sum(flat_ok)),
                   ("shed says rate limit", all("rate limit" in m.lower() for m in shed)),
                   ("pushback", any(r.retry_after_ms > 0 for r in resps),
                    float(trailing["cpzk-retry-after-ms"]) > 0),
                   ("code", (await call.code()).name))
            entries2 = await direct_entries(t, 4)
            async with AuthClient(f"127.0.0.1:{t.port}", client_id="polite") as polite:
                t.note(("polite", tuple([v.ok async for v in
                                         polite.verify_proof_stream(entries2)])))
        finally:
            await t.stop()

    obs = twin_check(scenario, seed=61)
    assert obs == [("admitted", 10), ("shed says rate limit", True),
                   ("pushback", True, True), ("code", "OK"),
                   ("polite", (True,) * 4)]


@pytest.mark.parametrize("side", ["reference", "port"])
def test_batcher_settled_results_mix_verdicts_and_exceptions(side):
    """The settled contract under the stream: a deadline-expired entry comes
    back as its exception while batch siblings carry verdicts, via
    ``submit_many(settled=True)`` and the group enqueue, in both packages."""
    pkg = PACKAGES[side]
    rng = SeededRng(59)
    params = Parameters.new()

    def login_entries():
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        out = []
        for k in range(3):
            ctx = b"settled-%d" % k
            t = Transcript()
            t.append_context(ctx)
            wire = prover.prove_with_transcript(rng, t).to_bytes()
            out.append((prover.statement, wire, ctx))
        return out

    def to_entries(rows):
        # each package's own proof and statement types
        if side == "reference":
            from cpzk_tpu import Parameters as P, Proof, Statement
        else:
            from cpzk_tpu_torch import Parameters as P, Proof, Statement
            from cpzk_tpu_torch.core.ristretto import Ristretto255 as R
        out = []
        for st, wire, ctx in rows:
            if side == "port":
                eb = Ristretto255.element_to_bytes
                st = Statement(R.element_from_bytes(eb(st.y1)), R.element_from_bytes(eb(st.y2)))
            out.append(pkg.BatchEntry(P.new(), st, Proof.from_bytes(wire), ctx))
        out[1].deadline = time.monotonic() - 1.0  # already expired
        return out

    async def main():
        batcher = pkg.DynamicBatcher(pkg.CpuBackend(), max_batch=8, window_ms=1.0)
        batcher.start()
        try:
            got = []
            for submit in (lambda e: batcher.submit_many(e, settled=True),
                           batcher.submit_group):
                results = await submit(to_entries(login_entries()))
                got.append((results[0], type(results[1]).__name__, results[2]))
            return got
        finally:
            await batcher.stop()

    assert asyncio.run(main()) == [(None, "DeadlineExceeded", None)] * 2


@pytest.mark.parametrize("side", ["reference", "port"])
def test_stream_refused_on_unpromoted_standby(side):
    """The inert ``replica=`` seam still refuses streams on an unpromoted
    standby, as the reference does."""
    pkg = PACKAGES[side]

    class FakeReplica:
        role = "standby"

    class FakeContext:
        def invocation_metadata(self):
            return ()

        def peer(self):
            return "ipv4:127.0.0.1:1"

        def time_remaining(self):
            return None

        async def abort(self, code, msg, **kw):
            raise RuntimeError(f"aborted:{code.name}:{msg}")

    async def main():
        service = pkg.service.AuthServiceImpl(
            pkg.ServerState(), pkg.RateLimiter(10**9, 10**9),
            backend=pkg.CpuBackend(), replica=FakeReplica())

        async def no_requests():
            return
            yield  # pragma: no cover

        agen = service.verify_proof_stream(no_requests(), FakeContext())
        with pytest.raises(RuntimeError, match="aborted:UNAVAILABLE"):
            await agen.__anext__()

    asyncio.run(main())
