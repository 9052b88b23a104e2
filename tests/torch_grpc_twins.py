"""Harness of the port's gRPC twin tests (``tests/test_torch_*.py``).

Two clients, two servers: every twin runs the same scenario against the
reference's in-process server (``cpzk_tpu.server.service.serve``) and the
port's (``cpzk_tpu_torch.server.service.serve``), both driven by the
reference's ``cpzk_tpu.client.AuthClient``, and compares what came back
response by response.  ``twin_check(..., clients=CLIENTS)`` also drives
both servers with the port's ``cpzk_tpu_torch.client.AuthClient`` and
requires all four runs to agree: the wire and metadata contract holds in
both directions.  A scenario records observations with
:meth:`Twin.note`; :func:`run_twins` returns both sides' records and the
caller asserts them equal (and, where the reference test asserted a
value, that value).

Observations are normalised only where the two servers cannot agree by
construction: session tokens and challenge ids are random, so they are
recorded by shape (length, the shard tag the state store stamps into
them, hex-ness); ``expires_at`` by whether it lies 300 s ahead.
Everything else (success flags, messages, gRPC status codes, details and
the ``cpzk-`` trailers) is compared exactly.

Witnesses and nonces come from numpy generators seeded per scenario, so
both sides register the same statements.  The port's inline path is given
its ``CpuBackend`` explicitly: with no backend it would mean the card.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import string
import time

import grpc
import numpy as np

import cpzk_tpu as J
import cpzk_tpu.observability as j_observability
import cpzk_tpu.protocol.batch as j_batch
import cpzk_tpu.server.batching as j_batching
import cpzk_tpu.server.state as j_state
import cpzk_tpu_torch.observability as t_observability
import cpzk_tpu_torch.protocol.batch as t_batch
import cpzk_tpu_torch.server.batching as t_batching
import cpzk_tpu_torch.server.state as t_state
from cpzk_tpu.client import AuthClient
from cpzk_tpu_torch.client import AuthClient as TAuthClient
from cpzk_tpu.server import metrics as j_metrics
from cpzk_tpu.server import service as j_service
from cpzk_tpu.server.config import RateLimiter as JRateLimiter
from cpzk_tpu_torch.server import metrics as t_metrics
from cpzk_tpu_torch.server import service as t_service
from cpzk_tpu_torch.server.config import RateLimiter as TRateLimiter

SIDES = ("reference", "port")

#: The client packages a scenario's ``twin.client`` can come from.
CLIENTS = {"reference": AuthClient, "port": TAuthClient}

#: Wall-clock bound of one side of a scenario: a hung server fails the
#: test instead of holding its worker.
SCENARIO_TIMEOUT_S = 60.0

_HEX = set(string.hexdigits.lower())


class SeededRng:
    """``fill_bytes`` from a seeded numpy generator (witnesses, nonces)."""

    def __init__(self, seed: int):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._g.bytes(n)


@dataclasses.dataclass(frozen=True)
class Package:
    """What one side of a twin takes from its package."""

    name: str
    root: str
    ServerState: type
    serve: object
    RateLimiter: type
    CpuBackend: type
    VerifierBackend: type
    DynamicBatcher: type
    BatchEntry: type
    service: object
    state_mod: object
    observability: object
    metrics: object


PACKAGES = {
    "reference": Package(
        "reference", "cpzk_tpu", j_state.ServerState, j_service.serve, JRateLimiter,
        j_batch.CpuBackend, j_batch.VerifierBackend, j_batching.DynamicBatcher,
        j_batch.BatchEntry,
        j_service, j_state, j_observability, j_metrics),
    "port": Package(
        "port", "cpzk_tpu_torch", t_state.ServerState, t_service.serve, TRateLimiter,
        t_batch.CpuBackend, t_batch.VerifierBackend, t_batching.DynamicBatcher,
        t_batch.BatchEntry,
        t_service, t_state, t_observability, t_metrics),
}


def token_shape(token) -> tuple | None:
    """A session token by shape: length, shard tag (first two hex chars,
    a function of the user id), and whether it is all lowercase hex."""
    if token is None:
        return None
    return ("token", len(token), token[:2], set(token) <= _HEX)


def norm(obj):
    """A response, error or stream verdict, with the random parts replaced
    by their shape (see the module docstring)."""
    if isinstance(obj, grpc.RpcError):
        trailers = tuple(sorted(
            (k, v) for k, v in (obj.trailing_metadata() or ())
            if str(k).startswith("cpzk-")))
        return ("error", obj.code().name, obj.details(), trailers)
    if isinstance(obj, BaseException):
        return ("raised", type(obj).__name__, str(obj))
    if dataclasses.is_dataclass(obj):  # the client's StreamVerdict
        d = dataclasses.asdict(obj)
        d["session_token"] = token_shape(d["session_token"])
        return ("verdict", tuple(sorted(d.items())))
    if hasattr(obj, "ListFields"):
        out = []
        for fd, value in obj.ListFields():
            name = fd.name
            if name == "session_token":
                value = token_shape(value)
            elif name == "session_tokens":
                value = tuple(token_shape(t) if t else "" for t in value)
            elif name == "challenge_id":
                value = ("challenge_id", len(value), value[0])
            elif name == "expires_at":
                left = value - time.time()
                value = ("expires_in_300s", 298 <= left <= 301)
            elif fd.message_type is not None:
                value = (tuple(norm(v) for v in value)
                         if fd.is_repeated else norm(value))
            elif fd.is_repeated:
                value = tuple(value)
            out.append((name, value))
        return (type(obj).__name__, tuple(out))
    if isinstance(obj, (list, tuple)):
        return tuple(norm(o) for o in obj)
    return obj


class Twin:
    """One side of a scenario: its package, server, state, client and the
    observations it records."""

    def __init__(self, side: str, seed: int, client_side: str = "reference"):
        self.side = side
        self.pkg = PACKAGES[side]
        #: the package whose ``AuthClient`` the scenario drives the server with
        self.client_side = client_side
        self.AuthClient = CLIENTS[client_side]
        self.rng = SeededRng(seed)
        self.params = J.Parameters.new()
        self.log: list = []
        self.state = None
        self.server = None
        self.port = None
        self.client = None
        self.batcher = None

    def module(self, name: str):
        """This side's package module ``name`` (e.g. ``"resilience.faults"``)."""
        return importlib.import_module(f"{self.pkg.root}.{name}")

    def note(self, *items) -> None:
        """Record observations (normalised) for the cross-side comparison."""
        for item in items:
            self.log.append(norm(item))

    async def call(self, coro):
        """Await an RPC; its response, or the RpcError it raised."""
        try:
            return await coro
        except grpc.RpcError as err:
            return err

    async def start(self, backend="cpu", batcher=None, rate: int = 10_000,
                    burst: int = 10_000, state=None, client: bool = True,
                    **serve_kw):
        """Start this side's server.  ``backend="cpu"`` means the side's
        ``CpuBackend`` (the port's inline path needs one passed);
        ``batcher`` is a callable ``(pkg) -> DynamicBatcher`` or None."""
        pkg = self.pkg
        self.state = state if state is not None else pkg.ServerState()
        if backend == "cpu":
            backend = pkg.CpuBackend()
        self.batcher = batcher(pkg) if batcher is not None else None
        self.server, self.port = await pkg.serve(
            self.state, pkg.RateLimiter(rate, burst), host="127.0.0.1",
            port=0, backend=backend, batcher=self.batcher, **serve_kw)
        if client:
            self.client = self.AuthClient(f"127.0.0.1:{self.port}")
        return self

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.close()
        if self.batcher is not None:
            await self.batcher.stop()
        if self.server is not None:
            await self.server.stop(None)

    # -- login helpers (the reference's prover on the client side) ---------

    def prover(self):
        return J.Prover(self.params, J.Witness(J.Ristretto255.random_scalar(self.rng)))

    def prove(self, prover, context: bytes) -> bytes:
        t = J.Transcript()
        t.append_context(context)
        return prover.prove_with_transcript(self.rng, t).to_bytes()

    async def register(self, user_id: str, prover=None):
        prover = prover or self.prover()
        eb = J.Ristretto255.element_to_bytes
        resp = await self.call(self.client.register(
            user_id, eb(prover.statement.y1), eb(prover.statement.y2)))
        return prover, resp

    async def register_users(self, n: int, prefix: str = "user") -> list:
        users = []
        for i in range(n):
            prover, resp = await self.register(f"{prefix}{i}")
            assert resp.success, resp
            users.append((f"{prefix}{i}", prover))
        return users

    async def register_batch(self, user_ids: list[str]) -> list:
        provers = [self.prover() for _ in user_ids]
        eb = J.Ristretto255.element_to_bytes
        resp = await self.client.register_batch(
            user_ids, [eb(p.statement.y1) for p in provers],
            [eb(p.statement.y2) for p in provers])
        assert all(r.success for r in resp.results), resp
        return list(zip(user_ids, provers))

    async def challenge_and_prove(self, users, wrong_context_for=()):
        ids, cids, proofs = [], [], []
        for idx, (user_id, prover) in enumerate(users):
            ch = await self.client.create_challenge(user_id)
            cid = bytes(ch.challenge_id)
            ctx = b"wrong-context" if idx in wrong_context_for else cid
            proofs.append(self.prove(prover, ctx))
            ids.append(user_id)
            cids.append(cid)
        return ids, cids, proofs

    async def register_and_prove(self, user_id: str):
        prover, resp = await self.register(user_id)
        assert resp.success, resp
        (ids, cids, proofs) = await self.challenge_and_prove([(user_id, prover)])
        return cids[0], proofs[0]


def run_twins(scenario, seed: int = 0, sides=SIDES, timeout_s: float = SCENARIO_TIMEOUT_S,
              client: str = "reference"):
    """Run ``scenario(twin)`` (a coroutine function) once per side, each in
    its own event loop, with ``client``'s ``AuthClient``; returns ``{side:
    twin}``.  The scenario starts and stops its own server (use
    :meth:`Twin.start` inside ``try``/``finally`` with :meth:`Twin.stop`)."""
    out = {}
    for side in sides:
        twin = Twin(side, seed, client)

        async def main(twin=twin):
            await asyncio.wait_for(scenario(twin), timeout_s)

        asyncio.run(main())
        out[side] = twin
    return out


def assert_twins_agree(twins: dict) -> list:
    """The two sides recorded the same observations; returns them."""
    ref, port = twins["reference"].log, twins["port"].log
    assert len(ref) == len(port), (len(ref), len(port))
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"observation {i}: reference {a!r} != port {b!r}"
    return ref


def twin_check(scenario, seed: int = 0, clients=("reference",)) -> list:
    """:func:`run_twins` then :func:`assert_twins_agree`, once per client
    package in ``clients``; every client's observations must equal the
    first's.  Returns them."""
    first = None
    for client in clients:
        obs = assert_twins_agree(run_twins(scenario, seed, client=client))
        if first is None:
            first = obs
            continue
        assert len(obs) == len(first), (clients[0], len(first), client, len(obs))
        for i, (a, b) in enumerate(zip(first, obs)):
            assert a == b, f"observation {i}: {clients[0]} client {a!r} != {client} client {b!r}"
    return first


def serving(scenario_body, backend="cpu", batcher=None, **start_kw):
    """Wrap a ``body(twin)`` coroutine function with a server started with
    these settings and stopped afterwards."""

    async def scenario(twin):
        await twin.start(backend=backend, batcher=batcher, **start_kw)
        try:
            await scenario_body(twin)
        finally:
            await twin.stop()

    return scenario
