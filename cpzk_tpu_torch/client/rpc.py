"""Async gRPC client for the auth service (hand-wired stubs).

A copy of ``cpzk_tpu/client/rpc.py`` on the port's request context, retry
policy, proto bindings and partition map; the wire and metadata contract
(retry pushback, partition redirects, stream chunks) is the reference's.
It mirrors the RPC surface the reference client drives through its generated
``AuthServiceClient`` (``src/bin/client.rs``); method paths and message
types come straight from ``proto/auth.proto``.

Resilience: pass a :class:`~cpzk_tpu_torch.resilience.retry.RetryPolicy` to get
exponential backoff with full jitter and a shared retry budget on
transient failures (``UNAVAILABLE``, ``RESOURCE_EXHAUSTED``).  Only
idempotent-safe RPCs are ever retried — ``VerifyProof`` /
``VerifyProofBatch`` are excluded because the server consumes their
challenges on FIRST receipt (even on failure): a resend can never
succeed, it just burns the challenge, so those errors surface
immediately and the caller restarts from ``CreateChallenge``.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass

import grpc

from ..fleet.partition_map import (
    PARTITION_MAP_VERSION_KEY,
    PARTITION_OWNER_KEY,
    PartitionMap,
)
from ..observability.context import RequestContext
from ..resilience.retry import RETRY_PUSHBACK_KEY, RetryPolicy
from ..server.proto import SERVICE_NAME, load_pb2, method_types, stream_method_types

#: RPCs safe to resend on a transient failure.  Register re-sent after an
#: unreported success fails loudly with ALREADY_EXISTS (never silently
#: corrupts); CreateChallenge just mints a fresh nonce; health is pure.
_RETRY_SAFE = frozenset({"Register", "RegisterBatch", "CreateChallenge", "HealthCheck"})

#: Metadata tag carrying the caller's self-chosen identity for per-client
#: fair admission (see cpzk_tpu_torch.admission.limiter.client_key).
CLIENT_ID_KEY = "cpzk-client-id"

#: Hard cap on wrong-partition re-routes within one logical call: the
#: contract is one refresh + re-route per attempt, and a second redirect
#: in a row means the fleet's maps are churning — surface the error.
_MAX_REDIRECTS = 2


def _pushback_ms(err) -> float | None:
    """Server retry pushback from an RpcError's trailing metadata
    (``cpzk-retry-after-ms``), or None when absent/unparseable.  Negative
    values are returned as-is — they mean "do not retry" (gRFC A6)."""
    try:
        trailing = err.trailing_metadata()
    except Exception:
        return None
    for key, value in trailing or ():
        if str(key).lower() != RETRY_PUSHBACK_KEY:
            continue
        if isinstance(value, bytes):
            value = value.decode("ascii", "replace")
        try:
            return float(value)
        except (TypeError, ValueError):
            return None
    return None


def _redirect_info(err) -> tuple[str | None, int | None]:
    """``(owner_address, map_version)`` from a wrong-partition
    FAILED_PRECONDITION's trailing metadata, or ``(None, None)`` when the
    error is not a fleet redirect.  Both trailers must be present — a
    plain FAILED_PRECONDITION from anything else is never re-routed."""
    try:
        trailing = err.trailing_metadata()
    except Exception:
        return None, None
    owner: str | None = None
    version: int | None = None
    for key, value in trailing or ():
        k = str(key).lower()
        if isinstance(value, bytes):
            value = value.decode("utf-8", "replace")
        if k == PARTITION_OWNER_KEY:
            owner = str(value)
        elif k == PARTITION_MAP_VERSION_KEY:
            try:
                version = int(value)
            except (TypeError, ValueError):
                version = None
    if owner is None or version is None:
        return None, None
    return owner, version


@dataclass(slots=True)
class StreamVerdict:
    """One per-proof outcome from :meth:`AuthClient.verify_proof_stream`.

    ``retry_after_ms`` nonzero marks an entry the server SHED under
    admission pressure (not verified, not rejected) — resend it after the
    delay; the stream itself stayed open."""

    id: int
    ok: bool
    message: str
    session_token: str | None = None
    retry_after_ms: int = 0


class AuthClient:
    """Thin unary-unary stub set over a grpc.aio channel — or, with a
    :class:`~cpzk_tpu_torch.fleet.PartitionMap`, over a **channel pool keyed by
    partition**: user-keyed RPCs route to the owning partition's address,
    batch RPCs fan out per partition, and a wrong-partition redirect
    (``FAILED_PRECONDITION`` + the map-version/owner trailers) triggers
    at most ONE map refresh + re-route per attempt, charged against the
    retry budget.  ``VerifyProof`` — never retried on any other error,
    because its challenge is consumed server-side on first receipt — IS
    safely re-routed here: the server checks ownership *before* touching
    state, so a redirected proof's challenge was never consumed."""

    def __init__(
        self,
        target: str = "",
        credentials: grpc.ChannelCredentials | None = None,
        retry: RetryPolicy | None = None,
        retry_rng: random.Random | None = None,
        client_id: str | None = None,
        partition_map: PartitionMap | None = None,
        map_refresh=None,
        refresh_jitter_s: float = 0.25,
        refresh_min_interval_s: float = 1.0,
        reconnect_damp_s: float = 0.5,
    ):
        self.pb2 = load_pb2()
        self.retry = retry
        #: sent as ``cpzk-client-id`` metadata on every RPC so the server
        #: keys fair admission to this identity rather than the peer
        #: address (useful behind proxies / NAT).
        self.client_id = client_id
        #: trace context of the most recent RPC attempt (observability).
        self.last_context: RequestContext | None = None
        #: the routing map (None = single-target client, exactly as
        #: before); refreshed in place on a server redirect when
        #: ``map_refresh`` is provided.
        self.partition_map = partition_map
        #: zero-arg callable (sync or async) returning a fresh
        #: :class:`PartitionMap` or None — typically a fetch of the ops
        #: plane's ``/partitionmap``; invoked at most once per redirect.
        self.map_refresh = map_refresh
        #: wrong-partition re-routes performed (observability/tests).
        self.redirects = 0
        #: UNAVAILABLE-triggered dials of a partition's warm standby
        #: (v2 maps only; observability/tests).
        self.standby_dials = 0
        # herd damping: N clients waking together (a promotion, a map
        # flip) must not hammer /partitionmap or the new primary in one
        # synchronized wave.  Map refreshes are SINGLE-FLIGHT (concurrent
        # callers share one in-flight fetch) behind a full-jitter delay
        # and a min re-fetch interval; the first RPC to an address that
        # just answered UNAVAILABLE sleeps full jitter before re-dialing.
        self.refresh_jitter_s = refresh_jitter_s
        self.refresh_min_interval_s = refresh_min_interval_s
        self.reconnect_damp_s = reconnect_damp_s
        self._refresh_inflight: asyncio.Task | None = None
        self._refresh_done_at = float("-inf")
        #: address -> loop time of the last UNAVAILABLE from it
        self._addr_down: dict[str, float] = {}
        #: damping observability (tests + bench assertions)
        self.refresh_fetches = 0
        self.refresh_coalesced = 0
        self.reconnects_damped = 0
        # injectable RNG so chaos tests get deterministic jitter
        self._retry_rng = retry_rng or random.Random()
        self._credentials = credentials
        if not target:
            if partition_map is None:
                raise ValueError(
                    "AuthClient needs a target or a partition_map"
                )
            target = partition_map.partitions[0].address
        self._target = target
        # per-partition channel pool; the default target's channel lives
        # in it too, so `self.channel` stays one of the pooled channels
        self._pool: dict[str, grpc.aio.Channel] = {}
        self._unary_stubs: dict[tuple[str, str], object] = {}
        self.channel = self._channel(target)
        types = method_types(self.pb2)
        self._stubs = {
            name: self._stub(target, name) for name in types
        }
        stream_types = stream_method_types(self.pb2)
        req, resp = stream_types["VerifyProofStream"]
        self._stream_stub = self.channel.stream_stream(
            f"/{SERVICE_NAME}/VerifyProofStream",
            request_serializer=req.SerializeToString,
            response_deserializer=resp.FromString,
        )

    # --- the per-partition channel pool ---

    def _channel(self, address: str) -> grpc.aio.Channel:
        ch = self._pool.get(address)
        if ch is None:
            if self._credentials is not None:
                ch = grpc.aio.secure_channel(address, self._credentials)
            else:
                ch = grpc.aio.insecure_channel(address)
            self._pool[address] = ch
        return ch

    def _stub(self, address: str, name: str):
        key = (address, name)
        stub = self._unary_stubs.get(key)
        if stub is None:
            req, resp = method_types(self.pb2)[name]
            stub = self._channel(address).unary_unary(
                f"/{SERVICE_NAME}/{name}",
                request_serializer=req.SerializeToString,
                response_deserializer=resp.FromString,
            )
            self._unary_stubs[key] = stub
        return stub

    def _route_address(self, user_id: str) -> str:
        """The owning partition's address under the client's map (the
        default target when no map is loaded)."""
        if self.partition_map is None:
            return self._target
        return self.partition_map.partition_for(user_id).address

    def _standby_for(self, address: str | None) -> str | None:
        """The warm-standby address paired with ``address`` under a v2
        map (the failover target when the primary answers UNAVAILABLE),
        or None on v1 maps / unknown addresses.  Symmetric: the map may
        already name the standby as the primary (a flipped entry), in
        which case the *other* address of the pair is returned."""
        pmap = self.partition_map
        if pmap is None or not address:
            return None
        for p in pmap.partitions:
            if not p.standby:
                continue
            if p.address == address:
                return p.standby
            if p.standby == address:
                return p.address
        return None

    async def _refresh_map(self) -> bool:
        """One bounded, HERD-DAMPED map refresh (called on a redirect):
        adopt the fetched map when its version is strictly newer.  A
        refresh failure is non-fatal — the redirect's owner trailer still
        routes this attempt.

        Damping: concurrent callers coalesce onto ONE in-flight fetch
        (single-flight), the fetch itself starts behind a full-jitter
        delay of up to ``refresh_jitter_s``, and a refresh that completed
        within ``refresh_min_interval_s`` answers from that result
        instead of re-fetching — so a thousand clients redirected by the
        same map flip produce a trickle of ``/partitionmap`` hits, not a
        synchronized wave."""
        if self.map_refresh is None:
            return False
        loop = asyncio.get_running_loop()
        task = self._refresh_inflight
        if task is None:
            if (
                loop.time() - self._refresh_done_at
                < self.refresh_min_interval_s
            ):
                return False  # a fresh-enough fetch already answered
            task = loop.create_task(self._do_refresh())
            self._refresh_inflight = task
        else:
            self.refresh_coalesced += 1
        # shield: one caller being cancelled must not kill the fetch the
        # coalesced others are waiting on
        try:
            return await asyncio.shield(task)
        except asyncio.CancelledError:
            raise
        except Exception:
            return False

    async def _do_refresh(self) -> bool:
        try:
            if self.refresh_jitter_s > 0:
                await asyncio.sleep(
                    self._retry_rng.uniform(0.0, self.refresh_jitter_s)
                )
            self.refresh_fetches += 1
            fresh = self.map_refresh()
            if asyncio.iscoroutine(fresh):
                fresh = await fresh
        except Exception:
            fresh = None
        finally:
            self._refresh_done_at = asyncio.get_running_loop().time()
            self._refresh_inflight = None
        if fresh is None or self.partition_map is None:
            return False
        if fresh.version > self.partition_map.version:
            self.partition_map = fresh
            return True
        return False

    def _mark_down(self, address: str | None) -> None:
        if address:
            self._addr_down[address] = asyncio.get_running_loop().time()

    async def _damp_reconnect(self, address: str | None) -> None:
        """Full-jitter sleep before the first RPC back to an address that
        just answered UNAVAILABLE, so N clients reconnecting after a
        failover spread their re-dials over ``reconnect_damp_s`` instead
        of landing on the new primary as one thundering herd.  One damped
        attempt per down-mark: the mark clears after the sleep (steady
        traffic is never taxed) and a still-down address re-marks on the
        next failure."""
        if not address or self.reconnect_damp_s <= 0:
            return
        since = self._addr_down.get(address)
        if since is None:
            return
        loop = asyncio.get_running_loop()
        if loop.time() - since > self.reconnect_damp_s:
            # the outage mark is stale — the herd window has passed
            self._addr_down.pop(address, None)
            return
        self._addr_down.pop(address, None)
        self.reconnects_damped += 1
        await asyncio.sleep(
            self._retry_rng.uniform(0.0, self.reconnect_damp_s)
        )

    async def close(self) -> None:
        for ch in self._pool.values():
            await ch.close()

    async def __aenter__(self) -> "AuthClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # --- retry plumbing ---

    async def _call(
        self, name: str, stub, request, timeout: float | None,
        user_id: str | None = None, address: str | None = None,
    ):
        """One RPC through the routing + retry stack.

        **Routing** (fleet mode only — a ``partition_map`` is loaded):
        ``user_id``-keyed RPCs resolve the owning partition's address per
        attempt and go out on that partition's pooled channel.  A
        wrong-partition rejection (``FAILED_PRECONDITION`` carrying the
        map-version + owner trailers) triggers at most one map refresh +
        re-route per attempt — charged against the shared retry budget,
        capped at ``_MAX_REDIRECTS`` per logical call — which is how a
        stale-map client converges in one extra round trip.  This applies
        to EVERY routed RPC including ``VerifyProof``: the server checks
        ownership before consuming anything, so a redirected proof is not
        a replay.

        **Retries**: non-idempotent methods (and clients with no policy)
        go straight through; the rest retry only on the policy's
        transient codes, sleeping full-jitter backoff, until attempts or
        the shared budget run out.

        Every attempt carries a trace context in its gRPC metadata: the
        trace id is minted ONCE per logical call and stays stable across
        retries/redirects while the attempt number increments, so the
        server-side trace ring shows a retried request as one trace with
        several completions.  The most recent context is kept on
        ``self.last_context`` for callers that want to correlate their
        own logs with the server's.

        Server pushback (gRFC A6): a rejection carrying
        ``cpzk-retry-after-ms`` trailing metadata overrides the jittered
        backoff — the sleep is exactly the server-advertised delay
        (sized from its queue drain rate).  Negative pushback means the
        server asked us not to retry at all.  The retry budget and
        attempt cap still apply either way."""
        rctx = RequestContext()
        self.last_context = rctx
        policy = self.retry
        routed = self.partition_map is not None and user_id is not None
        if routed:
            address = self._route_address(user_id)
            stub = self._stub(address, name)
        elif address is None:
            address = self._target
        # post-failover herd damping: jittered hold-off before re-dialing
        # an address whose last answer was UNAVAILABLE
        await self._damp_reconnect(address)
        redirected = 0
        standby_tried = False
        while True:
            try:
                response = await stub(
                    request, timeout=timeout, metadata=self._metadata(rctx)
                )
            except grpc.RpcError as e:
                code = e.code()
                code_name = code.name if code is not None else ""
                if code_name == "UNAVAILABLE":
                    self._mark_down(address)
                    # v2-map failover: dial the partition's warm standby
                    # ONCE per logical call, before any retry budget is
                    # charged — a dead primary mid-handover (or a plain
                    # crash) costs one extra dial, not a backoff ladder
                    if not standby_tried:
                        standby = self._standby_for(address)
                        if standby is not None and standby != address:
                            standby_tried = True
                            self.standby_dials += 1
                            stub = self._stub(standby, name)
                            address = standby
                            rctx = rctx.child()
                            self.last_context = rctx
                            continue
                if (
                    self.partition_map is not None
                    and code_name == "FAILED_PRECONDITION"
                    and redirected < _MAX_REDIRECTS
                ):
                    owner, _version = _redirect_info(e)
                    if owner is not None:
                        # one refresh + re-route, against the retry budget
                        if (
                            policy is not None
                            and policy.budget is not None
                            and not policy.budget.try_withdraw()
                        ):
                            raise
                        redirected += 1
                        self.redirects += 1
                        refreshed = await self._refresh_map()
                        addr = owner
                        if refreshed and user_id is not None:
                            # the fresh map may know better than the
                            # (possibly itself-stale) rejecting server
                            addr = self._route_address(user_id)
                        stub = self._stub(addr, name)
                        address = addr
                        rctx = rctx.child()  # same trace id, attempt + 1
                        self.last_context = rctx
                        continue
                pushback = _pushback_ms(e)
                if policy is None or name not in _RETRY_SAFE:
                    raise
                if pushback is not None and pushback < 0:
                    raise  # server pushback: do not retry
                if not policy.should_retry(code_name, rctx.attempt):
                    raise
                await asyncio.sleep(
                    policy.sleep_s(
                        rctx.attempt, pushback_ms=pushback,
                        rng=self._retry_rng,
                    )
                )
                rctx = rctx.child()  # same trace id, attempt + 1
                self.last_context = rctx
                continue
            if policy is not None and name in _RETRY_SAFE:
                policy.note_success()
            self._addr_down.pop(address, None)
            return response

    def _metadata(self, rctx: RequestContext):
        md = rctx.to_metadata()
        if self.client_id:
            md += ((CLIENT_ID_KEY, self.client_id),)
        return md

    # --- RPCs ---

    async def register(self, user_id: str, y1: bytes, y2: bytes, timeout: float | None = None):
        return await self._call(
            "Register",
            self._stubs["Register"],
            self.pb2.RegistrationRequest(user_id=user_id, y1=y1, y2=y2),
            timeout,
            user_id=user_id,
        )

    def _partition_groups(
        self, user_ids: list[str]
    ) -> list[tuple[str, list[int]]] | None:
        """Batch fan-out plan: ``[(address, [indices]), ...]`` grouping
        the batch by owning partition under the client's map, or ``None``
        when no fan-out is needed (no map, or a single partition)."""
        pmap = self.partition_map
        if pmap is None or len(pmap.partitions) < 2:
            return None
        groups: dict[str, list[int]] = {}
        for i, uid in enumerate(user_ids):
            groups.setdefault(pmap.partition_for(uid).address, []).append(i)
        return list(groups.items())

    async def register_batch(
        self, user_ids: list[str], y1_values: list[bytes], y2_values: list[bytes],
        timeout: float | None = None,
    ):
        groups = self._partition_groups(user_ids)
        if groups is None:
            return await self._call(
                "RegisterBatch",
                self._stubs["RegisterBatch"],
                self.pb2.BatchRegistrationRequest(
                    user_ids=user_ids, y1_values=y1_values, y2_values=y2_values
                ),
                timeout,
            )
        # fleet fan-out: one sub-batch per owning partition, results
        # reassembled in the caller's entry order
        results = [None] * len(user_ids)
        for address, idxs in groups:
            resp = await self._call(
                "RegisterBatch",
                self._stub(address, "RegisterBatch"),
                self.pb2.BatchRegistrationRequest(
                    user_ids=[user_ids[i] for i in idxs],
                    y1_values=[y1_values[i] for i in idxs],
                    y2_values=[y2_values[i] for i in idxs],
                ),
                timeout,
                address=address,
            )
            for k, i in enumerate(idxs):
                results[i] = resp.results[k]
        return self.pb2.BatchRegistrationResponse(results=results)

    async def create_challenge(self, user_id: str, timeout: float | None = None):
        return await self._call(
            "CreateChallenge",
            self._stubs["CreateChallenge"],
            self.pb2.ChallengeRequest(user_id=user_id),
            timeout,
            user_id=user_id,
        )

    async def verify_proof(
        self, user_id: str, challenge_id: bytes, proof: bytes, timeout: float | None = None
    ):
        # never retried: the challenge is consumed server-side on first
        # receipt, so a resend is guaranteed PERMISSION_DENIED.  (A fleet
        # wrong-partition redirect IS re-routed — ownership is checked
        # before the consume, so nothing was burned.)
        return await self._call(
            "VerifyProof",
            self._stubs["VerifyProof"],
            self.pb2.VerificationRequest(
                user_id=user_id, challenge_id=challenge_id, proof=proof
            ),
            timeout,
            user_id=user_id,
        )

    async def verify_proof_batch(
        self, user_ids: list[str], challenge_ids: list[bytes], proofs: list[bytes],
        timeout: float | None = None,
    ):
        # never retried (same consumed-challenge semantics as VerifyProof)
        groups = self._partition_groups(user_ids)
        if groups is None:
            return await self._call(
                "VerifyProofBatch",
                self._stubs["VerifyProofBatch"],
                self.pb2.BatchVerificationRequest(
                    user_ids=user_ids, challenge_ids=challenge_ids, proofs=proofs
                ),
                timeout,
            )
        results = [None] * len(user_ids)
        for address, idxs in groups:
            resp = await self._call(
                "VerifyProofBatch",
                self._stub(address, "VerifyProofBatch"),
                self.pb2.BatchVerificationRequest(
                    user_ids=[user_ids[i] for i in idxs],
                    challenge_ids=[challenge_ids[i] for i in idxs],
                    proofs=[proofs[i] for i in idxs],
                ),
                timeout,
                address=address,
            )
            for k, i in enumerate(idxs):
                results[i] = resp.results[k]
        return self.pb2.BatchVerificationResponse(results=results)

    async def verify_proof_stream(
        self,
        entries,
        timeout: float | None = None,
        mint_sessions: bool = False,
        chunk: int = 512,
    ):
        """Stream proofs, get verdicts: an async iterator of
        :class:`StreamVerdict` over the ``VerifyProofStream`` bidi RPC.

        ``entries`` is a sync or async iterable of ``(user_id,
        challenge_id, proof_bytes)`` tuples.  The client packs up to
        ``chunk`` entries per wire message (amortizing HTTP/2 frame +
        protobuf overhead — the knob that lets one stream keep a device
        batch engine fed) and assigns sequential ids; verdicts stream
        back in entry order as the server's device batches settle.

        Never retried (same consumed-challenge semantics as
        VerifyProof): a transport failure mid-stream surfaces
        immediately — the caller restarts from CreateChallenge for
        whatever entries had no verdict yet.

        Fleet note: a stream rides ONE channel (the default target), so
        in a multi-partition deployment the driver shards its entry
        stream per partition itself (``partition_map.partition_for``)
        and opens one stream per partition; entries for users this
        partition does not own come back as per-entry wrong-partition
        failures, never a dead stream.

        Convenience wrapper over :meth:`verify_proof_stream_chunks` —
        bulk drivers that count outcomes at 10k+ proofs/s should consume
        the chunk iterator directly and skip the per-entry object."""
        async for chunk_v in self.verify_proof_stream_chunks(
            entries, timeout=timeout, mint_sessions=mint_sessions,
            chunk=chunk,
        ):
            ids, succ, msgs, tokens, push = chunk_v
            n_tok = len(tokens)
            n_msg = len(msgs)
            for k in range(len(ids)):
                ok = succ[k]
                yield StreamVerdict(
                    id=ids[k],
                    ok=ok,
                    message=msgs[k] if k < n_msg else "",
                    session_token=(
                        tokens[k] if k < n_tok and tokens[k] else None
                    ),
                    retry_after_ms=0 if ok else push,
                )

    async def verify_proof_stream_chunks(
        self,
        entries,
        timeout: float | None = None,
        mint_sessions: bool = False,
        chunk: int = 512,
    ):
        """The raw chunk-level face of :meth:`verify_proof_stream`:
        yields ``(ids, success, messages, session_tokens,
        retry_after_ms)`` — plain lists materialized once per response
        message — in entry order.  This is the surface bulk pipelines
        and the e2e bench drive: per-verdict Python objects are the
        client's dominant cost at device-batch rates."""
        rctx = RequestContext()
        self.last_context = rctx
        call = self._stream_stub(
            timeout=timeout, metadata=self._metadata(rctx)
        )

        async def _aiter(items):
            if hasattr(items, "__aiter__"):
                async for item in items:
                    yield item
            else:
                for item in items:
                    yield item

        async def _writer():
            step = max(1, chunk)
            if not hasattr(entries, "__aiter__"):
                # list input (the bulk-driver shape): slice whole chunks
                # instead of stepping an async generator per entry — at
                # device-batch rates the per-entry loop is measurable
                # client overhead on the same host
                items = entries if isinstance(entries, list) else list(entries)
                for lo in range(0, len(items), step):
                    part = items[lo:lo + step]
                    users, cids, proofs = zip(*part)
                    await call.write(self.pb2.StreamVerifyRequest(
                        ids=range(lo, lo + len(part)),
                        user_ids=users,
                        challenge_ids=map(bytes, cids),
                        proofs=map(bytes, proofs),
                        mint_sessions=mint_sessions,
                    ))
                await call.done_writing()
                return
            next_id = 0
            ids, users, cids, proofs = [], [], [], []

            async def _flush():
                nonlocal ids, users, cids, proofs
                await call.write(self.pb2.StreamVerifyRequest(
                    ids=ids, user_ids=users, challenge_ids=cids,
                    proofs=proofs, mint_sessions=mint_sessions,
                ))
                ids, users, cids, proofs = [], [], [], []

            async for user_id, challenge_id, proof in _aiter(entries):
                ids.append(next_id)
                next_id += 1
                users.append(user_id)
                cids.append(bytes(challenge_id))
                proofs.append(bytes(proof))
                if len(ids) >= max(1, chunk):
                    await _flush()
            if ids:
                await _flush()
            await call.done_writing()

        writer = asyncio.ensure_future(_writer())
        try:
            async for resp in call:
                # bulk repeated-field materialization (one C call each)
                # instead of per-index proto __getitem__ in a hot loop
                yield (
                    list(resp.ids),
                    list(resp.success),
                    list(resp.messages),
                    list(resp.session_tokens),
                    int(getattr(resp, "retry_after_ms", 0) or 0),
                )
            await writer
        finally:
            if not writer.done():
                writer.cancel()
                await asyncio.gather(writer, return_exceptions=True)
            # abandoned mid-iteration (caller broke out of the loop):
            # cancel the RPC so the server tears the stream down instead
            # of waiting on a reader that will never come back
            try:
                if not call.done():
                    call.cancel()
            except Exception:  # pragma: no cover - non-grpc call stub
                pass

    async def health_check(
        self, timeout: float | None = None, service: str = ""
    ):
        # service="" is the liveness probe; service="readiness" (or the
        # auth service name) additionally reports NOT_SERVING while the
        # backend is degraded or WAL recovery is still replaying, so load
        # balancers stop routing to a replica that would only shed.
        from ..server.proto import load_health_pb2

        pb2 = load_health_pb2()
        stub = self.channel.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=pb2.HealthCheckRequest.SerializeToString,
            response_deserializer=pb2.HealthCheckResponse.FromString,
        )
        return await self._call(
            "HealthCheck", stub, pb2.HealthCheckRequest(service=service),
            timeout,
        )
