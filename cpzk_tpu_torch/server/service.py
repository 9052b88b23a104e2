"""gRPC AuthService implementation (asyncio).

A copy of ``cpzk_tpu/server/service.py`` on the port's own state store,
wire parse and serving plane.  The handlers' ``admission=`` branch takes
the port's :class:`~cpzk_tpu_torch.admission.AdmissionController`, the
``audit_log=`` branch the port's
:class:`~cpzk_tpu_torch.audit.ProofLogWriter`, the ``replica=`` branch a
:class:`~cpzk_tpu_torch.replication.StandbyReplica` or
:class:`~cpzk_tpu_torch.replication.SegmentShipper` and the ``fleet=``
branch a :class:`~cpzk_tpu_torch.fleet.FleetRouter`; each is inert under
``None``.  Two
departures of the port hold here too: with no ``backend`` the batch
verifier means ``TorchBackend()`` on the card (it raises without CUDA; the
host runs only when passed ``backend=CpuBackend()``), and nothing moves
work to the host unless the serving plane was built with a ``fallback=``.

Behavior parity with the reference service (``src/verifier/service.rs``):
identical validation limits and error strings, opaque "Authentication
failed" for anything secret-adjacent, challenge consumption BEFORE
verification (replay cannot retry a failed proof), per-item results for the
batch RPCs, 32-byte challenge ids and hex session tokens, and the same
metric names. The gRPC plumbing is hand-wired through grpcio's generic
handler API because the protoc gRPC plugin is unavailable (see proto.py).
"""

from __future__ import annotations

import asyncio
import time

import grpc

from dataclasses import dataclass, field

from .. import errors
from ..core.ristretto import Ristretto255
from ..core.rng import SecureRng
from ..core.transcript import Transcript
from ..observability import current_context, traced_rpc, traced_stream_rpc
from ..protocol.batch import BatchEntry, BatchVerifier, VerifierBackend
from ..protocol.gadgets import Parameters, Proof, Statement
from ..protocol.verifier import Verifier
from . import batching, metrics
from . import wire as wire_mod
from .config import RateLimiter, RateLimitExceeded
from .dispatch import DispatchLane
from ..admission.limiter import client_key
from ..resilience.retry import RETRY_PUSHBACK_KEY
from ..audit.log import proof_record
from ..fleet.partition_map import PARTITION_MAP_VERSION_KEY, PARTITION_OWNER_KEY
from .proto import SERVICE_NAME, load_pb2, method_types, stream_method_types
from .state import ServerState, UserData
from .state import user_id_error as _user_id_error

MAX_ELEMENT_WIRE = 4096
MAX_CHALLENGE_ID = 64
MAX_PROOF_WIRE = 8192
MAX_BATCH = 1000

#: Hard cap on entries per stream chunk message: a client packing more is
#: answered with per-entry failures, never a bigger allocation.
MAX_STREAM_CHUNK = 4096

#: "no verdict recorded" sentinel for a stream entry's result slot.
_UNSET = object()

#: Pushback advertised on RESOURCE_EXHAUSTED paths that have no better
#: estimate (no admission controller / no queue signal): one client
#: backoff's worth, so uninstrumented retry loops still spread out.
DEFAULT_RETRY_AFTER_S = 0.05


class AuthServiceImpl:
    """The five unary RPCs (service.rs:59-617 twin) plus the
    ``VerifyProofStream`` bidi-streaming verification surface."""

    def __init__(
        self,
        state: ServerState,
        rate_limiter: RateLimiter,
        backend: VerifierBackend | None = None,
        batcher=None,
        admission=None,
        replica=None,
        audit_log=None,
        stream_window: int = 8192,
        stream_entry_deadline_ms: float = 0.0,
        fleet=None,
        wire: str = "native",
    ):
        self.state = state
        self.rate_limiter = rate_limiter
        #: transport wire mode: "native" = C++ request parse, with the
        #: protobuf runtime for every message it does not recognize,
        #: "python" = protobuf runtime only (see server/wire.py)
        self.wire = wire
        self.backend = backend
        self.batcher = batcher  # DynamicBatcher | None (the card's serving path)
        self.admission = admission  # AdmissionController | None
        self.replica = replica  # StandbyReplica | None (replication standby)
        self.audit_log = audit_log  # audit.ProofLogWriter | None (opt-in)
        self.fleet = fleet  # fleet.FleetRouter | None (partition ownership)
        #: max proof entries in flight per VerifyProofStream before the
        #: reader stops pulling (gRPC flow control then pushes back on the
        #: sender) — bounds per-stream memory without killing the stream
        self.stream_window = max(1, int(stream_window))
        #: per-entry verification deadline for stream entries (0 = only
        #: the stream's own gRPC deadline applies); expired entries are
        #: shed by the batcher and answered with per-entry NOT-verdicts
        self.stream_entry_deadline_s = (
            stream_entry_deadline_ms / 1000.0
            if stream_entry_deadline_ms > 0 else None
        )
        self.pb2 = load_pb2()
        self.rng = SecureRng()
        # inline-verify concurrency: 2 lets one RPC's Python overlap
        # another's GIL-released crypto without unbounded to_thread
        # workers each spawning a cpu-wide native pool (crypto-vs-crypto
        # oversubscription under many concurrent batch RPCs)
        self._inline_verify = asyncio.Semaphore(2)
        # in-flight audit-log fsync tasks (handles kept: a dropped task
        # handle both leaks exceptions and trips ASYNC-002)
        self._audit_flushes: set[asyncio.Task] = set()
        # live VerifyProofStream registry behind the ops plane's /statusz
        # per-stream rows and the auth.stream.active gauge
        self._streams: dict[int, dict] = {}
        self._stream_seq = 0
        # write-time ownership fence: the entry-point _check_owner alone
        # cannot fence multi-await handlers (VerifyProof awaits the
        # batcher between its check and create_session) across a live
        # split's map flip, so state re-verifies ownership INSIDE the
        # shard lock on every acked user-keyed mutation and raises
        # errors.WrongPartition — answered below with the same redirect
        # as the entry check (see ServerState.attach_owner_fence)
        if fleet is not None and hasattr(state, "attach_owner_fence"):
            state.attach_owner_fence(self._wrong_partition_counted)

    # --- stream registry (ops plane introspection seam) -------------------

    def _stream_open(self, client: str, trace_id: str) -> dict:
        self._stream_seq += 1
        info = {
            "id": self._stream_seq,
            "client": client,
            "trace_id": trace_id,
            "opened_unix": time.time(),
            "chunks": 0,
            "entries": 0,
            "inflight": 0,
        }
        self._streams[info["id"]] = info
        metrics.gauge("auth.stream.active").set(len(self._streams))
        return info

    def _stream_close(self, info: dict) -> None:
        self._streams.pop(info["id"], None)
        metrics.gauge("auth.stream.active").set(len(self._streams))

    def stream_stats(self) -> dict:
        """Active VerifyProofStream sessions (the ``streams`` block of
        the ops plane's ``/statusz``)."""
        return {
            "active": len(self._streams),
            "streams": [dict(info) for info in self._streams.values()],
        }

    # --- helpers ---

    async def _abort_exhausted(self, context, msg: str, retry_after_s: float):
        """RESOURCE_EXHAUSTED carrying ``cpzk-retry-after-ms`` trailing
        metadata (gRFC A6 server pushback) — EVERY shed path goes through
        here, not only admission rejections, so a bare 'try again
        whenever' rejection no longer exists."""
        ms = max(0, int(round(retry_after_s * 1000.0)))
        md = ((RETRY_PUSHBACK_KEY, str(ms)),)
        try:
            await context.abort(
                grpc.StatusCode.RESOURCE_EXHAUSTED, msg, trailing_metadata=md
            )
        except TypeError:  # hand-rolled test context without the kwarg
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, msg)

    def _pushback_s(self, default: float = DEFAULT_RETRY_AFTER_S) -> float:
        """Queue-drain-sized pushback when a controller is wired, else
        ``default``."""
        if self.admission is not None:
            return self.admission.retry_after_s()
        return default

    async def _admit(self, context, rpc: str) -> None:
        """Full admission stack for one RPC: the global token bucket
        (backstop), then the per-client keyed bucket and the adaptive
        priority threshold.  Rejections abort RESOURCE_EXHAUSTED with
        retry pushback.  A replication standby that has not been promoted
        refuses every auth RPC outright — its state is a replica of the
        primary's, and writes on it would fork history."""
        if self.replica is not None and self.replica.role != "primary":
            # counted like every other shed path so the /slo burn math and
            # dashboards see standby refusals, not a silent abort
            metrics.counter("admission.shed.standby").inc()
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "standby replica: not promoted (writes go to the primary)",
            )
        try:
            await self.rate_limiter.check_rate_limit()
        except RateLimitExceeded as e:
            metrics.counter("admission.shed.global").inc()
            await self._abort_exhausted(
                context, "Rate limit exceeded",
                getattr(e, "retry_after_s", 0.0) or DEFAULT_RETRY_AFTER_S,
            )
        if self.admission is None:
            return
        rejection = self.admission.admit(rpc, client_key(context))
        if rejection is not None:
            await self._abort_exhausted(
                context, rejection.message, rejection.retry_after_s
            )

    @staticmethod
    async def _validate_user_id(user_id: str, context) -> None:
        msg = _user_id_error(user_id)
        if msg is not None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)

    def _wrong_partition(self, user_id: str) -> str | None:
        """Redirect message when this partition does not own ``user_id``
        under the loaded map, else ``None``.  The single-partition fast
        path is a constant-time no-op inside ``FleetRouter.owns`` — fleet
        routing must cost the N=1 hot path nothing (perf-gate pinned).

        A coordinated handover fences the WHOLE node, challenge creates
        and consumes included: unlike a live split (where the consume
        stays open so an in-flight login can finish here), the standby
        holds every challenge shipped before the fence watermark, while
        a challenge minted here after it replicates nowhere — serving
        the challenge flow on a fenced/deposed primary strands logins
        for the whole drain window.  Checking BEFORE the consume keeps
        the redirect replay-safe: the login retries at the standby with
        its challenge intact there."""
        fleet = self.fleet
        if fleet is not None and not fleet.owns(user_id):
            owner = fleet.owner(user_id)
            return (
                f"wrong partition: user is owned by partition {owner.index} "
                f"at {owner.address} (map v{fleet.map.version})"
            )
        target = getattr(self.replica, "redirect_address", None)
        if target is not None:
            return (
                "wrong partition: handover in progress; writes go to "
                f"the standby at {target}"
            )
        return None

    def _wrong_partition_counted(self, user_id: str) -> str | None:
        """Per-entry form for the batch/stream paths: the same redirect
        message as :meth:`_check_owner`, counted, but answered as an
        individual failure (one misrouted entry must not abort its batch
        siblings — the client fans batches out per partition)."""
        msg = self._wrong_partition(user_id)
        if msg is not None:
            if self.fleet is not None:  # handover fences fleetless pairs too
                self.fleet.redirects += 1
            metrics.counter("fleet.redirects").inc()
        return msg

    async def _check_owner(self, user_id: str, context) -> None:
        """Partition-ownership enforcement, BEFORE any state access: a
        wrong-partition request aborts ``FAILED_PRECONDITION`` with the
        map version and the owning partition's address in trailing
        metadata (the same trailer discipline as retry pushback), so a
        stale-map client can refresh + re-route in one round trip.
        Running this ahead of every state touch is what makes the
        redirect replay-safe even for ``VerifyProof`` — the challenge is
        still unconsumed when the redirect goes out."""
        msg = self._wrong_partition_counted(user_id)
        if msg is None:
            return
        await self._redirect_abort(user_id, context, msg)

    async def _redirect_abort(self, user_id: str, context, msg: str) -> None:
        """The wrong-partition abort itself (counting is the caller's —
        or the write-time fence's — job): ``FAILED_PRECONDITION`` with
        the map version and the owning partition's address in trailing
        metadata, so a stale-map client can refresh + re-route in one
        round trip.  Shared by the entry check above and the
        ``errors.WrongPartition`` handlers on the mutation paths."""
        fleet = self.fleet
        # during a coordinated handover the write fence redirects at the
        # STANDBY, not at what the (not-yet-flipped) map says this
        # partition's owner is — and it must work with no fleet at all
        # (a plain replicated pair): the shipper carries the target
        target = getattr(self.replica, "redirect_address", None)
        if target:
            md = (
                (PARTITION_MAP_VERSION_KEY,
                 str(fleet.map.version) if fleet is not None else "0"),
                (PARTITION_OWNER_KEY, target),
            )
        else:
            owner = fleet.owner(user_id)
            md = (
                (PARTITION_MAP_VERSION_KEY, str(fleet.map.version)),
                (PARTITION_OWNER_KEY, owner.address),
            )
        try:
            await context.abort(
                grpc.StatusCode.FAILED_PRECONDITION, msg,
                trailing_metadata=md,
            )
        except TypeError:  # hand-rolled test context without the kwarg
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION, msg)

    @staticmethod
    def _note_wire(request) -> None:
        """wire_parse trace span for natively-parsed requests (no-op on
        the protobuf path and outside an instrumented RPC)."""
        rctx = current_context.get()
        wire_mod.note_wire_parse(
            request, rctx.trace_id if rctx is not None else None
        )

    @staticmethod
    def _request_context(context):
        """The decorator-minted :class:`RequestContext` of this RPC (trace
        id + absolute deadline), or a fresh one when the handler was
        invoked outside ``traced_rpc`` (hand-rolled test harnesses)."""
        rctx = current_context.get()
        if rctx is None:
            from ..observability import RequestContext, rpc_deadline

            rctx = RequestContext.from_grpc(
                context, deadline=rpc_deadline(context)
            )
        return rctx

    def _audit_note(
        self, items: list[tuple[str, Statement, bytes, bytes, bool]]
    ) -> None:
        """Append verification outcomes to the proof log (no-op unless
        ``[audit]`` wired one in).  ``items``: (user_id, statement,
        challenge_id, proof_wire, verdict) per VERIFIED entry — shed or
        errored entries never reached the verifier and are not audit
        events.  The append is one buffered ``os.write``; the fsync (when
        the policy wants one) runs on a worker thread with its task
        handle retained."""
        log = self.audit_log
        if log is None or not items:
            return
        eb = Ristretto255.element_to_bytes
        try:
            log.append_proofs([
                proof_record(uid, eb(st.y1), eb(st.y2), ctx, wire, ok)
                for uid, st, ctx, wire, ok in items
            ])
        except OSError:
            metrics.counter("audit.log.errors").inc()
            return
        if log.needs_sync():
            task = asyncio.get_running_loop().create_task(
                asyncio.to_thread(log.sync)
            )
            self._audit_flushes.add(task)
            task.add_done_callback(self._audit_flushes.discard)

    def _parse_statement(self, y1_bytes: bytes, y2_bytes: bytes) -> Statement:
        """Shared register-path statement validation; raises errors.Error
        with the reference's message prefixes."""
        try:
            y1 = Ristretto255.element_from_bytes(y1_bytes)
        except errors.Error as e:
            raise errors.InvalidParams(f"Invalid y1: {e}") from None
        try:
            y2 = Ristretto255.element_from_bytes(y2_bytes)
        except errors.Error as e:
            raise errors.InvalidParams(f"Invalid y2: {e}") from None
        statement = Statement(y1, y2)
        try:
            statement.validate()
        except errors.Error as e:
            raise errors.InvalidParams(f"Invalid statement: {e}") from None
        if Ristretto255.is_identity(y1) or Ristretto255.is_identity(y2):
            raise errors.InvalidParams("Statement contains identity elements")
        return statement

    # --- RPCs ---

    # requests/success/failure counters and the duration histogram for
    # every RPC live in the traced_rpc decorator (one lifecycle, no
    # skipped .observe() on early-abort paths); handler bodies keep only
    # their domain-specific counters.

    @traced_rpc("Register", "auth.register")
    async def register(self, request, context):
        await self._admit(context, "Register")
        await self._validate_user_id(request.user_id, context)
        await self._check_owner(request.user_id, context)

        if not request.y1 or not request.y2:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "Empty y1 or y2 values")
        if len(request.y1) > MAX_ELEMENT_WIRE or len(request.y2) > MAX_ELEMENT_WIRE:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "y1 or y2 values too large")

        try:
            statement = self._parse_statement(request.y1, request.y2)
        except errors.Error as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))

        try:
            await self.state.register_user(
                UserData(
                    user_id=request.user_id,
                    statement=statement,
                    registered_at=int(time.time()),
                )
            )
        except errors.WrongPartition as e:
            # ownership moved between the entry check and the insert (a
            # live split flipped the map mid-flight): redirect, no ack
            await self._redirect_abort(request.user_id, context, str(e))
        except errors.Error as e:
            await context.abort(grpc.StatusCode.ALREADY_EXISTS, f"Registration failed: {e}")

        return self.pb2.RegistrationResponse(
            success=True,
            message=f"User '{request.user_id}' registered successfully",
        )

    @traced_rpc("RegisterBatch", "auth.register_batch")
    async def register_batch(self, request, context):
        await self._admit(context, "RegisterBatch")

        n = len(request.user_ids)
        if n == 0:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "Empty batch")
        if n != len(request.y1_values) or n != len(request.y2_values):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "Mismatched array lengths in batch request"
            )
        if n > MAX_BATCH:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"Batch size exceeds maximum limit of {MAX_BATCH}",
            )
        metrics.counter("auth.register_batch.users_count").inc(n)

        # per entry: the failure message, or None while the entry waits
        # for the state; the valid entries then register in one call with
        # one journal sync for the batch (answered together, so one fsync
        # before the response covers every acknowledged registration)
        messages: list[str | None] = []
        users: list[UserData] = []
        for i in range(n):
            user_id = request.user_ids[i]
            y1b, y2b = request.y1_values[i], request.y2_values[i]

            msg = _user_id_error(user_id)
            if msg is None:
                msg = self._wrong_partition_counted(user_id)
            if msg is None:
                if not y1b or not y2b:
                    msg = f"Empty y1 or y2 values for user {i}"
                elif len(y1b) > MAX_ELEMENT_WIRE or len(y2b) > MAX_ELEMENT_WIRE:
                    msg = f"y1 or y2 values too large for user {i}"
            if msg is None:
                try:
                    statement = self._parse_statement(y1b, y2b)
                    users.append(UserData(
                        user_id=user_id,
                        statement=statement,
                        registered_at=int(time.time()),
                    ))
                except errors.Error as e:
                    msg = str(e)
            messages.append(msg)

        outcomes = iter(await self.state.register_users(users))
        results = []
        for user_id, msg in zip(request.user_ids, messages):
            if msg is None:
                err = next(outcomes)
                if err is not None:
                    msg = str(err)
                    if "already registered" in msg or "capacity" in msg:
                        msg = f"Registration failed: {msg}"
            if msg is not None:
                results.append(self.pb2.RegistrationResult(success=False, message=msg))
                metrics.counter("auth.register_batch.individual_failure").inc()
                continue
            results.append(
                self.pb2.RegistrationResult(
                    success=True,
                    message=f"User '{user_id}' registered successfully",
                )
            )
            metrics.counter("auth.register_batch.individual_success").inc()

        return self.pb2.BatchRegistrationResponse(results=results)

    @traced_rpc("CreateChallenge", "auth.challenge")
    async def create_challenge(self, request, context):
        self._note_wire(request)
        await self._admit(context, "CreateChallenge")
        await self._validate_user_id(request.user_id, context)
        await self._check_owner(request.user_id, context)

        user = await self.state.get_user(request.user_id)
        if user is None:
            await context.abort(
                grpc.StatusCode.NOT_FOUND, f"User '{request.user_id}' not found"
            )

        # the id carries the owning user's shard index in byte 0, so
        # VerifyProof routes straight to the shard that issued it
        challenge_id = self.state.tag_challenge_id(
            user.user_id, self.rng.fill_bytes(32)
        )
        try:
            expires_at = await self.state.create_challenge(user.user_id, challenge_id)
        except errors.WrongPartition as e:
            await self._redirect_abort(request.user_id, context, str(e))
        except errors.Error as e:
            # per-user challenge-cap overload: pushback rides along like
            # every other RESOURCE_EXHAUSTED
            await self._abort_exhausted(
                context, f"Challenge creation failed: {e}", self._pushback_s()
            )

        return self.pb2.ChallengeResponse(challenge_id=challenge_id, expires_at=expires_at)

    @traced_rpc("VerifyProof", "auth.verify")
    async def verify_proof(self, request, context):
        await self._admit(context, "VerifyProof")
        await self._validate_user_id(request.user_id, context)
        # ownership BEFORE consume_challenge: a redirected VerifyProof
        # never burned its challenge, so re-routing it is safe
        await self._check_owner(request.user_id, context)

        msg = _proof_args_error(request.challenge_id, request.proof)
        if msg is not None:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, msg)

        try:
            challenge = await self.state.consume_challenge(request.challenge_id)
        except errors.Error:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, "Authentication failed")
        if challenge.user_id != request.user_id:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, "Authentication failed")

        user = await self.state.get_user(request.user_id)
        if user is None:
            await context.abort(grpc.StatusCode.PERMISSION_DENIED, "Authentication failed")

        try:
            proof = Proof.from_bytes(request.proof)
        except errors.Error as e:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, f"Invalid proof: {e}")

        if self.batcher is not None:
            # the card's serving path: coalesce with concurrent RPCs into one
            # device batch; per-entry result has identical semantics
            rctx = self._request_context(context)
            try:
                verify_err = await self.batcher.submit(
                    Parameters.new(), user.statement, proof,
                    bytes(request.challenge_id),
                    deadline=rctx.deadline,
                    trace_id=rctx.trace_id,
                )
            except batching.QueueFull:
                await self._abort_exhausted(
                    context, "Server overloaded", self._pushback_s()
                )
            except batching.DeadlineExceeded:
                await context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    "Deadline expired before verification",
                )
        else:
            verifier = Verifier(Parameters.new(), user.statement)
            transcript = Transcript()
            transcript.append_context(request.challenge_id)
            try:
                verifier.verify_with_transcript(proof, transcript)
                verify_err = None
            except errors.Error as e:
                verify_err = e
        # audit trail BEFORE the failure abort: rejected proofs are audit
        # events too (the bulk pipeline re-checks both verdicts)
        self._audit_note([(
            request.user_id, user.statement, bytes(request.challenge_id),
            bytes(request.proof), verify_err is None,
        )])
        if verify_err is not None:
            await context.abort(
                grpc.StatusCode.PERMISSION_DENIED, f"Verification failed: {verify_err}"
            )

        # shard-tagged like the challenge id: validate/revoke route
        # straight to the issuing shard
        token = self.state.tag_session_token(
            request.user_id, self.rng.fill_bytes(32).hex()
        )
        try:
            await self.state.create_session(token, request.user_id)
        except errors.WrongPartition as e:
            # the split race: ownership was checked at entry,
            # the batcher await straddled a live split's map flip, and the
            # session write reached a partition that no longer owns the
            # user.  The fence rejected it BEFORE any state or WAL touch,
            # so no token is acked that exists on neither partition — the
            # client re-routes (its challenge is gone here, so the login
            # restarts at the new owner; a failed attempt, never a lie)
            await self._redirect_abort(request.user_id, context, str(e))
        except errors.Error as e:
            await context.abort(grpc.StatusCode.INTERNAL, f"Failed to create session: {e}")

        return self.pb2.VerificationResponse(
            success=True,
            message=f"User '{request.user_id}' authenticated successfully",
            session_token=token,
        )

    @traced_rpc("VerifyProofBatch", "auth.verify_batch")
    async def verify_proof_batch(self, request, context):
        self._note_wire(request)
        await self._admit(context, "VerifyProofBatch")

        n = len(request.user_ids)
        if n == 0:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, "Empty batch")
        if n != len(request.challenge_ids) or n != len(request.proofs):
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "Mismatched array lengths in batch request"
            )
        if n > MAX_BATCH:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"Batch size exceeds maximum limit of {MAX_BATCH}",
            )
        metrics.counter("auth.verify_batch.proofs_count").inc(n)

        # materialize the repeated fields once: protobuf repeated-field
        # __getitem__ costs add up over 3 accesses x 1000 items (the
        # native wire views already hold plain lists — no copy needed)
        user_ids = request.user_ids
        if type(user_ids) is not list:
            user_ids = list(user_ids)
        challenge_ids = request.challenge_ids
        if type(challenge_ids) is not list:
            challenge_ids = list(challenge_ids)
        proof_wires = request.proofs
        if type(proof_wires) is not list:
            proof_wires = list(proof_wires)

        batch = BatchVerifier(backend=self.backend)
        contexts: list[str | None] = []  # user_id once queued for verify, else None
        statements: dict[int, Statement] = {}  # queued-for-verify audit trail
        error_msgs: list[str] = []
        # stage 1: argument validation (no awaits)
        staged: list[int] = []  # indices that passed arg validation
        for i in range(n):
            msg = _user_id_error(user_ids[i])
            if msg is None:
                # ownership BEFORE staging: a misrouted entry is answered
                # with the redirect message and its challenge is NEVER
                # consumed, so re-sending it to the owner succeeds
                msg = self._wrong_partition_counted(user_ids[i])
            if msg is None:
                msg = _proof_args_error(challenge_ids[i], proof_wires[i], index=i)
            contexts.append(None)
            error_msgs.append(msg or "")
            if msg is None:
                staged.append(i)

        # stage 2: consume BEFORE verification — single-use even on failure
        # (service.rs:478).  Bulk state calls:
        # one lock acquisition for all n consumes (and one for the user
        # lookups) instead of 2n event-loop round-trips.
        challenges = await self.state.consume_challenges(
            [challenge_ids[i] for i in staged])
        users = await self.state.get_users(
            [user_ids[i] for i in staged])
        live: list[tuple[int, UserData]] = []
        for i, challenge, user in zip(staged, challenges, users, strict=True):
            if (
                challenge is None
                or challenge.user_id != user_ids[i]
                or user is None
            ):
                error_msgs[i] = "Authentication failed"
                continue
            live.append((i, user))
        # Bulk parse: one native validation pass for the whole batch,
        # commitment point decodes DEFERRED on every path — the
        # batch-verify stage decodes them anyway (BatchVerifier settles
        # failures with the exact parse error).  On the batcher path the
        # deferred screening runs in BatchVerifier.prepare_batch on the
        # dispatch lane's prep thread, overlapped with the previous
        # batch's device compute, so the decode cost leaves the RPC's
        # serial path entirely.
        # when every entry survived screening, the native wire view's
        # contiguous proof buffer (gathered in C straight off the socket
        # bytes) feeds the batched parse with no Python re-join
        packed = (
            request.packed_proofs(n)
            if len(live) == n and hasattr(request, "packed_proofs")
            else None
        )
        parsed = Proof.from_bytes_batch(
            [proof_wires[i] for i, _ in live],
            defer_point_validation=True,
            packed=packed,
        )
        params = Parameters.new()  # shared generators: one instance per RPC
        for (i, user), proof in zip(live, parsed, strict=True):
            if isinstance(proof, errors.Error):
                error_msgs[i] = f"Invalid proof: {proof}"
                continue
            try:
                batch.add_with_context(
                    params, user.statement, proof, bytes(challenge_ids[i]),
                )
            except errors.Error as e:
                error_msgs[i] = f"Failed to add proof to batch: {e}"
                continue
            contexts[i] = user_ids[i]
            statements[i] = user.statement

        batch_results: list = []
        if len(batch) > 0:
            try:
                if self.batcher is not None:
                    # one bulk enqueue; all-or-nothing on backpressure, so
                    # no orphaned sibling submits to drain on QueueFull.
                    # All entries share this RPC's deadline: past it the
                    # batcher sheds them instead of burning device time.
                    rctx = self._request_context(context)
                    for entry in batch.entries:
                        entry.deadline = rctx.deadline
                        entry.trace_id = rctx.trace_id
                    batch_results = await self.batcher.submit_many(batch.entries)
                else:
                    # worker thread, not the event loop: the native verify
                    # releases the GIL, so a concurrent RPC's Python
                    # (parse, state ops, response build) overlaps this
                    # batch's crypto instead of queueing behind ~100ms of
                    # blocked loop — and health checks stay responsive
                    async with self._inline_verify:
                        batch_results = await asyncio.to_thread(
                            batch.verify, self.rng)
            except batching.QueueFull:
                await self._abort_exhausted(
                    context, "Server overloaded", self._pushback_s()
                )
            except batching.DeadlineExceeded:
                await context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED,
                    "Deadline expired before verification",
                )
            except errors.Error as e:
                await context.abort(grpc.StatusCode.INTERNAL, f"Batch verification failed: {e}")

        # session issuance for verified items — one bulk mint (single lock,
        # single CSPRNG draw sliced into per-item tokens)
        verified: list[int] = []
        tokens: dict[int, str] = {}
        batch_index = 0
        verify_errs: dict[int, object] = {}
        audit_items = []
        for i in range(n):
            if contexts[i] is None:
                continue
            verify_errs[i] = batch_results[batch_index]
            batch_index += 1
            if verify_errs[i] is None:
                verified.append(i)
            audit_items.append((
                contexts[i], statements[i], bytes(challenge_ids[i]),
                bytes(proof_wires[i]), verify_errs[i] is None,
            ))
        self._audit_note(audit_items)
        token_pool = self.rng.fill_bytes(32 * len(verified)).hex()
        for k, i in enumerate(verified):
            tokens[i] = self.state.tag_session_token(
                contexts[i], token_pool[64 * k: 64 * (k + 1)]
            )
        # cpzk-lint: disable=AWAIT-001 -- bulk mint: the fence verdict comes back per-entry from create_sessions (re-checked inside its shard lock) and is mapped to redirect-shaped messages below — the batch wire contract has no single redirect to raise
        session_errs = await self.state.create_sessions(
            [(tokens[i], contexts[i]) for i in verified])
        session_err_by_index = dict(zip(verified, session_errs, strict=True))

        results = []
        n_failure = 0
        Result = self.pb2.VerificationResult
        for i in range(n):
            user_id = contexts[i]
            if user_id is None:
                results.append(Result(success=False, message=error_msgs[i]))
                n_failure += 1
                continue
            verr = verify_errs[i]
            if verr is not None:
                # a deferred-parse proof whose commitment wire failed to
                # decode reports the exact parse-time message; genuine
                # verification failures stay opaque (service.rs:528)
                if isinstance(verr, errors.InvalidProofEncoding):
                    msg = f"Invalid proof: {verr}"
                else:
                    msg = "Authentication failed"
                results.append(Result(success=False, message=msg))
                n_failure += 1
                continue
            serr = session_err_by_index[i]
            if serr is not None:
                # a write-time fence rejection (live split flipped the map
                # mid-batch) keeps the entry-check redirect shape so the
                # client's per-entry re-route handling sees one format
                if serr.startswith("wrong partition"):
                    msg = serr
                else:
                    msg = f"Failed to create session: {serr}"
                results.append(Result(success=False, message=msg))
                n_failure += 1
                continue
            results.append(Result(
                success=True,
                message=f"User '{user_id}' authenticated successfully",
                session_token=tokens[i],
            ))
        if n_failure:
            metrics.counter("auth.verify_batch.individual_failure").inc(n_failure)
        if n - n_failure:
            metrics.counter("auth.verify_batch.individual_success").inc(n - n_failure)

        return self.pb2.BatchVerificationResponse(results=results)

    # --- streaming verification -------------------------------------------

    @traced_stream_rpc("VerifyProofStream", "auth.verify_stream")
    async def verify_proof_stream(self, request_iterator, context):
        """Bidirectional streaming verification: the client streams proof
        entries (possibly several per message — parallel arrays keyed by
        ``ids``), the server streams verdicts as their device batches
        settle.  Entries enqueue straight into the dynamic batcher, so
        one stream gives the dispatch lane naturally deep, card-sized
        batches without per-RPC overhead.

        Contract highlights (pinned in ``tests/test_torch_streaming.py``):

        - **flow control**: at most ``stream_window`` entries in flight;
          past it the reader stops pulling and gRPC's own flow control
          pushes back on the sender — memory stays bounded, the stream
          stays open;
        - **admission per proof, not per RPC**: the keyed token bucket is
          charged for every entry (client id read once at stream open);
          a shed entry answers a per-entry NOT-verdict with the pushback
          delay in ``retry_after_ms`` (and trailing metadata at stream
          end) — the stream is never killed for overload;
        - **per-entry deadline shedding**: expired entries come back as
          NOT-verdicts while their batch siblings carry real verdicts;
        - **failure isolation**: a backend blow-up is confined to its
          chunk (NOT-verdicts), the stream and the lane both survive;
        - **verdict order** follows entry order.
        """
        if self.replica is not None and self.replica.role != "primary":
            metrics.counter("admission.shed.standby").inc()
            await context.abort(
                grpc.StatusCode.UNAVAILABLE,
                "standby replica: not promoted (writes go to the primary)",
            )
        # the global bucket is an RPC-level backstop: one charge per
        # stream open; per-PROOF fairness is the keyed bucket below
        try:
            await self.rate_limiter.check_rate_limit()
        except RateLimitExceeded as e:
            metrics.counter("admission.shed.global").inc()
            await self._abort_exhausted(
                context, "Rate limit exceeded",
                getattr(e, "retry_after_s", 0.0) or DEFAULT_RETRY_AFTER_S,
            )
        client = client_key(context)  # read once at stream open
        rctx = self._request_context(context)
        stream_info = self._stream_open(client, rctx.trace_id)
        pushback_ms = 0

        def note_pushback(ms: int) -> None:
            nonlocal pushback_ms
            pushback_ms = max(pushback_ms, ms)

        # reader task + responder loop: chunks dispatch the moment they
        # arrive and verdicts flow back the moment their batches settle —
        # a client that reads verdicts before sending its next chunk must
        # never deadlock against a handler that only flushes on pressure.
        # The window condition is the flow-control seam: past
        # ``stream_window`` in-flight entries the reader stops pulling,
        # and gRPC's transport-level flow control pushes back on the
        # sender without killing the stream.
        cond = asyncio.Condition()
        inflight = 0
        unsettled: set[_StreamChunk] = set()
        out_q: asyncio.Queue[_StreamChunk | None] = asyncio.Queue()

        async def reader() -> None:
            nonlocal inflight
            try:
                async for request in request_iterator:
                    async with cond:
                        while inflight > self.stream_window:
                            await cond.wait()
                    work = self._stream_start_chunk(
                        request, client, rctx, note_pushback
                    )
                    inflight += work.size
                    stream_info["chunks"] += 1
                    stream_info["entries"] += len(work.ids)
                    stream_info["inflight"] = inflight
                    unsettled.add(work)
                    out_q.put_nowait(work)
            finally:
                out_q.put_nowait(None)

        reader_task = asyncio.get_running_loop().create_task(reader())
        try:
            while True:
                work = await out_q.get()
                if work is None:
                    break
                resp = await self._stream_settle(work)
                unsettled.discard(work)
                async with cond:
                    inflight -= work.size
                    cond.notify_all()
                stream_info["inflight"] = inflight
                yield resp
            await reader_task  # surface a reader-side transport error
        finally:
            self._stream_close(stream_info)
            # client gone / handler torn down with chunks in flight:
            # cancel the reader and every unsettled verify task so no
            # batcher future leaks (cancelled chunk futures are shed as
            # 'abandoned' before device dispatch)
            if not reader_task.done():
                reader_task.cancel()
            doomed = [w.task for w in unsettled if w.task is not None]
            for task in doomed:
                task.cancel()
            if doomed or not reader_task.done():
                await asyncio.gather(
                    reader_task, *doomed, return_exceptions=True,
                )
            if pushback_ms > 0:
                try:
                    context.set_trailing_metadata(
                        ((RETRY_PUSHBACK_KEY, str(pushback_ms)),)
                    )
                except Exception:  # hand-rolled test context
                    pass

    def _stream_start_chunk(
        self, request, client: str, rctx, note_pushback
    ) -> "_StreamChunk":
        """Validate + admit one chunk message, consume its challenges,
        and dispatch the survivors into the batcher WITHOUT awaiting —
        the caller keeps reading while the device works."""
        wire_mod.note_wire_parse(request, rctx.trace_id)
        ids = request.ids
        ids = list(ids) if type(ids) is not list else ids
        n = len(ids)
        work = _StreamChunk(ids=ids, size=max(n, 1),
                            mint=bool(request.mint_sessions))
        if (
            n == 0
            or n != len(request.user_ids)
            or n != len(request.challenge_ids)
            or n != len(request.proofs)
        ):
            work.chunk_error = (
                "Mismatched array lengths in stream chunk"
                if n else "Empty stream chunk"
            )
            return work
        if n > MAX_STREAM_CHUNK:
            work.chunk_error = (
                f"Stream chunk exceeds maximum of {MAX_STREAM_CHUNK} entries"
            )
            return work
        metrics.counter("auth.stream.proofs_count").inc(n)
        user_ids = request.user_ids
        user_ids = list(user_ids) if type(user_ids) is not list else user_ids
        challenge_ids = request.challenge_ids
        if type(challenge_ids) is not list:
            challenge_ids = list(challenge_ids)
        proof_wires = request.proofs
        if type(proof_wires) is not list:
            proof_wires = list(proof_wires)
        if hasattr(request, "packed_proofs"):
            work.packed = request.packed_proofs(n)
        work.messages = [""] * n
        work.results = [_UNSET] * n
        work.user_ids = user_ids
        work.challenge_ids = challenge_ids
        work.proof_wires = proof_wires
        staged: list[int] = []
        uid_memo: dict[str, str | None] = {}  # streams repeat user ids
        for i in range(n):
            # keyed fair admission charged per PROOF:
            # a hot streamer exhausts its own bucket entry by entry and
            # gets NOT-verdicts + pushback, never a dead stream
            if self.admission is not None:
                rejection = self.admission.admit("VerifyProof", client)
                if rejection is not None:
                    ms = max(0, int(round(rejection.retry_after_s * 1000.0)))
                    note_pushback(ms)
                    work.messages[i] = rejection.message
                    work.shed[i] = ms
                    metrics.counter("auth.stream.shed").inc()
                    continue
            uid = user_ids[i]
            if uid in uid_memo:
                msg = uid_memo[uid]
            else:
                # ownership rides the same memo as user-id validation
                # (streams repeat user ids): one hash per distinct user,
                # misrouted entries answered per-entry, stream survives
                msg = uid_memo[uid] = (
                    _user_id_error(uid) or self._wrong_partition_counted(uid)
                )
            msg = msg or _proof_args_error(challenge_ids[i], proof_wires[i])
            if msg is not None:
                work.messages[i] = msg
                continue
            staged.append(i)
        work.staged = staged
        if staged:
            work.task = asyncio.get_running_loop().create_task(
                self._stream_verify(work, rctx)
            )
        return work

    async def _stream_verify(self, work: "_StreamChunk", rctx) -> None:
        """One chunk's consume -> lookup -> parse -> dispatch, recording
        per-entry outcomes onto ``work`` (runs as a task so the stream
        reader is never blocked on the device)."""
        staged = work.staged
        challenges = await self.state.consume_challenges(
            [work.challenge_ids[i] for i in staged])
        users = await self.state.get_users(
            [work.user_ids[i] for i in staged])
        live: list[int] = []
        for i, challenge, user in zip(staged, challenges, users, strict=True):
            if (
                challenge is None
                or challenge.user_id != work.user_ids[i]
                or user is None
            ):
                work.messages[i] = "Authentication failed"
                continue
            work.users[i] = user
            live.append(i)
        parsed = Proof.from_bytes_batch(
            [work.proof_wires[i] for i in live],
            defer_point_validation=True,
            # native wire views: the C-gathered contiguous proof buffer
            # feeds the batched parse when every entry survived screening
            packed=(
                work.packed
                if len(live) == len(work.proof_wires) else None
            ),
        )
        params = Parameters.new()
        deadline = rctx.deadline
        if self.stream_entry_deadline_s is not None:
            entry_deadline = time.monotonic() + self.stream_entry_deadline_s
            deadline = (
                entry_deadline if deadline is None
                else min(deadline, entry_deadline)
            )
        entries: list[BatchEntry] = []
        queued: list[int] = []
        for i, proof in zip(live, parsed, strict=True):
            if isinstance(proof, errors.Error):
                work.messages[i] = f"Invalid proof: {proof}"
                continue
            entries.append(BatchEntry(
                params, work.users[i].statement, proof,
                bytes(work.challenge_ids[i]),
                deadline=deadline, trace_id=rctx.trace_id,
            ))
            queued.append(i)
        if not entries:
            return
        if self.batcher is not None:
            try:
                results = await self.batcher.submit_group(entries)
            except batching.QueueFull:
                results = [batching.QueueFull("Server overloaded")] * len(entries)
        else:
            # inline CPU path: same dispatch seam, worker thread, bounded
            # crypto concurrency (GIL-released native verify)
            async with self._inline_verify:
                try:
                    results = await asyncio.to_thread(
                        DispatchLane.verify_once,
                        self.backend, self.rng, entries,
                    )
                except errors.Error as exc:
                    results = [exc] * len(entries)
        for i, res in zip(queued, results, strict=True):
            work.results[i] = res

    async def _stream_settle(self, work: "_StreamChunk"):
        """Await a chunk's verification task and build its verdict
        message (sessions minted in bulk, audit records appended)."""
        Resp = self.pb2.StreamVerifyResponse
        if work.chunk_error is not None:
            return Resp(
                ids=work.ids,
                success=[False] * len(work.ids),
                messages=[work.chunk_error] * len(work.ids),
            )
        if work.task is not None:
            try:
                await work.task
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # chunk-confined: stream survives
                blowup = RuntimeError(f"Batch verification failed: {exc}")
                for i in work.staged:
                    if work.results[i] is _UNSET and work.users.get(i) is not None:
                        work.results[i] = blowup
        n = len(work.ids)
        success = [False] * n
        audit_items = []
        verified: list[int] = []
        retry_ms = 0
        shed = work.shed
        results = work.results
        for i in range(n):
            if shed and i in shed:
                retry_ms = max(retry_ms, shed[i])
                continue
            res = results[i]
            if res is _UNSET:
                continue  # message already set (validation/auth failure)
            if res is None:
                success[i] = True
                verified.append(i)
            elif isinstance(res, batching.DeadlineExceeded):
                work.messages[i] = "Deadline expired before verification"
                metrics.counter("auth.stream.shed").inc()
            elif isinstance(res, batching.QueueFull):
                work.messages[i] = "Server overloaded"
                ms = max(0, int(round(self._pushback_s() * 1000.0)))
                retry_ms = max(retry_ms, ms)
                metrics.counter("auth.stream.shed").inc()
            elif isinstance(res, errors.InvalidProofEncoding):
                work.messages[i] = f"Invalid proof: {res}"
            elif isinstance(res, errors.Error):
                work.messages[i] = "Authentication failed"
            else:  # dispatch blow-up (backend raise) confined to chunk
                work.messages[i] = "Verification unavailable"
            if isinstance(res, (type(None), errors.Error)):
                user = work.users.get(i)
                if user is not None:
                    audit_items.append((
                        work.user_ids[i], user.statement,
                        bytes(work.challenge_ids[i]),
                        bytes(work.proof_wires[i]), res is None,
                    ))
        self._audit_note(audit_items)
        tokens: dict[int, str] = {}
        if work.mint and verified:
            pool = self.rng.fill_bytes(32 * len(verified)).hex()
            pairs = []
            for k, i in enumerate(verified):
                tokens[i] = self.state.tag_session_token(
                    work.user_ids[i], pool[64 * k: 64 * (k + 1)]
                )
                pairs.append((tokens[i], work.user_ids[i]))
            session_errs = await self.state.create_sessions(pairs)
            for i, err in zip(verified, session_errs, strict=True):
                if err is not None:
                    success[i] = False
                    # fence rejections keep the redirect shape (see
                    # verify_proof_batch) so stream consumers re-route
                    work.messages[i] = (
                        err if err.startswith("wrong partition")
                        else f"Failed to create session: {err}"
                    )
                    tokens.pop(i, None)
        resp = Resp(
            ids=work.ids,
            success=success,
            messages=work.messages,
            retry_after_ms=retry_ms,
        )
        if tokens:
            resp.session_tokens.extend(
                tokens.get(i, "") for i in range(n)
            )
        return resp


@dataclass(eq=False)  # identity hash: chunks live in the handler's
class _StreamChunk:     # unsettled set until their verdicts are yielded
    """One VerifyProofStream chunk moving through the pipeline."""

    ids: list[int]
    size: int
    mint: bool
    chunk_error: str | None = None
    messages: list[str] = field(default_factory=list)
    user_ids: list[str] = field(default_factory=list)
    challenge_ids: list = field(default_factory=list)
    proof_wires: list = field(default_factory=list)
    staged: list[int] = field(default_factory=list)
    shed: dict[int, int] = field(default_factory=dict)        # i -> retry ms
    users: dict[int, UserData] = field(default_factory=dict)
    results: list = field(default_factory=list)  # i -> verdict | _UNSET
    task: asyncio.Task | None = None
    #: native wire view's contiguous proof buffer (None on the protobuf
    #: path or when any proof has a non-canonical size)
    packed: bytes | None = None


def _proof_args_error(challenge_id: bytes, proof: bytes, index: int | None = None) -> str | None:
    sfx = "" if index is None else f" for proof {index}"
    if not challenge_id:
        return f"Empty challenge ID{sfx}"
    if len(challenge_id) > MAX_CHALLENGE_ID:
        return f"Challenge ID too long{sfx}"
    if not proof:
        return f"Empty proof{sfx}" if index is None else f"Empty proof {index}"
    if len(proof) > MAX_PROOF_WIRE:
        return f"Proof too large{sfx}" if index is None else f"Proof {index} too large"
    return None


def request_deserializers(pb2, wire: str = "native") -> dict:
    """{rpc name: request deserializer} for all six RPCs.  With
    ``wire="native"`` the three hot messages (``CreateChallenge``,
    ``VerifyProofBatch``, ``VerifyProofStream`` chunks) go through the
    native wire parser first (``server/wire.py``), which hands anything
    outside its recognized subset to the protobuf runtime; with
    ``wire="python"`` every message takes ``FromString``."""
    types = method_types(pb2)
    stream_types = stream_method_types(pb2)
    out = {name: req.FromString for name, (req, _resp) in types.items()}
    out["VerifyProofStream"] = stream_types["VerifyProofStream"][0].FromString
    if wire == "native":
        for name in ("CreateChallenge", "VerifyProofBatch",
                     "VerifyProofStream"):
            req_cls = (stream_types if name == "VerifyProofStream"
                       else types)[name][0]
            deser = wire_mod.make_deserializer(name, req_cls)
            if deser is not None:
                out[name] = deser
    return out


def make_generic_handler(service: AuthServiceImpl) -> grpc.GenericRpcHandler:
    """Register the six RPCs without generated *_pb2_grpc stubs."""
    pb2 = service.pb2
    types = method_types(pb2)
    desers = request_deserializers(pb2, service.wire)
    impl = {
        "Register": service.register,
        "RegisterBatch": service.register_batch,
        "CreateChallenge": service.create_challenge,
        "VerifyProof": service.verify_proof,
        "VerifyProofBatch": service.verify_proof_batch,
    }
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            impl[name],
            request_deserializer=desers[name],
            response_serializer=types[name][1].SerializeToString,
        )
        for name in impl
    }
    stream_types = stream_method_types(pb2)
    handlers["VerifyProofStream"] = grpc.stream_stream_rpc_method_handler(
        service.verify_proof_stream,
        request_deserializer=desers["VerifyProofStream"],
        response_serializer=stream_types["VerifyProofStream"][1].SerializeToString,
    )
    return grpc.method_handlers_generic_handler(SERVICE_NAME, handlers)


async def serve(
    state: ServerState,
    rate_limiter: RateLimiter,
    host: str = "127.0.0.1",
    port: int = 50051,
    backend: VerifierBackend | None = None,
    batcher=None,
    tls: tuple[bytes, bytes] | None = None,
    admission=None,
    replica=None,
    audit_log=None,
    stream_window: int = 8192,
    stream_entry_deadline_ms: float = 0.0,
    fleet=None,
    wire: str = "native",
    listen: bool = True,
):
    """Build and start an aio server; returns (server, bound_port).

    ``tls`` is an optional (private_key_pem, cert_chain_pem) pair.
    ``batcher`` is an optional started-here
    :class:`~cpzk_tpu_torch.server.batching.DynamicBatcher` routing
    verification through the card (``build_backend`` makes it); it is
    exposed as ``server.batcher`` so the caller can drain it on shutdown.
    ``backend`` is the inline path's verifier backend (no batcher): pass
    one, since ``None`` means ``TorchBackend()`` on the card.
    ``admission``, ``replica``, ``audit_log`` and ``fleet`` are the
    reference's host control plane seams (admission control, a replication
    standby, the proof log, partition ownership); the daemon passes the
    first and the third, and ``None`` for the two whose packages the port
    does not have yet.  ``stream_window`` /
    ``stream_entry_deadline_ms`` are the VerifyProofStream flow-control
    knobs (``[tpu]`` config).  ``wire`` selects the transport parse path
    ("native" = the C++ wire scanner, with the protobuf runtime for
    anything it does not recognize; "python" = protobuf runtime only; see
    ``server/wire.py``).  ``listen=False`` starts the server portless
    (``bound_port`` None) for the sharded-ingest mode, where SO_REUSEPORT
    listener processes own the public address and feed the handlers over
    the :class:`~cpzk_tpu_torch.server.ingest.IngestSupervisor` seam.
    """
    server = grpc.aio.server()
    service = AuthServiceImpl(
        state, rate_limiter, backend=backend, batcher=batcher,
        admission=admission, replica=replica, audit_log=audit_log,
        stream_window=stream_window,
        stream_entry_deadline_ms=stream_entry_deadline_ms,
        fleet=fleet, wire=wire,
    )
    server.add_generic_rpc_handlers((make_generic_handler(service),))
    if replica is not None:
        server.add_generic_rpc_handlers((replica.handler(),))
    health = _add_health_service(server, backend=backend)
    if replica is not None:
        health.standby = replica.role != "primary"
        replica.health = health  # promotion flips readiness to SERVING
    server.health = health  # for shutdown: server.health.serving = False
    server.auth_service = service  # ops plane: /statusz stream rows
    server.batcher = batcher
    server.admission = admission
    server.replica = replica
    server.audit_log = audit_log  # daemon closes it after the batcher drains
    server.fleet = fleet  # ops plane: /partitionmap + /statusz fleet block
    if batcher is not None:
        batcher.start()
    if not listen:
        # sharded-ingest mode: the handlers are reachable only through
        # the ingest supervisor's framed unix-socket seam
        await server.start()
        return server, None
    addr = f"{host}:{port}"
    if tls is not None:
        creds = grpc.ssl_server_credentials([tls])
        bound = server.add_secure_port(addr, creds)
    else:
        bound = server.add_insecure_port(addr)
    await server.start()
    return server, bound


#: ``HealthCheckRequest.service`` values that select the READINESS view
#: (the auth service name also works, for LB configs that probe it).
READINESS_SERVICE = "readiness"


class HealthService:
    """Standard gRPC health protocol, hand-wired (tonic-health twin,
    bin/server.rs:208-211), split into liveness and readiness views:

    - ``service=""`` — **liveness**: SERVING while the process is up and
      not draining (``serving = False`` flips it at graceful shutdown,
      bin/server.rs:420-422).  An open failover breaker does NOT flip
      liveness — the CPU fallback still answers correctly.
    - ``service="readiness"`` (or the auth service name) — **readiness**:
      additionally NOT_SERVING while WAL recovery/replay is still running
      (``recovering``), while the failover breaker holds the backend
      degraded, and while the node is an unpromoted replication standby
      (``standby`` — lease-based promotion flips it to SERVING), so load
      balancers stop routing to a replica that would only shed or answer
      at fallback speed, without restart-looping it.
    """

    def __init__(self, backend=None):
        from .proto import load_health_pb2

        self.pb2 = load_health_pb2()
        self.serving = True
        #: True while boot-time WAL recovery/replay runs (set by whoever
        #: drives recovery with the listener already up; the stock daemon
        #: recovers before binding, where "not ready" is simply
        #: connection-refused).
        self.recovering = False
        #: True while this node is an unpromoted replication standby —
        #: liveness stays SERVING (the process is healthy), readiness is
        #: NOT_SERVING until lease expiry or /promote flips the role.
        self.standby = False
        self.backend = backend  # FailoverBackend | None

    def _ready(self) -> bool:
        if not self.serving or self.recovering or self.standby:
            return False
        backend = self.backend
        return not (backend is not None and getattr(backend, "degraded", False))

    async def check(self, request, context):
        del context
        st = self.pb2.HealthCheckResponse.ServingStatus
        service = getattr(request, "service", "") or ""
        if service in (READINESS_SERVICE, SERVICE_NAME):
            ok = self._ready()
        else:
            ok = self.serving
        return self.pb2.HealthCheckResponse(
            status=st.SERVING if ok else st.NOT_SERVING
        )

    def handler(self) -> grpc.GenericRpcHandler:
        return grpc.method_handlers_generic_handler(
            "grpc.health.v1.Health",
            {
                "Check": grpc.unary_unary_rpc_method_handler(
                    self.check,
                    request_deserializer=self.pb2.HealthCheckRequest.FromString,
                    response_serializer=self.pb2.HealthCheckResponse.SerializeToString,
                )
            },
        )


def _add_health_service(server, backend=None) -> "HealthService":
    health = HealthService(backend=backend)
    server.add_generic_rpc_handlers((health.handler(),))
    return health
