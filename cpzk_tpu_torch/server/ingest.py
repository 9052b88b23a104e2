"""SO_REUSEPORT sharded ingest: N listener processes, one dispatch process.

A port of ``cpzk_tpu/server/ingest.py``.  The in-process listener pays the
whole gRPC/HTTP/2 + parse + serialize tax on the dispatch process's single
event loop; past one busy core that loop is the serving ceiling.  With
``[server] ingest_shards = N`` (N > 1) the daemon instead spawns N
**ingest shard** processes.  Each shard binds the public listener itself —
gRPC's ``SO_REUSEPORT`` (on by default on Linux) lets every shard bind the
same ``host:port`` and the kernel spreads incoming connections across them
— and runs the transport work: HTTP/2, request reads, the **native wire
parse** (the same ``server/wire.py`` parser on the host core the
in-process path uses), and response writes.  Parsed requests travel to the
single dispatch/state process over a unix-domain socket speaking the
``length u32 | crc32 u32 | payload`` frame header
(:mod:`cpzk_tpu_torch.durability.wal`), where the REAL ``AuthServiceImpl``
handlers run against the one batcher, state store and card.

Division of labor: the shards own sockets and parse; admission, priority
shedding and rate limiting stay in the dispatch process, where the
batcher's queue signals live and where the keyed buckets see every client
exactly once no matter which shard its connections hashed to (a shard
forwards each call's metadata and peer, so ``client_key`` sees the
client, never the shard's socket).  A request answers with identical
verdicts, trailers and metrics whether it entered in-process or through
any shard.

A shard never touches the card: it is spawned (never forked from a
process that holds a CUDA context and the dispatch threads) and its import
path — this module, ``server/wire.py``, the host core, grpc — imports no
torch.  The dispatch process loads the host core before it spawns the
shards, so N shards never race to build the same library.

Failure model: a shard is stateless — SIGKILL one and its open
connections reset (clients retry per their policy), the daemon keeps
serving through the remaining shards, and the supervisor respawns the
dead shard with exponential full-jitter backoff
(``ingest.shard.respawns``).  A shard that keeps dying trips the
crash-loop guard — N deaths in M seconds and the supervisor abandons it
(``ingest.shard.crashloop``, ``crashloop`` marker in /statusz) instead
of spinning forever on a doomed binary.  The dispatch process dying
takes the service down.

``ingest_shards = 1`` never imports any of this: the daemon binds
in-process.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import pickle
import random
import tempfile
import time

from ..durability.wal import (
    HEADER_BYTES,
    frame_crc_ok,
    frame_payload,
    unpack_frame_header,
)
from . import metrics

log = logging.getLogger("cpzk_tpu_torch.server.ingest")

#: Frame payload cap: the largest legal gRPC request (4 MiB default
#: receive limit) plus pickle overhead, with headroom.  A garbage
#: length field must not make either side allocate gigabytes.
MAX_INGEST_FRAME = 64 << 20

#: Outstanding chunks a shard may forward per stream before waiting for
#: dispatch-side credits — keeps the parent-side queue bounded so gRPC's
#: own flow control (shard stops reading) pushes back on the sender.
STREAM_CREDITS = 8

#: RPCs the shards proxy (full method path -> unary/stream kind).
AUTH_SERVICE = "auth.AuthService"
HEALTH_SERVICE = "grpc.health.v1.Health"
UNARY_METHODS = (
    "Register", "RegisterBatch", "CreateChallenge",
    "VerifyProof", "VerifyProofBatch",
)
STREAM_METHOD = "VerifyProofStream"

#: Native-parse message kinds a shard ships pre-parsed ("v" payloads).
_WIRE_KINDS = {"CreateChallenge": 1, "VerifyProofBatch": 2,
               "VerifyProofStream": 3}


def pack_frame(payload: bytes) -> bytes:
    """One CRC-framed message, via the shared
    :func:`~cpzk_tpu_torch.durability.wal.frame_payload` helper."""
    if len(payload) > MAX_INGEST_FRAME:
        raise ValueError(f"ingest frame exceeds {MAX_INGEST_FRAME} bytes")
    return frame_payload(payload)


async def read_frame(reader: asyncio.StreamReader) -> bytes | None:
    """Next frame payload, or None on clean EOF.  Raises ValueError on a
    corrupt header/CRC — the connection is then torn down (both sides
    treat the stream as append-only and unrecoverable past corruption,
    like a torn WAL tail)."""
    try:
        head = await reader.readexactly(HEADER_BYTES)
    except asyncio.IncompleteReadError:
        return None
    length, crc = unpack_frame_header(head)
    if length == 0 or length > MAX_INGEST_FRAME:
        raise ValueError(f"ingest frame length {length} out of bounds")
    payload = await reader.readexactly(length)
    if not frame_crc_ok(payload, crc):
        raise ValueError("ingest frame CRC mismatch")
    return payload


class _FrameWriter:
    """Serialized frame writes over one StreamWriter (many dispatcher
    tasks answer concurrently; interleaved partial writes would corrupt
    the framing)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self._writer = writer
        self._lock = asyncio.Lock()

    async def send(self, msg: tuple) -> None:
        frame = pack_frame(pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL))
        async with self._lock:
            self._writer.write(frame)
            await self._writer.drain()

    def close(self) -> None:
        with contextlib.suppress(Exception):
            self._writer.close()


# ---------------------------------------------------------------------------
# dispatch-process side
# ---------------------------------------------------------------------------


class ShardAbort(Exception):
    """A handler called context.abort() on a shard-forwarded RPC."""

    def __init__(self, code, details: str, trailers):
        super().__init__(details)
        self.code = code
        self.details = details
        self.trailers = tuple(trailers or ())


class ShardContext:
    """The gRPC server-context surface the real handlers touch, backed by
    facts the shard forwarded (metadata, peer, deadline).  Hand-rolled
    contexts are an established pattern in this service (every abort site
    tolerates them); this one additionally raises :class:`ShardAbort` so
    the dispatcher can relay (code, details, trailers) byte-identically
    to what the in-process listener would have sent."""

    def __init__(self, metadata, peer: str, remaining_s: float | None):
        self._metadata = tuple(metadata or ())
        self._peer = peer
        self._deadline = (
            time.monotonic() + remaining_s if remaining_s is not None else None
        )
        self.trailers: tuple = ()
        self.aborted: ShardAbort | None = None

    def invocation_metadata(self):
        return self._metadata

    def peer(self) -> str:
        return self._peer

    def time_remaining(self):
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def set_trailing_metadata(self, md) -> None:
        self.trailers = tuple(md or ())

    async def abort(self, code, details: str = "", trailing_metadata=()):
        exc = ShardAbort(code, details, trailing_metadata or self.trailers)
        self.aborted = exc
        raise exc


class IngestSupervisor:
    """Dispatch-process owner of the shard fleet: spawns the N listener
    processes, serves the framed unix socket they feed, dispatches into
    the real service handlers, and respawns dead shards."""

    def __init__(
        self,
        service,                  # AuthServiceImpl (the real handlers)
        health,                   # HealthService
        shards: int,
        host: str,
        port: int,
        wire: str = "native",
        tls: tuple[bytes, bytes] | None = None,
        uds_dir: str | None = None,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        crashloop_deaths: int = 5,
        crashloop_window_s: float = 60.0,
    ):
        from .proto import load_pb2, method_types, stream_method_types
        from .service import request_deserializers

        self.service = service
        self.health = health
        self.shards = shards
        self.host = host
        self.port = port
        self.wire = wire
        self.tls = tls
        self._uds_dir = uds_dir or tempfile.mkdtemp(prefix="cpzk-ingest-")
        os.chmod(self._uds_dir, 0o700)  # the socket carries pickled frames
        self.uds_path = os.path.join(self._uds_dir, "dispatch.sock")
        self._server: asyncio.AbstractServer | None = None
        # index -> multiprocessing Process (spawn context; typed loosely —
        # the spawn context's Process class is resolved at runtime)
        self._procs: dict = {}
        self._monitor: asyncio.Task | None = None
        self._stopping = False
        self.respawns = 0
        # crash-loop guard: dead shards respawn with exponential full-jitter
        # backoff, and crashloop_deaths deaths inside crashloop_window_s
        # stop the respawning entirely — a bad shard binary (bad port, bad
        # TLS material, instant-exit bug) must not spin the supervisor
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.crashloop_deaths = crashloop_deaths
        self.crashloop_window_s = crashloop_window_s
        self._death_times: dict[int, list[float]] = {}
        self._respawn_at: dict[int, float] = {}
        self._backoff_rng = random.Random()  # injectable for deterministic tests
        #: per-shard counters behind /statusz (index -> row dict);
        #: ``boot_s`` is spawn to the shard's hello on the seam (its
        #: imports done; it binds the listener next), None until then
        self.shard_stats: dict[int, dict] = {
            i: {"shard": i, "pid": None, "connected": False, "rpcs": 0,
                "streams": 0, "parses": 0, "fallbacks": 0, "errors": 0,
                "respawns": 0, "crashloop": False, "boot_s": None}
            for i in range(shards)
        }
        self._spawned_at: dict[int, float] = {}

        pb2 = service.pb2
        desers = request_deserializers(pb2, wire)
        types = method_types(pb2)
        stream_types = stream_method_types(pb2)
        self._unary = {}
        impl = {
            "Register": service.register,
            "RegisterBatch": service.register_batch,
            "CreateChallenge": service.create_challenge,
            "VerifyProof": service.verify_proof,
            "VerifyProofBatch": service.verify_proof_batch,
        }
        for name in UNARY_METHODS:
            self._unary[f"/{AUTH_SERVICE}/{name}"] = (
                desers[name], impl[name],
                types[name][1].SerializeToString,
            )
        self._unary[f"/{HEALTH_SERVICE}/Check"] = (
            health.pb2.HealthCheckRequest.FromString, health.check,
            health.pb2.HealthCheckResponse.SerializeToString,
        )
        self._stream_path = f"/{AUTH_SERVICE}/{STREAM_METHOD}"
        self._stream_deser = desers[STREAM_METHOD]
        self._stream_ser = (
            stream_types[STREAM_METHOD][1].SerializeToString
        )
        load_pb2()  # shards ship raw bytes for punted messages
        if wire == "native":
            # build (or find) and load the host core here, once, before
            # any shard is spawned: N shards must not race to build it
            from ..core import _native

            _native.load()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        self._server = await asyncio.start_unix_server(
            self._handle_shard, path=self.uds_path
        )
        os.chmod(self.uds_path, 0o700)
        for i in range(self.shards):
            self._spawn(i)
        self._monitor = asyncio.get_running_loop().create_task(
            self._monitor_loop()
        )
        metrics.gauge("ingest.shards").set(self.shards)
        log.info(
            "sharded ingest: %d listener processes on %s:%d (SO_REUSEPORT), "
            "dispatch seam at %s", self.shards, self.host, self.port,
            self.uds_path,
        )

    def _spawn(self, index: int) -> None:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        proc = ctx.Process(
            target=run_shard,
            args=(index, self.uds_path, {
                "host": self.host,
                "port": self.port,
                "wire": self.wire,
                "tls": self.tls,
            }),
            name=f"cpzk-ingest-{index}",
            daemon=True,
        )
        self._spawned_at[index] = time.monotonic()
        proc.start()
        self._procs[index] = proc
        self.shard_stats[index]["pid"] = proc.pid

    async def _monitor_loop(self) -> None:
        """Respawn dead shards (SIGKILL, OOM, crash) with exponential
        full-jitter backoff; one shard dying only resets its own
        connections, and a shard that keeps dying (``crashloop_deaths``
        deaths inside ``crashloop_window_s``) is abandoned — marked
        ``crashloop`` in /statusz, counted once, never respawned again —
        so the daemon keeps serving on the healthy shards instead of
        burning the supervisor on a doomed binary."""
        while not self._stopping:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            for index, proc in list(self._procs.items()):
                if self._stopping or proc.is_alive():
                    continue
                code = proc.exitcode
                await asyncio.to_thread(proc.join, 1.0)
                del self._procs[index]
                self.shard_stats[index]["connected"] = False
                self._on_shard_death(index, proc.pid, code, now)
            for index, due in list(self._respawn_at.items()):
                if self._stopping or now < due:
                    continue
                del self._respawn_at[index]
                self.respawns += 1
                self.shard_stats[index]["respawns"] += 1
                metrics.counter("ingest.shard.respawns").inc()
                self._spawn(index)

    def _on_shard_death(self, index: int, pid, code, now: float) -> None:
        """One shard death: record it, then either give up (crash-loop)
        or schedule a jittered respawn."""
        deaths = self._death_times.setdefault(index, [])
        deaths.append(now)
        cutoff = now - self.crashloop_window_s
        while deaths and deaths[0] < cutoff:
            deaths.pop(0)
        if len(deaths) >= self.crashloop_deaths:
            self.shard_stats[index]["crashloop"] = True
            metrics.counter("ingest.shard.crashloop").inc()
            log.warning(
                "ingest shard %d (pid %s) crash-looping: %d deaths in "
                "%.0fs (last exit code %s) — giving up on this shard; "
                "the daemon keeps serving on the remaining %d",
                index, pid, len(deaths), self.crashloop_window_s, code,
                sum(1 for p in self._procs.values() if p.is_alive()),
            )
            return
        ceiling = min(
            self.backoff_max_s,
            self.backoff_base_s * (2 ** (len(deaths) - 1)),
        )
        delay = self._backoff_rng.uniform(0.0, ceiling)  # full jitter
        self._respawn_at[index] = now + delay
        log.warning(
            "ingest shard %d (pid %s) died with exit code %s; respawn "
            "in %.2fs (death %d/%d in the last %.0fs)",
            index, pid, code, delay, len(deaths),
            self.crashloop_deaths, self.crashloop_window_s,
        )

    async def stop(self) -> None:
        self._stopping = True
        if self._monitor is not None:
            self._monitor.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._monitor
        for proc in self._procs.values():
            with contextlib.suppress(Exception):
                proc.terminate()
        for proc in self._procs.values():
            with contextlib.suppress(Exception):
                await asyncio.to_thread(proc.join, 5.0)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        with contextlib.suppress(OSError):
            os.unlink(self.uds_path)
        with contextlib.suppress(OSError):
            os.rmdir(self._uds_dir)

    def status(self) -> dict:
        """The ``ingest`` block of /statusz."""
        return {
            "shards": self.shards,
            "respawns": self.respawns,
            "crashloop_shards": sum(
                1 for i in range(self.shards)
                if self.shard_stats[i].get("crashloop")
            ),
            "per_shard": [
                dict(self.shard_stats[i]) for i in range(self.shards)
            ],
        }

    # -- shard connection handling ------------------------------------------

    async def _handle_shard(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> None:
        out = _FrameWriter(writer)
        stats = None
        tasks: dict[tuple[str, int], asyncio.Task] = {}
        streams: dict[int, _DispatchStream] = {}
        try:
            while True:
                payload = await read_frame(reader)
                if payload is None:
                    return
                msg = pickle.loads(payload)
                kind = msg[0]
                if kind == "hello":
                    index = int(msg[1])
                    stats = self.shard_stats.setdefault(
                        index, {"shard": index, "respawns": 0})
                    stats.update(pid=msg[2], connected=True, rpcs=0,
                                 streams=0, parses=0, fallbacks=0, errors=0)
                    spawned = self._spawned_at.get(index)
                    if spawned is not None:
                        stats["boot_s"] = time.monotonic() - spawned
                    metrics.gauge("ingest.shard.connected").set(
                        sum(1 for s in self.shard_stats.values()
                            if s.get("connected"))
                    )
                    continue
                if stats is None:
                    raise ValueError("shard spoke before hello")
                if kind == "u":          # unary request
                    _, req_id, path, md, peer, remaining, body = msg
                    stats["rpcs"] += 1
                    self._note_parse(stats, path, body)
                    task = asyncio.get_running_loop().create_task(
                        self._dispatch_unary(
                            out, req_id, path, md, peer, remaining, body)
                    )
                    tasks[("u", req_id)] = task
                    task.add_done_callback(
                        lambda _t, k=("u", req_id): tasks.pop(k, None))
                elif kind == "ux":       # unary cancelled client-side
                    task = tasks.get(("u", msg[1]))
                    if task is not None:
                        task.cancel()
                elif kind == "so":       # stream open
                    _, sid, md, peer, remaining = msg
                    stats["streams"] += 1
                    st = _DispatchStream(sid, out)
                    streams[sid] = st
                    st.task = asyncio.get_running_loop().create_task(
                        self._dispatch_stream(st, md, peer, remaining)
                    )
                    st.task.add_done_callback(
                        lambda _t, s=sid: streams.pop(s, None))
                elif kind == "sc":       # stream chunk
                    _, sid, body = msg
                    st = streams.get(sid)
                    if st is not None:
                        self._note_parse(stats, self._stream_path, body)
                        st.chunks.put_nowait(body)
                elif kind == "se":       # stream half-close
                    st = streams.get(msg[1])
                    if st is not None:
                        st.chunks.put_nowait(None)
                elif kind == "sx":       # stream cancelled client-side
                    st = streams.get(msg[1])
                    if st is not None and st.task is not None:
                        st.task.cancel()
                else:
                    raise ValueError(f"unknown ingest frame kind {kind!r}")
        except (ValueError, pickle.UnpicklingError, ConnectionResetError):
            log.exception("ingest shard connection torn down")
        finally:
            if stats is not None:
                stats["connected"] = False
            for task in list(tasks.values()):
                task.cancel()
            for st in list(streams.values()):
                if st.task is not None:
                    st.task.cancel()
            out.close()

    def _note_parse(self, stats: dict, path: str, body) -> None:
        if body[0] == "v":
            stats["parses"] += 1
        else:
            stats["fallbacks"] += 1

    # -- request materialization --------------------------------------------

    def _materialize(self, path: str, body, deser):
        """Body -> request object: pre-parsed native views ("v") rebuild
        with zero re-parse; raw bytes ("b") run through the SAME
        native-first deserializer the in-process listener uses."""
        from . import wire as wire_mod

        tag, payload = body
        if tag != "v":
            return deser(payload)
        kind, fields = payload
        if kind == 1:
            return wire_mod.NativeChallengeRequest(*fields)
        if kind == 2:
            return wire_mod.NativeBatchVerificationRequest(*fields)
        return wire_mod.NativeStreamVerifyRequest(*fields)

    async def _dispatch_unary(self, out: _FrameWriter, req_id: int,
                              path: str, md, peer, remaining, body) -> None:
        entry = self._unary.get(path)
        try:
            if entry is None:
                import grpc

                await out.send(("a", req_id, grpc.StatusCode.UNIMPLEMENTED,
                                f"unknown method {path}", ()))
                return
            deser, handler, serializer = entry
            request = self._materialize(path, body, deser)
            ctx = ShardContext(md, peer, remaining)
            response = await handler(request, ctx)
            await out.send(("r", req_id, serializer(response), ctx.trailers))
        except ShardAbort as exc:
            await out.send(("a", req_id, exc.code, exc.details, exc.trailers))
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # parity with grpc: unhandled -> UNKNOWN
            import grpc

            log.exception("ingest unary dispatch failed for %s", path)
            await out.send(("a", req_id, grpc.StatusCode.UNKNOWN,
                            f"Unhandled error: {exc}", ()))

    async def _dispatch_stream(self, st: "_DispatchStream",
                               md, peer, remaining) -> None:
        ctx = ShardContext(md, peer, remaining)
        out = st.out

        async def request_iterator():
            while True:
                body = await st.chunks.get()
                if body is None:
                    return
                request = self._materialize(self._stream_path, body,
                                            self._stream_deser)
                # consumed: grant the shard one more in-flight chunk
                await out.send(("scr", st.sid, 1))
                yield request

        try:
            handler = self.service.verify_proof_stream
            async for response in handler(request_iterator(), ctx):
                await out.send(("sm", st.sid, self._stream_ser(response)))
            await out.send(("sr", st.sid, ctx.trailers))
        except ShardAbort as exc:
            await out.send(("sa", st.sid, exc.code, exc.details,
                            exc.trailers))
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            import grpc

            log.exception("ingest stream dispatch failed")
            with contextlib.suppress(Exception):
                await out.send(("sa", st.sid, grpc.StatusCode.UNKNOWN,
                                f"Unhandled error: {exc}", ()))


class _DispatchStream:
    """Parent-side state of one proxied VerifyProofStream."""

    __slots__ = ("sid", "out", "chunks", "task")

    def __init__(self, sid: int, out: _FrameWriter):
        self.sid = sid
        self.out = out
        self.chunks: asyncio.Queue = asyncio.Queue()
        self.task: asyncio.Task | None = None


# ---------------------------------------------------------------------------
# shard-process side (spawned; must stay import-light — no torch, no state)
# ---------------------------------------------------------------------------


def run_shard(index: int, uds_path: str, options: dict) -> None:
    """Entry point of one ingest shard process (multiprocessing spawn)."""
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        format=f"%(asctime)s %(levelname)s ingest-{index}: %(message)s",
    )
    try:
        asyncio.run(_shard_amain(index, uds_path, options))
    except KeyboardInterrupt:
        pass


async def _shard_amain(index: int, uds_path: str, options: dict) -> None:
    import grpc

    from . import wire as wire_mod

    reader, writer = await asyncio.open_unix_connection(uds_path)
    out = _FrameWriter(writer)
    await out.send(("hello", index, os.getpid()))

    pending: dict[int, asyncio.Future] = {}
    stream_q: dict[int, asyncio.Queue] = {}
    credits: dict[int, asyncio.Semaphore] = {}
    seq = 0

    def next_id() -> int:
        nonlocal seq
        seq += 1
        return seq

    native = options.get("wire", "native") == "native"

    def parse_body(path: str, data: bytes):
        """("v", (kind, fields)) when the native parser accepted, else
        ("b", raw) — the dispatch process then runs its own deserializer
        (the protobuf runtime, for a message the parser does not
        recognize)."""
        name = path.rsplit("/", 1)[-1]
        kind = _WIRE_KINDS.get(name)
        if not native or kind is None:
            return ("b", data)
        if kind == 1:
            view = wire_mod._parse_challenge(data)
            if view is None:
                return ("b", data)
            return ("v", (1, (view.user_id,)))
        if kind == 2:
            view = wire_mod._parse_batch_verify(data)
            if view is None:
                return ("b", data)
            return ("v", (2, (view.user_ids, view.challenge_ids,
                              view.proofs, view.proofs_packed)))
        view = wire_mod._parse_stream_chunk(data)
        if view is None:
            return ("b", data)
        return ("v", (3, (view.ids, view.user_ids, view.challenge_ids,
                          view.proofs, view.proofs_packed,
                          view.mint_sessions)))

    async def reply_loop() -> None:
        """Dispatch-process responses -> waiting handler coroutines."""
        while True:
            payload = await read_frame(reader)
            if payload is None:
                break
            msg = pickle.loads(payload)
            kind = msg[0]
            if kind in ("r", "a"):
                fut = pending.pop(msg[1], None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
            elif kind in ("sm", "sr", "sa"):
                q = stream_q.get(msg[1])
                if q is not None:
                    q.put_nowait(msg)
            elif kind == "scr":
                sem = credits.get(msg[1])
                if sem is not None:
                    sem.release()
        # dispatch process gone: fail everything in flight and exit so
        # the supervisor (or systemd) decides what happens next
        for fut in pending.values():
            if not fut.done():
                fut.set_result(("a", 0, grpc.StatusCode.UNAVAILABLE,
                                "dispatch process unavailable", ()))
        for q in stream_q.values():
            q.put_nowait(("sa", 0, grpc.StatusCode.UNAVAILABLE,
                          "dispatch process unavailable", ()))
        raise SystemExit(1)

    def _forward_meta(context):
        md = tuple(
            (k, v) for k, v in (context.invocation_metadata() or ())
        )
        try:
            remaining = context.time_remaining()
        except Exception:
            remaining = None
        return md, context.peer(), remaining

    def unary_handler(path: str):
        async def handle(request_bytes: bytes, context):
            req_id = next_id()
            fut = asyncio.get_running_loop().create_future()
            pending[req_id] = fut
            md, peer, remaining = _forward_meta(context)
            try:
                await out.send(("u", req_id, path, md, peer, remaining,
                                parse_body(path, request_bytes)))
                msg = await fut
            except asyncio.CancelledError:
                pending.pop(req_id, None)
                with contextlib.suppress(Exception):
                    await out.send(("ux", req_id))
                raise
            if msg[0] == "r":
                _, _, resp, trailers = msg
                if trailers:
                    context.set_trailing_metadata(tuple(trailers))
                return resp
            _, _, code, details, trailers = msg
            try:
                await context.abort(code, details,
                                    trailing_metadata=tuple(trailers))
            except TypeError:
                await context.abort(code, details)

        return handle

    async def stream_handler(request_iterator, context):
        sid = next_id()
        q: asyncio.Queue = asyncio.Queue()
        stream_q[sid] = q
        sem = credits[sid] = asyncio.Semaphore(STREAM_CREDITS)
        md, peer, remaining = _forward_meta(context)
        await out.send(("so", sid, md, peer, remaining))

        async def pump() -> None:
            try:
                async for request_bytes in request_iterator:
                    await sem.acquire()  # dispatch-side queue stays bounded
                    await out.send(
                        ("sc", sid, parse_body(self_path, request_bytes)))
                await out.send(("se", sid))
            except asyncio.CancelledError:
                raise
            except Exception:
                with contextlib.suppress(Exception):
                    await out.send(("sx", sid))

        self_path = f"/{AUTH_SERVICE}/{STREAM_METHOD}"
        pump_task = asyncio.get_running_loop().create_task(pump())
        try:
            while True:
                msg = await q.get()
                if msg[0] == "sm":
                    yield msg[2]
                elif msg[0] == "sr":
                    if msg[2]:
                        context.set_trailing_metadata(tuple(msg[2]))
                    return
                else:  # sa
                    _, _, code, details, trailers = msg
                    try:
                        await context.abort(
                            code, details, trailing_metadata=tuple(trailers))
                    except TypeError:
                        await context.abort(code, details)
        finally:
            pump_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await pump_task
            stream_q.pop(sid, None)
            credits.pop(sid, None)
            with contextlib.suppress(Exception):
                await out.send(("sx", sid))

    identity = bytes  # request bytes in, response bytes out, untouched
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(
            unary_handler(f"/{AUTH_SERVICE}/{name}"),
            request_deserializer=identity,
            response_serializer=identity,
        )
        for name in UNARY_METHODS
    }
    handlers[STREAM_METHOD] = grpc.stream_stream_rpc_method_handler(
        stream_handler,
        request_deserializer=identity,
        response_serializer=identity,
    )
    health_handlers = {
        "Check": grpc.unary_unary_rpc_method_handler(
            unary_handler(f"/{HEALTH_SERVICE}/Check"),
            request_deserializer=identity,
            response_serializer=identity,
        )
    }

    server = grpc.aio.server(options=(("grpc.so_reuseport", 1),))
    server.add_generic_rpc_handlers((
        grpc.method_handlers_generic_handler(AUTH_SERVICE, handlers),
        grpc.method_handlers_generic_handler(HEALTH_SERVICE, health_handlers),
    ))
    addr = f"{options['host']}:{options['port']}"
    tls = options.get("tls")
    if tls is not None:
        bound = server.add_secure_port(
            addr, grpc.ssl_server_credentials([tls]))
    else:
        bound = server.add_insecure_port(addr)
    if bound == 0:
        log.error("ingest shard %d could not bind %s", index, addr)
        raise SystemExit(2)
    await server.start()
    log.info("ingest shard %d listening on %s (pid %d)",
             index, addr, os.getpid())
    reply = asyncio.get_running_loop().create_task(reply_loop())
    try:
        await reply
    finally:
        await server.stop(grace=None)
