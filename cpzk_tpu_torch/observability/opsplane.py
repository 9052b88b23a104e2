"""Ops plane: dependency-free HTTP introspection endpoints.

A copy of ``cpzk_tpu/observability/opsplane.py`` over the port's metrics
(its own ``PROM_REGISTRY``), tracer and flight recorder.  A small asyncio
HTTP/1.1 server (stdlib only) the daemon starts **before** the gRPC
listener, serving:

- ``GET /metrics``  — text exposition rendered directly from the metrics
  facade's own registry (:func:`cpzk_tpu_torch.server.metrics.render_exposition`),
  identical family set on the prometheus and no-prometheus backings;
  ``tpu.kernel.launches{kernel}`` is refreshed at scrape time from the
  CUDA kernels' launch counts, so another process can read them, and so
  is ``tpu.device.memory_reserved_bytes``, the card memory this process's
  PyTorch allocator holds;
- ``GET /statusz``  — one JSON snapshot of the whole box: batcher depth/
  drain rate, dispatch-lane stage percentiles from the flight ring,
  per-shard registry sizes + sampled lock wait, breaker state, ingest
  shards, active streams, uptime, config fingerprint, and the admission,
  durability, audit, replication (with the primary's handover block)
  fleet and controller blocks when the daemon runs them, and one row per
  dispatch lane (breaker, depth, drain rate) when it serves through the
  lane router;
- ``GET /partitionmap`` — the fleet's partition map (404 without
  ``[fleet]``);
- ``GET /tracez``, ``GET /flightrec`` — the ring dumps as JSON, the
  EXACT payloads the REPL renders and SIGUSR2 writes (one serializer,
  one schema: ``Tracer.payload`` / ``FlightRecorder.payload``);
- ``GET /healthz``  — the readiness/liveness split as JSON (200 while
  live; ``?service=readiness`` keys the status code on readiness, for
  probes that can only read status codes);
- ``GET /slo``      — the :class:`~cpzk_tpu_torch.observability.slo.SloEngine`
  burn-rate view (ticked on demand, so it is always current).

Anything else is a JSON 404 listing the catalog.  GET only — the ops
plane is strictly read-only.  Bind it to loopback (the default) or an
internal interface; there is no auth layer.

The handler loop never blocks the event loop: every render is a
synchronous walk over in-memory rings/registries, and responses are
bounded (ring sizes cap the payloads).

Hosts without an event loop attach via :meth:`OpsPlane.start_in_thread`,
which runs the same server on a daemon-thread loop.
"""

from __future__ import annotations

import asyncio
import json
import sys
import threading
import time
import urllib.parse
from dataclasses import dataclass, field

from ..server import metrics

#: Endpoint catalog (the 404 body lists it; tests pin it).
ENDPOINTS = (
    "/metrics", "/statusz", "/tracez", "/flightrec", "/healthz", "/slo",
    "/partitionmap",
)

#: Schema tag of the ``/statusz`` payload.
STATUSZ_SCHEMA = "cpzk-statusz/1"
#: the package whose kernel modules (each with a ``LAUNCHES`` dict of its
#: kernels' launch counts) ``tpu.kernel.launches{kernel}`` exports
KERNEL_PACKAGE = "cpzk_tpu_torch.ops."

_MAX_REQUEST_BYTES = 16384
_READ_TIMEOUT_S = 10.0


@dataclass
class OpsSources:
    """Everything the ops plane can introspect — all optional, so the
    same server attaches to a full daemon, a standby, or the bulk audit
    pipeline (absent planes render as ``null`` rows, never errors)."""

    state: object | None = None        # ServerState
    batcher: object | None = None      # DynamicBatcher
    backend: object | None = None      # TorchBackend | FailoverBackend
    # the reference's host control plane: the daemon fills admission,
    # durability, audit_log, replication, fleet and controller when their
    # sections are enabled
    admission: object | None = None    # AdmissionController
    replication: object | None = None  # SegmentShipper | StandbyReplica
    audit_log: object | None = None    # ProofLogWriter
    durability: object | None = None   # DurabilityManager
    health: object | None = None       # HealthService
    service: object | None = None      # AuthServiceImpl (stream stats)
    slo: object | None = None          # SloEngine
    fleet: object | None = None        # fleet.FleetRouter
    ingest: object | None = None       # server.ingest.IngestSupervisor
    controller: object | None = None   # fleet.controller.FleetController
    config_fingerprint: str = ""
    role: str = "server"               # "server" | "standby" | "audit"
    started_at: float = field(default_factory=time.monotonic)

    # -- gauge refresh -------------------------------------------------------

    def refresh_gauges(self) -> None:
        """Update the pull-style gauges (per-shard sizes, and the CUDA
        kernels' launch counts and the card memory PyTorch's allocator
        holds when this process has loaded them; queue depth is
        push-maintained already) right before an exposition render, so a
        scrape never reads stale values."""
        state = self.state
        if state is not None and hasattr(state, "export_shard_gauges"):
            state.export_shard_gauges()
        # read from the loaded kernel modules, never imported here: the
        # ingest shards and the host-only daemon must not import torch for a
        # scrape
        for module_name, module in list(sys.modules.items()):
            launches = getattr(module, "LAUNCHES", None)
            if module_name.startswith(KERNEL_PACKAGE) and isinstance(launches, dict):
                gauge = metrics.gauge("tpu.kernel.launches", labelnames=("kernel",))
                for name, count in launches.items():
                    gauge.labels(kernel=name).set(count)
        # this process's share of the card: several daemons on one card
        # (a replication pair, a fleet) each report their own
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            metrics.gauge("tpu.device.memory_reserved_bytes").set(
                float(torch.cuda.memory_reserved()))

    # -- statusz -------------------------------------------------------------

    def statusz(self) -> dict:
        """The one-box JSON snapshot (see module docstring)."""
        from .flightrec import get_flight_recorder, stage_percentiles

        self.refresh_gauges()
        doc: dict = {
            "schema": STATUSZ_SCHEMA,
            "role": self.role,
            "uptime_s": round(time.monotonic() - self.started_at, 3),
            "config_fingerprint": self.config_fingerprint,
            "ts": time.time(),
        }

        batcher = self.batcher
        if batcher is not None:
            depth, capacity = batcher.load_snapshot()
            doc["batcher"] = {
                "queue_depth": depth,
                "queue_capacity": capacity,
                "max_batch": batcher.max_batch,
                "window_ms": batcher.window * 1000.0,
                "drain_rate_per_s": round(batcher.drain_rate(), 3),
            }
        else:
            doc["batcher"] = None

        recorder = get_flight_recorder()
        records = recorder.snapshot()
        doc["dispatch"] = {
            "recorded_batches": len(records),
            "proofs_per_s_ewma": round(recorder.proofs_per_s(), 1),
            "stage_percentiles_ms": stage_percentiles(records),
        }

        # multi-chip serving plane: one row per dispatch lane (breaker
        # state, depth, dispatches, drain rate) + the mesh lane when the
        # big-batch path is configured; null on single-lane hosts
        router = getattr(batcher, "router", None) if batcher is not None else None
        doc["lanes"] = router.status() if router is not None else None

        state = self.state
        if state is not None and hasattr(state, "shard_stats"):
            shards = state.shard_stats()
            wait_count, wait_sum = metrics.read_histogram(
                "state.shard.lock_wait"
            )
            doc["shards"] = {
                "count": len(shards),
                "users": sum(s["users"] for s in shards),
                "sessions": sum(s["sessions"] for s in shards),
                "challenges": sum(s["challenges"] for s in shards),
                "lock_wait_sampled": wait_count,
                "lock_wait_mean_ms": round(
                    (wait_sum / wait_count) * 1000.0, 4
                ) if wait_count else 0.0,
                "per_shard": shards,
            }
        else:
            doc["shards"] = None

        admission = self.admission
        if admission is not None:
            s = admission.snapshot()
            doc["admission"] = {
                "level": round(s["level"], 3),
                "admitted_tiers": s["admitted_tiers"],
                "clients": s["clients"],
                "max_clients": s["max_clients"],
                "utilization": round(s["utilization"], 4),
                "retry_after_ms": round(s["retry_after_ms"], 1),
            }
        else:
            doc["admission"] = None

        backend = self.backend
        if backend is not None and hasattr(backend, "breaker"):
            doc["breaker"] = {
                "state": backend.breaker.state.value,
                "degraded_seconds": round(
                    backend.breaker.degraded_seconds, 3
                ),
            }
        else:
            doc["breaker"] = None

        replication = self.replication
        doc["replication"] = (
            replication.status() if replication is not None else None
        )
        # coordinated-handover bookkeeping (primary side only): stage,
        # fence watermark, standby applied-seq, last duration + counters
        doc["handover"] = (
            replication.handover_status()
            if replication is not None
            and hasattr(replication, "handover_status")
            else None
        )

        audit_log = self.audit_log
        doc["audit"] = audit_log.status() if audit_log is not None else None

        # fleet partition rollup: this box's slot in the partition map,
        # its owned keyspace share, and the wrong-partition redirects it
        # has answered (map version/digest spot drift across the fleet)
        fleet = self.fleet
        doc["fleet"] = fleet.status() if fleet is not None else None

        # fleet controller: mode (dry-run vs live), cooldowns in flight,
        # administratively drained lanes, and the last-N decision ring —
        # the primary "what did the controller just do and why" surface
        controller = self.controller
        doc["controller"] = (
            controller.status() if controller is not None else None
        )

        # sharded ingest: one row per SO_REUSEPORT listener process
        # (pid, connected, rpcs/streams handled, native parses vs
        # protobuf fallbacks, respawns); null on in-process listeners
        ingest = self.ingest
        doc["ingest"] = ingest.status() if ingest is not None else None

        durability = self.durability
        if durability is not None and getattr(durability, "wal", None) is not None:
            doc["durability"] = durability.status()
        else:
            doc["durability"] = None

        service = self.service
        doc["streams"] = (
            service.stream_stats()
            if service is not None and hasattr(service, "stream_stats")
            else None
        )

        health = self.health
        if health is not None:
            doc["health"] = {
                "live": bool(health.serving),
                "ready": bool(health._ready()),
            }
        else:
            doc["health"] = None
        return doc

    def healthz(self) -> dict:
        """The readiness/liveness split as one JSON object."""
        health = self.health
        if health is None:
            # an attached-without-health host (audit pipeline): the
            # process answering IS the liveness signal
            return {"live": True, "ready": True, "detail": "no health gate"}
        return {
            "live": bool(health.serving),
            "ready": bool(health._ready()),
            "recovering": bool(getattr(health, "recovering", False)),
            "standby": bool(getattr(health, "standby", False)),
        }


class OpsPlane:
    """The HTTP introspection server (see module docstring)."""

    def __init__(self, sources: OpsSources, host: str = "127.0.0.1",
                 port: int = 9092):
        self.sources = sources
        self.host = host
        self.port = port
        self.bound_port: int | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._thread_loop: asyncio.AbstractEventLoop | None = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> int:
        """Bind and serve; returns the bound port (the configured one, or
        the OS pick when ``port`` is 0 — tests bind ephemeral)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.bound_port = self._server.sockets[0].getsockname()[1]
        return self.bound_port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def start_in_thread(self) -> int:
        """Run the same server on a daemon-thread event loop — the
        attachment point for synchronous hosts (the bulk audit pipeline).
        Returns the bound port; the thread dies with the process."""
        ready = threading.Event()
        box: dict = {}

        def run() -> None:
            loop = asyncio.new_event_loop()
            self._thread_loop = loop
            try:
                box["port"] = loop.run_until_complete(self.start())
            except OSError as e:  # bind failure surfaces to the caller
                box["error"] = e
                ready.set()
                return
            ready.set()
            loop.run_forever()

        self._thread = threading.Thread(
            target=run, name="cpzk-opsplane", daemon=True
        )
        self._thread.start()
        ready.wait(timeout=10.0)
        if "error" in box:
            raise box["error"]
        return box["port"]

    def stop_thread(self) -> None:
        """Stop a :meth:`start_in_thread` server (idempotent)."""
        loop = self._thread_loop
        if loop is None:
            return

        def shutdown() -> None:
            task = loop.create_task(self.stop())
            task.add_done_callback(lambda _t: loop.stop())

        loop.call_soon_threadsafe(shutdown)
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._thread = None
        self._thread_loop = None

    # -- request handling ----------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                request = await asyncio.wait_for(
                    reader.readuntil(b"\r\n\r\n"), timeout=_READ_TIMEOUT_S
                )
            except asyncio.LimitOverrunError:
                await self._respond(writer, 431, "text/plain",
                                    b"request too large\n")
                return
            except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                return
            if len(request) > _MAX_REQUEST_BYTES:
                await self._respond(writer, 431, "text/plain",
                                    b"request too large\n")
                return
            line = request.split(b"\r\n", 1)[0].decode("latin-1")
            parts = line.split()
            if len(parts) != 3:
                await self._respond(writer, 400, "text/plain",
                                    b"malformed request line\n")
                return
            method, target, _version = parts
            if method != "GET":
                await self._respond(
                    writer, 405, "application/json",
                    _json({"error": "method not allowed", "allow": "GET"}),
                )
                return
            status, ctype, body = self._route(target)
            await self._respond(writer, status, ctype, body)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    async def _respond(self, writer: asyncio.StreamWriter, status: int,
                       ctype: str, body: bytes) -> None:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  405: "Method Not Allowed", 431: "Request Too Large",
                  503: "Service Unavailable"}.get(status, "OK")
        head = (
            f"HTTP/1.1 {status} {reason}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            "Connection: close\r\n"
            "\r\n"
        ).encode("latin-1")
        writer.write(head + body)
        await writer.drain()

    # -- routing (every render is synchronous, in-memory, bounded) -----------

    def _route(self, target: str) -> tuple[int, str, bytes]:
        parsed = urllib.parse.urlsplit(target)
        path = parsed.path.rstrip("/") or "/"
        query = urllib.parse.parse_qs(parsed.query)
        if path == "/metrics":
            self.sources.refresh_gauges()
            return (200, "text/plain; version=0.0.4; charset=utf-8",
                    metrics.render_exposition().encode())
        if path == "/statusz":
            return 200, "application/json", _json(self.sources.statusz())
        if path == "/tracez":
            from .tracing import get_tracer

            return (200, "application/json",
                    _json(get_tracer().payload(_limit(query))))
        if path == "/flightrec":
            from .flightrec import get_flight_recorder

            return (200, "application/json",
                    _json(get_flight_recorder().payload(_limit(query))))
        if path == "/healthz":
            doc = self.sources.healthz()
            want_ready = query.get("service", [""])[0] == "readiness"
            ok = doc.get("ready", False) if want_ready else doc.get("live", False)
            return (200 if ok else 503), "application/json", _json(doc)
        if path == "/slo":
            engine = self.sources.slo
            if engine is None:
                return (404, "application/json",
                        _json({"error": "no SLO engine attached"}))
            engine.tick()
            return 200, "application/json", _json(engine.snapshot())
        if path == "/partitionmap":
            fleet = self.sources.fleet
            if fleet is None:
                return (404, "application/json",
                        _json({"error": "no partition map attached "
                                        "([fleet] is disabled)"}))
            # the canonical serialized map, digest included — exactly
            # what PartitionMap.from_doc validates, so a client's
            # map_refresh can point straight at this endpoint
            return 200, "application/json", _json(fleet.map.to_doc())
        return (404, "application/json", _json({
            "error": f"unknown path {path!r}",
            "endpoints": list(ENDPOINTS),
        }))


def _limit(query: dict) -> int | None:
    """``?n=`` ring-dump limit (None = whole ring; garbage = None)."""
    raw = query.get("n", [None])[0]
    if raw is None:
        return None
    try:
        return max(1, int(raw))
    except ValueError:
        return None


def _json(obj: dict) -> bytes:
    return (json.dumps(obj, indent=2, sort_keys=True) + "\n").encode()
