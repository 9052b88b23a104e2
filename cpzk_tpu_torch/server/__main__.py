"""Server daemon + admin REPL: the port of ``cpzk_tpu/server/__main__.py``.

Flags (env-overridable through ``ServerConfig``), config load +
validation, crash recovery (``[durability]``: snapshot + write-ahead log
replay before anything listens), the background cleanup task under a
restart-on-crash supervisor, optional Prometheus exporter, admission
control (``[admission]``, on by default as in the reference), the ops
plane and SLO engine, the proof-log audit trail (``[audit]``: one record
per verdict served, for ``python -m cpzk_tpu_torch.audit run``), WAL
replication to a warm standby (``[replication]``: a primary ships its
log and sealed proof-log segments, a standby applies them, refuses auth
RPCs and promotes on lease expiry), partition ownership
(``[fleet]``: wrong-partition RPCs redirect to the owner named by the
map), gRPC health, an admin REPL (/status /overload /tracez /flightrec
/profile /persist /audit /replication /promote /handover /fleet /users
/sessions /challenges /cleanup /reset /help /quit), and graceful
shutdown: on SIGTERM a replication primary with ``handover_on_term``
first hands its partition over to the standby, then health flips to
NOT_SERVING, a 2 s drain, the ingest shards and the batcher stop, the
listener stops, the proof log closes (every acknowledged verdict in it),
the shipper's final flush ships its last sealed segment, background
tasks are awaited, and the final snapshot lands (with durability: the
covered write-ahead log is truncated).

With ``[tpu] backend = "tpu"`` (this package's default) the daemon serves
the card bare: ``plane.build_backend`` builds the CUDA kernels and
prewarms them before the listener binds, and a kernel or CUDA fault fails
its batch; there is no host failover.  Without CUDA it stops at boot.
``backend = "cpu"`` (or ``--backend cpu``) verifies inline on the host.
A replication standby builds and prewarms the card's backend at boot as
a primary does, so its promotion pays no kernel load.  With ``[audit]
enabled`` its promotion moves the proof log's numbering past the segments
the primary shipped, so its own verdicts continue that trail.

``[tpu] lanes`` over several cards serves through the lane router
(one lane per card), and ``[controller] enabled`` boots the fleet
controller's ticker (dry-run by default), behind ``/controller`` on the
REPL and the controller block of ``/statusz``.

Run: ``python -m cpzk_tpu_torch.server --host 127.0.0.1 --port 50051``
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import logging
import os
import signal
import sys
import time

from . import metrics
from ..errors import UnsupportedFormat
from .config import ServerConfig
from .state import ServerState

# sweep/checkpoint cadence; CPZK_CLEANUP_INTERVAL_S shortens it so a
# bounded-duration run still observes checkpoints and sweeps
CLEANUP_INTERVAL_SECONDS = float(os.environ.get("CPZK_CLEANUP_INTERVAL_S", 60))
SUPERVISOR_BACKOFF_SECONDS = 5
DRAIN_SECONDS = 2

#: config sections of the reference's host control plane that the port
#: does not have: none, every section boots
UNPORTED_SECTIONS = ()

log = logging.getLogger("cpzk_tpu_torch.server")


def _c(color: str, text: str) -> str:
    codes = {"green": "32", "red": "31", "yellow": "33", "cyan": "36", "white": "37"}
    if not sys.stdout.isatty():
        return text
    return f"\x1b[{codes[color]}m{text}\x1b[0m"


def parse_args(argv=None) -> argparse.Namespace:
    """CLI flags are the TOP config layer: every flag defaults to None and
    only overrides the resolved config when explicitly provided — env vars
    (SERVER_HOST, SERVER_RATE_LIMIT_REQUESTS_PER_MINUTE, ...) and .env are
    handled by ``ServerConfig.from_env`` so precedence stays
    defaults < TOML < .env < env < CLI."""
    p = argparse.ArgumentParser(prog="cpzk-server", description="Chaum-Pedersen auth server")
    p.add_argument("-H", "--host", default=None)
    p.add_argument("-p", "--port", type=int, default=None)
    p.add_argument("--metrics", action="store_true", default=None,
                   help="enable the Prometheus exporter")
    p.add_argument("--metrics-port", type=int, default=None)
    p.add_argument("--rate-limit", type=int, default=None,
                   help="requests per minute")
    p.add_argument("--rate-burst", type=int, default=None)
    p.add_argument("--backend", choices=("cpu", "tpu"), default=None,
                   help="verifier backend: tpu (the default: the card's CUDA "
                        "kernels behind dynamic batching) or cpu (inline "
                        "host verify)")
    p.add_argument("--batch-max", type=int, default=None,
                   help="dynamic-batcher device batch target (tpu backend)")
    p.add_argument("--batch-window-ms", type=float, default=None,
                   help="dynamic-batcher queue deadline in ms (tpu backend)")
    p.add_argument("--no-repl", action="store_true", help="run headless (no admin REPL)")
    p.add_argument("--state-file", default=None,
                   help="opt-in checkpoint/resume: restore users+sessions "
                        "from this JSON snapshot at boot (when it exists) "
                        "and write it on graceful shutdown and every "
                        "cleanup sweep. Default: in-memory only")
    return p.parse_args(argv)


async def cleanup_supervisor(
    state: ServerState,
    stop: asyncio.Event,
    state_file: str | None = None,
    durability=None,
    replica=None,
) -> None:
    """Periodic expiry sweeps under a restart-on-crash supervisor; with
    --state-file, each sweep also checkpoints — through the
    :class:`~cpzk_tpu_torch.durability.DurabilityManager` (snapshot + WAL
    fsync/compaction) when durability is enabled.  An unpromoted
    replication standby only checkpoints: a local expiry sweep would
    journal records into the standby's WAL and fork its sequence numbers
    away from the primary's stream (expired entries are inert anyway —
    validation rejects them lazily and the primary's own sweep records
    replay the removals).  Full sweeps resume once promoted."""

    async def sweep_loop():
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=CLEANUP_INTERVAL_SECONDS)
                return
            except asyncio.TimeoutError:
                pass
            if replica is None or replica.role == "primary":
                nc = await state.cleanup_expired_challenges()
                ns = await state.cleanup_expired_sessions()
                if nc or ns:
                    log.info("cleanup: %d challenges, %d sessions expired", nc, ns)
            if durability is not None:
                await durability.checkpoint()
            elif state_file:
                await state.snapshot(state_file)
            # freeze the surviving object graph out of the cyclic
            # collector's gen-2 scan: at millions of registered users an
            # automatic collection traverses every UserData/SessionData
            # and stalls the event loop.  The state graph is acyclic
            # (refcounting frees removed entries regardless), so freezing
            # after each checkpoint keeps the scanned set to recent
            # allocations only.
            gc.freeze()

    while not stop.is_set():
        try:
            await sweep_loop()
            return
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("cleanup task crashed; restarting in %ss", SUPERVISOR_BACKOFF_SECONDS)
            try:
                await asyncio.wait_for(stop.wait(), timeout=SUPERVISOR_BACKOFF_SECONDS)
            except asyncio.TimeoutError:
                pass


HELP = """Available commands:
  /status      (/st)  server status summary (incl. backend breaker state)
  /overload    (/ov)  admission status: level, tiers, clients, pushback
  /tracez [N]  (/tz)  last N completed request traces w/ stage breakdown
  /flightrec [N] (/fr) last N device batches: occupancy, dispatch gap,
                      thread_hop/marshal/device_wait split, the card's
                      work interval
  /profile S [DIR]    capture S seconds of torch.profiler (Chrome trace)
  /persist     (/wal) durability status: WAL size, fsync age, covered seq
  /audit       (/au)  proof-log status: path, bytes, seq, fsync policy
  /replication (/repl) replication status: role, epoch, seq, lag, lease
  /promote            promote this standby to primary (operator failover)
  /handover           coordinated primary→standby handover (zero loss)
  /fleet [reload] (/fl) partition-map status; reload adopts a newer map
  /controller  (/ctl) fleet controller: mode, cooldowns, last decisions
  /users       (/u)   registered user count
  /sessions    (/s)   active session count
  /challenges  (/c)   pending challenge count
  /cleanup     (/gc)  run an expiry sweep now
  /reset       (/rearm) re-arm the failover breaker
  /help        (/h)   this help
  /quit        (/q)   graceful shutdown"""


async def handle_command(
    cmd: str, state: ServerState, backend=None, durability=None,
    admission=None, *, audit_log=None, replication=None, fleet=None,
    controller=None,
) -> tuple[str, bool]:
    """(output, should_quit) for one REPL line.  ``backend`` is the
    serving backend: /status surfaces its breaker state and /reset re-arms
    it when it is a ``FailoverBackend`` (the daemon serves the card bare,
    so only a caller that builds one sees them); ``durability`` is the
    DurabilityManager behind /persist, ``admission`` the
    AdmissionController behind /overload, ``audit_log`` the
    ProofLogWriter behind /audit, ``replication`` the SegmentShipper
    (primary) or StandbyReplica (standby) behind /replication, /promote
    and /handover, ``fleet`` the FleetRouter behind /fleet and
    ``controller`` the FleetController behind /controller (each None when
    disabled)."""
    cmd = cmd.strip()
    if not cmd:
        return "", False
    if not cmd.startswith("/"):
        return "Commands must start with '/'. Type /help for available commands.", False
    word = cmd.split()[0].lower()
    if word in ("/status", "/st"):
        u, s, c = (
            await state.user_count(),
            await state.session_count(),
            await state.challenge_count(),
        )
        line = f"users={u} sessions={s} challenges={c}"
        if backend is not None and hasattr(backend, "breaker"):
            line += (
                f" backend={backend.breaker.state.value}"
                f" degraded_for={backend.breaker.degraded_seconds:.1f}s"
                f" expired_shed={int(metrics.read('tpu.queue.expired'))}"
            )
        return line, False
    if word in ("/overload", "/ov"):
        if admission is None:
            return (
                "admission control disabled (set [admission] enabled = true "
                "to get per-client fairness + priority shedding)",
                False,
            )
        s = admission.snapshot()
        tiers = "+".join(s["admitted_tiers"]) or "none"
        return (
            f"level={s['level']:.2f}/3 admitting={tiers}"
            f" clients={s['clients']}/{s['max_clients']}"
            f" (evicted={s['evictions']})"
            f" queue={s['queue_depth']}/{s['queue_capacity']}"
            f" drain={s['drain_rate']:.1f}/s"
            f" util={s['utilization']:.2f}"
            f" queue_wait={s['queue_wait_ms']:.1f}ms"
            f" retry_after={s['retry_after_ms']:.0f}ms"
            f" admitted={int(s['admitted'])}"
            f" shed{{client={int(s['shed_per_client'])}"
            f" priority={int(s['shed_priority'])}"
            f" global={int(s['shed_global'])}}}",
            False,
        )
    if word in ("/tracez", "/traces", "/tz"):
        from ..observability import format_tracez, get_tracer

        parts = cmd.split()
        try:
            limit = int(parts[1]) if len(parts) > 1 else 20
        except ValueError:
            return f"usage: /tracez [N] — not a number: {parts[1]}", False
        # same serializer as the ops plane's HTTP /tracez (one schema)
        return format_tracez(get_tracer().payload(), limit=max(1, limit)), False
    if word in ("/flightrec", "/fr"):
        from ..observability import format_flightrec, get_flight_recorder

        parts = cmd.split()
        try:
            limit = int(parts[1]) if len(parts) > 1 else 20
        except ValueError:
            return f"usage: /flightrec [N] — not a number: {parts[1]}", False
        # same serializer as the HTTP /flightrec and the SIGUSR2 dump
        return format_flightrec(
            get_flight_recorder().payload(), limit=max(1, limit)
        ), False
    if word in ("/profile", "/prof"):
        from ..observability import flightrec as flightrec_mod

        parts = cmd.split()
        if len(parts) < 2:
            return "usage: /profile <seconds> [dir]", False
        try:
            seconds = float(parts[1])
        except ValueError:
            return f"usage: /profile <seconds> [dir] — not a number: {parts[1]}", False
        if not 0 < seconds <= 600:
            return "profile duration must be in (0, 600] seconds", False
        logdir = parts[2] if len(parts) > 2 else (
            f"/tmp/cpzk-torch-profile-{int(time.time())}"
        )
        if not flightrec_mod.start_profile(logdir):
            return (
                f"a profile capture is already running "
                f"(into {flightrec_mod.profile_active()}); wait for it",
                False,
            )
        try:
            await asyncio.sleep(seconds)
        finally:
            flightrec_mod.stop_profile()
        return (
            f"torch.profiler capture ({seconds:g}s) written to {logdir} as "
            f"a Chrome trace — open it in chrome://tracing or Perfetto "
            f"(the cpzk.* ranges match /tracez stage names)",
            False,
        )
    if word in ("/persist", "/wal"):
        if durability is None or durability.wal is None:
            return (
                "durability disabled (set [durability] enabled = true and a "
                "state_file to get a write-ahead log)",
                False,
            )
        s = durability.status()
        age = s["snapshot_age_s"]
        return (
            f"wal={s['wal_path']} bytes={s['wal_bytes']} seq={s['wal_seq']}"
            f" covered_seq={s['covered_seq']} pending={s['pending_appends']}"
            f" fsync={s['fsync_policy']}"
            f" last_fsync_age={s['last_fsync_age_s']:.1f}s"
            f" snapshot_age={'n/a' if age is None else f'{age:.1f}s'}",
            False,
        )
    if word in ("/audit", "/au"):
        if audit_log is None:
            return (
                "audit trail disabled (set [audit] enabled = true and a "
                "log_path to record verified proofs for offline replay)",
                False,
            )
        s = audit_log.status()
        return (
            f"log={s['path']} bytes={s['bytes']} seq={s['seq']}"
            f" this_boot={s['records_this_boot']}"
            f" pending={s['pending_appends']} fsync={s['fsync_policy']}"
            f" — replay with: python -m cpzk_tpu_torch.audit run --log"
            f" {s['path']} --report <out.json>",
            False,
        )
    if word in ("/replication", "/repl"):
        if replication is None:
            return (
                "replication disabled (set [replication] enabled = true on "
                "a durability-enabled pair to get a warm standby)",
                False,
            )
        s = replication.status()
        if s["role"] == "primary":
            return (
                f"role=primary epoch={s['epoch']} mode={s['mode']}"
                f" peer={s['peer']} wal_seq={s['wal_seq']}"
                f" acked_seq={s['acked_seq']} lag={s['lag_records']}"
                f" segments_shipped={s['segments_shipped']}"
                f" fenced={s['fenced']} gap_stalled={s['gap_stalled']}",
                False,
            )
        lease = s["lease_remaining_s"]
        return (
            f"role={s['role']} epoch={s['epoch']}"
            f" applied_seq={s['applied_seq']} lag={s['lag_records']}"
            f" segments={s['segments_received']}"
            f" (rejected={s['segments_rejected']} fenced={s['fenced']})"
            f" records={s['records_applied']}"
            f" (skipped={s['records_skipped']})"
            f" lease={'unarmed' if lease is None else f'{lease:.2f}s'}",
            False,
        )
    if word in ("/fleet", "/fl"):
        if fleet is None:
            return (
                "fleet routing disabled (set [fleet] enabled = true with a "
                "map_path to join an N-partition fleet)",
                False,
            )
        parts = cmd.split()
        if len(parts) > 1 and parts[1].lower() == "reload":
            try:
                changed = fleet.reload()
            except (OSError, ValueError) as e:
                return f"map reload failed: {e}", False
            if not changed:
                return (
                    f"map unchanged (still v{fleet.map.version} "
                    f"{fleet.map.short_digest()})",
                    False,
                )
        s = fleet.status()
        return (
            f"partition={s['partition']}/{s['partitions']}"
            f" map=v{s['map_version']} digest={s['map_digest']}"
            f" address={s['address']}"
            f" owned={s['owned_span_fraction']:.1%} of keyspace"
            f" redirects={s['redirects']}",
            False,
        )
    if word in ("/controller", "/ctl"):
        if controller is None:
            return (
                "fleet controller disabled (set [controller] enabled = true "
                "to close the signal->actuator loop; dry_run = true to "
                "watch decisions without acting)",
                False,
            )
        s = controller.status()
        lines = [
            f"mode={'DRY-RUN' if s['dry_run'] else 'LIVE'}"
            f" ticks={s['ticks']}"
            f" acting={s['acting']}"
            f" drained_lanes={','.join(s['drained_lanes']) or 'none'}"
            + (
                " cooldowns=" + " ".join(
                    f"{k}:{v:.0f}s" for k, v in s["cooldowns_s"].items()
                ) if s["cooldowns_s"] else ""
            )
        ]
        for row in list(s["decisions"])[-5:]:
            outcome = (
                "FIRED" if row["fired"]
                else f"veto:{row['veto']}" if row["veto"]
                else "dry-run"
            )
            lines.append(
                f"  {row['action']} {row['target']} [{outcome}] "
                f"{row['reason']}"
            )
        if len(lines) == 1:
            lines.append("  (no decisions yet)")
        return "\n".join(lines), False
    if word == "/promote":
        if replication is None or not hasattr(replication, "promote"):
            return (
                "nothing to promote (this node is not a replication "
                "standby)",
                False,
            )
        report = await replication.promote(reason="operator")
        if not report["promoted"]:
            return f"not promoted: {report['message']}", False
        return (
            f"PROMOTED to primary: epoch={report['epoch']}"
            f" applied_seq={report['applied_seq']}"
            f" tail_replayed={report['replayed_tail']}"
            f" torn_bytes={report['truncated_bytes']} — this node now "
            "accepts auth traffic; fence the old primary before reviving it",
            False,
        )
    if word == "/handover":
        if replication is None or not hasattr(replication, "run_handover"):
            return (
                "nothing to hand over (this node is not a replication "
                "primary)",
                False,
            )
        try:
            report = await replication.run_handover(reason="operator")
        except Exception as exc:  # noqa: BLE001 — surface, don't kill REPL
            return (
                f"handover ABORTED: {exc} — pair unchanged, lease "
                "failover still covers a real primary death",
                False,
            )
        return (
            f"HANDOVER complete in {report['duration_s'] * 1000.0:.0f}ms: "
            f"standby promoted at epoch={report['epoch']} "
            f"fence_seq={report['fence_seq']} — this node now redirects "
            "writes to the new primary; drain and restart it",
            False,
        )
    if word in ("/reset", "/rearm"):
        if backend is None or not hasattr(backend, "breaker"):
            return "no failover backend to reset (inline CPU path)", False
        backend.reset()
        return "breaker re-armed: traffic back on the primary backend", False
    if word in ("/users", "/u"):
        return f"registered users: {await state.user_count()}", False
    if word in ("/sessions", "/s"):
        return f"active sessions: {await state.session_count()}", False
    if word in ("/challenges", "/c"):
        return f"pending challenges: {await state.challenge_count()}", False
    if word in ("/cleanup", "/gc"):
        nc = await state.cleanup_expired_challenges()
        ns = await state.cleanup_expired_sessions()
        return f"cleanup done: {nc} challenges, {ns} sessions removed", False
    if word in ("/help", "/h", "/?"):
        return HELP, False
    if word in ("/quit", "/exit", "/q"):
        return "shutting down...", True
    return f"Unknown command: {word}. Type /help for available commands.", False


async def load_state(config: ServerConfig):
    """(state, durability manager | None) for the resolved config.

    With ``[durability] enabled``: full crash recovery — snapshot load with
    corrupt-file quarantine, WAL torn-tail truncation + suffix replay, then
    a fresh covering snapshot so the next boot replays nothing.  It runs
    before the daemon binds any listener (ops plane or gRPC), so nothing
    reports ready while replay runs.  Without it: the plain snapshot
    restore, where a corrupt snapshot quarantines with a loud ERROR and
    the server boots empty instead of crash-looping on every restart."""
    state = ServerState(
        shards=config.replication.shards,
        max_users=config.server.max_users,
        max_challenges=config.server.max_challenges,
        max_sessions=config.server.max_sessions,
    )
    if config.durability.enabled:
        from ..durability import DurabilityManager

        t0 = time.perf_counter()
        durability = DurabilityManager(state, config.durability, config.state_file)
        report = await durability.recover()
        log.info(
            "durability: %d users / %d sessions from snapshot, %d WAL records "
            "replayed (%d skipped) up to seq %d in %.3fs",
            report.users, report.sessions, report.replayed, report.skipped,
            report.next_seq, time.perf_counter() - t0,
        )
        # fold the replayed suffix into a fresh covering snapshot now:
        # bounds the next boot's replay and arms compaction
        await durability.checkpoint()
        # a freshly-recovered million-user graph goes straight into the
        # collector's frozen set (see cleanup_supervisor for why)
        gc.collect()
        gc.freeze()
        return state, durability
    if config.state_file and os.path.exists(config.state_file):
        try:
            nu, ns = await state.restore(config.state_file)
            log.info("restored state snapshot: %d users, %d sessions", nu, ns)
        except asyncio.CancelledError:
            raise
        except UnsupportedFormat:
            # newer-format snapshot: not corrupt, the binary is old —
            # refuse to boot rather than quarantining live data
            raise
        except Exception as e:
            from ..durability.recovery import quarantine_file

            dst = quarantine_file(config.state_file, int(time.time()))
            log.error(
                "ERROR: corrupt state snapshot %s (%s); quarantined to %s and "
                "booting with empty state instead of crash-looping",
                config.state_file, e, dst,
            )
    return state, None


def resolve_config(args) -> ServerConfig:
    """defaults < TOML < .env < SERVER_* env < explicitly-provided CLI flags."""
    config = ServerConfig.from_env()
    if args.host is not None:
        config.host = args.host
    if args.port is not None:
        config.port = args.port
    if args.rate_limit is not None:
        config.rate_limit.requests_per_minute = args.rate_limit
    if args.rate_burst is not None:
        config.rate_limit.burst = args.rate_burst
    if args.metrics is not None:
        config.metrics.enabled = args.metrics
    if args.metrics_port is not None:
        config.metrics.port = args.metrics_port
    if args.backend is not None:
        config.tpu.backend = args.backend
    if args.batch_max is not None:
        config.tpu.batch_max = args.batch_max
    if args.batch_window_ms is not None:
        config.tpu.batch_window_ms = args.batch_window_ms
    if args.state_file is not None:
        config.state_file = args.state_file
    config.validate()
    return config


async def amain(args, *, device=None, devices=None) -> None:
    """Run the daemon until SIGTERM/SIGINT or /quit.  ``device`` is where
    ``backend = "tpu"`` serves: None means ``cuda:0`` (and raises without
    CUDA); the tests pass ``"cpu"`` to run the kernels' plain versions.
    ``devices`` is an explicit device pool for ``[tpu] lanes`` and
    ``mesh_devices`` to resolve against (it may repeat a device); None
    means the local CUDA cards (:func:`.plane.build_backend`)."""
    # resolve config first so .env-provided RUST_LOG/LOG_LEVEL reach logging
    config = resolve_config(args)

    logging.basicConfig(
        level=os.environ.get("RUST_LOG", os.environ.get("LOG_LEVEL", "INFO")).upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )

    # observability: trace ring size, slow-request threshold, histogram
    # buckets, and the (opt-in) JSON log formatter — before any RPC runs
    from ..observability import configure as configure_observability

    configure_observability(config.observability)
    if config.observability.json_logs:
        log.info("structured JSON logging enabled")

    state, durability = await load_state(config)
    limiter = config.rate_limit.build_limiter()
    stop = asyncio.Event()

    metrics_fallback_needed = False
    if config.metrics.enabled:
        if metrics.start_exporter(config.metrics.host, config.metrics.port):
            log.info("metrics exporter on %s:%d", config.metrics.host, config.metrics.port)
        else:
            # the ops plane serves the facade's own text exposition on
            # that same port instead, and says so
            metrics_fallback_needed = True
            log.warning(
                "prometheus_client is not installed: the metrics exporter "
                "cannot start; serving the metrics facade's own text "
                "exposition at http://%s:%d/metrics via the ops plane "
                "instead (identical family set)",
                config.metrics.host, config.metrics.port,
            )

    tls = None
    if config.tls.enabled:
        def _read_tls(key_path: str, cert_path: str) -> tuple[bytes, bytes]:
            with open(key_path, "rb") as kf, open(cert_path, "rb") as cf:
                return kf.read(), cf.read()

        tls = await asyncio.to_thread(
            _read_tls, config.tls.key_path, config.tls.cert_path
        )

    from .service import serve

    if config.tpu.backend == "tpu":
        from .plane import build_backend

        # builds the CUDA kernels and prewarms [tpu] prewarm_quanta before
        # anything listens: a kernel that fails to build or launch stops
        # the boot here
        backend, batcher = build_backend(config.tpu, device=device, devices=devices)
        log.info(
            "card backend enabled on %s (batch_max=%d window=%.1fms, no "
            "host failover)",
            backend.device, config.tpu.batch_max, config.tpu.batch_window_ms,
        )
    else:
        from ..protocol.batch import CpuBackend

        # the port's serve(backend=None) means the card: ask for the host
        backend, batcher = CpuBackend(), None

    admission = None
    if config.admission.enabled:
        from ..admission import AdmissionController

        admission = AdmissionController(config.admission, batcher=batcher)
        log.info(
            "admission control enabled (per_client_rpm=%d, max_clients=%d)",
            config.admission.per_client_rpm, config.admission.max_clients,
        )
    audit_log = None
    if config.audit.enabled:
        from ..audit import ProofLogWriter

        audit_log = ProofLogWriter(
            config.audit.log_path,
            fsync=config.audit.fsync,
            fsync_interval_ms=config.audit.fsync_interval_ms,
            segment_bytes=config.audit.segment_bytes,
        )
        log.info(
            "audit trail enabled: proof log at %s (fsync=%s, seq=%d, "
            "segment_bytes=%d)",
            config.audit.log_path, config.audit.fsync, audit_log.seq,
            config.audit.segment_bytes,
        )

    shipper = None
    replica = None
    if config.replication.enabled:
        from ..replication import SegmentShipper, StandbyReplica

        if config.replication.role == "standby":
            replica = StandbyReplica(
                state, durability, config.replication,
                audit_path=config.audit.log_path or None,
                audit_log=audit_log,
            )
            log.info(
                "replication standby: epoch=%d applied_seq=%d (auth RPCs "
                "refused until promotion; lease %gms, auto_promote=%s)",
                replica.epoch, replica.applied_seq,
                config.replication.lease_ms, config.replication.auto_promote,
            )
        else:
            # sealed proof-log segments ride the same shipping loop as
            # WAL segments, so the audit trail survives machine death too
            shipper = SegmentShipper(
                state, durability, config.replication, audit_log=audit_log
            )
            durability.attach_shipper(shipper)
            if config.replication.mode == "sync":
                # one barrier per acknowledgement: a RegisterBatch RPC
                # syncs the WAL once and so awaits this once, on the RPC's
                # last sequence number, before it answers
                state.attach_replication_barrier(shipper.wait_replicated)
            log.info(
                "replication primary: epoch=%d mode=%s -> %s (segment "
                "%d bytes, renew %gms)",
                shipper.epoch, config.replication.mode,
                config.replication.peer, config.replication.segment_bytes,
                config.replication.renew_interval_ms,
            )

    fleet_router = None
    if config.fleet.enabled:
        from ..fleet import FleetRouter, PartitionMap

        pmap = PartitionMap.load(config.fleet.map_path)
        idx = config.fleet.partition
        if idx < 0:
            advertise = config.fleet.advertise or config.addr()
            idx = pmap.index_of_address(advertise)
        fleet_router = FleetRouter(
            pmap, idx, map_path=config.fleet.map_path
        )
        me = pmap.partitions[idx]
        log.info(
            "fleet routing enabled: partition %d/%d (map v%d %s, owns "
            "%.1f%% of the keyspace as %s)",
            idx, len(pmap.partitions), pmap.version, pmap.short_digest(),
            100.0 * me.span() / (1 << 32), me.address,
        )
    # the boot graph (restored state, the imported modules, the kernels'
    # plumbing) goes into the collector's frozen set, as after each sweep
    gc.collect()
    gc.freeze()

    # started after the replication block: an unpromoted standby's sweep
    # must checkpoint-only (see cleanup_supervisor)
    cleanup_task = asyncio.create_task(
        cleanup_supervisor(
            state, stop, config.state_file or None, durability, replica
        )
    )

    # ops plane + SLO engine: the remote introspection surface, started
    # BEFORE the gRPC listener so a booting box is observable
    from ..observability.opsplane import OpsPlane, OpsSources
    from ..observability.slo import SloEngine

    slo_engine = SloEngine(config.slo)

    async def slo_ticker() -> None:
        interval = config.slo.tick_interval_ms / 1000.0
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=interval)
                return
            except asyncio.TimeoutError:
                pass
            try:
                slo_engine.tick()
            except Exception:
                log.exception("SLO tick failed; continuing")

    slo_task = asyncio.create_task(slo_ticker())

    if fleet_router is not None:
        # per-partition SLO attribution: the /slo payload (and /statusz
        # rollup) names this partition so fleet dashboards can join
        slo_engine.partition = str(fleet_router.self_index)

    ops_sources = OpsSources(
        state=state,
        batcher=batcher,
        backend=backend,
        admission=admission,
        replication=shipper or replica,
        durability=durability,
        audit_log=audit_log,
        slo=slo_engine,
        fleet=fleet_router,
        config_fingerprint=config.fingerprint(),
        role="standby" if replica is not None else "server",
    )
    ops_plane = None
    if config.opsplane.enabled:
        ops_plane = OpsPlane(
            ops_sources, host=config.opsplane.host, port=config.opsplane.port
        )
        bound = await ops_plane.start()
        log.info(
            "ops plane on http://%s:%d (/metrics /statusz /tracez "
            "/flightrec /healthz /slo)", config.opsplane.host, bound,
        )
    metrics_fallback_plane = None
    if metrics_fallback_needed:
        metrics_fallback_plane = OpsPlane(
            ops_sources, host=config.metrics.host, port=config.metrics.port
        )
        await metrics_fallback_plane.start()

    # sharded ingest ([server] ingest_shards > 1): the dispatch process
    # starts PORTLESS and N SO_REUSEPORT listener processes own the
    # public address, feeding it over the CRC-framed unix-socket seam;
    # ingest_shards = 1 binds in-process (no supervisor is constructed)
    shard_ingest = config.server.ingest_shards > 1
    server, port = await serve(
        state, limiter, host=config.host, port=config.port,
        backend=backend, batcher=batcher, tls=tls, admission=admission,
        # a primary exposes the ReplicationService too (the shipper's
        # handler serves the Handover RPC; ship/status answer refusals)
        replica=replica or shipper, audit_log=audit_log,
        stream_window=config.tpu.stream_window,
        stream_entry_deadline_ms=config.tpu.stream_entry_deadline_ms,
        fleet=fleet_router, wire=config.server.wire,
        listen=not shard_ingest,
    )
    ingest = None
    if shard_ingest:
        from .ingest import IngestSupervisor

        ingest = IngestSupervisor(
            server.auth_service, server.health,
            shards=config.server.ingest_shards,
            host=config.host, port=config.port,
            wire=config.server.wire, tls=tls,
        )
        await ingest.start()
        port = config.port
        ops_sources.ingest = ingest
    # late attachments: serve() built these (health gate, stream registry)
    ops_sources.health = server.health
    ops_sources.service = server.auth_service
    # fleet controller ([controller] enabled): the self-driving loop over
    # the planes built above — started after serve() so its first tick
    # already sees the lane router and ingest shards, dry-run by default
    controller = None
    controller_task = None
    if config.controller.enabled:
        from ..fleet.controller import FleetController

        controller = FleetController(
            config.controller,
            state=state,
            router=getattr(batcher, "router", None),
            admission=admission,
            slo=slo_engine,
            fleet=fleet_router,
            durability=durability,
            replica=replica,
            epoch_file=config.replication.epoch_file
            or ((config.state_file + ".epoch") if config.state_file else ""),
            segment_bytes=config.replication.segment_bytes,
        )
        ops_sources.controller = controller

        async def controller_ticker() -> None:
            interval = config.controller.tick_interval_ms / 1000.0
            while not stop.is_set():
                try:
                    await asyncio.wait_for(stop.wait(), timeout=interval)
                    return
                except asyncio.TimeoutError:
                    pass
                try:
                    await controller.tick()
                except Exception:
                    log.exception("controller tick failed; continuing")

        controller_task = asyncio.create_task(controller_ticker())
        log.info(
            "fleet controller %s: tick %gms, act after %d hot ticks, "
            "clear after %d",
            "DRY-RUN (decisions only)" if config.controller.dry_run
            else "LIVE", config.controller.tick_interval_ms,
            config.controller.act_ticks, config.controller.clear_ticks,
        )
    if shipper is not None:
        shipper.start()
    if replica is not None:
        replica.start()
    log.info("wire path: %s", config.server.wire)
    print(_c("green", f"AuthService listening on {config.host}:{port}"
             + (f" ({config.server.ingest_shards} ingest shards)"
                if shard_ingest else "")), flush=True)

    loop = asyncio.get_running_loop()
    # SIGTERM is the planned-operations signal: on a primary with a live
    # standby it runs a coordinated handover before the drain (below).
    # SIGINT stays a plain stop — ^C in a terminal should not fail over.
    term_requested = False

    def _on_term() -> None:
        nonlocal term_requested
        term_requested = True
        stop.set()

    loop.add_signal_handler(signal.SIGINT, stop.set)
    loop.add_signal_handler(signal.SIGTERM, _on_term)

    def dump_flightrec() -> None:
        """SIGUSR2: dump the flight-recorder ring as JSON — the live-
        incident snapshot (``kill -USR2 <pid>``), no REPL needed."""
        from ..observability import get_flight_recorder

        path = os.environ.get(
            "CPZK_FLIGHTREC_DUMP", f"/tmp/cpzk-flightrec-{os.getpid()}.json"
        )
        try:
            get_flight_recorder().dump(path)
            log.info("flight recorder dumped to %s", path)
        except OSError:
            log.exception("flight recorder dump to %s failed", path)

    with contextlib.suppress(NotImplementedError, ValueError, AttributeError):
        # absent on platforms without SIGUSR2 (windows) — REPL still works
        loop.add_signal_handler(signal.SIGUSR2, dump_flightrec)

    async def repl():
        print(_c("cyan", "Admin REPL ready. Type /help for commands."))
        while not stop.is_set():
            try:
                line = await asyncio.to_thread(input, "> ")
            except (EOFError, KeyboardInterrupt):
                stop.set()
                return
            out, quit_ = await handle_command(
                line, state, backend, durability, admission,
                audit_log=audit_log, replication=shipper or replica,
                fleet=fleet_router, controller=controller,
            )
            if out:
                print(_c("white", out))
            if quit_:
                stop.set()
                return

    repl_task = None
    if not args.no_repl and sys.stdin.isatty():
        repl_task = asyncio.create_task(repl())

    await stop.wait()

    # planned operations: SIGTERM on a primary with a standby hands
    # ownership over BEFORE the drain — the write blackout is one ship RTT
    # plus the promotion instead of a lease_ms failover window, with zero
    # acknowledged-write loss structurally.  Any failure falls back to the
    # plain drain, loudly: the standby then takes over on lease expiry.
    if (
        term_requested
        and shipper is not None
        and config.replication.handover_on_term
        and not shipper.fenced
    ):
        print(_c("yellow", "SIGTERM: attempting coordinated handover..."), flush=True)
        try:
            report = await shipper.run_handover(reason="sigterm")
            print(_c(
                "green",
                f"handover complete: standby promoted at epoch "
                f"{report['epoch']} in {report['duration_s'] * 1000.0:.0f}ms",
            ), flush=True)
        except Exception:
            log.exception(
                "coordinated handover FAILED; falling back to plain drain "
                "(no/stale standby?) — the standby takes over via lease "
                "expiry instead"
            )

    # graceful shutdown: not-serving -> drain -> stop -> final snapshot;
    # background tasks are cancelled AND awaited so no in-flight sweep
    # races the final snapshot and no "Task was destroyed but it is
    # pending" warnings leak
    print(_c("yellow", "shutdown: flipping health to NOT_SERVING, draining..."), flush=True)
    server.health.serving = False
    await asyncio.sleep(DRAIN_SECONDS)
    if ingest is not None:
        await ingest.stop()  # listener shards down before the batcher drain
    if batcher is not None:
        await batcher.stop()  # drain queued verifications before the listener
    await server.stop(grace=5)
    if audit_log is not None:
        # after the drain and the listener: every verdict a client was
        # answered is appended (the handlers append before they answer);
        # the pending fsync tasks finish before the writer closes
        for res in await asyncio.gather(
                *server.auth_service._audit_flushes, return_exceptions=True):
            if isinstance(res, BaseException):
                log.error("audit trail: a pending fsync failed: %r", res)
        await asyncio.to_thread(audit_log.close)
        log.info("audit trail closed at seq %d", audit_log.seq)
    # after the listener and the proof log: the shipper's final flush tick
    # ships the last WAL records and the last sealed proof-log segment
    # (the reference stops it before the listener)
    if shipper is not None:
        await shipper.stop()
    if replica is not None:
        await replica.stop()
    # the ops plane outlives the gRPC listener (it watched the drain);
    # stop it after so the last /statusz of a shutdown is observable
    if ops_plane is not None:
        await ops_plane.stop()
    if metrics_fallback_plane is not None:
        await metrics_fallback_plane.stop()
    if controller_task is not None:
        controller_task.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await controller_task
    slo_task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await slo_task
    cleanup_task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await cleanup_task
    if durability is not None:
        await durability.close()  # final snapshot + truncate the covered WAL
        log.info(
            "durability: final snapshot written to %s, WAL truncated",
            config.state_file,
        )
    elif config.state_file:
        await state.snapshot(config.state_file)
        log.info("state snapshot written to %s", config.state_file)
    if repl_task is not None:
        repl_task.cancel()
        # the REPL may be blocked in a to_thread(input) that only returns
        # on the next keypress — bound the wait instead of hanging exit
        with contextlib.suppress(asyncio.CancelledError, asyncio.TimeoutError):
            await asyncio.wait_for(repl_task, timeout=1.0)
    print(_c("green", "bye"), flush=True)


def main() -> None:
    asyncio.run(amain(parse_args()))


if __name__ == "__main__":
    main()
