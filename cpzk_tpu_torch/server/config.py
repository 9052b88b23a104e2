"""Server configuration and rate limiting.

A copy of ``cpzk_tpu/server/config.py``, section for section and key for
key, so one TOML file, ``.env`` or ``SERVER_*`` environment serves either
package.  Layering: defaults <- TOML file (path from
``SERVER_CONFIG_PATH``, default ``config/server.toml``) <- ``.env`` file
<- ``SERVER_*`` environment variables, then the daemon's CLI flags on top.
``ServerConfig.validate`` keeps the reference's messages; its ``[tpu]``
checks are :func:`validate_tpu`, which ``build_backend`` runs too.

One departure, a default: ``[tpu] backend`` defaults to ``"tpu"``, the
device plane, which in this package is the card.  ``"cpu"`` (in a file,
the environment or ``--backend cpu``) is the caller asking for inline host
verification.

:class:`RateLimiter` and :class:`RateLimitExceeded` are the global token
bucket the gRPC service admits every RPC through (fractional refill, burst
cap).
"""

from __future__ import annotations

import os
import time
import asyncio

try:
    import tomllib  # Python >= 3.11
except ModuleNotFoundError:  # pragma: no cover - 3.10 containers
    import tomli as tomllib  # type: ignore[no-redef]
from dataclasses import dataclass, field


@dataclass
class ServerSettings:
    """Transport-plane knobs (``[server]``): the native wire path and the
    SO_REUSEPORT sharded-ingest mode.  See ``docs/operations.md``
    §"Wire path & ingest shards"."""

    wire: str = "native"   # "native" = the host core's C++ parse of the
                           # hot request messages straight off the socket
                           # bytes (a message outside the parser's
                           # recognized subset goes to the protobuf
                           # runtime) | "python" = always the protobuf
                           # runtime
    ingest_shards: int = 1  # 1 = in-process listener; N > 1 = N spawned
                            # event-loop processes each bind the listener
                            # via SO_REUSEPORT and run the native parse,
                            # feeding this dispatch/state process (which
                            # keeps rate limiting and the card) over a
                            # CRC-framed unix-socket seam
    # global state-capacity caps (reference-parity defaults; raise them
    # for million-user deployments — the soak harness does).  Counters
    # are maintained integers, so a large cap costs nothing per RPC.
    max_users: int = 10_000
    max_challenges: int = 50_000
    max_sessions: int = 100_000


@dataclass
class RateLimitSettings:
    """The GLOBAL token bucket — the aggregate backstop behind the
    per-client buckets in ``[admission]``.  ``requests_per_minute`` has
    no "0 disables" semantics here (a server that admits nothing is a
    misconfiguration): set it very large to effectively disable.  The
    per-client limits in :class:`AdmissionSettings` use ``0`` = unset."""

    requests_per_minute: int = 100
    burst: int = 10

    def build_limiter(self) -> "RateLimiter":
        return RateLimiter(self.requests_per_minute, self.burst)


@dataclass
class MetricsSettings:
    enabled: bool = False  # opt-in, like the reference's --metrics flag
    host: str = "127.0.0.1"
    port: int = 9090


@dataclass
class TlsSettings:
    enabled: bool = False
    cert_path: str = ""
    key_path: str = ""


@dataclass
class TpuSettings:
    """Device serving knobs: backend selection, batch-size target, queue
    deadline, lane and mesh shape, plus the resilience knobs (breaker
    recovery, probe sizing, deadline shedding)."""

    backend: str = "tpu"          # "tpu" (the card; the reference's default
                                  # is "cpu") | "cpu" (inline host verify)
    batch_max: int = 4096         # dynamic-batcher device batch target
    batch_window_ms: float = 5.0  # queue deadline before dispatch
    mesh_devices: int = 0         # 0 = all visible devices, k = the first k
                                  # (one card: no mesh)
    lanes: int = 1                # per-device dispatch lanes: 1 = one lane;
                                  # -1 = one per local device, k > 1 = the
                                  # first k
    mesh_threshold: int = 0       # entries at/above which a batch routes to
                                  # the mesh lane; 0 = never
    pipeline_depth: int = 2       # in-flight batches (1 = serial dispatch);
                                  # >1 double-buffers host prep against
                                  # device work on the dispatch lane
    prewarm_quanta: str = ""      # comma list of batch sizes checked on the
                                  # card BEFORE the server reports ready
                                  # (the kernels are built either way)
    recovery_after_s: float = 30.0  # breaker cooldown before a device probe
                                    # (0 = probe immediately; -1 = never
                                    # self-heal, degrade until reset)
    probe_batch_max: int = 64     # rows re-verified on the device per probe
    shed_expired: bool = True     # drop deadline-expired queue entries
    stream_window: int = 8192     # max in-flight proofs per verify stream
    stream_entry_deadline_ms: float = 0.0  # per-entry verify deadline on
                                  # streams; 0 = only the stream's deadline

    def parsed_prewarm_quanta(self) -> list[int]:
        """Batch sizes from the comma-separated config string."""
        text = self.prewarm_quanta.strip()
        if not text:
            return []
        return [int(part) for part in text.split(",") if part.strip()]


def validate_tpu(tpu: TpuSettings) -> None:
    """The ``[tpu]`` checks of the reference's ``ServerConfig.validate``,
    with its messages; raises ``ValueError`` on the first violation."""
    if tpu.backend not in ("cpu", "tpu"):
        raise ValueError(f"Unknown verifier backend: {tpu.backend}")
    if tpu.pipeline_depth < 1:
        raise ValueError("tpu.pipeline_depth must be >= 1")
    if tpu.batch_max < 1:
        raise ValueError("tpu.batch_max must be positive")
    if tpu.batch_window_ms < 0:
        raise ValueError("tpu.batch_window_ms cannot be negative")
    if tpu.mesh_devices < 0:
        raise ValueError("tpu.mesh_devices cannot be negative")
    if tpu.lanes == 0 or tpu.lanes < -1:
        raise ValueError(
            "tpu.lanes must be a positive lane count, or -1 for one "
            "lane per local device"
        )
    if tpu.mesh_threshold < 0:
        raise ValueError(
            "tpu.mesh_threshold cannot be negative (0 disables the "
            "big-batch mesh path)"
        )
    if tpu.mesh_threshold > 0 and tpu.lanes == 1:
        raise ValueError(
            "tpu.mesh_threshold needs tpu.lanes != 1 (the mesh lane "
            "shards over the per-device lanes' devices)"
        )
    if tpu.recovery_after_s < 0 and tpu.recovery_after_s != -1:
        raise ValueError(
            "tpu.recovery_after_s must be >= 0, or -1 to disable self-healing"
        )
    if tpu.probe_batch_max < 1:
        raise ValueError("tpu.probe_batch_max must be positive")
    if tpu.stream_window < 1:
        raise ValueError("tpu.stream_window must be positive")
    if tpu.stream_entry_deadline_ms < 0:
        raise ValueError(
            "tpu.stream_entry_deadline_ms cannot be negative "
            "(0 disables per-entry deadlines)"
        )
    try:
        quanta = tpu.parsed_prewarm_quanta()
    except ValueError:
        raise ValueError(
            "tpu.prewarm_quanta must be a comma-separated list of "
            "batch sizes"
        ) from None
    if any(q < 1 for q in quanta):
        raise ValueError("tpu.prewarm_quanta entries must be positive")


@dataclass
class OpsplaneSettings:
    """HTTP introspection server (ops plane): remote, read-only access to
    ``/metrics``, ``/statusz``, ``/tracez``, ``/flightrec``, ``/healthz``,
    and ``/slo`` — the surfaces that were REPL-only before.  Dependency-
    free (stdlib asyncio); started by the daemon BEFORE the gRPC listener
    so a booting box is observable while it recovers.  No auth layer:
    bind to loopback (default) or an internal interface.  See
    ``docs/operations.md`` §"Ops plane & SLOs"."""

    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 9092          # 0 = OS-assigned (tests bind ephemeral)


@dataclass
class SloSettings:
    """SLO objectives + burn-rate alerting thresholds over the per-RPC
    request/duration families (``observability/slo.py``).  Burn rates are
    computed over the standard multi-window pairs (5m/1h fast, 30m/6h
    slow); a page fires only when BOTH windows of a pair exceed the
    pair's threshold.  See ``docs/operations.md`` §"Ops plane & SLOs"."""

    availability_target: float = 0.999  # fraction of requests that must
                                        # succeed (99.9%)
    latency_ms: str = ""          # per-RPC mean-latency targets as
                                  # "Rpc=ms" pairs, comma-separated
                                  # (e.g. "VerifyProof=250,Register=100");
                                  # empty = built-in per-class defaults
    fast_burn_threshold: float = 14.4  # page when 5m AND 1h burn >= this
    slow_burn_threshold: float = 6.0   # page when 30m AND 6h burn >= this
    tick_interval_ms: float = 5000.0   # engine sampling cadence

    def parsed_latency_ms(self) -> dict[str, float]:
        """{rpc: target ms} overrides from the config string."""
        out: dict[str, float] = {}
        text = self.latency_ms.strip()
        if not text:
            return out
        for part in text.split(","):
            part = part.strip()
            if not part:
                continue
            rpc, _, value = part.partition("=")
            if not rpc.strip() or not value.strip():
                raise ValueError(f"malformed latency_ms entry: {part!r}")
            out[rpc.strip()] = float(value)
        return out


@dataclass
class ObservabilitySettings:
    """Tracing/telemetry knobs (observability subsystem): the JSON log
    formatter opt-in, the slow-request WARNING threshold, the completed-
    trace ring capacity behind the admin REPL's ``/tracez``, and an
    optional override of the built-in histogram bucket schedule."""

    json_logs: bool = False        # structured JSON log records (opt-in)
    slow_request_ms: float = 1000.0  # >= this logs a WARNING with stage
                                     # breakdown; 0 logs every request,
                                     # -1 disables slow-request logging
    trace_ring: int = 256          # completed traces kept for /tracez
    latency_buckets_ms: str = ""   # comma-separated upper bounds in ms;
                                   # empty keeps the built-in schedule
    flight_ring: int = 512         # device batches kept for /flightrec
                                   # and the SIGUSR2 JSON dump
    compile_storm_threshold: int = 8  # first-sight jit compiles per 60s
                                      # window that trigger the
                                      # compile-storm WARNING

    def parsed_buckets(self) -> list[float]:
        """Bucket bounds in SECONDS from the ms-denominated config string
        (empty list = keep the metrics module's built-in default)."""
        text = self.latency_buckets_ms.strip()
        if not text:
            return []
        return [float(part) / 1000.0 for part in text.split(",") if part.strip()]


@dataclass
class DurabilitySettings:
    """Crash-consistent persistence knobs (durability subsystem): upgrade
    the opt-in ``state_file`` snapshot to snapshot + write-ahead log, so
    an acknowledged mutation survives a crash between cleanup sweeps.
    See ``docs/operations.md`` §"Durability & recovery"."""

    enabled: bool = False         # opt-in; requires state_file to be set
    wal_path: str = ""            # empty = "<state_file>.wal"
    fsync: str = "always"         # "always" | "interval" | "off"
    fsync_interval_ms: float = 50.0  # fsync cadence under the interval
                                     # policy (= the acknowledged-write
                                     # loss window)
    compact_bytes: int = 1_048_576   # compact the WAL once it outgrows
                                     # this after a covering snapshot;
                                     # 0 = compact on every snapshot
    wal_segment_bytes: int = 0       # rotate the WAL into sealed
                                     # <wal>.<first>-<last>.seg files at
                                     # about this size (0 = single-file
                                     # log, copy-compaction).  Sealed
                                     # segments make compaction an
                                     # unlink of fully-covered files —
                                     # append stalls stop scaling with
                                     # the surviving tail


@dataclass
class ReplicationSettings:
    """Replicated server state (replication subsystem): WAL segment
    shipping from the primary to a warm standby, lease-based promotion,
    and epoch fencing.  Built on [durability] (``enabled`` requires it).
    See ``docs/operations.md`` §"Replication & failover"."""

    enabled: bool = False
    role: str = "primary"        # "primary" (ships) | "standby" (receives)
    peer: str = ""               # primary: the standby's gRPC address
    mode: str = "async"          # "async" (lose <= renew_interval of acked
                                 # writes on failover) | "sync" (acks wait
                                 # for standby apply: zero loss)
    lease_ms: float = 3000.0     # standby promotes after this long without
                                 # contact from an equal-or-higher epoch
    renew_interval_ms: float = 500.0  # ship/renew cadence; MUST be < lease_ms
    segment_bytes: int = 65536   # seal shipped segments at about this size
    sync_timeout_ms: float = 1000.0   # sync-mode ack deadline (past it the
                                      # mutation FAILS, not silently async)
    auto_promote: bool = True    # standby self-promotes on lease expiry
                                 # (false = operator /promote only)
    epoch_file: str = ""         # empty = "<state_file>.epoch"
    shards: int = 16             # ServerState lock shards; ids/tokens carry
                                 # the shard tag, so a replicated pair MUST
                                 # agree on this value (1..256)
    handover_on_term: bool = True     # SIGTERM on a primary with a standby
                                      # attached runs the coordinated
                                      # handover before draining (a missing
                                      # or stale standby falls back to the
                                      # plain drain, loudly)
    handover_timeout_ms: float = 5000.0  # deadline for the whole handover
                                         # (fence-watermark catch-up + the
                                         # promote exchange); past it the
                                         # handover aborts and unfences


@dataclass
class AuditSettings:
    """Proof-log audit trail (audit subsystem): when enabled, the service
    appends one CRC-framed record per verified proof (statement,
    challenge, proof wire, verdict) to ``log_path``; the audit pipeline
    later replays it through the batch engine and emits a Schnorr-signed
    report.  See ``docs/operations.md`` §"Streaming & audit"."""

    enabled: bool = False         # opt-in; requires log_path
    log_path: str = ""            # the proof log (created 0600)
    fsync: str = "off"            # "always" | "interval" | "off" — an
                                  # audit trail usually tolerates losing
                                  # the last instants of a crash
    fsync_interval_ms: float = 200.0  # cadence under the interval policy
    segment_bytes: int = 0        # rotate the log into sealed
                                  # <log>.<first>-<last>.seg files at about
                                  # this size; sealed segments ship to the
                                  # replication standby so a machine death
                                  # loses at most the unsealed tail
                                  # (0 = never rotate)


@dataclass
class FleetSettings:
    """N-partition fleet routing (fleet subsystem): this daemon's slot in
    a versioned partition map.  Every auth RPC then checks ownership
    before touching state and redirects wrong-partition requests with the
    map version + owner address in trailing metadata; the ops plane serves
    the map read-only at ``/partitionmap``.  See ``docs/operations.md``
    §"Partitioned fleet"."""

    enabled: bool = False      # opt-in; requires map_path
    map_path: str = ""         # the serialized partition-map JSON file
    partition: int = -1        # this daemon's partition index;
                               # -1 = discover by matching `advertise`
                               # (or host:port) against the map
    advertise: str = ""        # this partition's address as it appears in
                               # the map (empty = "<host>:<port>")


@dataclass
class ControllerSettings:
    """Self-driving fleet control loop (``fleet/controller.py``): a
    daemon-resident ticker that consumes the existing observability
    signals (SLO burn pages, per-shard sizes + lock-wait, lane breaker
    states) and acts through the existing actuators — live partition
    split, lane drain/re-admit, admission level cap.  Ships with
    ``dry_run = true``: decisions are computed, traced, and surfaced on
    ``/statusz`` but no actuator fires until an operator flips it.  See
    ``docs/operations.md`` §"Fleet controller & failure storms"."""

    enabled: bool = False
    tick_interval_ms: float = 1000.0  # signal sampling cadence
    dry_run: bool = True          # compute + publish decisions, act on none
    decision_ring: int = 64       # last-N decisions kept for /statusz
    # two-sided hysteresis: a signal must stay hot for act_ticks
    # consecutive ticks before the action fires, and stay clear for
    # clear_ticks consecutive ticks before the reverse action (lane
    # re-admit, admission cap restore) fires — the controller cannot flap
    act_ticks: int = 3
    clear_ticks: int = 5
    # live partition split: fires when THIS partition's user count or
    # sustained mean shard lock-wait crosses its capacity envelope
    # (calibrate both from the soak harness; 0 = that trigger disabled)
    split_user_threshold: int = 0
    split_lock_wait_ms: float = 0.0
    split_target_address: str = ""  # address the new partition will own in
                                    # the flipped map; empty disarms splits
    split_cooldown_s: float = 600.0
    # lane drain: fires when a lane breaker stays OPEN this long;
    # re-admit once the breaker has been CLOSED for clear_ticks ticks
    lane_open_after_s: float = 10.0
    lane_cooldown_s: float = 30.0   # min seconds a drained lane stays out
    # admission bias: cap the AIMD level one tier down per shrink while a
    # login SLO burn page is firing; restore tier-by-tier on clear ticks
    slo_rpc: str = "VerifyProof"    # the RPC whose burn pages drive it
    admission_cooldown_s: float = 15.0
    # retry spacing after an actuator RAISED: the failed action's full
    # cooldown is rolled back (nothing changed in the planes) and this
    # short backoff governs the retry instead — a transient split
    # failure must not burn the 600 s split cooldown
    error_backoff_s: float = 30.0


@dataclass
class AdmissionSettings:
    """Adaptive overload control (admission subsystem): per-client keyed
    token buckets in an LRU-bounded table, DAGOR-style priority-aware
    shedding driven by live queue signals, and server retry-pushback
    sizing.  See ``docs/operations.md`` §"Overload & admission"."""

    enabled: bool = True
    # per-client fair limiting; 0 = DISABLED (the unset state — unlike
    # the global [rate_limit] bucket, where 0 is invalid)
    per_client_rpm: int = 0
    per_client_burst: int = 20
    max_clients: int = 1024       # LRU bound on the keyed-bucket table
    # adaptive priority shedding (AIMD on the admission level)
    high_watermark: float = 0.75  # queue utilization that sheds harder
    low_watermark: float = 0.50   # utilization below which we re-admit
    target_queue_wait_ms: float = 50.0  # avg queue_wait that counts as
                                        # overload even at low depth
    adjust_interval_ms: float = 100.0   # signal sampling / AIMD cadence
    increase_step: float = 0.1    # additive level increase per healthy tick
    decrease_factor: float = 0.5  # multiplicative decrease on overload
    # server pushback bounds (cpzk-retry-after-ms trailing metadata)
    retry_after_min_ms: float = 25.0
    retry_after_max_ms: float = 5000.0


@dataclass
class RetrySettings:
    """Client retry knobs (resilience subsystem): exponential backoff with
    full jitter and a shared retry budget, applied by ``AuthClient`` to
    idempotent-safe RPCs only.  ``budget = 0`` disables retries."""

    max_attempts: int = 3
    initial_backoff_ms: float = 50.0
    max_backoff_ms: float = 1000.0
    multiplier: float = 2.0
    budget: float = 10.0       # channel-wide retry tokens
    token_ratio: float = 0.1   # budget refill per success

    def build_policy(self):
        """Resolve to a ``RetryPolicy`` (None when retries are disabled)."""
        from ..resilience.retry import RetryBudget, RetryPolicy

        if self.budget <= 0 or self.max_attempts <= 1:
            return None
        return RetryPolicy(
            max_attempts=self.max_attempts,
            initial_backoff_s=self.initial_backoff_ms / 1000.0,
            max_backoff_s=self.max_backoff_ms / 1000.0,
            multiplier=self.multiplier,
            budget=RetryBudget(tokens=self.budget, token_ratio=self.token_ratio),
        )


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 50051
    # opt-in checkpoint/resume (empty = in-memory only, reference parity)
    state_file: str = ""
    server: ServerSettings = field(default_factory=ServerSettings)
    rate_limit: RateLimitSettings = field(default_factory=RateLimitSettings)
    admission: AdmissionSettings = field(default_factory=AdmissionSettings)
    metrics: MetricsSettings = field(default_factory=MetricsSettings)
    tls: TlsSettings = field(default_factory=TlsSettings)
    tpu: TpuSettings = field(default_factory=TpuSettings)
    retry: RetrySettings = field(default_factory=RetrySettings)
    observability: ObservabilitySettings = field(
        default_factory=ObservabilitySettings
    )
    durability: DurabilitySettings = field(default_factory=DurabilitySettings)
    replication: ReplicationSettings = field(
        default_factory=ReplicationSettings
    )
    audit: AuditSettings = field(default_factory=AuditSettings)
    opsplane: OpsplaneSettings = field(default_factory=OpsplaneSettings)
    slo: SloSettings = field(default_factory=SloSettings)
    fleet: FleetSettings = field(default_factory=FleetSettings)
    controller: ControllerSettings = field(default_factory=ControllerSettings)

    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def fingerprint(self) -> str:
        """Stable 12-hex digest of the fully-resolved config — the
        ``config_fingerprint`` row of the ops plane's ``/statusz``, so an
        operator can tell at a glance whether two boxes (or a box and a
        deploy manifest) are running the same configuration."""
        import dataclasses
        import hashlib
        import json

        doc = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(doc.encode()).hexdigest()[:12]

    # --- loading (config.rs:218-232 precedence) ---

    @classmethod
    def from_env(cls) -> "ServerConfig":
        _load_dotenv()
        cfg = cls()
        config_path = os.environ.get("SERVER_CONFIG_PATH", "config/server.toml")
        if os.path.exists(config_path):
            with open(config_path, "rb") as f:
                cfg._merge_mapping(tomllib.load(f))
        cfg._merge_env()
        return cfg

    def _merge_mapping(self, data: dict) -> None:
        if "host" in data:
            self.host = str(data["host"])
        if "port" in data:
            self.port = int(data["port"])
        if "state_file" in data:
            self.state_file = str(data["state_file"])
        for section, obj in (
            ("server", self.server),
            ("rate_limit", self.rate_limit),
            ("admission", self.admission),
            ("metrics", self.metrics),
            ("tls", self.tls),
            ("tpu", self.tpu),
            ("retry", self.retry),
            ("observability", self.observability),
            ("durability", self.durability),
            ("replication", self.replication),
            ("audit", self.audit),
            ("opsplane", self.opsplane),
            ("slo", self.slo),
            ("fleet", self.fleet),
            ("controller", self.controller),
        ):
            for key, value in data.get(section, {}).items():
                if hasattr(obj, key):
                    setattr(obj, key, type(getattr(obj, key))(value))

    def _merge_env(self) -> None:
        """``SERVER_`` prefix, components split on ``_`` like figment's
        ``Env.prefixed("SERVER_").split("_")`` (nested keys greedy-match the
        known sections, e.g. SERVER_RATE_LIMIT_BURST)."""
        env = os.environ

        def get(name: str) -> str | None:
            return env.get(f"SERVER_{name}")

        def get_alias(primary: str, alias: str) -> str | None:
            # A set-but-empty primary must win over the alias (ADVICE r2:
            # `get(a) or get(b)` treats "" as unset and falls through) —
            # but an empty value means "explicitly unset": it suppresses
            # the alias AND keeps the default, rather than crashing int()
            # (deployment templates render optional vars as empty).
            v = get(primary)
            if v is None:
                v = get(alias)
            return v if v != "" else None

        if (v := get("HOST")) is not None:
            self.host = v
        if (v := get("PORT")) is not None:
            self.port = int(v)
        if (v := get("STATE_FILE")) is not None:
            self.state_file = v
        # transport-plane knobs (native wire path + sharded ingest)
        if (v := get("WIRE")) is not None:
            self.server.wire = v.lower()
        if (v := get("INGEST_SHARDS")) is not None:
            self.server.ingest_shards = int(v)
        if (v := get("MAX_USERS")) is not None:
            self.server.max_users = int(v)
        if (v := get("MAX_CHALLENGES")) is not None:
            self.server.max_challenges = int(v)
        if (v := get("MAX_SESSIONS")) is not None:
            self.server.max_sessions = int(v)
        # short aliases mirror the reference's clap env names
        if (v := get_alias("RATE_LIMIT_REQUESTS_PER_MINUTE", "RATE_LIMIT")) is not None:
            self.rate_limit.requests_per_minute = int(v)
        if (v := get_alias("RATE_LIMIT_BURST", "RATE_BURST")) is not None:
            self.rate_limit.burst = int(v)
        # admission knobs (overload control subsystem)
        if (v := get("ADMISSION_ENABLED")) is not None:
            self.admission.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("ADMISSION_PER_CLIENT_RPM")) is not None:
            self.admission.per_client_rpm = int(v)
        if (v := get("ADMISSION_PER_CLIENT_BURST")) is not None:
            self.admission.per_client_burst = int(v)
        if (v := get("ADMISSION_MAX_CLIENTS")) is not None:
            self.admission.max_clients = int(v)
        if (v := get("ADMISSION_HIGH_WATERMARK")) is not None:
            self.admission.high_watermark = float(v)
        if (v := get("ADMISSION_LOW_WATERMARK")) is not None:
            self.admission.low_watermark = float(v)
        if (v := get("ADMISSION_TARGET_QUEUE_WAIT_MS")) is not None:
            self.admission.target_queue_wait_ms = float(v)
        if (v := get("ADMISSION_ADJUST_INTERVAL_MS")) is not None:
            self.admission.adjust_interval_ms = float(v)
        if (v := get("ADMISSION_INCREASE_STEP")) is not None:
            self.admission.increase_step = float(v)
        if (v := get("ADMISSION_DECREASE_FACTOR")) is not None:
            self.admission.decrease_factor = float(v)
        if (v := get("ADMISSION_RETRY_AFTER_MIN_MS")) is not None:
            self.admission.retry_after_min_ms = float(v)
        if (v := get("ADMISSION_RETRY_AFTER_MAX_MS")) is not None:
            self.admission.retry_after_max_ms = float(v)
        if (v := get_alias("METRICS_ENABLED", "METRICS")) is not None:
            self.metrics.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("METRICS_HOST")) is not None:
            self.metrics.host = v
        if (v := get("METRICS_PORT")) is not None:
            self.metrics.port = int(v)
        if (v := get("TLS_ENABLED")) is not None:
            self.tls.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("TLS_CERT_PATH")) is not None:
            self.tls.cert_path = v
        if (v := get("TLS_KEY_PATH")) is not None:
            self.tls.key_path = v
        if (v := get("TPU_BACKEND")) is not None:
            self.tpu.backend = v.lower()
        if (v := get("TPU_BATCH_MAX")) is not None:
            self.tpu.batch_max = int(v)
        if (v := get("TPU_BATCH_WINDOW_MS")) is not None:
            self.tpu.batch_window_ms = float(v)
        if (v := get("TPU_MESH_DEVICES")) is not None:
            self.tpu.mesh_devices = int(v)
        if (v := get("TPU_LANES")) is not None:
            self.tpu.lanes = int(v)
        if (v := get("TPU_MESH_THRESHOLD")) is not None:
            self.tpu.mesh_threshold = int(v)
        if (v := get("TPU_PIPELINE_DEPTH")) is not None:
            self.tpu.pipeline_depth = int(v)
        if (v := get("TPU_RECOVERY_AFTER_S")) is not None:
            self.tpu.recovery_after_s = float(v)
        if (v := get("TPU_PROBE_BATCH_MAX")) is not None:
            self.tpu.probe_batch_max = int(v)
        if (v := get("TPU_SHED_EXPIRED")) is not None:
            self.tpu.shed_expired = v.lower() in ("1", "true", "yes", "on")
        if (v := get("TPU_PREWARM_QUANTA")) is not None:
            self.tpu.prewarm_quanta = v
        if (v := get("TPU_STREAM_WINDOW")) is not None:
            self.tpu.stream_window = int(v)
        if (v := get("TPU_STREAM_ENTRY_DEADLINE_MS")) is not None:
            self.tpu.stream_entry_deadline_ms = float(v)
        if (v := get("RETRY_MAX_ATTEMPTS")) is not None:
            self.retry.max_attempts = int(v)
        if (v := get("RETRY_INITIAL_BACKOFF_MS")) is not None:
            self.retry.initial_backoff_ms = float(v)
        if (v := get("RETRY_MAX_BACKOFF_MS")) is not None:
            self.retry.max_backoff_ms = float(v)
        if (v := get("RETRY_MULTIPLIER")) is not None:
            self.retry.multiplier = float(v)
        if (v := get("RETRY_BUDGET")) is not None:
            self.retry.budget = float(v)
        if (v := get("RETRY_TOKEN_RATIO")) is not None:
            self.retry.token_ratio = float(v)
        # observability knobs (short OBS_* aliases mirror the section name)
        if (v := get_alias("OBSERVABILITY_JSON_LOGS", "OBS_JSON_LOGS")) is not None:
            self.observability.json_logs = v.lower() in ("1", "true", "yes", "on")
        if (v := get_alias("OBSERVABILITY_SLOW_REQUEST_MS", "OBS_SLOW_REQUEST_MS")) is not None:
            self.observability.slow_request_ms = float(v)
        if (v := get_alias("OBSERVABILITY_TRACE_RING", "OBS_TRACE_RING")) is not None:
            self.observability.trace_ring = int(v)
        if (v := get_alias("OBSERVABILITY_LATENCY_BUCKETS_MS", "OBS_LATENCY_BUCKETS_MS")) is not None:
            self.observability.latency_buckets_ms = v
        if (v := get_alias("OBSERVABILITY_FLIGHT_RING", "OBS_FLIGHT_RING")) is not None:
            self.observability.flight_ring = int(v)
        if (v := get_alias("OBSERVABILITY_COMPILE_STORM_THRESHOLD", "OBS_COMPILE_STORM_THRESHOLD")) is not None:
            self.observability.compile_storm_threshold = int(v)
        # durability knobs (snapshot + write-ahead log)
        if (v := get("DURABILITY_ENABLED")) is not None:
            self.durability.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("DURABILITY_WAL_PATH")) is not None:
            self.durability.wal_path = v
        if (v := get("DURABILITY_FSYNC")) is not None:
            self.durability.fsync = v.lower()
        if (v := get("DURABILITY_FSYNC_INTERVAL_MS")) is not None:
            self.durability.fsync_interval_ms = float(v)
        if (v := get("DURABILITY_COMPACT_BYTES")) is not None:
            self.durability.compact_bytes = int(v)
        if (v := get("DURABILITY_WAL_SEGMENT_BYTES")) is not None:
            self.durability.wal_segment_bytes = int(v)
        # replication knobs (WAL segment shipping + lease-based promotion)
        if (v := get("REPLICATION_ENABLED")) is not None:
            self.replication.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("REPLICATION_ROLE")) is not None:
            self.replication.role = v.lower()
        if (v := get("REPLICATION_PEER")) is not None:
            self.replication.peer = v
        if (v := get("REPLICATION_MODE")) is not None:
            self.replication.mode = v.lower()
        if (v := get("REPLICATION_LEASE_MS")) is not None:
            self.replication.lease_ms = float(v)
        if (v := get("REPLICATION_RENEW_INTERVAL_MS")) is not None:
            self.replication.renew_interval_ms = float(v)
        if (v := get("REPLICATION_SEGMENT_BYTES")) is not None:
            self.replication.segment_bytes = int(v)
        if (v := get("REPLICATION_SYNC_TIMEOUT_MS")) is not None:
            self.replication.sync_timeout_ms = float(v)
        if (v := get("REPLICATION_AUTO_PROMOTE")) is not None:
            self.replication.auto_promote = v.lower() in ("1", "true", "yes", "on")
        if (v := get("REPLICATION_EPOCH_FILE")) is not None:
            self.replication.epoch_file = v
        if (v := get("REPLICATION_SHARDS")) is not None:
            self.replication.shards = int(v)
        if (v := get("REPLICATION_HANDOVER_ON_TERM")) is not None:
            self.replication.handover_on_term = v.lower() in (
                "1", "true", "yes", "on",
            )
        if (v := get("REPLICATION_HANDOVER_TIMEOUT_MS")) is not None:
            self.replication.handover_timeout_ms = float(v)
        # ops plane knobs (HTTP introspection server)
        if (v := get("OPSPLANE_ENABLED")) is not None:
            self.opsplane.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("OPSPLANE_HOST")) is not None:
            self.opsplane.host = v
        if (v := get("OPSPLANE_PORT")) is not None:
            self.opsplane.port = int(v)
        # SLO knobs (burn-rate engine behind the ops plane's /slo)
        if (v := get("SLO_AVAILABILITY_TARGET")) is not None:
            self.slo.availability_target = float(v)
        if (v := get("SLO_LATENCY_MS")) is not None:
            self.slo.latency_ms = v
        if (v := get("SLO_FAST_BURN_THRESHOLD")) is not None:
            self.slo.fast_burn_threshold = float(v)
        if (v := get("SLO_SLOW_BURN_THRESHOLD")) is not None:
            self.slo.slow_burn_threshold = float(v)
        if (v := get("SLO_TICK_INTERVAL_MS")) is not None:
            self.slo.tick_interval_ms = float(v)
        # audit knobs (proof-log trail behind the bulk audit pipeline)
        if (v := get("AUDIT_ENABLED")) is not None:
            self.audit.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("AUDIT_LOG_PATH")) is not None:
            self.audit.log_path = v
        if (v := get("AUDIT_FSYNC")) is not None:
            self.audit.fsync = v.lower()
        if (v := get("AUDIT_FSYNC_INTERVAL_MS")) is not None:
            self.audit.fsync_interval_ms = float(v)
        if (v := get("AUDIT_SEGMENT_BYTES")) is not None:
            self.audit.segment_bytes = int(v)
        # fleet knobs (partition-map routing)
        if (v := get("FLEET_ENABLED")) is not None:
            self.fleet.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("FLEET_MAP_PATH")) is not None:
            self.fleet.map_path = v
        if (v := get("FLEET_PARTITION")) is not None:
            self.fleet.partition = int(v)
        if (v := get("FLEET_ADVERTISE")) is not None:
            self.fleet.advertise = v
        # controller knobs (self-driving fleet control loop)
        if (v := get("CONTROLLER_ENABLED")) is not None:
            self.controller.enabled = v.lower() in ("1", "true", "yes", "on")
        if (v := get("CONTROLLER_TICK_INTERVAL_MS")) is not None:
            self.controller.tick_interval_ms = float(v)
        if (v := get("CONTROLLER_DRY_RUN")) is not None:
            self.controller.dry_run = v.lower() in ("1", "true", "yes", "on")
        if (v := get("CONTROLLER_DECISION_RING")) is not None:
            self.controller.decision_ring = int(v)
        if (v := get("CONTROLLER_ACT_TICKS")) is not None:
            self.controller.act_ticks = int(v)
        if (v := get("CONTROLLER_CLEAR_TICKS")) is not None:
            self.controller.clear_ticks = int(v)
        if (v := get("CONTROLLER_SPLIT_USER_THRESHOLD")) is not None:
            self.controller.split_user_threshold = int(v)
        if (v := get("CONTROLLER_SPLIT_LOCK_WAIT_MS")) is not None:
            self.controller.split_lock_wait_ms = float(v)
        if (v := get("CONTROLLER_SPLIT_TARGET_ADDRESS")) is not None:
            self.controller.split_target_address = v
        if (v := get("CONTROLLER_SPLIT_COOLDOWN_S")) is not None:
            self.controller.split_cooldown_s = float(v)
        if (v := get("CONTROLLER_LANE_OPEN_AFTER_S")) is not None:
            self.controller.lane_open_after_s = float(v)
        if (v := get("CONTROLLER_LANE_COOLDOWN_S")) is not None:
            self.controller.lane_cooldown_s = float(v)
        if (v := get("CONTROLLER_SLO_RPC")) is not None:
            self.controller.slo_rpc = v
        if (v := get("CONTROLLER_ADMISSION_COOLDOWN_S")) is not None:
            self.controller.admission_cooldown_s = float(v)
        if (v := get("CONTROLLER_ERROR_BACKOFF_S")) is not None:
            self.controller.error_backoff_s = float(v)

    # --- validation (config.rs:238-273) ---

    def validate(self) -> None:
        if self.tls.enabled:
            if not self.tls.cert_path:
                raise ValueError("TLS is enabled but cert_path is empty")
            if not self.tls.key_path:
                raise ValueError("TLS is enabled but key_path is empty")
            if not os.path.exists(self.tls.cert_path):
                raise ValueError(
                    f"TLS certificate file does not exist: {self.tls.cert_path}"
                )
            if not os.path.exists(self.tls.key_path):
                raise ValueError(f"TLS key file does not exist: {self.tls.key_path}")
        # the global bucket has no "0 disables" escape hatch: 0 admits
        # nothing, and negatives used to slip through silently and refill
        # the bucket BACKWARDS (satellite fix) — both are now rejected
        if self.rate_limit.requests_per_minute == 0:
            raise ValueError("Rate limit requests_per_minute cannot be zero")
        if self.rate_limit.requests_per_minute < 0:
            raise ValueError("Rate limit requests_per_minute cannot be negative")
        if self.rate_limit.burst == 0:
            raise ValueError("Rate limit burst cannot be zero")
        if self.rate_limit.burst < 0:
            raise ValueError("Rate limit burst cannot be negative")
        # per-client limits: 0 = unset/disabled, negative = error
        if self.admission.per_client_rpm < 0:
            raise ValueError(
                "admission.per_client_rpm cannot be negative "
                "(0 disables per-client limiting)"
            )
        if self.admission.per_client_burst < 1:
            raise ValueError("admission.per_client_burst must be >= 1")
        if self.admission.max_clients < 1:
            raise ValueError("admission.max_clients must be >= 1")
        if not (0.0 < self.admission.low_watermark <= self.admission.high_watermark <= 1.0):
            raise ValueError(
                "admission watermarks must satisfy "
                "0 < low_watermark <= high_watermark <= 1"
            )
        if self.admission.target_queue_wait_ms < 0:
            raise ValueError("admission.target_queue_wait_ms cannot be negative")
        if self.admission.adjust_interval_ms <= 0:
            raise ValueError("admission.adjust_interval_ms must be positive")
        if self.admission.increase_step <= 0:
            raise ValueError("admission.increase_step must be positive")
        if not (0.0 < self.admission.decrease_factor < 1.0):
            raise ValueError("admission.decrease_factor must be in (0, 1)")
        if not (0.0 <= self.admission.retry_after_min_ms
                <= self.admission.retry_after_max_ms):
            raise ValueError(
                "admission retry_after bounds must satisfy "
                "0 <= retry_after_min_ms <= retry_after_max_ms"
            )
        if self.server.wire not in ("native", "python"):
            raise ValueError(
                "server.wire must be 'native' (C++ request parse with "
                "Python fallback) or 'python' (protobuf runtime only)"
            )
        if not 1 <= self.server.ingest_shards <= 64:
            raise ValueError(
                "server.ingest_shards must be in [1, 64] (1 = the "
                "in-process listener)"
            )
        if min(
            self.server.max_users,
            self.server.max_challenges,
            self.server.max_sessions,
        ) < 1:
            raise ValueError(
                "server.max_users/max_challenges/max_sessions must be >= 1"
            )
        if (
            self.server.ingest_shards > 1
            and self.replication.enabled
            and self.replication.role == "standby"
        ):
            raise ValueError(
                "server.ingest_shards > 1 requires replication.role = "
                "'primary': ingest shards proxy only auth + health, and "
                "a standby must receive ShipSegment on its own listener"
            )
        validate_tpu(self.tpu)
        if self.retry.max_attempts < 1:
            raise ValueError("retry.max_attempts must be >= 1")
        if self.retry.initial_backoff_ms < 0 or self.retry.max_backoff_ms < 0:
            raise ValueError("retry backoff bounds cannot be negative")
        if self.retry.multiplier < 1.0:
            raise ValueError("retry.multiplier must be >= 1")
        if self.retry.budget < 0:
            raise ValueError("retry.budget cannot be negative")
        if self.observability.trace_ring < 1:
            raise ValueError("observability.trace_ring must be >= 1")
        if (
            self.observability.slow_request_ms < 0
            and self.observability.slow_request_ms != -1
        ):
            raise ValueError(
                "observability.slow_request_ms must be >= 0, or -1 to disable"
            )
        if self.observability.flight_ring < 1:
            raise ValueError("observability.flight_ring must be >= 1")
        if self.observability.compile_storm_threshold < 1:
            raise ValueError(
                "observability.compile_storm_threshold must be >= 1"
            )
        if self.durability.fsync not in ("always", "interval", "off"):
            raise ValueError(
                "durability.fsync must be one of: always, interval, off"
            )
        if self.durability.fsync_interval_ms <= 0:
            raise ValueError("durability.fsync_interval_ms must be positive")
        if self.durability.compact_bytes < 0:
            raise ValueError("durability.compact_bytes cannot be negative")
        if self.durability.wal_segment_bytes < 0:
            raise ValueError(
                "durability.wal_segment_bytes cannot be negative "
                "(0 = single-file log)"
            )
        if self.durability.enabled and not self.state_file:
            raise ValueError(
                "durability.enabled requires state_file (the snapshot path "
                "the write-ahead log is paired with)"
            )
        if self.replication.role not in ("primary", "standby"):
            raise ValueError(
                "replication.role must be 'primary' or 'standby'"
            )
        if self.replication.mode not in ("async", "sync"):
            raise ValueError("replication.mode must be 'async' or 'sync'")
        if self.replication.renew_interval_ms <= 0:
            raise ValueError("replication.renew_interval_ms must be positive")
        # a lease at or below the renewal cadence guarantees spurious
        # failovers: one delayed renewal and the standby deposes a healthy
        # primary — reject the configuration outright
        if self.replication.lease_ms <= self.replication.renew_interval_ms:
            raise ValueError(
                "replication.lease_ms must be strictly greater than "
                "replication.renew_interval_ms (a lease the renewal "
                "cadence cannot keep alive promotes on every hiccup)"
            )
        if self.replication.segment_bytes < 1:
            raise ValueError("replication.segment_bytes must be positive")
        if self.replication.sync_timeout_ms <= 0:
            raise ValueError("replication.sync_timeout_ms must be positive")
        if self.replication.handover_timeout_ms <= 0:
            raise ValueError(
                "replication.handover_timeout_ms must be positive"
            )
        if not 1 <= self.replication.shards <= 256:
            raise ValueError(
                "replication.shards must be in [1, 256] (the shard tag is "
                "one byte of the challenge id)"
            )
        if self.replication.enabled:
            if not self.durability.enabled:
                raise ValueError(
                    "replication.enabled requires durability.enabled (the "
                    "write-ahead log is what gets shipped)"
                )
            if self.replication.role == "primary" and not self.replication.peer:
                raise ValueError(
                    "replication on the primary requires peer (the "
                    "standby's gRPC address)"
                )
        if not 0 <= self.opsplane.port <= 65535:
            raise ValueError(
                "opsplane.port must be in [0, 65535] (0 = OS-assigned)"
            )
        if self.opsplane.enabled and not self.opsplane.host:
            raise ValueError("opsplane.enabled requires a host to bind")
        if not 0.0 < self.slo.availability_target < 1.0:
            raise ValueError(
                "slo.availability_target must be in (0, 1) — 1.0 leaves "
                "zero error budget and every failure pages"
            )
        if self.slo.fast_burn_threshold <= 0:
            raise ValueError("slo.fast_burn_threshold must be positive")
        if self.slo.slow_burn_threshold <= 0:
            raise ValueError("slo.slow_burn_threshold must be positive")
        if self.slo.tick_interval_ms <= 0:
            raise ValueError("slo.tick_interval_ms must be positive")
        try:
            latency_targets = self.slo.parsed_latency_ms()
        except ValueError:
            raise ValueError(
                "slo.latency_ms must be comma-separated Rpc=ms pairs "
                '(e.g. "VerifyProof=250,Register=100")'
            ) from None
        if any(ms <= 0 for ms in latency_targets.values()):
            raise ValueError("slo.latency_ms targets must be positive")
        if self.audit.fsync not in ("always", "interval", "off"):
            raise ValueError(
                "audit.fsync must be one of: always, interval, off"
            )
        if self.audit.fsync_interval_ms <= 0:
            raise ValueError("audit.fsync_interval_ms must be positive")
        if self.audit.enabled and not self.audit.log_path:
            raise ValueError(
                "audit.enabled requires log_path (where the proof log "
                "is appended)"
            )
        if self.audit.segment_bytes < 0:
            raise ValueError(
                "audit.segment_bytes cannot be negative (0 disables "
                "proof-log rotation)"
            )
        if self.fleet.enabled and not self.fleet.map_path:
            raise ValueError(
                "fleet.enabled requires map_path (the partition-map JSON "
                "every daemon in the fleet shares)"
            )
        if self.fleet.partition < -1:
            raise ValueError(
                "fleet.partition must be a partition index, or -1 to "
                "discover it from the advertise address"
            )
        if self.controller.tick_interval_ms <= 0:
            raise ValueError("controller.tick_interval_ms must be positive")
        if self.controller.decision_ring < 1:
            raise ValueError("controller.decision_ring must be >= 1")
        if self.controller.act_ticks < 1 or self.controller.clear_ticks < 1:
            raise ValueError(
                "controller.act_ticks and controller.clear_ticks must be "
                ">= 1 (the hysteresis windows cannot be empty)"
            )
        if self.controller.split_user_threshold < 0:
            raise ValueError(
                "controller.split_user_threshold cannot be negative "
                "(0 disables the user-count split trigger)"
            )
        if self.controller.split_lock_wait_ms < 0:
            raise ValueError(
                "controller.split_lock_wait_ms cannot be negative "
                "(0 disables the lock-wait split trigger)"
            )
        if min(
            self.controller.split_cooldown_s,
            self.controller.lane_cooldown_s,
            self.controller.admission_cooldown_s,
            self.controller.error_backoff_s,
        ) < 0:
            raise ValueError("controller cooldowns cannot be negative")
        if self.controller.lane_open_after_s <= 0:
            raise ValueError("controller.lane_open_after_s must be positive")
        if not self.controller.slo_rpc:
            raise ValueError(
                "controller.slo_rpc must name the RPC whose burn pages "
                "drive the admission action"
            )
        if (
            self.controller.enabled
            and (
                self.controller.split_user_threshold > 0
                or self.controller.split_lock_wait_ms > 0
            )
            and not self.controller.split_target_address
        ):
            raise ValueError(
                "controller split triggers are armed but "
                "controller.split_target_address is empty (the flipped map "
                "needs an address for the new partition)"
            )
        try:
            buckets = self.observability.parsed_buckets()
        except ValueError:
            raise ValueError(
                "observability.latency_buckets_ms must be a comma-separated "
                "list of numbers"
            ) from None
        if buckets and sorted(buckets) != buckets:
            raise ValueError(
                "observability.latency_buckets_ms must be sorted ascending"
            )


def _load_dotenv() -> None:
    """Minimal ``.env`` loader (dotenvy twin): walks up from cwd, first file
    wins, existing environment variables are never overridden."""
    d = os.getcwd()
    while True:
        path = os.path.join(d, ".env")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("#") or "=" not in line:
                        continue
                    key, _, value = line.partition("=")
                    key = key.strip()
                    value = value.strip().strip("\"'")
                    os.environ.setdefault(key, value)
            return
        parent = os.path.dirname(d)
        if parent == d:
            return
        d = parent


class RateLimitExceeded(Exception):
    """Global-bucket rejection.  ``retry_after_s`` is the time until one
    token refills — the service layer sizes its ``cpzk-retry-after-ms``
    pushback from it (every RESOURCE_EXHAUSTED path carries pushback)."""

    def __init__(self, message: str = "Rate limit exceeded",
                 retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class RateLimiter:
    """Token bucket with fractional refill (config.rs:64-118 twin)."""

    def __init__(self, requests_per_minute: int, burst: int):
        self.rate = requests_per_minute
        self.burst = burst
        self._tokens = float(burst)
        self._last_update = time.monotonic()
        self._lock = asyncio.Lock()

    async def check_rate_limit(self) -> None:
        async with self._lock:
            now = time.monotonic()
            elapsed = now - self._last_update
            self._tokens = min(self._tokens + elapsed * (self.rate / 60.0), float(self.burst))
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self._last_update = now
            else:
                per_s = self.rate / 60.0
                raise RateLimitExceeded(
                    "Rate limit exceeded",
                    retry_after_s=(
                        (1.0 - self._tokens) / per_s if per_s > 0 else 1.0
                    ),
                )
