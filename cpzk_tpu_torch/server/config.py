"""The ``[tpu]`` section of the server configuration.

A copy of ``TpuSettings`` (``cpzk_tpu/server/config.py``), field for field,
so one config file serves either package: ``backend = "tpu"`` selects the
device plane, which in this package is the GPU.  :func:`validate_tpu`
carries the ``[tpu]`` checks of the reference's ``ServerConfig.validate``
with its messages.  :class:`RateLimiter` and :class:`RateLimitExceeded`
are the global token bucket the gRPC service admits every RPC through
(``cpzk_tpu/server/config.py:1085-1121``).  The rest of ``ServerConfig``
comes with the port's server daemon.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass


@dataclass
class TpuSettings:
    """Device serving knobs: backend selection, batch-size target, queue
    deadline, lane and mesh shape, plus the resilience knobs (breaker
    recovery, probe sizing, deadline shedding)."""

    backend: str = "cpu"          # "cpu" (inline host verify) | "tpu" (the card)
    batch_max: int = 4096         # dynamic-batcher device batch target
    batch_window_ms: float = 5.0  # queue deadline before dispatch
    mesh_devices: int = 0         # 0 = all visible devices; the port serves
                                  # on one card and refuses more than one
    lanes: int = 1                # per-device dispatch lanes: 1 = one lane;
                                  # -1 = one per local device, k > 1 = the
                                  # first k (not ported yet: refused)
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


class RateLimitExceeded(Exception):
    """Global-bucket rejection.  ``retry_after_s`` is the time until one
    token refills; the service sizes its ``cpzk-retry-after-ms`` pushback
    from it (every RESOURCE_EXHAUSTED path carries pushback)."""

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
