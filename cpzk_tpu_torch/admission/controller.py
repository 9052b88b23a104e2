"""Priority-aware adaptive admission control (DAGOR-style).

A copy of ``cpzk_tpu/admission/controller.py`` on the port's own metrics:
the load signals it reads (``tpu.batch.queue_wait``, the ``admission.*``
families) live in the port's ``PROM_REGISTRY``, which the port's batcher
writes, never in prometheus_client's default registry.

The serving plane already measures its own load — batcher queue depth and
in-flight count (``server/batching.py``) and the per-entry ``queue_wait``
stage latency (observability subsystem).  :class:`AdmissionController`
turns those live signals into an **admission level**: a float in
``[1.0, N_TIERS]`` where an RPC of priority tier ``t`` is admitted iff
``t < level``.  The level moves by AIMD — multiplicative decrease on an
overload signal (queue utilization above ``high_watermark`` or average
queue wait above ``target_queue_wait_ms``), additive increase while
healthy — so the lowest-priority tiers shed first and re-admit last,
instead of today's all-or-nothing "Server overloaded" abort.

Priority tiers (lower = more important):

- tier 0 ``verify`` — ``VerifyProof`` / ``VerifyProofBatch``: an
  in-flight login; its challenge is already consumed, so shedding it
  wastes work the user cannot retry.
- tier 1 ``challenge`` — ``CreateAuthenticationChallenge``: starts a
  login; cheap, but shedding it merely delays the login.
- tier 2 ``register`` — ``Register`` / ``RegisterBatch``: the deferrable
  tier; registrations retry cleanly.

The level floor is 1.0: the adaptive tier never sheds ``verify`` —
extreme overload still reaches VerifyProof only through the per-client
buckets, the global bucket, and batcher backpressure, all of which answer
with pushback.  This is also what makes the acceptance invariant ("no
VerifyProof rejected while lower tiers are still admitted") structural
rather than tuned.

Every rejection carries a ``retry_after_s`` sized from the batcher's
current queue depth and observed drain rate, which the service layer
attaches as ``cpzk-retry-after-ms`` trailing metadata (gRFC A6 server
pushback) and the client retry policy honors in place of its own jitter.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..resilience.retry import RETRY_PUSHBACK_KEY  # noqa: F401  (re-export)
from ..server import metrics
from .limiter import KeyedTokenBuckets

#: Priority tiers, lowest number = most important.
TIER_VERIFY = 0
TIER_CHALLENGE = 1
TIER_REGISTER = 2
N_TIERS = 3

TIER_NAMES = {TIER_VERIFY: "verify", TIER_CHALLENGE: "challenge",
              TIER_REGISTER: "register"}

_RPC_TIERS = {
    "VerifyProof": TIER_VERIFY,
    "VerifyProofBatch": TIER_VERIFY,
    "CreateChallenge": TIER_CHALLENGE,
    "Register": TIER_REGISTER,
    "RegisterBatch": TIER_REGISTER,
}

#: The adaptive level never drops below this: tier-0 RPCs are exempt from
#: priority shedding (see module docstring).
MIN_LEVEL = 1.0


def classify(rpc) -> int:
    """Priority tier of an RPC name.  Total over arbitrary input (the
    fuzz invariant): unknown or non-string names land in the lowest
    priority tier rather than raising."""
    try:
        return _RPC_TIERS.get(str(rpc), TIER_REGISTER)
    except Exception:
        return TIER_REGISTER


@dataclass
class Rejection:
    """One shed decision: why, the status message, and the pushback."""

    reason: str  # "per_client" | "priority"
    message: str
    retry_after_s: float
    tier: int


class AdmissionController:
    """Keyed fair limiting + adaptive priority shedding + pushback sizing.

    ``batcher`` (a :class:`~cpzk_tpu_torch.server.batching.DynamicBatcher`, or
    None on the inline CPU path) supplies the live load signals and the
    drain rate behind :meth:`retry_after_s`.  ``clock`` and ``signals``
    are injectable for deterministic tests: ``signals()`` must return
    ``(queue_utilization, avg_queue_wait_s)``.
    """

    def __init__(self, settings, batcher=None, clock=time.monotonic,
                 signals=None):
        self.settings = settings
        self.batcher = batcher
        self._clock = clock
        self._signals = signals
        self.buckets = KeyedTokenBuckets(
            settings.per_client_rpm,
            settings.per_client_burst,
            max_keys=settings.max_clients,
            clock=clock,
        )
        self.level = float(N_TIERS)  # boot admitting everything
        self.level_cap = float(N_TIERS)  # fleet-controller bias: the AIMD
                                         # level can recover only up to
                                         # this while an SLO burn page is
                                         # shedding load ahead of cascade
        self._lock = threading.Lock()
        self._last_adjust = clock()
        self._last_wait_count, self._last_wait_sum = metrics.read_histogram(
            "tpu.batch.queue_wait"
        )
        self._last_util = 0.0
        self._last_wait_s = 0.0
        self._last_shed_event = 0.0
        metrics.gauge("admission.level").set(self.level)

    # -- load signals -------------------------------------------------------

    def _read_signals(self) -> tuple[float, float]:
        """(queue utilization in [0,1], avg queue_wait seconds since the
        last adjustment) from the injected provider or the live batcher +
        stage-latency histogram."""
        if self._signals is not None:
            return self._signals()
        util = 0.0
        if self.batcher is not None:
            depth, capacity = self.batcher.load_snapshot()
            util = depth / capacity if capacity > 0 else 0.0
        count, total = metrics.read_histogram("tpu.batch.queue_wait")
        d_count = count - self._last_wait_count
        d_sum = total - self._last_wait_sum
        self._last_wait_count, self._last_wait_sum = count, total
        wait = d_sum / d_count if d_count > 0 else 0.0
        return util, wait

    def _maybe_adjust(self, now: float) -> None:
        s = self.settings
        with self._lock:
            if now - self._last_adjust < s.adjust_interval_ms / 1000.0:
                return
            self._last_adjust = now
            util, wait = self._read_signals()
            self._last_util, self._last_wait_s = util, wait
            overloaded = (
                util >= s.high_watermark
                or wait * 1000.0 >= s.target_queue_wait_ms
            )
            healthy = (
                util <= s.low_watermark
                and wait * 1000.0 < s.target_queue_wait_ms
            )
            old = self.level
            if overloaded:
                self.level = max(MIN_LEVEL, self.level * s.decrease_factor)
            elif healthy:
                self.level = min(float(N_TIERS), self.level + s.increase_step)
            self.level = min(self.level, self.level_cap)
            changed = self.level != old
        if changed:
            metrics.gauge("admission.level").set(self.level)
            from ..observability import get_tracer

            get_tracer().record_event(
                "admission_level",
                old=round(old, 3), new=round(self.level, 3),
                utilization=round(util, 3),
                queue_wait_ms=round(wait * 1000.0, 3),
            )

    def set_level_cap(self, cap: float) -> float:
        """Clamp the admission level's recovery ceiling (the fleet
        controller's burn-page actuator).  The cap itself is clamped to
        ``[MIN_LEVEL, N_TIERS]`` — the controller can never bias tier-0
        logins out — and an already-higher level drops to it immediately.
        Returns the applied cap."""
        cap = min(float(N_TIERS), max(MIN_LEVEL, float(cap)))
        with self._lock:
            self.level_cap = cap
            old = self.level
            self.level = min(self.level, cap)
            changed = self.level != old
        if changed:
            metrics.gauge("admission.level").set(self.level)
        return cap

    # -- admission ----------------------------------------------------------

    def admit(self, rpc: str, key: str) -> Rejection | None:
        """One admission decision: ``None`` admits; a :class:`Rejection`
        tells the service layer what to shed with.  Never raises on
        arbitrary ``rpc``/``key`` input (fuzz invariant)."""
        now = self._clock()
        self._maybe_adjust(now)
        tier = classify(rpc)
        retry_after = self.buckets.check(key, now=now)
        metrics.gauge("admission.clients").set(len(self.buckets))
        if retry_after is not None:
            metrics.counter("admission.shed.per_client").inc()
            self._shed_event(now, rpc, tier, "per_client", key)
            return Rejection(
                reason="per_client",
                message="Per-client rate limit exceeded",
                retry_after_s=self._clamp(retry_after),
                tier=tier,
            )
        if tier >= self.level:
            metrics.counter("admission.shed.priority").inc()
            self._shed_event(now, rpc, tier, "priority", key)
            return Rejection(
                reason="priority",
                message=(
                    "Server overloaded: shedding "
                    f"{TIER_NAMES.get(tier, tier)}-tier requests"
                ),
                retry_after_s=self.retry_after_s(),
                tier=tier,
            )
        metrics.counter("admission.admitted").inc()
        return None

    # -- pushback -----------------------------------------------------------

    def _clamp(self, seconds: float) -> float:
        s = self.settings
        return min(
            s.retry_after_max_ms / 1000.0,
            max(s.retry_after_min_ms / 1000.0, seconds),
        )

    def retry_after_s(self) -> float:
        """Server pushback sized from the current queue drain rate: how
        long until the backlog ahead of a retry would clear.  Falls back
        to one batch window's worth of wait when no drain has been
        observed yet, and to the configured minimum off the batched
        path."""
        batcher = self.batcher
        if batcher is None:
            return self._clamp(0.0)
        depth, _ = batcher.load_snapshot()
        rate = batcher.drain_rate()
        if rate > 0.0:
            return self._clamp(depth / rate)
        est = batcher.window * (1.0 + depth / max(1, batcher.max_batch))
        return self._clamp(est)

    # -- observability ------------------------------------------------------

    def _shed_event(self, now, rpc, tier, reason, key) -> None:
        """Shed events land in the trace ring, rate-limited to one per
        adjust interval so an overload storm cannot evict every real
        trace from the ring."""
        interval = self.settings.adjust_interval_ms / 1000.0
        with self._lock:
            if now - self._last_shed_event < interval:
                return
            self._last_shed_event = now
        from ..observability import get_tracer

        get_tracer().record_event(
            "admission_shed",
            rpc=str(rpc)[:64], tier=tier, reason=reason, key=str(key)[:64],
            level=round(self.level, 3),
        )

    def snapshot(self) -> dict:
        """Operator view behind the REPL ``/overload``."""
        depth, capacity, rate = 0, 0, 0.0
        if self.batcher is not None:
            depth, capacity = self.batcher.load_snapshot()
            rate = self.batcher.drain_rate()
        admitted_tiers = [
            TIER_NAMES[t] for t in range(N_TIERS) if t < self.level
        ]
        return {
            "level": self.level,
            "level_cap": self.level_cap,
            "admitted_tiers": admitted_tiers,
            "clients": len(self.buckets),
            "max_clients": self.buckets.max_keys,
            "evictions": self.buckets.evictions,
            "per_client_rpm": self.buckets.rate,
            "queue_depth": depth,
            "queue_capacity": capacity,
            "drain_rate": rate,
            "retry_after_ms": self.retry_after_s() * 1000.0,
            "utilization": self._last_util,
            "queue_wait_ms": self._last_wait_s * 1000.0,
            "shed_per_client": metrics.read("admission.shed.per_client"),
            "shed_priority": metrics.read("admission.shed.priority"),
            "shed_global": metrics.read("admission.shed.global"),
            "admitted": metrics.read("admission.admitted"),
        }
