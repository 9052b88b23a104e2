"""Circuit breaker with half-open probe recovery.

A copy of ``cpzk_tpu/resilience/breaker.py`` (the port imports nothing of
the JAX package).

State machine (the classic Nygard breaker, specialized for a primary/
fallback verifier pair where the fallback is *always* correct, just slow):

    CLOSED ──failure──▶ OPEN ──recovery_after_s──▶ HALF_OPEN
       ▲                  ▲                            │
       │                  └───────probe failed─────────┤
       └────────────────probe succeeded────────────────┘

- CLOSED: traffic routes to the primary (the GPU backend).
- OPEN: traffic routes to the fallback; after ``recovery_after_s`` the
  next caller is granted a single *probe* and the breaker moves to
  HALF_OPEN.
- HALF_OPEN: exactly one probe is in flight; everyone else stays on the
  fallback.  The probe's outcome (decided by the caller — for verifier
  backends, primary output compared against fallback ground truth)
  either re-closes the breaker or re-opens it and restarts the timer.

Thread-safety: the serving layer's pipelined batcher calls backends from
multiple worker threads; every transition is lock-guarded and the probe
token is handed to exactly one caller.

The breaker knows nothing about verifiers — it is a generic routing/
bookkeeping core (see ``FailoverBackend`` for the verifier policy on top).
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Callable


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"


#: Routing decisions handed out by :meth:`CircuitBreaker.acquire`.
ROUTE_PRIMARY = "primary"
ROUTE_PROBE = "probe"
ROUTE_FALLBACK = "fallback"


class CircuitBreaker:
    """Generic three-state breaker; see module docstring for semantics.

    ``recovery_after_s=None`` disables self-healing entirely (the breaker
    stays OPEN until :meth:`reset` — the legacy permanent-degradation
    behavior).  ``clock`` is injectable for deterministic tests.
    ``on_transition(old, new)`` fires outside the lock, at most once per
    actual state change — metrics/log hooks can't miss or double-count.
    """

    def __init__(
        self,
        recovery_after_s: float | None = 30.0,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Callable[[BreakerState, BreakerState], None] | None = None,
    ):
        if recovery_after_s is not None and recovery_after_s < 0:
            raise ValueError("recovery_after_s cannot be negative")
        self.recovery_after_s = recovery_after_s
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = BreakerState.CLOSED
        self._opened_at = 0.0  # clock time of the most recent -> OPEN
        self._degraded_since: float | None = None  # clock time we left CLOSED
        self._degraded_total = 0.0  # cumulative seconds spent non-CLOSED

    # -- observability -----------------------------------------------------

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    @property
    def degraded_seconds(self) -> float:
        """Cumulative wall seconds spent outside CLOSED (live-updating
        while degraded) — the ``tpu.backend.degraded_seconds`` gauge."""
        with self._lock:
            total = self._degraded_total
            if self._degraded_since is not None:
                total += max(0.0, self._clock() - self._degraded_since)
            return total

    # -- routing -----------------------------------------------------------

    def acquire(self) -> str:
        """Route one unit of work: ``"primary"`` (CLOSED), ``"probe"``
        (granted to exactly one caller once the OPEN cooldown elapses,
        transitioning to HALF_OPEN), or ``"fallback"``."""
        transition = None
        with self._lock:
            if self._state is BreakerState.CLOSED:
                return ROUTE_PRIMARY
            if (
                self._state is BreakerState.OPEN
                and self.recovery_after_s is not None
                and self._clock() - self._opened_at >= self.recovery_after_s
            ):
                transition = (self._state, BreakerState.HALF_OPEN)
                self._state = BreakerState.HALF_OPEN
        if transition is not None:
            self._fire(*transition)
            return ROUTE_PROBE
        return ROUTE_FALLBACK

    # -- outcomes ----------------------------------------------------------

    def record_failure(self) -> bool:
        """Primary failed on the CLOSED path.  Returns True for the caller
        that performed the CLOSED→OPEN transition (log/count exactly once
        even when pipelined batches fail concurrently)."""
        with self._lock:
            if self._state is not BreakerState.CLOSED:
                return False
            self._state = BreakerState.OPEN
            self._opened_at = self._clock()
            self._degraded_since = self._clock()
        self._fire(BreakerState.CLOSED, BreakerState.OPEN)
        return True

    def probe_succeeded(self) -> None:
        """HALF_OPEN probe matched ground truth: re-close."""
        with self._lock:
            if self._state is not BreakerState.HALF_OPEN:
                return
            self._state = BreakerState.CLOSED
            self._settle_degraded_locked()
        self._fire(BreakerState.HALF_OPEN, BreakerState.CLOSED)

    def probe_failed(self) -> None:
        """HALF_OPEN probe raised or disagreed: re-open, restart cooldown."""
        with self._lock:
            if self._state is not BreakerState.HALF_OPEN:
                return
            self._state = BreakerState.OPEN
            self._opened_at = self._clock()
        self._fire(BreakerState.HALF_OPEN, BreakerState.OPEN)

    def release_probe(self) -> None:
        """Hand an unused probe back (the caller couldn't evaluate it, e.g.
        the work unit wasn't probe-shaped): back to OPEN with the original
        cooldown timestamp, so the *next* caller probes immediately."""
        with self._lock:
            if self._state is not BreakerState.HALF_OPEN:
                return
            self._state = BreakerState.OPEN
            # _opened_at deliberately untouched: cooldown already served

    def reset(self) -> None:
        """Operator re-arm: back to CLOSED regardless of state."""
        with self._lock:
            old = self._state
            if old is BreakerState.CLOSED:
                return
            self._state = BreakerState.CLOSED
            self._settle_degraded_locked()
        self._fire(old, BreakerState.CLOSED)

    # -- internals ---------------------------------------------------------

    def _settle_degraded_locked(self) -> None:
        if self._degraded_since is not None:
            self._degraded_total += max(0.0, self._clock() - self._degraded_since)
            self._degraded_since = None

    def _fire(self, old: BreakerState, new: BreakerState) -> None:
        if self._on_transition is not None and old is not new:
            self._on_transition(old, new)
