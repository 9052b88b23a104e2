"""Client retry policy: exponential backoff, full jitter, retry budget.

A copy of ``cpzk_tpu/resilience/retry.py``.  It follows the gRPC retry
design (gRFC A6): a per-call attempt cap with exponentially growing
backoff, *full* jitter (each sleep is uniform on ``[0, cap]`` —
decorrelates synchronized client herds after a server blip), and a
channel-wide token budget so a sustained outage can't turn every caller
into a retry storm.  Only status codes that are safe to resend land in
:attr:`RetryPolicy.retryable_codes`; the mapping of *which RPCs* are
idempotent-safe lives with the caller (``VerifyProof`` is never retried
because the server consumes its challenge on first receipt).  The port's
client is not ported yet: ``RetrySettings.build_policy`` builds this
policy, and the service's retry pushback key lives here.

Codes are held as names (``"UNAVAILABLE"``) rather than ``grpc.StatusCode``
members so this module — and everything importing it — works without
grpcio installed.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

#: Codes safe to resend for idempotent RPCs: the server either never saw
#: the request (UNAVAILABLE) or refused before acting on it
#: (RESOURCE_EXHAUSTED: rate limit / shed queue).  DEADLINE_EXCEEDED is
#: deliberately absent — the work may have committed server-side.
DEFAULT_RETRYABLE_CODES = ("UNAVAILABLE", "RESOURCE_EXHAUSTED")

#: Trailing-metadata key for server retry pushback (gRFC A6): the server
#: attaches it to every admission/overload rejection, sized from the
#: current queue drain rate; the client sleeps exactly this long instead
#: of its own jittered backoff.  A negative value means "do not retry".
#: Held here (not in the admission package) so the client side needs
#: neither grpcio nor the server modules to know the key.
RETRY_PUSHBACK_KEY = "cpzk-retry-after-ms"

#: Safety ceiling on honoring server pushback: a buggy or hostile server
#: must not be able to park a client for minutes with one header.
MAX_PUSHBACK_S = 30.0


class RetryBudget:
    """Channel-wide retry token bucket (gRFC A6 ``retryThrottling``).

    Every retry withdraws one token; every success deposits
    ``token_ratio``.  Retries are allowed only while the balance is at
    least one token, so under a long outage the budget drains and callers
    fail fast instead of multiplying load.  Thread-safe: one budget is
    shared across all of a client's concurrent calls.
    """

    def __init__(self, tokens: float = 10.0, token_ratio: float = 0.1):
        if tokens <= 0:
            raise ValueError("retry budget must start positive")
        self._max = float(tokens)
        self._tokens = float(tokens)
        self._ratio = float(token_ratio)
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def try_withdraw(self) -> bool:
        """Take one retry token; False means the budget is exhausted and
        the caller must surface the error instead of retrying."""
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def deposit(self) -> None:
        """Record a success (refills ``token_ratio`` of a token)."""
        with self._lock:
            self._tokens = min(self._max, self._tokens + self._ratio)


@dataclass
class RetryPolicy:
    """Backoff schedule + budget for one client.

    ``max_attempts`` counts the original call (3 = initial + 2 retries).
    Sleep before retry ``k`` (1-based) is uniform on
    ``[0, min(max_backoff_s, initial_backoff_s * multiplier**(k-1))]``.
    """

    max_attempts: int = 3
    initial_backoff_s: float = 0.05
    max_backoff_s: float = 1.0
    multiplier: float = 2.0
    retryable_codes: tuple[str, ...] = DEFAULT_RETRYABLE_CODES
    budget: RetryBudget | None = field(default_factory=RetryBudget)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.initial_backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff bounds cannot be negative")
        if self.multiplier < 1.0:
            raise ValueError("multiplier must be >= 1")

    def backoff_s(self, attempt: int, rng: random.Random | None = None) -> float:
        """Full-jitter sleep before retry ``attempt`` (1-based)."""
        cap = min(
            self.max_backoff_s,
            self.initial_backoff_s * self.multiplier ** max(0, attempt - 1),
        )
        return (rng or random).uniform(0.0, cap)

    def sleep_s(
        self,
        attempt: int,
        pushback_ms: float | None = None,
        rng: random.Random | None = None,
    ) -> float:
        """The sleep before retry ``attempt``: server pushback verbatim
        when present (gRFC A6 — the server knows its queue drain rate,
        the client's jitter schedule does not), capped at
        :data:`MAX_PUSHBACK_S`; otherwise the full-jitter backoff.
        Negative pushback ("do not retry") is the *caller's* decision to
        enforce before sleeping — here it falls back to jitter."""
        if pushback_ms is not None and pushback_ms >= 0:
            return min(MAX_PUSHBACK_S, pushback_ms / 1000.0)
        return self.backoff_s(attempt, rng)

    def should_retry(self, code_name: str, attempt: int) -> bool:
        """Policy decision for a failed attempt (1-based): code retryable,
        attempts remaining, and a budget token available (withdrawn here)."""
        if code_name not in self.retryable_codes:
            return False
        if attempt >= self.max_attempts:
            return False
        if self.budget is not None and not self.budget.try_withdraw():
            return False
        return True

    def note_success(self) -> None:
        if self.budget is not None:
            self.budget.deposit()
