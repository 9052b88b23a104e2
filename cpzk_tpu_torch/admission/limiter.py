"""Per-client fair admission: keyed token buckets in an LRU-bounded table.

A copy of ``cpzk_tpu/admission/limiter.py``.

The global :class:`~cpzk_tpu_torch.server.config.RateLimiter` treats every
caller as one aggregate, so a single abusive client starves everyone
(DAGOR, SoCC '18, calls this out as the first thing fair overload control
must fix).  :class:`KeyedTokenBuckets` keeps one token bucket per client
key instead — same fractional-refill arithmetic as the global limiter —
bounded by an LRU table so the *keyspace itself* cannot be used for a
memory DoS: an attacker minting fresh keys evicts only least-recently-seen
buckets (each eviction hands the evicted key a fresh burst at its next
request, which is why the global bucket stays on as a backstop).

Client keys come from :func:`client_key`: the ``cpzk-client-id`` gRPC
metadata tag when present (self-identifying clients, and deployments
behind an L7 proxy where the peer address is the proxy), else the gRPC
peer host.  A forged or rotated client-id only moves a caller between
buckets in the LRU-bounded table — it never widens the global bucket.

``requests_per_minute == 0`` means per-client limiting is **disabled**
(the unset state; negative values are rejected by config validation) —
unlike the global ``[rate_limit]`` bucket, where ``0`` is invalid because
a server that admits nothing is a misconfiguration, not a policy.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

#: Metadata tag a client may send to self-identify for fair admission.
CLIENT_ID_KEY = "cpzk-client-id"

#: Keys are truncated to this before entering the table (arbitrary
#: metadata must not become an allocation primitive).
MAX_KEY_LEN = 128


def client_key(context) -> str:
    """Fair-admission key of one RPC: the ``cpzk-client-id`` metadata tag
    when present, else the gRPC peer host (port stripped — one TCP
    connection churn must not mint fresh buckets).  Tolerates hand-rolled
    test contexts without metadata/peer; never raises."""
    try:
        for key, value in context.invocation_metadata() or ():
            if str(key).lower() == CLIENT_ID_KEY:
                if isinstance(value, bytes):
                    value = value.decode("utf-8", "replace")
                return ("id:" + str(value))[:MAX_KEY_LEN]
    except Exception:
        pass
    try:
        peer = str(context.peer() or "")
    except Exception:
        peer = ""
    if not peer:
        return "peer:unknown"
    # "ipv4:1.2.3.4:56789" / "ipv6:[::1]:56789" / "unix:/path" — drop the
    # trailing ephemeral port for the socket families that carry one
    if peer.startswith(("ipv4:", "ipv6:")) and ":" in peer[5:]:
        peer = peer.rsplit(":", 1)[0]
    return ("peer:" + peer)[:MAX_KEY_LEN]


class KeyedTokenBuckets:
    """LRU-bounded table of per-key token buckets.

    :meth:`check` returns ``None`` when the key is admitted and the
    retry-after estimate in seconds (time until one token refills) when
    it is over its rate.  The table holds at most ``max_keys`` buckets;
    the least-recently-*seen* key is evicted first.  Thread-safe (the
    admission controller is also driven from fuzz harnesses and tests
    outside the event loop).
    """

    def __init__(
        self,
        requests_per_minute: int,
        burst: int,
        max_keys: int = 1024,
        clock=time.monotonic,
    ):
        self.rate = max(0, int(requests_per_minute))
        self.burst = max(1, int(burst))
        self.max_keys = max(1, int(max_keys))
        self._clock = clock
        self._lock = threading.Lock()
        # key -> [tokens, last_update]; most-recently-seen at the end
        self._table: OrderedDict[str, list[float]] = OrderedDict()
        self.evictions = 0

    @property
    def enabled(self) -> bool:
        return self.rate > 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    def check(self, key: str, now: float | None = None) -> float | None:
        """Admit (``None``) or reject (retry-after seconds) one request
        from ``key`` at ``now`` (defaults to the injected clock)."""
        if not self.enabled:
            return None
        key = str(key)[:MAX_KEY_LEN]
        if now is None:
            now = self._clock()
        per_s = self.rate / 60.0
        with self._lock:
            bucket = self._table.pop(key, None)
            if bucket is None:
                bucket = [float(self.burst), now]
            self._table[key] = bucket
            while len(self._table) > self.max_keys:
                self._table.popitem(last=False)
                self.evictions += 1
            tokens, last = bucket
            tokens = min(
                tokens + max(0.0, now - last) * per_s, float(self.burst)
            )
            bucket[1] = now
            if tokens >= 1.0:
                bucket[0] = tokens - 1.0
                return None
            bucket[0] = tokens
            return (1.0 - tokens) / per_s
