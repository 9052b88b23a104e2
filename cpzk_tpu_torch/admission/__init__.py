"""Adaptive overload control: per-client fair admission, priority-aware
shedding, and server retry-pushback.

A copy of ``cpzk_tpu/admission/``; the daemon builds it by default
(``[admission] enabled = true``, as the reference does).

The admission subsystem sits in front of every RPC handler:

- :mod:`.limiter` — :class:`KeyedTokenBuckets`, per-client token buckets
  in an LRU-bounded table (key = ``cpzk-client-id`` metadata tag, else
  gRPC peer host), so one abusive client exhausts its own bucket instead
  of the global one;
- :mod:`.controller` — :class:`AdmissionController`, DAGOR-style AIMD
  priority shedding driven by live batcher queue depth and ``queue_wait``
  stage latency, plus :meth:`~AdmissionController.retry_after_s` pushback
  sizing from the queue drain rate.

The service layer attaches every rejection's pushback as
``cpzk-retry-after-ms`` trailing metadata; the client-side
:class:`~cpzk_tpu_torch.resilience.retry.RetryPolicy` prefers that pushback
over its own jittered backoff (gRFC A6 semantics).  See
``docs/operations.md`` §"Overload & admission".
"""

from __future__ import annotations

from .controller import (
    MIN_LEVEL,
    N_TIERS,
    RETRY_PUSHBACK_KEY,
    TIER_CHALLENGE,
    TIER_NAMES,
    TIER_REGISTER,
    TIER_VERIFY,
    AdmissionController,
    Rejection,
    classify,
)
from .limiter import CLIENT_ID_KEY, KeyedTokenBuckets, client_key

__all__ = [
    "AdmissionController",
    "CLIENT_ID_KEY",
    "KeyedTokenBuckets",
    "MIN_LEVEL",
    "N_TIERS",
    "RETRY_PUSHBACK_KEY",
    "Rejection",
    "TIER_CHALLENGE",
    "TIER_NAMES",
    "TIER_REGISTER",
    "TIER_VERIFY",
    "classify",
    "client_key",
]
