"""The few symbols of the reference's host control plane that the gRPC
service needs, copied here until their packages are ported.

The service (``server/service.py``) reads these from four packages the
port does not have yet: admission, retry, fleet and audit.  Each symbol is
copied letter for letter from its source, named beside it; the packages
themselves (admission control, client retries, the partitioned fleet, the
proof log) come with the host control plane, which moves the symbols back
to their homes.
"""

from __future__ import annotations

import time

#: Trailing-metadata key for server retry pushback (gRFC A6): the server
#: attaches it to every admission/overload rejection; the client sleeps
#: exactly this long instead of its own jittered backoff.  A negative
#: value means "do not retry".  (``cpzk_tpu/resilience/retry.py:36``)
RETRY_PUSHBACK_KEY = "cpzk-retry-after-ms"

#: Trailing-metadata keys of the wrong-partition redirect contract: the
#: map version tells the client why (its map is stale or the server's is),
#: the owner is the address to re-route to under the server's map.
#: (``cpzk_tpu/fleet/partition_map.py:75-76``)
PARTITION_MAP_VERSION_KEY = "cpzk-partition-map-version"
PARTITION_OWNER_KEY = "cpzk-partition-owner"

#: Metadata tag a client may send to self-identify for fair admission.
#: (``cpzk_tpu/admission/limiter.py:32``)
CLIENT_ID_KEY = "cpzk-client-id"

#: Keys are truncated to this before entering the admission table
#: (arbitrary metadata must not become an allocation primitive).
MAX_KEY_LEN = 128


def client_key(context) -> str:
    """Fair-admission key of one RPC: the ``cpzk-client-id`` metadata tag
    when present, else the gRPC peer host (port stripped: one TCP
    connection churn must not mint fresh buckets).  Tolerates hand-rolled
    test contexts without metadata/peer; never raises.
    (``cpzk_tpu/admission/limiter.py:39``)"""
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
    # "ipv4:1.2.3.4:56789" / "ipv6:[::1]:56789" / "unix:/path": drop the
    # trailing ephemeral port for the socket families that carry one
    if peer.startswith(("ipv4:", "ipv6:")) and ":" in peer[5:]:
        peer = peer.rsplit(":", 1)[0]
    return ("peer:" + peer)[:MAX_KEY_LEN]


def proof_record(
    user_id: str,
    y1: bytes,
    y2: bytes,
    context: bytes,
    proof_wire: bytes,
    verdict: bool,
    now: int | None = None,
) -> dict:
    """One proof-log payload (everything but ``seq``, which the log writer
    assigns under its lock).  (``cpzk_tpu/audit/log.py:68``)"""
    return {
        "u": user_id,
        "y1": y1.hex(),
        "y2": y2.hex(),
        "ctx": context.hex(),
        "p": proof_wire.hex(),
        "v": 1 if verdict else 0,
        "t": int(time.time()) if now is None else int(now),
    }
