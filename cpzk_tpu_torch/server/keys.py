"""The few symbols of the reference's fleet and audit packages that the
gRPC service needs, copied here until those packages are ported.

The service (``server/service.py``) reads these from two packages the port
does not have yet: the partitioned fleet and the proof log.  Each symbol
is copied letter for letter from its source, named beside it; the packages
themselves come with the host control plane, which moves the symbols back
to their homes (the admission and retry symbols already live in
:mod:`cpzk_tpu_torch.admission` and :mod:`cpzk_tpu_torch.resilience.retry`).
"""

from __future__ import annotations

import time

#: Trailing-metadata keys of the wrong-partition redirect contract: the
#: map version tells the client why (its map is stale or the server's is),
#: the owner is the address to re-route to under the server's map.
#: (``cpzk_tpu/fleet/partition_map.py:75-76``)
PARTITION_MAP_VERSION_KEY = "cpzk-partition-map-version"
PARTITION_OWNER_KEY = "cpzk-partition-owner"


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
