"""Fleet layer: N-partition routing.

So far only the versioned :class:`PartitionMap` (a copy of the
reference's ``cpzk_tpu/fleet/partition_map.py`` up to ``FleetRouter``),
which the client (:class:`~cpzk_tpu_torch.client.AuthClient`) routes by
and whose redirect trailers the auth service names.  The daemon-side
router, the live split and the fleet CLI are not ported yet.
"""

from .partition_map import (
    HASH_SPACE,
    PARTITION_MAP_VERSION_KEY,
    PARTITION_OWNER_KEY,
    Partition,
    PartitionMap,
    fetch_partition_map,
    user_hash,
)

__all__ = [
    "HASH_SPACE",
    "PARTITION_MAP_VERSION_KEY",
    "PARTITION_OWNER_KEY",
    "Partition",
    "PartitionMap",
    "fetch_partition_map",
    "user_hash",
]
