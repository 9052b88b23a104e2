"""Fleet layer: N-partition routing over the replication plane.

A port of ``cpzk_tpu/fleet/``: one
primary/standby pair scaled out to N partitions behind a versioned
:class:`PartitionMap` — consumed client-side by
:class:`~cpzk_tpu_torch.client.AuthClient`, enforced server-side by the
auth service through :class:`FleetRouter` (wrong-partition RPCs redirect
with the map version + owner address in trailing metadata), served
read-only from the ops plane at ``/partitionmap``, and **grown** by the
live split flow (:mod:`cpzk_tpu_torch.fleet.split`), which moves a hash
range's users to a new partition through the same ``SegmentApplier``
trust boundary promotion already relies on.  The daemon-resident
controller (:mod:`cpzk_tpu_torch.fleet.controller`, ``[controller]``)
closes the loop: it splits a serving partition, drains and re-admits a
sick lane and caps admission from the signals the planes export.

CLI: ``python -m cpzk_tpu_torch.fleet
init|show|route|split|set-standby|rolling-restart``.
"""

from .partition_map import (
    HASH_SPACE,
    PARTITION_MAP_VERSION_KEY,
    PARTITION_OWNER_KEY,
    FleetRouter,
    Partition,
    PartitionMap,
    fetch_partition_map,
    user_hash,
)
from .split import SPLIT_CRASH_POINTS, SplitError, run_split

__all__ = [
    "HASH_SPACE",
    "PARTITION_MAP_VERSION_KEY",
    "PARTITION_OWNER_KEY",
    "SPLIT_CRASH_POINTS",
    "FleetRouter",
    "Partition",
    "PartitionMap",
    "SplitError",
    "fetch_partition_map",
    "run_split",
    "user_hash",
]
