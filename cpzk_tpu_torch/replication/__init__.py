"""Replicated server state: WAL segment shipping to a warm standby and
lease-based promotion, built on the durability subsystem and the sharded
:class:`~cpzk_tpu_torch.server.state.ServerState`.

A port of ``cpzk_tpu/replication/``: the segments, the messages and the
protocol are the reference's, so a primary of either package ships to a
standby of the other.  On the port's daemon both roles serve the card: a
standby builds and prewarms its ``TorchBackend`` at boot, so a promotion
pays no kernel load.

- :mod:`.segments` — sealed, CRC-checked WAL slices (the shipping unit);
- :mod:`.shipper` — primary side: tail-follow the WAL, ship segments,
  renew the lease, sync-mode acknowledgement barrier, fencing detection;
- :mod:`.standby` — standby side: validate + replay through the
  ``replay_journal_record`` trust boundary, lease watch, promotion,
  epoch fencing;
- :mod:`.wire` — hand-wired gRPC plumbing for ``proto/replication.proto``.

The reference's ``docs/operations.md`` §"Replication & failover" has the
topology, the promotion runbook and the loss-window table; they hold for
the port unchanged.
"""

from .segments import Segment, seal_segment, split_records, validate_segment
from .shipper import HandoverError, ReplicationTimeout, SegmentShipper
from .standby import SegmentApplier, StandbyReplica, load_epoch, store_epoch

__all__ = [
    "Segment",
    "seal_segment",
    "split_records",
    "validate_segment",
    "SegmentShipper",
    "ReplicationTimeout",
    "HandoverError",
    "SegmentApplier",
    "StandbyReplica",
    "load_epoch",
    "store_epoch",
]
