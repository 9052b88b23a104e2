"""DurabilityManager: the snapshot + WAL pair as one serving-stack unit.

A copy of ``cpzk_tpu/durability/manager.py``.
:meth:`DurabilityManager.attach_shipper` is the seam the replication
shipper fills on a ``[replication]`` primary: compaction then stops at
the smaller of the standby's acknowledged offset and the oldest live
challenge's record.

Owns the whole persistence lifecycle the daemon wires up when
``[durability] enabled = true``:

- :meth:`recover` — boot: snapshot load (quarantine-safe), torn-tail
  truncation, WAL-suffix replay, then opens the log for append and
  attaches it to ``ServerState`` as the journal hook;
- :meth:`checkpoint` — each cleanup sweep: snapshot (which embeds the
  covered WAL sequence number), opportunistic interval-policy fsync, and
  log compaction once the WAL outgrows ``compact_bytes``;
- :meth:`close` — graceful shutdown: final snapshot, then truncate the
  fully-covered log so the next boot replays nothing.

Compaction never loses data: the snapshot write captures the WAL byte
offset it covers (under the state lock, so it is exact), and compaction
drops only that prefix — records appended after the snapshot survive the
rename and remain the replay suffix.  Snapshots hold no challenges, so
the port also stops the prefix at the oldest live challenge's
create_challenge record; the reference drops it, and with it every
challenge acknowledged before the compaction (ROADMAP section C).  A
graceful :meth:`close` still truncates the whole log, as the
reference's does: challenges pending at a clean stop end with it.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..observability import get_tracer
from ..server import metrics
from .recovery import RecoveryReport, recover_state
from .wal import WriteAheadLog

log = logging.getLogger("cpzk_tpu_torch.durability")


class DurabilityManager:
    """Wire a :class:`WriteAheadLog` + snapshot pair to a ``ServerState``."""

    def __init__(self, state, settings, state_file: str, faults=None):
        if not state_file:
            raise ValueError("durability requires a state_file")
        self.state = state
        self.settings = settings
        self.state_file = state_file
        self.wal_path = settings.wal_path or state_file + ".wal"
        self.faults = faults
        self.wal: WriteAheadLog | None = None
        self.report: RecoveryReport | None = None
        self.covered_seq = 0
        self._covered_offset = 0
        self._last_snapshot_wall: float | None = None
        # replication coupling (SegmentShipper | None): compaction is
        # clamped to the shipped-and-acknowledged offset so a covering
        # snapshot can never drop records the standby has not received
        self.shipper = None

    def attach_shipper(self, shipper) -> None:
        """Couple a primary-side :class:`SegmentShipper` into the
        compaction path (see ``__init__``)."""
        self.shipper = shipper

    # -- lifecycle -----------------------------------------------------------

    async def recover(self) -> RecoveryReport:
        """Boot-time recovery, then open the WAL for append and attach it
        as the state's journal hook.  Call exactly once, before serving."""
        report = await recover_state(self.state, self.state_file, self.wal_path)
        self.report = report
        self.covered_seq = report.covered_seq
        # Conservative: the byte offset the last snapshot covers inside the
        # (possibly pre-existing) log is unknown until this process writes
        # a snapshot of its own — until then, compaction keeps everything.
        self._covered_offset = 0
        self.wal = WriteAheadLog(
            self.wal_path,
            fsync=self.settings.fsync,
            fsync_interval_ms=self.settings.fsync_interval_ms,
            start_seq=report.next_seq,
            faults=self.faults,
            segment_bytes=getattr(self.settings, "wal_segment_bytes", 0),
        )
        self.state.attach_journal(self.wal)
        return report

    async def checkpoint(self) -> bool:
        """One sweep's persistence work: snapshot when dirty, fsync an
        interval-policy log that is due, compact a log the snapshot now
        mostly covers.  Returns whether a snapshot was written."""
        wrote = await self.state.snapshot(self.state_file)
        if wrote:
            self.covered_seq = self.state.snapshot_covered_seq
            self._covered_offset = self.state.snapshot_covered_offset
            self._last_snapshot_wall = time.time()
        if self.wal is not None and self.wal.needs_sync():
            await asyncio.to_thread(self.wal.sync)
        compact_upto = self._covered_offset
        pin = self.state.oldest_challenge_record()
        if pin is not None and self.wal is not None:
            pin -= self.wal.freed_total  # its logical offset
            if pin < compact_upto:
                # a copy compaction rewrites the tail under the log's
                # lock: stopped short, it runs only where it frees at
                # least as much as it copies
                compact_upto = pin if 2 * pin >= self.wal.size else 0
        held = self._covered_offset - compact_upto
        if self.shipper is not None:
            # never drop bytes the standby has not acknowledged
            compact_upto = min(
                compact_upto, self.shipper.safe_compact_offset()
            )
        due = (
            self.wal is not None
            and self.wal.size > self.settings.compact_bytes
        )
        if due and compact_upto > 0:
            freed = await asyncio.to_thread(self.wal.compact, compact_upto)
            self._covered_offset -= freed
            if self.shipper is not None:
                self.shipper.note_compacted(freed)
            if freed:
                get_tracer().record_event(
                    "wal_compaction",
                    freed_bytes=freed,
                    covered_seq=self.covered_seq,
                    wal_bytes=self.wal.size,
                )
                log.info(
                    "WAL compaction: dropped %d covered bytes (<= seq %d), "
                    "%d bytes remain", freed, self.covered_seq, self.wal.size,
                )
        if due and held:
            log.info(
                "WAL compaction held at the oldest live challenge: %d "
                "covered bytes kept, %d bytes remain", held, self.wal.size,
            )
        self._update_snapshot_age()
        return wrote

    async def close(self) -> None:
        """Graceful shutdown: final snapshot, truncate the fully-covered
        log, release the fd.  After this a reboot restores from the
        snapshot alone and replays nothing."""
        if self.wal is None:
            return
        wrote = await self.state.snapshot(self.state_file)
        if wrote:
            self.covered_seq = self.state.snapshot_covered_seq
            self._covered_offset = self.state.snapshot_covered_offset
            self._last_snapshot_wall = time.time()
        # Clean state means the last snapshot already covers every record
        # (every journaled mutation also dirties the snapshot flag), so
        # covered_seq == wal.seq here on both branches.
        if self.covered_seq == self.wal.seq and self.wal.size > 0:
            upto = self.wal.size
            if self.shipper is not None:
                upto = min(upto, self.shipper.safe_compact_offset())
            if upto > 0:
                freed = await asyncio.to_thread(self.wal.compact, upto)
                if self.shipper is not None:
                    self.shipper.note_compacted(freed)
            self._covered_offset = 0
        await asyncio.to_thread(self.wal.close)
        self._update_snapshot_age()

    # -- inspection ----------------------------------------------------------

    def _update_snapshot_age(self) -> None:
        if self._last_snapshot_wall is not None:
            metrics.gauge("state.snapshot.age_seconds").set(
                max(0.0, time.time() - self._last_snapshot_wall)
            )

    def status(self) -> dict:
        """The admin REPL ``/persist`` payload."""
        wal = self.wal
        return {
            "wal_path": self.wal_path,
            "wal_bytes": wal.size if wal is not None else 0,
            "wal_segments": wal.segment_count if wal is not None else 0,
            "wal_seq": wal.seq if wal is not None else 0,
            "covered_seq": self.covered_seq,
            "pending_appends": wal.pending if wal is not None else 0,
            "fsync_policy": self.settings.fsync,
            "last_fsync_age_s": (
                wal.last_fsync_age_s if wal is not None else float("inf")
            ),
            "snapshot_age_s": (
                time.time() - self._last_snapshot_wall
                if self._last_snapshot_wall is not None
                else None
            ),
        }
