"""Warm standby: segment receipt, replay, lease watch, promotion.

A copy of ``cpzk_tpu/replication/standby.py``; shipped proof-log segments
are stored under the names of the port's ``audit/log.py``.  One departure:
given the standby's own proof-log writer (``audit_log``), a promotion
moves its numbering past the segments shipped in (under the apply lock,
which audit shipments take too), so the promoted node's records continue
the primary's trail; the reference's writer keeps the seq it opened at.

Two layers:

- :class:`SegmentApplier` — the pure trust boundary: validates one
  :class:`~cpzk_tpu_torch.replication.segments.Segment` (epoch fencing, CRC,
  clean parse, contiguity with the applied prefix) and replays its new
  records through ``ServerState.replay_journal_record`` — the same
  validators a boot-time recovery uses, so a hostile primary cannot
  smuggle in what the live RPC would reject.  No gRPC, no disk (the disk
  write goes through an injectable sink); the fuzz harness drives this
  class directly with duplicated/reordered/truncated/cross-epoch
  deliveries and holds "never raises, prefix-stable" as invariants.

- :class:`StandbyReplica` — the serving wrapper: the ReplicationService
  gRPC handlers, durable frame persistence into the standby's own WAL
  (primary sequence numbers preserved via ``append_frames``), the lease
  clock (armed at first contact, renewed by every accepted ShipSegment /
  ReplicationStatus from an equal-or-higher epoch), and lease-based
  promotion — truncate the torn tail, finish replay, bump + persist the
  epoch, flip the readiness gate, and fence the deposed primary.
"""

from __future__ import annotations

import asyncio
import logging
import os
import tempfile
import time

from ..durability.wal import encode_record, iter_frames
from ..observability import get_tracer
from ..server import metrics
from .segments import Segment, validate_segment
from .wire import load_replication_pb2, make_replication_handler

log = logging.getLogger("cpzk_tpu_torch.replication")


def load_epoch(path: str) -> int:
    """The persisted fencing epoch at ``path`` (1 when absent/garbage —
    epoch 1 is the first primary's epoch, so a fresh pair agrees)."""
    try:
        with open(path, encoding="utf-8") as f:
            return max(1, int(f.read().strip()))
    except (OSError, ValueError):
        return 1


def store_epoch(path: str, epoch: int) -> None:
    """Durably persist the fencing epoch (tmp + fsync + atomic rename,
    0600): a rebooted deposed primary must come back fenced, not amnesiac."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".tmp.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(str(int(epoch)))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class SegmentApplier:
    """Validate-and-replay for shipped WAL segments (see module docstring).

    ``sink`` (optional) is called as ``sink(frames, last_seq)`` with the
    canonical re-encoded frames of exactly the NEW records before they are
    applied — the durable-before-apply ordering the standby's WAL needs.
    """

    def __init__(self, state, epoch: int = 1, applied_seq: int = 0, sink=None):
        self.state = state
        self.epoch = epoch
        self.applied_seq = applied_seq
        self.sink = sink
        self.segments_received = 0
        self.segments_rejected = 0
        self.records_applied = 0
        self.records_skipped = 0
        self.fenced = 0
        self.lag_records = 0

    # -- the two-phase apply (prepare is pure; commit mutates state) -------

    def prepare(self, seg: Segment) -> tuple[bool, str, list[dict]]:
        """``(accepted, message, new_records)`` for one delivery.  Never
        raises.  ``accepted`` with an empty record list is an idempotent
        duplicate; a rejection names its reason and changes nothing."""
        self.segments_received += 1
        try:
            epoch = int(seg.epoch)
        except (TypeError, ValueError):
            epoch = -1
        if epoch < self.epoch:
            self.fenced += 1
            metrics.counter("state.repl.fenced").inc()
            return (
                False,
                f"fenced: stale epoch {epoch} < {self.epoch}",
                [],
            )
        records, err = validate_segment(seg)
        if err is not None:
            self.segments_rejected += 1
            return False, f"rejected: {err}", []
        if epoch > self.epoch:
            # a newer primary exists (our own epoch file lags a promotion
            # elsewhere): adopt its epoch so older senders fence correctly
            self.epoch = epoch
        if int(seg.last_seq) <= self.applied_seq:
            return True, "duplicate (already applied)", []
        if int(seg.first_seq) > self.applied_seq + 1:
            self.segments_rejected += 1
            return (
                False,
                f"gap: first_seq {seg.first_seq} > applied {self.applied_seq} + 1",
                [],
            )
        new = [r for r in records if r["seq"] > self.applied_seq]
        return True, "", new

    def commit(self, new_records: list[dict]) -> None:
        """Apply prepared records through the replay trust boundary and
        advance the applied watermark.  Invalid records are skipped and
        counted, never applied and never fatal — identical to boot-time
        recovery."""
        for rec in new_records:
            msg = self.state.replay_journal_record(rec)
            if msg is None:
                self.records_applied += 1
            else:
                self.records_skipped += 1
                log.warning(
                    "segment replay skipped seq %d (%s): %s",
                    rec["seq"], rec.get("type"), msg,
                )
            self.applied_seq = int(rec["seq"])
        metrics.gauge("state.repl.applied_seq").set(float(self.applied_seq))

    def apply(self, seg: Segment) -> tuple[bool, str]:
        """One-shot prepare + sink + commit (the synchronous path the fuzz
        harness and in-process tests drive)."""
        accepted, message, new = self.prepare(seg)
        if accepted and new:
            if self.sink is not None:
                frames = b"".join(encode_record(r) for r in new)
                self.sink(frames, int(new[-1]["seq"]))
            self.commit(new)
            message = f"applied {len(new)} records"
        return accepted, message

    def note_primary_seq(self, primary_seq: int) -> None:
        """Update lag accounting from the sender's advertised WAL head."""
        if primary_seq > 0:
            self.lag_records = max(0, int(primary_seq) - self.applied_seq)
            metrics.gauge("state.repl.lag_records").set(float(self.lag_records))


class StandbyReplica:
    """The standby node's replication plane (see module docstring).

    ``manager`` is the standby's own started
    :class:`~cpzk_tpu_torch.durability.DurabilityManager` (``recover()`` already
    run): shipped frames append to its WAL with primary sequence numbers,
    so a standby reboot recovers through the ordinary durability path and
    a promotion continues the same journal for its own writes.
    """

    def __init__(self, state, manager, settings, faults=None, health=None,
                 audit_path: str | None = None, audit_log=None):
        if manager is None or manager.wal is None:
            raise ValueError(
                "StandbyReplica requires a recovered DurabilityManager "
                "(replication is built on the durability subsystem)"
            )
        self.state = state
        self.manager = manager
        self.settings = settings
        self.health = health
        self._faults = faults
        #: where shipped ``kind="audit"`` proof-log segments land (the
        #: standby's own ``[audit] log_path``; segments are stored as
        #: ``<audit_path>.<first>-<last>.seg`` exactly as the primary
        #: sealed them, so a promotion continues the same directory)
        self.audit_path = audit_path
        self.audit_segments_received = 0
        #: this node's own ProofLogWriter (``[audit] enabled``), whose
        #: numbering a promotion moves past the shipped segments
        self.audit_log = audit_log
        self.pb2 = load_replication_pb2()
        self.role = "standby"
        self.epoch_path = settings.epoch_file or manager.state_file + ".epoch"
        epoch = load_epoch(self.epoch_path)
        self.applier = SegmentApplier(
            state, epoch=epoch, applied_seq=manager.wal.seq, sink=None
        )
        # serializes whole segment applications: prepare/persist/commit
        # must not interleave between two concurrent ShipSegment handlers
        self._apply_lock = asyncio.Lock()
        self._last_contact: float | None = None  # lease armed at 1st contact
        self._last_segment_at: float | None = None  # last ACCEPTED segment
        self._watch_task: asyncio.Task | None = None
        self._promotions = 0
        metrics.gauge("state.repl.role").set(0.0)
        metrics.gauge("state.repl.epoch").set(float(epoch))

    # -- introspection -----------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.applier.epoch

    @property
    def applied_seq(self) -> int:
        return self.applier.applied_seq

    @property
    def lease_remaining_s(self) -> float | None:
        """Seconds until the primary's lease expires; ``None`` before the
        first contact (an unpaired standby never self-promotes)."""
        if self._last_contact is None:
            return None
        return (
            self.settings.lease_ms / 1000.0
            - (time.monotonic() - self._last_contact)
        )

    def status(self) -> dict:
        """The admin REPL ``/replication`` payload (standby side)."""
        lease = self.lease_remaining_s
        return {
            "role": self.role,
            "epoch": self.epoch,
            "applied_seq": self.applied_seq,
            "lag_records": self.applier.lag_records,
            "segments_received": self.applier.segments_received,
            "segments_rejected": self.applier.segments_rejected,
            "records_applied": self.applier.records_applied,
            "records_skipped": self.applier.records_skipped,
            "fenced": self.applier.fenced,
            "lease_remaining_s": lease,
            "last_ship_age_s": (
                None if self._last_segment_at is None
                else round(time.monotonic() - self._last_segment_at, 3)
            ),
            "promotions": self._promotions,
            "audit_segments_received": self.audit_segments_received,
        }

    # -- lease -------------------------------------------------------------

    def _renew_lease(self) -> None:
        self._last_contact = time.monotonic()

    def start(self) -> None:
        """Start the lease watch task (idempotent)."""
        if self._watch_task is None or self._watch_task.done():
            self._watch_task = asyncio.get_running_loop().create_task(
                self._watch()
            )

    async def stop(self) -> None:
        task = self._watch_task
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                log.exception("replication lease watch task died")
            self._watch_task = None

    async def _watch(self) -> None:
        """Promote when the armed lease expires (``auto_promote``)."""
        interval = self.settings.renew_interval_ms / 1000.0
        while self.role == "standby":
            await asyncio.sleep(interval)
            lease = self.lease_remaining_s
            if (
                self.settings.auto_promote
                and lease is not None
                and lease <= 0
            ):
                log.warning(
                    "primary lease expired (%.0f ms without contact); "
                    "promoting standby at applied_seq=%d epoch=%d",
                    self.settings.lease_ms, self.applied_seq, self.epoch,
                )
                await self.promote(reason="lease-expired")
                return

    # -- gRPC handlers -----------------------------------------------------

    def handler(self):
        return make_replication_handler(self)

    async def ship_segment(self, request, context):
        del context
        if getattr(request, "kind", "") == "audit":
            # under the apply lock: a promotion holds it while it moves the
            # proof log's numbering past the stored segments, and none may
            # land after that
            async with self._apply_lock:
                return await self._ship_audit_segment(request)
        seg = Segment(
            epoch=request.epoch,
            index=request.segment_index,
            first_seq=request.first_seq,
            last_seq=request.last_seq,
            frames=bytes(request.frames),
            crc=request.crc32,
            sealed=request.sealed,
        )
        async with self._apply_lock:
            if self.role != "standby":
                # a promoted node refuses shipments outright — its epoch is
                # higher than any legitimate sender's, but be explicit
                accepted, message = False, (
                    f"fenced: this node is primary at epoch {self.epoch}"
                )
                self.applier.fenced += 1
                metrics.counter("state.repl.fenced").inc()
            else:
                accepted, message, new = self.applier.prepare(seg)
                if accepted:
                    if new:
                        frames = b"".join(encode_record(r) for r in new)
                        last = int(new[-1]["seq"])
                        # durable BEFORE applied: a standby crash between
                        # the two replays the frames from its own WAL
                        await asyncio.to_thread(
                            self._persist_frames, frames, last
                        )
                        self.applier.commit(new)
                        message = f"applied {len(new)} records"
                    self._last_segment_at = time.monotonic()
                    # apply lag against the shipper's send stamp: wall
                    # clock from "primary wrote it" to "standby applied
                    # it" (clock skew shows as a level shift, not noise)
                    sent_ms = int(getattr(request, "sent_unix_ms", 0))
                    if sent_ms > 0:
                        metrics.histogram(
                            "state.repl.apply_lag_seconds"
                        ).observe(max(0.0, time.time() - sent_ms / 1000.0))
                    self.applier.note_primary_seq(int(request.primary_seq))
                    self._renew_lease()
            if not accepted:
                get_tracer().record_event(
                    "segment_rejected",
                    epoch=int(request.epoch),
                    index=int(request.segment_index),
                    reason=message,
                )
        return self.pb2.ShipSegmentResponse(
            accepted=accepted,
            applied_seq=self.applied_seq,
            epoch=self.epoch,
            message=message,
        )

    def _persist_frames(self, frames: bytes, last_seq: int) -> None:
        wal = self.manager.wal
        assert wal is not None  # ctor refuses an unrecovered manager
        wal.append_frames(frames, last_seq)
        if wal.needs_sync():
            wal.sync()

    async def _ship_audit_segment(self, request):
        """A sealed proof-log segment (``kind="audit"``): validate CRC +
        clean parse, persist it atomically as a rotated-segment file next
        to this node's proof log.  Never replayed as state — proof
        records are audit evidence, not mutations.  Same epoch fencing as
        WAL segments; an identical re-delivery is an idempotent
        overwrite."""
        import zlib

        from ..durability.wal import iter_frames as _iter

        try:
            epoch = int(request.epoch)
        except (TypeError, ValueError):
            epoch = -1
        if self.role != "standby" or epoch < self.epoch:
            self.applier.fenced += 1
            metrics.counter("state.repl.fenced").inc()
            return self.pb2.ShipSegmentResponse(
                accepted=False, applied_seq=self.applied_seq,
                epoch=self.epoch,
                message=f"fenced: stale epoch {epoch} < {self.epoch}",
            )
        if self.audit_path is None:
            return self.pb2.ShipSegmentResponse(
                accepted=False, applied_seq=self.applied_seq,
                epoch=self.epoch,
                message="rejected: standby has no audit plane "
                        "([audit] log_path unset)",
            )
        raw = bytes(request.frames)
        if zlib.crc32(raw) & 0xFFFFFFFF != int(request.crc32) & 0xFFFFFFFF:
            return self.pb2.ShipSegmentResponse(
                accepted=False, applied_seq=self.applied_seq,
                epoch=self.epoch, message="rejected: segment CRC mismatch",
            )
        records, valid = _iter(raw)
        if valid != len(raw) or not records:
            return self.pb2.ShipSegmentResponse(
                accepted=False, applied_seq=self.applied_seq,
                epoch=self.epoch,
                message="rejected: segment frames do not parse cleanly",
            )
        if (
            int(records[0]["seq"]) != int(request.first_seq)
            or int(records[-1]["seq"]) != int(request.last_seq)
        ):
            return self.pb2.ShipSegmentResponse(
                accepted=False, applied_seq=self.applied_seq,
                epoch=self.epoch,
                message="rejected: seq bounds do not match the frames",
            )
        from ..audit.log import segment_name

        dst = segment_name(
            self.audit_path, int(request.first_seq), int(request.last_seq)
        )
        await asyncio.to_thread(self._persist_audit_file, dst, raw)
        self.audit_segments_received += 1
        self._renew_lease()
        return self.pb2.ShipSegmentResponse(
            accepted=True, applied_seq=self.applied_seq, epoch=self.epoch,
            message=f"audit segment stored ({len(records)} records)",
        )

    @staticmethod
    def _persist_audit_file(dst: str, raw: bytes) -> None:
        d = os.path.dirname(os.path.abspath(dst)) or "."
        fd, tmp = tempfile.mkstemp(
            prefix="." + os.path.basename(dst) + ".tmp.", dir=d
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, dst)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.chmod(dst, 0o600)

    async def replication_status(self, request, context):
        del context
        if (
            self.role == "standby"
            and request.renew_lease
            and int(request.epoch) >= self.epoch
        ):
            self._renew_lease()
        if self.role == "standby":
            self.applier.note_primary_seq(int(request.primary_seq))
        lease = self.lease_remaining_s
        return self.pb2.ReplicationStatusResponse(
            role=self.role,
            epoch=self.epoch,
            applied_seq=self.applied_seq,
            lag_records=self.applier.lag_records,
            lease_remaining_s=-1.0 if lease is None else lease,
            segments_received=self.applier.segments_received,
        )

    async def handover(self, request, context):
        """Coordinated-handover wire handler, STANDBY side (phase
        "promote"): promote at epoch+1 once the local applied sequence
        number has reached the primary's fence watermark.  The primary
        has already fenced writes and shipped the WAL tail, so under a
        healthy pair the watermark is already applied and this is one
        promotion away; a standby that somehow lags past the watermark
        refuses rather than promoting with acked writes missing — the
        primary then aborts, unfences, and the pair degrades to the
        ordinary path."""
        del context
        if request.phase not in ("", "promote"):
            return self.pb2.HandoverResponse(
                ok=False, role=self.role, epoch=self.epoch,
                applied_seq=self.applied_seq,
                message=(
                    "this node is a standby; it answers phase 'promote' "
                    f"only (got {request.phase!r})"
                ),
            )
        if self._faults is not None and self._faults.take_crash(
            "pre_handover_ack"
        ):
            from ..resilience.faults import CrashPoint

            raise CrashPoint("pre_handover_ack during handover promotion")
        if self.role == "primary":
            # idempotent retry of a handover whose response was lost
            return self.pb2.HandoverResponse(
                ok=True, role="primary", epoch=self.epoch,
                applied_seq=self.applied_seq, message="already primary",
                fence_seq=int(request.fence_seq),
            )
        if int(request.epoch) < self.epoch:
            return self.pb2.HandoverResponse(
                ok=False, role=self.role, epoch=self.epoch,
                applied_seq=self.applied_seq,
                message=(
                    f"fenced: stale handover epoch {int(request.epoch)} < "
                    f"{self.epoch}"
                ),
            )
        fence_seq = int(request.fence_seq)
        if self.applied_seq < fence_seq:
            return self.pb2.HandoverResponse(
                ok=False, role=self.role, epoch=self.epoch,
                applied_seq=self.applied_seq,
                message=(
                    f"not caught up: applied_seq {self.applied_seq} < "
                    f"fence watermark {fence_seq}"
                ),
            )
        report = await self.promote(
            reason=f"handover ({request.reason or 'rpc'})"
        )
        return self.pb2.HandoverResponse(
            ok=True, role=self.role, epoch=self.epoch,
            applied_seq=self.applied_seq,
            message=report["message"], fence_seq=fence_seq,
        )

    # -- promotion ---------------------------------------------------------

    async def promote(self, reason: str = "operator") -> dict:
        """Take over as primary: truncate the local WAL's torn tail,
        finish replaying anything persisted-but-unapplied, bump + persist
        the fencing epoch, flip the readiness gate to SERVING, and attach
        nothing new — the journal the frames landed in simply continues
        for this node's own writes.  Idempotent: promoting a primary is a
        no-op report, and a :class:`CrashPoint` at ``pre_promote`` leaves
        a retryable standby."""
        if self.role == "primary":
            return {"promoted": False, "message": "already primary",
                    "epoch": self.epoch}
        if self._faults is not None and self._faults.take_crash("pre_promote"):
            from ..resilience.faults import CrashPoint

            raise CrashPoint("pre_promote during standby promotion")
        async with self._apply_lock:
            wal = self.manager.wal
            assert wal is not None  # ctor refuses an unrecovered manager
            await asyncio.to_thread(wal.sync, True)
            # finish replay: anything durable in the local log beyond the
            # applied watermark (a crash between persist and commit), and
            # truncate a torn tail a hard standby death left behind —
            # read_from(0) spans sealed segments + the active file, so a
            # rotated standby WAL promotes exactly like a single file
            raw = await asyncio.to_thread(wal.read_from, 0)
            records, valid = iter_frames(raw)
            truncated = 0
            if valid < len(raw):
                truncated = len(raw) - valid
                await asyncio.to_thread(wal.truncate_to, valid)
            replayed = 0
            for rec in records:
                if rec["seq"] > self.applier.applied_seq:
                    self.applier.commit([rec])
                    replayed += 1
            self.applier.epoch += 1
            await asyncio.to_thread(
                store_epoch, self.epoch_path, self.applier.epoch
            )
            audit_seq = None
            if self.audit_log is not None:
                # before the gate opens: the first verdict this node serves
                # follows the last proof record the primary shipped
                audit_seq = await asyncio.to_thread(
                    self.audit_log.resume_past_sealed
                )
            self.role = "primary"
            self._promotions += 1
            if self.health is not None:
                self.health.standby = False
        metrics.gauge("state.repl.role").set(1.0)
        metrics.gauge("state.repl.epoch").set(float(self.epoch))
        get_tracer().record_event(
            "promotion",
            reason=reason,
            epoch=self.epoch,
            applied_seq=self.applied_seq,
            replayed_tail=replayed,
            truncated_bytes=truncated,
        )
        log.warning(
            "PROMOTED to primary (reason=%s): epoch=%d applied_seq=%d "
            "tail_replayed=%d torn_bytes_truncated=%d audit_seq=%s",
            reason, self.epoch, self.applied_seq, replayed, truncated,
            audit_seq,
        )
        return {
            "promoted": True,
            "message": f"promoted ({reason})",
            "epoch": self.epoch,
            "applied_seq": self.applied_seq,
            "replayed_tail": replayed,
            "truncated_bytes": truncated,
        }
