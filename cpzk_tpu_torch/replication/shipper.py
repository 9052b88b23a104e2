"""Primary-side WAL segment shipping + lease renewal.

A copy of ``cpzk_tpu/replication/shipper.py``.  Its shipped offsets are
logical offsets into the port's write-ahead log, which compaction rebases
through :meth:`SegmentShipper.note_compacted`; the port's
``DurabilityManager.checkpoint`` clamps compaction to the smaller of
:meth:`SegmentShipper.safe_compact_offset` and the oldest live
challenge's record.

A :class:`SegmentShipper` follows the primary's write-ahead log, chops
new records into sealed segments (plus an unsealed tail-follow of the
active run), and ships them to the warm standby over the
ReplicationService.  Every successful exchange renews the standby's view
of the primary lease; when the primary dies, renewals stop, the lease
expires, and the standby promotes (``standby.py``).

Modes (``[replication] mode``):

- ``async`` — appends are acknowledged after the local fsync; shipping
  runs on the renewal cadence (loss window on failover: up to one
  ``renew_interval_ms`` of acknowledged writes).
- ``sync``  — :meth:`wait_replicated` is attached to ``ServerState`` as
  the replication barrier: an acknowledged mutation additionally waits
  until the standby has applied its sequence number (loss window: none —
  the SIGKILL chaos test pins it).  If the standby cannot acknowledge
  within ``sync_timeout_ms`` the mutation FAILS rather than silently
  degrading to async — zero-loss means refusing to lie about durability.

Fencing: a shipper that sees a higher epoch in a response (or an
explicit ``fenced`` rejection) has been deposed — it stops shipping for
good and every sync-mode barrier fails.  Compaction on the primary is
clamped to the shipped-and-acknowledged byte offset so a covering
snapshot can never drop records the standby has not yet received.
"""

from __future__ import annotations

import asyncio
import logging
import time

import grpc

from ..durability.wal import encode_record, iter_frames
from ..observability import get_tracer
from ..resilience.faults import CrashPoint
from ..server import metrics
from .segments import split_records
from .standby import load_epoch
from .wire import ReplicationStub, load_replication_pb2, make_replication_handler

log = logging.getLogger("cpzk_tpu_torch.replication")


class ReplicationTimeout(RuntimeError):
    """A sync-mode barrier could not confirm standby durability in time
    (standby down, lagging past ``sync_timeout_ms``, or this primary has
    been fenced).  The mutation is durable locally but NOT replicated —
    the caller must surface the failure, not acknowledge the write."""


class HandoverError(RuntimeError):
    """A coordinated handover could not run or complete (no standby, a
    stale standby that never reached the fence watermark, a refused
    promotion, a concurrent handover).  Raised by
    :meth:`SegmentShipper.run_handover` — the caller falls back to the
    ordinary path (plain drain + lease failover), loudly."""


class SegmentShipper:
    """Ship sealed WAL segments + tail-follow deltas to the standby.

    With ``audit_log`` attached (a rotating
    :class:`~cpzk_tpu_torch.audit.ProofLogWriter`), sealed proof-log segments
    ride the same loop as ``kind="audit"`` shipments: CRC-validated by
    the standby and persisted as rotated-segment files next to *its*
    proof log, so a machine death loses at most the unsealed audit tail
    — the audit trail survives hardware the way the WAL does.
    """

    def __init__(self, state, manager, settings, faults=None,
                 audit_log=None):
        if manager is None or manager.wal is None:
            raise ValueError(
                "SegmentShipper requires a recovered DurabilityManager"
            )
        self.state = state
        self.manager = manager
        self.settings = settings
        self._faults = faults
        self.audit_log = audit_log  # ProofLogWriter | None
        self.audit_segments_shipped = 0
        #: sealed-segment basenames already accepted by the standby this
        #: boot; a restart re-ships (the standby's atomic overwrite makes
        #: duplicates idempotent)
        self._audit_shipped: set[str] = set()
        self.pb2 = load_replication_pb2()
        self.epoch_path = settings.epoch_file or manager.state_file + ".epoch"
        self.epoch = load_epoch(self.epoch_path)
        self.peer = settings.peer
        #: byte offset into the WAL file that has been shipped AND
        #: acknowledged — also the compaction floor (``DurabilityManager``
        #: never compacts past it)
        self.acked_offset = 0
        self.acked_seq = 0
        self.segments_shipped = 0
        #: ``time.monotonic()`` of the last ACCEPTED segment ship (None
        #: until the first) — the ``last_ship_age_s`` row of /statusz
        self.last_ship_at: float | None = None
        self.fenced = False
        self.gap_stalled = False
        self.crashed: BaseException | None = None
        #: "primary" always — lets ``serve(replica=shipper)`` expose the
        #: ReplicationService (the Handover entry point) on a primary
        #: daemon through the same seam as a standby, while ``_admit``'s
        #: role check keeps admitting auth traffic
        self.role = "primary"
        self.health = None  # serve() wires the HealthService here
        #: set while (and after) a handover fences writes: the address
        #: the service's redirect trailers point at (the standby)
        self.redirect_address: str | None = None
        #: coordinated-handover bookkeeping behind /statusz + /handover
        self._handover = {
            "stage": "idle", "fence_seq": 0, "standby_applied_seq": 0,
        }
        self.handovers_attempted = 0
        self.handovers_completed = 0
        self.handovers_aborted = 0
        self.last_handover_s: float | None = None
        self._index = 0
        self._task: asyncio.Task | None = None
        self._stop = False
        self._wake: asyncio.Event | None = None
        self._ack_cond: asyncio.Condition | None = None
        self._channel = None
        self._stub: ReplicationStub | None = None
        metrics.gauge("state.repl.role").set(1.0)
        metrics.gauge("state.repl.epoch").set(float(self.epoch))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Start the shipping loop (idempotent); call on a running loop."""
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._ack_cond = asyncio.Condition()
            self._stop = False
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        """Graceful stop: one final flush tick, then close the channel."""
        self._stop = True
        if self._task is not None:
            assert self._wake is not None
            self._wake.set()
            try:
                await self._task
            except Exception:
                log.exception("segment shipper loop died during stop")
            self._task = None
        await self._close_channel()

    async def kill(self) -> None:
        """Abrupt stop with NO final flush — the in-process stand-in for
        SIGKILLing the primary (chaos tests)."""
        self._stop = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            self._task = None
        await self._close_channel()

    async def _close_channel(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self._stub = None

    def _ensure_stub(self) -> ReplicationStub:
        if self._stub is None:
            self._channel = grpc.aio.insecure_channel(self.peer)
            self._stub = ReplicationStub(self._channel)
        return self._stub

    # -- the loop ----------------------------------------------------------

    async def _run(self) -> None:
        interval = self.settings.renew_interval_ms / 1000.0
        wake, cond = self._wake, self._ack_cond
        assert wake is not None and cond is not None
        final = False
        while True:
            if self.fenced or self.crashed is not None:
                return
            try:
                await self._tick()
            except CrashPoint as e:
                # a scheduled deterministic death: the primary is "gone"
                self.crashed = e
                log.error("segment shipper crash point: %s", e)
                async with cond:
                    cond.notify_all()
                return
            except grpc.aio.AioRpcError as e:
                # standby unreachable: keep trying on the cadence — the
                # lease math on the other side decides what it means
                log.debug("standby unreachable: %s", e.code())
            except Exception:
                log.exception("segment shipper tick failed; retrying")
            if final:
                return
            if self._stop:
                final = True  # one last flush tick, then exit
                continue
            try:
                await asyncio.wait_for(wake.wait(), timeout=interval)
            except asyncio.TimeoutError:
                pass
            wake.clear()

    async def _tick(self) -> None:
        """Ship everything new past the acked offset, else renew the lease."""
        wal = self.manager.wal
        if wal is None:
            return

        offset = self.acked_offset
        # logical-offset read across sealed segments + the active file:
        # the shipper keeps tailing straight through a rotation, and
        # compaction rebases acked_offset via note_compacted as before
        raw = await asyncio.to_thread(wal.read_from, offset)
        records, valid = iter_frames(raw)
        new = [r for r in records if r["seq"] > self.acked_seq]
        # bytes of already-acknowledged records in the chunk (a restarted
        # primary re-reading history a caught-up standby already has):
        # skip them so the compaction floor advances past them too
        if records and len(new) < len(records):
            new_bytes = sum(len(encode_record(r)) for r in new)
            self.acked_offset = offset + valid - new_bytes
        if not new:
            await self._ship_audit_segments()
            if not self.fenced:
                await self._renew_lease()
            return
        for seg in split_records(
            new, self.epoch, self._index, self.settings.segment_bytes
        ):
            await self._ship(seg)
            if self.fenced:
                return
        await self._ship_audit_segments()

    async def _ship_audit_segments(self) -> None:
        """Ship sealed proof-log segments the standby has not accepted
        yet (``kind="audit"``).  Sealed files are immutable, so the work
        list is a directory scan and duplicates are idempotent on the
        standby (atomic overwrite of an identical file)."""
        log_writer = self.audit_log
        if log_writer is None or self.fenced:
            return
        import os
        import zlib

        for path in log_writer.sealed_segments():
            name = os.path.basename(path)
            if name in self._audit_shipped:
                continue

            def _read_seg(p=path) -> bytes:
                with open(p, "rb") as f:
                    return f.read()

            raw = await asyncio.to_thread(_read_seg)
            records, valid = iter_frames(raw)
            if valid != len(raw) or not records:
                # a sealed segment is fsynced before the rename — this is
                # disk corruption, not a race; skip it loudly rather than
                # spinning on it every tick
                log.error(
                    "sealed proof-log segment %s does not parse cleanly; "
                    "NOT shipped (inspect/restore from the primary copy)",
                    path,
                )
                self._audit_shipped.add(name)
                continue
            stub = self._ensure_stub()
            req = self.pb2.ShipSegmentRequest(
                epoch=self.epoch,
                segment_index=int(records[0]["seq"]),
                first_seq=int(records[0]["seq"]),
                last_seq=int(records[-1]["seq"]),
                frames=raw,
                crc32=zlib.crc32(raw) & 0xFFFFFFFF,
                sealed=True,
                primary_seq=self._wal_seq(),
                sent_unix_ms=int(time.time() * 1000.0),
                kind="audit",
            )
            resp = await stub.ship_segment(
                req, timeout=self.settings.sync_timeout_ms / 1000.0
            )
            if resp.accepted:
                self._audit_shipped.add(name)
                self.audit_segments_shipped += 1
                metrics.counter("audit.log.segments_shipped").inc()
            elif resp.epoch > self.epoch or "fenced" in resp.message:
                self._fence(resp.epoch, resp.message)
                return
            else:
                log.warning(
                    "audit segment %s rejected: %s", name, resp.message
                )
                return  # retry next tick

    def _wal_seq(self) -> int:
        wal = self.manager.wal
        return wal.seq if wal is not None else 0

    async def _renew_lease(self) -> None:
        stub = self._ensure_stub()
        req = self.pb2.ReplicationStatusRequest(
            epoch=self.epoch, renew_lease=True,
            primary_seq=self._wal_seq(),
        )
        resp = await stub.replication_status(
            req, timeout=self.settings.sync_timeout_ms / 1000.0
        )
        if resp.epoch > self.epoch or resp.role == "primary":
            self._fence(resp.epoch, "status exchange")
        else:
            self.acked_seq = max(self.acked_seq, int(resp.applied_seq))
        metrics.gauge("state.repl.lag_records").set(
            float(max(0, self._wal_seq() - self.acked_seq))
        )

    async def _ship(self, seg) -> None:
        if self._faults is not None and self._faults.take_crash("pre_ship"):
            raise CrashPoint(f"pre_ship of segment {seg.index}")
        stub = self._ensure_stub()
        frames = seg.frames
        if self._faults is not None and self._faults.take_crash("mid_segment"):
            # the death-mid-transfer stand-in: half the frame bytes leave
            # the machine (CRC intact, so the standby rejects the torn
            # blob whole), then the "process" dies
            torn = self.pb2.ShipSegmentRequest(
                epoch=self.epoch, segment_index=seg.index,
                first_seq=seg.first_seq, last_seq=seg.last_seq,
                frames=frames[: max(1, len(frames) // 2)],
                crc32=seg.crc, sealed=seg.sealed,
                primary_seq=self._wal_seq(),
            )
            try:
                await stub.ship_segment(
                    torn, timeout=self.settings.sync_timeout_ms / 1000.0
                )
            finally:
                raise CrashPoint(f"mid_segment of segment {seg.index}")
        req = self.pb2.ShipSegmentRequest(
            epoch=self.epoch, segment_index=seg.index,
            first_seq=seg.first_seq, last_seq=seg.last_seq,
            frames=frames, crc32=seg.crc, sealed=seg.sealed,
            primary_seq=self._wal_seq(),
            # wall-clock send stamp: the applier reports its apply-time
            # lag against this into state.repl.apply_lag_seconds
            sent_unix_ms=int(time.time() * 1000.0),
        )
        t0 = time.monotonic()
        resp = await stub.ship_segment(
            req, timeout=self.settings.sync_timeout_ms / 1000.0
        )
        # ship RTT: request out -> response in, the wire half of the
        # replication lag an operator sees on /statusz and /metrics
        metrics.histogram("state.repl.ship_rtt").observe(
            time.monotonic() - t0
        )
        if resp.accepted:
            self._index = seg.index + 1
            self.segments_shipped += 1
            self.last_ship_at = time.monotonic()
            self.acked_seq = max(self.acked_seq, int(resp.applied_seq))
            self.acked_offset += len(frames)
            self.gap_stalled = False
            metrics.counter("state.repl.segments_shipped").inc()
            metrics.gauge("state.repl.lag_records").set(
                float(max(0, self._wal_seq() - self.acked_seq))
            )
            await self._notify_ack()
        elif resp.epoch > self.epoch or "fenced" in resp.message:
            self._fence(resp.epoch, resp.message)
            await self._notify_ack()
        elif "gap" in resp.message:
            # the standby is missing history this WAL no longer holds
            # (compacted before the pair was connected): unrecoverable
            # over the wire — seed the standby from a snapshot copy
            # (the operations runbook) — but keep renewing the lease
            # so a live primary is not failed over from
            if not self.gap_stalled:
                log.error(
                    "standby reports a history gap (%s): seed it from a "
                    "snapshot copy and restart replication", resp.message,
                )
            self.gap_stalled = True
            await self._renew_lease()
        else:
            log.warning("segment %d rejected: %s", seg.index, resp.message)

    async def _notify_ack(self) -> None:
        cond = self._ack_cond
        if cond is not None:
            async with cond:
                cond.notify_all()

    def _fence(self, their_epoch: int, where: str) -> None:
        if not self.fenced:
            log.error(
                "DEPOSED: standby is at epoch %d > ours %d (%s); this "
                "primary stops shipping and must not take writes",
                their_epoch, self.epoch, where,
            )
            get_tracer().record_event(
                "primary_fenced", our_epoch=self.epoch,
                their_epoch=int(their_epoch),
            )
        self.fenced = True

    # -- sync-mode barrier -------------------------------------------------

    async def wait_replicated(self, seq: int) -> None:
        """Block until the standby has applied ``seq`` (the sync-mode
        acknowledgement barrier ``ServerState`` awaits before an RPC
        returns).  Raises :class:`ReplicationTimeout` when the standby
        cannot confirm within ``sync_timeout_ms`` or this primary has
        been fenced/crashed."""
        if seq <= self.acked_seq:
            return
        wake, cond = self._wake, self._ack_cond
        if wake is None or cond is None:
            raise ReplicationTimeout("segment shipper is not running")
        wake.set()
        timeout = self.settings.sync_timeout_ms / 1000.0

        def _done() -> bool:
            return (
                self.acked_seq >= seq
                or self.fenced
                or self.crashed is not None
            )

        try:
            async with cond:
                await asyncio.wait_for(
                    cond.wait_for(_done), timeout=timeout
                )
        except asyncio.TimeoutError:
            raise ReplicationTimeout(
                f"standby did not acknowledge seq {seq} within "
                f"{self.settings.sync_timeout_ms:g} ms (acked "
                f"{self.acked_seq})"
            ) from None
        if self.fenced:
            raise ReplicationTimeout(
                "this primary has been fenced by a promoted standby"
            )
        if self.crashed is not None:
            raise ReplicationTimeout("segment shipper crashed")

    # -- coordinated handover -----------------------------------------------

    def handler(self):
        """ReplicationService handler for the PRIMARY side: ship/status
        answer with structural refusals, ``Handover`` (phase "initiate")
        runs the coordinated handover — what lets ``serve(replica=self)``
        expose the planned-operations entry point over the same port as
        auth traffic."""
        return make_replication_handler(self)

    def _crashpt(self, point: str) -> None:
        if self._faults is not None and self._faults.take_crash(point):
            raise CrashPoint(f"{point} during handover")

    def _set_stage(self, stage: str) -> None:
        self._handover["stage"] = stage

    async def run_handover(self, reason: str = "operator",
                           timeout_ms: float | None = None) -> dict:
        """The coordinated primary→standby handover, end to end:

        1. arm the write fence (``ServerState.owner_fence`` — reads and
           challenge consumes stay open; fenced writes get the standard
           FAILED_PRECONDITION redirect, pointed at the standby);
        2. flush and ship the WAL tail, wait for the standby's
           applied-seq ack at the fence watermark;
        3. instruct the standby to promote at epoch+1;
        4. enter deposed-redirecting mode (stay fenced, stop shipping).

        Zero acked-write loss is structural: the fence precedes the
        journal append, so every acknowledged write has ``seq <=
        fence_seq`` and the standby applied it before promoting.  Any
        failure before step 3 completes restores the previous fence and
        re-raises — the pair keeps serving exactly as before, and a real
        process death at any stage degrades to ordinary lease failover
        (``HANDOVER_CRASH_POINTS`` pins every stage).
        """
        if self.fenced:
            raise HandoverError("this primary is already fenced/deposed")
        if self.crashed is not None:
            raise HandoverError("segment shipper crashed")
        if not self.peer:
            raise HandoverError("no standby attached ([replication] peer)")
        if self._handover["stage"] in ("fence", "ship_tail", "promote"):
            raise HandoverError("a handover is already in progress")
        timeout_s = (
            timeout_ms if timeout_ms is not None
            else self.settings.handover_timeout_ms
        ) / 1000.0
        self.handovers_attempted += 1
        metrics.counter("fleet.handover.attempts").inc()
        t0 = time.monotonic()
        prev_fence = getattr(self.state, "owner_fence", None)
        target = self.peer
        promoted = False
        try:
            self._crashpt("pre_handover_fence")
            # 1. arm the write fence, composed over any fleet fence: a
            # user another partition owns keeps its fleet redirect, every
            # user this partition owns redirects to the standby
            def _handover_fence(uid: str, _prev=prev_fence):
                if _prev is not None:
                    msg = _prev(uid)
                    if msg is not None:
                        return msg
                return (
                    "wrong partition: handover in progress; writes go to "
                    f"the standby at {target}"
                )

            if hasattr(self.state, "attach_owner_fence"):
                self.state.attach_owner_fence(_handover_fence)
            self.redirect_address = target
            self._set_stage("fence")
            self._crashpt("post_handover_fence")
            # 2. flush + ship the tail; the fence preceded every later
            # append, so this watermark covers every acknowledged write
            wal = self.manager.wal
            if wal is not None:
                await asyncio.to_thread(wal.sync, True)
            fence_seq = self._wal_seq()
            self._handover["fence_seq"] = fence_seq
            self._set_stage("ship_tail")
            await self._await_acked(fence_seq, timeout_s)
            self._handover["standby_applied_seq"] = self.acked_seq
            self._crashpt("pre_handover_promote")
            # 3. instruct the standby to promote at epoch+1
            self._set_stage("promote")
            stub = self._ensure_stub()
            resp = await stub.handover(
                self.pb2.HandoverRequest(
                    phase="promote", epoch=self.epoch,
                    fence_seq=fence_seq, reason=reason,
                ),
                timeout=timeout_s,
            )
            if not resp.ok:
                raise HandoverError(
                    f"standby refused promotion: {resp.message}"
                )
            promoted = True
            self._handover["standby_applied_seq"] = int(resp.applied_seq)
            self._crashpt("post_handover_promote")
            # 4. deposed-redirecting mode: stop shipping/renewing for
            # good, keep the fence redirecting writes at the new primary
            self._fence(int(resp.epoch), "coordinated handover")
            await self._notify_ack()
            self._set_stage("deposed")
            duration = time.monotonic() - t0
            self.last_handover_s = duration
            self.handovers_completed += 1
            metrics.counter("fleet.handover.completed").inc()
            metrics.histogram("fleet.handover.duration").observe(duration)
            get_tracer().record_event(
                "handover", reason=reason, fence_seq=fence_seq,
                new_epoch=int(resp.epoch), duration_s=duration,
            )
            log.warning(
                "handover complete (%s): standby %s promoted at epoch %d, "
                "fence watermark seq %d, %.3fs; this node is "
                "deposed-redirecting and should drain",
                reason, target, int(resp.epoch), fence_seq, duration,
            )
            return {
                "ok": True, "epoch": int(resp.epoch),
                "fence_seq": fence_seq,
                "applied_seq": int(resp.applied_seq),
                "duration_s": duration, "peer": target,
            }
        except BaseException:
            self.handovers_aborted += 1
            metrics.counter("fleet.handover.aborted").inc()
            if promoted:
                # the standby IS primary now — stay deposed-redirecting;
                # anything less re-forks history
                self._fence(self.epoch + 1, "handover abort after promotion")
                self._set_stage("deposed")
            else:
                # nothing irreversible happened: restore the previous
                # fence and keep serving as the primary (lease renewal
                # continues; a real death here becomes lease failover)
                if hasattr(self.state, "attach_owner_fence"):
                    self.state.attach_owner_fence(prev_fence)
                self.redirect_address = None
                self._set_stage("aborted")
            raise

    async def _await_acked(self, seq: int, timeout_s: float) -> None:
        """Wait until the standby has applied ``seq`` (the handover's
        fence-watermark wait — ``wait_replicated`` with the handover
        deadline instead of the sync-mode one)."""
        if seq <= self.acked_seq:
            return
        wake, cond = self._wake, self._ack_cond
        if wake is None or cond is None:
            raise HandoverError("segment shipper is not running")
        wake.set()

        def _done() -> bool:
            return (
                self.acked_seq >= seq
                or self.fenced
                or self.crashed is not None
            )

        try:
            async with cond:
                await asyncio.wait_for(cond.wait_for(_done), timeout=timeout_s)
        except asyncio.TimeoutError:
            raise HandoverError(
                f"stale standby: did not reach the fence watermark seq "
                f"{seq} within {timeout_s * 1000.0:g} ms (applied "
                f"{self.acked_seq})"
            ) from None
        if self.fenced:
            raise HandoverError("fenced during handover")
        if self.crashed is not None:
            raise HandoverError("segment shipper crashed during handover")

    # ReplicationService wire methods (serve(replica=shipper) installs
    # these next to the auth handlers on a primary daemon)

    async def handover(self, request, context):
        """Wire entry point: phase "initiate" runs :meth:`run_handover`
        (the fleet rolling-restart CLI's path); anything else is refused
        — a primary does not promote."""
        if request.phase not in ("", "initiate"):
            return self.pb2.HandoverResponse(
                ok=False, role="primary", epoch=self.epoch,
                applied_seq=self._wal_seq(),
                message=(
                    "this node is a primary; it answers phase 'initiate' "
                    f"only (got {request.phase!r})"
                ),
            )
        try:
            report = await self.run_handover(reason=request.reason or "rpc")
        except CrashPoint:
            raise  # the process-death stand-in must stay fatal
        except Exception as e:
            return self.pb2.HandoverResponse(
                ok=False, role="primary", epoch=self.epoch,
                applied_seq=self._wal_seq(), message=str(e),
            )
        return self.pb2.HandoverResponse(
            ok=True, role="primary", epoch=report["epoch"],
            applied_seq=report["applied_seq"],
            message="standby promoted; this node is deposed-redirecting",
            fence_seq=report["fence_seq"],
            duration_s=report["duration_s"],
        )

    async def ship_segment(self, request, context):
        """A primary never applies shipped segments; the 'fenced' refusal
        makes a deposed twin shipping at us fence itself."""
        return self.pb2.ShipSegmentResponse(
            accepted=False, applied_seq=self._wal_seq(), epoch=self.epoch,
            message="fenced: this node is a primary, not a standby",
        )

    async def replication_status(self, request, context):
        return self.pb2.ReplicationStatusResponse(
            role="primary", epoch=self.epoch,
            applied_seq=self._wal_seq(),
            lag_records=max(0, self._wal_seq() - self.acked_seq),
            lease_remaining_s=0.0, segments_received=0,
        )

    def handover_status(self) -> dict:
        """The ``handover`` block of ``/statusz`` and the REPL's
        ``/handover`` status line."""
        return {
            "stage": self._handover["stage"],
            "fence_seq": self._handover["fence_seq"],
            "standby_applied_seq": self._handover["standby_applied_seq"],
            "last_duration_s": (
                None if self.last_handover_s is None
                else round(self.last_handover_s, 4)
            ),
            "attempts": self.handovers_attempted,
            "completed": self.handovers_completed,
            "aborted": self.handovers_aborted,
            "redirecting_to": self.redirect_address,
        }

    # -- compaction coupling (DurabilityManager) ---------------------------

    def safe_compact_offset(self) -> int:
        """Compaction floor: bytes at or past this offset have not been
        acknowledged by the standby and must survive compaction."""
        return self.acked_offset

    def note_compacted(self, freed: int) -> None:
        """Compaction dropped ``freed`` bytes of the already-acked prefix;
        rebase the shipped-offset bookkeeping."""
        self.acked_offset = max(0, self.acked_offset - freed)

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """The admin REPL ``/replication`` payload (primary side) — also
        the ``replication`` block of the ops plane's ``/statusz``."""
        wal_seq = self._wal_seq()
        return {
            "role": "primary",
            "epoch": self.epoch,
            "mode": self.settings.mode,
            "peer": self.peer,
            "wal_seq": wal_seq,
            "acked_seq": self.acked_seq,
            "lag_records": max(0, wal_seq - self.acked_seq),
            "segments_shipped": self.segments_shipped,
            "last_ship_age_s": (
                None if self.last_ship_at is None
                else round(time.monotonic() - self.last_ship_at, 3)
            ),
            "fenced": self.fenced,
            "gap_stalled": self.gap_stalled,
            "audit_segments_shipped": self.audit_segments_shipped,
        }
