"""Live partition splitting: grow the fleet one hash range at a time.

A copy of ``cpzk_tpu/fleet/split.py``: the source is recovered through the
port's ``durability/recovery.py`` and the copy goes through the port's
``SegmentApplier``, so a split by either package's CLI writes the same map
and moves the same users.

``python -m cpzk_tpu_torch.fleet split`` moves the upper half of the source
partition's largest hash range onto a brand-new partition, using the
same machinery lease-based promotion already trusts:

1. **manifest** — the split's own write-ahead intent: the computed new
   map version, the moved ranges, and a fencing epoch (source epoch + 1,
   exactly how promotion fences a deposed primary) are atomically
   written to ``<map>.split.json`` *before anything else changes*, so a
   SIGKILL at any later stage leaves a resumable plan, and a re-run
   continues the SAME split instead of computing a different one.
2. **copy** — the source partition's state is recovered from its
   snapshot + WAL (the ordinary durability boot path, torn tails
   truncated), the moved users' records are exported as a deterministic
   journal-record stream (``ServerState.export_user_records``),
   re-sequenced from 1, sealed into CRC'd segments
   (:func:`~cpzk_tpu_torch.replication.segments.split_records`), and replayed
   into the new partition through the
   :class:`~cpzk_tpu_torch.replication.SegmentApplier` **trust boundary** — a
   tampered source file cannot smuggle into the new partition what a
   live RPC would reject — with every applied frame durable in the new
   partition's own WAL *before* it is applied (the standby's
   persist-then-commit discipline).  The copy is idempotent: a re-run
   truncates the target files and rebuilds them from scratch.
3. **flip** — the new map (version + 1) is atomically renamed over the
   map file.  From this instant the moved range's owner of record is the
   new partition; the old source still *holds* stale copies but
   server-side ownership enforcement refuses to serve them, so the fleet
   never serves one user from two places.
4. **drain** — the moved users are dropped from the source's state, a
   fresh covering snapshot lands, and the source WAL is compacted away
   (the same "snapshot covers everything, replay nothing" state a
   graceful shutdown leaves).  Only then is the manifest removed.

Crash consistency (the chaos suite SIGKILLs every stage): before the
flip, the fleet serves entirely from the source (the target is not in
the map); after the flip, the target is authoritative for the moved
range and enforcement fences the source's stale copies until the drain
lands.  At no point can both partitions serve the same user, and a
re-run of the identical command completes the split from whatever stage
the crash left.

The source partition must be **stopped** (or read-only) while the split
runs — the reference's runbook (``docs/operations.md`` §"Partitioned
fleet") walks the stop → split → restart-with-new-map sequence and the
rollback.
"""

from __future__ import annotations

import json
import logging
import os

from ..durability.wal import WriteAheadLog
from ..replication.segments import split_records
from ..replication.standby import SegmentApplier, load_epoch, store_epoch
from .partition_map import PartitionMap, user_hash

log = logging.getLogger("cpzk_tpu_torch.fleet")

#: Schema tag of the split manifest (``<map>.split.json``).
MANIFEST_SCHEMA = "cpzk-split-manifest/1"

#: Deterministic crash sites the chaos suite schedules via a
#: :class:`~cpzk_tpu_torch.resilience.faults.FaultPlan` — each raises
#: :class:`~cpzk_tpu_torch.resilience.faults.CrashPoint` at exactly the file
#: state a SIGKILL at that instruction would leave behind.
SPLIT_CRASH_POINTS = (
    "pre_manifest",   # nothing written: the split never started
    "pre_copy",       # manifest durable, target untouched
    "mid_copy",       # target WAL half-written (next run rebuilds it)
    "pre_flip",       # target complete, map still the old version
    "pre_drain",      # map flipped, source still holds stale copies
    "pre_finish",     # drain done, manifest still present
)


#: the offline split replays whole partitions: its recovery and its copy
#: take every record, whatever capacity the daemons are configured with
#: (a default cap would skip the records past it, and the drain would then
#: drop users the copy never received)
_NO_CAPS = {"max_users": 1 << 62, "max_challenges": 1 << 62, "max_sessions": 1 << 62}


class SplitError(RuntimeError):
    """A split cannot proceed (bad arguments, mismatched resume manifest,
    or a segment the trust boundary refused)."""


def _crash(faults, point: str) -> None:
    if faults is not None and faults.take_crash(point):
        from ..resilience.faults import CrashPoint

        raise CrashPoint(f"{point} during partition split")


def manifest_path(map_path: str) -> str:
    return map_path + ".split.json"


def _write_manifest(path: str, doc: dict) -> None:
    import tempfile

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


async def _recover_into(state, state_file: str, wal_path: str):
    """Load a stopped partition's durable pair through the ordinary
    recovery path (snapshot + torn-tail truncation + suffix replay)."""
    from ..durability.recovery import recover_state

    return await recover_state(state, state_file, wal_path)


async def run_split(
    map_path: str,
    source: int,
    new_address: str,
    source_state_file: str,
    target_state_file: str,
    *,
    source_wal: str | None = None,
    target_wal: str | None = None,
    source_epoch_file: str | None = None,
    target_epoch_file: str | None = None,
    segment_bytes: int = 65536,
    faults=None,
) -> dict:
    """Run (or resume) one split; returns a report dict.  Idempotent and
    crash-resumable at every :data:`SPLIT_CRASH_POINTS` site — re-invoke
    with the same arguments after any death and it completes.  See the
    module docstring for the stage contract."""
    from ..server.state import ServerState

    source_wal = source_wal or source_state_file + ".wal"
    target_wal = target_wal or target_state_file + ".wal"
    source_epoch_file = source_epoch_file or source_state_file + ".epoch"
    target_epoch_file = target_epoch_file or target_state_file + ".epoch"
    if segment_bytes < 1:
        raise SplitError("segment_bytes must be positive")

    # -- stage 1: the manifest (the split's own write-ahead intent) --------
    mpath = manifest_path(map_path)
    current = PartitionMap.load(map_path)
    if os.path.exists(mpath):
        with open(mpath, encoding="utf-8") as f:
            manifest = json.load(f)
        if manifest.get("schema") != MANIFEST_SCHEMA:
            raise SplitError(
                f"unknown split manifest schema: {manifest.get('schema')!r}"
            )
        if (
            int(manifest["source"]) != source
            or manifest["new_address"] != new_address
        ):
            raise SplitError(
                f"a different split is in progress (source "
                f"{manifest['source']} -> {manifest['new_address']!r}); "
                "finish or remove its manifest first: " + mpath
            )
        log.info(
            "resuming split manifest %s (map v%d -> v%d)",
            mpath, manifest["old_version"], manifest["new_version"],
        )
    else:
        if current.version < 1:  # pragma: no cover - load() validates
            raise SplitError("map failed to load")
        new_map, moved = current.split(source, new_address)
        _crash(faults, "pre_manifest")
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "old_version": current.version,
            "new_version": new_map.version,
            "source": source,
            "new_index": len(current.partitions),
            "new_address": new_address,
            "moved": [[lo, hi] for lo, hi in moved],
            # promotion-style fencing: segments built by THIS split carry
            # source-epoch + 1, so a stale splitter resuming an older
            # manifest is refused by the target's applier
            "epoch": load_epoch(source_epoch_file) + 1,
        }
        _write_manifest(mpath, manifest)

    moved_ranges = [(int(lo), int(hi)) for lo, hi in manifest["moved"]]
    epoch = int(manifest["epoch"])
    new_version = int(manifest["new_version"])

    def moved_user(uid: str) -> bool:
        h = user_hash(uid)
        return any(lo <= h < hi for lo, hi in moved_ranges)

    report = {
        "old_version": int(manifest["old_version"]),
        "new_version": new_version,
        "source": source,
        "new_index": int(manifest["new_index"]),
        "new_address": new_address,
        "moved_ranges": [list(r) for r in moved_ranges],
        "epoch": epoch,
        "copied": False,
        "flipped": False,
        "moved_users": 0,
        "moved_records": 0,
        "segments": 0,
        "dropped_users": 0,
        "dropped_challenges": 0,
        "dropped_sessions": 0,
    }

    flipped = current.version >= new_version

    # -- stage 2: copy the moved subset into the new partition -------------
    if not flipped:
        _crash(faults, "pre_copy")
        src_state = ServerState(**_NO_CAPS)
        await _recover_into(src_state, source_state_file, source_wal)
        records = src_state.export_user_records(moved_user)
        for seq, rec in enumerate(records, start=1):
            rec["seq"] = seq
        report["moved_records"] = len(records)
        report["moved_users"] = sum(
            1 for r in records if r["type"] == "register_user"
        )

        # idempotent restart: a half-written target from a crashed
        # attempt is rebuilt from scratch, never appended to
        for stale in (target_state_file, target_wal, target_epoch_file):
            try:
                os.unlink(stale)
            except OSError:
                pass
        tgt_state = ServerState(**_NO_CAPS)
        twal = WriteAheadLog(target_wal, fsync="always")

        def sink(frames: bytes, last_seq: int) -> None:
            # durable-before-apply, the standby's persist discipline
            twal.append_frames(frames, last_seq)
            twal.sync(force=True)

        applier = SegmentApplier(tgt_state, epoch=epoch, sink=sink)
        segments = split_records(records, epoch, 0, segment_bytes)
        half = (len(segments) + 1) // 2
        for i, seg in enumerate(segments):
            accepted, message = applier.apply(seg)
            if not accepted:
                raise SplitError(
                    f"target refused segment {seg.index}: {message}"
                )
            if i + 1 == half:
                # the half-copied state: target WAL holds frames but no
                # covering snapshot or epoch file exists yet
                _crash(faults, "mid_copy")
        report["segments"] = len(segments)
        if applier.records_skipped:
            log.warning(
                "split copy: %d records refused by the replay trust "
                "boundary (they would not have survived a reboot either)",
                applier.records_skipped,
            )
        # covering snapshot + fencing epoch: the new partition boots
        # through ordinary durability recovery like any other node
        tgt_state.attach_journal(twal)
        await tgt_state.snapshot(target_state_file)
        twal.close()
        store_epoch(target_epoch_file, epoch)
        report["copied"] = True
        _crash(faults, "pre_flip")

        # -- stage 3: flip the map (atomic rename = the ownership edge) ----
        new_map, moved_again = current.split(source, new_address)
        if (
            new_map.version != new_version
            or [list(r) for r in moved_again] != manifest["moved"]
        ):  # pragma: no cover - split() is deterministic over one map
            raise SplitError("map changed under the manifest; aborting")
        new_map.store(map_path)
        report["flipped"] = True
    else:
        report["copied"] = True
        report["flipped"] = True

    # -- stage 4: drain the moved subset from the source -------------------
    _crash(faults, "pre_drain")
    src_state = ServerState(**_NO_CAPS)
    src_report = await _recover_into(src_state, source_state_file, source_wal)
    dropped = src_state.drop_users(moved_user)
    report["dropped_users"], report["dropped_challenges"], \
        report["dropped_sessions"] = dropped
    wal = WriteAheadLog(
        source_wal, fsync="always", start_seq=src_report.next_seq
    )
    src_state.attach_journal(wal)
    src_state._persist_dirty = True  # force a covering snapshot on resume
    await src_state.snapshot(source_state_file)
    # the snapshot covers every record: compact the whole log, exactly the
    # state a graceful shutdown leaves (reboot restores, replays nothing)
    wal.compact(wal.size)
    wal.close()

    _crash(faults, "pre_finish")
    try:
        os.unlink(mpath)
    except OSError:
        pass
    log.info(
        "split complete: map v%d -> v%d, partition %d -> new partition %d "
        "(%s), %d users moved, %d dropped from the source",
        report["old_version"], new_version, source, report["new_index"],
        new_address, report["moved_users"], report["dropped_users"],
    )
    return report
