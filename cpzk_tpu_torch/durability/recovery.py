"""Boot-time crash recovery: snapshot + WAL-suffix replay, bounded loss.

A copy of ``cpzk_tpu/durability/recovery.py`` on the port's own state
store, metrics and tracer.

The recovery invariant (the durability acceptance contract): after any
crash, a reboot yields exactly the acknowledged prefix —

- every mutation acknowledged before the crash is present (snapshot, or
  WAL record fsynced per the policy's loss window);
- no partially-written record is ever applied (``iter_frames`` stops at
  the first bad frame, and the torn tail is truncated on the spot);
- a corrupt snapshot or wholly unreadable WAL is **quarantined** to
  ``<path>.corrupt-<seq>`` (0600 preserved) with a loud ERROR, and the
  server boots from the remaining good state instead of crash-looping.

Replay goes through the same trust-boundary validators as
``ServerState.restore`` (``replay_journal_record``): a tampered log
cannot smuggle in what the live RPC would reject — invalid records are
skipped and counted, never applied and never fatal.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass

from ..errors import UnsupportedFormat
from ..observability import get_tracer
from ..server import metrics
from .wal import (
    NewerFormatError,
    check_record_format,
    iter_frames,
    wal_sealed_segments,
)

log = logging.getLogger("cpzk_tpu_torch.durability")


def quarantine_file(path: str, seq: int) -> str:
    """Move an unreadable snapshot/WAL aside as ``<path>.corrupt-<seq>``
    (suffixed further if that name is taken), preserving 0600 — corrupt or
    not, the file may still hold live bearer tokens.  Returns the new
    path."""
    base = f"{path}.corrupt-{seq}"
    dst, i = base, 0
    while os.path.exists(dst):
        i += 1
        dst = f"{base}.{i}"
    os.replace(path, dst)
    try:
        os.chmod(dst, 0o600)
    except OSError:  # pragma: no cover - chmod on our own fresh rename
        pass
    return dst


@dataclass
class RecoveryReport:
    """What one boot-time recovery pass found and did."""

    snapshot_loaded: bool = False
    snapshot_quarantined: str | None = None
    wal_quarantined: str | None = None
    users: int = 0                 # loaded from the snapshot
    sessions: int = 0              # loaded from the snapshot
    covered_seq: int = 0           # WAL seq the snapshot covers
    replayed: int = 0              # WAL records applied past covered_seq
    skipped: int = 0               # WAL records rejected by the validators
    truncated_bytes: int = 0       # torn tail dropped from the WAL
    next_seq: int = 0              # where the reopened WAL resumes


async def recover_state(state, snapshot_path: str, wal_path: str) -> RecoveryReport:
    """Load the snapshot (quarantining a corrupt one), truncate the WAL's
    torn tail (quarantining a wholly unreadable log), and replay the valid
    suffix past the snapshot's covered sequence number into ``state``.

    ``state`` must be empty (a fresh ``ServerState``); serving must not
    have started — replay writes the maps single-threaded.
    """
    report = RecoveryReport()

    # 1. Read the WAL's valid prefix first: its last sequence number names
    #    the quarantine files, and a quarantined snapshot falls back to
    #    replaying the log from seq 0.  A segmented log is scanned in name
    #    order (sealed segments, then the active file) with the sequence
    #    numbers threaded across file boundaries — one logical prefix.
    records: list[dict] = []
    log_files = [(seg, False) for seg in wal_sealed_segments(wal_path)]
    if os.path.exists(wal_path):
        log_files.append((wal_path, True))
    prev_seq: int | None = None
    poisoned = False  # a corrupt SEALED file ends the trusted prefix
    for fpath, is_active in log_files:
        if poisoned:
            # history past a corrupt sealed segment is unreachable (replay
            # must never skip a gap): set it aside for the operator
            dst = quarantine_file(fpath, int(time.time()))
            log.error(
                "ERROR: WAL file %s follows a corrupt sealed segment; "
                "quarantined to %s", fpath, dst,
            )
            continue  # the reopened log O_CREATs a fresh active file

        def _read_log(p=fpath) -> bytes:
            with open(p, "rb") as f:
                return f.read()

        try:
            # worker thread: the log can be compact_bytes-sized, and boot
            # may run with the health listener already up
            raw = await asyncio.to_thread(_read_log)
        except OSError as e:
            dst = quarantine_file(fpath, int(time.time()))
            report.wal_quarantined = report.wal_quarantined or dst
            log.error(
                "ERROR: write-ahead log %s unreadable (%s); quarantined to %s",
                fpath, e, dst,
            )
            poisoned = not is_active
            continue
        if not raw:
            continue
        frecords, valid = iter_frames(raw, prev_seq=prev_seq)
        # format gate (before anything is replayed): a record stamped
        # newer than this build refuses the whole boot, loudly — the
        # file is fine, the binary is downgraded; quarantining would
        # throw away good data
        for rec in frecords:
            try:
                check_record_format(rec)
            except NewerFormatError as e:
                raise NewerFormatError(
                    f"write-ahead log {fpath}: {e}"
                ) from None
        if not frecords and valid == 0:
            # nonempty but yields no records: not a torn tail, the file
            # is garbage from byte 0 — quarantine rather than truncate
            # away what an operator may want to inspect
            dst = quarantine_file(fpath, int(time.time()))
            report.wal_quarantined = report.wal_quarantined or dst
            log.error(
                "ERROR: write-ahead log %s has no readable frames; "
                "quarantined to %s", fpath, dst,
            )
            poisoned = not is_active
            continue
        records.extend(frecords)
        if frecords:
            prev_seq = frecords[-1]["seq"]
        if valid < len(raw):
            if is_active:
                report.truncated_bytes = len(raw) - valid

                def _truncate() -> None:
                    fd = os.open(wal_path, os.O_WRONLY)
                    try:
                        os.ftruncate(fd, valid)
                        os.fsync(fd)
                    finally:
                        os.close(fd)

                await asyncio.to_thread(_truncate)
                log.warning(
                    "torn WAL tail: dropped %d trailing bytes of %s after "
                    "seq %d (crash mid-append; acknowledged records are "
                    "intact)",
                    report.truncated_bytes, wal_path, records[-1]["seq"],
                )
            else:
                # sealed segments are fsynced before their rename — a bad
                # interior is disk corruption: keep the valid prefix,
                # quarantine the file, refuse everything after the gap
                dst = quarantine_file(fpath, int(time.time()))
                report.wal_quarantined = report.wal_quarantined or dst
                log.error(
                    "ERROR: sealed WAL segment %s is corrupt past a valid "
                    "prefix; quarantined to %s (later log files will be "
                    "set aside — recover them manually if needed)",
                    fpath, dst,
                )
                poisoned = True
    last_seq = records[-1]["seq"] if records else 0

    # 2. Snapshot: corrupt files quarantine and boot, never crash-loop.
    if os.path.exists(snapshot_path):
        try:
            report.users, report.sessions = await state.restore(snapshot_path)
            report.covered_seq = state.restored_wal_seq
            report.snapshot_loaded = True
        except asyncio.CancelledError:
            raise
        except UnsupportedFormat as e:
            # NOT a quarantine case: the snapshot is from a newer build,
            # not corrupt — refuse to boot, naming both versions, so the
            # operator upgrades the binary instead of losing the file
            raise NewerFormatError(
                f"state snapshot {snapshot_path}: {e}"
            ) from e
        except Exception as e:
            report.snapshot_quarantined = quarantine_file(
                snapshot_path, last_seq or int(time.time())
            )
            log.error(
                "ERROR: state snapshot %s failed validation (%s); quarantined "
                "to %s and booting from the write-ahead log alone",
                snapshot_path, e, report.snapshot_quarantined,
            )

    # 3. Replay the suffix beyond the snapshot's covered sequence number.
    #    Challenge records bypass the covered-seq cut: challenges are
    #    deliberately NOT in the snapshot (300 s single-use nonces — see
    #    state.py), so their only durable home is the log.  Replaying the
    #    whole create/consume history is idempotent and cheap (expired
    #    creates drop, consumes of missing ids skip) and keeps in-flight
    #    logins alive across a crash that landed between a snapshot and
    #    the reboot.  The port's compaction keeps every record from the
    #    oldest live challenge's create_challenge on (the reference's
    #    drops them: ROADMAP section C), so no acknowledged challenge is
    #    lost to it.
    for rec in records:
        if rec["seq"] <= report.covered_seq and rec.get("type") not in (
            "create_challenge", "consume_challenge",
        ):
            continue
        msg = state.replay_journal_record(rec)
        if msg is None:
            report.replayed += 1
        else:
            report.skipped += 1
            log.warning(
                "WAL replay skipped seq %d (%s): %s",
                rec["seq"], rec.get("type"), msg,
            )

    report.next_seq = max(report.covered_seq, last_seq)
    if report.replayed:
        metrics.counter("state.recovery.replayed").inc(report.replayed)
    get_tracer().record_event(
        "recovery",
        snapshot_loaded=report.snapshot_loaded,
        snapshot_quarantined=report.snapshot_quarantined or "",
        wal_quarantined=report.wal_quarantined or "",
        covered_seq=report.covered_seq,
        replayed=report.replayed,
        skipped=report.skipped,
        truncated_bytes=report.truncated_bytes,
    )
    log.info(
        "recovery: snapshot users=%d sessions=%d covered_seq=%d; WAL "
        "replayed=%d skipped=%d truncated_bytes=%d next_seq=%d",
        report.users, report.sessions, report.covered_seq,
        report.replayed, report.skipped, report.truncated_bytes,
        report.next_seq,
    )
    return report
