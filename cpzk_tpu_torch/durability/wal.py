"""Write-ahead log: length- and CRC32-framed JSON records on a raw fd.

A copy of ``cpzk_tpu/durability/wal.py`` on the port's own metrics and
errors, plus :attr:`WriteAheadLog.position`, a record's place in the log
that compaction does not move.  The bytes on disk are the reference's — frame header, CRC and the
compact key-sorted JSON records — so a log written by either package is
recovered by the other.

The durability contract the snapshot-only persistence cannot give: an
acknowledged mutation survives a crash *between* snapshot sweeps.  Every
acknowledged change to persisted state (``register_user``,
``create_session``, ``revoke_session``, ``expire_sessions``) is appended
here before the RPC returns; boot-time recovery replays the suffix past
the last snapshot's covered sequence number (see :mod:`.recovery`).

Frame format (all integers big-endian)::

    +----------------+----------------+------------------------+
    | length  u32    | crc32   u32    | payload (JSON, length) |
    +----------------+----------------+------------------------+

The CRC covers the payload only; the payload is one JSON object with at
least ``{"seq": <monotonic int>, "type": <str>}``.  A reader accepts the
longest prefix of well-formed frames with strictly increasing sequence
numbers and stops at the first violation — a torn tail (the crash left a
partial frame) and mid-log corruption are therefore indistinguishable by
construction, and neither can ever make a partially-written record
visible to replay.

Fsync policy (``durability.fsync``):

- ``always``   — fsync before the mutation is acknowledged (loss window:
  none for acknowledged writes).
- ``interval`` — fsync at most every ``fsync_interval_ms``, piggybacked
  on appends and forced by the periodic sweep (loss window: about one
  interval of acknowledged writes).
- ``off``      — never fsync explicitly; the OS page cache decides
  (loss window: everything since the kernel's last writeback).

Appends go through ``os.write`` on an ``O_APPEND`` fd (no user-space
buffer), so ``size`` always reflects what a crashed process left in the
file.  The file is created 0600 and re-chmodded defensively: session
records hold live bearer tokens, the same protection requirement as the
snapshot.

Segmented mode (``wal_segment_bytes > 0``): the active file is sealed
into immutable ``<path>.<first_seq>-<last_seq>.seg`` files (zero-padded,
so lexicographic name order IS sequence order — the proof log's rotation
discipline) once it outgrows the threshold, off the event loop (the seal
runs inside :meth:`WriteAheadLog.sync` on the caller's worker thread).
Compaction then **unlinks** fully-covered sealed segments instead of
copying the surviving tail under the fd lock — the append stall stops
scaling with tail size (the million-user cliff).  All byte
offsets exposed by the class (``size``, ``read_from``, ``compact``,
``truncate_to``) are *logical*: positions in the concatenation of sealed
segments plus the active file, rebased by ``freed`` on compaction exactly
as the single-file offsets always were, so the snapshot watermark and the
replication shipper's acked-offset bookkeeping carry over unchanged.

Deterministic crash points (``pre_append`` / ``mid_frame`` /
``post_append_pre_fsync`` / ``pre_rename``, plus ``pre_seal`` /
``pre_unlink`` in segmented mode) are consulted on a
:class:`~cpzk_tpu_torch.resilience.faults.FaultPlan` passed as ``faults`` —
each raises :class:`CrashPoint` at exactly the file state a process
death at that instruction would leave, so the recovery tests assert
exact outcomes instead of sampling kill timing.
"""

from __future__ import annotations

import json
import os
import re
import struct
import tempfile
import threading
import time
import zlib

from ..errors import UnsupportedFormat
from ..server import metrics

_HEADER = struct.Struct(">II")
HEADER_BYTES = _HEADER.size

#: Sanity cap on one frame's payload: a garbage length field must not make
#: the reader allocate gigabytes (largest real record is a register_user
#: at a few hundred bytes).
MAX_FRAME_PAYLOAD = 1 << 20

#: Format version stamped into every record this writer appends (the
#: ``"fmt"`` key; proof-log records carry the same stamp).  Recovery
#: refuses a record stamped NEWER than this — a downgraded binary must
#: never half-understand a newer format and silently misreplay — while
#: records with no stamp (files from before the stamp) keep loading: the absence
#: of the key IS version 1.  Replay itself ignores unknown keys, so a
#: same-or-older stamp costs nothing.
WAL_FORMAT_VERSION = 1

#: The deterministic crash sites a FaultPlan can schedule (see
#: ``FaultPlan.crash_on``); occurrence indexes count per-site visits.
WAL_CRASH_POINTS = (
    "pre_append",            # nothing written for this record
    "mid_frame",             # half the frame written: a torn tail on disk
    "post_append_pre_fsync",  # full frame written, never fsynced
    "pre_rename",            # compaction tmp written, rename never happened
    "pre_seal",              # active file fsynced, seal rename never happened
    "pre_unlink",            # covered segment still on disk after compaction
)


class CrashPoint(RuntimeError):
    """Deterministic injected crash at a WAL write site — stands in for the
    process dying at exactly that instruction (the SIGKILL subprocess test
    does it for real)."""


def frame_payload(payload: bytes) -> bytes:
    """One framed blob: the shared ``length u32 | crc32 u32 | payload``
    header over arbitrary bytes.  THE construction helper for every
    plane speaking this discipline — the WAL and proof log (JSON records
    via :func:`encode_record`), and the sharded-ingest unix pipe
    (pickled request frames).  Hand-rolling the header elsewhere is a
    FRAME-001 finding: one copy of the contract, zero drift."""
    return _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def unpack_frame_header(header: bytes) -> tuple[int, int]:
    """``(length, crc32)`` from one ``HEADER_BYTES``-byte frame header —
    the streaming read seam for consumers that cannot buffer the whole
    log (the ingest pipe reads frame-by-frame off a socket;
    :func:`iter_frames` is the whole-buffer scanner)."""
    return _HEADER.unpack(header)


def frame_crc_ok(payload: bytes, crc: int) -> bool:
    """Whether ``payload`` matches the header's CRC (masked compare,
    exactly as :func:`iter_frames` validates)."""
    return zlib.crc32(payload) & 0xFFFFFFFF == int(crc) & 0xFFFFFFFF


def encode_record(rec: dict) -> bytes:
    """One framed record: compact, key-sorted JSON behind length + CRC32."""
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True).encode()
    if len(payload) > MAX_FRAME_PAYLOAD:
        raise ValueError(f"WAL record exceeds {MAX_FRAME_PAYLOAD} bytes")
    return frame_payload(payload)


class NewerFormatError(UnsupportedFormat, ValueError):
    """A record (WAL or proof log) is stamped with a format version newer
    than this build writes — a downgraded binary looking at a newer
    file.  Recovery refuses LOUDLY (raises, never quarantines): the file
    is not corrupt, the binary is old, and silently replaying what it
    half-understands would be data loss with extra steps.  Subclasses
    :class:`~cpzk_tpu_torch.errors.UnsupportedFormat` (the shared refusal
    taxonomy — snapshot version gates raise it too) and ``ValueError``
    (so pre-existing broad handlers keep their semantics)."""


def check_record_format(rec: dict) -> None:
    """Refuse a record stamped newer than ``WAL_FORMAT_VERSION`` (or with
    a junk stamp).  Unstamped records pass — pre-stamp files are format
    version 1 by definition."""
    fmt = rec.get("fmt")
    if fmt is None:
        return
    if not isinstance(fmt, int) or isinstance(fmt, bool) or fmt < 1:
        raise NewerFormatError(
            f"record seq {rec.get('seq')} carries an unintelligible "
            f"format stamp {fmt!r} (this build writes format "
            f"{WAL_FORMAT_VERSION})"
        )
    if fmt > WAL_FORMAT_VERSION:
        raise NewerFormatError(
            f"record seq {rec.get('seq')} is format version {fmt}, newer "
            f"than this build supports ({WAL_FORMAT_VERSION}) — run a "
            "binary at least as new as the one that wrote it"
        )


def iter_frames(
    buf: bytes, offset: int = 0, prev_seq: int | None = None
) -> tuple[list[dict], int]:
    """``(records, valid_bytes)``: the longest well-formed prefix of ``buf``.

    Stops at the first short header, oversized/zero length field, CRC
    mismatch, non-JSON payload, schema violation (missing ``seq``/``type``),
    or non-increasing sequence number.  ``valid_bytes`` is the byte offset
    the file should be truncated to; everything past it is a torn tail or
    corruption and is never surfaced as a record.

    ``offset``/``prev_seq`` resume a previous scan mid-file (the audit
    pipeline's cursor): parsing starts at ``offset`` and the first record's
    sequence number must exceed ``prev_seq`` — byte-identical results to
    one whole-buffer scan split at any frame boundary.
    """
    out: list[dict] = []
    off = offset
    n = len(buf)
    while n - off >= HEADER_BYTES:
        length, crc = _HEADER.unpack_from(buf, off)
        if length == 0 or length > MAX_FRAME_PAYLOAD:
            break
        end = off + HEADER_BYTES + length
        if end > n:
            break  # torn tail: the frame was cut mid-write
        payload = bytes(buf[off + HEADER_BYTES:end])
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        try:
            rec = json.loads(payload)
        except ValueError:
            break
        if (
            not isinstance(rec, dict)
            or not isinstance(rec.get("seq"), int)
            or isinstance(rec.get("seq"), bool)
            or not isinstance(rec.get("type"), str)
        ):
            break
        if prev_seq is not None and rec["seq"] <= prev_seq:
            break
        prev_seq = rec["seq"]
        out.append(rec)
        off = end
    return out, off


def read_frames(path: str) -> tuple[list[dict], int, int]:
    """``(records, valid_bytes, file_bytes)`` for the log at ``path``."""
    with open(path, "rb") as f:
        raw = f.read()
    records, valid = iter_frames(raw)
    return records, valid, len(raw)


#: Sealed-segment name template: zero-padded first/last sequence numbers
#: so lexicographic order equals sequence order (the reference proof log's
#: rotation discipline).
_SEG_WIDTH = 12
_SEG_RE = re.compile(r"\.(\d{12})-(\d{12})\.seg$")


def wal_segment_name(path: str, first_seq: int, last_seq: int) -> str:
    return (
        f"{path}.{first_seq:0{_SEG_WIDTH}d}-{last_seq:0{_SEG_WIDTH}d}.seg"
    )


def wal_segment_range(seg_path: str) -> tuple[int, int]:
    """``(first_seq, last_seq)`` encoded in a sealed-segment name."""
    m = _SEG_RE.search(seg_path)
    if m is None:
        raise ValueError(f"not a sealed WAL segment name: {seg_path!r}")
    return int(m.group(1)), int(m.group(2))


def wal_sealed_segments(path: str) -> list[str]:
    """Sealed-segment files rotated out of the log at ``path``, sequence
    order (their zero-padded names sort that way).  A directory scan, not
    in-memory state — survives restarts, exactly like the proof log's."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    try:
        names = os.listdir(d)
    except OSError:
        return []
    out = [
        os.path.join(d, n)
        for n in names
        if n.startswith(base + ".") and _SEG_RE.search(n)
    ]
    out.sort()
    return out


def wal_files(path: str) -> list[str]:
    """Every file holding this log's records, read order: sealed segments
    (sequence order), then the active file when it exists — the set a
    boot-time recovery must scan."""
    out = wal_sealed_segments(path)
    if os.path.exists(path):
        out.append(path)
    return out


class WriteAheadLog:
    """Append-only framed-record log with a configurable fsync policy.

    ``append`` is synchronous and cheap (one ``os.write`` into the page
    cache) so :class:`~cpzk_tpu_torch.server.state.ServerState` can call it
    under its state lock — WAL order then always matches in-memory
    application order.  The fsync (when the policy wants one) happens in
    :meth:`sync`, which callers run on a worker thread *after* releasing
    the lock but *before* acknowledging the mutation; fsync flushes every
    earlier write too, so per-record durability still holds under
    interleaving.

    A threading lock guards the fd: appends come from the event loop,
    ``sync`` and :meth:`compact` from worker threads.
    """

    def __init__(
        self,
        path: str,
        fsync: str = "always",
        fsync_interval_ms: float = 50.0,
        start_seq: int = 0,
        faults=None,
        segment_bytes: int = 0,
    ):
        if fsync not in ("always", "interval", "off"):
            raise ValueError(f"unknown WAL fsync policy: {fsync!r}")
        if segment_bytes < 0:
            raise ValueError("segment_bytes cannot be negative")
        self.path = path
        self.policy = fsync
        self.interval_s = fsync_interval_ms / 1000.0
        self.seq = start_seq
        self.segment_bytes = segment_bytes
        self._faults = faults
        self._lock = threading.Lock()
        # sealed segments already on disk (a restart, or a config change):
        # (path, byte length) in sequence order.  Loaded regardless of
        # segment_bytes so logical offsets stay correct after a downgrade.
        self._segments: list[tuple[str, int]] = [
            (seg, os.path.getsize(seg)) for seg in wal_sealed_segments(path)
        ]
        self._fd: int | None = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600
        )
        os.chmod(path, 0o600)  # session records are bearer secrets
        self._active_size = os.fstat(self._fd).st_size
        self.size = self._sealed_bytes() + self._active_size
        # bytes compaction has dropped since this process opened the log:
        # ``freed_total + size`` is where the next record starts, a
        # position that compaction never moves (the port's challenge
        # records are pinned by it; see DurabilityManager.checkpoint)
        self.freed_total = 0
        # first sequence number in the active file (names the seal): from
        # the file's own first frame when it has history, else the next
        # append's number
        self._active_first_seq = self.seq + 1
        if self._active_size and (self.segment_bytes or self._segments):
            # segmented mode needs the active file's own seq span (it
            # names the next seal); legacy mode keeps the caller's
            # start_seq untouched, exactly as before
            try:
                records, _, _ = read_frames(path)
                if records:
                    self._active_first_seq = int(records[0]["seq"])
                    self.seq = max(self.seq, int(records[-1]["seq"]))
            except OSError:  # pragma: no cover - racing external rotation
                pass
        for seg, _bytes in self._segments:
            try:
                self.seq = max(self.seq, wal_segment_range(seg)[1])
            except ValueError:  # pragma: no cover - name-filtered above
                pass
        self._rotate_due = False
        self._pending = 0  # appends since the last fsync
        self._last_fsync = time.monotonic()
        self._export_segment_gauge()

    def _sealed_bytes(self) -> int:
        return sum(b for _, b in self._segments)

    @property
    def segment_count(self) -> int:
        return len(self._segments)

    def _export_segment_gauge(self) -> None:
        metrics.gauge("state.wal.segments").set(float(len(self._segments)))

    # -- append / sync -------------------------------------------------------

    def _crash(self, point: str) -> bool:
        return self._faults is not None and self._faults.take_crash(point)

    def append(self, rtype: str, payload: dict) -> int:
        """Frame and write one record; returns its sequence number.  The
        record is in the OS page cache after this returns — call
        :meth:`sync` before acknowledging when the policy demands it."""
        with self._lock:
            if self._fd is None:
                raise OSError("write-ahead log is closed")
            seq = self.seq + 1
            rec = {"seq": seq, "type": rtype, "fmt": WAL_FORMAT_VERSION}
            rec.update(payload)
            frame = encode_record(rec)
            if self._crash("pre_append"):
                raise CrashPoint(f"pre_append at seq {seq}")
            if self._crash("mid_frame"):
                cut = max(1, len(frame) // 2)
                os.write(self._fd, frame[:cut])
                self.size += cut
                self._active_size += cut
                raise CrashPoint(f"mid_frame at seq {seq}")
            os.write(self._fd, frame)
            self.seq = seq
            self.size += len(frame)
            self._active_size += len(frame)
            self._pending += 1
            metrics.counter("state.wal.appends").inc()
            metrics.counter("state.wal.bytes").inc(len(frame))
            if self.segment_bytes and self._active_size >= self.segment_bytes:
                # sealed off the event loop: sync() (always run on a
                # worker thread by callers) performs the rotation
                self._rotate_due = True
            if self._crash("post_append_pre_fsync"):
                raise CrashPoint(f"post_append_pre_fsync at seq {seq}")
            return seq

    def append_frames(self, frames: bytes, last_seq: int) -> None:
        """Append pre-framed records verbatim, adopting ``last_seq`` as the
        log head — the replication standby's write path: shipped segments
        keep the PRIMARY's sequence numbers (replay and a later promotion
        continue the same numbering), so they must not be re-framed
        through :meth:`append`.  The caller has already validated the
        frames (CRC + parse + contiguity); fsync policy applies as usual
        via :meth:`sync`."""
        with self._lock:
            if self._fd is None:
                raise OSError("write-ahead log is closed")
            if last_seq <= self.seq:
                raise ValueError(
                    f"append_frames would move seq backwards "
                    f"({last_seq} <= {self.seq})"
                )
            os.write(self._fd, frames)
            self.seq = last_seq
            self.size += len(frames)
            self._active_size += len(frames)
            self._pending += 1
            metrics.counter("state.wal.appends").inc()
            metrics.counter("state.wal.bytes").inc(len(frames))
            if self.segment_bytes and self._active_size >= self.segment_bytes:
                self._rotate_due = True

    def needs_sync(self) -> bool:
        """Whether :meth:`sync` would do work right now — an fsync the
        policy wants, or a due segment seal — so the async caller can
        skip the worker-thread hop entirely otherwise."""
        if self._rotate_due:
            return True
        if self._pending == 0 or self.policy == "off":
            return False
        if self.policy == "always":
            return True
        return time.monotonic() - self._last_fsync >= self.interval_s

    def sync(self, force: bool = False) -> bool:
        """Fsync pending appends per the policy (``force`` overrides it);
        returns whether an fsync happened.  In segmented mode a due seal
        happens here too — callers always run :meth:`sync` on a worker
        thread, so the seal's fsync + rename never stall the event loop."""
        with self._lock:
            if self._fd is not None and self._rotate_due:
                self._seal_active_locked()
                return True
            if self._fd is None or self._pending == 0:
                return False
            if not force:
                if self.policy == "off":
                    return False
                if (
                    self.policy == "interval"
                    and time.monotonic() - self._last_fsync < self.interval_s
                ):
                    return False
            os.fsync(self._fd)
            self._pending = 0
            self._last_fsync = time.monotonic()
            metrics.counter("state.wal.fsyncs").inc()
            return True

    @property
    def last_fsync_age_s(self) -> float:
        """Seconds since the last fsync (or since open, if none yet)."""
        return max(0.0, time.monotonic() - self._last_fsync)

    @property
    def pending(self) -> int:
        return self._pending

    def _seal_active_locked(self) -> None:
        """Rotate the active file into an immutable sealed segment:
        fsync (a sealed segment is durable by definition), atomic rename
        to ``<path>.<first>-<last>.seg``, reopen a fresh active file.
        Caller holds ``_lock`` and runs on a worker thread."""
        assert self._fd is not None
        self._rotate_due = False
        if self._active_size == 0 or self.seq < self._active_first_seq:
            return  # nothing to seal (raced a compaction that truncated)
        os.fsync(self._fd)
        if self._crash("pre_seal"):
            # the process dies with the active file fsynced but the
            # rename not done: recovery sees the same records, unsealed
            raise CrashPoint(
                f"pre_seal of segments {self._active_first_seq}-{self.seq}"
            )
        os.close(self._fd)
        self._fd = None
        sealed = wal_segment_name(
            self.path, self._active_first_seq, self.seq
        )
        os.replace(self.path, sealed)
        self._segments.append((sealed, self._active_size))
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600
        )
        os.chmod(self.path, 0o600)
        self._active_size = 0
        self._active_first_seq = self.seq + 1
        self._pending = 0
        self._last_fsync = time.monotonic()
        metrics.counter("state.wal.rotations").inc()
        self._export_segment_gauge()

    def read_from(self, offset: int = 0) -> bytes:
        """Every log byte at or past the *logical* ``offset`` — the
        concatenation of sealed segments plus the active file.  The read
        seam the replication shipper tails and promotion replays through;
        single-file logs read exactly as before.  Runs under the fd lock
        (callers are worker threads); a torn concurrent append surfaces
        as a torn tail, which ``iter_frames`` already refuses to parse."""
        with self._lock:
            out = bytearray()
            pos = 0
            for seg, nbytes in self._segments:
                end = pos + nbytes
                if offset < end:
                    try:
                        with open(seg, "rb") as f:
                            f.seek(max(0, offset - pos))
                            out += f.read()
                    except FileNotFoundError:  # pragma: no cover - racing unlink
                        pass
                pos = end
            try:
                with open(self.path, "rb") as f:
                    f.seek(max(0, offset - pos))
                    out += f.read()
            except FileNotFoundError:  # pragma: no cover - closed + unlinked
                pass
            return bytes(out)

    # -- compaction ----------------------------------------------------------

    def compact(self, upto_offset: int) -> int:
        """Drop the byte prefix a snapshot now covers; returns bytes
        freed.  Offsets are logical (see the module docstring); callers
        rebase their own offsets by the return value exactly as before.

        **Segmented mode** (``segment_bytes > 0``): fully-covered sealed
        segments are simply **unlinked** — no copy, no stall proportional
        to the surviving tail (the ``pre_unlink`` crash point stands in
        for dying between unlinks: leftover covered segments replay
        idempotently at the next boot).  A covered prefix that ends
        inside the active file waits for that file's own seal, except
        when the WHOLE log is covered, where the active file is
        ftruncated to zero in place (O(1)).  **Single-file mode**
        (``segment_bytes == 0``, no sealed segments on disk): the
        historical copy-and-rename path, byte-for-byte, including the
        ``pre_rename`` all-or-nothing crash point."""
        with self._lock:
            size = self.size
            try:
                return self._compact_locked(upto_offset)
            finally:
                # every path (a crash point's included) shrinks ``size``
                # by exactly what it dropped
                self.freed_total += size - self.size

    @property
    def position(self) -> int:
        """Where the next record starts, counted from the log's first byte
        when this process opened it: unlike the logical offsets,
        compaction leaves it unchanged."""
        return self.freed_total + self.size

    def _compact_locked(self, upto_offset: int) -> int:
        if self._fd is None:
            raise OSError("write-ahead log is closed")
        upto = max(0, min(upto_offset, self.size))
        if upto == 0:
            return 0
        freed = 0
        # 1) unlink sealed segments the covered prefix fully spans
        while self._segments and self._segments[0][1] <= upto:
            seg, nbytes = self._segments[0]
            if self._crash("pre_unlink"):
                raise CrashPoint(f"pre_unlink of {os.path.basename(seg)}")
            try:
                os.unlink(seg)
            except FileNotFoundError:  # pragma: no cover - already gone
                pass
            self._segments.pop(0)
            upto -= nbytes
            freed += nbytes
            self.size -= nbytes
        if self._segments:
            # the boundary lies inside a sealed segment: it stays
            # until a later snapshot covers it whole (no partial
            # rewrites of immutable files)
            self._export_segment_gauge()
            return freed
        # 2) the remaining covered prefix lies inside the active file
        if upto <= 0:
            self._export_segment_gauge()
            return freed
        if self.segment_bytes:
            if upto >= self._active_size:
                # whole log covered: empty the active file in place
                os.ftruncate(self._fd, 0)
                freed += self._active_size
                self.size -= self._active_size
                self._active_size = 0
                self._active_first_seq = self.seq + 1
                self._pending = 0
                self._rotate_due = False
            # else: wait for the seal — never copy under the fd lock
            self._export_segment_gauge()
            return freed
        # single-file mode: the historical copy-compaction
        with open(self.path, "rb") as f:
            f.seek(upto)
            tail = f.read()
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        prefix = "." + os.path.basename(self.path) + ".compact."
        fd, tmp = tempfile.mkstemp(prefix=prefix, dir=d)  # 0600
        try:
            if tail:
                os.write(fd, tail)
            os.fsync(fd)
            os.close(fd)
            if self._crash("pre_rename"):
                raise CrashPoint("pre_rename during WAL compaction")
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        os.close(self._fd)
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600
        )
        freed += self._active_size - len(tail)
        self.size -= self._active_size - len(tail)
        self._active_size = len(tail)
        self._pending = 0  # the tmp copy was fsynced before the rename
        return freed

    def truncate_to(self, valid_bytes: int) -> int:
        """Drop everything past the *logical* offset ``valid_bytes`` (the
        torn tail a standby found at promotion time); returns bytes
        dropped.  Callers pass the valid-prefix boundary ``iter_frames``
        reported over :meth:`read_from` output.  Sealed segments are
        fsynced before their rename, so the boundary normally lands in
        the active file; a boundary inside a sealed segment (disk
        corruption) truncates that segment in place, renames it to its
        corrected seq range, and drops everything after it."""
        with self._lock:
            if self._fd is None:
                raise OSError("write-ahead log is closed")
            valid = max(0, min(valid_bytes, self.size))
            dropped = self.size - valid
            if not dropped:
                return 0
            active_start = self.size - self._active_size
            if valid >= active_start:
                # the normal case: the torn tail is in the active file
                keep = valid - active_start
                fd = os.open(self.path, os.O_WRONLY)
                try:
                    os.ftruncate(fd, keep)
                    os.fsync(fd)
                finally:
                    os.close(fd)
                self._active_size = keep
                self.size = valid
                return dropped
            # corruption inside a sealed segment: drop the active file
            # and every later segment, cut the straddled one in place
            fd = os.open(self.path, os.O_WRONLY)
            try:
                os.ftruncate(fd, 0)
                os.fsync(fd)
            finally:
                os.close(fd)
            self._active_size = 0
            pos = 0
            keep_segments: list[tuple[str, int]] = []
            for seg, nbytes in self._segments:
                end = pos + nbytes
                if end <= valid:
                    keep_segments.append((seg, nbytes))
                elif pos < valid:
                    # straddled: truncate, rescan, rename to the real range
                    cut = valid - pos
                    sfd = os.open(seg, os.O_WRONLY)
                    try:
                        os.ftruncate(sfd, cut)
                        os.fsync(sfd)
                    finally:
                        os.close(sfd)
                    records, _, _ = read_frames(seg)
                    if records:
                        fixed = wal_segment_name(
                            self.path, int(records[0]["seq"]),
                            int(records[-1]["seq"]),
                        )
                        os.replace(seg, fixed)
                        keep_segments.append((fixed, cut))
                    else:
                        os.unlink(seg)
                else:
                    try:
                        os.unlink(seg)
                    except FileNotFoundError:  # pragma: no cover
                        pass
                pos = end
            self._segments = keep_segments
            self.size = self._sealed_bytes()
            self._active_first_seq = self.seq + 1
            self._export_segment_gauge()
            return dropped

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Force-sync pending appends and release the fd (idempotent)."""
        self.sync(force=True)
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
