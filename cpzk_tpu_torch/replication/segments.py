"""WAL segments: sealed, CRC-checked slices of the write-ahead log.

A copy of ``cpzk_tpu/replication/segments.py`` on the port's
``durability/wal.py`` framing: the bytes of a segment are the reference's.

The replication unit: the primary chops the write-ahead log's
framed-record stream into segments — a contiguous run of records
``[first_seq, last_seq]`` in the WAL's own wire format, sealed with a
CRC32 over the whole blob — and ships them to the warm standby.  A
segment is *sealed* once it reaches the configured size; the short run
at the head of the active log ships unsealed as a tail-follow delta
(same validation, it just signals "more of this is coming").

Validation on receipt is strict and total (the fuzz harness holds it as
an invariant): a segment either parses into exactly the records its
header claims, or it is rejected whole — a torn or bit-flipped segment
can never partially apply.  Duplicate and overlapping deliveries are
idempotent (records at or below the standby's applied sequence number
are skipped); a gap is refused so prefix-stability is preserved.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

from ..durability.wal import encode_record, iter_frames

#: Sanity cap on one segment's frames blob (a garbage length field must
#: not make the standby buffer gigabytes): the largest sealed segment a
#: sane config produces is segment_bytes + one frame.
MAX_SEGMENT_BYTES = 8 * (1 << 20)


@dataclass
class Segment:
    """One shipped slice of the WAL (see module docstring)."""

    epoch: int
    index: int
    first_seq: int
    last_seq: int
    frames: bytes
    crc: int
    sealed: bool = True


def seal_segment(
    epoch: int, index: int, records: list[dict], sealed: bool = True
) -> Segment:
    """Frame ``records`` (already carrying ``seq``/``type``) into one
    sealed segment.  Re-encoding is canonical (compact, key-sorted JSON),
    so frames built here are byte-identical to the primary's log."""
    if not records:
        raise ValueError("a segment must carry at least one record")
    frames = b"".join(encode_record(r) for r in records)
    return Segment(
        epoch=epoch,
        index=index,
        first_seq=int(records[0]["seq"]),
        last_seq=int(records[-1]["seq"]),
        frames=frames,
        crc=zlib.crc32(frames) & 0xFFFFFFFF,
        sealed=sealed,
    )


def split_records(
    records: list[dict], epoch: int, first_index: int, segment_bytes: int
) -> list[Segment]:
    """Chop a record run into sealed segments of about ``segment_bytes``
    each; the remainder ships as one final *unsealed* tail-follow segment.
    Indexes are ``first_index, first_index+1, ...``."""
    out: list[Segment] = []
    chunk: list[dict] = []
    size = 0
    for rec in records:
        frame_len = len(encode_record(rec))
        chunk.append(rec)
        size += frame_len
        if size >= segment_bytes:
            out.append(seal_segment(epoch, first_index + len(out), chunk))
            chunk, size = [], 0
    if chunk:
        out.append(
            seal_segment(epoch, first_index + len(out), chunk, sealed=False)
        )
    return out


def validate_segment(seg: Segment) -> tuple[list[dict], str | None]:
    """``(records, None)`` when the segment is internally consistent, else
    ``([], reason)``.  Never raises — arbitrary hostile input comes back
    as a rejection reason (the standby refuses and the shipper retries or
    is fenced)."""
    try:
        frames = bytes(seg.frames)
        if not frames:
            return [], "empty segment"
        if len(frames) > MAX_SEGMENT_BYTES:
            return [], "segment exceeds the size cap"
        if zlib.crc32(frames) & 0xFFFFFFFF != int(seg.crc) & 0xFFFFFFFF:
            return [], "segment CRC mismatch"
        records, valid = iter_frames(frames)
        if valid != len(frames) or not records:
            return [], "segment frames do not parse cleanly"
        if records[0]["seq"] != int(seg.first_seq):
            return [], "first_seq does not match the frames"
        if records[-1]["seq"] != int(seg.last_seq):
            return [], "last_seq does not match the frames"
        return records, None
    except Exception as e:  # hostile input is a rejection, not a crash
        return [], f"malformed segment: {e!r}"
