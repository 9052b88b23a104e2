"""The frame header of ``cpzk_tpu/durability/wal.py``.

``length u32 | crc32 u32 | payload``, big-endian: the reference's WAL,
proof log and sharded-ingest pipe all speak it.  Only the framing is
ported, for the ingest seam (:mod:`cpzk_tpu_torch.server.ingest`); the
write-ahead log itself comes with the port's durability subsystem.
"""

from __future__ import annotations

import struct
import zlib

_HEADER = struct.Struct(">II")
HEADER_BYTES = _HEADER.size


def frame_payload(payload: bytes) -> bytes:
    """One framed blob: the ``length u32 | crc32 u32 | payload`` header
    over arbitrary bytes."""
    return _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def unpack_frame_header(header: bytes) -> tuple[int, int]:
    """``(length, crc32)`` from one ``HEADER_BYTES``-byte frame header —
    the streaming read seam for a consumer reading frame by frame off a
    socket."""
    return _HEADER.unpack(header)


def frame_crc_ok(payload: bytes, crc: int) -> bool:
    """Whether ``payload`` matches the header's CRC (masked compare)."""
    return zlib.crc32(payload) & 0xFFFFFFFF == int(crc) & 0xFFFFFFFF
