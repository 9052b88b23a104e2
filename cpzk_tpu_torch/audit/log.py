"""Proof log: an append-only, CRC-framed record of verification outcomes.

The serving plane's audit trail, a copy of ``cpzk_tpu/audit/log.py`` on
the port's write-ahead log framing.  When ``[audit]`` is enabled, the
service appends one record per verified proof — the statement halves,
the challenge context, the proof wire, and the verdict the serving path
returned — using the SAME framing discipline as the durability
write-ahead log (:mod:`cpzk_tpu_torch.durability.wal`): length + CRC32
header, compact key-sorted JSON payload with a strictly increasing
``seq``, torn tails and mid-log corruption indistinguishable and never
surfaced as records.  The frames' bytes are the reference's, so either
package replays the other's log.  The bulk audit pipeline
(:mod:`cpzk_tpu_torch.audit.pipeline`) later replays the log through the
batch engine on the card and signs what it found.

Record schema (type ``"proof"``)::

    {"seq": n, "type": "proof", "u": user_id, "y1": hex, "y2": hex,
     "ctx": hex-challenge-id, "p": hex-proof-wire, "v": 0|1, "t": unix}

Unknown record types parse cleanly and are skipped by the replayer (a
durability WAL therefore *parses* as a proof log — its records simply
audit to zero proofs), so the two log families can share tooling.

The writer mirrors :class:`~cpzk_tpu_torch.durability.wal.WriteAheadLog`'s
threading contract — sync, cheap ``append_proofs`` (one ``os.write`` into
the page cache, callable from the event loop), fsync policy applied in
``sync()`` off-thread — but keeps its own metrics namespace
(``audit.log.*``) and has no compaction: an audit trail is append-only
by design; rotate by pointing ``[audit] log_path`` somewhere new, or let
``segment_bytes`` seal segments.
"""

from __future__ import annotations

import os
import re
import threading
import time

from ..durability.wal import (
    MAX_FRAME_PAYLOAD,
    WAL_FORMAT_VERSION,
    NewerFormatError,
    check_record_format,
    encode_record,
    iter_frames,
)
from ..server import metrics

__all__ = [
    "MAX_FRAME_PAYLOAD",
    "ProofLogWriter",
    "proof_record",
    "read_log",
    "scan_records",
    "sealed_segments",
    "segment_name",
    "validate_proof_record",
]

#: Field caps mirroring the service-side wire limits (service.py): a log
#: written by the service can never violate these, so a record that does
#: is tampered and is skipped by the replayer, never verified.
MAX_CTX_HEX = 64 * 2
MAX_PROOF_HEX = 8192 * 2
MAX_ELEMENT_HEX = 32 * 2
MAX_USER_ID = 256


def proof_record(
    user_id: str,
    y1: bytes,
    y2: bytes,
    context: bytes,
    proof_wire: bytes,
    verdict: bool,
    now: int | None = None,
) -> dict:
    """One proof-log payload (everything but ``seq``, which the writer
    assigns under its lock)."""
    return {
        "u": user_id,
        "y1": y1.hex(),
        "y2": y2.hex(),
        "ctx": context.hex(),
        "p": proof_wire.hex(),
        "v": 1 if verdict else 0,
        "t": int(time.time()) if now is None else int(now),
    }


def validate_proof_record(rec: dict) -> str | None:
    """``None`` when ``rec`` is a well-formed ``proof`` record the
    replayer may verify; else a short reason string.  Total over
    arbitrary parsed JSON (the fuzz invariant) — never raises."""
    try:
        if rec.get("type") != "proof":
            return "not-a-proof-record"
        u = rec.get("u")
        if not isinstance(u, str) or len(u) > MAX_USER_ID:
            return "bad-user"
        for key, cap in (("y1", MAX_ELEMENT_HEX), ("y2", MAX_ELEMENT_HEX),
                         ("ctx", MAX_CTX_HEX), ("p", MAX_PROOF_HEX)):
            value = rec.get(key)
            if not isinstance(value, str) or not value or len(value) > cap:
                return f"bad-{key}"
            if len(value) % 2:
                return f"bad-{key}"
            try:
                bytes.fromhex(value)
            except ValueError:
                return f"bad-{key}"
        v = rec.get("v")
        if v not in (0, 1) or isinstance(v, bool):
            return "bad-verdict"
        return None
    except Exception:  # pragma: no cover - dict subclass shenanigans
        return "bad-record"


def scan_records(
    buf: bytes, offset: int = 0, prev_seq: int | None = None
) -> tuple[list[dict], int]:
    """``(records, valid_bytes)`` from ``offset`` in a proof-log buffer —
    the WAL prefix contract (:func:`cpzk_tpu_torch.durability.wal.iter_frames`)
    with resumable offset/seq, shared by the pipeline and the fuzz
    harness."""
    return iter_frames(buf, offset=offset, prev_seq=prev_seq)


def read_log(path: str) -> tuple[list[dict], int, int]:
    """``(records, valid_bytes, file_bytes)`` for the log at ``path``."""
    with open(path, "rb") as f:
        raw = f.read()
    records, valid = scan_records(raw)
    return records, valid, len(raw)


#: Sealed-segment name template: zero-padded first/last sequence numbers
#: so lexicographic order equals sequence order.
_SEG_WIDTH = 12
_SEG_SUFFIX = ".seg"
_SEG_RE = re.compile(r"\.(\d{12})-(\d{12})\.seg$")


def segment_name(path: str, first_seq: int, last_seq: int) -> str:
    return (
        f"{path}.{first_seq:0{_SEG_WIDTH}d}-{last_seq:0{_SEG_WIDTH}d}"
        f"{_SEG_SUFFIX}"
    )


def _segment_seq_range(seg_path: str) -> tuple[int, int]:
    m = _SEG_RE.search(seg_path)
    if m is None:
        raise ValueError(f"not a sealed proof-log segment name: {seg_path!r}")
    return int(m.group(1)), int(m.group(2))


def sealed_segments(path: str) -> list[str]:
    """Sealed-segment files rotated out of the log at ``path``, sequence
    order (their zero-padded names sort that way)."""
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


class ProofLogWriter:
    """Append-only framed proof log with a configurable fsync policy.

    ``append_proofs`` is synchronous and cheap (one ``os.write`` for the
    whole batch of frames) so the service can call it on the event loop
    right after a batch of verdicts settles; the fsync — when the policy
    wants one — happens in :meth:`sync` on a worker thread.  Created
    0600: the log carries statements and challenge ids (public-ish), but
    an audit trail's integrity expectations match the WAL's.

    **Rotation** (``segment_bytes > 0``): once the active file reaches
    the threshold it is force-synced and atomically renamed to
    ``<path>.<first_seq>-<last_seq>.seg`` (zero-padded, so lexicographic
    order IS sequence order) and a fresh active file opens.  Sealed
    segments are immutable, so a shipper can copy them to a standby
    while the active tail grows.  ``python -m cpzk_tpu_torch.audit run``
    accepts the directory of rotated segments directly.
    """

    def __init__(
        self,
        path: str,
        fsync: str = "off",
        fsync_interval_ms: float = 200.0,
        segment_bytes: int = 0,
    ):
        if fsync not in ("always", "interval", "off"):
            raise ValueError(f"unknown proof-log fsync policy: {fsync!r}")
        if segment_bytes < 0:
            raise ValueError("segment_bytes cannot be negative")
        self.path = path
        self.policy = fsync
        self.interval_s = fsync_interval_ms / 1000.0
        self.segment_bytes = segment_bytes
        self._lock = threading.Lock()
        self._fd: int | None = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600
        )
        os.chmod(path, 0o600)
        self.size = os.fstat(self._fd).st_size
        # resume numbering past an existing log so an appended-to log
        # still satisfies the strictly-increasing-seq prefix contract.
        # With rotation, sealed segments hold the earlier history — the
        # active file resumes past the LAST sealed segment too.
        self.seq = 0
        for seg in self.sealed_segments():
            _first, last = _segment_seq_range(seg)
            self.seq = max(self.seq, last)
        self.file_first_seq = self.seq + 1
        if self.size:
            try:
                records, _, _ = read_log(path)
                # format gate (same contract as WAL recovery): refuse to
                # append after records stamped newer than this build
                # writes — naming both versions and the file
                for rec in records:
                    try:
                        check_record_format(rec)
                    except NewerFormatError as e:
                        raise NewerFormatError(
                            f"proof log {path}: {e}"
                        ) from None
                if records:
                    self.file_first_seq = int(records[0]["seq"])
                    self.seq = max(self.seq, int(records[-1]["seq"]))
            except OSError:  # pragma: no cover - racing rotation
                pass
        self.records = 0
        self.rotations = 0
        self._pending = 0
        self._last_fsync = time.monotonic()

    # -- append / sync -------------------------------------------------------

    def append_proofs(self, payloads: list[dict]) -> int:
        """Frame and write a batch of proof records in ONE ``os.write``;
        returns the last assigned sequence number.  Records land in the
        OS page cache; call :meth:`sync` (off-thread) afterwards when the
        policy wants durability."""
        if not payloads:
            return self.seq
        with self._lock:
            if self._fd is None:
                raise OSError("proof log is closed")
            frames = bytearray()
            for payload in payloads:
                self.seq += 1
                rec = dict(payload)
                # assigned AFTER the payload merge: a replayed record (or
                # hostile payload) carrying its own seq/type/fmt must
                # never override the writer's numbering or format stamp
                rec["seq"] = self.seq
                rec["type"] = "proof"
                rec["fmt"] = WAL_FORMAT_VERSION
                frames += encode_record(rec)
            os.write(self._fd, frames)
            self.size += len(frames)
            self.records += len(payloads)
            self._pending += len(payloads)
            metrics.counter("audit.log.appends").inc(len(payloads))
            metrics.counter("audit.log.bytes").inc(len(frames))
            if self.segment_bytes and self.size >= self.segment_bytes:
                self._rotate_locked()
            return self.seq

    def _rotate_locked(self) -> None:
        """Seal the active file (fsync + atomic rename to
        ``<path>.<first>-<last>.seg``) and open a fresh one.  Caller
        holds ``_lock``.  Zero-padded seq range in the name keeps
        lexicographic order equal to sequence order — the audit
        pipeline leans on that."""
        assert self._fd is not None
        os.fsync(self._fd)  # a sealed segment is durable by definition
        os.close(self._fd)
        self._fd = None
        sealed = segment_name(self.path, self.file_first_seq, self.seq)
        os.replace(self.path, sealed)
        self._fd = os.open(
            self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o600
        )
        os.chmod(self.path, 0o600)
        self.size = 0
        self._pending = 0
        self._last_fsync = time.monotonic()
        self.file_first_seq = self.seq + 1
        self.rotations += 1
        metrics.counter("audit.log.rotations").inc()

    def sealed_segments(self) -> list[str]:
        """Sealed-segment paths for this log, sequence order (survives
        restarts — it is a directory scan, not in-memory state)."""
        return sealed_segments(self.path)

    def resume_past_sealed(self) -> int:
        """Move the numbering past every sealed segment now beside the
        log, those a primary shipped in since this writer opened
        included; returns the last assigned seq.  A replication standby's
        writer opens at boot, before the shipments, and appends nothing
        until its promotion, which calls this first: the promoted node's
        records then continue the primary's trail instead of numbering
        from the seq the writer opened at."""
        with self._lock:
            last = max(
                (_segment_seq_range(s)[1] for s in self.sealed_segments()),
                default=0,
            )
            if last > self.seq:
                self.seq = last
                if self.size == 0:
                    self.file_first_seq = last + 1
            return self.seq

    def needs_sync(self) -> bool:
        """Whether :meth:`sync` would fsync right now under the policy —
        lets the async caller skip the worker-thread hop entirely."""
        if self._pending == 0 or self.policy == "off":
            return False
        if self.policy == "always":
            return True
        return time.monotonic() - self._last_fsync >= self.interval_s

    def sync(self, force: bool = False) -> bool:
        """Fsync pending appends per the policy (``force`` overrides);
        returns whether an fsync happened."""
        with self._lock:
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
            metrics.counter("audit.log.fsyncs").inc()
            return True

    @property
    def pending(self) -> int:
        return self._pending

    def status(self) -> dict:
        """Operator view behind the REPL ``/audit``."""
        with self._lock:
            return {
                "path": self.path,
                "bytes": self.size,
                "seq": self.seq,
                "records_this_boot": self.records,
                "pending_appends": self._pending,
                "fsync_policy": self.policy,
                "segment_bytes": self.segment_bytes,
                "rotations_this_boot": self.rotations,
                "sealed_segments": len(self.sealed_segments()),
            }

    def close(self) -> None:
        """Force-sync pending appends and release the fd (idempotent)."""
        self.sync(force=True)
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
