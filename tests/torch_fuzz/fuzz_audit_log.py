"""Fuzz target: proof-log scanning + audit fold-state invariants.

(A port-owned copy of the reference package's ``fuzz/fuzz_audit_log.py``,
driving ``cpzk_tpu_torch``.)

Arbitrary bytes presented as a proof log — truncated, tampered,
reordered, duplicated, or pure garbage — must leave the bulk audit
pipeline's parse-and-fold layer in a sane state:

Invariants:
- ``scan_records`` never raises; its valid-prefix offset is a byte
  offset within the input; every parsed record is a dict with an int,
  strictly increasing ``seq`` and a str ``type`` (the WAL prefix
  contract inherited byte-for-byte);
- scanning is **split-resume equivalent**: resuming from any prefix's
  (offset, prev_seq) cursor yields exactly the whole-buffer scan's
  suffix — the property SIGKILL-resume correctness rests on;
- ``validate_proof_record`` never raises and is total over arbitrary
  parsed JSON;
- the :class:`~cpzk_tpu_torch.audit.pipeline.AuditState` fold never raises,
  its cursor offset/seq stay monotonic, its totals stay consistent
  (``records == audited + skipped``, ``audited == verified +
  rejected``), and the digest chain is split-independent: folding the
  records in one pass equals folding them across any resume boundary
  (cursor round-trip included).

The fold runs WITHOUT the crypto engine (outcomes derived from the
recorded verdict): the invariants under test are parsing, cursor, and
totals discipline — re-verification correctness is pinned by
``tests/test_audit.py`` against real proofs.

Run: python tests/torch_fuzz/fuzz_audit_log.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

import random

from common import run_fuzzer

from cpzk_tpu_torch.audit.log import proof_record, validate_proof_record
from cpzk_tpu_torch.audit.pipeline import (
    OUTCOME_REJECTED,
    OUTCOME_SKIPPED,
    OUTCOME_VERIFIED,
    AuditState,
)
from cpzk_tpu_torch.audit import scan_records
from cpzk_tpu_torch.durability.wal import HEADER_BYTES, _HEADER, encode_record


def _seeds() -> list[bytes]:
    frames = []
    seq = 0
    for i in range(4):
        seq += 1
        rec = proof_record(
            f"user-{i}", b"\x11" * 32, b"\x22" * 32, bytes([i]) * 32,
            b"\x03" * 109, i % 2 == 0, now=1,
        )
        rec["seq"] = seq
        rec["type"] = "proof"
        frames.append(encode_record(rec))
    seq += 1
    frames.append(encode_record({"seq": seq, "type": "register_user",
                                 "user_id": "x"}))
    whole = b"".join(frames)
    return [whole, whole[: len(whole) // 2], frames[0] * 3]


def _outcome(rec: dict) -> bytes:
    """Deterministic stand-in for the verification engine: well-formed
    records audit to their recorded verdict, everything else skips."""
    if validate_proof_record(rec) is not None:
        return OUTCOME_SKIPPED
    return OUTCOME_VERIFIED if rec["v"] else OUTCOME_REJECTED


def _fold(records, offsets, state: AuditState) -> AuditState:
    prev_offset = state.offset
    prev_records = state.records
    for rec, end in zip(records, offsets):
        outcome = _outcome(rec)
        state.note(rec, outcome, mismatch=outcome == OUTCOME_REJECTED)
        state.offset = end
        assert state.offset >= prev_offset, "cursor offset went backwards"
        prev_offset = state.offset
    assert state.records == prev_records + len(records)
    return state


def _frame_ends(buf: bytes, start: int, n: int) -> list[int]:
    out = []
    off = start
    for _ in range(n):
        length, _crc = _HEADER.unpack_from(buf, off)
        off += HEADER_BYTES + length
        out.append(off)
    return out


def one_input(data: bytes) -> None:
    records, valid = scan_records(data)
    assert 0 <= valid <= len(data)
    prev = None
    for rec in records:
        assert isinstance(rec, dict)
        seq = rec["seq"]
        assert isinstance(seq, int) and not isinstance(seq, bool)
        assert prev is None or seq > prev
        prev = seq
        assert isinstance(rec["type"], str)
        validate_proof_record(rec)  # total: must never raise

    ends = _frame_ends(data, 0, len(records))
    assert not ends or ends[-1] == valid

    # one-pass fold
    one = _fold(records, ends, AuditState())
    totals_hold(one)

    # split-resume fold at a pseudo-random frame boundary, with a cursor
    # round-trip at the seam (exactly what SIGKILL resume does)
    split = random.Random(len(data) ^ valid).randint(0, len(records))
    head = _fold(records[:split], ends[:split], AuditState())
    cur = head.to_cursor("fuzz.log")
    resumed = AuditState.from_cursor(cur, "fuzz.log")
    tail_records, tail_valid = scan_records(
        data, offset=resumed.offset, prev_seq=resumed.prev_seq
    )
    assert tail_records == records[split:], "split-resume scan diverged"
    assert tail_valid == valid
    two = _fold(tail_records, ends[split:], resumed)
    totals_hold(two)
    assert two.chain == one.chain, "digest chain is split-dependent"
    assert two.records == one.records
    assert (two.verified, two.rejected, two.skipped, two.mismatched) == (
        one.verified, one.rejected, one.skipped, one.mismatched
    )


def totals_hold(state: AuditState) -> None:
    assert state.records == state.audited + state.skipped
    assert state.audited == state.verified + state.rejected
    assert 0 <= state.mismatched <= state.audited


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
