"""Fuzz target: WAL frame parsing, boot-time replay, segmented delivery.

(A port-owned copy of the reference package's ``fuzz/fuzz_wal_replay.py``,
driving ``cpzk_tpu_torch``.)

Arbitrary bytes presented as a write-ahead log must yield clean
truncate-at-tail recovery — never an exception, never garbage state
(the durability subsystem's trust-boundary contract).  The same bytes
re-packaged as replication segments and delivered adversarially
(duplicated, reordered, truncated, cross-epoch) must leave the standby
applier in a prefix-stable state.

Invariants:
- ``iter_frames`` never raises; the valid prefix is a byte offset within
  the input, every parsed record is a dict with an int ``seq`` (strictly
  increasing) and str ``type``;
- parsing is **prefix-stable**: re-parsing the valid prefix alone yields
  the same records and consumes it fully (what recovery's truncation
  relies on — truncating at the boundary loses nothing that parsed);
- ``ServerState.replay_journal_record`` never raises on any parsed
  record — malformed fields come back as skip reasons, and whatever does
  apply passes the registration-time validators (user-id rules, no
  identity statement elements, session expiry sanity);
- ``SegmentApplier`` never raises on any delivery schedule; its
  ``applied_seq`` is monotonic; a torn or tampered segment changes
  nothing; duplicates never double-apply; a lower-epoch segment after a
  higher one is always fenced.

Run: python tests/torch_fuzz/fuzz_wal_replay.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

import dataclasses
import random
import zlib

from common import run_fuzzer

from cpzk_tpu_torch.durability.wal import encode_record, iter_frames
from cpzk_tpu_torch.replication import SegmentApplier, split_records
from cpzk_tpu_torch.server.state import ServerState, user_id_error


def _seeds() -> list[bytes]:
    from cpzk_tpu_torch import Parameters, Prover, SecureRng, Witness
    from cpzk_tpu_torch.core.ristretto import Ristretto255

    rng, params = SecureRng(), Parameters.new()
    eb = Ristretto255.element_to_bytes
    frames = []
    for i in range(3):
        st = Prover(params, Witness(Ristretto255.random_scalar(rng))).statement
        frames.append(encode_record({
            "seq": 2 * i + 1, "type": "register_user", "user_id": f"user-{i}",
            "y1": eb(st.y1).hex(), "y2": eb(st.y2).hex(), "registered_at": 1,
        }))
        frames.append(encode_record({
            "seq": 2 * i + 2, "type": "create_session", "token": f"tok-{i}",
            "user_id": f"user-{i}", "created_at": 10 ** 10,
            "expires_at": 10 ** 10 + 60,
        }))
    frames.append(encode_record({"seq": 7, "type": "revoke_session",
                                 "token": "tok-0"}))
    frames.append(encode_record({"seq": 8, "type": "expire_sessions",
                                 "now": 10 ** 10}))
    full = b"".join(frames)
    return [full, frames[0], full[: len(full) // 2]]


def _segment_delivery(records: list[dict], data: bytes) -> None:
    """Re-package the parsed records as segments and deliver them through
    an adversarial schedule derived deterministically from the input."""
    if not records:
        return
    rnd = random.Random(zlib.crc32(data))
    segs = split_records(
        records, epoch=2, first_index=0,
        segment_bytes=rnd.choice((1, 64, 300, 1 << 16)),
    )
    schedule = list(segs)
    # duplicates, reordering, truncation/tamper, cross-epoch deliveries
    schedule += rnd.sample(segs, k=min(2, len(segs)))
    rnd.shuffle(schedule)
    mutated = []
    for seg in schedule:
        roll = rnd.random()
        if roll < 0.25 and len(seg.frames) > 1:
            cut = rnd.randrange(1, len(seg.frames))
            mutated.append(dataclasses.replace(seg, frames=seg.frames[:cut]))
        elif roll < 0.4:
            mutated.append(dataclasses.replace(seg, epoch=rnd.choice((1, 3))))
        elif roll < 0.5:
            mutated.append(dataclasses.replace(seg, crc=seg.crc ^ 0x1))
        else:
            mutated.append(seg)

    state = ServerState()
    applier = SegmentApplier(state, epoch=2)
    prev_applied = 0
    for seg in mutated:
        accepted, message = applier.apply(seg)  # must never raise
        assert isinstance(accepted, bool) and isinstance(message, str)
        assert applier.applied_seq >= prev_applied  # monotonic, never back
        prev_applied = applier.applied_seq
        if seg.epoch < applier.epoch:
            assert not accepted  # fencing is unconditional
    for uid in state._users:
        assert user_id_error(uid) is None

    # prefix-stability: an in-order delivery applies the contiguous
    # prefix; re-delivering the same segments is pure no-op — duplicates
    # for the applied prefix, the same gap rejection for the rest
    fresh = SegmentApplier(
        ServerState(), epoch=2, applied_seq=records[0]["seq"] - 1
    )
    for seg in segs:
        fresh.apply(seg)
    applied_now = fresh.applied_seq
    for seg in segs:
        accepted, message = fresh.apply(seg)
        if seg.last_seq <= applied_now:
            assert accepted and "duplicate" in message
        else:
            assert not accepted and "gap" in message
    assert fresh.applied_seq == applied_now


def one_input(data: bytes) -> None:
    records, valid = iter_frames(data)
    assert 0 <= valid <= len(data)
    prev = None
    for rec in records:
        assert isinstance(rec, dict)
        assert isinstance(rec["seq"], int) and isinstance(rec["type"], str)
        assert prev is None or rec["seq"] > prev
        prev = rec["seq"]

    # prefix stability: truncating at the boundary loses nothing
    again, valid2 = iter_frames(data[:valid])
    assert valid2 == valid and again == records

    # replay must never raise; applied records passed the validators
    state = ServerState()
    for rec in records:
        msg = state.replay_journal_record(rec)
        assert msg is None or isinstance(msg, str)
    for uid in state._users:
        assert user_id_error(uid) is None, f"validator bypass: {uid!r}"
    for token, sess in state._sessions.items():
        assert sess.user_id in state._users, "session for unregistered user"
        assert 0 < sess.expires_at - sess.created_at <= 3600

    # the same records as an adversarially-delivered segment stream
    _segment_delivery(records, data)


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
