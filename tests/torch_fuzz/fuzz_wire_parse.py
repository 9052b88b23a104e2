"""Fuzz target: native wire parse ≡ protobuf parse on arbitrary bytes.

(A port-owned copy of the reference package's ``fuzz/fuzz_wire_parse.py``,
driving ``cpzk_tpu_torch``.)

The native request scanner (``native/wire.cpp`` via ``server/wire.py``)
sits on the gRPC deserializer seam — a trust boundary fed raw socket
bytes.  Its safety contract is NOT "parses everything correctly"; it is
"either produce exactly what the Python protobuf runtime would, or punt
to it".  This target holds that differentially, per message kind:

- the parser (and the view materialization behind it) never crashes on
  arbitrary bytes — it returns a view or ``None`` (punt);
- whenever it ACCEPTS, the protobuf runtime must also accept, and every
  decoded field is byte/value-equal to the protobuf message's
  (``user_id(s)``, ``challenge_ids``, ``proofs``, packed/unpacked
  ``ids``, ``mint_sessions`` last-wins);
- the packed-proof staging buffer, when claimed, is exactly the
  concatenation of the proofs at canonical size;
- rejection parity is structural: on punt the deserializer IS
  ``FromString``, so accept/reject can never diverge — asserted here by
  construction (a punt with a protobuf-accepted message is fine, a
  native accept with a protobuf rejection is a violation).

Run: python tests/torch_fuzz/fuzz_wire_parse.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

import random

from common import run_fuzzer

from cpzk_tpu_torch.server import wire as wire_mod
from cpzk_tpu_torch.server.proto import load_pb2

pb2 = load_pb2()

_KINDS = (
    (pb2.ChallengeRequest, wire_mod._parse_challenge),
    (pb2.BatchVerificationRequest, wire_mod._parse_batch_verify),
    (pb2.StreamVerifyRequest, wire_mod._parse_stream_chunk),
)

_PROOF = 109


def _seeds() -> list[bytes]:
    rng = random.Random(7)
    seeds = [
        pb2.ChallengeRequest(user_id="alice").SerializeToString(),
        pb2.ChallengeRequest(user_id="héllo-ü\U0001F600").SerializeToString(),
        pb2.ChallengeRequest().SerializeToString(),
        pb2.BatchVerificationRequest(
            user_ids=["a", "b", "c"],
            challenge_ids=[b"\x01" * 33, b"", b"\x02" * 64],
            proofs=[bytes(_PROOF), b"x", bytes(_PROOF)],
        ).SerializeToString(),
        pb2.StreamVerifyRequest(
            ids=[0, 1, 2**64 - 1],
            user_ids=["u1", "u2", "u3"],
            challenge_ids=[b"c" * 33] * 3,
            proofs=[bytes([rng.randrange(256)] * _PROOF) for _ in range(3)],
            mint_sessions=True,
        ).SerializeToString(),
        # unpacked varint ids (legal proto3 encoding the client never emits)
        b"\x08\x2a\x08\x00" + pb2.StreamVerifyRequest(
            user_ids=["x"], challenge_ids=[b"y"], proofs=[b"z"]
        ).SerializeToString(),
        b"",
        b"\x0a\x00",
    ]
    return seeds


def _ref_parse(cls, data: bytes):
    try:
        return cls.FromString(data)
    except Exception:
        return None


def _check_kind(cls, parser, data: bytes) -> None:
    try:
        view = parser(data)
    except Exception as exc:  # the parser must NEVER raise
        raise AssertionError(
            f"native parser raised on arbitrary bytes: {exc!r}"
        ) from exc
    if view is None:
        return  # punt: the deserializer is FromString — parity structural
    ref = _ref_parse(cls, data)
    assert ref is not None, (
        "native parser accepted bytes the protobuf runtime rejects"
    )
    if cls is pb2.ChallengeRequest:
        assert view.user_id == ref.user_id
        return
    assert view.user_ids == list(ref.user_ids)
    assert view.challenge_ids == list(ref.challenge_ids)
    assert view.proofs == list(ref.proofs)
    if view.proofs_packed is not None:
        assert all(len(p) == _PROOF for p in ref.proofs)
        assert view.proofs_packed == b"".join(ref.proofs)
        assert view.packed_proofs(len(ref.proofs)) == view.proofs_packed
    if cls is pb2.StreamVerifyRequest:
        assert view.ids == list(ref.ids)
        assert view.mint_sessions == ref.mint_sessions


def one_input(data: bytes) -> None:
    for cls, parser in _KINDS:
        _check_kind(cls, parser, data)


if __name__ == "__main__":
    if not wire_mod.native_available():
        print("native core unavailable; nothing to fuzz")
        raise SystemExit(0)
    run_fuzzer(one_input, _seeds())
