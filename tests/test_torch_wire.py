"""The port's native request-wire parse (``cpzk_tpu_torch/server/wire.py``
on ``native/wire.cpp`` in the port's host core): twins of the cases of
``tests/test_wire.py`` that need no ``ServerConfig``.

The port's views are held against the protobuf runtime AND the
reference's views on the same bytes (field for field), its packed parse
against the reference's, and, through both servers with the reference's
``AuthClient``, the per-entry verdicts of a batch and a stream with
malformed wires (truncated, bad point, empty, a trailing byte) in both
wire modes.  Tolerance: exact.

Departures, tested here: a host core that does not build raises
``NativeCoreError`` out of the deserializer instead of falling back
silently, so the reference's ``test_fallback_when_native_unavailable``,
``test_no_native_build_env_serves_identically`` and
``test_build_failure_warns_once`` have no twin.  Waiting for the daemon's
``ServerConfig`` (A5c): ``test_perf_entry_wire_is_a_config_key``,
``test_server_config_layering_and_validation``,
``test_server_config_keys_documented``.
"""

import pytest

from cpzk_tpu.protocol.gadgets import Proof as JProof
from cpzk_tpu.server import wire as j_wire
from cpzk_tpu.server.proto import load_pb2 as j_load_pb2
from cpzk_tpu.server.service import request_deserializers as j_request_deserializers
from cpzk_tpu_torch.core import _native
from cpzk_tpu_torch.protocol.gadgets import PROOF_WIRE_SIZE, Proof
from cpzk_tpu_torch.server import metrics
from cpzk_tpu_torch.server import wire as wire_mod
from cpzk_tpu_torch.server.proto import load_pb2
from cpzk_tpu_torch.server.service import request_deserializers
from torch_grpc_twins import SeededRng, run_twins, twin_check

import cpzk_tpu as J

VIEW_FIELDS = ("user_id", "user_ids", "challenge_ids", "proofs", "proofs_packed",
               "ids", "mint_sessions")


def _deser(rpc, wire="native"):
    return request_deserializers(load_pb2(), wire)[rpc]


def _j_deser(rpc):
    return j_request_deserializers(j_load_pb2(), "native")[rpc]


def _fields(view) -> dict:
    return {name: getattr(view, name) for name in VIEW_FIELDS if hasattr(view, name)}


def _both_views(rpc, data: bytes):
    view, j_view = _deser(rpc)(data), _j_deser(rpc)(data)
    assert type(view).__name__ == type(j_view).__name__
    assert _fields(view) == _fields(j_view)
    return view


# --- view parity -------------------------------------------------------------


def test_batch_view_parity_with_protobuf():
    pb2 = load_pb2()
    req = pb2.BatchVerificationRequest(
        user_ids=[f"user{i}" for i in range(50)] + ["héllo-ü"],
        challenge_ids=[bytes([i]) * 33 for i in range(51)],
        proofs=[bytes([i]) * PROOF_WIRE_SIZE for i in range(51)],
    )
    data = req.SerializeToString()
    view = _both_views("VerifyProofBatch", data)
    assert isinstance(view, wire_mod.NativeBatchVerificationRequest)
    ref = pb2.BatchVerificationRequest.FromString(data)
    assert view.user_ids == list(ref.user_ids)
    assert view.challenge_ids == list(ref.challenge_ids)
    assert view.proofs == list(ref.proofs)
    assert view.proofs_packed == b"".join(ref.proofs)
    assert view.packed_proofs(51) == view.proofs_packed
    assert view.packed_proofs(50) is None  # a subset: no contiguity claim


def test_stream_view_parity_with_protobuf():
    pb2 = load_pb2()
    req = pb2.StreamVerifyRequest(
        ids=[0, 1, 2**63, 7], user_ids=["a", "b", "c", "d"],
        challenge_ids=[b"x" * 33] * 4, proofs=[bytes(PROOF_WIRE_SIZE)] * 4,
        mint_sessions=True,
    )
    data = req.SerializeToString()
    view = _both_views("VerifyProofStream", data)
    assert isinstance(view, wire_mod.NativeStreamVerifyRequest)
    ref = pb2.StreamVerifyRequest.FromString(data)
    assert list(view.ids) == list(ref.ids)
    assert view.user_ids == list(ref.user_ids)
    assert view.challenge_ids == list(ref.challenge_ids)
    assert view.proofs == list(ref.proofs)
    assert view.mint_sessions is True
    # unpacked (wire type 0) ids are legal proto3 too: field 1, varint
    unpacked = b"\x08\x05\x08\x2a" + data
    view2 = _both_views("VerifyProofStream", unpacked)
    assert list(view2.ids) == list(pb2.StreamVerifyRequest.FromString(unpacked).ids)


def test_challenge_view_parity_with_protobuf():
    pb2 = load_pb2()
    for uid in ("alice", "héllo-ü", "", "a" * 300):
        data = pb2.ChallengeRequest(user_id=uid).SerializeToString()
        view = _both_views("CreateChallenge", data)
        assert isinstance(view, wire_mod.NativeChallengeRequest)
        assert view.user_id == pb2.ChallengeRequest.FromString(data).user_id
    # a duplicated singular field: the last occurrence wins, as in proto3
    twice = (pb2.ChallengeRequest(user_id="first").SerializeToString()
             + pb2.ChallengeRequest(user_id="second").SerializeToString())
    assert _both_views("CreateChallenge", twice).user_id == "second"


def test_parser_punts_outside_its_subset():
    """Unknown fields, foreign wire types and invalid UTF-8 go to the
    protobuf runtime: the same accept/reject and the same errors."""
    pb2 = load_pb2()
    deser = _deser("CreateChallenge")
    base = pb2.ChallengeRequest(user_id="u").SerializeToString()
    got = deser(base + b"\x22\x01x")  # unknown field 4, LEN
    assert type(got).__name__ == "ChallengeRequest" and got.user_id == "u"
    bad_utf8 = b"\x0a\x02\xff\xfe"
    with pytest.raises(Exception) as native_err:
        deser(bad_utf8)
    with pytest.raises(Exception) as py_err:
        pb2.ChallengeRequest.FromString(bad_utf8)
    with pytest.raises(Exception) as j_err:
        _j_deser("CreateChallenge")(bad_utf8)
    assert type(native_err.value) is type(py_err.value) is type(j_err.value)
    for garbage in (b"\x0a", b"\x0a\xff", b"\x80" * 12, b"\x0a\x7fzz"):
        try:
            ref = pb2.ChallengeRequest.FromString(garbage)
        except Exception:
            with pytest.raises(Exception):
                deser(garbage)
        else:
            assert deser(garbage).user_id == ref.user_id


def test_packed_proofs_none_when_sizes_vary():
    pb2 = load_pb2()
    req = pb2.BatchVerificationRequest(
        user_ids=["a", "b"], challenge_ids=[b"c" * 33] * 2,
        proofs=[bytes(PROOF_WIRE_SIZE), b"short"],
    )
    view = _both_views("VerifyProofBatch", req.SerializeToString())
    assert view.proofs_packed is None
    assert view.proofs == [bytes(PROOF_WIRE_SIZE), b"short"]


# --- packed parse equivalence ------------------------------------------------


def _proof_corpus():
    rng = SeededRng(41)
    prover = J.Prover(J.Parameters.new(), J.Witness(J.Ristretto255.random_scalar(rng)))
    t = J.Transcript()
    t.append_context(b"ctx")
    wire = prover.prove_with_transcript(rng, t).to_bytes()
    return [
        wire,
        wire[:5] + b"\xff" * 32 + wire[37:],   # invalid r1 point
        wire[:77] + bytes(32),                 # zero scalar
        b"\x02" + wire[1:],                    # bad version
        wire,
    ]


def _outcome(p):
    if isinstance(p, Exception):
        return (type(p).__name__, str(p))
    return (p.to_bytes(), p.deferred)


def test_from_bytes_batch_packed_equivalence():
    items = _proof_corpus()
    assert all(len(i) == PROOF_WIRE_SIZE for i in items)
    packed = b"".join(items)
    for defer in (False, True):
        plain = Proof.from_bytes_batch(items, defer_point_validation=defer)
        fast = Proof.from_bytes_batch(items, defer_point_validation=defer, packed=packed)
        ref = JProof.from_bytes_batch(items, defer_point_validation=defer, packed=packed)
        assert [_outcome(p) for p in plain] == [_outcome(p) for p in fast] \
            == [_outcome(p) for p in ref]
    # a buffer of the wrong length is ignored, never trusted
    safe = Proof.from_bytes_batch(items, packed=packed[:-1])
    assert [_outcome(p) for p in safe] == [_outcome(p) for p in Proof.from_bytes_batch(items)]


def test_from_bytes_batch_packed_builds_from_the_validated_bytes():
    """A proof accepted from ``packed`` is built from its slice of
    ``packed``: the bytes the native pass validated."""
    items = _proof_corpus()
    other = list(items)
    other[0] = items[1]  # the item list disagrees with the buffer at 0
    got = Proof.from_bytes_batch(other, packed=b"".join(items))
    assert got[0].to_bytes() == items[0]


# --- service-layer parity ----------------------------------------------------


def _malformed_scenario(wire: str):
    async def scenario(t):
        await t.start(rate=10**9, burst=10**9, wire=wire)
        try:
            users = await t.register_batch([f"u{i}" for i in range(4)])
            ids, cids, proofs = await t.challenge_and_prove(users)
            # malformed wires inside one batch: truncated, a bad point,
            # plus valid ones
            proofs[1] = proofs[1][:50]
            proofs[2] = proofs[2][:5] + b"\xff" * 32 + proofs[2][37:]
            t.note(await t.client.verify_proof_batch(ids, cids, proofs))
            ids, cids, proofs = await t.challenge_and_prove(users)
            proofs[0] = b""
            proofs[3] = proofs[3] + b"\x00"
            async for chunk in t.client.verify_proof_stream_chunks(
                    list(zip(ids, cids, proofs)), chunk=4):
                t.note(("stream", tuple(chunk[0]), tuple(chunk[1]), tuple(chunk[2])))
        finally:
            await t.stop()

    return scenario


def test_malformed_batch_parity_native_vs_python():
    """A batch and a stream chunk holding malformed wires answer the same,
    entry for entry, through the native wire path and the protobuf path,
    on the reference's server and the port's."""
    native = twin_check(_malformed_scenario("native"), seed=43)
    python = twin_check(_malformed_scenario("python"), seed=43)
    assert native == python
    results = [dict(r[1]) for r in dict(native[0][1])["results"]]
    assert results[0]["success"] is True and results[3]["success"] is True
    assert (results[1].get("success", False), results[1]["message"]) == (
        False, "Invalid proof: Truncated proof: incomplete r2 data")
    assert results[2]["message"] == "Invalid proof: Bytes do not represent a valid Ristretto point"
    (_, ids, oks, msgs), = native[1:]
    assert oks == (False, True, True, False)
    assert msgs[0] == "Empty proof"
    assert msgs[3] == "Invalid proof: Proof has 1 trailing bytes"


def test_native_counters_and_span():
    before = metrics.read("transport.parse.native", labels={"rpc": "VerifyProofBatch"})
    twins = run_twins(_malformed_scenario("native"), seed=43, sides=("port",))
    assert twins["port"].log
    after = metrics.read("transport.parse.native", labels={"rpc": "VerifyProofBatch"})
    assert after > before


def test_python_mode_never_builds_views():
    req = load_pb2().ChallengeRequest(user_id="u").SerializeToString()
    assert type(_deser("CreateChallenge", "python")(req)).__name__ == "ChallengeRequest"
    assert isinstance(_deser("CreateChallenge")(req), wire_mod.NativeChallengeRequest)


def test_host_core_failure_raises(monkeypatch):
    """No silent fallback: when the host core cannot be built the native
    deserializer raises ``NativeCoreError`` (the reference would parse with
    the protobuf runtime instead)."""

    def broken():
        raise _native.NativeCoreError("host core build failed (test)")

    monkeypatch.setattr(_native, "load", broken)
    req = load_pb2().ChallengeRequest(user_id="u").SerializeToString()
    with pytest.raises(_native.NativeCoreError):
        _deser("CreateChallenge")(req)
    assert j_wire.native_available()  # the reference's own parser is untouched
