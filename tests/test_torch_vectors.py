"""The pinned vectors on the port's host core: twins of
``tests/test_ristretto.py`` (RFC 9496 small multiples, the one-way map,
non-canonical encodings, the group API), ``tests/test_security_extra.py``
(the pinned proof vectors of ``tests/vectors/proof_vectors.json``, the
identity-statement limitation, the proof-size window),
``tests/test_sodium_differential.py`` (libsodium's independent
ristretto255, or its vendored ``tests/vectors/sodium_vectors.json`` where
libsodium is absent) and ``tests/test_transcript.py``'s pinned transcript
vectors (``tests/vectors/transcript_vectors.json``, also through the host
core's Merlin).  The other cases of ``tests/test_transcript.py`` are in
``tests/test_torch_transcript.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import json
import os
import secrets

import pytest

from cpzk_tpu_torch import (
    Error,
    Parameters,
    Proof,
    Prover,
    SecureRng,
    Statement,
    Transcript,
    Verifier,
    Witness,
)
from cpzk_tpu_torch.core import _native, edwards
from cpzk_tpu_torch.core import scalars as hs
from cpzk_tpu_torch.core.ristretto import GENERATOR_H_DST, Element, Ristretto255, Scalar
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.core.transcript import MerlinTranscript
from cpzk_tpu_torch.errors import InvalidGroupElement, InvalidScalar


# --- RFC 9496 and the group API (tests/test_ristretto.py) ---------------------

SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
]


def test_small_multiples():
    acc = edwards.IDENTITY
    for expected in SMALL_MULTIPLES:
        assert edwards.ristretto_encode(acc).hex() == expected
        acc = edwards.pt_add(acc, edwards.BASEPOINT)


def test_one_way_map_vector():
    """RFC 9496 one-way map vector (dalek/libsodium 'espresso' vector) —
    guards the sign of SQRT_AD_MINUS_ONE, which the squaring-only constant
    test cannot see."""
    import hashlib

    digest = hashlib.sha512(
        b"Ristretto is traditionally a short shot of espresso coffee"
    ).digest()
    point = edwards.ristretto_from_uniform_bytes(digest)
    assert (
        edwards.ristretto_encode(point).hex()
        == "3066f82a1a747d45120d1740f14358531a8f04bbffe6a819f86dfe50f44a0a46"
    )


def test_decode_rejects_noncanonical():
    # s >= p
    bad = (edwards.P + 2).to_bytes(32, "little")
    assert edwards.ristretto_decode(bad) is None
    # negative (odd) s
    assert edwards.ristretto_decode((3).to_bytes(32, "little")) is None
    # all-ones
    assert edwards.ristretto_decode(b"\xff" * 32) is None
    # wrong length via API
    with pytest.raises(InvalidGroupElement):
        Ristretto255.element_from_bytes(b"\x00" * 31)


def test_generators_distinct_and_valid():
    g = Ristretto255.generator_g()
    h = Ristretto255.generator_h()
    assert g != h
    assert not Ristretto255.is_identity(g)
    assert not Ristretto255.is_identity(h)
    Ristretto255.validate_element(g)
    Ristretto255.validate_element(h)
    # deterministic
    assert Ristretto255.element_to_bytes(h) == Ristretto255.element_to_bytes(Ristretto255.generator_h())


def test_scalar_roundtrip_and_ops():
    rng = SecureRng()
    a = Ristretto255.random_scalar(rng)
    b = Ristretto255.random_scalar(rng)
    assert Ristretto255.scalar_sub(Ristretto255.scalar_add(a, b), b) == a
    assert Ristretto255.scalar_mul_scalar(a, b) == Ristretto255.scalar_mul_scalar(b, a)
    inv = Ristretto255.scalar_invert(a)
    assert Ristretto255.scalar_mul_scalar(a, inv) == Scalar(1)
    assert Ristretto255.scalar_invert(Scalar(0)) is None
    data = Ristretto255.scalar_to_bytes(a)
    assert Ristretto255.scalar_from_bytes(data) == a
    with pytest.raises(InvalidScalar):
        Ristretto255.scalar_from_bytes(b"\xff" * 32)


def test_element_roundtrip_and_group_law():
    rng = SecureRng()
    g = Ristretto255.generator_g()
    a = Ristretto255.random_scalar(rng)
    b = Ristretto255.random_scalar(rng)
    ga = Ristretto255.scalar_mul(g, a)
    gb = Ristretto255.scalar_mul(g, b)
    # serialization roundtrip
    data = Ristretto255.element_to_bytes(ga)
    assert Ristretto255.element_from_bytes(data) == ga
    # homomorphism: g^a * g^b == g^(a+b)
    lhs = Ristretto255.element_mul(ga, gb)
    rhs = Ristretto255.scalar_mul(g, Ristretto255.scalar_add(a, b))
    assert lhs == rhs
    Ristretto255.validate_element(ga)


def test_identity():
    ident = Ristretto255.identity()
    assert Ristretto255.is_identity(ident)
    assert not Ristretto255.is_identity(Ristretto255.generator_g())
    assert Ristretto255.element_to_bytes(ident) == b"\x00" * 32
    Ristretto255.validate_element(ident)


def test_torsion_coset_equality():
    # The 2-torsion point (0, -1) is in the identity coset.
    t = (0, edwards.P - 1, 1, 0)
    assert Element(t) == Ristretto255.identity()
    assert edwards.ristretto_encode(t) == b"\x00" * 32


# --- pinned proofs (tests/test_security_extra.py) -------------------------------

VECTORS = os.path.join(os.path.dirname(__file__), "vectors", "proof_vectors.json")


def test_identity_statement_known_limitation():
    """Statement.validate allows the identity pair — parity with the
    reference's documented limitation (security_tests.rs:135-149); the
    *service* registration path is where identity statements are rejected
    (service.rs:93-97 / server.service._parse_statement)."""
    identity = Ristretto255.identity()
    assert Ristretto255.is_identity(identity)
    Statement(identity, identity).validate()  # must NOT raise (parity)


def test_proof_size_window():
    """109-byte proofs sit inside the reference's 32 < len < 1024 window
    (security_tests.rs:211-237)."""
    rng = SecureRng()
    params = Parameters.new()
    prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
    wire = prover.prove_with_transcript(rng, Transcript()).to_bytes()
    assert 32 < len(wire) < 1024
    assert len(wire) == 109  # exact format: 1 + 3*(4 + 32)


def test_pinned_proof_vectors():
    """Deterministic vectors pin the generators, the 109-byte wire format,
    and Merlin challenge derivation: regenerating each proof from its
    SHA-512-derived witness/nonce must reproduce the exact bytes, and
    verification must match the recorded accept bit."""
    with open(VECTORS) as f:
        data = json.load(f)

    params = Parameters.new()
    eb = Ristretto255.element_to_bytes
    assert eb(params.generator_g).hex() == data["generator_g"]
    assert eb(params.generator_h).hex() == data["generator_h"]

    def det_scalar(label: str) -> Scalar:
        h = hashlib.sha512(b"cpzk-tpu-test-vector:" + label.encode()).digest()
        return Scalar(int.from_bytes(h, "little") % L)

    for i, vec in enumerate(v for v in data["vectors"] if v["accept"]):
        x = det_scalar(f"witness-{i}")
        k = det_scalar(f"nonce-{i}")
        ctx = bytes.fromhex(vec["context"]) if vec["context"] else None

        y1 = Ristretto255.scalar_mul(params.generator_g, x)
        y2 = Ristretto255.scalar_mul(params.generator_h, x)
        assert eb(y1).hex() == vec["y1"] and eb(y2).hex() == vec["y2"]

        r1 = Ristretto255.scalar_mul(params.generator_g, k)
        r2 = Ristretto255.scalar_mul(params.generator_h, k)
        t = Transcript()
        if ctx is not None:
            t.append_context(ctx)
        t.append_parameters(eb(params.generator_g), eb(params.generator_h))
        t.append_statement(eb(y1), eb(y2))
        t.append_commitment(eb(r1), eb(r2))
        c = t.challenge_scalar()
        assert Ristretto255.scalar_to_bytes(c).hex() == vec["challenge"]

        s = Scalar((k.value + c.value * x.value) % L)
        from cpzk_tpu_torch.protocol.gadgets import Commitment
        from cpzk_tpu_torch.protocol.prover import Response

        wire = Proof(Commitment(r1, r2), Response(s)).to_bytes()
        assert wire.hex() == vec["proof"], f"wire drift in {vec['name']}"

        vt = Transcript()
        if ctx is not None:
            vt.append_context(ctx)
        Verifier(params, Statement(y1, y2)).verify_with_transcript(
            Proof.from_bytes(wire), vt
        )

    # rejection vectors: recorded proof must NOT verify under its context
    for vec in (v for v in data["vectors"] if not v["accept"]):
        proof = Proof.from_bytes(bytes.fromhex(vec["proof"]))
        y1 = Ristretto255.element_from_bytes(bytes.fromhex(vec["y1"]))
        y2 = Ristretto255.element_from_bytes(bytes.fromhex(vec["y2"]))
        vt = Transcript()
        vt.append_context(bytes.fromhex(vec["context"]))
        try:
            Verifier(params, Statement(y1, y2)).verify_with_transcript(proof, vt)
            raise AssertionError(f"{vec['name']} unexpectedly verified")
        except Error:
            pass


# --- libsodium (tests/test_sodium_differential.py) ------------------------------

VEC_PATH = os.path.join(os.path.dirname(__file__), "vectors", "sodium_vectors.json")


class Sodium:
    """Minimal ctypes surface over libsodium's ristretto255."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib
        lib.sodium_init()

    @classmethod
    def load(cls) -> "Sodium | None":
        for name in ("libsodium.so.23", "libsodium.so.26", "libsodium.so",
                     ctypes.util.find_library("sodium")):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                lib.crypto_core_ristretto255_add  # probe the API
                return cls(lib)
            except (OSError, AttributeError):
                continue
        return None

    def is_valid(self, p: bytes) -> bool:
        return self.lib.crypto_core_ristretto255_is_valid_point(p) == 1

    def add(self, p: bytes, q: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        assert self.lib.crypto_core_ristretto255_add(out, p, q) == 0
        return out.raw

    def scalarmult(self, n: bytes, p: bytes) -> bytes | None:
        """n*p; None when libsodium refuses (it errors on identity results)."""
        out = ctypes.create_string_buffer(32)
        if self.lib.crypto_scalarmult_ristretto255(out, n, p) != 0:
            return None
        return out.raw

    def scalarmult_base(self, n: bytes) -> bytes | None:
        out = ctypes.create_string_buffer(32)
        if self.lib.crypto_scalarmult_ristretto255_base(out, n) != 0:
            return None
        return out.raw

    def from_hash(self, h64: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        assert self.lib.crypto_core_ristretto255_from_hash(out, h64) == 0
        return out.raw

    def scalar_reduce(self, s64: bytes) -> bytes:
        out = ctypes.create_string_buffer(32)
        self.lib.crypto_core_ristretto255_scalar_reduce(out, s64)
        return out.raw


SODIUM = Sodium.load()
eb = Ristretto255.element_to_bytes
sb = Ristretto255.scalar_to_bytes


def _vectors():
    with open(VEC_PATH, encoding="utf-8") as f:
        return json.load(f)


def test_generator_parity():
    """Both generators match libsodium's independent construction."""
    g = eb(Parameters.new().generator_g)
    h = eb(Parameters.new().generator_h)
    digest = hashlib.sha512(GENERATOR_H_DST).digest()
    if SODIUM is not None:
        one = (1).to_bytes(32, "little")
        assert SODIUM.scalarmult_base(one) == g
        assert SODIUM.from_hash(digest) == h
    v = _vectors()
    assert v["basepoint"] == g.hex()
    assert v["generator_h"] == h.hex()
    assert v["generator_h_input_sha512"] == digest.hex()


def test_scalarmult_differential():
    if SODIUM is None:
        pytest.skip("libsodium not available (vendored vectors cover parity)")
    g = Parameters.new().generator_g
    for _ in range(16):
        k = secrets.randbelow(hs.L - 1) + 1  # sodium rejects 0 scalars
        ours = eb(Ristretto255.scalar_mul(g, Ristretto255.scalar_from_bytes(
            k.to_bytes(32, "little"))))
        assert SODIUM.scalarmult_base(k.to_bytes(32, "little")) == ours


def test_point_add_and_validity_differential():
    if SODIUM is None:
        pytest.skip("libsodium not available (vendored vectors cover parity)")
    rng = SecureRng()
    g = Parameters.new().generator_g
    for _ in range(8):
        a = Ristretto255.scalar_mul(g, Ristretto255.random_scalar(rng))
        b = Ristretto255.scalar_mul(g, Ristretto255.random_scalar(rng))
        assert SODIUM.is_valid(eb(a)) and SODIUM.is_valid(eb(b))
        assert SODIUM.add(eb(a), eb(b)) == eb(Ristretto255.element_mul(a, b))
    # both implementations reject the same bad encodings
    for bad in ((3).to_bytes(32, "little"), b"\xff" * 32):
        assert not SODIUM.is_valid(bad)
        with pytest.raises(InvalidGroupElement):
            Ristretto255.element_from_bytes(bad)


def test_wide_scalar_reduction_differential():
    if SODIUM is None:
        pytest.skip("libsodium not available (vendored vectors cover parity)")
    for _ in range(16):
        raw = secrets.token_bytes(64)
        ours = hs.sc_from_bytes_mod_order_wide(raw)
        assert SODIUM.scalar_reduce(raw) == ours.to_bytes(32, "little")


def _sodium_check_equation(s: bytes, base: bytes, r: bytes, c: bytes,
                           y: bytes) -> bool:
    """s*base == r + c*y with every group op in libsodium."""
    lhs = SODIUM.scalarmult(s, base)
    cy = SODIUM.scalarmult(c, y)
    assert lhs is not None and cy is not None
    return SODIUM.add(r, cy) == lhs


def test_proof_equations_cross_verified():
    """Proofs made by this framework verify under libsodium arithmetic."""
    if SODIUM is None:
        pytest.skip("libsodium not available (vendored vectors cover parity)")
    rng = SecureRng()
    params = Parameters.new()
    for _ in range(4):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        proof = prover.prove_with_transcript(rng, Transcript())
        t = Transcript()
        t.append_parameters(eb(params.generator_g), eb(params.generator_h))
        t.append_statement(eb(prover.statement.y1), eb(prover.statement.y2))
        t.append_commitment(eb(proof.commitment.r1), eb(proof.commitment.r2))
        c = sb(t.challenge_scalar())
        s = sb(proof.response.s)
        assert _sodium_check_equation(
            s, eb(params.generator_g), eb(proof.commitment.r1), c,
            eb(prover.statement.y1))
        assert _sodium_check_equation(
            s, eb(params.generator_h), eb(proof.commitment.r2), c,
            eb(prover.statement.y2))
        # a corrupted response must fail the sodium-side equation too
        bad = sb(Ristretto255.scalar_add(proof.response.s,
                                         Ristretto255.scalar_from_bytes(
                                             (1).to_bytes(32, "little"))))
        assert not _sodium_check_equation(
            bad, eb(params.generator_g), eb(proof.commitment.r1), c,
            eb(prover.statement.y1))


def test_vendored_scalarmult_vectors():
    """The libsodium-generated vectors verify against OUR implementation
    (runs everywhere, libsodium or not)."""
    for v in _vectors()["scalarmult_base"]:
        k = Ristretto255.scalar_from_bytes(bytes.fromhex(v["scalar_le_hex"]))
        ours = eb(Ristretto255.scalar_mul(Parameters.new().generator_g, k))
        assert ours.hex() == v["point_hex"]
    for v in _vectors()["add"]:
        a = Ristretto255.element_from_bytes(bytes.fromhex(v["p"]))
        b = Ristretto255.element_from_bytes(bytes.fromhex(v["q"]))
        assert eb(Ristretto255.element_mul(a, b)).hex() == v["sum"]


# --- pinned transcripts (tests/test_transcript.py) ------------------------------


def test_pinned_transcript_vectors():
    """Frozen transcript behavior across the op surface (self-generated by
    the reference, provenance in the JSON — the external anchors remain the
    merlin doc vector and the SHA3 differential of
    ``tests/test_torch_transcript.py``).
    Any drift in label framing, STROBE op chaining, multi-squeeze state,
    context binding, or the scalar wide reduction fails here."""
    path = os.path.join(os.path.dirname(__file__), "vectors",
                        "transcript_vectors.json")
    with open(path, encoding="utf-8") as f:
        data = json.load(f)

    g = Ristretto255.element_to_bytes(Ristretto255.generator_g())
    h = Ristretto255.element_to_bytes(Ristretto255.generator_h())
    checked = 0
    for vec in data["vectors"]:
        if vec["kind"] == "merlin" and "messages" in vec:
            # the pure twin and the host core's Merlin alike
            for t in (MerlinTranscript(b"cpzk-vector-test"),
                      _native.NativeMerlin(b"cpzk-vector-test")):
                for lbl, m in vec["messages"]:
                    t.append_message(lbl.encode(), bytes.fromhex(m))
                for lbl, n in vec["challenges"]:
                    assert t.challenge_bytes(lbl.encode(), n).hex() == \
                        vec["outputs"][lbl], vec["name"]
            checked += 1
        elif vec["kind"] == "merlin":  # append-after-squeeze
            t = MerlinTranscript(b"cpzk-vector-test")
            t.append_message(b"m", b"first")
            assert t.challenge_bytes(b"c1", 32).hex() == vec["outputs"]["c1"]
            t.append_message(b"m2", b"second")
            assert t.challenge_bytes(b"c2", 32).hex() == vec["outputs"]["c2"]
            checked += 1
        else:  # protocol layer
            t = Transcript()
            if vec["context"] is not None:
                t.append_context(bytes.fromhex(vec["context"]))
            t.append_parameters(g, h)
            t.append_statement(g, h)
            t.append_commitment(h, g)
            assert "%064x" % t.challenge_scalar().value == \
                vec["challenge_scalar"], vec["name"]
            checked += 1
    assert checked == len(data["vectors"]) == 9


# --- chip_smoke.py's vectors check, rehearsed on the CPU ---------------------------


def test_vectors_check_rehearsal():
    """``chip_smoke.py``'s ``vectors`` check on the kernels' plain versions
    (``comb_tables``/``commitments``, ``derive_challenges_device`` and
    ``reduce_wide``, ``TorchBackend`` on the CPU): every vector matches."""
    import pathlib
    import runpy

    import torch

    root = pathlib.Path(__file__).resolve().parent.parent
    smoke = runpy.run_path(str(root / "chip_smoke.py"), run_name="chip_smoke_rehearsal")
    out = smoke["vectors_check"](torch.device("cpu"))
    assert out["scalarmult_base"] == 8
    assert out["protocol_challenges"] == ["no-context", "with-context", "empty-context",
                                          "large-context"]
    assert out["proof_vectors"] == {"vector-0": True, "vector-1": True, "vector-2": True,
                                    "vector-3": True, "vector-wrong-context": False}
