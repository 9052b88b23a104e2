"""Twins of ``tests/test_transcript.py`` for the port's Keccak / STROBE /
Merlin twins and the host core's protocol transcript (mirrors reference
src/primitives/transcript.rs:80-119 tests, plus permutation validation
against hashlib and the merlin crate's own published test vector).  The
pinned-vector case is in ``tests/test_torch_vectors.py``;
``test_device_challenges_env_warns_once`` holds the port's notice for a
``CPZK_DEVICE_CHALLENGES=1`` deployment."""

import hashlib

from cpzk_tpu_torch.core.keccak import sha3_256
from cpzk_tpu_torch.core.transcript import MerlinTranscript, Transcript


def test_keccak_permutation_via_sha3():
    for msg in [b"", b"abc", b"x" * 135, b"y" * 136, b"z" * 1000]:
        assert sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_merlin_crate_vector():
    """The merlin crate's 'equivalence' doc test vector — byte-identical
    framing is required for cross-verification against reference proofs."""
    t = MerlinTranscript(b"test protocol")
    t.append_message(b"some label", b"some data")
    challenge = t.challenge_bytes(b"challenge", 32)
    assert challenge.hex() == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


def test_challenge_scalar_deterministic():
    def build():
        t = Transcript()
        t.append_parameters(b"g", b"h")
        t.append_statement(b"y1", b"y2")
        t.append_commitment(b"r1", b"r2")
        return t.challenge_scalar()

    assert build() == build()


def test_challenge_scalar_different_inputs():
    t1 = Transcript()
    t1.append_commitment(b"r1", b"r2")
    t2 = Transcript()
    t2.append_commitment(b"r1_different", b"r2")
    assert t1.challenge_scalar() != t2.challenge_scalar()


def test_context_changes_challenge():
    t1 = Transcript()
    t1.append_context(b"ctx-a")
    t2 = Transcript()
    t2.append_context(b"ctx-b")
    t1.append_commitment(b"r1", b"r2")
    t2.append_commitment(b"r1", b"r2")
    assert t1.challenge_scalar() != t2.challenge_scalar()


def test_label_framing_not_concatenation():
    """Merlin length-prefixes messages: moving bytes between fields must
    change the challenge."""
    t1 = Transcript()
    t1.append_statement(b"ab", b"c")
    t2 = Transcript()
    t2.append_statement(b"a", b"bc")
    assert t1.challenge_scalar() != t2.challenge_scalar()


class _SpecStrobe128:
    """Independent STROBE-128 duplex written from the STROBE v1.0.2 spec
    (sections 5.1-5.3, 6.2, 7: initialization, ``_begin_op``, duplexing),
    deliberately structured differently from ``core/strobe.py`` — state as
    25 keccak lanes with explicit byte packing rather than a 200-byte
    buffer — so a shared implementation quirk cannot hide in both.  Only
    the keccak permutation itself is shared, and that is anchored to
    hashlib separately (``test_keccak_permutation_via_sha3``): a second,
    spec-derived anchor for the transcript layer beyond the single merlin
    doc vector."""

    R = 166  # security level 128: R = 200 - 128/4 - 2

    def __init__(self, label: bytes):
        from cpzk_tpu_torch.core.keccak import keccak_f1600

        self._f = keccak_f1600
        # spec 5.1: S = F(pad-start bytes || "STROBEv1.0.2"); the 6-byte
        # prefix is the cSHAKE-style domain [1, R+2, 1, 0, 1, 96]
        init = bytes([0x01, self.R + 2, 0x01, 0x00, 0x01, 0x60])
        init += b"STROBEv1.0.2"
        init += bytes(200 - len(init))
        self.lanes = self._f(
            [int.from_bytes(init[i * 8:(i + 1) * 8], "little")
             for i in range(25)])
        self.off = 0          # spec: pos within the rate
        self.begin = 0        # spec: pos_begin
        self.flags = None
        # operate(meta_ad, label) per spec 5.1 "initial AD of the
        # protocol label as meta-AD"
        self.operate(0x10 | 0x02, label)

    # -- lane-level byte access (the structural difference) --
    def _get(self, i: int) -> int:
        return (self.lanes[i // 8] >> (8 * (i % 8))) & 0xFF

    def _xor(self, i: int, b: int) -> None:
        self.lanes[i // 8] ^= b << (8 * (i % 8))

    def _set(self, i: int, b: int) -> None:
        lane = self.lanes[i // 8]
        shift = 8 * (i % 8)
        self.lanes[i // 8] = (lane & ~(0xFF << shift)) | (b << shift)

    def _runf(self) -> None:
        # spec 6.2: absorb pos_begin and the padding byte, permute
        self._xor(self.off, self.begin)
        self._xor(self.off + 1, 0x04)
        self._xor(self.R + 1, 0x80)
        self.lanes = self._f(self.lanes)
        self.off = 0
        self.begin = 0

    def operate(self, flags: int, data: bytes, n: int = 0) -> bytes | None:
        """One whole (non-continued) operation per spec 7: frame then
        duplex.  ``n`` nonzero = output op (PRF)."""
        # spec 6.3 _begin_op: duplex([pos_begin, flags]) with pos_begin
        # recorded BEFORE the frame bytes are absorbed
        old = self.begin
        self.begin = self.off + 1
        self.flags = flags
        for b in (old, flags):
            self._xor(self.off, b)
            self.off += 1
            if self.off == self.R:
                self._runf()
        if flags & (0x04 | 0x20) and self.off != 0:  # C or K: align to F
            self._runf()
        if n:  # squeeze (overwrite mode: output then zero, spec 7 PRF)
            out = bytearray()
            for _ in range(n):
                out.append(self._get(self.off))
                self._set(self.off, 0)
                self.off += 1
                if self.off == self.R:
                    self._runf()
            return bytes(out)
        for b in data:  # absorb
            self._xor(self.off, b)
            self.off += 1
            if self.off == self.R:
                self._runf()
        return None

    # merlin's three ops
    def meta_ad(self, d: bytes) -> None:
        self.operate(0x10 | 0x02, d)

    def ad(self, d: bytes) -> None:
        self.operate(0x02, d)

    def prf(self, n: int) -> bytes:
        return self.operate(0x01 | 0x02 | 0x04, b"", n)


def test_strobe_spec_twin_differential():
    """Randomized op sequences through the production Strobe128 and the
    spec-derived twin above must agree byte-for-byte — including ops that
    cross the 166-byte rate boundary, long squeezes, and absorb-after-
    squeeze chaining that the merlin doc vector never exercises."""
    import random

    from cpzk_tpu_torch.core.strobe import Strobe128

    rng = random.Random(0xC0FFEE)
    for trial in range(20):
        label = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 40)))
        prod = Strobe128(label)
        spec = _SpecStrobe128(label)
        for step in range(rng.randrange(2, 12)):
            op = rng.randrange(3)
            if op == 0:
                d = bytes(rng.randrange(256)
                          for _ in range(rng.randrange(0, 400)))
                prod.meta_ad(d, False)
                spec.meta_ad(d)
            elif op == 1:
                d = bytes(rng.randrange(256)
                          for _ in range(rng.randrange(0, 400)))
                prod.ad(d, False)
                spec.ad(d)
            else:
                n = rng.randrange(1, 300)
                a, b = prod.prf(n, False), spec.prf(n)
                assert a == b, f"trial {trial} step {step}: PRF diverged"
        # final drain: states must still be aligned
        assert prod.prf(64, False) == spec.prf(64), f"trial {trial} drain"


def test_strobe_spec_twin_merlin_vector():
    """The spec twin reproduces the merlin doc vector through merlin's own
    framing (meta-AD of 'Merlin v1.0', dom-sep appends, PRF challenge) —
    tying the spec-derived STROBE directly to the external anchor."""
    # merlin framing: Transcript::new(label) = Strobe128("Merlin v1.0")
    # then append_message(b"dom-sep", label); append_message(label, msg) =
    # meta_ad(label || LE32(len(msg))) then ad(msg); challenge_bytes =
    # meta_ad(label || LE32(n)) then prf(n)
    spec2 = _SpecStrobe128(b"Merlin v1.0")
    for label, msg in ((b"dom-sep", b"test protocol"),
                       (b"some label", b"some data")):
        spec2.meta_ad(label + len(msg).to_bytes(4, "little"))
        spec2.ad(msg)
    spec2.meta_ad(b"challenge" + (32).to_bytes(4, "little"))
    out = spec2.prf(32)
    assert out.hex() == \
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


def test_device_challenges_env_warns_once(monkeypatch):
    """CPZK_DEVICE_CHALLENGES=1 deployments must be told (once) that
    serving derives challenges on the host core, instead of the variable
    doing nothing without a word."""
    import warnings

    import pytest

    from cpzk_tpu_torch.core import transcript as tr

    def derive():
        w = b"\x01" * 32
        return tr.derive_challenges_batch([None], [w], [w], [w], [w], [w], [w])

    monkeypatch.setenv("CPZK_DEVICE_CHALLENGES", "1")
    monkeypatch.setattr(tr, "_DEVICE_CHALLENGES_WARNED", False)
    with pytest.warns(UserWarning, match="device-challenge"):
        assert len(derive()) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a second warning would raise
        assert len(derive()) == 1

    # unset env: no warning at all
    monkeypatch.delenv("CPZK_DEVICE_CHALLENGES")
    monkeypatch.setattr(tr, "_DEVICE_CHALLENGES_WARNED", False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(derive()) == 1
