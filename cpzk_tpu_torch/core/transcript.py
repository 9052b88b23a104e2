"""Fiat-Shamir transcript — Merlin-protocol twin for Chaum-Pedersen.

Message framing follows the ``merlin`` crate exactly:

- ``Transcript::new(label)``: STROBE-128 init with protocol label
  ``b"Merlin v1.0"`` then ``append_message(b"dom-sep", label)``.
- ``append_message(label, msg)``: ``meta_AD(label) || meta_AD(LE32(len))``
  then ``AD(msg)``.
- ``challenge_bytes(label, n)``: ``meta_AD(label) || meta_AD(LE32(n))`` then
  ``PRF(n)``.

The protocol-level labels and append order mirror the reference
``src/primitives/transcript.rs:11-71`` byte for byte: protocol label
``"Chaum-Pedersen ZKP v1.0.0"``, protocol DST ``"chaum-pedersen-ristretto255"``,
challenge DST ``"challenge"``, and the 64-byte wide challenge reduction.
"""

from . import _native
from .scalars import sc_from_bytes_mod_order_wide
from .strobe import Strobe128

MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"
PROTOCOL_LABEL = b"Chaum-Pedersen ZKP v1.0.0"
PROTOCOL_DST = b"chaum-pedersen-ristretto255"
CHALLENGE_DST = b"challenge"
WIDE_REDUCTION_BYTES = 64


class MerlinTranscript:
    """General Merlin transcript (crate-level twin)."""

    def __init__(self, label: bytes):
        self.strobe = Strobe128(MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        data_len = len(message).to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = n.to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)


class Transcript:
    """Chaum-Pedersen protocol transcript (reference ``Transcript`` twin).

    Mirrors ``src/primitives/transcript.rs:29-71``: construction appends the
    protocol DST under label ``"protocol"``; context/parameters/statement/
    commitment appends use the same labels; ``challenge_scalar`` squeezes 64
    bytes under ``"challenge"`` and wide-reduces mod ℓ.  Runs on the host
    core's Merlin (:class:`._native.NativeMerlin`).
    """

    def __init__(self) -> None:
        self._t = self._merlin(PROTOCOL_LABEL)
        self._t.append_message(b"protocol", PROTOCOL_DST)

    @staticmethod
    def _merlin(label: bytes):
        return _native.NativeMerlin(label)

    def append_context(self, context: bytes) -> None:
        self._t.append_message(b"context", context)

    def append_parameters(self, generator_g: bytes, generator_h: bytes) -> None:
        self._t.append_message(b"generator-g", generator_g)
        self._t.append_message(b"generator-h", generator_h)

    def append_statement(self, y1: bytes, y2: bytes) -> None:
        self._t.append_message(b"y1", y1)
        self._t.append_message(b"y2", y2)

    def append_commitment(self, r1: bytes, r2: bytes) -> None:
        self._t.append_message(b"r1", r1)
        self._t.append_message(b"r2", r2)

    def challenge_scalar(self):
        from .ristretto import Scalar

        buf = self._t.challenge_bytes(CHALLENGE_DST, WIDE_REDUCTION_BYTES)
        return Scalar(sc_from_bytes_mod_order_wide(buf))


class PureTranscript(Transcript):
    """:class:`Transcript` on the pure-Python Merlin twin (the tests'
    oracle for the native core; byte-identical)."""

    @staticmethod
    def _merlin(label: bytes):
        return MerlinTranscript(label)


_DEVICE_CHALLENGES_WARNED = False


def _warn_device_challenges_ignored() -> None:
    """One-time notice for deployments that still set
    ``CPZK_DEVICE_CHALLENGES=1``: the serving path has no device-challenge
    route, so the variable does nothing; say so once instead of letting it
    rot unnoticed in a config template."""
    global _DEVICE_CHALLENGES_WARNED
    if _DEVICE_CHALLENGES_WARNED:
        return
    _DEVICE_CHALLENGES_WARNED = True
    import os

    if os.environ.get("CPZK_DEVICE_CHALLENGES") == "1":
        import warnings

        warnings.warn(
            "CPZK_DEVICE_CHALLENGES=1 is set, but serving has no "
            "device-challenge path: challenges derive on the host core "
            "(on an NVIDIA H100 80GB HBM3 at 700 W the host core measured "
            "1.4-6.9x faster than ops.challenge.derive_challenges_device at "
            "16,384 rows; that function stays available off the serving "
            "path) — drop the env var",
            stacklevel=3,
        )


def derive_challenges_batch(
    contexts: list[bytes | None],
    gs: list[bytes],
    hs: list[bytes],
    y1s: list[bytes],
    y2s: list[bytes],
    r1s: list[bytes],
    r2s: list[bytes],
):
    """Fiat-Shamir challenges for a whole batch (host hot loop of batch
    verification; reference analog ``src/verifier/batch.rs:239-260``), on
    the host core's thread pool, one thread per online CPU.  Returns a list
    of Scalars."""
    from .ristretto import Scalar

    _warn_device_challenges_ignored()
    out = _native.challenge_batch(
        contexts,
        b"".join(gs), b"".join(hs),
        b"".join(y1s), b"".join(y2s),
        b"".join(r1s), b"".join(r2s),
    )
    return [
        Scalar(sc_from_bytes_mod_order_wide(out[64 * i : 64 * i + 64]))
        for i in range(len(contexts))
    ]


def derive_challenges_batch_pure(
    contexts: list[bytes | None],
    gs: list[bytes],
    hs: list[bytes],
    y1s: list[bytes],
    y2s: list[bytes],
    r1s: list[bytes],
    r2s: list[bytes],
):
    """Pure-Python twin of :func:`derive_challenges_batch`: one
    :class:`PureTranscript` per row."""
    scalars = []
    for i in range(len(contexts)):
        t = PureTranscript()
        if contexts[i] is not None:
            t.append_context(contexts[i])
        t.append_parameters(gs[i], hs[i])
        t.append_statement(y1s[i], y2s[i])
        t.append_commitment(r1s[i], r2s[i])
        scalars.append(t.challenge_scalar())
    return scalars
