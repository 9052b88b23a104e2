"""Ristretto255 group API — reference ``src/primitives/ristretto.rs`` twin.

``Scalar`` and ``Element`` are immutable newtypes over the integer/extended-
coordinate representations in :mod:`.scalars` and :mod:`.edwards`.
``Ristretto255`` is the static namespace whose method set mirrors the
reference line for line (generators, canonical (de)serialization, random
scalars via 64-byte wide reduction, group ops, recompression validation).

Decoding, validation and the group operations run on the port's C++ host
core (:mod:`._native`); elements parsed from bytes carry their wire only
and decode to coordinates on first ``.point`` access.  Secret scalars (the
prover's nonce and witness) go through :meth:`Ristretto255.double_base_mul`,
the core's constant-time fixed-base comb; there is no variable-time
fallback for them.  The pure-Python twins (``*_pure``) are the tests'
oracles and are reached only by name.
"""

from __future__ import annotations

import hashlib
import hmac

from ..errors import InvalidGroupElement, InvalidScalar
from . import _native, edwards, scalars
from .rng import SecureRng

RISTRETTO_BYTES = 32
WIDE_REDUCTION_BYTES = 64

#: The decode error's message (eager parse, and deferred-parse rows).
BAD_POINT = "Bytes do not represent a valid Ristretto point"

# Domain separation tag for the second generator h (ristretto.rs:27).
GENERATOR_H_DST = b"chaum-pedersen-zkp-v1.0.0-generator-h"


class Scalar:
    """Scalar mod ℓ. Equality is constant-time on the canonical encoding."""

    __slots__ = ("value",)

    def __init__(self, value: int):
        self.value = value % scalars.L

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Scalar):
            return NotImplemented
        # constant-time compare of canonical encodings (subtle::ConstantTimeEq twin)
        return hmac.compare_digest(scalars.sc_to_bytes(self.value), scalars.sc_to_bytes(other.value))

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"Scalar(0x{self.value:064x})"


class Element:
    """Ristretto255 group element (point coset).

    Dual representation, each computed lazily from the other and cached:
    ``point`` (extended Edwards coordinates, for the pure-Python paths) and
    ``wire()`` (the canonical 32-byte encoding the host core and the GPU
    marshalling consume).  Elements parsed from bytes or produced by the
    host core carry wire bytes only and decode on first ``.point`` access.
    """

    __slots__ = ("_point", "_wire", "_validated")

    def __init__(
        self,
        point: edwards.Point | None = None,
        wire: bytes | None = None,
        validated: bool = False,
    ):
        if point is None and wire is None:
            raise ValueError("Element needs a point or wire bytes")
        self._point = point
        self._wire = wire
        # True when the wire bytes are known canonical (they passed the
        # canonical decode, or came out of an internal group op): then
        # recompression validation is skipped.  Wire bytes handed to this
        # constructor without a decode still get validated (fail-closed).
        self._validated = validated

    @property
    def point(self) -> edwards.Point:
        if self._point is None:
            self._point = edwards.ristretto_decode(self._wire)
            if self._point is None:
                # reachable for a deferred-parse proof's commitment wire
                # (frame-checked, decode postponed to the verify stage)
                raise InvalidGroupElement(BAD_POINT)
        return self._point

    def wire(self) -> bytes:
        """Canonical encoding, cached after first computation."""
        if self._wire is None:
            self._wire = edwards.ristretto_encode(self._point)
        return self._wire

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Element):
            return NotImplemented
        if self._wire is not None and other._wire is not None:
            return self._wire == other._wire
        return edwards.pt_eq(self.point, other.point)

    def __hash__(self) -> int:
        return hash(self.wire())

    def __repr__(self) -> str:
        return f"Element({self.wire().hex()})"


class Ristretto255:
    """Static namespace mirroring the reference group API."""

    _GENERATOR_G_CACHE: Element | None = None
    _GENERATOR_H_CACHE: Element | None = None

    @classmethod
    def generator_g(cls) -> Element:
        if cls._GENERATOR_G_CACHE is None:
            cls._GENERATOR_G_CACHE = Element(edwards.BASEPOINT, validated=True)
        return cls._GENERATOR_G_CACHE

    @classmethod
    def generator_h(cls) -> Element:
        """Second generator: SHA-512(DST) → one-way map (ristretto.rs:86-91)."""
        if cls._GENERATOR_H_CACHE is None:
            digest = hashlib.sha512(GENERATOR_H_DST).digest()
            cls._GENERATOR_H_CACHE = Element(edwards.ristretto_from_uniform_bytes(digest), validated=True)
        return cls._GENERATOR_H_CACHE

    @staticmethod
    def scalar_from_bytes(data: bytes) -> Scalar:
        if len(data) != RISTRETTO_BYTES:
            raise InvalidScalar(f"Expected {RISTRETTO_BYTES} bytes, got {len(data)}")
        v = scalars.sc_from_bytes_canonical(data)
        if v is None:
            raise InvalidScalar("Bytes do not represent a valid scalar")
        return Scalar(v)

    @staticmethod
    def scalar_to_bytes(scalar: Scalar) -> bytes:
        return scalars.sc_to_bytes(scalar.value)

    @staticmethod
    def element_from_bytes(data: bytes) -> Element:
        """Canonical decode on the host core (decode success is validity
        under RFC 9496); the element keeps the wire, coordinates stay lazy."""
        if len(data) != RISTRETTO_BYTES:
            raise InvalidGroupElement(f"Expected {RISTRETTO_BYTES} bytes, got {len(data)}")
        if not _native.point_validate(bytes(data)):
            raise InvalidGroupElement(BAD_POINT)
        return Element(wire=bytes(data), validated=True)

    @staticmethod
    def element_from_bytes_pure(data: bytes) -> Element:
        """Pure-Python twin of :meth:`element_from_bytes` (eager decode)."""
        if len(data) != RISTRETTO_BYTES:
            raise InvalidGroupElement(f"Expected {RISTRETTO_BYTES} bytes, got {len(data)}")
        point = edwards.ristretto_decode(data)
        if point is None:
            raise InvalidGroupElement(BAD_POINT)
        return Element(point, bytes(data), validated=True)

    @staticmethod
    def element_to_bytes(element: Element) -> bytes:
        return element.wire()

    @staticmethod
    def random_scalar(rng: SecureRng) -> Scalar:
        return Scalar(scalars.sc_from_bytes_mod_order_wide(rng.fill_bytes(WIDE_REDUCTION_BYTES)))

    @staticmethod
    def random_scalars(rng: SecureRng, n: int) -> list[Scalar]:
        """``n`` independent uniform scalars from ONE CSPRNG draw, sliced
        into 64-byte windows (same distribution as ``n`` separate draws,
        one syscall)."""
        pool = rng.fill_bytes(WIDE_REDUCTION_BYTES * n)
        return [
            Scalar(scalars.sc_from_bytes_mod_order_wide(
                pool[WIDE_REDUCTION_BYTES * i: WIDE_REDUCTION_BYTES * (i + 1)]
            ))
            for i in range(n)
        ]

    @staticmethod
    def scalar_mul(element: Element, scalar: Scalar) -> Element:
        """scalar * element on the host core, for PUBLIC inputs (variable
        time); secret scalars go through :meth:`double_base_mul`."""
        if scalar.value == 0:
            return Ristretto255.identity()
        out = _native.scalarmul(element.wire(), scalars.sc_to_bytes(scalar.value))
        if not out:
            raise InvalidGroupElement(BAD_POINT)
        return Element(wire=out, validated=True)

    @staticmethod
    def double_base_mul(g: Element, h: Element, scalar: Scalar) -> tuple[Element, Element]:
        """(scalar*g, scalar*h) for SECRET scalars: the prover's nonce
        commitment (prover/mod.rs:115-121) and the statement derivation
        (gadgets.rs:217-221).  Runs the host core's constant-time
        fixed-base comb (signed radix-16, masked table scan, no
        secret-dependent branches).  Raises :class:`._native.NativeCoreError`
        when the comb cannot serve the pair; never runs a variable-time
        ladder instead."""
        if scalar.value == 0:
            return Ristretto255.identity(), Ristretto255.identity()
        gw, hw = g.wire(), h.wire()
        sc = scalars.sc_to_bytes(scalar.value)
        out = _native.double_basemul(gw, hw, sc)
        if out is None and _native.basemul_init(gw, hw):
            # None can also mean the comb-table race (another thread swapped
            # the generator pair between build and read): rebuild, retry once
            out = _native.double_basemul(gw, hw, sc)
        if out is None:
            raise _native.NativeCoreError(
                "constant-time fixed-base comb failed for this generator pair "
                "(a generator does not decode, or concurrent callers churned "
                "the comb tables)")
        return Element(wire=out[0], validated=True), Element(wire=out[1], validated=True)

    @staticmethod
    def element_mul(a: Element, b: Element) -> Element:
        """Group operation (written multiplicatively in the protocol; the
        curve implementation is additive) — ristretto.rs:158-160."""
        out = _native.point_add(a.wire(), b.wire())
        if not out:
            raise InvalidGroupElement(BAD_POINT)
        return Element(wire=out, validated=True)

    @staticmethod
    def identity() -> Element:
        return Element(edwards.IDENTITY, bytes(RISTRETTO_BYTES), validated=True)

    @staticmethod
    def is_identity(element: Element) -> bool:
        if element._wire is not None:
            return element._wire == bytes(RISTRETTO_BYTES)
        return edwards.pt_is_identity(element.point)

    @staticmethod
    def validate_element(element: Element) -> None:
        """Recompression validation (ristretto.rs:173-185): identity is valid;
        otherwise decode→encode on the host core must give back the same
        bytes."""
        if element._validated:
            return  # parse-time canonical decode already proved validity
        if Ristretto255.is_identity(element):
            return
        compressed = element.wire()
        if _native.point_roundtrip(compressed) != compressed:
            raise InvalidGroupElement("Element failed recompression validation")

    @staticmethod
    def validate_element_pure(element: Element) -> None:
        """Pure-Python twin of :meth:`validate_element`."""
        if element._validated:
            return
        if Ristretto255.is_identity(element):
            return
        point = edwards.ristretto_decode(element.wire())
        if point is None or not edwards.pt_eq(point, element.point):
            raise InvalidGroupElement("Element failed recompression validation")

    @staticmethod
    def scalar_add(a: Scalar, b: Scalar) -> Scalar:
        return Scalar(scalars.sc_add(a.value, b.value))

    @staticmethod
    def scalar_sub(a: Scalar, b: Scalar) -> Scalar:
        return Scalar(scalars.sc_sub(a.value, b.value))

    @staticmethod
    def scalar_mul_scalar(a: Scalar, b: Scalar) -> Scalar:
        return Scalar(scalars.sc_mul(a.value, b.value))

    @staticmethod
    def scalar_negate(scalar: Scalar) -> Scalar:
        return Scalar(scalars.sc_neg(scalar.value))

    @staticmethod
    def scalar_invert(scalar: Scalar) -> Scalar | None:
        if scalar.value == 0:
            return None
        return Scalar(scalars.sc_invert(scalar.value))

    @staticmethod
    def scalar_is_zero(scalar: Scalar) -> bool:
        return scalar.value == 0
