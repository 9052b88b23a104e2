"""Protocol gadgets: Parameters, Witness, Statement, Commitment, Response, Proof.

Mirrors the reference ``src/primitives/gadgets.rs`` including the exact
109-byte versioned, length-prefixed proof wire format
(``gadgets.rs:343-361``) and every ``from_bytes`` rejection rule
(``gadgets.rs:364-489``): size caps, truncation, trailing bytes, identity
commitments, zero responses.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import Error, InvalidParams
from ..core import _native
from ..core.ristretto import Element, Ristretto255, Scalar

PROTOCOL_VERSION = 1

# The one wire size a valid proof can have: ver(1) + 3 × [len u32 + 32-byte
# field].  Other sizes still parse (and fail) through the framing loop so
# the reference's per-field error messages are preserved.
PROOF_WIRE_SIZE = 1 + 3 * (4 + 32)

MAX_ELEMENT_SIZE = 4096
MAX_SCALAR_SIZE = 512
MIN_PROOF_SIZE = 1 + 4 + 1 + 4 + 1 + 4 + 1


def frame_fields(version: int, *fields: bytes) -> bytes:
    """The proof wire framing: ``[ver u8]`` then u32-BE length-prefixed
    fields."""
    out = bytearray([version])
    for field in fields:
        out += len(field).to_bytes(4, "big")
        out += field
    return bytes(out)


@dataclass(frozen=True)
class Parameters:
    """Public generators (g, h) — gadgets.rs:25-121."""

    generator_g: Element
    generator_h: Element

    @staticmethod
    def new() -> "Parameters":
        return Parameters(Ristretto255.generator_g(), Ristretto255.generator_h())

    @staticmethod
    def with_generators(g: Element, h: Element) -> "Parameters":
        """Custom generators; rejects identity/equal/invalid (gadgets.rs:77-103)."""
        Ristretto255.validate_element(g)
        Ristretto255.validate_element(h)
        if Ristretto255.is_identity(g):
            raise InvalidParams("Generator g cannot be identity")
        if Ristretto255.is_identity(h):
            raise InvalidParams("Generator h cannot be identity")
        if g == h:
            raise InvalidParams("Generators g and h must be different")
        return Parameters(g, h)


class Witness:
    """Secret discrete log x (gadgets.rs:125-164).

    Best-effort zeroization: ``clear()`` wipes the value; Python cannot
    guarantee copies are destroyed.
    """

    __slots__ = ("_x",)

    def __init__(self, x: Scalar):
        self._x = x

    def secret(self) -> Scalar:
        return self._x

    def clear(self) -> None:
        self._x = Scalar(0)

    def __repr__(self) -> str:
        # redaction guard: a Witness in a log line / traceback / debugger
        # must never emit the scalar encoding
        return "Witness(<secret scalar redacted>)"

    __str__ = __repr__


@dataclass(frozen=True)
class Statement:
    """Public values y1 = g^x, y2 = h^x (gadgets.rs:168-238)."""

    y1: Element
    y2: Element

    @staticmethod
    def from_witness(params: Parameters, witness: Witness) -> "Statement":
        y1, y2 = Ristretto255.double_base_mul(
            params.generator_g, params.generator_h, witness.secret()
        )
        return Statement(y1, y2)

    def validate(self) -> None:
        Ristretto255.validate_element(self.y1)
        Ristretto255.validate_element(self.y2)


@dataclass(frozen=True)
class Commitment:
    """First prover message r1 = g^k, r2 = h^k (gadgets.rs:244-265)."""

    r1: Element
    r2: Element


class Response:
    """Prover response s = k + c*x (gadgets.rs:270-286)."""

    __slots__ = ("_s",)

    def __init__(self, s: Scalar):
        self._s = s

    @property
    def s(self) -> Scalar:
        return self._s

    def clear(self) -> None:
        self._s = Scalar(0)

    def __repr__(self) -> str:
        # redaction guard: the response scalar is bound to the witness
        return "Response(<secret scalar redacted>)"

    __str__ = __repr__


class Proof:
    """Complete NIZK proof: version + commitment + response (gadgets.rs:306-489).

    ``deferred`` marks a proof built by the frame-only fast parse
    (:meth:`from_bytes_batch` with ``defer_point_validation=True``): the
    framing, scalar and identity rules are already enforced, but the two
    commitment point decodes are postponed to the batch-verify stage.
    ``BatchVerifier`` screens or tri-state-maps deferred proofs so that
    accept/reject and error messages are identical to eager parsing."""

    __slots__ = ("version", "commitment", "response", "deferred")

    def __init__(self, commitment: Commitment, response: Response, version: int = PROTOCOL_VERSION):
        self.version = version
        self.commitment = commitment
        self.response = response
        self.deferred = False

    def to_bytes(self) -> bytes:
        """Wire format: ``[ver u8][len u32_be|r1][len|r2][len|s]`` = 109 bytes."""
        return frame_fields(
            self.version,
            Ristretto255.element_to_bytes(self.commitment.r1),
            Ristretto255.element_to_bytes(self.commitment.r2),
            Ristretto255.scalar_to_bytes(self.response.s),
        )

    @staticmethod
    def _response_of(data: bytes) -> Response:
        # the native parser proved s canonical (< l): skip the reduction
        s = Scalar.__new__(Scalar)
        s.value = int.from_bytes(data[77:109], "little")
        resp = Response.__new__(Response)
        resp._s = s
        return resp

    @staticmethod
    def _from_validated_wire(data: bytes) -> "Proof":
        """Construct from a PROOF_WIRE_SIZE wire that the native parser
        validated end to end (framing, canonical non-identity points,
        canonical nonzero scalar)."""
        return Proof(
            Commitment(Element(wire=data[5:37], validated=True),
                       Element(wire=data[41:73], validated=True)),
            Proof._response_of(data),
        )

    @staticmethod
    def _from_framed_wire(data: bytes) -> "Proof":
        """Construct from a frame-checked wire whose point decodes are
        deferred to the verify stage (commitment elements unvalidated)."""
        p = Proof(
            Commitment(Element(wire=data[5:37]), Element(wire=data[41:73])),
            Proof._response_of(data),
        )
        p.deferred = True
        return p

    @staticmethod
    def from_bytes_batch(
        items: "list[bytes]",
        defer_point_validation: bool = False,
        packed: bytes | None = None,
    ) -> "list[Proof | Error]":
        """Parse n proof wires with one native validation call for the
        whole batch (the host core's parse pool).  Per item, a
        :class:`Proof` or the :class:`~cpzk_tpu_torch.errors.Error` that
        :meth:`from_bytes` raises for it: items the native pass rejects
        re-parse on the Python parser, so error messages are exactly the
        reference's (gadgets.rs:364-489).

        ``defer_point_validation=True`` skips the two commitment point
        decodes and returns ``deferred`` proofs (see :class:`Proof`); hand
        those only to a :class:`~cpzk_tpu_torch.protocol.batch.BatchVerifier`.

        ``packed`` is the concatenation of ``items`` with every item at
        ``PROOF_WIRE_SIZE``: the buffer the native request-wire parse
        gathers straight off the socket bytes (``server/wire.py``).  The
        native validation then runs over it with no per-item join, and an
        item it accepts is built from its slice of ``packed``, the bytes
        that were validated.  A buffer of any other length is ignored."""
        n = len(items)
        results: list = [None] * n
        if packed is not None and n and len(packed) == PROOF_WIRE_SIZE * n:
            sized = range(n)
        else:
            packed = None
            sized = [i for i in range(n) if len(items[i]) == PROOF_WIRE_SIZE]
        if sized:
            if packed is None:
                packed = b"".join(bytes(items[i]) for i in sized)
            flags = _native.parse_proofs(packed, deep=not defer_point_validation)
            build = (Proof._from_framed_wire if defer_point_validation
                     else Proof._from_validated_wire)
            for j, i in enumerate(sized):
                if flags[j]:
                    results[i] = build(packed[PROOF_WIRE_SIZE * j:PROOF_WIRE_SIZE * (j + 1)])
        for i in range(n):
            if results[i] is None:
                # the native pass rejected (or never applies to) this item:
                # the Python parser gives its exact error
                try:
                    results[i] = Proof._from_bytes_slow(items[i])
                except Error as e:
                    results[i] = e
        return results

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        """Full adversarial-input validation (gadgets.rs:364-489), with the
        reference's exact error messages: one native call validates a
        109-byte wire, and anything it rejects goes through the Python
        parser for the message."""
        if len(data) == PROOF_WIRE_SIZE:
            if _native.parse_proofs(bytes(data), threads=1) == b"\x01":
                return Proof._from_validated_wire(bytes(data))
        return Proof._from_bytes_slow(data)

    @staticmethod
    def _from_bytes_slow(data: bytes) -> "Proof":
        """The Python parser, decoding points on the host core."""
        return Proof._parse(data, Ristretto255.element_from_bytes)

    @staticmethod
    def from_bytes_pure(data: bytes) -> "Proof":
        """Pure-Python twin of :meth:`from_bytes` (the tests' oracle)."""
        return Proof._parse(data, Ristretto255.element_from_bytes_pure)

    @staticmethod
    def _parse(data: bytes, element_from_bytes) -> "Proof":
        """Per-field validation with the reference's exact error messages."""
        if len(data) < MIN_PROOF_SIZE:
            raise InvalidParams(f"Proof too small: {len(data)} bytes")

        version = data[0]
        if version != PROTOCOL_VERSION:
            raise InvalidParams(f"Unsupported proof version: {version}")

        pos = 1
        fields = []
        for name, cap in (("r1", MAX_ELEMENT_SIZE), ("r2", MAX_ELEMENT_SIZE), ("s", MAX_SCALAR_SIZE)):
            if pos + 4 > len(data):
                raise InvalidParams(f"Truncated proof: missing {name} length")
            flen = int.from_bytes(data[pos : pos + 4], "big")
            pos += 4
            if flen == 0 or flen > cap:
                raise InvalidParams(f"Invalid {name} length: {flen}")
            if pos + flen > len(data):
                raise InvalidParams(f"Truncated proof: incomplete {name} data")
            fields.append(data[pos : pos + flen])
            pos += flen

        if pos != len(data):
            raise InvalidParams(f"Proof has {len(data) - pos} trailing bytes")

        # both decoders return canonical (validated) elements, so the
        # reference's recompression validation is already done here
        r1 = element_from_bytes(fields[0])
        r2 = element_from_bytes(fields[1])
        s = Ristretto255.scalar_from_bytes(fields[2])

        if Ristretto255.is_identity(r1) or Ristretto255.is_identity(r2):
            raise InvalidParams("Commitment contains identity element")
        if Ristretto255.scalar_is_zero(s):
            raise InvalidParams("Response scalar is zero")

        return Proof(Commitment(r1, r2), Response(s), version)
