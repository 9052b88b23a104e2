"""Single-proof verifier — reference ``src/verifier/mod.rs`` twin.

Checks ``g^s == r1 * y1^c`` and ``h^s == r2 * y2^c``; the transcript variant
validates the statement first and mirrors the prover's Fiat-Shamir ordering
(``verifier/mod.rs:120-171``).
"""

from __future__ import annotations

from ..errors import InvalidGroupElement, InvalidParams, InvalidProofEncoding
from ..core import _native, edwards
from ..core.ristretto import BAD_POINT, Ristretto255, Scalar
from ..core.transcript import PureTranscript, Transcript
from .gadgets import Parameters, Proof, Statement


class Verifier:
    def __init__(self, params: Parameters, statement: Statement):
        self.params = params
        self.statement = statement

    def verify(self, proof: Proof) -> None:
        """NIZK verification with a fresh transcript (verifier/mod.rs:85-88)."""
        self.verify_with_transcript(proof, Transcript())

    def verify_with_transcript(self, proof: Proof, transcript: Transcript) -> None:
        """Context-bound verification (verifier/mod.rs:120-139). Raises on failure."""
        self.statement.validate()
        self.verify_response(self._challenge(proof, transcript), proof)

    def verify_pure(self, proof: Proof, context: bytes | None = None) -> None:
        """Pure-Python twin of ``verify_with_transcript(proof, t)`` with a
        fresh transcript ``t`` bound to ``context`` (when not None):
        statement validation, transcript and group operations all in
        Python.  The tests' and ``chip_smoke.py``'s oracle."""
        Ristretto255.validate_element_pure(self.statement.y1)
        Ristretto255.validate_element_pure(self.statement.y2)
        transcript = PureTranscript()
        if context is not None:
            transcript.append_context(context)
        self.verify_response_pure(self._challenge(proof, transcript), proof)

    def _challenge(self, proof: Proof, transcript: Transcript) -> Scalar:
        transcript.append_parameters(
            Ristretto255.element_to_bytes(self.params.generator_g),
            Ristretto255.element_to_bytes(self.params.generator_h),
        )
        transcript.append_statement(
            Ristretto255.element_to_bytes(self.statement.y1),
            Ristretto255.element_to_bytes(self.statement.y2),
        )
        transcript.append_commitment(
            Ristretto255.element_to_bytes(proof.commitment.r1),
            Ristretto255.element_to_bytes(proof.commitment.r2),
        )
        return transcript.challenge_scalar()

    def verify_response(self, challenge: Scalar, proof: Proof) -> None:
        """Interactive fourth message check (verifier/mod.rs:144-171), one
        row of the host core's verifier."""
        eb = Ristretto255.element_to_bytes
        status = _native.verify_rows(
            eb(self.params.generator_g), eb(self.params.generator_h),
            eb(self.statement.y1), eb(self.statement.y2),
            eb(proof.commitment.r1), eb(proof.commitment.r2),
            Ristretto255.scalar_to_bytes(proof.response.s),
            Ristretto255.scalar_to_bytes(challenge),
            threads=1,
        )[0]
        if status == 2:
            # a deferred-parse proof whose commitment wire never decoded:
            # the eager parse's error, even at this single-proof entry point
            raise InvalidProofEncoding(BAD_POINT)
        if status != 1:
            raise InvalidParams("Proof verification failed")

    def verify_response_pure(self, challenge: Scalar, proof: Proof) -> None:
        """Pure-Python twin of :meth:`verify_response`."""
        try:
            r1 = proof.commitment.r1.point
            r2 = proof.commitment.r2.point
        except InvalidGroupElement:
            raise InvalidProofEncoding(BAD_POINT) from None
        s, c = proof.response.s.value, challenge.value
        mul, add, eq = edwards.pt_scalar_mul, edwards.pt_add, edwards.pt_eq
        ok1 = eq(mul(self.params.generator_g.point, s), add(r1, mul(self.statement.y1.point, c)))
        ok2 = eq(mul(self.params.generator_h.point, s), add(r2, mul(self.statement.y2.point, c)))
        if not (ok1 and ok2):
            raise InvalidParams("Proof verification failed")
