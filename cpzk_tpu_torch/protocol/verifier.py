"""Single-proof verifier — reference ``src/verifier/mod.rs`` twin.

Checks ``g^s == r1 * y1^c`` and ``h^s == r2 * y2^c``; the transcript variant
validates the statement first and mirrors the prover's Fiat-Shamir ordering
(``verifier/mod.rs:120-171``).
"""

from __future__ import annotations

from ..errors import InvalidParams
from ..core.ristretto import Ristretto255, Scalar
from ..core.transcript import Transcript
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

        challenge = transcript.challenge_scalar()
        self.verify_response(challenge, proof)

    def verify_response(self, challenge: Scalar, proof: Proof) -> None:
        """Interactive fourth message check (verifier/mod.rs:144-171)."""
        g = self.params.generator_g
        h = self.params.generator_h
        y1 = self.statement.y1
        y2 = self.statement.y2
        r1 = proof.commitment.r1
        r2 = proof.commitment.r2
        s = proof.response.s

        lhs1 = Ristretto255.scalar_mul(g, s)
        rhs1 = Ristretto255.element_mul(r1, Ristretto255.scalar_mul(y1, challenge))
        lhs2 = Ristretto255.scalar_mul(h, s)
        rhs2 = Ristretto255.element_mul(r2, Ristretto255.scalar_mul(y2, challenge))

        if not (lhs1 == rhs1 and lhs2 == rhs2):
            raise InvalidParams("Proof verification failed")
