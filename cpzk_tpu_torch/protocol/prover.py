"""Prover — reference ``src/prover/mod.rs`` twin.

NIZK (Fiat-Shamir) and interactive flows. Transcript append order is
normative and mirrors ``prover/mod.rs:86-110``: [context (caller)] →
parameters → statement → commitment → challenge.
"""

from __future__ import annotations

from ..core.ristretto import Ristretto255, Scalar
from ..core.rng import SecureRng
from ..core.transcript import Transcript
from .gadgets import Commitment, Parameters, Proof, Response, Statement, Witness


class Nonce:
    """Secret commitment nonce k (prover/mod.rs:137-152)."""

    __slots__ = ("_k",)

    def __init__(self, k: Scalar):
        self._k = k

    def k(self) -> Scalar:
        return self._k

    def clear(self) -> None:
        self._k = Scalar(0)

    def __repr__(self) -> str:
        # redaction guard: leaking k leaks the witness (s = k + c*x), so
        # reprs must never emit its encoding
        return "Nonce(<secret scalar redacted>)"

    __str__ = __repr__


class Prover:
    """Generates proofs of knowledge of x with y1 = g^x, y2 = h^x."""

    def __init__(self, params: Parameters, witness: Witness, statement: Statement | None = None):
        self.params = params
        self.witness = witness
        self.statement = statement if statement is not None else Statement.from_witness(params, witness)

    def prove(self, rng: SecureRng) -> Proof:
        """NIZK proof with a fresh protocol transcript (prover/mod.rs:78-81)."""
        return self.prove_with_transcript(rng, Transcript())

    def prove_with_transcript(self, rng: SecureRng, transcript: Transcript) -> Proof:
        """NIZK proof over a caller-prepared transcript (prover/mod.rs:86-110)."""
        commitment, nonce = self.commit(rng)

        transcript.append_parameters(
            Ristretto255.element_to_bytes(self.params.generator_g),
            Ristretto255.element_to_bytes(self.params.generator_h),
        )
        transcript.append_statement(
            Ristretto255.element_to_bytes(self.statement.y1),
            Ristretto255.element_to_bytes(self.statement.y2),
        )
        transcript.append_commitment(
            Ristretto255.element_to_bytes(commitment.r1),
            Ristretto255.element_to_bytes(commitment.r2),
        )

        challenge = transcript.challenge_scalar()
        response = self.respond(nonce, challenge)
        nonce.clear()
        return Proof(commitment, response)

    def commit(self, rng: SecureRng) -> tuple[Commitment, Nonce]:
        """Interactive first message: k ← rng, r1 = g^k, r2 = h^k (prover/mod.rs:115-121)."""
        k = Ristretto255.random_scalar(rng)
        r1, r2 = Ristretto255.double_base_mul(
            self.params.generator_g, self.params.generator_h, k
        )
        return Commitment(r1, r2), Nonce(k)

    def respond(self, nonce: Nonce, challenge: Scalar) -> Response:
        """Interactive third message: s = k + c*x (prover/mod.rs:126-131)."""
        cx = Ristretto255.scalar_mul_scalar(challenge, self.witness.secret())
        s = Ristretto255.scalar_add(nonce.k(), cx)
        return Response(s)
