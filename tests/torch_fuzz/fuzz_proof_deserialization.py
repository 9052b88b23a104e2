"""Fuzz target: ``Proof.from_bytes`` — the adversarial input surface

(A port-owned copy of the reference package's ``fuzz/fuzz_proof_deserialization.py``,
driving ``cpzk_tpu_torch``.)
(reference analog ``fuzz/fuzz_targets/fuzz_proof_deserialization.rs``;
parser under test mirrors ``src/primitives/gadgets.rs:364-489``).

Invariants:
- any input either parses or raises ``cpzk_tpu_torch.Error`` — never another
  exception type, never a crash;
- a successful parse round-trips: ``to_bytes()`` reproduces the exact
  input (the wire format is canonical);
- a parsed proof never contains identity commitments or a zero response
  (the parser's own rejection rules).

Run: python tests/torch_fuzz/fuzz_proof_deserialization.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

from common import run_fuzzer

from cpzk_tpu_torch import Error, Parameters, Proof, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255


def _seeds() -> list[bytes]:
    rng = SecureRng()
    params = Parameters.new()
    out = []
    for _ in range(4):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        out.append(prover.prove_with_transcript(rng, Transcript()).to_bytes())
    return out


def one_input(data: bytes) -> None:
    try:
        proof = Proof.from_bytes(data)
        verdict = "OK"
    except Error as e:
        proof = None
        verdict = f"{type(e).__name__}: {e}"

    # three-way parse differential: the batched native pass and the
    # deferred-parse pipeline (frame check now, point decodes settled by
    # the dispatcher's screening) must agree with the eager parser on
    # accept/reject AND on the exact error
    b_eager, = Proof.from_bytes_batch([data])
    b_defer, = Proof.from_bytes_batch([data], defer_point_validation=True)
    if isinstance(b_eager, Proof):
        assert verdict == "OK", f"batch accepted what eager rejected: {verdict}"
    else:
        assert verdict == f"{type(b_eager).__name__}: {b_eager}", (
            verdict, f"{type(b_eager).__name__}: {b_eager}")
    if isinstance(b_defer, Proof):
        if b_defer.deferred:  # settle the postponed decodes like verify does
            from cpzk_tpu_torch.protocol.batch import BatchEntry, BatchVerifier, CpuBackend
            from cpzk_tpu_torch.protocol.gadgets import Parameters

            bv = BatchVerifier(backend=CpuBackend())
            bv.entries.append(BatchEntry(Parameters.new(), None, b_defer, None))
            errs = bv._screen_deferred()
            if verdict == "OK":
                assert not errs, f"screening rejected an eager-valid wire: {errs}"
            else:
                assert 0 in errs, f"deferred pipeline accepted: {verdict}"
        else:
            assert verdict == "OK"
    else:
        assert verdict == f"{type(b_defer).__name__}: {b_defer}", (
            verdict, f"{type(b_defer).__name__}: {b_defer}")

    if proof is None:
        return  # expected rejection path
    # canonical wire format: parse -> serialize must be the identity
    assert proof.to_bytes() == bytes(data), "non-canonical accept"
    assert not Ristretto255.is_identity(proof.commitment.r1), "identity r1 accepted"
    assert not Ristretto255.is_identity(proof.commitment.r2), "identity r2 accepted"
    assert proof.response.s.value != 0, "zero response accepted"


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
