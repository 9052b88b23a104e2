"""Twins of ``tests/test_large_batch.py`` for the port: the configurable
batch ceiling, the 100-user gRPC batch (the reference crate's
``batch_verification_tests.rs:396-460``) driven by the port's client
against the port's server, and the 64k-row batch on the card, which stays
``slow`` as in the reference (and needs the card: it skips without one).
"""

import asyncio
import os

import pytest

from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.client import AuthClient
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.errors import InvalidParams
from cpzk_tpu_torch.protocol.batch import MAX_BATCH_SIZE, BatchVerifier, CpuBackend
from cpzk_tpu_torch.server.config import RateLimiter
from cpzk_tpu_torch.server.service import serve
from cpzk_tpu_torch.server.state import ServerState


def test_batch_ceiling_configurable():
    rng = SecureRng()
    params = Parameters.new()
    prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
    proof = prover.prove_with_transcript(rng, Transcript())

    # reference-parity default (the port's default backend is the card:
    # the host is asked for)
    assert BatchVerifier(backend=CpuBackend()).max_size == MAX_BATCH_SIZE == 1000

    small = BatchVerifier(backend=CpuBackend(), max_size=2)
    small.add(params, prover.statement, proof)
    small.add(params, prover.statement, proof)
    assert small.remaining_capacity() == 0
    with pytest.raises(InvalidParams):
        small.add(params, prover.statement, proof)

    big = BatchVerifier(backend=CpuBackend(), max_size=100_000)
    assert big.remaining_capacity() == 100_000
    with pytest.raises(InvalidParams):
        BatchVerifier(backend=CpuBackend(), max_size=0)


def test_100_user_grpc_batch():
    """100 users register (batch RPC), get challenges, and batch-login —
    the reference's largest integration scenario."""

    async def main():
        rng = SecureRng()
        params = Parameters.new()
        state = ServerState()
        server, port = await serve(
            state, RateLimiter(100_000, 100_000), host="127.0.0.1", port=0,
            backend=CpuBackend(),
        )
        try:
            async with AuthClient(f"127.0.0.1:{port}") as client:
                users = [f"load{i:03d}" for i in range(100)]
                provers = {
                    u: Prover(params, Witness(Ristretto255.random_scalar(rng)))
                    for u in users
                }
                reg = await client.register_batch(
                    users,
                    [Ristretto255.element_to_bytes(provers[u].statement.y1) for u in users],
                    [Ristretto255.element_to_bytes(provers[u].statement.y2) for u in users],
                )
                assert len(reg.results) == 100 and all(r.success for r in reg.results)

                challenge_ids, proofs = [], []
                for u in users:
                    ch = await client.create_challenge(u)
                    cid = bytes(ch.challenge_id)
                    t = Transcript()
                    t.append_context(cid)
                    proofs.append(provers[u].prove_with_transcript(rng, t).to_bytes())
                    challenge_ids.append(cid)

                resp = await client.verify_proof_batch(users, challenge_ids, proofs)
                assert len(resp.results) == 100
                assert all(r.success and r.session_token for r in resp.results)
                assert await state.session_count() == 100
        finally:
            await server.stop(None)

    asyncio.run(main())


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.skipif(
    not os.environ.get("CPZK_SLOW_TESTS"),
    reason="64k-row batch on the card: set CPZK_SLOW_TESTS=1 (slow tier, on a GPU)",
)
def test_64k_row_device_batch():
    """64k rows through TorchBackend's Pippenger combined check on the
    card + one corrupted row falling back to per-proof results."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from cpzk_tpu_torch.ops.backend import TorchBackend

    rng = SecureRng()
    params = Parameters.new()
    corpus = []
    for _ in range(16):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        corpus.append((prover.statement, prover.prove_with_transcript(rng, Transcript())))

    n = 65_536
    bv = BatchVerifier(backend=TorchBackend(pippenger_min=2), max_size=n)
    for i in range(n):
        st, pr = corpus[i % len(corpus)]
        bv.add(params, st, pr)
    assert bv.verify(rng) == [None] * n

    bad = BatchVerifier(backend=TorchBackend(pippenger_min=2), max_size=n)
    for i in range(n - 1):
        st, pr = corpus[i % len(corpus)]
        bad.add(params, st, pr)
    bad.add(params, corpus[0][0], corpus[1][1])  # mismatched
    results = bad.verify(rng)
    assert results[-1] is not None
    assert all(r is None for r in results[:-1])
