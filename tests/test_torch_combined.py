"""Differential tests: the port's combined RLC check
(:func:`cpzk_tpu_torch.ops.verify.combined_kernel` and
``combined_partial_kernel``) against the JAX package's (jitted on the CPU
backend), on the batch of tests/test_torch_verify.py with the correction
row at lane 6.  Verdicts must be equal and the partial point equal after
canonicalization (tolerance: exact)."""

import numpy as np
import pytest

import jax

from cpzk_tpu.ops import curve as jc
from cpzk_tpu.ops import limbs as jl
from cpzk_tpu.ops import verify as jv
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.ops import curve as tc
from cpzk_tpu_torch.ops import limbs as tl
from cpzk_tpu_torch.ops import verify as tv
from test_torch_verify import combined_inputs, make_batch, to_torch


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def test_combined_kernels_match_jax(batch):
    G, H, rows, alphas, beta = batch
    j_partial = jax.jit(jv.combined_partial_kernel)
    j_is_identity = jax.jit(jc.is_identity)

    # valid batch: the full check accepts
    pts, wins = combined_inputs(G, H, rows, alphas, beta, tampered=False)
    jtotal = j_partial(*pts, *wins)
    assert bool(j_is_identity(tuple(c[..., 0] for c in jtotal)))
    assert bool(tv.combined_kernel(*to_torch(pts, wins))) is True

    # one tampered response: the partial point matches, the check rejects
    pts, wins = combined_inputs(G, H, rows, alphas, beta, tampered=True)
    jtotal = j_partial(*pts, *wins)
    ttotal = tv.combined_partial_kernel(*to_torch(pts, wins))
    for j, t in zip(jtotal, ttotal):
        assert t.shape == (20, 1)
        np.testing.assert_array_equal(
            np.asarray(jl.canonical(j)), convert.to_numpy(tl.canonical(t)))
    jok = bool(j_is_identity(tuple(c[..., 0] for c in jtotal)))
    tok = bool(tc.is_identity(tuple(c[..., 0] for c in ttotal)))
    assert jok is tok is False
