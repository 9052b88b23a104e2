"""Differential tests: the port's point operations
(:mod:`cpzk_tpu_torch.ops.curve`) against the JAX package's
(:mod:`cpzk_tpu.ops.curve` on the CPU backend, jitted at the shapes
tests/test_ops_curve.py uses; encode/decode eager).

The algorithms are the same, so points match limb for limb, masks and
encoded bytes exactly (tolerance: exact)."""

import numpy as np
import pytest

import jax

from cpzk_tpu.core import edwards as he
from cpzk_tpu.core import scalars as hs
from cpzk_tpu.ops import curve as jc
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.ops import curve as tc

N = 16

j_add = jax.jit(jc.add)
j_double = jax.jit(jc.double)
j_eq = jax.jit(jc.eq)
j_is_identity = jax.jit(jc.is_identity)
j_scalar_mul = jax.jit(jc.scalar_mul)
j_tree_sum = jax.jit(jc.tree_sum)
# encode/decode run eagerly: op-by-op dispatch costs less than compiling
# their ~800-multiply programs on a cold compilation cache
j_decode = jc.decode
j_encode = jc.encode


def rand_points(rng, n):
    pts = [he.pt_scalar_mul(he.BASEPOINT, int.from_bytes(rng.bytes(32), "little") % hs.L)
           for _ in range(n - 2)]
    return pts + [he.IDENTITY, he.BASEPOINT]


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(4242)
    p = rand_points(rng, N)
    q = rand_points(rng, N)
    ks = [int.from_bytes(rng.bytes(32), "little") % hs.L for _ in range(N - 2)] + [0, 1]
    return p, q, jc.points_to_device(p), jc.points_to_device(q), ks


def same(jax_out, torch_out):
    if isinstance(torch_out, tuple):
        for j, t in zip(jax_out, torch_out):
            np.testing.assert_array_equal(np.asarray(j), convert.to_numpy(t))
    else:
        np.testing.assert_array_equal(np.asarray(jax_out), convert.to_numpy(torch_out))


def test_add_double_double_k(pts):
    p, q, dp, dq, _ = pts
    tp, tq = convert.point(dp, "cpu"), convert.point(dq, "cpu")
    same(j_add(dp, dq), tc.add(tp, tq))
    same(j_double(dp), tc.double(tp))
    # JAX's unfused double_k is k plain doublings: same limbs as the fused op
    same(jax.jit(lambda x: jc.double_k(x, 4))(dp), tc.double_k(tp, 4))
    assert tc.double_k(tp, 0) is tp


def test_eq_is_identity(pts):
    p, q, dp, dq, _ = pts
    tp, tq = convert.point(dp, "cpu"), convert.point(dq, "cpu")
    same(j_eq(dp, dq), tc.eq(tp, tq))
    same(j_eq(dp, dp), tc.eq(tp, tp))
    same(j_is_identity(dp), tc.is_identity(tp))
    assert list(tc.is_identity(tp).numpy()) == [he.pt_is_identity(a) for a in p]


def test_build_table_and_gather(pts):
    _, _, dp, _, _ = pts
    tp = convert.point(dp, "cpu")
    jt = jax.jit(jc.build_table)(dp)
    tt = tc.build_table(tp)
    same(jt, tt)
    idx = np.random.default_rng(9).integers(0, 16, N).astype(np.int32)
    same(jax.jit(jc.table_gather)(jt, idx), tc.table_gather(tt, convert.tensor(idx, "cpu")))
    # a shared [20, 1] table broadcasts against per-lane indices
    one = tuple(c[:, :1] for c in tp)
    shared = tc.table_gather(tc.build_table(one), convert.tensor(idx, "cpu"))
    assert shared[0].shape == (20, N)


def test_scalar_mul(pts):
    p, _, dp, _, ks = pts
    win = jc.scalars_to_windows(ks)
    np.testing.assert_array_equal(tc.scalars_to_windows(ks), win)
    out = tc.scalar_mul(convert.point(dp, "cpu"), convert.tensor(win, "cpu"))
    same(j_scalar_mul(dp, win), out)
    for want, got in zip([he.pt_scalar_mul(a, k) for a, k in zip(p, ks)],
                         tc.points_from_device(out)):
        assert he.pt_eq(want, tuple(v % he.P for v in got))


def test_tree_sum(pts):
    _, _, dp, _, _ = pts
    same(j_tree_sum(dp), tc.tree_sum(convert.point(dp, "cpu")))
    odd = tuple(np.asarray(c)[:, :5] for c in dp)  # identity-padded to 8
    same(jax.jit(jc.tree_sum)(odd), tc.tree_sum(convert.point(odd, "cpu")))


def test_encode_decode(pts):
    p, _, dp, _, _ = pts
    tp = convert.point(dp, "cpu")
    enc = tc.encode(tp)
    jenc = np.asarray(j_encode(dp))
    same(jenc, enc)
    wires = [bytes(convert.to_numpy(enc)[:, j].astype(np.uint8)) for j in range(N)]
    assert wires == [he.ristretto_encode(a) for a in p]
    jpt, jok = j_decode(jenc)
    tpt, tok = tc.decode(enc)
    same(jpt, tpt)
    same(jok, tok)
    assert tok.all()


def test_decode_rejects_invalid():
    """Non-canonical, negative and non-square encodings: same masks and
    identity points as the JAX decode, and the host decoder agrees."""
    bad = [
        (he.P).to_bytes(32, "little"),           # non-canonical (s = p)
        (he.P + 2).to_bytes(32, "little"),       # non-canonical
        (1).to_bytes(32, "little"),              # negative s
        bytes([2]) + bytes(31),                  # even, not on the curve
        bytes(32),                               # identity: valid
        b"\xff" * 32,                            # >= 2^255
    ] + [bytes([2 * k]) + bytes(31) for k in range(2, 12)]
    arr = np.stack([np.frombuffer(b, dtype=np.uint8) for b in bad], axis=-1).astype(np.int32)
    jpt, jok = j_decode(arr)
    tpt, tok = tc.decode(convert.tensor(arr, "cpu"))
    same(jok, tok)
    same(jpt, tpt)
    assert list(tok.numpy()) == [he.ristretto_decode(b) is not None for b in bad]
