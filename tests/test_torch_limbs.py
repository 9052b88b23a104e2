"""Differential tests: the port's torch limb arithmetic
(:mod:`cpzk_tpu_torch.ops.limbs`) against the JAX package's
(:mod:`cpzk_tpu.ops.limbs`, eager on the CPU backend).

Same algorithm, same carry schedule: outputs must match limb for limb
(tolerance: exact), and agree with the integer-exact host field."""

import numpy as np
import pytest
import torch

from cpzk_tpu.core import field as hf
from cpzk_tpu.ops import limbs as jl
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.ops import limbs as tl

N = 16
BOUND = 9500
# loose-limb extremes of tests/test_ops_limbs.py::test_loose_limb_bounds_adversarial
ADVERSARIAL = np.stack([
    np.full(20, BOUND, dtype=np.int32),
    np.full(20, -BOUND, dtype=np.int32),
    np.asarray([BOUND if i % 2 else -BOUND for i in range(20)], dtype=np.int32),
    np.asarray([-BOUND] + [BOUND] * 19, dtype=np.int32),
], axis=-1)


def field_values(rng, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % hf.P for _ in range(n - 4)]
    return vals + [0, 1, hf.P - 1, hf.P - 19]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    a = field_values(rng, N)
    b = field_values(rng, N)[::-1]
    la, lb = jl.ints_to_limbs(a), jl.ints_to_limbs(b)
    return a, b, la, lb


def same(jax_out, torch_out):
    assert torch_out.dtype in (torch.int32, torch.bool)
    np.testing.assert_array_equal(np.asarray(jax_out), convert.to_numpy(torch_out))


def canon_ints(t):
    return [v % hf.P for v in tl.limbs_to_ints(t)]


BINARY = {
    "mul": (hf.fmul, jl.mul, tl.mul),
    "add": (hf.fadd, jl.add, tl.add),
    "sub": (hf.fsub, jl.sub, tl.sub),
}


@pytest.mark.parametrize("op", sorted(BINARY))
def test_binary_ops_match_jax(inputs, op):
    a, b, la, lb = inputs
    host, jf, tf = BINARY[op]
    out = tf(convert.tensor(la, "cpu"), convert.tensor(lb, "cpu"))
    same(jf(la, lb), out)
    assert canon_ints(out) == [host(x, y) for x, y in zip(a, b)]


UNARY = {
    "square": (lambda x: x * x % hf.P, jl.square, tl.square),
    "canonical": (lambda x: x, jl.canonical, tl.canonical),
    "inv": (lambda x: hf.finv(x) if x else 0, jl.inv, tl.inv),
    "mul_small_121": (lambda x: 121 * x % hf.P,
                      lambda x: jl.mul_small(x, 121), lambda x: tl.mul_small(x, 121)),
    "mul_small_neg2": (lambda x: -2 * x % hf.P,
                       lambda x: jl.mul_small(x, -2), lambda x: tl.mul_small(x, -2)),
}


@pytest.mark.parametrize("op", sorted(UNARY))
def test_unary_ops_match_jax(inputs, op):
    a, _, la, _ = inputs
    host, jf, tf = UNARY[op]
    out = tf(convert.tensor(la, "cpu"))
    same(jf(la), out)
    assert canon_ints(out) == [host(x) for x in a]


def test_predicates_match_jax(inputs):
    a, b, la, lb = inputs
    ta, tb = convert.tensor(la, "cpu"), convert.tensor(lb, "cpu")
    same(jl.eq(la, lb), tl.eq(ta, tb))
    same(jl.eq(la, la), tl.eq(ta, ta))
    same(jl.is_zero(la), tl.is_zero(ta))
    assert tl.eq(ta, ta).all()
    assert list(tl.is_zero(ta).numpy()) == [x == 0 for x in a]


def test_sqrt_ratio_m1_matches_jax(inputs):
    a, b, la, lb = inputs
    # (0, 0) -> (True, 0) and (u != 0, 0) -> (False, 0) ride along
    u = jl.ints_to_limbs(a + [0, 5])
    v = jl.ints_to_limbs(b + [0, 0])
    jok, jr = jl.sqrt_ratio_m1(u, v)
    tok, tr = tl.sqrt_ratio_m1(convert.tensor(u, "cpu"), convert.tensor(v, "cpu"))
    same(jok, tok)
    same(jr, tr)
    expect = [hf.sqrt_ratio_m1(x, y) for x, y in zip(a + [0, 5], b + [0, 0])]
    assert list(tok.numpy()) == [ok for ok, _ in expect]
    assert canon_ints(tr) == [r for _, r in expect]


def test_bytes_roundtrip_matches_jax(inputs):
    a, _, la, _ = inputs
    jb = jl.to_bytes_le(la)
    tb = tl.to_bytes_le(convert.tensor(la, "cpu"))
    same(jb, tb)
    enc = tb.numpy()
    assert [bytes(enc[:, j].astype(np.uint8)) for j in range(N)] == [hf.fe_to_bytes(x) for x in a]
    same(jl.from_bytes_le(np.asarray(jb)), tl.from_bytes_le(tb))


def test_adversarial_loose_limbs_match_jax():
    """The +-9500 extremes through mul/add/sub/square: limb-exact against
    JAX, value-exact against big ints, outputs within the loose bound."""
    la = ADVERSARIAL
    rev = la[:, ::-1].copy()
    ta, trev = convert.tensor(la, "cpu"), convert.tensor(rev, "cpu")
    vals = [jl.limbs_to_int(la[:, j]) for j in range(4)]
    cases = [
        (jl.mul(la, la), tl.mul(ta, ta), [v * v for v in vals]),
        (jl.mul(la, rev), tl.mul(ta, trev), [v * w for v, w in zip(vals, vals[::-1])]),
        (jl.add(la, la), tl.add(ta, ta), [2 * v for v in vals]),
        (jl.sub(la, rev), tl.sub(ta, trev), [v - w for v, w in zip(vals, vals[::-1])]),
        (jl.square(jl.add(la, rev)), tl.square(tl.add(ta, trev)),
         [(v + w) ** 2 for v, w in zip(vals, vals[::-1])]),
    ]
    for jout, tout, expect in cases:
        same(jout, tout)
        assert canon_ints(tout) == [e % hf.P for e in expect]
        assert int(tout.abs().max()) <= BOUND


def test_int32_dtype_throughout(inputs):
    """Every op keeps int32 limbs (Tensor.sum would promote to int64 without
    an explicit dtype) and right shifts stay arithmetic on negative limbs."""
    _, _, la, lb = inputs
    ta, tb = convert.tensor(la, "cpu"), convert.tensor(lb, "cpu")
    adv = convert.tensor(ADVERSARIAL, "cpu")
    for out in (tl.mul(ta, tb), tl.add(ta, tb), tl.sub(ta, tb), tl.neg(ta),
                tl.mul_small(ta, 2), tl.canonical(adv), tl.mul(adv, adv),
                tl.carry_product(tl._raw_schoolbook(adv, adv, 20)),
                tl.from_bytes_le(tl.to_bytes_le(ta)), tl.to_bytes_le(ta)):
        assert out.dtype == torch.int32
    neg = torch.tensor([-1, -8192, -8193], dtype=torch.int32)
    assert (neg >> 13).tolist() == [-1, -1, -2]


def test_host_conversions_match_jax(inputs):
    a, _, la, _ = inputs
    np.testing.assert_array_equal(tl.ints_to_limbs(a), la)
    rows = np.stack([np.frombuffer(hf.fe_to_bytes(x), dtype=np.uint8) for x in a])
    np.testing.assert_array_equal(tl.bytes_to_limbs(rows), jl.bytes_to_limbs(rows))
    assert tl.limbs_to_ints(convert.tensor(la, "cpu")) == a


# -- CPZK_MUL: the matmulfold variant (twin of
# tests/test_ops_limbs.py::test_mul_variants_bit_exact) -----------------------

#: loose carried-form extremes with mixed-sign halves: low half +bound,
#: high half -bound (the shape that overflowed the reference's removed
#: Karatsuba variant), and the reverse
MIXED_A = np.concatenate([np.full((10, 3), BOUND), np.full((10, 3), -BOUND)]).astype(np.int32)
MIXED_B = np.concatenate([np.full((10, 3), -BOUND), np.full((10, 3), BOUND)]).astype(np.int32)


@pytest.mark.parametrize("variant", ["schoolbook", "matmulfold"])
def test_mul_variants_match_jax(inputs, variant, monkeypatch):
    """Under each ``CPZK_MUL`` variant the port's ``mul`` equals the JAX
    package's under the same variant limb for limb (exact), on field
    values, on the loose-limb extremes and on mixed-sign halves at the
    bound, and both variants give the host field's products."""
    monkeypatch.setattr(jl, "MUL_VARIANT", variant)
    monkeypatch.setattr(tl, "MUL_VARIANT", variant)
    a, b, la, lb = inputs
    got = tl.mul(convert.tensor(la, "cpu"), convert.tensor(lb, "cpu"))
    same(jl.mul(la, lb), got)
    assert canon_ints(got) == [hf.fmul(x, y) for x, y in zip(a, b)]
    for xa, xb in ((ADVERSARIAL, ADVERSARIAL[:, ::-1].copy()), (MIXED_A, MIXED_B),
                   (MIXED_B, MIXED_A)):
        got = tl.mul(convert.tensor(xa, "cpu"), convert.tensor(xb, "cpu"))
        same(jl.mul(xa, xb), got)
        want = [jl.limbs_to_int(xa[:, i]) * jl.limbs_to_int(xb[:, i]) % hf.P
                for i in range(xa.shape[1])]
        assert canon_ints(got) == want


def test_matmulfold_product_matches_jax(inputs):
    """The uncarried 39-limb fold itself is the JAX package's, and equals
    the schoolbook anti-diagonal sums (int32 on the CPU)."""
    _, _, la, lb = inputs
    for xa, xb in ((la, lb), (MIXED_A, MIXED_B)):
        ta, tb = convert.tensor(xa, "cpu"), convert.tensor(xb, "cpu")
        fold = tl._mul_matmulfold(ta, tb)
        assert fold.dtype == torch.int32 and fold.shape == (39,) + tuple(xa.shape[1:])
        same(jl._mul_matmulfold(xa, xb), fold)
        assert torch.equal(fold, tl._raw_schoolbook(ta, tb, 20))


@pytest.mark.parametrize("value,ok", [("matmulfold", True), ("karatsuba", False)])
def test_cpzk_mul_is_read_at_import(value, ok):
    """``CPZK_MUL`` picks the variant when the module is imported; an
    unknown value is refused with the reference's ``ValueError``."""
    import os
    import subprocess
    import sys

    done = subprocess.run(
        [sys.executable, "-c",
         "from cpzk_tpu_torch.ops import limbs; print(limbs.MUL_VARIANT)"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CPZK_MUL=value))
    if ok:
        assert done.returncode == 0, done.stderr
        assert done.stdout.strip() == value
    else:
        assert done.returncode != 0
        assert ("ValueError: CPZK_MUL='karatsuba' is not one of ('schoolbook', "
                "'matmulfold') — refusing to silently benchmark the default under a "
                "mislabeled name") in done.stderr
