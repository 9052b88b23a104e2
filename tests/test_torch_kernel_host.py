"""The CUDA kernels' field and point arithmetic (``csrc/fe25519_w32.cuh``,
``__host__ __device__``) compiled for the host with g++ through the
test-only ``csrc/host_shim.cpp``, held against the plain PyTorch versions
on random limbs, the +-9500 adversarial patterns and edge values (0, p - 1,
values >= p and above 2^256, negative values).  The kernels compute in
8 x 32-bit words, their own radix, so outputs must equal the plain
versions' after ``limbs.canonical`` (tolerance: exact) and every output
limb must lie within ``limbs.BOUND``.  Skips where g++ is missing."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cpzk_tpu_torch.ops import limbs, point_kernels as pk

N = 96
BOUND = limbs.BOUND
P = limbs.P

#: values the word representation treats specially: 0 and p - 1, p and its
#: multiples, the 2^255 and 2^256 boundaries (the folds by 19 and 38), the
#: largest 260-bit value, and negatives
EDGE_VALUES = [
    0, 1, 2, 19, 37, 38, P - 1, P, P + 1, 2 * P - 1, 2 * P,
    2**255 - 1, 2**255, 2**255 + 18, 2**256 - 39, 2**256 - 38, 2**256 - 1,
    2**256, 2**256 + 37, 2**259, 2**260 - 1,
    -1, -19, -38, -P, -(2**256 - 1), -(2**260 - 1),
]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: cannot build the host copy of fe25519_w32.cuh")
    out = tmp_path_factory.mktemp("fe25519") / "libfe25519_host.so"
    src = pk.CSRC / "host_shim.cpp"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", str(src), "-o", str(out)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    P_, I = ctypes.c_void_p, ctypes.c_int
    lib.host_d2.argtypes = [P_]
    lib.host_to_words.argtypes = [P_, P_, I]
    lib.host_fe_op.argtypes = [I, P_, P_, P_, I]
    lib.host_point_add.argtypes = [P_] * 12 + [I]
    lib.host_point_double_k.argtypes = [P_] * 7 + [I, I]
    for fn in (lib.host_d2, lib.host_to_words, lib.host_fe_op, lib.host_point_add,
               lib.host_point_double_k):
        fn.restype = None
    return lib


def value_limbs(v: int) -> np.ndarray:
    """[20] int32 limbs of v, |v| < 2^260: digits in [0, 2^13) for v >= 0,
    their negation for v < 0."""
    return limbs.int_to_limbs(v) if v >= 0 else -limbs.int_to_limbs(-v)


def limb_inputs(seed, count):
    """count [20, N] int32 tensors: uniform in [-9500, 9500], with the four
    adversarial patterns of tests/test_ops_limbs.py in the first lanes and
    the edge values in the next ones (rolled between tensors, so the edge
    values meet each other)."""
    rng = np.random.default_rng(seed)
    adv = np.stack([
        np.full(20, BOUND), np.full(20, -BOUND),
        np.asarray([BOUND if i % 2 else -BOUND for i in range(20)]),
        np.asarray([-BOUND] + [BOUND] * 19),
    ], axis=-1).astype(np.int32)
    edge = np.stack([value_limbs(v) for v in EDGE_VALUES], axis=-1).astype(np.int32)
    out = []
    for k in range(count):
        a = rng.integers(-BOUND, BOUND + 1, size=(20, N)).astype(np.int32)
        a[:, :4] = np.roll(adv, k, axis=1)
        a[:, 4:4 + edge.shape[1]] = np.roll(edge, 3 * k, axis=1)
        out.append(torch.from_numpy(a))
    return out


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def empty(n=N):
    return torch.empty((20, n), dtype=torch.int32)


def assert_canonical_equal(out, ref):
    assert torch.equal(limbs.canonical(out), limbs.canonical(ref))
    assert int(out.abs().max()) <= BOUND


def fe_op(lib, code, a, b=None):
    out = empty(a.shape[1])
    lib.host_fe_op(code, ptr(a), ptr(a if b is None else b), ptr(out), a.shape[1])
    return out


def test_d2_constant_matches(host_lib):
    d2 = empty(1)
    host_lib.host_d2(ptr(d2))
    assert_canonical_equal(d2, limbs.D2)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "mul_small"])
def test_field_ops_match_plain(host_lib, op):
    a, b = limb_inputs(1, 2)
    code, plain = {
        "mul": (0, lambda: limbs.mul(a, b)),
        "add": (1, lambda: limbs.add(a, b)),
        "sub": (2, lambda: limbs.sub(a, b)),
        "mul_small": (3, lambda: limbs.mul_small(a, 2)),
    }[op]
    assert_canonical_equal(fe_op(host_lib, code, a, b), plain())


def test_square_matches_mul(host_lib):
    a, = limb_inputs(4, 1)
    sq = fe_op(host_lib, 4, a)
    # the same 512-bit product and the same fold: equal word for word
    assert torch.equal(sq, fe_op(host_lib, 0, a, a))
    assert_canonical_equal(sq, limbs.square(a))


def test_sub_where_b_exceeds_a(host_lib):
    """a below b as integers, so the word chain borrows out of word 7; a = 0
    against b = 2^256 - 1 borrows twice."""
    small = [0, 1, 5, 37, 0, P - 1]
    large = [2**256 - 1, P - 1, 2**255, 2**256 - 38, 2**260 - 1, 2**256 - 1]
    a = torch.from_numpy(np.stack([value_limbs(v) for v in small], axis=-1))
    b = torch.from_numpy(np.stack([value_limbs(v) for v in large], axis=-1))
    out = fe_op(host_lib, 2, a, b)
    assert_canonical_equal(out, limbs.sub(a, b))
    got = [v % P for v in limbs.limbs_to_ints(out)]
    assert got == [(x - y) % P for x, y in zip(small, large)]


def test_conversion_round_trip(host_lib):
    """limbs -> words -> limbs: the words hold a value in [0, 2^256)
    congruent to the limbs' (equal to it where that is already in range),
    and the limbs that come back are digits in [0, 2^13) of that value."""
    a, = limb_inputs(5, 1)
    words = np.empty((8, N), dtype=np.uint32)
    host_lib.host_to_words(ptr(a), ctypes.c_void_p(words.ctypes.data), N)
    values = [sum(int(w) << (32 * i) for i, w in enumerate(col)) for col in words.T]
    for j, v in enumerate(values):
        src = limbs.limbs_to_int(a[:, j].numpy())
        assert v % P == src % P
        if 0 <= src < 2**256:
            assert v == src
    back = fe_op(host_lib, 5, a)
    assert limbs.limbs_to_ints(back) == values
    assert int(back.min()) >= 0 and int(back.max()) <= limbs.LIMB_MASK
    assert_canonical_equal(back, a)


def test_point_add_matches_plain(host_lib):
    coords = limb_inputs(2, 8)
    outs = [empty() for _ in range(4)]
    host_lib.host_point_add(*(ptr(c) for c in coords + outs), N)
    ref = pk.point_add_plain(tuple(coords[:4]), tuple(coords[4:]))
    for o, r in zip(outs, ref):
        assert_canonical_equal(o, r)


@pytest.mark.parametrize("k", [1, 4])
def test_point_double_k_matches_plain(host_lib, k):
    coords = limb_inputs(3, 3)
    outs = [empty() for _ in range(4)]
    host_lib.host_point_double_k(*(ptr(c) for c in coords + outs), N, k)
    ref = pk.point_double_k_plain(tuple(coords) + (coords[0],), k)
    for o, r in zip(outs, ref):
        assert_canonical_equal(o, r)
