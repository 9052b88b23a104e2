"""The CUDA kernels' field and point arithmetic (``csrc/fe25519_w32.cuh``,
``__host__ __device__``) compiled for the host with g++ through the
test-only ``csrc/host_shim.cpp``, held against the plain PyTorch versions
on random limbs, the +-9500 adversarial patterns and edge values (0, p - 1,
values >= p and above 2^256, negative values).  The kernels compute in
8 x 32-bit words, their own radix, so outputs must equal the plain
versions' after ``limbs.canonical`` (tolerance: exact) and every output
limb must lie within ``limbs.BOUND``.

The same build holds the scalar arithmetic mod l (``csrc/sc25519_w32.cuh``)
against :mod:`cpzk_tpu_torch.ops.sclimbs` limb for limb (both canonical;
tolerance: exact) at random scalars and 0, 1, l - 1, and the Pippenger
thread bodies (``csrc/msm_w32.cuh``), run over every (window, bucket) the
top bucket |d| = 2^(c-1) included, against :mod:`cpzk_tpu_torch.ops.msm`'s
plain version as group elements (equal encodings: the order of the adds
differs).

The batch prover's headers too: ``csrc/ristretto_w32.cuh`` (canonical form,
sign, a^((p-5)/8), SQRT_RATIO_M1 with its non-square case, and ENCODE of the
identity, of points on both branches of the rotation by sqrt(-1) and of
coordinates at or above p) against :mod:`cpzk_tpu_torch.ops.limbs` and
``curve.encode`` (canonical limbs exact, bytes identical);
``csrc/prove_w32.cuh``'s phases of ``comb_tables_kernel`` (the quad's
chain of window bases, the entries level by level, one inversion a window)
over every thread against ``prove_kernels.table_words`` of the plain tables
(words identical, G and H), ``commitments_kernel``'s thread body (signed
recode, constant-time select, mixed add, ENCODE) against the plain
commitments and the host core's comb (bytes identical, scalars at or
above 2^255 too), and its recode (65 digits in [-8, 8] summing to the
scalar); and ``csrc/keccak_u64.cuh``'s absorb chain of
``keccak_chain_kernel``, both threads of a row's pair at once, against the
plain int32-pair Keccak (words identical; 1, 17, 33 and 4097 rows, a
shared and a per-row state, k = 0, 1, 3, 5); ``reduce_wide``'s lane body
(the fold at bit 252) on 40 and 24 limbs, edge values and every bit
length, against ``reduce_wide_plain`` limb for limb; ``ristretto_decode``'s
lane body (``csrc/decode_w32.cuh``, its products in radix 2^25.5) on
``chip_smoke.py``'s decode inputs against the plain and the JAX
``curve.decode``, the host core's ``batch_decode`` and the pure decode
(validity equal, canonical words exact), and that radix's products, power
and conversions against :mod:`cpzk_tpu_torch.ops.limbs`; and ``scalar_recode``'s whole thread body (``csrc/recode_w32.cuh``,
four lanes a thread) over every thread of a call against
``rlc_windows_plain`` and ``rlc_digits_plain`` (exact).

And the per-row ladders' thread bodies (``csrc/ladder_w32.cuh``), the code
``ladder_combined``, ``ladder_partials_identity`` and ``ladder_each`` run
on the card, sequenced by the shim's ``host_ladder_*`` functions over
every block and quad of threads in the kernels' order: the quad's cached
add against one thread's (words identical), the table build, one ladder
step and a lane's whole ladder against :mod:`cpzk_tpu_torch.ops.verify`'s plain composition
(coordinates equal after canonicalization: the cached adds run the plain
adds' formulas on the same values mod p), the identity test against
``curve.is_identity`` on non-canonical coordinates, and the kernels' whole
bodies (the lane sum of blocks and of the last block, at block sizes that
leave blocks partly empty and more blocks than threads): chunk totals
equal as group elements (``curve.eq``), identity tests and per-row bits
exact, tampered rows and per-lane generators included; ``ladder_partials_identity``
over 1 to 92 totals.  And ``rlc_scalars``' bodies (``csrc/sc25519_w32.cuh``:
a row's two halves, the unreduced 9-word sum, the last block's reduction),
sequenced by ``host_rlc_scalars`` over every block, the warps' shuffle
levels and the last block, against ``rlc_scalars_plain`` limb for limb.
Skips where g++ is missing."""

import ctypes
import random

import numpy as np
import pytest
import torch

from cpzk_tpu_torch.bench_kernels import rlc_case, wide_edges
from cpzk_tpu_torch.core import edwards as he
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.ops import curve, limbs, msm, point_kernels as pk, sclimbs as sc
from cpzk_tpu_torch.ops import decode_kernels as dk
from cpzk_tpu_torch.ops import keccak, keccak_kernels as kk, prove_kernels as pvk
from cpzk_tpu_torch.ops import scalar_kernels as sk, verify
import torch_host_shim
from torch_ladder_inputs import combined_inputs, each_inputs, make_rows, partial_totals, weights

N = 96
BOUND = limbs.BOUND
P = limbs.P


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module: its plain point and scalar
    arithmetic runs many small tensor ops, and a full thread team each,
    beside the test suite's other workers, oversubscribes the host's
    cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

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
    return torch_host_shim.build(tmp_path_factory)


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


# -- scalars mod l (sc25519_w32.cuh) ----------------------------------------

SC_EDGES = [0, 1, 2, L - 1, L - 2, L // 2, 2**252, 2**252 - 1, 2**32 - 1, 2**224]


def sc_inputs(seed, count, n=64):
    """count [20, n] canonical scalar limb tensors: random below l, the edge
    values in the first lanes (rolled between tensors)."""
    rng = random.Random(seed)
    out = []
    for k in range(count):
        vals = [rng.randrange(L) for _ in range(n)]
        vals[:len(SC_EDGES)] = SC_EDGES[k:] + SC_EDGES[:k]
        out.append(torch.from_numpy(sc.ints_to_limbs(vals)))
    return out


def sc_op(lib, code, a, b=None):
    out = empty(a.shape[1])
    lib.host_sc_op(code, ptr(a), ptr(a if b is None else b), ptr(out), a.shape[1])
    return out


@pytest.mark.parametrize("op", ["mul", "add", "neg", "round_trip"])
def test_scalar_ops_match_plain(host_lib, op):
    a, b = sc_inputs(11, 2)
    code, plain = {
        "mul": (0, lambda: sc.mul(a, b)),
        "add": (1, lambda: sc.add(a, b)),
        "neg": (2, lambda: sc.neg(a)),
        "round_trip": (3, lambda: a),
    }[op]
    assert torch.equal(sc_op(host_lib, code, a, b), plain())


def test_scalar_wide_reduction_matches_plain(host_lib):
    rng = np.random.default_rng(12)
    blobs = rng.integers(0, 256, size=(40, 64), dtype=np.uint8)
    blobs[0] = 0xFF   # the largest 512-bit value
    blobs[1] = 0      # zero
    wide = torch.from_numpy(sc.bytes_wide_to_limbs(blobs))
    out = empty(40)
    host_lib.host_reduce_wide(ptr(wide), 40, ptr(out), 40)
    assert torch.equal(out, sc.reduce_wide(wide))
    assert sc.limbs_to_ints(out) == [int.from_bytes(b.tobytes(), "little") % L for b in blobs]


@pytest.mark.parametrize("c", [4, 11, 13, 16])
def test_scalar_recodes_match_plain(host_lib, c):
    a, = sc_inputs(13, 1)
    n = a.shape[1]
    wins = torch.empty((64, n), dtype=torch.int32)
    host_lib.host_sc_windows(ptr(a), ptr(wins), n)
    assert torch.equal(wins, sc.to_windows(a))
    nwin = msm.num_windows(c)
    digits = torch.empty((nwin, n), dtype=torch.int32)
    host_lib.host_sc_signed_digits(ptr(a), c, nwin, ptr(digits), n)
    assert torch.equal(digits, sc.to_signed_digits(a, c))


# -- scalar_recode's whole thread body (recode_w32.cuh) ----------------------

#: the scalars every recode case leads with (rolled between the groups)
RECODE_EDGES = [0, 1, L - 1, 2**253 - 1]


def recode_operands(seed, pad):
    """Four [20, pad] groups of random scalars below l led by
    :data:`RECODE_EDGES`, and the corrections l - 1 and 2^253 - 1."""
    rng = random.Random(seed)
    groups = []
    for g in range(4):
        vals = [rng.randrange(L) for _ in range(pad)]
        vals[:min(pad, 4)] = (RECODE_EDGES[g:] + RECODE_EDGES[:g])[:min(pad, 4)]
        groups.append(torch.from_numpy(sc.ints_to_limbs(vals)))
    corr = [torch.from_numpy(sc.ints_to_limbs([v])) for v in (L - 1, 2**253 - 1)]
    return groups, corr


def host_recode(lib, groups, corr, n, mode, c, nwin, m, shape):
    """``host_scalar_recode``: every thread of a ``scalar_recode`` call."""
    out = torch.full(shape, -(2**31), dtype=torch.int32)
    lib.host_scalar_recode(*(ptr(g) for g in groups), *(ptr(x) for x in corr), n,
                           groups[0].shape[1], mode, c, nwin, m, ptr(out))
    return out


@pytest.mark.parametrize("n,pad", [(1, 2), (5, 6), (5, 8), (126, 127), (127, 128), (127, 130)])
def test_scalar_recode_windows_thread_matches_plain(host_lib, n, pad):
    """``scalar_recode_kernel``'s thread body in mode 0 over every thread:
    the four groups' windows with lane n spliced (corr0, corr1, 0, 0) equal
    ``rlc_windows_plain``'s; the splice at the last lane (n = pad - 1) and
    lane counts that are not a multiple of a thread's four lanes."""
    groups, corr = recode_operands(n + pad, pad)
    got = host_recode(host_lib, groups, corr, n, 0, 4, 64, 0, (4, 64, pad))
    assert torch.equal(got, sk.rlc_windows_plain(groups, *corr, n))


@pytest.mark.parametrize("c", [4, 11, 13, 16])
@pytest.mark.parametrize("zeros", [0, 3])
@pytest.mark.parametrize("n", [1, 5, 127])
def test_scalar_recode_digits_thread_matches_plain(host_lib, n, zeros, c):
    """``scalar_recode_kernel``'s thread body in mode 1 over every thread:
    the digits of a | a c | b a | b a c | corr0 | corr1 | zeros (m - 4 n - 2
    zero terms) equal ``rlc_digits_plain``'s, for a run of terms that
    crosses a group's end inside a thread (n = 1, 5, 127) and a ragged m."""
    pad = 1 << (n - 1).bit_length()
    groups, corr = recode_operands(7 * n + c, pad)
    m, nwin = 4 * n + 2 + zeros, msm.num_windows(c)
    got = host_recode(host_lib, groups, corr, n, 1, c, nwin, m, (nwin, m))
    assert torch.equal(got, sk.rlc_digits_plain(groups, *corr, n, m, c))


# -- the Pippenger thread bodies (msm_w32.cuh) -------------------------------

def msm_inputs(seed, m, c):
    """m random valid points (one the identity) and [K, m] digits from
    random scalars with 0, 1 and l - 1 among them; window 1's digits set to
    +-2^(c-1) (the top bucket), window 2's all equal (one crowded bucket),
    and the last window's non-zero, of both signs (scalars below l leave it
    nearly empty, and the reduction must count it too)."""
    rng = random.Random(seed)
    pts = [he.pt_scalar_mul(he.BASEPOINT, rng.randrange(L)) for _ in range(m - 1)]
    pts.append(he.IDENTITY)
    scalars = [rng.randrange(L) for _ in range(m - 3)] + [0, 1, L - 1]
    digits = msm.scalars_to_signed_digits(scalars, c)
    half = 1 << (c - 1)
    digits[1] = [half if i % 3 else -half for i in range(m)]
    digits[2] = min(3, half)
    digits[-1] = [(1 + i % half) * (1 if i % 2 else -1) for i in range(m)]
    return curve.points_to_device(pts, "cpu"), torch.from_numpy(digits)


def group_equal(p, q):
    return torch.equal(curve.encode(p), curve.encode(q))


def host_bucket_sums(lib, points, digits, c, threads, parts):
    """msm_bucket's two kernels run by the host driver: [20, K, 2^(c-1)]."""
    k, m = digits.shape
    nb = 1 << (c - 1)
    outs = [empty(k * nb) for _ in range(4)]
    lib.host_msm_bucket(*(ptr(p) for p in points), ptr(digits.contiguous()),
                        *(ptr(o) for o in outs), m, k, c, threads, parts)
    return tuple(o.reshape(20, k, nb) for o in outs)


def host_window_reduce(lib, buckets, c, segments, quads):
    """msm_window_reduce's two kernels run by the host driver: [20, 1]."""
    k = buckets[0].shape[1]
    outs = [empty(1) for _ in range(4)]
    flat = [b.reshape(20, -1).contiguous() for b in buckets]
    lib.host_msm_window_reduce(*(ptr(b) for b in flat), *(ptr(o) for o in outs),
                               k, c, segments, quads)
    return tuple(outs)


def oracle_msm(points, digits, c):
    """sum_i (sum_w d_wi 2^(c w)) P_i on the host oracle."""
    want = he.IDENTITY
    for j, p in enumerate(curve.points_from_device(points)):
        s = sum(int(digits[w, j]) << (c * w) for w in range(digits.shape[0]))
        want = he.pt_add(want, he.pt_scalar_mul(p, s % L))
    return want


def assert_oracle_equal(point, want):
    got = tuple(v % he.P for v in curve.points_from_device(point)[0])
    assert he.pt_eq(got, want)


@pytest.mark.parametrize("c,m,threads,parts,digits_kind", [
    (4, 12, 4, 2, "mixed"),
    (5, 12, 32, 2, "mixed"),          # runs of one entry (and empty runs)
    (5, 40, 1, 1, "mixed"),           # one run across every bucket of a window
    (4, 24, 4, 3, "one_bucket"),      # one bucket across every run and block
    (2, 10, 4, 2, "mixed"),           # the smallest window
], ids=["mixed", "run_of_one", "run_across_buckets", "bucket_across_runs", "c2"])
def test_msm_bucket_body_matches_plain(host_lib, c, m, threads, parts, digits_kind):
    """msm_bucket's sort, runs and joins over every block and thread (the
    top bucket and a crowded one included) against the plain bucket sums."""
    points, digits = msm_inputs(14 + c + m, m, c)
    if digits_kind == "one_bucket":
        digits = torch.tensor([[5 if i % 2 else -5 for i in range(m)]] * digits.shape[0],
                              dtype=torch.int32)
    got = host_bucket_sums(host_lib, points, digits, c, threads, parts)
    ref = msm.bucket_sums_plain(points, digits, c)
    assert group_equal(got, ref)
    nb = 1 << (c - 1)
    if digits_kind == "mixed":
        # the top bucket of window 1 holds every term, signs applied
        assert not bool(curve.is_identity(tuple(g[:, 1, nb - 1:] for g in got)))


def test_msm_bucket_body_matches_oracle_at_c16(host_lib):
    """c = 16 (32,768 buckets a window) on two windows: the non-empty
    buckets against sums on the host oracle, every other bucket exactly
    the identity's limbs (0, 1, 1, 0)."""
    c, m = 16, 6
    points, _ = msm_inputs(61, m, c)
    half = 1 << (c - 1)
    digits = torch.tensor([[half, -half, 1, -1, 12345, 0],
                           [7, 7, -7, half - 1, 0, -half]], dtype=torch.int32)
    got = host_bucket_sums(host_lib, points, digits, c, 4, 2)
    host_pts = curve.points_from_device(points)
    filled = set()
    for w in range(2):
        for b in {abs(int(d)) for d in digits[w]} - {0}:
            want = he.IDENTITY
            for i in range(m):
                d = int(digits[w, i])
                if abs(d) == b:
                    want = he.pt_add(want, host_pts[i] if d > 0 else he.pt_neg(host_pts[i]))
            assert_oracle_equal(tuple(g[:, w, b - 1:b] for g in got), want)
            filled.add((w, b - 1))
    ident = [0, 1, 1, 0]
    for q, g in enumerate(got):
        mask = torch.ones(g.shape[1:], dtype=torch.bool)
        for w, j in filled:
            mask[w, j] = False
        rest = g[:, mask]
        assert int(rest[0].ne(ident[q]).sum()) == 0 and int(rest[1:].abs().sum()) == 0


@pytest.mark.parametrize("c,segments,quads", [
    (4, 8, 64),      # the card's shapes at c = 4: two windows on some quads
    (4, 1, 5),       # one segment a window; Horner with stride 5 on each quad
    (5, 4, 52),
    (2, 2, 64),      # the smallest window: 128 windows on 64 quads
    (11, 64, 24),    # the main path's c = 11 with the card's segments and quads
])
def test_msm_window_reduce_body_matches_plain(host_lib, c, segments, quads):
    """msm_window_reduce's window totals (segments, suffix scan, tree sum)
    and its quads' scaled windows and tree sum, on the plain bucket sums,
    against the plain window reduction and the host oracle."""
    m = 10
    points, digits = msm_inputs(20 + c + segments, m, c)
    buckets = msm.bucket_sums_plain(points, digits, c)
    got = host_window_reduce(host_lib, buckets, c, segments, quads)
    assert group_equal(got, msm.window_reduce_plain(buckets, c))
    assert_oracle_equal(got, oracle_msm(points, digits, c))


def test_msm_window_reduce_body_matches_oracle_at_c16(host_lib):
    """c = 16 on two windows, from msm_bucket's host run: 64 segments of
    512 buckets, against the host oracle."""
    c, m = 16, 5
    points, _ = msm_inputs(62, m, c)
    half = 1 << (c - 1)
    digits = torch.tensor([[half, -3, 3, 999, -half + 1], [1, half, -half, 0, 2]],
                          dtype=torch.int32)
    buckets = host_bucket_sums(host_lib, points, digits, c, 4, 2)
    assert_oracle_equal(host_window_reduce(host_lib, buckets, c, 64, 2),
                        oracle_msm(points, digits, c))


@pytest.mark.parametrize("k", [1, 5])
def test_quad_double_k_matches_plain(host_lib, k):
    """The quad doubling (four lanes, one square and one product each a
    round) against the plain k-fold doubling, on loose limbs."""
    a = limb_inputs(50 + k, 3)
    outs = [empty() for _ in range(4)]
    host_lib.host_quad_double_k(*(ptr(t) for t in a), *(ptr(o) for o in outs), N, k)
    ref = pk.point_double_k_plain((a[0], a[1], a[2], a[0]), k)
    for o, r in zip(outs, ref):
        assert_canonical_equal(o, r)


def test_quad_add_matches_plain(host_lib):
    """The quad add (four lanes, two products each and C in every lane)
    against the plain add, on loose limbs."""
    a = limb_inputs(57, 8)
    outs = [empty() for _ in range(4)]
    host_lib.host_quad_add(*(ptr(t) for t in a), *(ptr(o) for o in outs), N)
    ref = pk.point_add_plain(tuple(a[:4]), tuple(a[4:]))
    for o, r in zip(outs, ref):
        assert_canonical_equal(o, r)


@pytest.mark.parametrize("case", ["random", "identity"])
def test_quad_add_cached_matches_one_thread(host_lib, case):
    """The quad's cached add (one product a lane, a gather, E F G H in every
    lane, one product a lane, a gather) equals one thread's
    ``pt_add_cached_into`` word for word, on loose limbs (edge values among
    them) and with the identity as either operand (the first half of the
    lanes its second, the rest its first); both equal the plain add mod p."""
    a = limb_inputs(58, 8)
    p, q = tuple(a[:4]), tuple(a[4:])
    if case == "identity":
        ident = curve.identity((N,), "cpu")
        h = N // 2
        p = tuple(torch.cat([c[:, :h], i[:, h:]], dim=1).contiguous() for c, i in zip(p, ident))
        q = tuple(torch.cat([i[:, :h], c[:, h:]], dim=1).contiguous() for c, i in zip(q, ident))
    one = torch.empty((4, 8, N), dtype=torch.int32)
    quad = torch.empty((4, 8, N), dtype=torch.int32)
    host_lib.host_quad_add_cached(ptr_array(p), ptr_array(q), ptr(one), ptr(quad), N)
    assert torch.equal(one, quad)
    ref = pk.point_add_plain(p, q)
    words = quad.numpy().view(np.uint32).astype(object)
    for k in range(4):
        got = [sum(int(words[k, i, j]) << (32 * i) for i in range(8)) % P for j in range(N)]
        assert got == limbs.limbs_to_ints(limbs.canonical(ref[k]))


# -- ristretto encode (ristretto_w32.cuh) ------------------------------------

def test_canonical_sign_neg_abs_pow_match_plain(host_lib):
    """fe_canonical returns the representative below p (limbs identical to
    ``limbs.canonical``, the edge values p - 1, p, 2^255 - 1 and above
    included); the sign, negation, |a| and a^((p-5)/8) agree with the
    plain versions after canonicalization."""
    a, = limb_inputs(30, 1)
    assert torch.equal(fe_op(host_lib, 6, a), limbs.canonical(a))
    sign = torch.empty(N, dtype=torch.int32)
    host_lib.host_fe_is_negative(ptr(a), ptr(sign), N)
    assert torch.equal(sign.bool(), limbs.is_negative(a))
    assert_canonical_equal(fe_op(host_lib, 8, a), limbs.neg(a))
    assert_canonical_equal(fe_op(host_lib, 9, a), limbs.fabs(a))
    assert_canonical_equal(fe_op(host_lib, 7, a), limbs._pow_p58(a))


def test_sqrt_ratio_m1_matches_plain(host_lib):
    """Random (u, v) pairs (about half of u / v are non-squares), squares
    u = v w^2, u = 0, v = 0 and u = v = 0: root and was_square equal the
    plain version's."""
    u, v = limb_inputs(31, 2)
    rng = random.Random(31)
    w = [rng.randrange(P) for _ in range(8)]
    vs = [rng.randrange(1, P) for _ in range(8)]
    u[:, :8] = torch.from_numpy(limbs.ints_to_limbs([x * x * y % P for x, y in zip(w, vs)]))
    v[:, :8] = torch.from_numpy(limbs.ints_to_limbs(vs))
    u[:, 8] = 0
    v[:, 9] = 0
    u[:, 10] = 0
    v[:, 10] = 0
    r = empty()
    ok = torch.empty(N, dtype=torch.int32)
    host_lib.host_fe_sqrt_ratio_m1(ptr(u), ptr(v), ptr(r), ptr(ok), N)
    ref_ok, ref_r = limbs.sqrt_ratio_m1(u, v)
    assert torch.equal(ok.bool(), ref_ok)
    assert_canonical_equal(r, ref_r)
    assert bool(ok[:8].all()) and not bool(ok.all())  # both cases were met


def encode_points(seed, n):
    """n points: the identity, random multiples of the base point, and the
    same points in other projective representations (scaled by a random
    factor, and with coordinates lifted to value + p, at or above p)."""
    rng = random.Random(seed)
    pts = [he.IDENTITY] + [he.pt_scalar_mul(he.BASEPOINT, rng.randrange(L))
                           for _ in range(n // 2 - 1)]
    scaled = []
    for p in pts:
        lam = rng.randrange(1, P)
        scaled.append(tuple(c * lam % P for c in p))
    coords = [[int(c) for c in col] for col in zip(*(pts + scaled))]
    for col in coords:  # coordinates below 2^256 - p lifted by p
        for j in range(0, len(col), 3):
            if col[j] + P < 2**256:
                col[j] += P
    return tuple(torch.from_numpy(np.stack([value_limbs(v) for v in col], axis=-1))
                 for col in coords)


def test_encode_matches_plain(host_lib):
    pts = encode_points(32, 40)
    n = pts[0].shape[1]
    out = torch.empty((32, n), dtype=torch.uint8)
    host_lib.host_ristretto_encode(*(ptr(c) for c in pts), ptr(out), n)
    ref = curve.encode(pts)
    assert torch.equal(out.to(torch.int32), ref)
    assert not bool(out[:, 0].any())  # the identity: 32 zero bytes
    assert torch.equal(out[:, :n // 2], out[:, n // 2:])  # representation-free
    # both branches of the rotation by sqrt(-1) were taken
    X0, Y0, Z0, T0 = pts
    u1 = limbs.mul(limbs.add(Z0, Y0), limbs.sub(Z0, Y0))
    u2 = limbs.mul(X0, Y0)
    _, inv = limbs.sqrt_ratio_m1(limbs.on(limbs.ONE, "cpu"), limbs.mul(u1, limbs.square(u2)))
    z_inv = limbs.mul(limbs.mul(limbs.mul(inv, u1), limbs.mul(inv, u2)), T0)
    rotate = limbs.is_negative(limbs.mul(T0, z_inv))
    assert bool(rotate.any()) and not bool(rotate.all())


# -- ristretto decode (ristretto_w32.cuh, decode_ops.cu's thread body) ------

@pytest.fixture(scope="module")
def decode_inputs():
    """The ``decode`` phase's inputs of ``chip_smoke.py`` at 96 lanes: the
    rejected cases of tests/test_ristretto.py, p, p - 1, bit 255 set over a
    valid encoding, the identity, then corpus encodings and random bytes."""
    import pathlib
    import runpy

    smoke = runpy.run_path(str(pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"),
                           run_name="chip_smoke_inputs")
    _, corpus, _ = smoke["make_corpus"](4, smoke["SeededRng"](7))
    wires, kinds = smoke["decode_wires"](96, corpus, smoke["SeededRng"](8))
    return wires, kinds, smoke["host_decode_words"]


def test_decode_matches_plain_jax_and_host_core(host_lib, decode_inputs):
    """The kernel's lane body gives the plain ``curve.decode``'s validity
    and canonical words exactly, and the JAX package's ``curve.decode``
    (compared after canonicalization); valid lanes hold the host core's
    ``batch_decode`` points, invalid ones the identity; every listed case
    and every random row is decided as the reference's pure decode decides
    it."""
    import jax.numpy as jnp

    from cpzk_tpu.ops import curve as jax_curve

    wires, kinds, host_decode_words = decode_inputs
    n = wires.shape[0]
    words = torch.empty((4, 8, n), dtype=torch.int32)
    valid = torch.empty(n, dtype=torch.uint8)
    host_lib.host_ristretto_decode(ptr(torch.from_numpy(wires)), ptr(words), ptr(valid), n)
    plain_words, plain_valid = dk.ristretto_decode_plain(torch.from_numpy(wires))
    assert torch.equal(valid, plain_valid) and torch.equal(words, plain_words)
    point, jax_valid = jax_curve.decode(jnp.asarray(wires.T.astype(np.int32)))
    assert np.array_equal(np.asarray(jax_valid), valid.numpy().astype(bool))
    jax_words = dk.limbs_to_words(tuple(torch.from_numpy(np.asarray(c)) for c in point))
    assert torch.equal(jax_words, words)
    host_words, host_valid = host_decode_words(wires)
    ok = valid.bool()
    assert torch.equal(valid, host_valid) and torch.equal(words[..., ok], host_words[..., ok])
    identity = dk.limbs_to_words(tuple(torch.from_numpy(limbs.int_to_limbs(v)[:, None])
                                       for v in (0, 1, 1, 0)))
    assert torch.equal(words[..., ~ok], identity.expand(4, 8, int((~ok).sum())))
    for i, kind in enumerate(kinds):
        assert bool(ok[i]) == (he.ristretto_decode(wires[i].tobytes()) is not None), (i, kind)
        if kind != "random":
            assert bool(ok[i]) == (kind in ("corpus", "identity")), (i, kind)
    assert 0 < int(ok[[i for i, k in enumerate(kinds) if k == "random"]].sum()) < kinds.count(
        "random")  # random bytes met both verdicts


@pytest.fixture(scope="module")
def decode_refs(decode_inputs):
    """The 96 lanes' references: the plain ``curve.decode``'s words and
    validity, the JAX package's words and validity, the host core's, and
    the reference's pure decode's verdict a row.  ``decode_wires`` gives
    the same first rows at any n, so n lanes' references are their first
    n."""
    import jax.numpy as jnp

    from cpzk_tpu.ops import curve as jax_curve

    wires, kinds, host_decode_words = decode_inputs
    plain = dk.ristretto_decode_plain(torch.from_numpy(wires))
    point, jax_valid = jax_curve.decode(jnp.asarray(wires.T.astype(np.int32)))
    jax_words = dk.limbs_to_words(tuple(torch.from_numpy(np.array(c)) for c in point))
    pure = [he.ristretto_decode(w.tobytes()) is not None for w in wires]
    return (plain, (jax_words, torch.from_numpy(np.array(jax_valid)).to(torch.uint8)),
            host_decode_words(wires), pure)


@pytest.mark.parametrize("n", [1, 33, 96])
def test_decode_lane_body_matches_plain_jax_and_host_core(host_lib, decode_inputs, decode_refs,
                                                          n):
    """DECODE's lane body (``csrc/decode_w32.cuh``: the products in radix
    2^25.5) on ``chip_smoke.py``'s first n decode inputs (one wire, the
    seven listed cases and 26 more, all 96): words and validity exact
    against the plain and the JAX package's ``curve.decode`` (canonical
    words), the host core's ``batch_decode`` on valid lanes and the
    identity on invalid ones, and every row decided as the reference's
    pure decode decides it."""
    smoke_wires, kinds, _ = decode_inputs
    wires = torch.from_numpy(smoke_wires[:n].copy())
    words = torch.empty((4, 8, n), dtype=torch.int32)
    valid = torch.empty(n, dtype=torch.uint8)
    host_lib.host_ristretto_decode(ptr(wires), ptr(words), ptr(valid), n)
    (plain_words, plain_valid), (jax_words, jax_valid), (host_words, host_valid), pure = \
        decode_refs
    assert torch.equal(valid, plain_valid[:n]) and torch.equal(words, plain_words[..., :n])
    assert torch.equal(valid, jax_valid[:n]) and torch.equal(words, jax_words[..., :n])
    ok = valid.bool()
    assert torch.equal(valid, host_valid[:n])
    assert torch.equal(words[..., ok], host_words[..., :n][..., ok])
    identity = dk.limbs_to_words(tuple(torch.from_numpy(limbs.int_to_limbs(v)[:, None])
                                       for v in (0, 1, 1, 0)))
    assert torch.equal(words[..., ~ok], identity.expand(4, 8, int((~ok).sum())))
    assert [bool(v) for v in ok] == pure[:n]
    for i, kind in enumerate(kinds[:n]):
        if kind != "random":
            assert bool(ok[i]) == (kind in ("corpus", "identity")), (i, kind)


@pytest.mark.parametrize("op", ["mul", "square", "pow_p58", "round_trip", "mul_bound"])
def test_fe10_ops_match_plain(host_lib, op):
    """``decode_w32.cuh``'s radix-2^25.5 arithmetic through its word
    conversions, on the adversarial and edge limbs (2^256 - 1 among them:
    bit 255 set, every word all ones): products, squares, the
    a^((p-5)/8) chain and the round trip equal ``limbs.mul`` and
    ``limbs._pow_p58`` after canonicalization, and a product's limbs stay
    within the carry's bound (``mul_bound``: the shim zeroes a lane that
    leaves it)."""
    a, b = limb_inputs(31, 2)
    out = empty()
    code = {"mul": 0, "square": 1, "pow_p58": 2, "round_trip": 3, "mul_bound": 4}[op]
    host_lib.host_fe10_op(code, ptr(a), ptr(b), ptr(out), N)
    want = {"mul": lambda: limbs.mul(a, b), "square": lambda: limbs.mul(a, a),
            "pow_p58": lambda: limbs._pow_p58(a), "round_trip": lambda: a,
            "mul_bound": lambda: limbs.mul(a, b)}[op]()
    assert_canonical_equal(out, want)


# -- the batch prover's thread bodies (prove_w32.cuh) ------------------------

@pytest.fixture(scope="module")
def gen_tables():
    """G's and H's [20, 1] coordinates and plain comb tables, by name."""
    from cpzk_tpu_torch import Parameters

    params = Parameters.new()
    out = {}
    for name, elem in (("G", params.generator_g), ("H", params.generator_h)):
        p = curve.points_to_device([elem.point], "cpu")
        out[name] = (p, pvk.comb_tables_plain(p))
    return out


def host_table(lib, p):
    words = torch.empty(pvk.WORDS_SHAPE, dtype=torch.int32)
    lib.host_comb_tables(*(ptr(c) for c in p), ptr(words))
    return words


@pytest.mark.parametrize("gen", ["G", "H"])
def test_comb_window_matches_plain(host_lib, gen_tables, gen):
    """comb_tables_kernel's phases over every thread in the kernel's order
    (the bases on one quad, entries 2..8 by levels, one inversion a window)
    give exactly the words of ``table_words`` of the plain tables."""
    p, ref = gen_tables[gen]
    words = pvk.table_words(ref)
    assert words.shape == pvk.WORDS_SHAPE
    assert torch.equal(host_table(host_lib, p), words)
    # a table in the kernel's layout maps to itself
    assert torch.equal(pvk.table_words(words), words)
    # entry 0 is the identity (y - x, y + x, 2d x y) = (1, 1, 0)
    assert words[:, 0, :, 1:].eq(0).all() and words[:, 0, :2, 0].eq(1).all()
    assert words[:, 0, 2, 0].eq(0).all()


SCALAR_CASES = {
    "edges": [0, 1, L - 1, 2**252, 2**255 - 1, 2**253 - 1, 8 * (16**63 - 1) // 15],
    # top nibble 8 or more: the top window's digit over two steps
    "wide": [2**255, 2**256 - 1, 15 * 16**63, 2**255 + 8, 8 * 16**63 + 8 * 16**62,
             8 * (16**64 - 1) // 15],
    "random": None,
}


@pytest.mark.parametrize("case", sorted(SCALAR_CASES))
def test_commitments_lane_matches_plain(host_lib, gen_tables, case):
    """commitments_kernel's thread body (signed recode, 65 constant-time
    selects and mixed adds, then ENCODE), over every (lane, generator), on
    the host-built tables: bytes identical to the plain commitments and to
    the host core's constant-time comb (the edge scalars 0, 1, l - 1,
    2^252, 2^255 - 1 (top nibble 7), 2^253 - 1 and all-8 nibbles; scalars
    at or above 2^255, whose top window takes two steps; random ones)."""
    from cpzk_tpu_torch import Parameters, Ristretto255, Scalar

    (g, tg), (h, th) = gen_tables["G"], gen_tables["H"]
    params = Parameters.new()
    assert Ristretto255.element_to_bytes(params.generator_g) == bytes(
        curve.encode(g).to(torch.uint8)[:, 0].tolist())
    rng = random.Random(33)
    scalars = SCALAR_CASES[case] or [rng.randrange(L) for _ in range(9)]
    digits = torch.from_numpy(np.ascontiguousarray(curve.scalars_to_windows(scalars)[::-1]))
    n = len(scalars)
    r1, r2 = (torch.empty((32, n), dtype=torch.uint8) for _ in range(2))
    gw, hw = host_table(host_lib, g), host_table(host_lib, h)
    host_lib.host_commitments(ptr(gw), ptr(hw), ptr(digits), ptr(r1), ptr(r2), n)
    ref = pvk.commitments_plain(tg, th, digits)
    assert torch.equal(r1, ref[0]) and torch.equal(r2, ref[1])
    for j, k in enumerate(scalars):
        # the generators' order is l: k and k mod l give the same encoding
        y1, y2 = Ristretto255.double_base_mul(params.generator_g, params.generator_h,
                                              Scalar(k % L))
        assert bytes(r1[:, j].tolist()) == y1.wire()
        assert bytes(r2[:, j].tolist()) == y2.wire()


@pytest.mark.parametrize("seed,bits", [(0, 255), (1, 255), (2, 256)])
def test_comb_signed_recode(host_lib, seed, bits):
    """The walk's recode: from the 64 nibbles of scalars below 2^bits
    (random ones, and nibbles all 15 but the top 7, all 8, all 7, zero,
    all 15), 65 digits e_s in [-8, 8], below 8 under the top window, the
    top window's two in [0, 8], with sum_{s < 64} e_s 16^s + e_64 16^63
    the scalar."""
    rng = random.Random(60 + seed)
    scalars = [rng.randrange(2**bits) for _ in range(40)] + [
        2**255 - 1, 8 * (16**64 - 1) // 15 - 2**255, 7 * (16**64 - 1) // 15, 0, L - 1]
    if bits > 255:
        scalars += [2**256 - 1, 8 * (16**64 - 1) // 15, 2**255]
    digits = torch.from_numpy(np.ascontiguousarray(curve.scalars_to_windows(scalars)[::-1]))
    n = len(scalars)
    out = torch.empty((65, n), dtype=torch.int32)
    host_lib.host_comb_recode(ptr(digits), ptr(out), n)
    assert int(out.min()) >= -8 and int(out.max()) <= 8
    assert int(out[:63].max()) <= 7 and int(out[63:].min()) >= 0
    if bits <= 255:
        assert not out[64].any()
    for j, k in enumerate(scalars):
        assert sum(int(out[s, j]) << (4 * min(s, 63)) for s in range(65)) == k


# -- the Keccak chain (keccak_u64.cuh) ---------------------------------------

@pytest.mark.parametrize("k,shared", [(1, False), (3, True), (3, False)])
def test_keccak_chain_matches_plain(host_lib, k, shared):
    """keccak_chain_kernel's thread body: random states (one shared by
    every row, or one a row) and k random masks, against the plain
    int32-pair chain (words identical); k = 1 with a zero mask is one
    permutation, held against the host oracle."""
    rng = np.random.default_rng(34 + k)
    n = 9
    width = 1 if shared else n
    s_hi, s_lo = (torch.from_numpy(rng.integers(-2**31, 2**31, (25, width), dtype=np.int64)
                                   .astype(np.int32)) for _ in range(2))
    m_hi, m_lo = (torch.from_numpy(rng.integers(-2**31, 2**31, (k, 25, n), dtype=np.int64)
                                   .astype(np.int32)) for _ in range(2))
    if k == 1:
        m_hi.zero_()
        m_lo.zero_()
    o_hi, o_lo = (torch.empty((25, n), dtype=torch.int32) for _ in range(2))
    host_lib.host_keccak_chain(ptr(s_hi), ptr(s_lo), int(shared), ptr(m_hi), ptr(m_lo), k, n,
                               ptr(o_hi), ptr(o_lo))
    ref = kk.keccak_chain_plain(s_hi, s_lo, m_hi, m_lo)
    assert torch.equal(o_hi, ref[0]) and torch.equal(o_lo, ref[1])
    if k == 1:
        from cpzk_tpu_torch.core import keccak as host_keccak

        lanes = keccak.state_to_lanes((s_hi.expand(25, n), s_lo.expand(25, n)))
        got = keccak.state_to_lanes((o_hi, o_lo))
        for j in range(n):
            assert [int(v) for v in got[j]] == host_keccak.keccak_f1600(
                [int(v) for v in lanes[j]])


@pytest.mark.parametrize("shared", [True, False], ids=["shared_state", "row_state"])
@pytest.mark.parametrize("k", [0, 1, 3, 5])
@pytest.mark.parametrize("n", [1, 17, 33, 4097])
def test_keccak_chain_row_pairs_match_plain(host_lib, n, k, shared):
    """keccak_chain_kernel's row body, both threads of each row's pair (the
    lo and the hi halves of the 25 lanes, rotations across the pair) at
    once, at row counts that leave the last pair and the last warp partly
    empty on the card; k = 0 returns the state, one shared by every row or
    one a row.  Words identical to the plain int32-pair chain."""
    rng = np.random.default_rng(1000 * k + n + shared)
    width = 1 if shared else n
    ints = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32))
    s_hi, s_lo, m_hi, m_lo = ints((25, width)), ints((25, width)), ints((k, 25, n)), \
        ints((k, 25, n))
    o_hi, o_lo = (torch.empty((25, n), dtype=torch.int32) for _ in range(2))
    host_lib.host_keccak_chain(ptr(s_hi), ptr(s_lo), int(shared), ptr(m_hi), ptr(m_lo), k, n,
                               ptr(o_hi), ptr(o_lo))
    ref = kk.keccak_chain_plain(s_hi, s_lo, m_hi, m_lo)
    assert torch.equal(o_hi, ref[0]) and torch.equal(o_lo, ref[1])


def wide_limbs(values: list[int], rows: int) -> torch.Tensor:
    """``[rows, n]`` canonical 13-bit limbs of values below 2^(13 rows)."""
    return torch.tensor([[(v >> (13 * i)) & 0x1FFF for v in values] for i in range(rows)],
                        dtype=torch.int32)


@pytest.mark.parametrize("rows", [40, 24])
def test_reduce_wide_lane_matches_plain(host_lib, rows):
    """reduce_wide_kernel's lane body (the fold at bit 252) on W = rows limbs:
    the edge values that fit (0, 1, l - 1, l, 2 l, 2^252, 2^256 - 1, 2^512 -
    1), the largest value W limbs hold, values of every bit length and
    random ones; limbs equal to ``reduce_wide_plain``'s and to the value mod
    l."""
    rng = random.Random(2000 + rows)
    top = 2 ** min(512, 13 * rows)
    values = [v for v in wide_edges() if v < top] + [top - 1]
    values += [rng.getrandbits(bits) | 1 << (bits - 1) for bits in range(1, top.bit_length())]
    values += [rng.randrange(top) for _ in range(256)]
    wide = wide_limbs(values, rows)
    out = empty(len(values))
    host_lib.host_reduce_wide(ptr(wide), rows, ptr(out), len(values))
    assert torch.equal(out, sc.reduce_wide_plain(wide))
    assert sc.limbs_to_ints(out) == [v % L for v in values]


# -- the per-row ladders (ladder_w32.cuh) -------------------------------------

def ptr_array(tensors):
    """A C array of the tensors' data pointers (kept alive by the caller)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def cached_plain(p):
    """The adds' cached form of plain points: (Y - X, Y + X, 2d T, 2 Z)."""
    X, Y, Z, T = p
    return (limbs.sub(Y, X), limbs.add(Y, X), limbs.mul(T, limbs.D2.expand_as(T)),
            limbs.mul_small(Z, 2))


def test_ladder_table_matches_plain(host_lib):
    """The table body (14 cached adds) on arbitrary coordinates, the edge
    values among them: every entry's cached form equals that of the plain
    ``curve.build_table``'s entry after canonicalization."""
    p = limb_inputs(40, 4)
    out = torch.empty((16, 4, 20, N), dtype=torch.int32)
    arr = ptr_array(p)
    host_lib.host_ladder_table(arr, ptr(out), N)
    table = curve.build_table(tuple(p))
    for e in range(16):
        want = cached_plain(tuple(c[e] for c in table))
        for k in range(4):
            assert_canonical_equal(out[e, k], want[k])


@pytest.mark.parametrize("terms", [2, 4])
def test_ladder_step_and_run_match_plain(host_lib, terms):
    """One ladder step (four doublings, a cached table add a term) on an
    arbitrary accumulator, and a lane's whole 64-step ladder from the
    identity, against the plain ``_msm_rows`` composition: equal after
    canonicalization.  Windows random in [0, 16) with the extremes 0 and 15
    in whole rows."""
    n = 24
    rng = np.random.default_rng(41 + terms)
    pts = [tuple(c[:, :n].contiguous() for c in limb_inputs(50 + t, 4)) for t in range(terms)]
    acc = tuple(c[:, :n].contiguous() for c in limb_inputs(60, 4))
    w = rng.integers(0, 16, size=(terms, 64, n)).astype(np.int32)
    w[:, 0] = 15
    w[:, 1] = 0
    w = torch.from_numpy(w)
    arr = ptr_array([c for p in pts for c in p])
    acc_arr = ptr_array(acc)
    tables = [curve.build_table(p) for p in pts]
    for s in (5, -1):
        outs = [torch.empty((20, n), dtype=torch.int32) for _ in range(4)]
        host_lib.host_ladder_steps(arr, ptr(w), acc_arr, terms, s, ptr_array(outs), n)
        if s < 0:
            want = verify._msm_rows(tables, list(w))
        else:
            want = pk.point_double_k_plain(acc, 4)
            for t in range(terms):
                want = pk.point_add_plain(want, curve.table_gather(tables[t], w[t, s]))
        for o, r in zip(outs, want):
            assert_canonical_equal(o, r)


def test_ladder_is_identity_matches_plain(host_lib):
    """The identity test on coordinates that are 0 mod p but not 0 (p, 2p,
    2^256 - 38 ...), on random ones and on the identity: equal to
    ``curve.is_identity``."""
    zeros = [0, P, 2 * P, -P, 2**255 - 19, 2**256 - 38]
    n = len(zeros) * 3
    x, y, z, t = limb_inputs(70, 4)
    # random columns (the first lanes hold the edge values, zeros among them)
    x, y, z, t = (c[:, 40:40 + n].clone() for c in (x, y, z, t))
    for i, v in enumerate(zeros):
        x[:, i] = torch.from_numpy(value_limbs(v))
        y[:, len(zeros) + i] = torch.from_numpy(value_limbs(v))
    out = torch.empty((n,), dtype=torch.int32)
    host_lib.host_ladder_is_identity(ptr_array([x, y, z, t]), ptr(out), n)
    want = curve.is_identity((x, y, z, t))
    assert torch.equal(out.bool(), want)
    assert out[:2 * len(zeros)].all() and not out[2 * len(zeros):].any()


def host_combined(lib, arrays, threads):
    pts = [torch.from_numpy(c) for p in arrays[:4] for c in p]
    win = torch.from_numpy(np.stack(arrays[4:]))
    n = win.shape[-1]
    outs = [torch.empty((20, 1), dtype=torch.int32) for _ in range(4)]
    ok = torch.empty((1,), dtype=torch.uint8)
    lib.host_ladder_combined(ptr_array(pts), ptr(win), ptr_array(outs), ptr(ok), n, threads)
    return tuple(outs), bool(ok[0])


@pytest.mark.parametrize("tampered,threads", [
    (False, 16), (True, 8), (True, 128), (True, 32), (True, 12), (False, 8)],
    ids=["valid_4_threads", "tampered_2_threads", "tampered_one_block", "tampered_one_warp",
         "tampered_3_quads", "valid_2_quads"])
def test_ladder_combined_body_matches_plain(host_lib, tampered, threads):
    """ladder_combined_kernel's phases over every block, a quad of threads a
    lane: 11 rows and the correction row in 14 lanes (two identity-padded),
    in blocks of 4 quads (the last block partly past the end; one group of
    4 partials), 2 quads (7 blocks: groups of two over three levels, the
    last group ragged), 32 quads (one block), 8 quads (the card's one-warp
    block: two blocks), 3 quads (5 blocks, groups of three) and 2 quads
    valid: the total equals the plain version's as a group element, the
    identity test its verdict.  A valid total is the identity whatever the
    order, so the tampered cases are the ones that hold the sums'
    bookkeeping.  (The first three ids keep their names: their counts are
    the blocks' quads.)"""
    rows = make_rows(80, 11, {3: "s"} if tampered else None)
    alphas, beta = weights(81, 11)
    arrays = combined_inputs(rows, alphas, beta, 14)
    total, ok = host_combined(host_lib, arrays, threads)
    port = [tuple(torch.from_numpy(c) for c in p) for p in arrays[:4]] + [
        torch.from_numpy(w) for w in arrays[4:]]
    want = verify.combined_partial_kernel_plain(*port)
    assert bool(curve.eq(tuple(c[:, 0] for c in total), tuple(c[:, 0] for c in want)))
    assert ok is bool(verify.combined_kernel_plain(*port)) is (not tampered)
    for c in total:
        assert int(c.min()) >= 0 and int(c.max()) <= limbs.LIMB_MASK


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "tampered"])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 33, 92])
def test_ladder_partials_identity_body_matches_plain(host_lib, k, valid):
    """ladder_partials_identity_kernel's block over k totals, every quad and
    level in its order: pairs P, -P (and the identity for odd k) in
    non-canonical coordinates (scaled by random factors) sum to the
    identity, one replaced point does not; equal to the plain tree-sum and
    identity test.  k = 1 is the identity test alone, 2..8 quads within a
    warp (shuffle levels only), 33 and 92 past the 32 quads (a quad sums two
    or three totals in turn, two levels across warps)."""
    parts = tuple(torch.from_numpy(c) for c in partial_totals(90 + k, k, valid))
    ok = torch.empty((1,), dtype=torch.uint8)
    host_lib.host_ladder_partials_identity(ptr_array(parts), ptr(ok), k)
    assert bool(ok[0]) is bool(verify.partials_identity_plain(parts)) is valid


@pytest.mark.parametrize("case,n,threads", [
    ("random", 1, 0), ("random", 77, 0), ("random", 4096, 0), ("random", 16384, 0),
    ("l_minus_1", 130, 0), ("ninth_word", 1500, 0), ("random", 77, 32), ("random", 1100, 64)],
    ids=["one_row", "ragged", "n4096", "n16384", "l_minus_1", "ninth_word",
         "ragged_32_threads", "n1100_64_threads"])
def test_rlc_scalars_body_matches_plain(host_lib, case, n, threads):
    """rlc_scalars_kernel's bodies (``csrc/sc25519_w32.cuh``: a row's two
    threads, the 9-word sum, the last block's reduction and corrections)
    over every block, the warps' shuffle levels and the last block, as the
    card runs them (threads 0: the kernel's block size), equal to
    ``rlc_scalars_plain`` limb for limb: one row, a count no block size
    divides, the main path's 4096 and 16,384 rows, every scalar l - 1, and
    1,500 rows whose a s sum past 2^256 (the ninth word); also at blocks of
    one and two warps."""
    al, cl, sl, bl = (torch.from_numpy(sc.ints_to_limbs(v))
                      for v in rlc_case(np.random.default_rng(120 + n), case, n))
    out = [empty(n) for _ in range(3)] + [empty(1) for _ in range(2)]
    host_lib.host_rlc_scalars(ptr(al), ptr(cl), ptr(sl), ptr(bl), *(ptr(o) for o in out), n,
                              threads)
    want = sk.rlc_scalars_plain(al, cl, sl, bl)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    if case == "ninth_word":
        terms = sum(a * s % L for a, s in zip(sc.limbs_to_ints(al), sc.limbs_to_ints(sl)))
        assert terms >= 2**256


def host_each(lib, shared, seed, threads, n=11):
    """ladder_each_kernel's phases over blocks of `threads` threads: 9 rows
    (a response off by one, a swapped commitment of each equation) in n
    lanes, g and h shared ([20, 1]) or per lane -> (the bits, the plain
    version's, the expectation)."""
    tampered = {1: "s", 4: "r1", 7: "r2"}
    rows = make_rows(seed, 9, tampered, per_lane_generators=not shared)
    arrays = each_inputs(rows, n, shared)
    pts = [torch.from_numpy(c) for p in arrays[:6] for c in p]
    steps = torch.tensor([0 if shared else 1] * 2 + [1] * 4, dtype=torch.int32)
    win = torch.from_numpy(np.stack(arrays[6:]))
    out = torch.empty((n,), dtype=torch.uint8)
    lib.host_ladder_each(ptr_array(pts), ptr(steps), ptr(win), ptr(out), n, threads)
    port = [tuple(torch.from_numpy(c) for c in p) for p in arrays[:6]] + [
        torch.from_numpy(w) for w in arrays[6:]]
    want = [int(i not in tampered) for i in range(9)] + [1] * (n - 9)
    return out, verify.verify_each_kernel_plain(*port), want


@pytest.mark.parametrize("shared", [True, False], ids=["shared_generators", "per_lane"])
def test_ladder_each_body_matches_plain(host_lib, shared):
    """ladder_each_kernel's lanes, two quads (one an equation) a lane, in
    blocks of four lanes (the last partly past the end): 9 rows (a response
    off by one, a swapped commitment of each equation) in 11 lanes, g and h
    shared ([20, 1], their tables once a block) or per lane: bits equal to
    the plain version's and to the expectation."""
    out, ref, want = host_each(host_lib, shared, 100 if shared else 101, 32)
    assert torch.equal(out.bool(), ref)
    assert out.tolist() == want


@pytest.mark.parametrize("shared,threads", [(True, 8), (True, 256), (False, 24)],
                         ids=["shared_lane_a_block", "shared_one_block", "per_lane_3_lanes"])
def test_ladder_each_body_blocks(host_lib, shared, threads):
    """ladder_each_kernel's phases at other block sizes: one lane a block
    (every block builds the shared generators' tables), one block of 32
    lanes (21 past the end), three lanes a block with per-lane generators:
    bits equal to the plain version's and to the expectation."""
    out, ref, want = host_each(host_lib, shared, 102 if shared else 103, threads)
    assert torch.equal(out.bool(), ref)
    assert out.tolist() == want
