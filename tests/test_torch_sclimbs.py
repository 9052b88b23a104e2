"""The port's scalar arithmetic mod l (``cpzk_tpu_torch.ops.sclimbs``) and
its device scalar plane (``ops.scalar_kernels``' plain versions, the
``CPZK_DEVICE_RLC=1`` paths of ``TorchBackend``), on the CPU.

Twins of tests/test_ops_sclimbs.py (all but the sharded-mesh case, which
waits for the multi-GPU port) against the host oracle, plus differentials
against the JAX package: the same numpy limbs through
``cpzk_tpu.ops.sclimbs`` and ``cpzk_tpu_torch.ops.sclimbs``, and the same
rows through the reference's ``_rlc_products``, ``_rlc_scalar_groups`` and
``_pippenger_digits_device`` and the port's; and ``scalar_recode``'s
thread body (``csrc/recode_w32.cuh``, through the host shim of
``tests/torch_host_shim.py``) against the reference's windows and digits.
Tolerance everywhere: exact (limb for limb; every output is canonical)."""

import random

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.ops import sclimbs as jsc
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.ops import backend as backend_mod
from cpzk_tpu_torch.ops import scalar_kernels as sk
from cpzk_tpu_torch.ops import sclimbs as m
from cpzk_tpu_torch.ops.backend import TorchBackend


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


class SeededRng:
    def __init__(self, seed):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n):
        return self._g.bytes(n)


def rand_scalars(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(L) for _ in range(n)]


def limbs(values):
    return torch.from_numpy(m.ints_to_limbs(values))


def test_mul_matches_host():
    n = 33
    xs, ys = rand_scalars(n, 1), rand_scalars(n, 2)
    xs[:4] = [0, 1, L - 1, L - 1]
    ys[:4] = [L - 1, L - 1, L - 1, 1]
    out = m.limbs_to_ints(m.mul(limbs(xs), limbs(ys)))
    assert out == [x * y % L for x, y in zip(xs, ys)]


def test_add_matches_host():
    n = 17
    xs, ys = rand_scalars(n, 3), rand_scalars(n, 4)
    xs[0], ys[0] = L - 1, L - 1
    out = m.limbs_to_ints(m.add(limbs(xs), limbs(ys)))
    assert out == [(x + y) % L for x, y in zip(xs, ys)]


def test_wide_reduction_matches_host():
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 256, size=(9, 64), dtype=np.uint8)
    cols[0] = 0xFF   # max 512-bit value
    cols[1] = 0      # zero
    out = m.limbs_to_ints(m.reduce_wide(torch.from_numpy(m.bytes_wide_to_limbs(cols))))
    assert out == [int.from_bytes(b.tobytes(), "little") % L for b in cols]


@pytest.mark.parametrize("n", [1, 7, 1024, 40000])
def test_sum_mod_l_matches_host(n):
    """40,000 columns take the chunked (2^15) partial sums."""
    xs = rand_scalars(n, 6 + n)
    got = m.limbs_to_ints(m.sum_mod_l(limbs(xs)))[0]
    assert got == sum(xs) % L


def test_mul_chain_stays_canonical():
    """Outputs feed back as inputs (canonical in, canonical out)."""
    xs = rand_scalars(5, 7)
    a = limbs(xs)
    acc, exp = a, list(xs)
    for _ in range(4):
        acc = m.mul(acc, a)
        exp = [e * x % L for e, x in zip(exp, xs)]
    assert m.limbs_to_ints(acc) == exp


def test_to_windows_matches_host():
    from cpzk_tpu_torch.ops.curve import scalars_to_windows

    xs = rand_scalars(21, 8) + [0, 1, L - 1]
    got = m.to_windows(limbs(xs)).numpy()
    exp = scalars_to_windows(xs)
    assert got.shape == exp.shape and (got == exp).all()


def test_to_signed_digits_matches_host():
    from cpzk_tpu_torch.ops.msm import scalars_to_signed_digits

    for c in (4, 8, 13, 16):
        xs = rand_scalars(9, 9 + c) + [0, 1, L - 1]
        got = m.to_signed_digits(limbs(xs), c).numpy()
        exp = scalars_to_signed_digits(xs, c)
        assert got.shape == exp.shape and (got == exp).all(), c


@pytest.mark.parametrize("op", ["mul", "add", "neg", "reduce_wide", "sum_mod_l",
                                "to_windows", "to_signed_digits"])
def test_matches_the_jax_package_limb_for_limb(op):
    """The same numpy limbs through both packages: equal limb for limb."""
    xs = rand_scalars(37, 10) + [0, 1, L - 1]
    ys = rand_scalars(40, 11)
    a, b = m.ints_to_limbs(xs), m.ints_to_limbs(ys)
    wide = m.bytes_wide_to_limbs(np.random.default_rng(12).integers(
        0, 256, size=(40, 64), dtype=np.uint8))
    assert (a == jsc.ints_to_limbs(xs)).all()
    port, ref = {
        "mul": (lambda: m.mul(torch.from_numpy(a), torch.from_numpy(b)),
                lambda: jsc.mul(a, b)),
        "add": (lambda: m.add(torch.from_numpy(a), torch.from_numpy(b)),
                lambda: jsc.add(a, b)),
        "neg": (lambda: m.neg(torch.from_numpy(a)), lambda: jsc.neg(a)),
        "reduce_wide": (lambda: m.reduce_wide(torch.from_numpy(wide)),
                        lambda: jsc.reduce_wide(wide)),
        "sum_mod_l": (lambda: m.sum_mod_l(torch.from_numpy(a)), lambda: jsc.sum_mod_l(a)),
        "to_windows": (lambda: m.to_windows(torch.from_numpy(a)), lambda: jsc.to_windows(a)),
        "to_signed_digits": (lambda: m.to_signed_digits(torch.from_numpy(a), 11),
                             lambda: jsc.to_signed_digits(a, 11)),
    }[op]
    got, want = port().numpy(), np.asarray(ref())
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (got == want).all()


# -- the device scalar plane: the plain versions of the scalar kernels -------

def make_rows(seed, n, params=None):
    """n port-made BatchRows (prepared by the port's BatchVerifier) and beta."""
    rng = SeededRng(seed)
    params = params or T.Parameters.new()
    bv = T.BatchVerifier(backend=T.CpuBackend())
    for _ in range(n):
        p = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng)))
        bv.add(params, p.statement, p.prove_with_transcript(rng, T.Transcript()))
    rows = bv.prepare_rows(rng)
    return rows, T.Ristretto255.random_scalar(rng)


def test_device_rlc_windows_match_host():
    """The four device-derived window columns equal the host big-int
    products' windows for the same rows and beta (correction at lane n)."""
    from cpzk_tpu_torch.ops.curve import scalar_windows

    rows, beta = make_rows(13, 3)
    n, pad = len(rows), backend_mod._pad_pow2(len(rows) + 1)
    a, ac, ba, bac, corr0, corr1 = backend_mod._host_rlc_scalars(rows, beta)
    host_cols = (scalar_windows(a + [corr0], pad, "cpu"),
                 scalar_windows(ac + [corr1], pad, "cpu"),
                 scalar_windows(ba, pad, "cpu"), scalar_windows(bac, pad, "cpu"))
    dev_cols = backend_mod._rlc_windows_device(rows, beta, pad, "cpu")
    assert n == 3 and len(dev_cols) == 4
    for hcol, dcol in zip(host_cols, dev_cols):
        assert torch.equal(hcol, dcol)


@pytest.mark.parametrize("n", [1, 11])
def test_scalar_plane_matches_the_jax_package(n):
    """The same rows and beta through the reference's ``_rlc_products``,
    ``_rlc_scalar_groups`` and ``_pippenger_digits_device`` and the port's
    (the plain versions of ``rlc_scalars`` and ``scalar_recode``)."""
    import jax.numpy as jnp

    from cpzk_tpu.ops import backend as jb
    from cpzk_tpu.protocol.batch import BatchRow as JRow

    rows, beta = make_rows(14 + n, n)
    el = J.Ristretto255.element_from_bytes

    def jrow(r):
        e = [el(x.wire()) for x in (r.g, r.h, r.y1, r.y2, r.r1, r.r2)]
        return JRow(*e, J.Scalar(r.s.value), J.Scalar(r.c.value), J.Scalar(r.alpha.value))

    jrows, jbeta = [jrow(r) for r in rows], J.Scalar(beta.value)
    pad = backend_mod._pad_lanes(n + 1)
    got = backend_mod._rlc_windows_device(rows, beta, pad, "cpu")
    want = jb._rlc_windows_device(jrows, jbeta, pad)
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
    al, cl, sl, bl = backend_mod._marshal_scalar_limbs(rows, beta, backend_mod._pad_pow2(n), "cpu")
    got = sk.rlc_scalars(al, cl, sl, bl)
    want = jb._rlc_scalar_groups(*(jnp.asarray(t.numpy()) for t in (al, cl, sl, bl)))
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
    mm = 4 * backend_mod._pad_pow2(n) + 2
    for c in (4, 11):
        got = backend_mod._pippenger_digits_device(rows, beta, mm, c, "cpu")
        want = jb._pippenger_digits_device(jrows, jbeta, mm, c)
        assert (got.numpy() == np.asarray(want)).all()


@pytest.mark.parametrize("case,n", [("edges", 1), ("edges", 77), ("l_minus_1", 130)])
def test_rlc_scalars_plain_matches_jax_at_edges(case, n):
    """``rlc_scalars_plain`` (and the wrapper on CPU tensors) against the
    reference's ``_rlc_scalar_groups`` bit for bit in the 13-bit limbs: one
    row, 77 rows (no block size of the kernel divides it) with 0, 1, l - 1
    and l - 2 among random scalars, and 130 rows of every scalar l - 1."""
    import jax.numpy as jnp

    from cpzk_tpu.ops import backend as jb

    rng = random.Random(30 + n)
    if case == "l_minus_1":
        cols = [[L - 1] * n for _ in range(3)] + [[L - 1]]
    else:
        edges = [0, 1, L - 1, L - 2]
        cols = [[rng.randrange(L) for _ in range(n)] for _ in range(3)] + [[L - 1]]
        for k, v in enumerate(cols[:3]):
            v[:min(n, 4)] = (edges[k:] + edges[:k])[:min(n, 4)]
    al, cl, sl, bl = (limbs(v) for v in cols)
    got = sk.rlc_scalars_plain(al, cl, sl, bl)
    want = jb._rlc_scalar_groups(*(jnp.asarray(t.numpy()) for t in (al, cl, sl, bl)))
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
    assert all(torch.equal(g, r) for g, r in zip(sk.rlc_scalars(al, cl, sl, bl), got))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    import torch_host_shim

    return torch_host_shim.build(tmp_path_factory)


def _edge_rows(n, seed):
    """n rows' (alpha, c, s) and beta as duck-typed scalars (``.value``):
    alpha led by 0, 1, l - 1 and 2^253 - 1, the rest random below l."""
    from types import SimpleNamespace as NS

    rng = random.Random(seed)
    alphas = [rng.randrange(L) for _ in range(n)]
    alphas[:min(n, 4)] = [0, 1, L - 1, 2**253 - 1][:min(n, 4)]
    rows = [NS(alpha=NS(value=a), c=NS(value=rng.randrange(L)), s=NS(value=rng.randrange(L)))
            for a in alphas]
    return rows, NS(value=rng.randrange(L))


def _host_recode(lib, groups, corr, n, mode, c, nwin, m, shape):
    out = torch.full(shape, -(2**31), dtype=torch.int32)
    lib.host_scalar_recode(*(t.contiguous().data_ptr() for t in (*groups, *corr)), n,
                           groups[0].shape[1], mode, c, nwin, m, out.data_ptr())
    return out


@pytest.mark.parametrize("n", [1, 5, 127])
def test_scalar_recode_body_matches_jax(host_lib, n):
    """``scalar_recode``'s thread body (``csrc/recode_w32.cuh``, through the
    host shim) on the products of the port's ``rlc_scalars`` against the
    JAX package: the windows of ``_rlc_products`` with the corrections at
    lane n = pad - 1, and the digits of ``_pippenger_digits_device`` at
    c = 4, 11, 13, 16, with m - 4 n - 2 = 0 or 3 zero terms; alpha led by
    0, 1, l - 1 and 2^253 - 1.  Exact."""
    import jax.numpy as jnp

    from cpzk_tpu.ops import backend as jb
    from cpzk_tpu_torch.ops import msm

    rows, beta = _edge_rows(n, 40 + n)
    pad = n + 1
    al, cl, sl, bl = backend_mod._marshal_scalar_limbs(rows, beta, pad, "cpu")
    ac, ba, bac, corr0, corr1 = sk.rlc_scalars(al, cl, sl, bl)
    got = _host_recode(host_lib, (al, ac, ba, bac), (corr0, corr1), n, 0, 4, 64, 0,
                       (4, 64, pad))
    want = jb._rlc_products(jnp.int32(n), *(jnp.asarray(t.numpy()) for t in (al, cl, sl, bl)))
    for g, w in zip(got, want):
        assert (g.numpy() == np.asarray(w)).all()
    pw = backend_mod._pad_pow2(n)
    al, cl, sl, bl = backend_mod._marshal_scalar_limbs(rows, beta, pw, "cpu")
    ac, ba, bac, corr0, corr1 = sk.rlc_scalars(al, cl, sl, bl)
    for c, zeros in ((4, 0), (11, 3), (13, 0), (16, 3)):
        m, nwin = 4 * n + 2 + zeros, msm.num_windows(c)
        got = _host_recode(host_lib, (al, ac, ba, bac), (corr0, corr1), n, 1, c, nwin, m,
                           (nwin, m))
        want = jb._pippenger_digits_device(rows, beta, m, c)
        assert (got.numpy() == np.asarray(want)).all(), (c, zeros)


def test_scalar_kernel_wrappers_check_their_inputs():
    a = limbs([1, 2, 3, 4])
    one = limbs([1])
    with pytest.raises(ValueError):
        sk.rlc_scalars(a.long(), a, a, one)
    with pytest.raises(ValueError):
        sk.rlc_windows((a, a, a, a), one, one, 4)   # lane 4 outside [0, 4)
    with pytest.raises(ValueError):
        sk.rlc_digits((a, a, a, a), one, one, 4, 17, 11)  # 17 < 4 * 4 + 2
    with pytest.raises(ValueError):
        sk.rlc_digits((a, a, a, a), one, one, 4, 18, 3)
    assert sk.LAUNCHES == {"rlc_scalars": 0, "scalar_recode": 0, "reduce_wide": 0}  # the CPU launches none


def _entries(seed, n):
    rng = SeededRng(seed)
    params = T.Parameters.new()
    provers = [T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng))) for _ in range(n)]
    proofs = [p.prove_with_transcript(rng, T.Transcript()) for p in provers]
    return params, provers, proofs


def test_device_rlc_prep_end_to_end(monkeypatch):
    """CPZK_DEVICE_RLC=1 routes the per-row combined check's scalar prep
    through the device plane with identical accept/reject decisions."""
    params, provers, proofs = _entries(16, 5)
    monkeypatch.setenv("CPZK_DEVICE_RLC", "1")
    bv = T.BatchVerifier(backend=TorchBackend(device="cpu", pippenger_min=9999))
    for p, pf in zip(provers, proofs):
        bv.add(params, p.statement, pf)
    assert bv.verify(T.SecureRng()) == [None] * 5

    # one bad row: combined fails, the per-proof fallback flags index 5 only
    bv = T.BatchVerifier(backend=TorchBackend(device="cpu", pippenger_min=9999))
    for p, pf in zip(provers, proofs):
        bv.add(params, p.statement, pf)
    bv.add(params, provers[0].statement, proofs[1])
    res = bv.verify(T.SecureRng())
    assert [r is None for r in res] == [True] * 5 + [False]


def test_device_rlc_pippenger_path(monkeypatch):
    """CPZK_DEVICE_RLC=1 with the Pippenger branch engaged (n >= min):
    same accept/reject, digits from the device scalar plane.  The crossover
    comes from the constructor (no module reload)."""
    params, provers, proofs = _entries(17, 6)
    monkeypatch.setenv("CPZK_DEVICE_RLC", "1")
    bv = T.BatchVerifier(backend=TorchBackend(device="cpu", pippenger_min=2))
    for p, pf in zip(provers, proofs):
        bv.add(params, p.statement, pf)
    assert bv.verify(T.SecureRng()) == [None] * 6

    bv = T.BatchVerifier(backend=TorchBackend(device="cpu", pippenger_min=2))
    for p, pf in zip(provers, proofs):
        bv.add(params, p.statement, pf)
    bv.add(params, provers[0].statement, proofs[1])
    res = bv.verify(T.SecureRng())
    assert [r is None for r in res] == [True] * 6 + [False]
