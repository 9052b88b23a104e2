"""The port's signed-digit Pippenger MSM (``cpzk_tpu_torch.ops.msm``, whose
plain version runs on the CPU) against the integer-exact host edwards
module, against the JAX package's ``msm_kernel`` on the same points and
digits, and the ``TorchBackend`` dispatch into it.

Twins of tests/test_msm.py (the m in {1, 5, 16} and window-size sweeps
included).  Tolerance: the MSM is a group element, so results compare as
group elements: ``pt_eq`` against the host oracle, equal ristretto
encodings against the JAX package (the limbs may differ with the order of
the adds)."""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cpzk_tpu.ops import curve as jcurve, msm as jmsm
from cpzk_tpu_torch.core import edwards as he
from cpzk_tpu_torch.core import scalars as hs
from cpzk_tpu_torch.ops import curve, msm, msm_kernels as mk, point_kernels as pk

RNG = random.Random(20261017)


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


def host_msm(points, scalars):
    acc = he.IDENTITY
    for p, k in zip(points, scalars):
        acc = he.pt_add(acc, he.pt_scalar_mul(p, k))
    return acc


def run_msm(points, scalars, c):
    pts = curve.points_to_device(points, "cpu")
    digits = torch.from_numpy(msm.scalars_to_signed_digits(scalars, c))
    got = curve.points_from_device(msm.msm_kernel(pts, digits, c))[0]
    return tuple(v % he.P for v in got)


def rand_point():
    return he.pt_scalar_mul(he.BASEPOINT, RNG.randrange(hs.L))


C = 6
M = 16


def padded(points, scalars):
    points = points + [he.IDENTITY] * (M - len(points))
    scalars = scalars + [0] * (M - len(scalars))
    return points, scalars


@pytest.mark.parametrize("m", [1, 5, 16])
def test_msm_matches_host(m):
    points = [rand_point() for _ in range(m)]
    scalars = [RNG.randrange(hs.L) for _ in range(max(0, m - 3))]
    scalars += [0, 1, hs.L - 1][: m - len(scalars)]
    points, scalars = padded(points, scalars)
    assert he.pt_eq(run_msm(points, scalars, C), host_msm(points, scalars))


def test_msm_duplicate_buckets():
    """Many terms landing in the same bucket exercise the segment sums."""
    p = rand_point()
    points, scalars = padded([p] * 12, [3] * 12)
    assert he.pt_eq(run_msm(points, scalars, C), host_msm(points, scalars))


def test_msm_identity_output():
    x = RNG.randrange(hs.L)
    points, scalars = padded([he.BASEPOINT, he.BASEPOINT], [x, hs.L - x])
    pts = curve.points_to_device(points, "cpu")
    digits = torch.from_numpy(msm.scalars_to_signed_digits(scalars, C))
    assert bool(msm.msm_is_identity_kernel(pts, digits, C))


@pytest.mark.parametrize("c", [5, 7])
def test_msm_matches_host_across_windows(c):
    points = [rand_point() for _ in range(M - 2)] + [he.IDENTITY]
    scalars = [RNG.randrange(hs.L) for _ in range(M - 3)] + [0, hs.L - 1]
    points, scalars = padded(points, scalars)
    assert he.pt_eq(run_msm(points, scalars, c), host_msm(points, scalars))


def test_signed_digit_recode_roundtrip():
    for c in (4, 7, 13, 16):
        vals = [0, 1, hs.L - 1, RNG.randrange(hs.L), (1 << 252)]
        digits = msm.scalars_to_signed_digits(vals, c)
        assert digits.shape == (msm.num_windows(c), len(vals))
        half = 1 << (c - 1)
        assert np.abs(digits).max() <= half
        for j, v in enumerate(vals):
            rec = sum(int(digits[k, j]) << (c * k) for k in range(digits.shape[0]))
            assert rec == v


def test_pick_window_grows_with_m(monkeypatch):
    monkeypatch.delenv("CPZK_MSM_WINDOW", raising=False)
    cs = [msm.pick_window(m) for m in (256, 8192, 262144)]
    assert cs == sorted(cs)
    assert cs[0] >= 4 and cs[-1] <= 16
    assert msm.pick_window(16384) == jmsm.pick_window(16384) == 11
    monkeypatch.setenv("CPZK_MSM_WINDOW", "9")
    assert msm.pick_window(16384) == 9
    monkeypatch.setenv("CPZK_MSM_WINDOW", "17")
    with pytest.raises(ValueError):
        msm.pick_window(16384)


def test_msm_matches_the_jax_package():
    """The same points and digits through both packages' ``msm_kernel`` (at
    tests/test_msm.py's shape, so the JAX program is shared): equal
    encodings; and the plain version split into the two kernels' halves
    gives the same point."""
    c = C
    points = [rand_point() for _ in range(M - 1)] + [he.IDENTITY]
    scalars = [RNG.randrange(hs.L) for _ in range(M - 3)] + [0, 1, hs.L - 1]
    digits = msm.scalars_to_signed_digits(scalars, c)
    digits[1] = 1 << (c - 1)  # every term in the top bucket of window 1
    pts = curve.points_to_device(points, "cpu")
    got = msm.msm_kernel(pts, torch.from_numpy(digits), c)
    jpts = tuple(jnp.asarray(x.numpy()) for x in pts)
    want = jax.jit(jmsm.msm_kernel, static_argnums=2)(jpts, jnp.asarray(digits), c)
    want = tuple(torch.from_numpy(np.array(x)) for x in want)
    assert torch.equal(curve.encode(got), curve.encode(want))
    buckets = mk.msm_bucket(pts, torch.from_numpy(digits), c)
    assert buckets[0].shape == (20, digits.shape[0], 1 << (c - 1))
    assert torch.equal(curve.encode(mk.msm_window_reduce(buckets, c)), curve.encode(got))
    # the JAX package's own encoding of its result, byte for byte
    assert (curve.encode(got).numpy() == np.asarray(jcurve.encode(
        tuple(jnp.asarray(x.numpy()) for x in want)))).all()


def test_wrappers_route_by_device():
    """CPU tensors run the plain versions (no launch counted); another
    device raises; bad shapes raise."""
    pts = curve.points_to_device([rand_point(), he.IDENTITY], "cpu")
    digits = torch.from_numpy(msm.scalars_to_signed_digits([5, 7], 4))
    mk.reset_launches()
    msm.msm_kernel(pts, digits, 4)
    assert mk.LAUNCHES == {"msm_bucket": 0, "msm_window_reduce": 0}
    meta = tuple(x.to("meta") for x in pts)
    with pytest.raises(ValueError):
        msm.msm_kernel(meta, digits.to("meta"), 4)
    with pytest.raises(ValueError):
        mk.msm_bucket(meta, digits.to("meta"), 4)
    with pytest.raises(ValueError):
        mk.msm_bucket(pts, digits, 17)


def test_msm_bucket_work_counts_what_the_digits_need():
    """msm_bucket's bound counts, per window, one cached add fewer than a
    bucket's terms, the cached form of every point with a non-zero digit
    and a negation per negative digit: here window 0 has buckets {1: 3
    terms, 2: 1} and window 1 {4: 2}, so 2 + 0 + 1 adds; points 0, 1, 2, 3
    have non-zero digits; two digits are negative."""
    digits = torch.tensor([[1, -1, 1, 2, 0], [4, 0, 0, -4, 0]], dtype=torch.int32)
    nbytes, ops = mk.msm_bucket_work(digits, 4)
    assert nbytes == mk.POINT_BYTES * 5 + 4 * 2 * 5 + mk.POINT_BYTES * 2 * 8
    assert ops == 3 * mk.CACHED_ADD_OPS + 4 * mk.CACHED_OPS + 2 * mk.NEGATE_OPS
    # the 8x32-bit schedule's counts: 8 multiplies and 6 linear ops an add
    assert (mk.CACHED_ADD_OPS, mk.CACHED_OPS, mk.NEGATE_OPS) == (1398, 213, 17)
    # one bucket a window: m - 1 adds each, fewer than one general add a digit
    same = torch.full((3, 100), 5, dtype=torch.int32)
    _, ops = mk.msm_bucket_work(same, 4)
    assert ops == 3 * 99 * mk.CACHED_ADD_OPS + 100 * mk.CACHED_OPS
    assert ops < 300 * pk.ADD_OPS_PER_LANE


def test_backend_pippenger_path():
    """BatchVerifier + TorchBackend routed through the Pippenger MSM: a
    valid batch accepts; a corrupted row falls back to per-proof results.
    The default never picks Pippenger, so the crossover is pinned low."""
    import cpzk_tpu_torch as T
    from cpzk_tpu_torch.ops.backend import TorchBackend

    class SeededRng:
        def __init__(self, seed):
            self._g = np.random.default_rng(seed)

        def fill_bytes(self, n):
            return self._g.bytes(n)

    rng = SeededRng(35)
    params = T.Parameters.new()
    n = 35
    bv = T.BatchVerifier(backend=TorchBackend(device="cpu", pippenger_min=32))
    proofs = []
    for _ in range(n):
        prover = T.Prover(params, T.Witness(T.Ristretto255.random_scalar(rng)))
        proof = prover.prove_with_transcript(rng, T.Transcript())
        proofs.append((prover.statement, proof))
        bv.add(params, prover.statement, proof)
    assert bv.verify(T.SecureRng()) == [None] * n

    bad = T.BatchVerifier(backend=TorchBackend(device="cpu", pippenger_min=32))
    for i, (st, pr) in enumerate(proofs):
        bad.add(params, st, proofs[0][1] if i == n - 1 else pr)
    results = bad.verify(T.SecureRng())
    assert results[: n - 1] == [None] * (n - 1)
    assert results[n - 1] is not None
