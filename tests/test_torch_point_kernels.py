"""The point kernels' plain PyTorch versions against the JAX package's
Pallas kernels (interpret mode on the CPU backend, as tests/test_pallas.py
runs them) and against the host oracle.

Both compute the same 20x13-bit schedule, so outputs must match limb for
limb (tolerance: exact).  On the CPU the wrappers run the plain versions,
so the launch counters stay at 0."""

import numpy as np
import pytest

from cpzk_tpu.core import edwards as he
from cpzk_tpu.core import scalars as hs
from cpzk_tpu.ops import curve as jcurve
from cpzk_tpu.ops import pallas_kernels
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.ops import point_kernels as pk

N = 128  # the Pallas kernels' minimum lane width


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(77)
    host = [
        he.pt_scalar_mul(he.BASEPOINT, int.from_bytes(rng.bytes(32), "little") % hs.L)
        for _ in range(N - 1)
    ]
    host.append(he.IDENTITY)
    p = jcurve.points_to_device(host)
    q = tuple(np.roll(np.asarray(c), 7, axis=1) for c in p)
    return host, p, q


def assert_limbs_equal(jax_pt, torch_pt):
    for j, t in zip(jax_pt, torch_pt):
        np.testing.assert_array_equal(np.asarray(j), convert.to_numpy(t))


def assert_host_equal(expected, torch_pt):
    from cpzk_tpu_torch.ops import curve

    for want, got in zip(expected, curve.points_from_device(torch_pt)):
        assert he.pt_eq(want, tuple(v % he.P for v in got))


def test_point_add_matches_pallas_and_host(pts):
    host, p, q = pts
    pk.reset_launches()
    out = pk.point_add(convert.point(p, "cpu"), convert.point(q, "cpu"))
    assert_limbs_equal(pallas_kernels.point_add(p, q), out)
    host_q = host[-7:] + host[:-7]
    assert_host_equal([he.pt_add(a, b) for a, b in zip(host, host_q)], out)
    assert pk.LAUNCHES == {"point_add": 0, "point_double_k": 0}


@pytest.mark.parametrize("k", [1, 4])
def test_point_double_k_matches_pallas_and_host(pts, k):
    host, p, _ = pts
    pk.reset_launches()
    out = pk.point_double_k(convert.point(p, "cpu"), k)
    assert_limbs_equal(pallas_kernels.point_double_k(p, k), out)
    expected = []
    for a in host:
        for _ in range(k):
            a = he.pt_double(a)
        expected.append(a)
    assert_host_equal(expected, out)
    assert pk.LAUNCHES == {"point_add": 0, "point_double_k": 0}


def test_wrapper_broadcasts_and_rejects(pts):
    """add broadcasts a [20, 1] operand against [20, n]; bad inputs raise."""
    _, p, _ = pts
    tp = convert.point(p, "cpu")
    one = tuple(c[:, :1] for c in tp)
    out = pk.point_add(one, tp)
    ref = pk.point_add_plain(tuple(c.expand(20, N) for c in one), tp)
    for a, b in zip(out, ref):
        assert (a == b).all()
    with pytest.raises(ValueError):
        pk.point_double_k(tp, 0)
    # the CUDA launch path's argument check (device-agnostic)
    flat, shape = pk._lanes(list(one) + list(tp), tp[0].device)
    assert shape == (20, N)
    assert all(c.shape == (20, N) and c.is_contiguous() for c in flat)
    with pytest.raises(ValueError):
        pk._lanes([tp[0].long()], tp[0].device)
    with pytest.raises(ValueError):
        pk._lanes([tp[0][:19]], tp[0].device)
