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


def test_kernel_registry_names_every_kernel_and_routes_one_way():
    """The registry: the fourteen kernels, named by their modules' ``LAUNCHES``
    keys, counted and reset together, each found in a build report; and
    the one routing rule of every wrapper (CPU plain, CUDA kernel, any
    other device raises)."""
    import torch

    from cpzk_tpu_torch.ops import decode_kernels as dk
    from cpzk_tpu_torch.ops import keccak_kernels as kk, ladder_kernels as lk
    from cpzk_tpu_torch.ops import msm_kernels as mk
    from cpzk_tpu_torch.ops import prove_kernels as pvk, scalar_kernels as sk

    names = ("point_add", "point_double_k", "ladder_combined", "ladder_partials_identity",
             "ladder_each", "rlc_scalars", "scalar_recode", "reduce_wide",
             "msm_bucket", "msm_window_reduce", "keccak_chain", "comb_tables", "commitments",
             "ristretto_decode")
    assert pk.kernel_modules() == (pk, lk, sk, mk, kk, pvk, dk)
    assert pk.kernel_names() == names
    saved = pk.all_launches()
    try:
        for module in pk.kernel_modules():
            for name in module.LAUNCHES:
                module.LAUNCHES[name] = 3
        assert pk.all_launches() == dict.fromkeys(names, 3)
        pk.reset_all_launches()
        assert pk.all_launches() == dict.fromkeys(names, 0)
    finally:
        for module in pk.kernel_modules():
            module.LAUNCHES.update({k: saved[k] for k in module.LAUNCHES})
    report = "\n".join(
        f"ptxas info    : Compiling entry function '_Z{len(name) + 7}{name}_kernelPKi' "
        f"for 'sm_90a'\nptxas info    : Used {40 + k} registers, used 1 barriers"
        for k, name in enumerate(names))
    assert pk.ptxas_report(report) == {name: {"registers": 40 + k}
                                       for k, name in enumerate(names)}
    assert pk.on_card("x", torch.device("cpu")) is False
    assert pk.on_card("x", torch.device("cuda", 0)) is True
    with pytest.raises(ValueError, match="x: unsupported device meta"):
        pk.on_card("x", torch.device("meta"))


def test_ptxas_report_and_operation_counts():
    """The build report chip_smoke.py prints per kernel, parsed from an
    ``nvcc -Xptxas -v`` report; and the bound counts the fewer operations
    of the two schedules."""
    report = "\n".join([
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL_21point_double_k_kernelEPKiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL_21point_double_k_kernelEPKiii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 110 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN4_GLOBAL_16point_add_kernelEPKii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4_GLOBAL_16point_add_kernelEPKii",
        "    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 80 registers, used 0 barriers, 16 bytes cumulative stack size",
    ])
    assert pk.ptxas_report(report) == {
        "point_double_k": {"stack_bytes": 0, "spill_store_bytes": 0,
                           "spill_load_bytes": 0, "registers": 110},
        "point_add": {"stack_bytes": 16, "spill_store_bytes": 12,
                      "spill_load_bytes": 8, "registers": 80},
    }
    assert pk.ADD_OPS_PER_LANE == pk._add_ops(pk.W32_MUL_OPS, pk.W32_LINEAR_OPS) == 1611
    assert pk.double_k_ops_per_lane(4) == 4578
    assert pk.double_k_ops_per_lane(4) < pk._double_k_ops(4, pk.MUL_OPS, pk.SQ_OPS, pk.LINEAR_OPS)


def test_ptxas_report_joins_a_wrappers_globals():
    """A wrapper whose call launches two ``__global__`` functions (the MSM
    pair's sort and add, totals and scale) reports each under ``globals``,
    its largest register count and stack and the sums of its spills."""
    lines = []
    for fn, regs, spill in (("msm_bucket_sort_kernel", 40, 0), ("msm_bucket_add_kernel", 168, 8),
                            ("msm_window_reduce_totals_kernel", 170, 0),
                            ("msm_window_reduce_scale_kernel", 130, 4)):
        mangled = f"_ZN12_GLOBAL__N_1{len(fn)}{fn}EPKiS1_"
        lines += [f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {mangled}",
                  f"    {spill} bytes stack frame, {spill} bytes spill stores, "
                  f"{spill} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    got = pk.ptxas_report("\n".join(lines))
    assert got["msm_bucket"]["registers"] == 168
    assert got["msm_bucket"]["spill_store_bytes"] == 8
    assert got["msm_bucket"]["globals"]["msm_bucket_sort_kernel"]["registers"] == 40
    assert got["msm_window_reduce"]["registers"] == 170
    assert got["msm_window_reduce"]["stack_bytes"] == 4
    assert set(got["msm_window_reduce"]["globals"]) == {"msm_window_reduce_totals_kernel",
                                                        "msm_window_reduce_scale_kernel"}
    assert set(got) == {"msm_bucket", "msm_window_reduce"}
