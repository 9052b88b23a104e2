"""The CUDA kernels' field and point arithmetic (``csrc/fe25519.cuh``,
``__host__ __device__``) compiled for the host with g++ through the
test-only ``csrc/host_shim.cpp``, held against the plain PyTorch versions
on random and +-9500 adversarial limbs.  Same schedule, so outputs must be
identical limb for limb (tolerance: exact).  Skips where g++ is missing."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cpzk_tpu_torch.ops import limbs, point_kernels as pk

N = 96
BOUND = limbs.BOUND


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: cannot build the host copy of fe25519.cuh")
    out = tmp_path_factory.mktemp("fe25519") / "libfe25519_host.so"
    src = pk.CSRC / "host_shim.cpp"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", str(src), "-o", str(out)],
                   check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.host_d2.argtypes = [P]
    lib.host_fe_op.argtypes = [I, P, P, P, I, I]
    lib.host_point_add.argtypes = [P] * 12 + [I]
    lib.host_point_double_k.argtypes = [P] * 7 + [I, I]
    for fn in (lib.host_d2, lib.host_fe_op, lib.host_point_add, lib.host_point_double_k):
        fn.restype = None
    return lib


def limb_inputs(seed, count):
    """count [20, N] int32 tensors: uniform in [-9500, 9500], with the four
    adversarial patterns of tests/test_ops_limbs.py in the first lanes."""
    rng = np.random.default_rng(seed)
    adv = np.stack([
        np.full(20, BOUND), np.full(20, -BOUND),
        np.asarray([BOUND if i % 2 else -BOUND for i in range(20)]),
        np.asarray([-BOUND] + [BOUND] * 19),
    ], axis=-1).astype(np.int32)
    out = []
    for k in range(count):
        a = rng.integers(-BOUND, BOUND + 1, size=(20, N)).astype(np.int32)
        a[:, :4] = np.roll(adv, k, axis=1)
        out.append(torch.from_numpy(a))
    return out


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def empty():
    return torch.empty((20, N), dtype=torch.int32)


def test_d2_constant_matches(host_lib):
    d2 = torch.empty(20, dtype=torch.int32)
    host_lib.host_d2(ptr(d2))
    assert torch.equal(d2, limbs.D2[:, 0])


@pytest.mark.parametrize("op", ["mul", "add", "sub", "mul_small"])
def test_field_ops_match_plain(host_lib, op):
    a, b = limb_inputs(1, 2)
    code, plain = {
        "mul": (0, lambda: limbs.mul(a, b)),
        "add": (1, lambda: limbs.add(a, b)),
        "sub": (2, lambda: limbs.sub(a, b)),
        "mul_small": (3, lambda: limbs.mul_small(a, 2)),
    }[op]
    out = empty()
    host_lib.host_fe_op(code, ptr(a), ptr(b), ptr(out), N, 2)
    assert torch.equal(out, plain())
    assert int(out.abs().max()) <= BOUND


def test_point_add_matches_plain(host_lib):
    coords = limb_inputs(2, 8)
    outs = [empty() for _ in range(4)]
    host_lib.host_point_add(*(ptr(c) for c in coords + outs), N)
    ref = pk.point_add_plain(tuple(coords[:4]), tuple(coords[4:]))
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)
        assert int(o.abs().max()) <= BOUND


@pytest.mark.parametrize("k", [1, 4])
def test_point_double_k_matches_plain(host_lib, k):
    coords = limb_inputs(3, 3)
    outs = [empty() for _ in range(4)]
    host_lib.host_point_double_k(*(ptr(c) for c in coords + outs), N, k)
    ref = pk.point_double_k_plain(tuple(coords) + (coords[0],), k)
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)
        assert int(o.abs().max()) <= BOUND
