"""The test-only host build of the kernels' ``__host__ __device__`` bodies
(``cpzk_tpu_torch/csrc/host_shim.cpp``, compiled with g++) and the ctypes
signatures of its entry points, for the tests that run those bodies on the
CPU (``tests/test_torch_kernel_host.py``, ``tests/test_torch_keccak.py``)."""

import ctypes
import shutil
import subprocess

import pytest

from cpzk_tpu_torch.ops import point_kernels as pk


def build(tmp_path_factory) -> ctypes.CDLL:
    """Compile the shim into a temporary directory and load it; skips the
    calling test where g++ is missing."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: cannot build the host copy of the kernels' bodies")
    out = tmp_path_factory.mktemp("host_shim") / "libcpzk_host_shim.so"
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
    lib.host_sc_op.argtypes = [I, P_, P_, P_, I]
    lib.host_reduce_wide.argtypes = [P_, I, P_, I]
    lib.host_sc_windows.argtypes = [P_, P_, I]
    lib.host_sc_signed_digits.argtypes = [P_, I, I, P_, I]
    lib.host_scalar_recode.argtypes = [P_] * 6 + [I] * 6 + [P_]
    lib.host_msm_bucket.argtypes = [P_] * 9 + [I] * 5
    lib.host_msm_window_reduce.argtypes = [P_] * 8 + [I] * 4
    lib.host_quad_double_k.argtypes = [P_] * 7 + [I, I]
    lib.host_quad_add.argtypes = [P_] * 12 + [I]
    lib.host_fe_is_negative.argtypes = [P_, P_, I]
    lib.host_fe_sqrt_ratio_m1.argtypes = [P_] * 4 + [I]
    lib.host_ristretto_encode.argtypes = [P_] * 5 + [I]
    lib.host_ristretto_decode.argtypes = [P_] * 3 + [I]
    lib.host_fe10_op.argtypes = [I, P_, P_, P_, I]
    lib.host_comb_tables.argtypes = [P_] * 5
    lib.host_commitments.argtypes = [P_] * 5 + [I]
    lib.host_comb_recode.argtypes = [P_, P_, I]
    lib.host_keccak_chain.argtypes = [P_, P_, I, P_, P_, I, I, P_, P_]
    lib.host_ladder_table.argtypes = [P_, P_, I]
    lib.host_ladder_steps.argtypes = [P_, P_, P_, I, I, P_, I]
    lib.host_ladder_is_identity.argtypes = [P_, P_, I]
    lib.host_ladder_combined.argtypes = [P_, P_, P_, P_, I, I]
    lib.host_ladder_partials_identity.argtypes = [P_, P_, I]
    lib.host_rlc_scalars.argtypes = [P_] * 9 + [I] * 2
    lib.host_ladder_each.argtypes = [P_, P_, P_, P_, I, I]
    lib.host_quad_add_cached.argtypes = [P_] * 4 + [I]
    for fn in (lib.host_d2, lib.host_to_words, lib.host_fe_op, lib.host_point_add,
               lib.host_point_double_k, lib.host_sc_op, lib.host_reduce_wide,
               lib.host_sc_windows, lib.host_sc_signed_digits, lib.host_msm_bucket,
               lib.host_msm_window_reduce, lib.host_quad_double_k,
               lib.host_quad_add, lib.host_fe_is_negative,
               lib.host_fe_sqrt_ratio_m1, lib.host_ristretto_encode,
               lib.host_ristretto_decode, lib.host_fe10_op, lib.host_scalar_recode,
               lib.host_comb_tables,
               lib.host_commitments, lib.host_comb_recode, lib.host_keccak_chain,
               lib.host_ladder_table, lib.host_ladder_steps, lib.host_ladder_is_identity,
               lib.host_ladder_combined,
               lib.host_ladder_partials_identity, lib.host_ladder_each, lib.host_rlc_scalars,
               lib.host_quad_add_cached):
        fn.restype = None
    return lib


