"""The hand-written CUDA Keccak kernel of the device Fiat-Shamir
derivation, its wrapper, its plain PyTorch version and its launch counter.

=================  ==========================================================
kernel             replaces
=================  ==========================================================
``keccak_chain``   ``cpzk_tpu/ops/challenge.py::_absorb_permute_chain`` (and
                   ``cpzk_tpu/ops/keccak.py::keccak_f1600``: one mask of
                   zeros)
=================  ==========================================================

Sources: ``csrc/keccak_u64.cuh`` (the permutation and the absorb chain of
one row on the 32-bit halves of its 25 lanes, ``__host__ __device__``) and
``csrc/keccak_ops.cu`` (the kernel and its C launch interface), built into
the package's kernel library by :func:`.point_kernels.library`.

The wrapper takes and returns the reference's tensors: the state as (hi,
lo) ``[25, n]`` int32 words (or ``[25, 1]``, one state for every row) and
the masks as ``[k, 25, n]``; so kernel and plain version compare with
``torch.equal``.  Two neighbouring threads of a warp own a row, one the lo
and one the hi words of its 25 lanes, in registers through all k
permutations; a rotation takes the other half by a warp shuffle, and the
next mask is loaded while the current permutation runs.  What bounds it on
an H100: :func:`keccak_chain_work` counts the bytes and int32 operations
(it is bound by operations); ``PERF.md`` holds the measured times.

Routing: the wrapper runs the plain version for tensors on the CPU and
launches its kernel for CUDA tensors; any other device raises, and a failed
launch raises.  There is no fallback from a CUDA tensor to the plain
version.
"""

from __future__ import annotations

import torch

from . import keccak
from .point_kernels import _check, count_launch, library, on_card

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"keccak_chain": 0}

#: int32 operations of one Keccak-f[1600] permutation of one row, the least
#: the card needs on 32-bit halves: a round's theta takes 2 three-input XORs
#: a column half (20) and a rotation by one of each column parity (5 x 2
#: funnel shifts), and folds both into every lane half with one three-input
#: XOR (50); rho rotates 24 lanes (2 funnel shifts each; no offset is 32);
#: chi is one three-input logic op a lane half (50); iota 2 XORs.
KECCAK_ROUND_OPS = 20 + 10 + 50 + 24 * 2 + 50 + 2
KECCAK_F_OPS = 24 * KECCAK_ROUND_OPS
#: one absorb step: the mask XOR (50) and the permutation
CHAIN_STEP_OPS = 50 + KECCAK_F_OPS


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def keccak_chain_work(n: int, k: int, shared_state: bool) -> tuple[int, int]:
    """(bytes, int32 operations) of one ``keccak_chain`` over n rows and k
    masks: the state read once (200 bytes, or 200 a row), k masks of 200
    bytes a row, and the state written once."""
    state = 200 if shared_state else 200 * n
    return state + 200 * k * n + 200 * n, CHAIN_STEP_OPS * k * n


def keccak_chain_plain(s_hi, s_lo, m_hi, m_lo):
    """state XOR mask j and permute, for each of the ``[k, 25, n]`` masks, as
    ``_absorb_permute_chain`` computes it."""
    n = m_hi.shape[-1]
    hi, lo = s_hi.expand(25, n), s_lo.expand(25, n)
    for j in range(m_hi.shape[0]):
        hi, lo = keccak.keccak_f1600((hi ^ m_hi[j], lo ^ m_lo[j]))
    return hi, lo


def keccak_chain(s_hi, s_lo, m_hi, m_lo):
    """The absorb chain: (hi, lo) ``[25, n]`` (or ``[25, 1]``) int32 state,
    ``[k, 25, n]`` int32 masks -> the ``[25, n]`` state after k steps."""
    tensors = (s_hi, s_lo, m_hi, m_lo)
    device = s_hi.device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"keccak_chain: tensors on {t.device} and {device}")
        if t.dtype != torch.int32:
            raise ValueError(f"keccak_chain: int32 words, got {t.dtype}")
    if m_hi.ndim != 3 or m_hi.shape[1] != 25 or m_lo.shape != m_hi.shape:
        raise ValueError(f"keccak_chain: masks must be [k, 25, n], got {tuple(m_hi.shape)}")
    k, _, n = m_hi.shape
    if s_hi.shape != s_lo.shape or s_hi.shape not in ((25, n), (25, 1)):
        raise ValueError(f"keccak_chain: state must be [25, {n}] or [25, 1], "
                         f"got {tuple(s_hi.shape)}")
    if not on_card("keccak_chain", device):
        return keccak_chain_plain(s_hi, s_lo, m_hi, m_lo)
    if n < 1:
        raise ValueError("keccak_chain needs at least one row")
    s_hi, s_lo, m_hi, m_lo = (t.contiguous() for t in tensors)
    out = [torch.empty((25, n), dtype=torch.int32, device=device) for _ in range(2)]
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_keccak_chain(s_hi.data_ptr(), s_lo.data_ptr(), int(s_hi.shape[1] != n),
                                   m_hi.data_ptr(), m_lo.data_ptr(), k, n,
                                   out[0].data_ptr(), out[1].data_ptr(), stream)
    _check(rc, "keccak_chain")
    count_launch(LAUNCHES, "keccak_chain")
    return out[0], out[1]


def keccak_f1600(state: keccak.State) -> keccak.State:
    """One permutation of a ``[25, n]`` (hi, lo) state: :func:`keccak_chain`
    with one mask of zeros (the kernel on CUDA tensors, the plain
    :func:`.keccak.keccak_f1600` on the CPU)."""
    hi, lo = state
    zero = torch.zeros((1,) + tuple(hi.shape), dtype=torch.int32, device=hi.device)
    return keccak_chain(hi, lo, zero, zero)
