"""Batched Keccak-f[1600] as plain PyTorch on (hi, lo) int32 lane pairs.

Port of ``cpzk_tpu/ops/keccak.py``: each Keccak lane is an (hi, lo) pair of
int32 words and a state is two ``[25, ...batch]`` int32 tensors, lane index
x + 5y as in the host oracle (:mod:`cpzk_tpu_torch.core.keccak`).  64-bit XOR
is two 32-bit XORs; a rotation is cross-word shifts on the pair (a rotation
by 32 swaps the words).  The reference leans on int32 ``<<`` wrapping mod
2^32; here a left shift runs in int64 and is masked back to 32 bits, so no
step depends on signed overflow.  Bit for bit with the JAX version
(``tests/test_torch_keccak.py``).

This is the plain version of the card's permutation: the absorb chain of
the device challenges runs as the hand-written
:func:`.keccak_kernels.keccak_chain` on CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import keccak as host_keccak

_RHO = host_keccak._RHO
_RC = host_keccak._ROUND_CONSTANTS

State = tuple[torch.Tensor, torch.Tensor]  # (hi, lo) each [25, ...] int32

_WORD = (1 << 32) - 1

#: the round constants as (hi, lo) int32 pairs, [24, 2]
RC_PAIRS = np.array(
    [[(rc >> 32) & _WORD, rc & _WORD] for rc in _RC], dtype=np.uint32
).astype(np.int32)


def _shl(x: torch.Tensor, n: int) -> torch.Tensor:
    """x << n mod 2^32 for int32 words, computed in int64 and folded back to
    the int32 with the same 32 bits."""
    y = (x.to(torch.int64) << n) & _WORD
    return (y - ((y >> 31) << 32)).to(torch.int32)


def _rotl(hi: torch.Tensor, lo: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """64-bit rotate-left by a static n on (hi, lo) int32 pairs; ``>>`` on
    int32 is arithmetic, so the logical shift masks its result."""
    n %= 64
    if n == 0:
        return hi, lo
    if n == 32:
        return lo, hi
    if n > 32:
        hi, lo = lo, hi
        n -= 32
    m = (1 << n) - 1
    rhi = _shl(hi, n) | ((lo >> (32 - n)) & m)
    rlo = _shl(lo, n) | ((hi >> (32 - n)) & m)
    return rhi, rlo


def _round(ahi: list, alo: list, rc_hi: int, rc_lo: int) -> tuple[list, list]:
    """One Keccak round on unstacked (hi, lo) lane lists."""
    # theta
    chi = [ahi[x] ^ ahi[x + 5] ^ ahi[x + 10] ^ ahi[x + 15] ^ ahi[x + 20] for x in range(5)]
    clo = [alo[x] ^ alo[x + 5] ^ alo[x + 10] ^ alo[x + 15] ^ alo[x + 20] for x in range(5)]
    for x in range(5):
        rh, rl = _rotl(chi[(x + 1) % 5], clo[(x + 1) % 5], 1)
        dh, dl = chi[(x + 4) % 5] ^ rh, clo[(x + 4) % 5] ^ rl
        for y in range(5):
            ahi[x + 5 * y] = ahi[x + 5 * y] ^ dh
            alo[x + 5 * y] = alo[x + 5 * y] ^ dl
    # rho + pi
    bhi: list = [None] * 25
    blo: list = [None] * 25
    for x in range(5):
        for y in range(5):
            src = x + 5 * y
            dst = y + 5 * ((2 * x + 3 * y) % 5)
            bhi[dst], blo[dst] = _rotl(ahi[src], alo[src], _RHO[src])
    # chi
    for y in range(5):
        row_h = bhi[5 * y: 5 * y + 5]
        row_l = blo[5 * y: 5 * y + 5]
        for x in range(5):
            ahi[x + 5 * y] = row_h[x] ^ (~row_h[(x + 1) % 5] & row_h[(x + 2) % 5])
            alo[x + 5 * y] = row_l[x] ^ (~row_l[(x + 1) % 5] & row_l[(x + 2) % 5])
    # iota
    ahi[0] = ahi[0] ^ rc_hi
    alo[0] = alo[0] ^ rc_lo
    return ahi, alo


def keccak_f1600(state: State) -> State:
    """One Keccak-f[1600] permutation over a batched (hi, lo) state, each
    ``[25, ...batch]`` int32."""
    hi, lo = state
    ahi, alo = list(hi.unbind(0)), list(lo.unbind(0))
    for rc_hi, rc_lo in RC_PAIRS.tolist():
        ahi, alo = _round(ahi, alo, rc_hi, rc_lo)
    return torch.stack(ahi, dim=0), torch.stack(alo, dim=0)


# ---------------------------------------------------------------------------
# host <-> device state conversion (for tests and absorb phases)
# ---------------------------------------------------------------------------

def lanes_to_state(lanes: np.ndarray, device) -> State:
    """[n, 25] uint64 lane values -> (hi, lo) [25, n] int32 on ``device``."""
    lanes = np.asarray(lanes, dtype=np.uint64).T  # [25, n]
    hi = (lanes >> np.uint64(32)).astype(np.uint32).astype(np.int32)
    lo = (lanes & np.uint64(_WORD)).astype(np.uint32).astype(np.int32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def state_to_lanes(state: State) -> np.ndarray:
    """(hi, lo) [25, n] -> [n, 25] uint64 lane values on the host."""
    hi = state[0].cpu().numpy().astype(np.uint32).astype(np.uint64)
    lo = state[1].cpu().numpy().astype(np.uint32).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).T


__all__ = ["State", "keccak_f1600", "lanes_to_state", "state_to_lanes"]
