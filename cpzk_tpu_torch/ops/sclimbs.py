"""Batched scalar-field arithmetic mod l on int32 limb tensors (PyTorch,
Barrett).

Port of ``cpzk_tpu/ops/sclimbs.py`` with the same representation and the
same schedule, so results match the JAX package limb for limb.

l = 2^252 + 27742317777372353535851937790883648493 has a 125-bit tail, so
the cheap fold of the GF(2^255 - 19) plane (2^260 = 608 mod p, :mod:`.limbs`)
does not exist here: reduction is a textbook Barrett with the precomputed
reciprocal mu = floor(b^(2K) / l) at limb base b = 2^13, K = 20 limbs.

What it is for: the combined RLC check needs per-row scalar products a*c,
b*a, b*a*c, the inner product sum(a*s) mod l, and window or signed-digit
decompositions of them.  On the host those are Python big-int loops; here
they are ops over ``[20, n]`` int32 tensors in the limb-major layout of the
rest of the data plane.  These are the plain versions of the scalar kernels
in :mod:`.scalar_kernels` (``CPZK_DEVICE_RLC=1`` in :mod:`.backend`).
``reduce_wide`` and ``bytes_wide_to_limbs`` also give the 64-byte wide
challenge reduction (a CUDA tensor goes to the hand-written
``reduce_wide`` kernel of :mod:`.scalar_kernels`); the serving path reduces
challenges on the host.

Representation: values < 2^260 as 20x13-bit limbs (leading limb axis).  All
outputs are fully reduced (< l): the digit and window decompositions need
canonical values.  Two torch pitfalls are guarded against: ``Tensor.sum``
promotes int32 to int64 unless ``dtype`` is given, and ``F.pad`` pads the
last axis first (leading-axis padding is a ``torch.cat`` with zeros here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.scalars import L

NLIMBS = 20          # limbs for one reduced scalar (260 bits >= 253)
LIMB_BITS = 13
MASK = (1 << LIMB_BITS) - 1
K = NLIMBS

#: Barrett reciprocal mu = floor(b^(2K) / l), 41 limbs (b^(2K) = 2^520).
_MU = (1 << (2 * K * LIMB_BITS)) // L

I32 = torch.int32


def _int_to_limbs_np(v: int, width: int) -> np.ndarray:
    out = np.empty(width, dtype=np.int32)
    for i in range(width):
        out[i] = v & MASK
        v >>= LIMB_BITS
    if v:
        raise ValueError("value too wide")
    return out


_L_LIMBS = _int_to_limbs_np(L, NLIMBS)           # [20]
_MU_LIMBS = _int_to_limbs_np(_MU, 2 * K + 1)     # [41]


def _const(values: np.ndarray, like: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    """A limb constant on ``like``'s device, shaped [W, 1, ...] for
    broadcasting against ``batch_ndim`` trailing axes."""
    return torch.from_numpy(values).to(like.device).reshape(
        (len(values),) + (1,) * batch_ndim)


def _rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """x cut or zero-extended along the leading (limb) axis to ``width``."""
    if x.shape[0] >= width:
        return x[:width]
    zeros = torch.zeros((width - x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    return torch.cat([x, zeros], dim=0)


def _carry_strip(x: torch.Tensor, width: int) -> torch.Tensor:
    """Carry-normalize a non-negative limb vector to exactly canonical
    ``width`` limbs in [0, 2^13) (carries beyond ``width`` must be zero by
    the caller's value bound).

    Two parallel widen rounds shrink limbs from < 2^31 to <= 2^13 + 1; a
    final sequential chain makes the form canonical: parallel rounds alone
    can ripple runs of 0x1FFF one limb per round and never settle, and
    :func:`_ge` needs canonical limbs."""
    x = _rows(x, width)
    for _ in range(2):
        lo = x & MASK
        hi = x >> LIMB_BITS
        x = lo + torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], dim=0)
    out = []
    carry = torch.zeros_like(x[0])
    for i in range(width):
        t = x[i] + carry
        carry = t >> LIMB_BITS
        out.append(t & MASK)
    return torch.stack(out, dim=0)


def _mul_raw(a: torch.Tensor, b: torch.Tensor, na: int, nb: int) -> torch.Tensor:
    """Schoolbook [na, ...] x [nb, ...] -> carried [na+nb, ...] product.

    Anti-diagonal sums stay < max(na, nb) * 2^26 < 2^31 for na, nb <= 41,
    so they are exact in int32 (summed with ``dtype=torch.int32``)."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((na,) + tuple(batch))
    b = b.expand((nb,) + tuple(batch))
    outer = a[:, None] * b[None, :]  # [na, nb, ...]
    width = na + nb - 1
    pad = torch.zeros((na, na) + tuple(batch), dtype=outer.dtype, device=outer.device)
    outer = torch.cat([outer, pad], dim=1)  # [na, nb+na, ...]
    # row i of the flat view, cut at width, is a[i] * b shifted right by i
    flat = outer.reshape((na * (nb + na),) + tuple(batch))[: na * width]
    prod = flat.reshape((na, width) + tuple(batch)).sum(dim=0, dtype=I32)
    return _carry_strip(prod, na + nb)


def _ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Limbwise lexicographic a >= b for canonical limb vectors -> [...]."""
    gt = a > b
    lt = a < b
    # the most significant difference decides: scan from the top limb down
    result = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    decided = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    for i in range(a.shape[0] - 1, -1, -1):
        result = result | (~decided & gt[i])
        decided = decided | gt[i] | lt[i]
    return result | ~decided  # equal -> >= holds


def _sub_nonneg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b for a >= b, canonical limbs in and out (sequential borrow)."""
    out = []
    borrow = torch.zeros_like(a[0])
    for i in range(a.shape[0]):
        t = a[i] - (b[i] if i < b.shape[0] else 0) - borrow
        borrow = (t < 0).to(I32)
        out.append(t + borrow * (1 << LIMB_BITS))
    return torch.stack(out, dim=0)


def _cond_sub_l(x: torch.Tensor) -> torch.Tensor:
    """x - l when x >= l (x < 2l, canonical [20, ...] limbs)."""
    lv = _const(_L_LIMBS, x, x.ndim - 1).expand(x.shape)
    need = _ge(x, lv)
    return torch.where(need, _sub_nonneg(x, lv), x)


def reduce_wide(x: torch.Tensor) -> torch.Tensor:
    """x mod l for [W, ...] canonical limbs (W <= 2K, value < b^(2K)) ->
    canonical [20, ...] limbs: the hand-written kernel
    :func:`.scalar_kernels.reduce_wide` for a CUDA tensor, the plain
    :func:`reduce_wide_plain` for a CPU tensor."""
    from . import scalar_kernels

    out = scalar_kernels.reduce_wide(x.reshape(x.shape[0], -1))
    return out.reshape((NLIMBS,) + tuple(x.shape[1:]))


def reduce_wide_plain(x: torch.Tensor) -> torch.Tensor:
    """Barrett: [W, ...] limbs (W <= 2K, value < b^(2K)) -> canonical
    [20, ...] limbs of x mod l.

    q_hat = floor( floor(x / b^(K-1)) * mu / b^(K+1) );  r = x - q_hat*l.
    The classic bound gives r < 3l, so two conditional subtractions finish
    the reduction."""
    batch_ndim = x.ndim - 1
    x = _rows(x, 2 * K)
    x_hi = x[K - 1:]  # floor(x / b^(K-1)), K+1 limbs
    mu = _const(_MU_LIMBS, x, batch_ndim)
    prod = _mul_raw(x_hi, mu, K + 1, 2 * K + 1)      # [3K+2, ...]
    q_hat = prod[K + 1: 2 * K + 2]                   # floor(./b^(K+1)), K+1 limbs
    lv = _const(_L_LIMBS, x, batch_ndim)
    ql = _mul_raw(q_hat, lv, K + 1, NLIMBS)          # [2K+1, ...]
    # r = x - q_hat*l with 0 <= r < 3l < 2^254 fits 20 limbs, so subtracting
    # in a (K+2)-limb window cancels the higher limbs exactly
    r = _sub_nonneg(x[: K + 2], ql[: K + 2])[:K]
    for _ in range(2):  # r < 3l: at most two subtractions
        r = _cond_sub_l(r)
    return r


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Canonical [20, ...] x [20, ...] -> canonical [20, ...] mod l."""
    return reduce_wide_plain(_mul_raw(a, b, NLIMBS, NLIMBS))


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # sum < 2l < 2^254 fits 20 limbs; one conditional subtract finishes
    return _cond_sub_l(_carry_strip(a + b, NLIMBS))


def neg(a: torch.Tensor) -> torch.Tensor:
    """l - a (canonical in and out; 0 maps to 0 by the conditional subtract)."""
    lv = _const(_L_LIMBS, a, a.ndim - 1).expand(a.shape)
    return _cond_sub_l(_sub_nonneg(lv, a))


def sum_mod_l(a: torch.Tensor) -> torch.Tensor:
    """Sum canonical [20, n] scalars over the batch axis -> [20, 1].

    One int32 sum would overflow past n = 2^18 (limb sums reach n * 2^13),
    so the reduction is hierarchical: chunks of 2^15 columns sum exactly
    (< 2^28), each chunk partial carries to canonical form, and the
    partials sum once more (exact up to n = 2^33) before one Barrett
    reduction."""
    chunk = 1 << 15
    n = a.shape[-1]
    if n <= chunk:
        s = a.sum(dim=-1, keepdim=True, dtype=I32)
    else:
        pad = (-n) % chunk
        ap = torch.cat([a, torch.zeros((NLIMBS, pad), dtype=a.dtype, device=a.device)], -1)
        parts = ap.reshape(NLIMBS, -1, chunk).sum(dim=-1, dtype=I32)  # [20, n/2^15]
        parts = _carry_strip(parts, 2 * K)
        s = parts.sum(dim=-1, keepdim=True, dtype=I32)
    s = _carry_strip(s, 2 * K)
    return reduce_wide_plain(s)


def _bits(a: torch.Tensor) -> torch.Tensor:
    """Canonical [20, ...] limbs -> [260, ...] bits, least significant first."""
    batch = tuple(a.shape[1:])
    shifts = torch.arange(LIMB_BITS, dtype=I32, device=a.device).reshape(
        (1, LIMB_BITS) + (1,) * len(batch))
    return ((a[:, None] >> shifts) & 1).reshape((NLIMBS * LIMB_BITS,) + batch)


def to_signed_digits(a: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical [20, ...] limbs -> [K, ...] signed c-bit digits (LSB window
    first), the tensor twin of :func:`.msm.scalars_to_signed_digits`.

    Unsigned c-bit windows come from the bit expansion; the borrow recode
    (digit in [-2^(c-1), 2^(c-1)]) is a K-step carry chain."""
    from .msm import num_windows

    k = num_windows(c)
    batch = tuple(a.shape[1:])
    bits = _rows(_bits(a), k * c)
    w = (1 << torch.arange(c, dtype=I32, device=a.device)).reshape((1, c) + (1,) * len(batch))
    u = (bits.reshape((k, c) + batch) * w).sum(dim=1, dtype=I32)  # [K, ...] unsigned
    half = 1 << (c - 1)
    digits = []
    carry = torch.zeros(batch, dtype=I32, device=a.device)
    for uw in u:
        t = uw + carry
        carry = (t >= half).to(I32)
        digits.append(t - carry * (1 << c))
    return torch.stack(digits, dim=0)


def to_windows(a: torch.Tensor) -> torch.Tensor:
    """Canonical [20, ...] scalar limbs -> [64, ...] 4-bit windows, most
    significant window first (the layout the :mod:`.curve` ladders eat);
    the tensor twin of :func:`.curve.scalars_to_windows`."""
    batch = tuple(a.shape[1:])
    bits = _bits(a)[:256]                               # scalars < 2^253
    w = torch.tensor([1, 2, 4, 8], dtype=I32, device=a.device).reshape((1, 4) + (1,) * len(batch))
    wins = (bits.reshape((64, 4) + batch) * w).sum(dim=1, dtype=I32)  # LSB first
    return torch.flip(wins, dims=[0])                   # MSB first


# -- host conversions (the layout of .limbs) --------------------------------

def ints_to_limbs(values: list[int]) -> np.ndarray:
    """[n] python ints (mod l) -> [20, n] int32 canonical limbs."""
    blob = b"".join((v % L).to_bytes(33, "little") for v in values)
    raw = np.frombuffer(blob, dtype=np.uint8).reshape(len(values), 33)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, : NLIMBS * LIMB_BITS]
    weights = 1 << np.arange(LIMB_BITS, dtype=np.int32)
    rows = bits.reshape(len(values), NLIMBS, LIMB_BITS).astype(np.int32) @ weights
    return np.ascontiguousarray(rows.T)


def bytes_wide_to_limbs(blob: np.ndarray) -> np.ndarray:
    """[n, 64] uint8 (wide challenge bytes) -> [40, n] int32 limbs."""
    raw = np.asarray(blob, dtype=np.uint8).reshape(-1, 64)
    bits = np.unpackbits(raw, axis=1, bitorder="little")
    bits = np.pad(bits, [(0, 0), (0, 40 * LIMB_BITS - 512)])
    weights = 1 << np.arange(LIMB_BITS, dtype=np.int32)
    rows = bits.reshape(len(raw), 40, LIMB_BITS).astype(np.int32) @ weights
    return np.ascontiguousarray(rows.T)


def limbs_to_ints(limbs) -> list[int]:
    arr = np.asarray(limbs.cpu() if isinstance(limbs, torch.Tensor) else limbs)
    arr = arr.reshape(NLIMBS, -1)
    return [
        sum(int(arr[i, j]) << (LIMB_BITS * i) for i in range(NLIMBS))
        for j in range(arr.shape[1])
    ]
