"""Windowed signed-digit Pippenger multi-scalar multiplication (PyTorch).

Port of ``cpzk_tpu/ops/msm.py``: ``sum_i scalar_i * P_i`` over a batch of
(point, scalar) pairs; the combined RLC check over 4n+2 terms is one such
MSM (:func:`.backend.chunked_msm_identity`).

Scalars arrive as ``[K, m]`` signed c-bit digits (LSB window first, digits
in [-2^(c-1), 2^(c-1)]), so a window has 2^(c-1) non-zero buckets and a
point is negated for a negative digit.  The result is Horner over the
windows, most significant first: ``acc = double_k(acc, c) + W_w`` with
``W_w = sum_j j * bucket_j``.

Two implementations of one function:

- on a CUDA tensor, :func:`msm_kernel` runs the two CUDA kernels of
  :mod:`.msm_kernels`: the bucket sums (``msm_bucket``), then the window
  totals and their sum, each scaled by 2^(c w) (``msm_window_reduce``; the
  same point as Horner's);
- on a CPU tensor, the plain version, which transcribes the reference's
  TPU formulation: per window a stable ``argsort`` of |digit|, an
  inclusive prefix scan of point adds, bucket sums as differences of the
  prefix at the ``searchsorted(right=True)`` boundaries, a reversed suffix
  scan over the buckets and a tree sum.  Its adds and doublings are
  :func:`.point_kernels.point_add_plain` and ``point_double_k_plain``, so on
  a card it shares no arithmetic with the kernels it is held against.

Layout: ``[20, m]`` limb-major coordinates, ``[K, m]`` digits; every input
is public verification data, so data-dependent order is fine.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import curve, limbs, msm_kernels
from .point_kernels import on_card, point_add_plain, point_double_k_plain

Point = curve.Point


def pick_window(m: int) -> int:
    """Static window size minimizing ~K(c) * (2m + 3 * 2^(c-1)), the
    reference's cost model (not measured on the H100).

    ``CPZK_MSM_WINDOW`` (4..16) overrides the cost model."""
    override = os.environ.get("CPZK_MSM_WINDOW")
    if override:
        c = int(override)
        if not 4 <= c <= 16:
            raise ValueError(f"CPZK_MSM_WINDOW={c} outside 4..16")
        return c
    best_c, best_cost = 4, float("inf")
    for c in range(4, 17):
        cost = num_windows(c) * (2 * m + 3 * (1 << (c - 1)))
        if cost < best_cost:
            best_c, best_cost = c, cost
    return best_c


def num_windows(c: int) -> int:
    """Window count for signed-digit recoding (one extra for the carry)."""
    return -(-253 // c) + 1


def scalars_to_signed_digits(values: list[int], c: int) -> np.ndarray:
    """Host: scalars (mod l) -> [K, m] int32 signed c-bit digits, LSB window
    first; digit k weighs 2^(c k), digits in [-2^(c-1), 2^(c-1)]."""
    k = num_windows(c)
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    raw = np.frombuffer(blob, dtype=np.uint8).reshape(len(values), 32)
    bits = np.unpackbits(raw, axis=1, bitorder="little")  # [m, 256]
    bits = np.pad(bits, [(0, 0), (0, k * c - 256)]) if k * c > 256 else bits[:, : k * c]
    weights = (1 << np.arange(c, dtype=np.int64))
    u = bits.reshape(len(raw), k, c).astype(np.int64) @ weights  # [m, K] unsigned
    digits = np.empty((k, len(raw)), dtype=np.int32)
    carry = np.zeros(len(raw), dtype=np.int64)
    half = 1 << (c - 1)
    for w in range(k):
        t = u[:, w] + carry
        wrap = t >= half
        digits[w] = np.where(wrap, t - (1 << c), t).astype(np.int32)
        carry = wrap.astype(np.int64)
    if carry.any():
        raise ValueError("signed-digit recode overflow (scalar >= 2^(cK-1))")
    return digits


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _negate(p: Point) -> Point:
    X, Y, Z, T = p
    return (limbs.neg(X), Y, Z, limbs.neg(T))


def _scan(p: Point) -> Point:
    """Inclusive prefix sum of points along the last axis (log-depth
    Hillis-Steele rounds of plain adds)."""
    n = p[0].shape[-1]
    s = 1
    while s < n:
        q = point_add_plain(tuple(c[..., s:] for c in p), tuple(c[..., :-s] for c in p))
        p = tuple(torch.cat([c[..., :s], qc], dim=-1) for c, qc in zip(p, q))
        s *= 2
    return p


def _tree_sum(p: Point) -> Point:
    """Sum of points along the last axis by halving (identity-padded to a
    power of two); keeps the axis with size 1."""
    n = p[0].shape[-1]
    size = 1
    while size < n:
        size *= 2
    if size != n:
        pad = curve.identity(tuple(p[0].shape[1:-1]) + (size - n,), p[0].device)
        p = tuple(torch.cat([c, pc], dim=-1) for c, pc in zip(p, pad))
    while p[0].shape[-1] > 1:
        half = p[0].shape[-1] // 2
        p = point_add_plain(tuple(c[..., :half] for c in p), tuple(c[..., half:] for c in p))
    return p


def _window_buckets(points: Point, digits: torch.Tensor, n_buckets: int) -> Point:
    """The bucket sums of every window: ``[20, K, n_buckets - 1]`` points,
    bucket j (1 <= j < n_buckets) at index j - 1, by sort + prefix scan +
    boundary differences (the reference's ``_window_sum``, batched over
    the K windows)."""
    a = digits.abs()
    perm = torch.argsort(a, dim=-1, stable=True)              # [K, m]
    a_sorted = torch.gather(a, -1, perm)
    d_sorted = torch.gather(digits, -1, perm)
    pts = tuple(c[:, perm] for c in points)                   # [20, K, m]
    # sign and zero-digit handling on the sorted lanes
    neg = d_sorted < 0
    pts = (torch.where(neg, -pts[0], pts[0]), pts[1], pts[2], torch.where(neg, -pts[3], pts[3]))
    pts = curve.select(a_sorted == 0, curve.identity(tuple(a_sorted.shape), a.device), pts)
    prefix = _scan(pts)
    ident = curve.identity(tuple(a_sorted.shape[:-1]) + (1,), a.device)
    prefix_ext = tuple(torch.cat([i1, c], dim=-1) for i1, c in zip(ident, prefix))  # [20, K, m+1]
    # boundary lanes: idx[j] = count(|d| <= j); bucket_j = P[idx[j]] - P[idx[j-1]]
    values = torch.arange(n_buckets, device=a.device).expand(a.shape[0], n_buckets)
    idx = torch.searchsorted(a_sorted.to(torch.int64).contiguous(), values.contiguous(),
                             right=True)                      # [K, n_buckets]
    gather_idx = idx[None].expand((limbs.NLIMBS,) + tuple(idx.shape))
    at = tuple(torch.gather(c, -1, gather_idx) for c in prefix_ext)
    ends = tuple(c[..., 1:] for c in at)
    starts = tuple(c[..., :-1] for c in at)
    return point_add_plain(ends, _negate(starts))


def _window_totals(buckets: Point) -> Point:
    """``[20, K, B]`` buckets -> ``[20, K, 1]``: sum_j j * bucket_j, as the
    sum of the reversed suffix scan over the bucket axis."""
    flipped = tuple(torch.flip(c, dims=[-1]) for c in buckets)
    suffix = tuple(torch.flip(c, dims=[-1]) for c in _scan(flipped))
    return _tree_sum(suffix)


def bucket_sums_plain(points: Point, digits: torch.Tensor, c: int) -> Point:
    """Plain version of ``msm_bucket``: ``[20, m]`` points and ``[K, m]``
    digits -> ``[20, K, 2^(c-1)]`` bucket sums."""
    return _window_buckets(points, digits, (1 << (c - 1)) + 1)


def window_reduce_plain(buckets: Point, c: int) -> Point:
    """Plain version of ``msm_window_reduce``: ``[20, K, 2^(c-1)]`` bucket
    sums -> the ``[20, 1]`` MSM result by Horner over the windows, most
    significant first."""
    totals = _window_totals(buckets)                          # [20, K, 1]
    acc = curve.identity((1,), buckets[0].device)
    for w in range(buckets[0].shape[1] - 1, -1, -1):
        acc = point_double_k_plain(acc, c)
        acc = point_add_plain(acc, tuple(t[:, w] for t in totals))
    return acc


def msm_kernel_plain(points: Point, digits: torch.Tensor, c: int) -> Point:
    return window_reduce_plain(bucket_sums_plain(points, digits, c), c)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def msm_kernel(points: Point, digits: torch.Tensor, c: int) -> Point:
    """sum_i scalar_i * P_i -> one point (``[20, 1]`` coordinates).

    ``points``: ``[20, m]`` x 4; ``digits``: ``[K, m]`` signed c-bit digits
    (from :func:`scalars_to_signed_digits` or the device recode).  A CUDA
    tensor runs the two CUDA kernels, a CPU tensor the plain version; any
    other device raises."""
    if not on_card("msm_kernel", digits.device):
        return msm_kernel_plain(points, digits, c)
    return msm_kernels.msm_window_reduce(msm_kernels.msm_bucket(points, digits, c), c)


def msm_is_identity_kernel(points: Point, digits: torch.Tensor, c: int) -> torch.Tensor:
    """Combined-check entry: MSM == identity -> ``[1]`` bool."""
    return curve.is_identity(msm_kernel(points, digits, c))
