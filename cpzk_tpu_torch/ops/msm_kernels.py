"""The two hand-written CUDA kernels of the signed-digit Pippenger MSM, their
wrappers, their launch counters and the bound arithmetic; the plain
versions are :func:`.msm.bucket_sums_plain` and
:func:`.msm.window_reduce_plain`.

=====================  ======================================================
kernel                 replaces
=====================  ======================================================
``msm_bucket``         the bucket sums of ``cpzk_tpu/ops/msm.py::_window_sum``
                       (every window of ``msm_kernel``)
``msm_window_reduce``  the suffix scan and tree sum of ``::_window_sum`` and
                       the Horner step of ``::msm_kernel``
=====================  ======================================================

Sources: ``csrc/msm_w32.cuh`` (the thread bodies, ``__host__ __device__``)
and ``csrc/msm_ops.cu`` (the kernels and their C launch interface), on the
point arithmetic of ``csrc/fe25519_w32.cuh``, built into the package's
kernel library by :func:`.point_kernels.library`.

Design (PERF.md, section 6, has the times).  ``msm_bucket`` is two
``__global__`` launches a call.  The first, one block per window, turns
the chunk's points once into the add's cached form, 32 contiguous words
each, and sorts the window's digits by bucket (a counting sort:
histogram, scan, scatter of the signed term entries; the empty buckets
stored as the identity).  The second, a grid of (part, window), splits
each window's sorted entries evenly over its blocks and their threads: a
thread adds its run of entries in order and stores a bucket at each
change, and the pieces of a bucket that spans runs or blocks are joined
by a segmented reduction of log depth (the last block of a window joins
the blocks').  So every thread adds about the same number of points
whatever the digits, and a bucket that holds every term costs about what
random digits cost.  ``msm_window_reduce`` is two launches too: one block
per window forms ``sum_j j B_j`` from segments of buckets, a suffix scan
and a tree sum in shared memory; then one block multiplies each window
total by 2^(c w) and sums them in a tree.  In both, a quad of lanes
shares every add and doubling four ways.  The buckets pass between the
two kernels as ``[20, K, 2^(c-1)]`` limb tensors, bucket j of a window at
index j - 1.  Outputs are group elements equal to the plain version's;
the order of the adds differs (and within a bucket follows the sort's
atomics), so the limbs may differ (compare encodings).

What bounds them on an H100: ``msm_bucket`` the adds of cached points
that the digits need, one fewer than a bucket's terms (int32 operations,
:func:`msm_bucket_work`; the sort's traffic is not counted);
``msm_window_reduce`` two adds a bucket and the doublings
(:func:`msm_window_reduce_work`), but in time the chain of c (k - 1)
doublings of the top window, one after another, which the quads shorten
and no schedule of this algorithm removes.  ``cpzk_msm_quad_chain`` in the
library runs that chain alone on one warp's quads, to time it; no wrapper
launches it.

Routing: each wrapper runs the plain version for tensors on the CPU and
launches its kernel for CUDA tensors; any other device raises, and a failed
launch raises.
"""

from __future__ import annotations

import torch

from .limbs import NLIMBS
from .point_kernels import (
    ADD_OPS_PER_LANE, LINEAR_OPS, MUL_OPS, W32_LINEAR_OPS, W32_MUL_OPS, _check, _lanes,
    count_launch, double_k_ops_per_lane, library, on_card)

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernels (one call, the
#: ``__global__`` launches of :data:`GLOBALS`) and nowhere else.
LAUNCHES = {"msm_bucket": 0, "msm_window_reduce": 0}

#: ``__global__`` launches of one wrapper call (the CUDA names in
#: ``csrc/msm_ops.cu``)
GLOBALS = {"msm_bucket": ("msm_bucket_sort_kernel", "msm_bucket_add_kernel"),
           "msm_window_reduce": ("msm_window_reduce_totals_kernel",
                                 "msm_window_reduce_scale_kernel")}

#: bytes of one point's four coordinates as [20] int32 limbs each
POINT_BYTES = 4 * NLIMBS * 4

#: int32 operations (the fewer of the two schedules' counts, as
#: :data:`.point_kernels.ADD_OPS_PER_LANE`) of a point's cached form
#: (Y - X, Y + X, 2d T, 2 Z: a multiply and three linear ops), of adding a
#: cached point (8 multiplies and 6 linear ops) and of negating one (one)
CACHED_OPS = min(MUL_OPS + 3 * LINEAR_OPS, W32_MUL_OPS + 3 * W32_LINEAR_OPS)
CACHED_ADD_OPS = min(8 * MUL_OPS + 6 * LINEAR_OPS, 8 * W32_MUL_OPS + 6 * W32_LINEAR_OPS)
NEGATE_OPS = min(LINEAR_OPS, W32_LINEAR_OPS)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def msm_bucket_work(digits: torch.Tensor, c: int) -> tuple[int, int]:
    """(bytes, int32 operations) of ``msm_bucket`` on these digits: the m
    points and the [K, m] digits read once and the K 2^(c-1) buckets
    written once; what this data needs of the operations: a bucket of n
    terms n - 1 adds of cached points (its first term starts it), the
    cached form of every point with a non-zero digit, and a negation per
    negative digit."""
    k, m = digits.shape
    nz = digits != 0
    buckets = digits.abs().to(torch.int64) + (1 << c) * torch.arange(
        k, dtype=torch.int64, device=digits.device)[:, None]
    adds = int(nz.sum()) - int(torch.unique(buckets[nz]).numel())
    ops = (adds * CACHED_ADD_OPS + int(nz.any(0).sum()) * CACHED_OPS
           + int((digits < 0).sum()) * NEGATE_OPS)
    return POINT_BYTES * m + 4 * k * m + POINT_BYTES * k * (1 << (c - 1)), ops


def msm_window_reduce_work(k: int, c: int) -> tuple[int, int]:
    """(bytes, int32 operations) of ``msm_window_reduce``: the buckets read
    and one point written; 2 adds a bucket (the running sums), then Horner:
    k times c doublings and an add."""
    nb = 1 << (c - 1)
    return (POINT_BYTES * (k * nb + 1),
            (2 * k * nb + k) * ADD_OPS_PER_LANE + k * double_k_ops_per_lane(c))


def msm_bucket(points, digits: torch.Tensor, c: int):
    """The bucket sums of every window: ``[20, m]`` x 4 points and ``[K, m]``
    int32 signed c-bit digits -> ``[20, K, 2^(c-1)]`` x 4 points."""
    if not 2 <= c <= 16:
        raise ValueError(f"msm_bucket: window size {c} outside 2..16")
    if not on_card("msm_bucket", digits.device):
        from .msm import bucket_sums_plain

        return bucket_sums_plain(points, digits, c)
    flat, shape = _lanes(list(points), digits.device)
    if digits.dtype != torch.int32 or digits.ndim != 2 or len(shape) != 2 \
            or digits.shape[1] != shape[1]:
        raise ValueError(f"msm_bucket: digits {digits.dtype} {tuple(digits.shape)} "
                         f"do not fit points {shape}")
    k, m = digits.shape
    nb = 1 << (c - 1)
    digits = digits.contiguous()
    out = [torch.empty((NLIMBS, k * nb), dtype=torch.int32, device=digits.device)
           for _ in range(4)]
    lib = library()
    with torch.cuda.device(digits.device):
        words = lib.cpzk_msm_bucket_scratch(m, k, c)
        if words < 0:
            raise ValueError(f"msm_bucket: {m} terms x {k} windows is too large")
        # the points' words, the sorted entries and the blocks' pieces
        scratch = torch.empty((words,), dtype=torch.int32, device=digits.device)
        stream = torch.cuda.current_stream(digits.device).cuda_stream
        rc = lib.cpzk_msm_bucket(*(f.data_ptr() for f in flat), digits.data_ptr(),
                                 scratch.data_ptr(), *(o.data_ptr() for o in out), m, k, c,
                                 stream)
    _check(rc, "msm_bucket")
    count_launch(LAUNCHES, "msm_bucket")
    return tuple(o.reshape(NLIMBS, k, nb) for o in out)


def msm_window_reduce(buckets, c: int):
    """``[20, K, 2^(c-1)]`` x 4 bucket sums -> the ``[20, 1]`` x 4 MSM
    result: per window W_w = sum_j j bucket_j, then sum_w 2^(c w) W_w."""
    if not 2 <= c <= 16:
        raise ValueError(f"msm_window_reduce: window size {c} outside 2..16")
    device = buckets[0].device
    if not on_card("msm_window_reduce", device):
        from .msm import window_reduce_plain

        return window_reduce_plain(buckets, c)
    nb = 1 << (c - 1)
    k = buckets[0].shape[1]
    for b in buckets:
        if b.dtype != torch.int32 or b.device != device or tuple(b.shape) != (NLIMBS, k, nb):
            raise ValueError(f"msm_window_reduce: buckets must be [20, K, {nb}] int32 "
                             f"on {device}, got {b.dtype} {tuple(b.shape)} on {b.device}")
    flat = [b.contiguous() for b in buckets]
    out = [torch.empty((NLIMBS, 1), dtype=torch.int32, device=device) for _ in range(4)]
    # the k window totals, 32 words each
    scratch = torch.empty((k * 32,), dtype=torch.int32, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_msm_window_reduce(*(f.data_ptr() for f in flat), scratch.data_ptr(),
                                        *(o.data_ptr() for o in out), k, c, stream)
    _check(rc, "msm_window_reduce")
    count_launch(LAUNCHES, "msm_window_reduce")
    return tuple(out)
