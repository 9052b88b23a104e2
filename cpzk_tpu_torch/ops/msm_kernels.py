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

``msm_bucket`` runs one thread per (window, bucket): a block stages tiles
of its window's digits in shared memory, each thread lists the terms of
its bucket and then adds their points (negated for a negative digit), so a
warp runs its adds together.  ``msm_window_reduce`` runs one block per
window: each thread walks a segment of buckets with two running sums,
thread 0 joins the segments, and the last block runs Horner over the
windows into one ``[20, 1]`` point.  The buckets pass between the two as
``[20, K, 2^(c-1)]`` limb tensors, bucket j of a window at index j - 1.
Outputs are group elements equal to the plain version's; the order of the
adds differs, so the limbs may differ (compare encodings).

Routing: each wrapper runs the plain version for tensors on the CPU and
launches its kernel for CUDA tensors; any other device raises, and a failed
launch raises.
"""

from __future__ import annotations

import torch

from .limbs import NLIMBS
from .point_kernels import (
    ADD_OPS_PER_LANE, _check, _lanes, count_launch, double_k_ops_per_lane, library,
    on_card)

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"msm_bucket": 0, "msm_window_reduce": 0}

#: bytes of one point's four coordinates as [20] int32 limbs each
POINT_BYTES = 4 * NLIMBS * 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def msm_bucket_work(digits: torch.Tensor, c: int) -> tuple[int, int]:
    """(bytes, int32 operations) of ``msm_bucket`` on these digits: the m
    points and the [K, m] digits read once and the K 2^(c-1) buckets
    written once; one point add per non-zero digit (what this data needs)."""
    k, m = digits.shape
    adds = int((digits != 0).sum())
    return (POINT_BYTES * m + 4 * k * m + POINT_BYTES * k * (1 << (c - 1)),
            adds * ADD_OPS_PER_LANE)


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
        stream = torch.cuda.current_stream(digits.device).cuda_stream
        rc = lib.cpzk_msm_bucket(*(f.data_ptr() for f in flat), digits.data_ptr(),
                                 *(o.data_ptr() for o in out), m, k, c, stream)
    _check(rc, "msm_bucket")
    count_launch(LAUNCHES, "msm_bucket")
    return tuple(o.reshape(NLIMBS, k, nb) for o in out)


def msm_window_reduce(buckets, c: int):
    """``[20, K, 2^(c-1)]`` x 4 bucket sums -> the ``[20, 1]`` x 4 MSM
    result: per window sum_j j bucket_j, then Horner over the windows,
    most significant first."""
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
    # k window totals of 32 words, then the ticket (zeroed)
    scratch = torch.zeros((k * 32 + 1,), dtype=torch.int32, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_msm_window_reduce(*(f.data_ptr() for f in flat), scratch.data_ptr(),
                                        *(o.data_ptr() for o in out), k, c, stream)
    _check(rc, "msm_window_reduce")
    count_launch(LAUNCHES, "msm_window_reduce")
    return tuple(out)
