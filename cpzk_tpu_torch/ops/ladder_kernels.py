"""The three hand-written CUDA kernels of the per-row ladders, their
wrappers, their launch counters and the bound arithmetic; the plain
versions are :mod:`.verify`'s ``*_plain`` functions (the step-by-step
composition of :func:`.verify._msm_rows`, ``curve.build_table``,
``table_gather`` and ``tree_sum``).

==========================  =================================================
kernel                      replaces
==========================  =================================================
``ladder_combined``         ``cpzk_tpu/ops/verify.py::combined_partial_kernel``
                            (``_msm_rows``, ``curve.build_table``,
                            ``table_gather``, ``tree_sum``) and
                            ``::combined_kernel``'s ``is_identity``
``ladder_partials_identity``  ``cpzk_tpu/ops/backend.py::_partials_impl`` and the
                            identity test of ``chunked_combined_identity``
``ladder_each``             ``cpzk_tpu/ops/verify.py::verify_each_kernel``
==========================  =================================================

Sources: ``csrc/ladder_w32.cuh`` (the thread bodies, ``__host__
__device__``) and ``csrc/ladder_ops.cu`` (the kernels and their C launch
interface), on the point arithmetic of ``csrc/fe25519_w32.cuh`` and
``csrc/msm_w32.cuh``, built into the package's kernel library by
:func:`.point_kernels.library`.

Design.  One launch a lane chunk, a quad of four threads a lane (each
thread holds the accumulator; a doubling round and a table add cost two
dependent field operations, where one thread runs seven and eight): the
quad builds its lane's 16-entry tables (in the adds' cached form) into a
global scratch this module allocates, thread r term r's, then runs the
64-step shared-doubling ladder, loading each step's table entries (a
thread its own coordinate, 32 bytes) while the step before runs.
``ladder_combined`` then sums its lanes (a tree of quad adds in each
block's shared memory, then the blocks' sums in groups, the last block of a
group to finish summing it, until one holds the total) and returns the
chunk's total and whether it is the identity; ``ladder_partials_identity``
sums k chunk totals on quads of threads, a quad a total (up to 32), by a
tree of only the ``ceil(log2 k)`` levels k needs (no add with the
identity; a warp's levels by shuffles, without a barrier), and tests the
identity; ``ladder_each`` runs a lane's
two equations on two quads at once and returns a bit a lane, with shared
generators' tables built once a block in shared memory.  Operands keep
the JAX layout (``[20, n]`` int32 limbs, ``[64, n]`` windows, most
significant first) and may be column slices of larger arrays (each with
its row stride), so a lane chunk is passed without a copy; ``g``/``h`` of
the per-row check are ``[20, 1]`` (shared) or ``[20, n]``.  The lane
ladders equal the plain version's coordinates after
:func:`.limbs.canonical`; the lane sum adds in another order than
``tree_sum``'s halving, so a total is the same group element in other
coordinates (compare with :func:`.curve.eq`).

What bounds them on an H100: operations (:func:`combined_work`,
:func:`each_work`, which count the work, not a design's shuffles or
repeated tables); but a lane is a dependent chain of point operations
(about 570 in the combined check, 830 in the per-row one), and at the
main path's widths one thread a lane would leave a warp about alone on
its scheduler, and the time would be that chain's latency.  The quads
halve the chain and fill four (eight) times the warps; the time is still
bounded below by the kernel at one lane (one quad, two for a per-row
lane: the chain floor), and past about 8,000 lanes by the issue of the
work each quad repeats in its four threads.

Routing: each wrapper runs the plain version for tensors on the CPU and
launches its kernel for CUDA tensors; any other device raises, and a failed
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .curve import NWINDOWS as STEPS, TABLE as ENTRIES, WINDOW_BITS
from .limbs import NLIMBS
from .msm_kernels import CACHED_ADD_OPS, CACHED_OPS, NEGATE_OPS, POINT_BYTES
from .point_kernels import (
    ADD_OPS_PER_LANE, _check, count_launch, double_k_ops_per_lane, library, on_card)

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"ladder_combined": 0, "ladder_partials_identity": 0, "ladder_each": 0}

#: int32 operations (the fewer of the two schedules' counts, as
#: :data:`.point_kernels.ADD_OPS_PER_LANE`) of one table: 14 cached adds
#: and the cached form of 15 entries (the identity's is a constant); of one
#: ladder step of ``terms`` terms: four doublings and a cached add a term;
#: and of an identity test: two canonical forms (two 8-word carry chains and
#: an 8-word select each) and their zero tests
TABLE_OPS = (ENTRIES - 2) * CACHED_ADD_OPS + (ENTRIES - 1) * CACHED_OPS
IDENTITY_OPS = 2 * (3 * 8 + 8)


def step_ops(terms: int) -> int:
    return double_k_ops_per_lane(WINDOW_BITS) + terms * CACHED_ADD_OPS


#: bytes of a lane's [64] windows
WINDOW_BYTES = STEPS * 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def combined_work(n: int) -> tuple[int, int]:
    """(bytes, int32 operations) of ``ladder_combined`` over n lanes: four
    points and four window columns a lane read once, the total written once;
    four tables and 64 steps of four terms a lane, n - 1 adds of the lane
    sum and the identity test."""
    return (n * (4 * POINT_BYTES + 4 * WINDOW_BYTES) + POINT_BYTES + 1,
            n * (4 * TABLE_OPS + STEPS * step_ops(4)) + (n - 1) * ADD_OPS_PER_LANE
            + IDENTITY_OPS)


def each_work(n: int, shared_generators: bool) -> tuple[int, int]:
    """(bytes, int32 operations) of ``ladder_each`` over n lanes: y1, y2,
    r1, r2 and the two window columns a lane read once (g and h once when
    every lane shares them), a byte a lane written; the tables of -y1, -y2
    a lane and of g, h once when shared (else a lane; the kernel builds
    shared ones once a block, which the bound does not count), two 64-step
    ladders of two terms, the negations, the adds of -r1 and -r2 (cached),
    and two identity tests a lane."""
    gh = 2 if shared_generators else 2 * n
    # an equation: its ladder, -y and -r (two negations each), the cached
    # form of -r, its add and the identity test
    per_lane = 2 * TABLE_OPS + 2 * (STEPS * step_ops(2) + 4 * NEGATE_OPS + CACHED_OPS
                                    + CACHED_ADD_OPS + IDENTITY_OPS)
    return (n * (4 * POINT_BYTES + 2 * WINDOW_BYTES + 1) + gh * POINT_BYTES,
            n * per_lane + gh * TABLE_OPS)


def partials_work(k: int) -> tuple[int, int]:
    """(bytes, int32 operations) of ``ladder_partials_identity`` over k
    totals: read once, one byte written; k - 1 adds and the identity test."""
    return k * POINT_BYTES + 1, (k - 1) * ADD_OPS_PER_LANE + IDENTITY_OPS


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------

def _i64(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def _ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * len(values))(*values)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with unit column stride (a column slice as it is, else a copy)."""
    return t if t.shape[1] == 1 or t.stride(1) == 1 else t.contiguous()


def _points(name: str, points, n: int, device: torch.device):
    """The coordinate tensors (kept alive by the caller), their pointers and
    row strides, and each point's column step (0: ``[20, 1]``, shared)."""
    keep, ptrs, lds, steps = [], [], [], []
    for pt in points:
        widths = {c.shape[1] if c.ndim == 2 else -1 for c in pt}
        for c in pt:
            if (c.dtype != torch.int32 or c.device != device or c.ndim != 2
                    or c.shape[0] != NLIMBS or c.shape[1] not in (1, n) or len(widths) != 1):
                raise ValueError(
                    f"{name}: point coordinates must be [20, 1] or [20, {n}] int32 on "
                    f"{device}, got {c.dtype} {tuple(c.shape)} on {c.device}")
            c = _rows(c)
            keep.append(c)
            ptrs.append(c.data_ptr())
            lds.append(c.stride(0))
        steps.append(0 if widths == {1} and n > 1 else 1)
    return keep, _ptrs(ptrs), _i64(lds), (ctypes.c_int * len(steps))(*steps)


def _windows(name: str, windows, device: torch.device):
    """The window tensors, their pointers and row strides, and the lanes."""
    n = windows[0].shape[-1] if windows[0].ndim == 2 else 0
    keep = []
    for w in windows:
        if w.dtype != torch.int32 or w.device != device or tuple(w.shape) != (STEPS, n) \
                or n < 1:
            raise ValueError(f"{name}: windows must be [64, n] int32 on {device}, got "
                             f"{w.dtype} {tuple(w.shape)} on {w.device}")
        keep.append(_rows(w))
    return keep, _ptrs([w.data_ptr() for w in keep]), _i64([w.stride(0) for w in keep]), n


def _scratch(name: str, n: int, each: bool, shared: bool, device: torch.device) -> torch.Tensor:
    """The call's scratch: tables and the lane sum's partials (``each``: the
    per-row check's tables, only the -Y tables when g and h are ``shared``)."""
    words = library().cpzk_ladder_scratch_words(n, int(each), int(shared))
    if words < 0:
        raise ValueError(f"{name}: {n} lanes is too large")
    return torch.empty((words,), dtype=torch.int32, device=device)


def _copy_out(out, total):
    if out is None:
        return total
    for o, t in zip(out, total):
        o.copy_(t)
    return tuple(out)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def ladder_combined(r1, y1, r2, y2, w_a: torch.Tensor, w_ac: torch.Tensor,
                    w_ba: torch.Tensor, w_bac: torch.Tensor, out=None):
    """One lane chunk of the combined check -> (its total, ``[20, 1]`` x 4;
    whether that total is the identity, a 0-dim bool tensor).  ``out``: four
    ``[20, 1]`` int32 tensors (column views allowed) the total is written
    into, and returned."""
    device = w_a.device
    if not on_card("ladder_combined", device):
        from .curve import is_identity
        from .verify import combined_partial_kernel_plain

        total = combined_partial_kernel_plain(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac)
        return _copy_out(out, total), is_identity(tuple(c[..., 0] for c in total))
    wkeep, wins, wlds, n = _windows("ladder_combined", (w_a, w_ac, w_ba, w_bac), device)
    keep, ptrs, lds, steps = _points("ladder_combined", (r1, y1, r2, y2), n, device)
    if out is None:
        out = tuple(torch.empty((NLIMBS, 1), dtype=torch.int32, device=device)
                    for _ in range(4))
    if any(o.dtype != torch.int32 or o.device != device or tuple(o.shape) != (NLIMBS, 1)
           or o.stride(0) != out[0].stride(0) for o in out):
        raise ValueError("ladder_combined: out must be four [20, 1] int32 tensors on "
                         f"{device} with one row stride")
    ok = torch.empty((), dtype=torch.bool, device=device)
    scratch = _scratch("ladder_combined", n, False, False, device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_ladder_combined(ptrs, lds, steps, wins, wlds, scratch.data_ptr(),
                                      _ptrs([o.data_ptr() for o in out]),
                                      _i64([out[0].stride(0)]), ok.data_ptr(), n, stream)
    _check(rc, "ladder_combined")
    count_launch(LAUNCHES, "ladder_combined")
    del keep, wkeep
    return tuple(out), ok


def ladder_partials_identity(parts) -> torch.Tensor:
    """Whether the sum of k chunk totals (``[20, k]`` x 4) is the identity:
    a 0-dim bool tensor."""
    device = parts[0].device
    if not on_card("ladder_partials_identity", device):
        from .verify import partials_identity_plain

        return partials_identity_plain(parts)
    k = parts[0].shape[-1] if parts[0].ndim == 2 else 0
    if k < 1:
        raise ValueError(f"ladder_partials_identity: parts must be [20, k], got "
                         f"{tuple(parts[0].shape)}")
    keep, ptrs, lds, _ = _points("ladder_partials_identity", (parts,), k, device)
    ok = torch.empty((), dtype=torch.bool, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_ladder_partials_identity(ptrs, lds, ok.data_ptr(), k, stream)
    _check(rc, "ladder_partials_identity")
    count_launch(LAUNCHES, "ladder_partials_identity")
    del keep
    return ok


def ladder_each(g, h, y1, y2, r1, r2, ws: torch.Tensor, wc: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """The per-row checks -> ``[n]`` bool.  ``g``/``h`` are ``[20, 1]``
    (shared) or ``[20, n]``; ``out``: an ``[n]`` bool tensor (a slice allowed)
    the bits are written into, and returned."""
    device = ws.device
    if not on_card("ladder_each", device):
        from .verify import verify_each_kernel_plain

        bits = verify_each_kernel_plain(g, h, y1, y2, r1, r2, ws, wc)
        return bits if out is None else out.copy_(bits)
    wkeep, wins, wlds, n = _windows("ladder_each", (ws, wc), device)
    keep, ptrs, lds, steps = _points("ladder_each", (g, h, y1, y2, r1, r2), n, device)
    if out is None:
        out = torch.empty((n,), dtype=torch.bool, device=device)
    if out.dtype != torch.bool or out.device != device or tuple(out.shape) != (n,) \
            or out.stride(0) != 1:
        raise ValueError(f"ladder_each: out must be a contiguous [{n}] bool tensor on {device}")
    scratch = _scratch("ladder_each", n, True, steps[0] == 0 and steps[1] == 0, device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_ladder_each(ptrs, lds, steps, wins, wlds, scratch.data_ptr(),
                                  out.data_ptr(), n, stream)
    _check(rc, "ladder_each")
    count_launch(LAUNCHES, "ladder_each")
    del keep, wkeep
    return out
