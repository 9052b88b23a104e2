"""Batched Chaum-Pedersen verification (PyTorch).

Port of ``cpzk_tpu/ops/verify.py``; both functions are free of
data-dependent control flow:

- ``verify_each_kernel`` — per-proof ground truth.  For each row checks
  ``s*G - c*y1 - r1 == O`` and ``s*H - c*y2 - r2 == O`` with a
  shared-doubling double-scalar ladder per equation.
- ``combined_kernel`` — the corrected randomized-linear-combination batch
  check.  Per row computes ``a*r1 + (a*c)*y1 + (b*a)*r2 + (b*a*c)*y2`` with
  one shared-doubling ladder and four tables, tree-sums all rows plus one
  host-built correction row carrying ``(-sum a*s)*G + (-b*sum a*s)*H``, and
  accepts iff the total is the identity coset.

All tensors are limb-major ([20, n] coords, [64, n] windows).  Scalar
decomposition (mod l) happens on the host; the device sees only public
4-bit windows.

On a CUDA tensor each function is one launch of a kernel of
:mod:`.ladder_kernels` (``ladder_each``; ``ladder_combined`` a lane chunk;
``ladder_partials_identity`` for :func:`partials_identity`).  On a CPU
tensor it runs its plain version, the ``*_plain`` function beside it: the
JAX package's composition (a shared-doubling ladder of ``double_k`` and
``add`` per step over ``curve.build_table`` tables, ``tree_sum``),
bit for bit.
"""

from __future__ import annotations

import torch

from . import curve, ladder_kernels
from .curve import Point, WINDOW_BITS, build_table, table_gather


def _msm_rows(tables: list[tuple[torch.Tensor, ...]], windows: list[torch.Tensor]) -> Point:
    """Shared-doubling multi-term scalar-mul.

    ``tables[k]`` is the window table of point set k (coords [16, 20, n] or
    [16, 20, 1]), ``windows[k]`` its [64, n] window tensor (MSB first).
    Returns sum_k scalar_k * point_k per lane: one doubling ladder total."""
    acc = curve.identity(tuple(windows[0].shape[1:]), windows[0].device)
    for step in range(windows[0].shape[0]):
        acc = curve.double_k(acc, WINDOW_BITS)
        for table, w in zip(tables, windows):
            acc = curve.add(acc, table_gather(table, w[step]))
    return acc


def verify_each_kernel(
    g: Point,
    h: Point,
    y1: Point,
    y2: Point,
    r1: Point,
    r2: Point,
    ws: torch.Tensor,
    wc: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-proof checks -> [n] bool.

    ``g``/``h`` are [20, 1] (shared, broadcast) or [20, n] points;
    ``y*``/``r*`` are [20, n]; ``ws``/``wc`` are [64, n] windows of s and c.
    ``out``: an [n] bool tensor the bits are written into, and returned."""
    return ladder_kernels.ladder_each(g, h, y1, y2, r1, r2, ws, wc, out=out)


def verify_each_kernel_plain(
    g: Point,
    h: Point,
    y1: Point,
    y2: Point,
    r1: Point,
    r2: Point,
    ws: torch.Tensor,
    wc: torch.Tensor,
) -> torch.Tensor:
    """The plain version of :func:`verify_each_kernel`."""
    tg = build_table(g)
    th = build_table(h)
    tny1 = build_table(curve.negate(y1))
    tny2 = build_table(curve.negate(y2))

    d1 = _msm_rows([tg, tny1], [ws, wc])
    d2 = _msm_rows([th, tny2], [ws, wc])
    d1 = curve.add(d1, curve.negate(r1))
    d2 = curve.add(d2, curve.negate(r2))
    return curve.is_identity(d1) & curve.is_identity(d2)


def combined_partial_kernel(
    r1: Point,
    y1: Point,
    r2: Point,
    y2: Point,
    w_a: torch.Tensor,
    w_ac: torch.Tensor,
    w_ba: torch.Tensor,
    w_bac: torch.Tensor,
    out: Point | None = None,
) -> Point:
    """Partial sum of the combined check over one lane chunk -> [20, 1].

    Identity-padded lanes (zero windows, identity points) contribute the
    identity, so chunk partials add up to the full batch total.  ``out``:
    four [20, 1] tensors (column views of a chunk-partials array) the
    partial is written into, and returned."""
    return ladder_kernels.ladder_combined(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac, out=out)[0]


def combined_partial_kernel_plain(
    r1: Point,
    y1: Point,
    r2: Point,
    y2: Point,
    w_a: torch.Tensor,
    w_ac: torch.Tensor,
    w_ba: torch.Tensor,
    w_bac: torch.Tensor,
) -> Point:
    """The plain version of :func:`combined_partial_kernel`."""
    rows = _msm_rows(
        [build_table(r1), build_table(y1), build_table(r2), build_table(y2)],
        [w_a, w_ac, w_ba, w_bac],
    )
    total = curve.tree_sum(rows, axis=-1)
    return tuple(c[..., None] for c in total)


def combined_kernel(
    r1: Point,
    y1: Point,
    r2: Point,
    y2: Point,
    w_a: torch.Tensor,
    w_ac: torch.Tensor,
    w_ba: torch.Tensor,
    w_bac: torch.Tensor,
) -> torch.Tensor:
    """Corrected-RLC combined check -> scalar bool tensor.

    Callers append the correction row (points G, H, O, O with windows of
    ``-sum(a*s)``, ``-b*sum(a*s)``, 0, 0) before invoking, so acceptance is
    ``total == O``."""
    return ladder_kernels.ladder_combined(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac)[1]


def combined_kernel_plain(
    r1: Point,
    y1: Point,
    r2: Point,
    y2: Point,
    w_a: torch.Tensor,
    w_ac: torch.Tensor,
    w_ba: torch.Tensor,
    w_bac: torch.Tensor,
) -> torch.Tensor:
    """The plain version of :func:`combined_kernel`."""
    total = combined_partial_kernel_plain(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac)
    return curve.is_identity(tuple(c[..., 0] for c in total))


def partials_identity(parts: Point) -> torch.Tensor:
    """Whether the sum of k chunk partials (``[20, k]`` coords) is the
    identity coset -> scalar bool tensor."""
    return ladder_kernels.ladder_partials_identity(parts)


def partials_identity_plain(parts: Point) -> torch.Tensor:
    """The plain version of :func:`partials_identity`: one tree-sum and
    identity test over the partials."""
    return curve.is_identity(curve.tree_sum(parts, axis=-1))
