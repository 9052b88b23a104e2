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
4-bit windows.  Each ladder step is one ``double_k`` kernel launch and one
``add`` kernel launch per term (:mod:`.point_kernels`).
"""

from __future__ import annotations

import torch

from . import curve
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
) -> torch.Tensor:
    """Per-proof checks -> [n] bool.

    ``g``/``h`` are [20, 1] (shared, broadcast) or [20, n] points;
    ``y*``/``r*`` are [20, n]; ``ws``/``wc`` are [64, n] windows of s and c."""
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
) -> Point:
    """Partial sum of the combined check over one lane chunk -> [20, 1].

    Identity-padded lanes (zero windows, identity points) contribute the
    identity, so chunk partials add up to the full batch total."""
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
    total = combined_partial_kernel(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac)
    return curve.is_identity(tuple(c[..., 0] for c in total))
