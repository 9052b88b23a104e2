"""The two hand-written CUDA kernels of the batch prover, their wrappers,
their plain PyTorch versions and their launch counters.

======================  ======================================================
kernel                  replaces
======================  ======================================================
``comb_tables``         ``cpzk_tpu/ops/prove.py::_comb_tables_kernel``
``commitments``         ``cpzk_tpu/ops/prove.py::_commitments_kernel`` (two
                        ``::_fixed_base_kernel`` walks and two
                        ``cpzk_tpu/ops/curve.py::encode``, fused)
======================  ======================================================

Sources: ``csrc/prove_w32.cuh`` (the table build's and the walk's thread
bodies), ``csrc/ristretto_w32.cuh`` (ENCODE on 8 x 32-bit words),
``csrc/msm_w32.cuh`` (the quad doubling) and ``csrc/fe25519_w32.cuh``
(field and point arithmetic), all ``__host__ __device__``, and
``csrc/prove_ops.cu`` (the kernels and their C launch interface), built into
the package's kernel library by :func:`.point_kernels.library`.

Tables.  A fixed-base comb table of P holds T_w[j] = j 16^w P for 64
windows.  The plain version keeps the reference's layout, four
``[64, 16, 20, 1]`` int32 limb tensors (X, Y, Z, T), entries 0 .. 15; the
kernel its own, one ``[64, 9, 3, 8]`` int32 tensor of canonical 32-bit
words: entries 0 .. 8 in affine form as (y - x, y + x, 2d x y)
(``csrc/prove_w32.cuh``), which the walk reaches with signed digits in
[-8, 8].  :func:`table_words` maps a plain table into the kernel's layout
(normalising Z by a plain inversion), so the kernel's table equals it
exactly.

Design (``csrc/prove_ops.cu``).  ``comb_tables`` runs once per generator
in one block: one chain of 252 doublings on a quad of threads gives the 64
window bases, then every entry is one doubling or one add on its own
thread, then one inversion a window brings them to affine form; the chain
bounds it (its chain floor, ~0.26 ms).  ``commitments`` runs a thread per
point, (lane, generator): it recodes the lane's 64 nibbles to signed digits
as it walks (the top window, unrecoded, over two steps: any nibble is
taken), selects the entry in constant time (every entry of the
window read, one kept by a mask; the sign applied by masks), adds it by
the mixed add (7 multiplies) and encodes the sum; a block copies each
window into shared memory as it walks.  Both are bound by operations:
:func:`comb_tables_work` and :func:`commitments_work` count the bytes and
the int32 operations; ``PERF.md`` holds the measured times.

Routing: each wrapper runs the plain version for tensors on the CPU and
launches its kernel for CUDA tensors; any other device raises, and a failed
launch raises.  There is no fallback from a CUDA tensor to the plain
version.
"""

from __future__ import annotations

import torch

from . import curve, limbs
from .limbs import NLIMBS
from .point_kernels import (
    ADD_OPS_PER_LANE, W32_LINEAR_OPS, W32_MUL_OPS, W32_SQ_OPS, _check, count_launch,
    double_k_ops_per_lane, library, on_card, point_add_plain, point_double_k_plain,
    words_of_limbs,
)

Point = curve.Point
#: the reference's layout: four [64, 16, 20, 1] limb tensors
LimbTable = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

NWINDOWS = curve.NWINDOWS
TABLE = curve.TABLE
#: entries a window in the kernel's table: |e| for signed digits e in [-8, 8]
KERNEL_ENTRIES = 9
#: the kernel's layout: [window, entry, coordinate (y - x, y + x, 2d x y), word]
WORDS_SHAPE = (NWINDOWS, KERNEL_ENTRIES, 3, 8)
TABLE_BYTES = NWINDOWS * KERNEL_ENTRIES * 3 * 8 * 4

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"comb_tables": 0, "commitments": 0}

#: int32 operations of one ristretto ENCODE on 8 x 32-bit words
#: (``csrc/ristretto_w32.cuh``): SQRT_RATIO_M1 is 254 squarings (251 of them
#: in the a^((p-5)/8) chain) and 19 multiplies, and the rest of ENCODE 1
#: squaring and 13 multiplies.  The canonical reductions, selects and byte
#: stores are not counted.
ENCODE_OPS = 255 * W32_SQ_OPS + 32 * W32_MUL_OPS
#: an inversion a^(p-2): 254 squarings and 12 multiplies
INVERT_OPS = 254 * W32_SQ_OPS + 12 * W32_MUL_OPS
#: the walk's mixed add (an affine entry, Z2 = 1): 7 multiplies, a doubling
#: and 6 additions or subtractions
MIXED_ADD_OPS = 7 * W32_MUL_OPS + 7 * W32_LINEAR_OPS
#: a point of ``commitments``: 64 mixed adds and one ENCODE.  The
#: constant-time selects (every entry read, a mask each), the recode and
#: the kernel's 65th add (the top window's second step) are not counted:
#: a walk needs the additions, and the count is of the least work.
COMMIT_OPS_PER_POINT = NWINDOWS * MIXED_ADD_OPS + ENCODE_OPS


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def comb_tables_work() -> tuple[int, int]:
    """(bytes, int32 operations) of one ``comb_tables``: the point read
    once (4 x 80 bytes), the table written once (55,296 bytes); the least
    work: 63 x 4 doublings between window bases, a window's 8 entries
    by 4 doublings and 3 adds, one inversion for the whole table with 3
    multiplies an entry around it (Montgomery's trick over all 512
    entries), and 4 multiplies an entry to (y - x, y + x, 2d x y).  (The
    kernel inverts once a window, 64 inversions, for parallelism.)"""
    entries = NWINDOWS * (KERNEL_ENTRIES - 1)
    per_window = 4 * double_k_ops_per_lane(1) + 3 * ADD_OPS_PER_LANE
    ops = (double_k_ops_per_lane(4) * (NWINDOWS - 1) + NWINDOWS * per_window + INVERT_OPS
           + 3 * entries * W32_MUL_OPS + 4 * entries * W32_MUL_OPS)
    return 4 * NLIMBS * 4 + TABLE_BYTES, ops


def commitments_work(n: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one ``commitments`` over n lanes: the two
    tables read once (55,296 bytes each), 64 int32 digits read and 2 x 32
    bytes written a lane, :data:`COMMIT_OPS_PER_POINT` a point, two points
    a lane."""
    return 2 * TABLE_BYTES + 64 * 4 * n + 64 * n, 2 * COMMIT_OPS_PER_POINT * n


# ---------------------------------------------------------------------------
# the kernel's table layout
# ---------------------------------------------------------------------------

def table_words(table) -> torch.Tensor:
    """The kernel's ``[64, 9, 3, 8]`` int32 words of a table: a plain limb
    table's entries 0 .. 8, each brought to affine form (x, y) = (X / Z,
    Y / Z) by a plain inversion and stored as canonical (y - x, y + x,
    2d x y); a tensor in the kernel's layout is returned as it is."""
    if isinstance(table, torch.Tensor):
        return table.reshape(WORDS_SHAPE)
    x_, y_, z_ = (c[:, :KERNEL_ENTRIES, :, 0].reshape(-1, NLIMBS).T for c in table[:3])
    zi = limbs.inv(z_)
    x, y = limbs.mul(x_, zi), limbs.mul(y_, zi)
    d2 = limbs.on(limbs.D2, x.device)
    coords = [limbs.sub(y, x), limbs.add(y, x), limbs.mul(limbs.mul(x, y), d2)]
    lim = torch.stack([limbs.canonical(c).T for c in coords], dim=1)  # [64 * 9, 3, 20]
    return words_of_limbs(lim).reshape(WORDS_SHAPE).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (transcriptions of the reference's XLA programs)
# ---------------------------------------------------------------------------

def _build_table_plain(p: Point) -> LimbTable:
    """[0..15] p as stacked coords, 4 x [16, 20, ...]: ``curve.build_table``
    on the plain point addition."""
    rows = [curve.identity(tuple(p[0].shape[1:]), p[0].device), p]
    acc = p
    for _ in range(TABLE - 2):
        acc = point_add_plain(acc, p)
        rows.append(acc)
    return tuple(torch.stack([r[i] for r in rows], dim=0) for i in range(4))


def comb_tables_plain(p: Point) -> LimbTable:
    """Four ``[64, 16, 20, 1]`` tables T_w[j] = j 16^w P of a ``[20, 1]``
    point, as ``_comb_tables_kernel`` computes them: window w's table, then
    four doublings to the next window's base."""
    base = p
    windows = []
    for _ in range(NWINDOWS):
        windows.append(_build_table_plain(base))
        base = point_double_k_plain(base, 4)
    return tuple(torch.stack([t[i] for t in windows], dim=0) for i in range(4))


def fixed_base_plain(table: LimbTable, digits: torch.Tensor) -> Point:
    """sum_w T_w[d_w] per lane, ``digits`` ``[64, n]`` LSB window first, as
    ``_fixed_base_kernel`` computes it (``curve.table_gather``'s select tree
    on the plain addition)."""
    acc = curve.identity((digits.shape[-1],), digits.device)
    for w in range(NWINDOWS):
        entry = curve.table_gather(tuple(t[w] for t in table), digits[w])
        acc = point_add_plain(acc, entry)
    return acc


def commitments_plain(tg: LimbTable, th: LimbTable,
                      digits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(encode(sum_w TG_w[d_w]), encode(sum_w TH_w[d_w])) as two ``[32, n]``
    uint8 tensors, as ``_commitments_kernel`` computes them."""
    return tuple(curve.encode(fixed_base_plain(t, digits)).to(torch.uint8)
                 for t in (tg, th))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def comb_tables(p: Point):
    """The comb table of a ``[20, 1]`` point: the kernel's ``[64, 9, 3, 8]``
    words for a point on the card, the plain limb tables on the CPU."""
    device = p[0].device
    for c in p:
        if c.dtype != torch.int32 or c.shape != (NLIMBS, 1) or c.device != device:
            raise ValueError(f"comb_tables: a [20, 1] int32 point on one device, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
    if not on_card("comb_tables", device):
        return comb_tables_plain(p)
    coords = [c.contiguous() for c in p]
    out = torch.empty(WORDS_SHAPE, dtype=torch.int32, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_comb_tables(*(c.data_ptr() for c in coords), out.data_ptr(), stream)
    _check(rc, "comb_tables")
    count_launch(LAUNCHES, "comb_tables")
    return out


def commitments(tg, th, digits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two ``[32, n]`` uint8 encodings of sum_w T_w[d_w] over the G and
    the H table, ``digits`` ``[64, n]`` int32 in 0..15 (LSB window first;
    any nibbles, the top one too); on the card the tables are the kernel's
    ``[64, 9, 3, 8]`` words
    (as :func:`comb_tables` gives them there), on the CPU the plain limb
    tables."""
    if digits.dtype != torch.int32 or digits.ndim != 2 or digits.shape[0] != NWINDOWS:
        raise ValueError(f"commitments: digits must be [64, n] int32, got "
                         f"{digits.dtype} {tuple(digits.shape)}")
    device = digits.device
    if not on_card("commitments", device):
        return commitments_plain(tg, th, digits)
    for t in (tg, th):
        if (not isinstance(t, torch.Tensor) or tuple(t.shape) != WORDS_SHAPE
                or t.device != device or t.dtype != torch.int32):
            raise ValueError(f"commitments: tables must be [64, 9, 3, 8] int32 words on "
                             f"{device} (table_words gives them from limb tables)")
    n = digits.shape[1]
    if n < 1:
        raise ValueError("commitments needs at least one lane")
    digits = digits.contiguous()
    out = [torch.empty((32, n), dtype=torch.uint8, device=device) for _ in range(2)]
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_commitments(tg.contiguous().data_ptr(), th.contiguous().data_ptr(),
                                  digits.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                  n, stream)
    _check(rc, "commitments")
    count_launch(LAUNCHES, "commitments")
    return out[0], out[1]
