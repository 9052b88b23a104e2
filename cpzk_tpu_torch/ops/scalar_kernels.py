"""The hand-written CUDA scalar kernels of the combined check's device
scalar plane and of the device challenge reduction, their wrappers, their
plain PyTorch versions and their launch counters.

=================  ===========================================================
kernel             replaces
=================  ===========================================================
``rlc_scalars``    the products and corrections of
                   ``cpzk_tpu/ops/backend.py::_rlc_products`` and
                   ``::_rlc_scalar_groups`` (``sclimbs.mul``, ``sum_mod_l``,
                   ``neg``)
``scalar_recode``  the splice and ``sclimbs.to_windows`` of
                   ``::_rlc_products``; the term concatenation and
                   ``sclimbs.to_signed_digits`` of
                   ``::_pippenger_digits_device`` / ``::_signed_digits_jit``
``reduce_wide``    ``cpzk_tpu/ops/sclimbs.py::reduce_wide`` on the 64-byte
                   challenges (``benches/bench_kernels.py``'s device
                   challenge reduction)
=================  ===========================================================

Sources: ``csrc/sc25519_w32.cuh`` (arithmetic mod l on 8 x 32-bit words,
``__host__ __device__``) and ``csrc/scalar_ops.cu`` (the kernels and their
C launch interface), built into the package's kernel library by
:func:`.point_kernels.library`.

The wrappers take and return the reference's tensors: ``[20, pad]`` int32
canonical limbs in, int32 limbs, windows or digits out; so kernel and plain
version compare with ``torch.equal``.  Design: one thread per lane, a
product mod l reduced by three folds at bit 252 (``sc_reduce_wide``);
``rlc_scalars`` two threads a row, each two of the row's four products
(operands picked by the thread's part, so a warp does not diverge), and ``sum(a s)`` over the grid in the same launch as a plain
9-word integer (warp shuffles, one pass over a block's warps, per-block
partials, then the last block by an atomic ticket, which it leaves zeroed,
so the wrapper keeps one a stream), reduced mod l once at the end: exact
in any order, the plain version's result bit for bit.
``scalar_recode`` runs one lane (or term) a thread, which reads its scalar
(or the correction, at the reference's place, picked by selects after one
32-bit division) and writes its 64 windows or nwin digits.  What bounds
them on an H100: :func:`rlc_scalars_work` and :func:`scalar_recode_work`
count the bytes and int32 operations; the recode is bound by bytes, and at
the paths' widths what it takes past its launch is one thread's chain and
the stores' drain, so its design keeps that chain short (several lanes a
thread in 16-byte accesses made it longer and lost at every shape).
``PERF.md`` holds the measured times.

Routing: each wrapper runs the plain version for tensors on the CPU and
launches its kernel for CUDA tensors; any other device raises, and a failed
launch raises.  There is no fallback from a CUDA tensor to the plain
version.
"""

from __future__ import annotations

import threading

import torch

from . import sclimbs as sc
from .point_kernels import _check, count_launch, library, on_card

NLIMBS = sc.NLIMBS

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"rlc_scalars": 0, "scalar_recode": 0, "reduce_wide": 0}

#: int32 operations of one reduction mod l of a 16-word value
#: (``sc25519_w32.cuh`` ``sc_reduce_wide``, three folds at bit 252): a word
#: product is 2 (the low and the high multiply-add), a row of products
#: ends in one carry; x >> 252 in 9 shifts, 36 products and 9 carries for
#: c x_hi, 5 shifts, 20 products and 5 carries for c t_hi, a 9-word sum of
#: four terms with carries (36, and 2 masks), v >> 252 (2), 4 products and
#: a carry for c q, an 8-word sum of three terms (24), and one conditional
#: subtraction of l (a 9-word compare and a 9-word subtract).  Where the
#: bounds use it the bytes bound the kernels, so its value does not move
#: them.
SC_REDUCE_OPS = 9 + (36 * 2 + 9) + 5 + (20 * 2 + 5) + 36 + 2 + 2 + (4 * 2 + 1) + 24 + (9 + 9)
#: one product mod l: 64 word products and 8 carries for a b, then
#: :data:`SC_REDUCE_OPS`
SC_MUL_OPS = (64 * 2 + 8) + SC_REDUCE_OPS
#: words of ``rlc_scalars``' sum and of each block's partial: the rows'
#: ``a s mod l`` summed as plain integers (below 2^280 for up to 2^27 rows)
RLC_SUM_WORDS = 9
#: a row of ``rlc_scalars``: a c, b a, b a c and a s, and a s into the sum
#: (a 9-word add with carries: the sum is reduced once, at the end, so the
#: adds need no compare or subtraction of l)
RLC_OPS_PER_ROW = 4 * SC_MUL_OPS + RLC_SUM_WORDS


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def rlc_scalars_work(pad: int) -> tuple[int, int]:
    """(bytes, int32 operations) of ``rlc_scalars`` over ``pad`` rows: three
    scalars read and three products written a row, beta read and the two
    corrections written once."""
    return 6 * NLIMBS * 4 * pad + 3 * NLIMBS * 4, RLC_OPS_PER_ROW * pad


def reduce_wide_work(rows: int, n: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one ``reduce_wide`` over n lanes of
    ``rows`` limbs: the limbs read once, 20 limbs written a lane, one
    reduction of a 16-word value a lane."""
    return 4 * rows * n + 4 * NLIMBS * n, SC_REDUCE_OPS * n


def scalar_recode_work(lanes: int, outputs_per_lane: int, reads: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one ``scalar_recode``: ``reads`` scalars
    read, ``lanes`` output lanes of ``outputs_per_lane`` int32 each (64
    windows, or nwin digits); a window is a shift and a mask, a digit those
    and the carry's add, compare and subtract."""
    ops = 2 if outputs_per_lane == 64 else 5
    return (NLIMBS * 4 * reads + 4 * outputs_per_lane * lanes,
            ops * outputs_per_lane * lanes)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the reference's device scalar plane, on .sclimbs)
# ---------------------------------------------------------------------------

def rlc_scalars_plain(al, cl, sl, bl):
    """(a c, b a, b a c, -sum(a s), -b sum(a s)) mod l: three ``[20, pad]``
    and two ``[20, 1]`` limb tensors, as ``_rlc_scalar_groups`` computes
    them."""
    ac = sc.mul(al, cl)
    ba = sc.mul(bl, al)
    bac = sc.mul(bl, ac)
    sum_as = sc.sum_mod_l(sc.mul(al, sl))
    return ac, ba, bac, sc.neg(sum_as), sc.neg(sc.mul(bl, sum_as))


def rlc_windows_plain(groups, corr0, corr1, n: int) -> torch.Tensor:
    """``[4, 64, pad]`` windows of the four ``[20, pad]`` groups (a, a c,
    b a, b a c) with lane n replaced by corr0, corr1, 0 and 0, as
    ``_rlc_products`` splices them."""
    lane = torch.arange(groups[0].shape[-1], device=groups[0].device)[None, :]
    zero = torch.zeros_like(corr0)
    corrs = (corr0, corr1, zero, zero)
    return torch.stack([sc.to_windows(torch.where(lane == n, corr, body))
                        for body, corr in zip(groups, corrs)])


def rlc_digits_plain(groups, corr0, corr1, n: int, m: int, c: int) -> torch.Tensor:
    """``[K, m]`` signed c-bit digits of the terms a | a c | b a | b a c
    (the first n lanes of each group) | corr0 | corr1 | zeros, as
    ``_pippenger_digits_device`` orders them."""
    zeros = torch.zeros((NLIMBS, m - 4 * n - 2), dtype=torch.int32, device=corr0.device)
    terms = torch.cat([g[:, :n] for g in groups] + [corr0, corr1, zeros], dim=-1)
    return sc.to_signed_digits(terms, c)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _route(name: str, tensors) -> bool:
    """:func:`.point_kernels.on_card` for the device of ``tensors``; raises
    on a mix of devices and on tensors the kernel does not take."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != torch.int32 or t.ndim != 2 or t.shape[0] != NLIMBS:
            raise ValueError(f"{name}: scalars must be [20, n] int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return on_card(name, device)


#: ``rlc_scalars``' ticket of each (device, stream): zeroed once when made;
#: every call leaves it zeroed (its last block resets it), and the calls on
#: one stream run one after another
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    with _TICKETS_LOCK:
        ticket = _TICKETS.get(key)
        if ticket is None:
            ticket = _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=device)
    return ticket


def rlc_scalars(al, cl, sl, bl):
    """a c, b a, b a c (``[20, pad]``) and -sum(a s), -b sum(a s)
    (``[20, 1]``) mod l from canonical ``[20, pad]`` limbs a, c, s and
    ``[20, 1]`` beta."""
    if not _route("rlc_scalars", (al, cl, sl, bl)):
        return rlc_scalars_plain(al, cl, sl, bl)
    pad = al.shape[1]
    if cl.shape != al.shape or sl.shape != al.shape or bl.shape != (NLIMBS, 1):
        raise ValueError("rlc_scalars: a, c, s must share one [20, pad] shape, beta [20, 1]")
    device = al.device
    al, cl, sl, bl = (t.contiguous() for t in (al, cl, sl, bl))
    out = [torch.empty((NLIMBS, pad), dtype=torch.int32, device=device) for _ in range(3)]
    corr = [torch.empty((NLIMBS, 1), dtype=torch.int32, device=device) for _ in range(2)]
    lib = library()
    with torch.cuda.device(device):
        blocks = lib.cpzk_rlc_scalars_blocks(pad)
        partials = torch.empty((blocks, RLC_SUM_WORDS), dtype=torch.int32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        ticket = _ticket(device, stream)
        rc = lib.cpzk_rlc_scalars(
            al.data_ptr(), cl.data_ptr(), sl.data_ptr(), bl.data_ptr(),
            *(o.data_ptr() for o in out), partials.data_ptr(), ticket.data_ptr(),
            *(o.data_ptr() for o in corr), pad, stream)
    _check(rc, "rlc_scalars")
    count_launch(LAUNCHES, "rlc_scalars")
    return (*out, *corr)


def _recode(groups, corr0, corr1, n: int, mode: int, c: int, nwin: int, m: int,
            out: torch.Tensor) -> torch.Tensor:
    pad = groups[0].shape[1]
    device = groups[0].device
    groups = [g.contiguous() for g in groups]
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_scalar_recode(
            *(g.data_ptr() for g in groups), corr0.contiguous().data_ptr(),
            corr1.contiguous().data_ptr(), n, pad, mode, c, nwin, m, out.data_ptr(), stream)
    _check(rc, "scalar_recode")
    count_launch(LAUNCHES, "scalar_recode")
    return out


def _check_groups(name: str, groups, corr0, corr1) -> bool:
    if len(groups) != 4:
        raise ValueError(f"{name}: four scalar groups (a, a c, b a, b a c)")
    launch = _route(name, (*groups, corr0, corr1))
    if any(g.shape != groups[0].shape for g in groups) or corr0.shape != (NLIMBS, 1) \
            or corr1.shape != (NLIMBS, 1):
        raise ValueError(f"{name}: groups must share one [20, pad] shape, corrections [20, 1]")
    return launch


def rlc_windows(groups, corr0, corr1, n: int) -> torch.Tensor:
    """The per-row combined check's four window columns, ``[4, 64, pad]``:
    each group's 4-bit windows (MSB first) with the corrections spliced at
    lane n (``n < pad``)."""
    pad = groups[0].shape[-1]
    if not 0 <= n < pad:
        raise ValueError(f"rlc_windows: lane {n} outside [0, {pad})")
    if not _check_groups("rlc_windows", groups, corr0, corr1):
        return rlc_windows_plain(groups, corr0, corr1, n)
    out = torch.empty((4, 64, pad), dtype=torch.int32, device=groups[0].device)
    return _recode(groups, corr0, corr1, n, 0, 4, 64, 0, out)


def rlc_digits(groups, corr0, corr1, n: int, m: int, c: int) -> torch.Tensor:
    """The Pippenger path's ``[K, m]`` signed c-bit digits (LSB window
    first) of the terms a | a c | b a | b a c | corr0 | corr1 | zeros, the
    first n lanes of each group (``m >= 4 n + 2``)."""
    from .msm import num_windows

    if not 1 <= n <= groups[0].shape[-1] or m < 4 * n + 2:
        raise ValueError(f"rlc_digits: {n} rows and {m} terms do not fit")
    if not 4 <= c <= 16:
        raise ValueError(f"rlc_digits: window size {c} outside 4..16")
    if not _check_groups("rlc_digits", groups, corr0, corr1):
        return rlc_digits_plain(groups, corr0, corr1, n, m, c)
    nwin = num_windows(c)
    out = torch.empty((nwin, m), dtype=torch.int32, device=groups[0].device)
    return _recode(groups, corr0, corr1, n, 1, c, nwin, m, out)


def reduce_wide(x: torch.Tensor) -> torch.Tensor:
    """x mod l for ``[W, n]`` int32 canonical 13-bit limbs of values below
    2^512 (W <= 40; the 64-byte challenges of
    ``sclimbs.bytes_wide_to_limbs``) -> canonical ``[20, n]`` limbs."""
    if x.dtype != torch.int32 or x.ndim != 2 or not 1 <= x.shape[0] <= 2 * NLIMBS:
        raise ValueError(f"reduce_wide: limbs must be [W <= 40, n] int32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not on_card("reduce_wide", x.device):
        return sc.reduce_wide_plain(x)
    n = x.shape[1]
    if n < 1:
        raise ValueError("reduce_wide needs at least one lane")
    x = x.contiguous()
    out = torch.empty((NLIMBS, n), dtype=torch.int32, device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cpzk_reduce_wide(x.data_ptr(), x.shape[0], out.data_ptr(), n, stream)
    _check(rc, "reduce_wide")
    count_launch(LAUNCHES, "reduce_wide")
    return out
