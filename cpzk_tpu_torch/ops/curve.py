"""Batched edwards25519 / ristretto255 point operations (PyTorch).

Port of ``cpzk_tpu/ops/curve.py``.  Points are structure-of-arrays extended
coordinates: a tuple ``(X, Y, Z, T)`` of ``[20, ...batch]`` int32 limb
tensors (x = X/Z, y = Y/Z, T = XY/Z), the limb axis leading.  No
data-dependent control flow: masks and selects only.

- host marshalling: ``wires_to_device`` (wire bytes, decoded by the host
  core) and ``points_soa`` (host points) to ``[20, pad]`` limb tensors;
- ``add`` / ``double`` / ``double_k`` go through the CUDA point kernels of
  :mod:`.point_kernels` (their plain versions for CPU tensors);
- ristretto ``decode`` (RFC 9496 §4.3.1) returns a validity mask instead of
  raising, ``encode`` (§4.3.2) returns byte values;
- windowed (4-bit) double-and-add scalar multiplication with per-lane
  tables, for public scalars only (vartime selects are fine for
  verification inputs);
- ``tree_sum``, the batch point sum of the combined RLC check.

Table lookups use a 4-level select tree of lane-masked ``torch.where``, as
the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import _native, edwards as host_edwards
from ..errors import InvalidGroupElement
from . import limbs, point_kernels
from .limbs import NLIMBS

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

WINDOW_BITS = 4
NWINDOWS = 64  # ceil(253 / 4) -> 64 windows cover 256 bits
TABLE = 1 << WINDOW_BITS


# ---------------------------------------------------------------------------
# host <-> device marshalling
# ---------------------------------------------------------------------------

def points_to_device(points: list[host_edwards.Point], device) -> Point:
    """Host extended-coordinate points -> SoA limb tensors [20, n] x 4."""
    return tuple(
        torch.from_numpy(limbs.ints_to_limbs([p[k] for p in points])).to(device)
        for k in range(4)
    )


def points_soa(points: list[host_edwards.Point], pad: int, device) -> Point:
    """Identity-padded SoA limb marshal of host points to ``[20, pad]`` x 4."""
    return points_to_device(
        points + [host_edwards.IDENTITY] * (pad - len(points)), device)


_IDENTITY_COORDS = np.zeros((4, 32), dtype=np.uint8)
_IDENTITY_COORDS[1:3, 0] = 1  # (X, Y, Z, T) = (0, 1, 1, 0)


def wires_to_device(wires: bytes, pad: int, device) -> Point:
    """n concatenated 32-byte wire encodings -> ``[20, pad]`` x 4 limb
    tensors on ``device``, identity-padded: the host core decodes the n
    wires on its worker pool into this call's own staging buffers, and
    :func:`limbs.bytes_to_limbs` turns each coordinate into fresh limb
    arrays before the copy (pageable, so the copy has landed when ``.to``
    returns).  Raises :class:`InvalidGroupElement` on a wire that
    does not decode (callers marshal elements that passed parse-time
    validation, so this is a guard, not a validation layer)."""
    n = len(wires) // 32
    if pad < n:
        raise ValueError(f"pad={pad} is smaller than the {n} wires")
    coords = np.empty((pad, 4, 32), dtype=np.uint8)
    ok = np.empty((pad,), dtype=np.uint8)
    _native.batch_decode_into(wires, coords, ok)
    if not (ok[:n] == 1).all():
        raise InvalidGroupElement("batch decode of pre-validated wire failed")
    coords[n:] = _IDENTITY_COORDS  # what the identity's all-zero wire decodes to
    return tuple(
        torch.from_numpy(limbs.bytes_to_limbs(coords[:, k, :])).to(device)
        for k in range(4)
    )


def scalars_to_windows(values: list[int]) -> np.ndarray:
    """Host: scalars (already reduced mod l) -> [64, n] int32 of 4-bit
    windows, most-significant window first (window axis leading)."""
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    raw = np.frombuffer(blob, dtype=np.uint8).reshape(len(values), 32)
    nibbles = np.empty((len(values), NWINDOWS), dtype=np.int32)
    nibbles[:, 0::2] = raw & 0x0F
    nibbles[:, 1::2] = raw >> 4
    return np.ascontiguousarray(nibbles[:, ::-1].T)  # [64, n], MSB first


def scalar_windows(values: list[int], pad: int, device) -> torch.Tensor:
    """Zero-padded window decomposition of a scalar batch, on ``device``."""
    return torch.from_numpy(
        scalars_to_windows(values + [0] * (pad - len(values)))).to(device)


def points_from_device(pt: Point) -> list[host_edwards.Point]:
    coords = [limbs.limbs_to_ints(c) for c in pt]
    return list(zip(*coords))


def identity(shape: tuple[int, ...], device) -> Point:
    z = torch.zeros((NLIMBS,) + tuple(shape), dtype=torch.int32, device=device)
    one = limbs.on(limbs.ONE, z.device)[:, 0].reshape(
        (NLIMBS,) + (1,) * len(shape)).expand((NLIMBS,) + tuple(shape))
    return (z, one, one, z)


# ---------------------------------------------------------------------------
# group operations
# ---------------------------------------------------------------------------

def add(p: Point, q: Point) -> Point:
    """Unified a=-1 extended addition (add-2008-hwcd-3); twin of
    ``core.edwards.pt_add``.  One :func:`point_kernels.point_add` call."""
    return point_kernels.point_add(p, q)


def double(p: Point) -> Point:
    """a=-1 doubling (dbl-2008-hwcd); twin of ``core.edwards.pt_double``."""
    return point_kernels.point_double_k(p, 1)


def double_k(p: Point, k: int) -> Point:
    """k consecutive doublings in one :func:`point_kernels.point_double_k`
    call (the ladder's WINDOW_BITS-per-step doubling run)."""
    if k == 0:
        return p
    return point_kernels.point_double_k(p, k)


def negate(p: Point) -> Point:
    X, Y, Z, T = p
    return (limbs.neg(X), Y, Z, limbs.neg(T))


def select(mask: torch.Tensor, p: Point, q: Point) -> Point:
    """Lane-wise where(mask, p, q); mask shaped [...batch] (no limb axis)."""
    return tuple(limbs.select(mask, a, b) for a, b in zip(p, q))


def cond_negate(mask: torch.Tensor, p: Point) -> Point:
    """Lane-wise negate where mask is set (negate X and T)."""
    X, Y, Z, T = p
    return (torch.where(mask, -X, X), Y, Z, torch.where(mask, -T, T))


def eq(p: Point, q: Point) -> torch.Tensor:
    """Ristretto (quotient-group) equality: X1*Y2 == Y1*X2 or
    Y1*Y2 == X1*X2 — twin of ``core.edwards.pt_eq``."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    a = limbs.eq(limbs.mul(X1, Y2), limbs.mul(Y1, X2))
    b = limbs.eq(limbs.mul(Y1, Y2), limbs.mul(X1, X2))
    return a | b


def is_identity(p: Point) -> torch.Tensor:
    """Identity test in the quotient group: X == 0 or Y == 0."""
    X, Y, _, _ = p
    return limbs.is_zero(X) | limbs.is_zero(Y)


# ---------------------------------------------------------------------------
# scalar multiplication
# ---------------------------------------------------------------------------

def build_table(p: Point) -> tuple[torch.Tensor, ...]:
    """[0..15] * p as stacked coords: 4 x [16, 20, ...batch] (14 adds)."""
    rows = [identity(tuple(p[0].shape[1:]), p[0].device), p]
    acc = p
    for _ in range(TABLE - 2):
        acc = add(acc, p)
        rows.append(acc)
    return tuple(torch.stack([r[i] for r in rows], dim=0) for i in range(4))


def table_gather(table: tuple[torch.Tensor, ...], idx: torch.Tensor) -> Point:
    """Select table[idx] per lane via a 4-level bit select tree.

    ``table`` coords are [16, 20, ...batch] (batch may be size-1 for shared
    tables); ``idx`` is [...batch] in [0, 16)."""
    bits = [((idx >> k) & 1).bool() for k in range(WINDOW_BITS)]
    out = []
    for c in table:
        t = c
        for bit in bits:
            t = torch.where(bit, t[1::2], t[0::2])
        out.append(t[0])
    return tuple(out)


def scalar_mul(p: Point, windows: torch.Tensor) -> Point:
    """Batched windowed double-and-add: [20, ...]-point ** [64, ...]-windows
    (per lane: a 16-entry table, then 64 steps of 4 doublings + one table
    add)."""
    table = build_table(p)
    acc = identity(tuple(windows.shape[1:]), windows.device)
    for w in windows:
        acc = double_k(acc, WINDOW_BITS)
        acc = add(acc, table_gather(table, w))
    return acc


def tree_sum(p: Point, axis: int = -1) -> Point:
    """Reduce-sum of points along a batch ``axis`` by halving (log2 n
    batched adds).  Pads to a power of two with identity points."""
    coords = [torch.movedim(c, axis if axis >= 0 else c.ndim + axis, 1) for c in p]
    n = coords[0].shape[1]
    size = 1
    while size < n:
        size *= 2
    if size != n:
        pad = identity((size - n,) + tuple(coords[0].shape[2:]), coords[0].device)
        coords = [torch.cat([c, pc], dim=1) for c, pc in zip(coords, pad)]
    pt = tuple(coords)
    while pt[0].shape[1] > 1:
        half = pt[0].shape[1] // 2
        pt = add(tuple(c[:, :half] for c in pt), tuple(c[:, half:] for c in pt))
    return tuple(c[:, 0] for c in pt)


# ---------------------------------------------------------------------------
# ristretto decode / encode (batched)
# ---------------------------------------------------------------------------

def decode(wire: torch.Tensor) -> tuple[Point, torch.Tensor]:
    """RFC 9496 DECODE on [32, ...batch] byte tensors.

    Returns (point, valid_mask).  Invalid lanes yield the identity point with
    ``valid == False``."""
    dev = wire.device
    one_c = limbs.on(limbs.ONE, dev)
    b = wire.to(torch.int32)
    s = limbs.from_bytes_le(b)
    # canonical check: re-encoding must reproduce the input bytes
    canonical_ok = torch.all(limbs.to_bytes_le(s) == b, dim=0)
    even_ok = (b[0] & 1) == 0

    ss = limbs.square(s)
    u1 = limbs.sub(one_c, ss)
    u2 = limbs.add(one_c, ss)
    u2_sqr = limbs.square(u2)
    v = limbs.sub(limbs.neg(limbs.mul(limbs.on(limbs.D, dev), limbs.square(u1))), u2_sqr)
    was_square, invsqrt = limbs.sqrt_ratio_m1(one_c, limbs.mul(v, u2_sqr))
    den_x = limbs.mul(invsqrt, u2)
    den_y = limbs.mul(limbs.mul(invsqrt, den_x), v)
    x = limbs.fabs(limbs.mul(limbs.mul_small(s, 2), den_x))
    y = limbs.mul(u1, den_y)
    t = limbs.mul(x, y)

    valid = (
        canonical_ok
        & even_ok
        & was_square
        & ~limbs.is_negative(t)
        & ~limbs.is_zero(y)
    )
    one = identity(tuple(x.shape[1:]), dev)[1]
    zero = torch.zeros_like(x)
    pt = select(valid, (x, y, one, t), (zero, one, one, zero))
    return pt, valid


def encode(p: Point) -> torch.Tensor:
    """RFC 9496 ENCODE -> [32, ...batch] int32 byte values; twin of
    ``core.edwards.ristretto_encode``."""
    X0, Y0, Z0, T0 = p
    dev = X0.device
    sqrt_m1 = limbs.on(limbs.SQRT_M1, dev)
    u1 = limbs.mul(limbs.add(Z0, Y0), limbs.sub(Z0, Y0))
    u2 = limbs.mul(X0, Y0)
    _, invsqrt = limbs.sqrt_ratio_m1(
        limbs.on(limbs.ONE, dev), limbs.mul(u1, limbs.square(u2)))
    den1 = limbs.mul(invsqrt, u1)
    den2 = limbs.mul(invsqrt, u2)
    z_inv = limbs.mul(limbs.mul(den1, den2), T0)

    ix0 = limbs.mul(X0, sqrt_m1)
    iy0 = limbs.mul(Y0, sqrt_m1)
    enchanted = limbs.mul(den1, limbs.on(limbs.INVSQRT_A_MINUS_D, dev))
    rotate = limbs.is_negative(limbs.mul(T0, z_inv))

    x = limbs.select(rotate, iy0, X0)
    y = limbs.select(rotate, ix0, Y0)
    den_inv = limbs.select(rotate, enchanted, den2)

    y = limbs.select(limbs.is_negative(limbs.mul(x, z_inv)), limbs.neg(y), y)
    s = limbs.fabs(limbs.mul(den_inv, limbs.sub(Z0, y)))
    return limbs.to_bytes_le(s)
