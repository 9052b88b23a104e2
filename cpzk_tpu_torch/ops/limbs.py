"""Batched GF(2^255 - 19) arithmetic over int32 limb tensors (PyTorch).

Port of ``cpzk_tpu/ops/limbs.py`` with the same representation and the same
carry schedule, so results match the JAX package limb for limb: a field
element is a ``[20, ...batch]`` int32 tensor in radix 2^13 ("13x20"),
value = sum(limb[i] * 2^(13 i)).  With |limb| <= 2^13 a schoolbook product
limb is a sum of at most 20 terms each < 2^26, so the whole multiply stays
in int32.  Limbs may be signed; carries use arithmetic shifts (``>>`` on a
torch int32 tensor is arithmetic), and the carry out of limb 19 (weight
2^260) wraps to limb 0 scaled by 608 = 2^260 mod p.

Layout: the limb axis leads and the batch axes trail (``[20, n]``), so a
CUDA thread per batch column reads coalesced limbs.

Every public op returns "carried" form: limbs in the loose symmetric bound
|limb| <= 9500, value congruent mod p.  ``canonical`` reduces to the unique
representative < p for encoding and equality.

Two torch pitfalls this module guards against: ``Tensor.sum`` promotes
int32 to int64 unless ``dtype=torch.int32`` is given, and a constant must
live on its operand's device (:func:`on`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core import field as host_field

NLIMBS = 20
LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1
NBITS = NLIMBS * LIMB_BITS  # 260
# 2^260 mod p = 19 * 2^5
TOP_FOLD = 19 << (NBITS - 255)
#: loose carried-form bound on every limb an op returns
BOUND = 9500

P = host_field.P

I32 = torch.int32


# ---------------------------------------------------------------------------
# host-side conversions (numpy; test oracles and data marshalling)
# ---------------------------------------------------------------------------

def int_to_limbs(v: int) -> np.ndarray:
    """One integer -> [NLIMBS] int32 (value must be in [0, 2^260))."""
    out = np.empty(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = v & LIMB_MASK
        v >>= LIMB_BITS
    if v:
        raise ValueError("value too large for 20x13 limbs")
    return out


def ints_to_limbs(values: list[int]) -> np.ndarray:
    """Batch conversion -> [NLIMBS, n] int32 (limb-major device layout)."""
    blob = b"".join((v % P).to_bytes(33, "little") for v in values)
    raw = np.frombuffer(blob, dtype=np.uint8).reshape(len(values), 33)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, :NBITS]
    weights = (1 << np.arange(LIMB_BITS, dtype=np.int32))
    rows = bits.reshape(len(values), NLIMBS, LIMB_BITS).astype(np.int32) @ weights
    return np.ascontiguousarray(rows.T)


def bytes_to_limbs(blob: bytes | np.ndarray) -> np.ndarray:
    """[n, 32] little-endian byte rows -> [NLIMBS, n] int32 limbs.

    Interprets all 256 bits; values >= 2^255 stay un-reduced (carried form
    handles them).  Each 13-bit limb is cut from the rows' four 64-bit
    words with shifts (a limb may straddle two words)."""
    raw = np.ascontiguousarray(np.asarray(blob, dtype=np.uint8).reshape(-1, 32))
    words = raw.view("<u8")  # [n, 4]
    out = np.empty((NLIMBS, len(raw)), dtype=np.int32)
    for k in range(NLIMBS):
        w, s = divmod(LIMB_BITS * k, 64)
        v = words[:, w] >> np.uint64(s)
        if s + LIMB_BITS > 64 and w + 1 < 4:
            v |= words[:, w + 1] << np.uint64(64 - s)
        out[k] = v & np.uint64(LIMB_MASK)
    return out


def limbs_to_int(limbs) -> int:
    """One [NLIMBS] limb vector -> integer (host, for tests)."""
    arr = np.asarray(limbs, dtype=object).reshape(-1)
    return int(sum(int(arr[i]) << (LIMB_BITS * i) for i in range(NLIMBS)))


def limbs_to_ints(limbs) -> list[int]:
    """[NLIMBS, n] limb array (numpy or tensor) -> list of n integers."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    arr = np.asarray(limbs).reshape(NLIMBS, -1)
    return [limbs_to_int(arr[:, j]) for j in range(arr.shape[1])]


def constant(v: int) -> torch.Tensor:
    """Field constant as a [NLIMBS, 1] CPU tensor (see :func:`on`)."""
    return torch.from_numpy(int_to_limbs(v % P))[:, None]


_ON_DEVICE: dict[tuple[int, torch.device], torch.Tensor] = {}


def on(c: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Module constant ``c`` on ``device``, copied there once per device
    (every constant of this package is a module-level CPU tensor that
    lives as long as the process, so its ``id`` is a stable key)."""
    if c.device == device:
        return c
    key = (id(c), device)
    t = _ON_DEVICE.get(key)
    if t is None:
        t = _ON_DEVICE[key] = c.to(device)
    return t


def _align(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert batch axes after the limb axis so [20, 1] constants broadcast
    against arbitrarily-batched [20, ...] operands."""
    if a.ndim < b.ndim:
        a = a.reshape(a.shape[:1] + (1,) * (b.ndim - a.ndim) + a.shape[1:])
    elif b.ndim < a.ndim:
        b = b.reshape(b.shape[:1] + (1,) * (a.ndim - b.ndim) + b.shape[1:])
    return a, b


def _zeros_rows(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((k,) + tuple(like.shape[1:]), dtype=I32, device=like.device)


def _pad_rows(x: torch.Tensor, before: int, after: int) -> torch.Tensor:
    """Zero-pad the leading (limb) axis."""
    parts = []
    if before:
        parts.append(_zeros_rows(before, x))
    parts.append(x)
    if after:
        parts.append(_zeros_rows(after, x))
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# carry / reduction
# ---------------------------------------------------------------------------

def _chain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential signed carry chain along the limb axis (axis 0).

    Returns (limbs in [0, 2^13), top carry)."""
    outs = []
    c = torch.zeros_like(x[0])
    for i in range(x.shape[0]):
        t = x[i] + c
        c = t >> LIMB_BITS
        outs.append(t & LIMB_MASK)
    return torch.stack(outs, dim=0), c


def _wrap_round(x: torch.Tensor) -> torch.Tensor:
    """One carry-save round with modular wrap: every limb splits into (low
    13 bits, carry), carries move one limb up, and the carry out of limb 19
    re-enters limb 0 times 608."""
    lo = x & LIMB_MASK
    hi = x >> LIMB_BITS
    shifted = torch.cat([hi[-1:] * TOP_FOLD, hi[:-1]], dim=0)
    return lo + shifted


def _round_widen(x: torch.Tensor) -> torch.Tensor:
    """One carry-save round without wrap; output is one limb wider."""
    lo = x & LIMB_MASK
    hi = x >> LIMB_BITS
    return _pad_rows(lo, 0, 1) + _pad_rows(hi, 1, 0)


def carry20(x: torch.Tensor) -> torch.Tensor:
    """Normalize a signed [20, ...] vector to |limb| <= BOUND.  Valid for
    inputs with |limb| < 2^22.5."""
    for _ in range(4):
        x = _wrap_round(x)
    return x


def carry_product(x: torch.Tensor) -> torch.Tensor:
    """Reduce a [39, ...] schoolbook product (|limb| < 2^30.8) to loose
    carried [20, ...] form: three widening rounds, a two-step fold mod p of
    the 42-limb result, then four wrap rounds."""
    x = _pad_rows(x, 0, 3)  # 42 limbs of headroom
    for _ in range(3):
        x = _round_widen(x)[:42]  # widened carries beyond 42 are zero
    c0 = x[:NLIMBS]
    c1 = x[NLIMBS : 2 * NLIMBS]
    c2 = _pad_rows(x[2 * NLIMBS :], 0, NLIMBS - 2)
    t = c1 + c2 * TOP_FOLD
    t = _wrap_round(_wrap_round(t))
    return carry20(c0 + t * TOP_FOLD)


def _bump(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x with v added at limb 0."""
    return torch.cat([x[:1] + v[None], x[1:]], dim=0)


_P_LIMBS = torch.from_numpy(int_to_limbs(P))[:, None]


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative < p, digits in [0, 2^13) (encode/compare)."""
    x = carry20(x)
    x, c = _chain(x)
    x = _bump(x, c * TOP_FOLD)
    x, c = _chain(x)
    x = _bump(x, c * TOP_FOLD)
    x, _ = _chain(x)
    # fold bits 255..259 (top 5 bits of limb 19): 2^255 ≡ 19
    hi = x[NLIMBS - 1] >> (255 - LIMB_BITS * (NLIMBS - 1))  # >> 8
    x = torch.cat(
        [x[:1] + (hi * 19)[None], x[1 : NLIMBS - 1], (x[NLIMBS - 1] & 0xFF)[None]],
        dim=0,
    )
    x, _ = _chain(x)  # value now < 2^255 + 608
    for _ in range(2):
        x = _cond_sub_p(x)
    return x


def _cond_sub_p(x: torch.Tensor) -> torch.Tensor:
    p = on(_P_LIMBS, x.device).reshape((NLIMBS,) + (1,) * (x.ndim - 1))
    y, borrow = _chain(x - p)
    return torch.where(borrow < 0, x, y)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # raw sum <= 2*BOUND; one wrap round restores the loose bound
    a, b = _align(a, b)
    return _wrap_round(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _align(a, b)
    return _wrap_round(a - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    # |-limb| <= BOUND already: mul-safe without a round
    return -a


#: Multiplication strategy, from ``CPZK_MUL`` at import: "schoolbook" (the
#: default: outer product and one anti-diagonal sum) or "matmulfold" (the
#: same outer product folded by a shared [39, 400] 0/1 matrix, as the JAX
#: package's MXU experiment does).  Both are bit-exact.  No H100 measurement
#: chooses between them; the default is the reference's.
_MUL_VARIANTS = ("schoolbook", "matmulfold")
MUL_VARIANT = os.environ.get("CPZK_MUL", "schoolbook")
if MUL_VARIANT not in _MUL_VARIANTS:
    raise ValueError(
        f"CPZK_MUL={MUL_VARIANT!r} is not one of {_MUL_VARIANTS} — refusing "
        "to silently benchmark the default under a mislabeled name"
    )


def _raw_schoolbook(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...] x [n, ...] -> un-carried [2n-1, ...] anti-diagonal sums.

    Pad the outer product's j axis from n to 2n, flatten (i, j) -> 2n i + j,
    reslice as rows of 2n-1: flat[(2n-1) i + k] lands at outer[i, k - i],
    so one sum over i yields the anti-diagonals."""
    batch = tuple(a.shape[1:])
    outer = a[:, None] * b[None, :]  # [n, n, ...]
    outer = torch.cat([outer, torch.zeros_like(outer)], dim=1)  # [n, 2n, ...]
    flat = outer.reshape((n * 2 * n,) + batch)[: n * (2 * n - 1)]
    return flat.reshape((n, 2 * n - 1) + batch).sum(dim=0, dtype=I32)


_FOLD_MATRICES: dict = {}  # (device, dtype) -> [39, 400] fold, built on first use


def _fold_matrix(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    key = (device, dtype)
    if key not in _FOLD_MATRICES:
        f = np.zeros((2 * NLIMBS - 1, NLIMBS * NLIMBS), dtype=np.int32)
        for i in range(NLIMBS):
            for j in range(NLIMBS):
                f[i + j, i * NLIMBS + j] = 1
        _FOLD_MATRICES[key] = torch.from_numpy(f).to(device=device, dtype=dtype)
    return _FOLD_MATRICES[key]


def _mul_matmulfold(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Anti-diagonal fold as one shared-matrix product: prod[k] =
    sum_{i+j=k} outer[i, j] is the fixed 0/1 map F [39, 400], so the
    product is ``F @ outer_flat`` with outer_flat [400, prod(batch)].

    torch has no int32 matrix product on CUDA, so there the fold runs in
    float64 and is cast back.  That is exact: under the loose carried-form
    bound |limb| <= 9500 each fold sum is at most 20 * 9500^2 ~ 1.8e9 < 2^53
    (and < 2^31, so the int32 result is the JAX package's).  float32 and
    TF32 would round it.  On the CPU the product stays int32."""
    batch = tuple(a.shape[1:])
    flat = (a[:, None] * b[None, :]).reshape(NLIMBS * NLIMBS, -1)  # [400, prod(batch)]
    if flat.is_cuda:
        prod = (_fold_matrix(flat.device, torch.float64) @ flat.to(torch.float64)).to(I32)
    else:
        prod = _fold_matrix(flat.device, I32) @ flat
    return prod.reshape((2 * NLIMBS - 1,) + batch)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched field multiply: schoolbook 20x20 -> 39-limb product (or the
    CPZK_MUL-selected variant), then fold+carry."""
    a, b = _align(a, b)
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((NLIMBS,) + tuple(batch))
    b = b.expand((NLIMBS,) + tuple(batch))
    if MUL_VARIANT == "matmulfold":
        return carry_product(_mul_matmulfold(a, b))
    return carry_product(_raw_schoolbook(a, b, NLIMBS))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small public integer: |k| * BOUND must stay < 2^22.5
    (carry20's input range), i.e. |k| <= ~400."""
    if abs(k) > 400:
        raise ValueError("mul_small bound: |k| must be <= 400")
    return carry20(a * k)


def pow2k(a: torch.Tensor, k: int) -> torch.Tensor:
    """a^(2^k) by k squarings."""
    for _ in range(k):
        a = square(a)
    return a


def _pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3), the curve25519 addition chain."""
    t0 = square(a)                     # a^2
    t1 = square(square(t0))            # a^8
    t2 = mul(a, t1)                    # a^9
    t3 = mul(t0, t2)                   # a^11
    t4 = square(t3)                    # a^22
    t5 = mul(t2, t4)                   # a^31 = a^(2^5 - 1)
    t6 = mul(pow2k(t5, 5), t5)         # a^(2^10 - 1)
    t7 = mul(pow2k(t6, 10), t6)        # a^(2^20 - 1)
    t8 = mul(pow2k(t7, 20), t7)        # a^(2^40 - 1)
    t9 = mul(pow2k(t8, 10), t6)        # a^(2^50 - 1)
    t10 = mul(pow2k(t9, 50), t9)       # a^(2^100 - 1)
    t11 = mul(pow2k(t10, 100), t10)    # a^(2^200 - 1)
    t12 = mul(pow2k(t11, 50), t9)      # a^(2^250 - 1)
    return mul(pow2k(t12, 2), a)       # a^(2^252 - 3)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) (Fermat); p-2 = 8*(2^252 - 3) + 2^2 + 1 -> reuse the chain."""
    t = _pow_p58(a)            # a^(2^252 - 3)
    t = pow2k(t, 3)            # a^(2^255 - 24)
    return mul(t, mul(square(a), a))  # * a^3 = a^(p-2)


def is_negative(a: torch.Tensor) -> torch.Tensor:
    """RFC 9496 sign: parity of the canonical representative. [...] bool."""
    return (canonical(a)[0] & 1).bool()


def fabs(a: torch.Tensor) -> torch.Tensor:
    return torch.where(is_negative(a), neg(a), a)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality -> [...] bool."""
    a, b = _align(a, b)
    return torch.all(canonical(a) == canonical(b), dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with mask shaped [...batch] (no limb axis)."""
    return torch.where(mask, a, b)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched SQRT_RATIO_M1 (RFC 9496 §3.1) — twin of
    :func:`cpzk_tpu_torch.core.field.sqrt_ratio_m1`.

    Returns (was_square [...] bool, root [20, ...])."""
    sqrt_m1 = on(SQRT_M1, u.device)
    v3 = mul(square(v), v)
    v7 = mul(square(v3), v)
    r = mul(mul(u, v3), _pow_p58(mul(u, v7)))
    check = mul(v, square(r))

    neg_u = neg(u)
    correct_sign = eq(check, u)
    flipped_sign = eq(check, neg_u)
    flipped_sign_i = eq(check, mul(neg_u, sqrt_m1))

    r = select(flipped_sign | flipped_sign_i, mul(r, sqrt_m1), r)
    r = fabs(r)
    return correct_sign | flipped_sign, r


# ---------------------------------------------------------------------------
# byte/bit conversions (on device; byte axis leading, like the limb axis)
# ---------------------------------------------------------------------------

def from_bytes_le(b: torch.Tensor) -> torch.Tensor:
    """[32, ...] uint8/int32 little-endian bytes -> carried limbs [20, ...].

    Interprets all 256 bits (caller masks bit 255 if needed); the result is
    carried but not canonicalized."""
    b = b.to(I32)
    batch = tuple(b.shape[1:])
    shifts = torch.arange(8, dtype=I32, device=b.device).reshape((1, 8) + (1,) * len(batch))
    bits = ((b[:, None] >> shifts) & 1).reshape((256,) + batch)
    bits = _pad_rows(bits, 0, NBITS - 256)
    w = (1 << torch.arange(LIMB_BITS, dtype=I32, device=b.device)).reshape(
        (1, LIMB_BITS) + (1,) * len(batch)
    )
    return (bits.reshape((NLIMBS, LIMB_BITS) + batch) * w).sum(dim=1, dtype=I32)


def to_bytes_le(a: torch.Tensor) -> torch.Tensor:
    """Canonical [32, ...] int32 byte values (0..255) of a field element."""
    x = canonical(a)
    batch = tuple(x.shape[1:])
    shifts = torch.arange(LIMB_BITS, dtype=I32, device=x.device).reshape(
        (1, LIMB_BITS) + (1,) * len(batch)
    )
    bits = ((x[:, None] >> shifts) & 1).reshape((NBITS,) + batch)[:256]
    w = (1 << torch.arange(8, dtype=I32, device=x.device)).reshape(
        (1, 8) + (1,) * len(batch)
    )
    return (bits.reshape((32, 8) + batch) * w).sum(dim=1, dtype=I32)


# ---------------------------------------------------------------------------
# constants (derived from the host field module — single source of truth)
# ---------------------------------------------------------------------------

ONE = constant(1)
D = constant(host_field.D)
D2 = constant(2 * host_field.D % P)
SQRT_M1 = constant(host_field.SQRT_M1)
INVSQRT_A_MINUS_D = constant(host_field.INVSQRT_A_MINUS_D)
