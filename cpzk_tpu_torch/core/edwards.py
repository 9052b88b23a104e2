"""Edwards25519 points (extended coordinates) and the ristretto255 functions.

Implements RFC 9496: ENCODE, DECODE, the Elligator-based one-way map
(FROM_UNIFORM_BYTES), and equality in the quotient group. Points are
immutable ``(X, Y, Z, T)`` tuples with x = X/Z, y = Y/Z, T = XY/Z.

Reference parity: the point layer of curve25519-dalek used by
``src/primitives/ristretto.rs`` (compress/decompress/identity/add/scalar-mul).
"""

from __future__ import annotations

from .field import (
    D,
    D_MINUS_ONE_SQ,
    INVSQRT_A_MINUS_D,
    ONE_MINUS_D_SQ,
    P,
    SQRT_AD_MINUS_ONE,
    SQRT_M1,
    fabs,
    fe_to_bytes,
    finv,
    is_negative,
    sqrt_ratio_m1,
)

Point = tuple[int, int, int, int]  # (X, Y, Z, T) extended coordinates

IDENTITY: Point = (0, 1, 1, 0)


def pt_add(p: Point, q: Point) -> Point:
    """Unified extended-coordinate addition for a = -1 (HWCD'08 add-2008-hwcd-3)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * (2 * D % P) % P * T2 % P
    Dd = Z1 * 2 * Z2 % P
    E = B - A
    F = Dd - C
    G = Dd + C
    H = B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_double(p: Point) -> Point:
    """Extended-coordinate doubling for a = -1 (dbl-2008-hwcd)."""
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + B
    E = (H - (X1 + Y1) * (X1 + Y1)) % P
    G = A - B
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def pt_neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def pt_sub(p: Point, q: Point) -> Point:
    return pt_add(p, pt_neg(q))


def pt_scalar_mul(p: Point, n: int) -> Point:
    """Double-and-add scalar multiplication (host path; not constant-time —
    host secret-scalar paths use this only where the reference also accepts
    vartime, and the threat model is documented in docs/security.md)."""
    acc = IDENTITY
    addend = p
    while n > 0:
        if n & 1:
            acc = pt_add(acc, addend)
        addend = pt_double(addend)
        n >>= 1
    return acc


def pt_eq(p: Point, q: Point) -> bool:
    """Equality in the ristretto quotient group: X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2
    (dalek RistrettoPoint::eq — OR, to identify the 4-torsion cosets)."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (Y1 * Y2 - X1 * X2) % P == 0


def pt_is_identity(p: Point) -> bool:
    return pt_eq(p, IDENTITY)


def ristretto_encode(p: Point) -> bytes:
    """RFC 9496 §4.3.2 ENCODE."""
    X0, Y0, Z0, T0 = p
    u1 = (Z0 + Y0) * (Z0 - Y0) % P
    u2 = X0 * Y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T0 % P

    ix0 = X0 * SQRT_M1 % P
    iy0 = Y0 * SQRT_M1 % P
    enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
    rotate = is_negative(T0 * z_inv % P)

    x = iy0 if rotate else X0
    y = ix0 if rotate else Y0
    z = Z0
    den_inv = enchanted_denominator if rotate else den2

    if is_negative(x * z_inv % P):
        y = (-y) % P
    s = fabs(den_inv * ((z - y) % P) % P)
    return fe_to_bytes(s)


def ristretto_decode(b: bytes) -> Point | None:
    """RFC 9496 §4.3.1 DECODE. Returns None on any non-canonical/invalid input."""
    if len(b) != 32:
        return None
    s = int.from_bytes(b, "little")
    if s >= P:  # non-canonical field encoding
        return None
    if s & 1:  # negative s
        return None

    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1 % P) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = fabs(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P

    if (not was_square) or is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def _elligator_map(t: int) -> Point:
    """RFC 9496 §4.3.4 MAP: one field element → point."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = ((-1 - r * D) % P) * ((r + D) % P) % P

    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = (-fabs(s * t % P)) % P
    if not was_square:
        s = s_prime
        c = r
    else:
        c = (-1) % P

    n = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - v) % P

    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def ristretto_from_uniform_bytes(b: bytes) -> Point:
    """RFC 9496 one-way map on 64 uniform bytes (dalek from_uniform_bytes).

    Used for generator_h derivation (reference ``ristretto.rs:86-91``)."""
    if len(b) != 64:
        raise ValueError("from_uniform_bytes needs 64 bytes")
    t1 = int.from_bytes(b[:32], "little") & ((1 << 255) - 1)
    t2 = int.from_bytes(b[32:], "little") & ((1 << 255) - 1)
    return pt_add(_elligator_map(t1 % P), _elligator_map(t2 % P))


def _derive_basepoint() -> Point:
    """Ed25519 basepoint: y = 4/5, x the even root of (y²-1)/(d y²+1)."""
    y = 4 * finv(5) % P
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    ok, x = sqrt_ratio_m1(u, v)
    assert ok
    # fabs already returned the even representative
    t = x * y % P
    return (x, y, 1, t)


BASEPOINT: Point = _derive_basepoint()


def pt_normalize(p: Point) -> Point:
    """Affine-normalize to Z = 1 (for stable coordinate comparisons)."""
    X, Y, Z, _ = p
    zi = finv(Z)
    x = X * zi % P
    y = Y * zi % P
    return (x, y, 1, x * y % P)
