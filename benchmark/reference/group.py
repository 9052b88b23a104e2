"""Plain ristretto255 on Python integers (RFC 9496), one element at a time.

The benchmark's own statement of the group: it decodes and encodes wires,
adds and multiplies points, derives the second generator by the one-way map,
and checks a Chaum-Pedersen row by its two group equations.  It imports
nothing of the program and serves as the reference the program's verdicts
are held against, and as the source of the constants of the vectorised
version in :mod:`.vecfield`.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
#: order of the prime-order group
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = tuple[int, int, int, int]  # extended coordinates (X, Y, Z, T)
IDENTITY: Point = (0, 1, 1, 0)


def is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def ct_abs(x: int) -> int:
    x %= P
    return (P - x) % P if is_negative(x) else x


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1: (was_square, the non-negative root of u/v or
    of SQRT_M1 * u / v)."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u
    flipped = check == (-u) % P
    flipped_i = check == (-u * SQRT_M1) % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, ct_abs(r)


INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)[1]
#: RFC 9496 takes the root of a d - 1 whose low bit is set (the "negative"
#: one); the espresso vector of the tests tells the two apart
SQRT_AD_MINUS_ONE = (-sqrt_ratio_m1((-D - 1) % P, 1)[1]) % P
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P


def add(p: Point, q: Point) -> Point:
    """Unified addition for a = -1 (add-2008-hwcd-3)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = T1 * 2 * D % P * T2 % P
    Dd = Z1 * 2 * Z2 % P
    E, F, G, H = B - A, Dd - C, Dd + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def double(p: Point) -> Point:
    return add(p, p)


def neg(p: Point) -> Point:
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def mul(k: int, p: Point) -> Point:
    """k * p by double-and-add (public scalars only)."""
    acc = IDENTITY
    for bit in bin(k % L)[2:]:
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def equal(p: Point, q: Point) -> bool:
    """Ristretto equality: X1 Y2 == Y1 X2 or Y1 Y2 == X1 X2."""
    X1, Y1, _, _ = p
    X2, Y2, _, _ = q
    return (X1 * Y2 - Y1 * X2) % P == 0 or (Y1 * Y2 - X1 * X2) % P == 0


def decode(data: bytes) -> Point | None:
    """RFC 9496 DECODE; None for a wire that is no canonical encoding."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P or is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = ct_abs(2 * s * den_x)
    y = u1 * den_y % P
    t = x * y % P
    if not was_square or is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def encode(p: Point) -> bytes:
    """RFC 9496 ENCODE."""
    X0, Y0, Z0, T0 = (c % P for c in p)
    u1 = (Z0 + Y0) * (Z0 - Y0) % P
    u2 = X0 * Y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * T0 % P
    if is_negative(T0 * z_inv):
        x, y = Y0 * SQRT_M1 % P, X0 * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y, den_inv = X0, Y0, den2
    if is_negative(x * z_inv):
        y = (-y) % P
    s = ct_abs(den_inv * (Z0 - y))
    return s.to_bytes(32, "little")


def _map(t: int) -> Point:
    """RFC 9496 MAP (the one-way map's half)."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) * (r + D) % P
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = (-ct_abs(s * t)) % P
    if not was_square:
        s = s_prime
    c = (P - 1) if was_square else r
    n = (c * (r - 1) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(data: bytes) -> Point:
    """RFC 9496 one-way map of 64 uniform bytes."""
    mask = (1 << 255) - 1
    r0 = (int.from_bytes(data[:32], "little") & mask) % P
    r1 = (int.from_bytes(data[32:64], "little") & mask) % P
    return add(_map(r0), _map(r1))


#: the generator of RFC 9496 (its encoding is the first small multiple)
G: Point = decode(bytes.fromhex(
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76"))
#: the second generator of the Chaum-Pedersen statement: the one-way map of
#: SHA-512 of the protocol's domain-separation tag
H: Point = from_uniform_bytes(
    hashlib.sha512(b"chaum-pedersen-zkp-v1.0.0-generator-h").digest())


def verify_row(y1: bytes, y2: bytes, r1: bytes, r2: bytes, s: int, c: int,
               g: Point = G, h: Point = H) -> bool:
    """One Chaum-Pedersen row by its group equations: s G == r1 + c y1 and
    s H == r2 + c y2, every wire decoded here."""
    pts = [decode(w) for w in (y1, y2, r1, r2)]
    if any(p is None for p in pts):
        return False
    Y1, Y2, R1, R2 = pts
    return (equal(mul(s, g), add(R1, mul(c, Y1)))
            and equal(mul(s, h), add(R2, mul(c, Y2))))
