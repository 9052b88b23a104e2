"""GF(2^255 - 19) field arithmetic and ristretto255 field constants.

Integer-exact host implementation. All ristretto constants are *derived*
(not hardcoded) from the curve definition, then cross-checked by the test
suite against RFC 9496 test vectors.

Reference parity: the field layer that curve25519-dalek provides underneath
``src/primitives/ristretto.rs`` (see SURVEY.md §2.2).
"""

P = 2**255 - 19

# Edwards curve: -x^2 + y^2 = 1 + d x^2 y^2  (a = -1)
D = (-121665 * pow(121666, P - 2, P)) % P

# sqrt(-1) mod p  (p ≡ 5 mod 8)
SQRT_M1 = pow(2, (P - 1) // 4, P)


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    """Multiplicative inverse by Fermat's little theorem (a != 0)."""
    return pow(a, P - 2, P)


def is_negative(a: int) -> bool:
    """RFC 9496 'negative' = odd canonical representative."""
    return (a % P) & 1 == 1


def fabs(a: int) -> int:
    """CT_ABS: the non-negative (even) representative of ±a."""
    a %= P
    return P - a if a & 1 else a


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """Compute (was_square, sqrt(u/v)) per RFC 9496 §3.1 (SQRT_RATIO_M1).

    Returns the non-negative square root of u/v if it exists; otherwise the
    non-negative square root of SQRT_M1 * u / v. ``(u, v) = (0, 0)`` returns
    ``(True, 0)``; ``v = 0, u != 0`` returns ``(False, 0)``.
    """
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P

    correct_sign = check == u
    flipped_sign = check == (P - u) % P
    flipped_sign_i = check == (P - u) * SQRT_M1 % P

    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P

    r = fabs(r)
    return (correct_sign or flipped_sign, r)


def fsqrt(a: int) -> int:
    """Non-negative square root of a (raises if a is not a QR)."""
    ok, r = sqrt_ratio_m1(a % P, 1)
    if not ok:
        raise ValueError("not a square")
    return r


# --- ristretto255 derived constants (RFC 9496 §4.1) ---
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
# sqrt(a*d - 1) with a = -1 → sqrt(-(d+1)). RFC 9496 fixes the ODD root
# (fsqrt returns the even one); the sign propagates into the Elligator map
# output, so using the even root would yield negated points and break
# interop with the reference's generator_h.
SQRT_AD_MINUS_ONE = P - fsqrt((-(D + 1)) % P)
assert SQRT_AD_MINUS_ONE & 1 == 1
# 1/sqrt(a - d) with a = -1 → invsqrt(-1 - d); RFC fixes the even root.
INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)[1]
assert INVSQRT_A_MINUS_D & 1 == 0


def fe_to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian encoding."""
    return (a % P).to_bytes(32, "little")
