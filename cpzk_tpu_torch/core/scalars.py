"""Scalar ring arithmetic mod ℓ (the ristretto255 group order).

ℓ = 2^252 + 27742317777372353535851937790883648493.

Mirrors the scalar behaviors the reference gets from curve25519-dalek
(``src/primitives/ristretto.rs:94-112,146-150,188-222``): canonical 32-byte
decode, 64-byte wide reduction, ring ops, inversion.
"""

L = 2**252 + 27742317777372353535851937790883648493


def sc_add(a: int, b: int) -> int:
    return (a + b) % L


def sc_sub(a: int, b: int) -> int:
    return (a - b) % L


def sc_mul(a: int, b: int) -> int:
    return (a * b) % L


def sc_neg(a: int) -> int:
    return (-a) % L


def sc_invert(a: int) -> int:
    """Multiplicative inverse mod ℓ (a != 0)."""
    return pow(a, L - 2, L)


def sc_from_bytes_canonical(b: bytes) -> int | None:
    """Canonical decode: 32 LE bytes; None if >= ℓ (dalek from_canonical_bytes)."""
    if len(b) != 32:
        return None
    v = int.from_bytes(b, "little")
    return v if v < L else None


def sc_from_bytes_mod_order_wide(b: bytes) -> int:
    """64-byte wide reduction (dalek from_bytes_mod_order_wide)."""
    if len(b) != 64:
        raise ValueError("wide reduction needs 64 bytes")
    return int.from_bytes(b, "little") % L


def sc_to_bytes(a: int) -> bytes:
    return (a % L).to_bytes(32, "little")
