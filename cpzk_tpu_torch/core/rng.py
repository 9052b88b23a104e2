"""Cryptographically secure RNG (reference ``src/primitives/rng.rs`` twin).

Wraps the OS CSPRNG (``os.urandom`` → getrandom(2)). All protocol randomness
— witnesses, nonces, batch-verification coefficients, challenge IDs — is
drawn on the host through this class; the GPU never generates secrets.
"""

import os


class SecureRng:
    """OS-backed CSPRNG with the reference's RngCore-ish surface."""

    def fill_bytes(self, n: int) -> bytes:
        return os.urandom(n)

    def next_u32(self) -> int:
        return int.from_bytes(os.urandom(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(os.urandom(8), "little")
