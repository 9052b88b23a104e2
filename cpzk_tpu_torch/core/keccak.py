"""Keccak-f[1600] permutation (host reference implementation).

Validated against hashlib's SHA3-256 by the test suite (we build SHA3 on top
of this permutation and compare digests). Serves STROBE-128 below, which in
turn serves the Merlin-style Fiat-Shamir transcript.

Reference parity: the Keccak core inside the ``merlin`` crate
(SURVEY.md §2.2, ``primitives/transcript.rs``).
"""

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x + 5y] for lane (x, y)
_RHO = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Apply Keccak-f[1600] to 25 64-bit lanes (lane index = x + 5y)."""
    a = list(lanes)
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _RHO[x + 5 * y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y] & _MASK) & b[(x + 2) % 5 + 5 * y])
        # iota
        a[0] ^= rc
    return a


def keccak_f1600_bytes(state: bytes | bytearray) -> bytearray:
    """Apply the permutation to a 200-byte state (little-endian lanes)."""
    assert len(state) == 200
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    out = bytearray(200)
    for i, lane in enumerate(lanes):
        out[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")
    return out


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 built on keccak_f1600 — used only to validate the permutation
    against hashlib in tests."""
    rate = 136
    state = bytearray(200)
    # absorb with pad10*1 (domain 0x06)
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += bytes(pad_len)
    padded[len(data)] ^= 0x06
    padded[-1] ^= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            state[i] ^= padded[off + i]
        state = keccak_f1600_bytes(state)
    return bytes(state[:32])
