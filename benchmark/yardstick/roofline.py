"""The least time the combined check of n rows could take on the card, by the
benchmark's own count of its work, and the card's peaks.

The combined check of n Chaum-Pedersen rows is one multi-scalar
multiplication of 4n + 2 terms (each row's r1, y1, r2 and y2 by its random
weight and challenge products, and the two generators by the weighted sums
of the responses) whose total must be the identity.  Its work is counted
two ways, and the smaller count is the least work:

- per row, a four-term Straus ladder: 4-bit windows, the 252 doublings
  shared by the four terms, an addition a term a window, and each term's
  table of 14 additions;
- Pippenger over all 4n + 2 terms with c-bit signed digits at the best c:
  ceil(254 / c) windows, an addition a term a window into its bucket, two
  additions a bucket to sum the buckets, and the 252 doublings.

Point operations are counted in field operations on 8 words of 32 bits (a
product of two words is two int32 operations, its low and its high half):
a multiply 170 int32 operations (64 word products, 16 carries and the fold
of the upper half by 38), a square 130 (36 products, the doubling of the
cross products, carries and fold), an addition or subtraction 16.  An
addition of a cached point is 8 multiplies and 8 linear operations; a
doubling that needs no T is 4 squares, 3 multiplies and 6 linear
operations.  Bytes: each row's four compressed points and four 32-byte
scalars read once; the one-bit answer is not counted.

Whatever route or kernel a later version of the program takes, it has at
least this much work to do, so the share cannot pass 100 %.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM5 80 GB (data sheet): HBM3 bandwidth, SM count, INT32
#: lanes an SM, boost clock
HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ

MUL_OPS = 64 * 2 + 16 + 26
SQ_OPS = 36 * 2 + 16 + 16 + 26
LINEAR_OPS = 16
ADD_OPS = 8 * MUL_OPS + 8 * LINEAR_OPS
DBL_OPS = 4 * SQ_OPS + 3 * MUL_OPS + 6 * LINEAR_OPS
SCALAR_BITS = 253
DOUBLINGS = 252
ROW_BYTES = 4 * 32 + 4 * 32


def straus_ops(n: int) -> int:
    """int32 operations of n four-term per-row ladders."""
    windows = math.ceil(SCALAR_BITS / 4)
    per_row = DOUBLINGS * DBL_OPS + (4 * windows + 4 * 14) * ADD_OPS
    return n * per_row


def pippenger_ops(n: int) -> tuple[int, int]:
    """(int32 operations, window bits) of Pippenger over 4n + 2 terms at its
    best window."""
    terms = 4 * n + 2
    best = None
    for c in range(2, 24):
        windows = math.ceil((SCALAR_BITS + 1) / c)
        adds = windows * (terms + 2 * 2 ** (c - 1))
        ops = adds * ADD_OPS + DOUBLINGS * DBL_OPS
        if best is None or ops < best[0]:
            best = (ops, c)
    return best


def combined_work(n: int) -> dict:
    """The least work of the combined check of n rows and the time it
    bounds."""
    straus = straus_ops(n)
    pippenger, c = pippenger_ops(n)
    ops = min(straus, pippenger)
    nbytes = n * ROW_BYTES
    ops_s = ops / INT32_OPS_PER_S
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {
        "ops": ops, "bytes": nbytes,
        "count": "pippenger" if pippenger < straus else "straus",
        "window_bits": c,
        "bound": "ops" if ops_s >= bytes_s else "bytes",
        "least_s": max(ops_s, bytes_s),
    }
