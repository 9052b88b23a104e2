"""Plain PyTorch ristretto255 for many points at once: fixed-base multiples
and their RFC 9496 encodings, for making statements and commitments on the
card from the seed.

A field element is 16 limbs of 16 bits in int64, limb-major: a (16, n)
tensor.  Limbs stay non-negative and under 2^21 between operations, so a
product's column sums (16 products under 2^42) and the fold of its upper
half by 38 fit in int64.  Plain torch operations only; the constants come
from :mod:`.group`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import group

LIMBS = 16
MASK = 0xFFFF


def from_ints(values, device) -> torch.Tensor:
    """(16, n) limbs of the integers ``values`` (each reduced mod p)."""
    raw = b"".join((v % group.P).to_bytes(32, "little") for v in values)
    limbs = np.frombuffer(raw, dtype="<u2").reshape(len(values), LIMBS).astype(np.int64)
    return torch.from_numpy(limbs.T.copy()).to(device)


def const(value: int, device) -> torch.Tensor:
    return from_ints([value], device)


#: 16 p with its limbs spread so that every limb is at least 2^19: added
#: before a subtraction so that no limb goes negative
_P_LIMBS = [(group.P >> (16 * i)) & MASK for i in range(LIMBS)]
_SUB_BIAS = [16 * x for x in _P_LIMBS]


class Field:
    """Field operations on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.bias = torch.tensor(_SUB_BIAS, dtype=torch.int64, device=self.device)[:, None]
        self.one = const(1, self.device)
        self.minus_one = const(group.P - 1, self.device)
        self.sqrt_m1 = const(group.SQRT_M1, self.device)
        self.minus_sqrt_m1 = const(group.P - group.SQRT_M1, self.device)
        self.invsqrt_a_minus_d = const(group.INVSQRT_A_MINUS_D, self.device)

    @staticmethod
    def add(a, b):
        return a + b

    def sub(self, a, b):
        return a + self.bias - b

    def neg(self, a):
        return self.bias - a

    @staticmethod
    def _carry(x):
        for _ in range(3):
            c = x >> 16
            x = x & MASK
            x[1:] += c[:-1]
            x[0] += 38 * c[-1]
        return x

    def mul(self, a, b):
        n = max(a.shape[1], b.shape[1])
        out = torch.zeros((2 * LIMBS - 1, n), dtype=torch.int64, device=self.device)
        for i in range(LIMBS):
            out[i:i + LIMBS].addcmul_(a[i:i + 1], b)
        lo = out[:LIMBS].clone()
        lo[:LIMBS - 1].add_(out[LIMBS:], alpha=38)
        return self._carry(lo)

    def sq(self, a):
        return self.mul(a, a)

    def sqn(self, a, k):
        for _ in range(k):
            a = self.mul(a, a)
        return a

    @staticmethod
    def canonical(a):
        """Limbs of the value reduced into [0, p), each under 2^16."""
        x = a.clone()
        for _ in range(3):
            for i in range(LIMBS - 1):
                x[i + 1] += x[i] >> 16
                x[i] &= MASK
            top = x[LIMBS - 1] >> 15
            x[LIMBS - 1] &= 0x7FFF
            x[0] += 19 * top
        t = x.clone()
        t[0] += 19
        for i in range(LIMBS - 1):
            t[i + 1] += t[i] >> 16
            t[i] &= MASK
        ge = (t[LIMBS - 1] >> 15) == 1
        t[LIMBS - 1] &= 0x7FFF
        return torch.where(ge, t, x)

    def is_negative(self, a):
        return (self.canonical(a)[0] & 1) == 1

    def eq(self, a, b):
        return (self.canonical(a) == self.canonical(b)).all(dim=0)

    def abs(self, a):
        return torch.where(self.is_negative(a), self.neg(a), a)

    def pow22523(self, z):
        """z^((p - 5) / 8) = z^(2^252 - 3)."""
        t0 = self.sq(z)
        t1 = self.sqn(t0, 2)
        t1 = self.mul(z, t1)
        t0 = self.mul(t0, t1)
        t0 = self.sq(t0)
        t0 = self.mul(t1, t0)                       # 2^5 - 1
        t1 = self.sqn(t0, 5)
        t0 = self.mul(t1, t0)                       # 2^10 - 1
        t1 = self.sqn(t0, 10)
        t1 = self.mul(t1, t0)                       # 2^20 - 1
        t2 = self.sqn(t1, 20)
        t1 = self.mul(t2, t1)                       # 2^40 - 1
        t1 = self.sqn(t1, 10)
        t0 = self.mul(t1, t0)                       # 2^50 - 1
        t1 = self.sqn(t0, 50)
        t1 = self.mul(t1, t0)                       # 2^100 - 1
        t2 = self.sqn(t1, 100)
        t1 = self.mul(t2, t1)                       # 2^200 - 1
        t1 = self.sqn(t1, 50)
        t0 = self.mul(t1, t0)                       # 2^250 - 1
        t0 = self.sqn(t0, 2)
        return self.mul(t0, z)                      # 2^252 - 3

    def invsqrt(self, v):
        """SQRT_RATIO_M1(1, v)'s root (non-negative)."""
        v3 = self.mul(self.sq(v), v)
        v7 = self.mul(self.sq(v3), v)
        r = self.mul(v3, self.pow22523(v7))
        check = self.mul(v, self.sq(r))
        flip = self.eq(check, self.minus_one) | self.eq(check, self.minus_sqrt_m1)
        r = torch.where(flip, self.mul(r, self.sqrt_m1), r)
        return self.abs(r)

    def to_bytes(self, a):
        """(n, 32) uint8 canonical little-endian encodings."""
        x = self.canonical(a)
        pair = torch.stack([x & 0xFF, x >> 8], dim=1).reshape(2 * LIMBS, -1)
        return pair.t().to(torch.uint8).contiguous()

    def encode(self, X0, Y0, Z0, T0):
        """RFC 9496 ENCODE of n points in extended coordinates."""
        u1 = self.mul(self.add(Z0, Y0), self.sub(Z0, Y0))
        u2 = self.mul(X0, Y0)
        inv = self.invsqrt(self.mul(u1, self.sq(u2)))
        den1 = self.mul(inv, u1)
        den2 = self.mul(inv, u2)
        z_inv = self.mul(self.mul(den1, den2), T0)
        rotate = self.is_negative(self.mul(T0, z_inv))
        X = torch.where(rotate, self.mul(Y0, self.sqrt_m1), X0)
        Y = torch.where(rotate, self.mul(X0, self.sqrt_m1), Y0)
        den_inv = torch.where(rotate, self.mul(den1, self.invsqrt_a_minus_d), den2)
        Y = torch.where(self.is_negative(self.mul(X, z_inv)), self.neg(Y), Y)
        s = self.abs(self.mul(den_inv, self.sub(Z0, Y)))
        return self.to_bytes(s)


def _niels_table(base: group.Point) -> list[int]:
    """64 windows x 16 digits of d 16^w B as (y + x, y - x, 2 d x y),
    affine, flattened."""
    P = group.P
    out = []
    step = base
    for _ in range(64):
        acc = group.IDENTITY
        for _d in range(16):
            X, Y, Z, _ = acc
            zi = pow(Z, P - 2, P)
            x, y = X * zi % P, Y * zi % P
            out += [(y + x) % P, (y - x) % P, 2 * group.D * x % P * y % P]
            acc = group.add(acc, step)
        for _ in range(4):
            step = group.double(step)
    return out


def scalar_digits(scalars, device) -> torch.Tensor:
    """(64, n) 4-bit digits, least significant first."""
    raw = b"".join((s % group.L).to_bytes(32, "little") for s in scalars)
    b = np.frombuffer(raw, dtype=np.uint8).reshape(len(scalars), 32)
    digits = np.stack([b & 15, b >> 4], axis=2).reshape(len(scalars), 64)
    return torch.from_numpy(digits.T.astype(np.int64).copy()).to(device)


class FixedBase:
    """k B for many scalars k and a few bases B, by 4-bit windows over
    tables of the bases' multiples (mixed additions, no doublings)."""

    def __init__(self, bases, device):
        self.f = Field(device)
        entries = []
        for b in bases:
            entries += _niels_table(b)
        t = from_ints(entries, device)  # (16, nbases * 64 * 16 * 3)
        self.table = t.t().reshape(len(bases) * 64 * 16, 3 * LIMBS).contiguous()

    def mul_encode(self, scalars, base_index) -> torch.Tensor:
        """(n, 32) uint8 encodings of scalars[i] * bases[base_index[i]]."""
        f = self.f
        dev = f.device
        n = len(scalars)
        digits = scalar_digits(scalars, dev)
        offset = torch.as_tensor(np.asarray(base_index, dtype=np.int64) * 1024, device=dev)
        X = torch.zeros((LIMBS, n), dtype=torch.int64, device=dev)
        Y = f.one.expand(LIMBS, n).clone()
        Z = f.one.expand(LIMBS, n).clone()
        T = torch.zeros((LIMBS, n), dtype=torch.int64, device=dev)
        for w in range(64):
            e = self.table[offset + 16 * w + digits[w]].t().reshape(3, LIMBS, n)
            yp, ym, t2d = e[0], e[1], e[2]
            A = f.mul(f.sub(Y, X), ym)
            B = f.mul(f.add(Y, X), yp)
            C = f.mul(T, t2d)
            Dd = f.add(Z, Z)
            E, F, G, H = f.sub(B, A), f.sub(Dd, C), f.add(Dd, C), f.add(B, A)
            X, Y, Z, T = f.mul(E, F), f.mul(G, H), f.mul(F, G), f.mul(E, H)
        return f.encode(X, Y, Z, T)
