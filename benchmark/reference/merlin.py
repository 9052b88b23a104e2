"""Merlin transcripts (STROBE-128 over Keccak-f[1600]) for many rows at once.

Every row of a batch absorbs messages of the same lengths, so the STROBE
position, the operation flags and the points at which the permutation runs
are the same for all rows: they are kept as plain integers, and only the
200-byte states are arrays, one row each.  The states live in a numpy
``uint64`` array (small batches on the host, as a login client computes its
proofs) or a torch ``int64`` tensor (large batches, on the card).

The protocol layer is that of the Chaum-Pedersen transcript: the protocol
label and domain-separation message, then the context, the generators, the
statement and the commitment, and a 64-byte challenge reduced mod l.
"""

from __future__ import annotations

import numpy as np

STROBE_R = 166
FLAG_I, FLAG_A, FLAG_C, FLAG_T, FLAG_M, FLAG_K = 1, 2, 4, 8, 16, 32

PROTOCOL_LABEL = b"Chaum-Pedersen ZKP v1.0.0"
PROTOCOL_DST = b"chaum-pedersen-ristretto255"

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# lane index x + 5 y; rotation offsets of rho
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39,
        41, 45, 15, 21, 8, 18, 2, 61, 56, 14]
# pi: B[y, 2x + 3y] = A[x, y], as a gather B = A[_PI]
_PI = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_THETA_PREV = [4, 0, 1, 2, 3]
_THETA_NEXT = [1, 2, 3, 4, 0]
_COL = [i % 5 for i in range(25)]
_CHI1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]


class _Numpy:
    """Lanes as numpy uint64 (shifts are logical)."""

    def __init__(self):
        self.rot = np.array(_ROT, dtype=np.uint64)[:, None]
        self.inv = np.uint64(64) - self.rot
        self.rc = [np.uint64(c) for c in _RC]
        self.one = np.uint64(1)
        self.s63 = np.uint64(63)

    def rotl(self, a, r, inv):
        return (a << r) | (a >> inv)

    def rotl1(self, a):
        return (a << self.one) | (a >> self.s63)

    def lanes(self, state):  # (n, 200) uint8 -> (25, n) uint64
        return np.ascontiguousarray(state.view(np.uint64).T)

    def store(self, state, lanes):
        state.view(np.uint64)[:] = lanes.T


class _Torch:
    """Lanes as torch int64: right shifts are arithmetic, so the bits they
    shift in are masked off."""

    def __init__(self, torch, device):
        self.torch = torch
        rot = torch.tensor(_ROT, dtype=torch.int64, device=device)[:, None]
        self.rot = rot
        self.inv = torch.where(rot == 0, torch.full_like(rot, 63), 64 - rot)
        self.mask = (torch.ones_like(rot) << rot) - 1
        self.rc = [c - (1 << 64) if c >= 1 << 63 else c for c in _RC]
        self.pi = torch.tensor(_PI, device=device)
        self.col = torch.tensor(_COL, device=device)
        self.prev = torch.tensor(_THETA_PREV, device=device)
        self.next = torch.tensor(_THETA_NEXT, device=device)
        self.chi1 = torch.tensor(_CHI1, device=device)
        self.chi2 = torch.tensor(_CHI2, device=device)

    def rotl(self, a, r, inv):
        return (a << r) | ((a >> inv) & self.mask)

    def rotl1(self, a):
        return (a << 1) | ((a >> 63) & 1)

    def lanes(self, state):  # (n, 200) uint8 -> (25, n) int64
        return state.view(self.torch.int64).t().contiguous()

    def store(self, state, lanes):
        state.view(self.torch.int64).copy_(lanes.t())


def keccak_f(ops, a):
    """Keccak-f[1600] over (25, n) lanes; returns the new lanes."""
    numpy = isinstance(ops, _Numpy)
    pi = _PI if numpy else ops.pi
    col = _COL if numpy else ops.col
    prev = _THETA_PREV if numpy else ops.prev
    nxt = _THETA_NEXT if numpy else ops.next
    chi1 = _CHI1 if numpy else ops.chi1
    chi2 = _CHI2 if numpy else ops.chi2
    for rc in ops.rc:
        c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
        d = c[prev] ^ ops.rotl1(c[nxt])
        a = a ^ d[col]
        b = ops.rotl(a, ops.rot, ops.inv)[pi]
        a = b ^ (~b[chi1] & b[chi2])
        a[0] ^= rc
    return a


class Strobe:
    """STROBE-128 (the subset Merlin uses) over n rows.

    ``xp`` is ``"numpy"`` or a torch device; the row data handed to
    :meth:`ad` is an (n, len) uint8 array of that kind, or bytes shared by
    every row."""

    def __init__(self, n: int, xp="numpy"):
        self.n = n
        if xp == "numpy":
            self.ops = _Numpy()
            self.state = np.zeros((n, 200), dtype=np.uint8)
        else:
            import torch

            self.ops = _Torch(torch, xp)
            self.state = torch.zeros((n, 200), dtype=torch.uint8, device=xp)
        self._array = (lambda b: np.frombuffer(b, dtype=np.uint8)) if xp == "numpy" else (
            lambda b: self._torch_bytes(b, xp))
        init = bytes([1, STROBE_R + 2, 1, 0, 1, 96]) + b"STROBEv1.0.2"
        self.state[:, :len(init)] = self._array(init)
        self._run()
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0

    @staticmethod
    def _torch_bytes(b: bytes, device):
        import torch

        return torch.frombuffer(bytearray(b), dtype=torch.uint8).to(device)

    def expand(self, n: int) -> "Strobe":
        """This (one-row) state repeated for n rows."""
        other = object.__new__(Strobe)
        other.__dict__.update(self.__dict__)
        other.n = n
        if isinstance(self.state, np.ndarray):
            other.state = np.repeat(self.state[:1], n, axis=0)
        else:
            other.state = self.state[:1].repeat(n, 1)
        return other

    def _run(self):
        lanes = keccak_f(self.ops, self.ops.lanes(self.state))
        self.ops.store(self.state, lanes)

    def _run_f(self):
        self.state[:, self.pos] ^= self.pos_begin
        self.state[:, self.pos + 1] ^= 0x04
        self.state[:, STROBE_R + 1] ^= 0x80
        self._run()
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data):
        """XOR ``data`` ((n, len) array, or a (len,) array for every row)
        into the states from ``pos``, permuting at each full rate."""
        i, m = 0, data.shape[-1]
        while i < m:
            take = min(m - i, STROBE_R - self.pos)
            self.state[:, self.pos:self.pos + take] ^= data[..., i:i + take]
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, m: int):
        out = []
        i = 0
        while i < m:
            take = min(m - i, STROBE_R - self.pos)
            out.append(self.state[:, self.pos:self.pos + take].copy()
                       if isinstance(self.state, np.ndarray)
                       else self.state[:, self.pos:self.pos + take].clone())
            self.state[:, self.pos:self.pos + take] = 0
            self.pos += take
            i += take
            if self.pos == STROBE_R:
                self._run_f()
        if isinstance(self.state, np.ndarray):
            return np.concatenate(out, axis=1)
        import torch

        return torch.cat(out, dim=1)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if self.cur_flags != flags:
                raise ValueError("STROBE: continued operation with other flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(self._array(bytes([old_begin, flags])))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(self._array(data) if isinstance(data, bytes) else data)

    def ad(self, data, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(self._array(data) if isinstance(data, bytes) else data)

    def prf(self, m: int, more: bool):
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(m)


class Merlin:
    """A Merlin transcript over n rows."""

    def __init__(self, label: bytes, n: int = 1, xp="numpy", strobe: Strobe | None = None):
        if strobe is not None:
            self.strobe = strobe
            return
        self.strobe = Strobe(n, xp)
        self.strobe.meta_ad(b"Merlin v1.0", False)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message):
        """``message``: bytes shared by every row, or an (n, len) array."""
        m = len(message) if isinstance(message, bytes) else message.shape[-1]
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(m.to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, m: int):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(m.to_bytes(4, "little"), True)
        return self.strobe.prf(m, False)

    def expand(self, n: int) -> "Merlin":
        return Merlin(b"", strobe=self.strobe.expand(n))


def protocol_start(xp="numpy") -> Merlin:
    """The one-row transcript every Chaum-Pedersen row starts from: the
    protocol label and the domain-separation message."""
    t = Merlin(PROTOCOL_LABEL, 1, xp)
    t.append_message(b"protocol", PROTOCOL_DST)
    return t


def challenge_wide(start: Merlin, contexts, g: bytes, h: bytes, y1, y2, r1, r2):
    """The 64-byte challenge of each row (before reduction mod l).

    ``start`` is :func:`protocol_start`'s transcript (kept by the caller, so
    the shared prefix is absorbed once); ``contexts`` an (n, len) array of
    context bytes or None for rows without a context; ``y1`` .. ``r2`` the
    (n, 32) wires."""
    n = y1.shape[0]
    t = start.expand(n)
    if contexts is not None:
        t.append_message(b"context", contexts)
    t.append_message(b"generator-g", g)
    t.append_message(b"generator-h", h)
    t.append_message(b"y1", y1)
    t.append_message(b"y2", y2)
    t.append_message(b"r1", r1)
    t.append_message(b"r2", r2)
    return t.challenge_bytes(b"challenge", 64)


def reduce_wide(rows) -> list[int]:
    """64-byte little-endian rows (an (n, 64) array) reduced mod l."""
    from .group import L

    raw = rows.tobytes() if isinstance(rows, np.ndarray) else rows.cpu().numpy().tobytes()
    return [int.from_bytes(raw[64 * i:64 * i + 64], "little") % L for i in range(len(raw) // 64)]
