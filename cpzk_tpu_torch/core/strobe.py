"""STROBE-128 duplex construction (the subset Merlin uses).

Implements ``meta_AD`` / ``AD`` / ``PRF`` over Keccak-f[1600] with rate
R = 166, matching the STROBE v1.0.2 lite implementation vendored by the
``merlin`` crate (reference dependency of ``src/primitives/transcript.rs``).

Only the operations Merlin needs are provided; there is no transport mode.
"""

from .keccak import keccak_f1600_bytes

STROBE_R = 166  # 200 - 2*16 - 2 bytes: keccak capacity for 128-bit security

FLAG_I = 0x01
FLAG_A = 0x02
FLAG_C = 0x04
FLAG_T = 0x08
FLAG_M = 0x10
FLAG_K = 0x20


class Strobe128:
    """STROBE-128 state machine (merlin's strobe.rs twin)."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 12 * 8])
        st[6:18] = b"STROBEv1.0.2"
        self.state = keccak_f1600_bytes(st)
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # --- internals ---
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        self.state = keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"continued op with different flags: {flags} != {self.cur_flags}"
                )
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = (flags & (FLAG_C | FLAG_K)) != 0
        if force_f and self.pos != 0:
            self._run_f()

    # --- merlin-facing operations ---
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)
