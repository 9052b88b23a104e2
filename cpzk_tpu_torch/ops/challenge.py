"""Batched Fiat-Shamir challenge derivation with Keccak on the card.

Port of ``cpzk_tpu/ops/challenge.py``.  When every row absorbs the same
shape of messages (fixed-length contexts, 32-byte point encodings) the
STROBE byte bookkeeping of a Merlin transcript does not depend on the data,
so a whole batch's transcripts reduce to

    state_0  (the shared prefix, computed once on the host)
    state ^= M_1 ; permute ; state ^= M_2 ; permute ; ... ; permute
    challenge = state[0:64]

where the XOR masks M_j are placed on the host with numpy (byte placement
only, no hashing) and the permutations, all of the hashing, run batched:
:func:`.keccak_kernels.keccak_chain`, the hand-written kernel on the card
(its plain PyTorch version for ``device="cpu"``).

``derive_challenges_device`` is byte for byte the host transcript's
(``tests/test_torch_keccak.py``); rows share one context length (``None``:
no context append).  As in the reference, the serving path derives its
challenges on the host core (:func:`..core.transcript.derive_challenges_batch`);
this path is for measurement and for callers that want the bytes on the
card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import strobe as host_strobe
from ..core.strobe import FLAG_A, FLAG_C, FLAG_I, FLAG_K, FLAG_M, STROBE_R
from ..core.transcript import CHALLENGE_DST, PROTOCOL_DST, PROTOCOL_LABEL
from . import keccak, keccak_kernels, point_kernels

WIDE = 64


class _BatchStrobe:
    """Replays Strobe128's exact byte schedule over a batch.

    Shared bytes (labels, headers, length prefixes) broadcast; per-row
    bytes land as [n, L] numpy columns.  Produces the base state plus a
    list of XOR-mask blocks, one per permutation."""

    def __init__(self, base: host_strobe.Strobe128, n: int):
        # the shared prefix's state already holds absorbed but unpermuted
        # bytes, so the masks continue from its position
        self.n = n
        self.base_state = bytes(base.state)
        self.pos = base.pos
        self.pos_begin = base.pos_begin
        self.cur_flags = base.cur_flags
        self.cur = np.zeros((200, n), dtype=np.uint8)
        self.blocks: list[np.ndarray] = []

    # -- strobe internals (twin of core/strobe.py, mask-building form) --

    def _run_f(self) -> None:
        self.cur[self.pos] ^= self.pos_begin
        self.cur[self.pos + 1] ^= 0x04
        self.cur[STROBE_R + 1] ^= 0x80
        self.blocks.append(self.cur)
        self.cur = np.zeros((200, self.n), dtype=np.uint8)
        self.pos = 0
        self.pos_begin = 0

    def _absorb_shared(self, data: bytes) -> None:
        for byte in data:
            self.cur[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _absorb_cols(self, cols: np.ndarray) -> None:
        """cols: [n, L] uint8 per-row message bytes."""
        off, length = 0, cols.shape[1]
        while off < length:
            chunk = min(STROBE_R - self.pos, length - off)
            self.cur[self.pos: self.pos + chunk] ^= cols[:, off: off + chunk].T
            self.pos += chunk
            off += chunk
            if self.pos == STROBE_R:
                self._run_f()

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert flags == self.cur_flags
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb_shared(bytes([old_begin, flags]))
        if (flags & (FLAG_C | FLAG_K)) != 0 and self.pos != 0:
            self._run_f()

    # -- merlin framing --

    def append_message(self, label: bytes, cols: np.ndarray | bytes) -> None:
        length = len(cols) if isinstance(cols, bytes) else cols.shape[1]
        self._begin_op(FLAG_M | FLAG_A, False)
        self._absorb_shared(label)
        self._begin_op(FLAG_M | FLAG_A, True)
        self._absorb_shared(length.to_bytes(4, "little"))
        self._begin_op(FLAG_A, False)
        if isinstance(cols, bytes):
            self._absorb_shared(cols)
        else:
            self._absorb_cols(cols)

    def finish_challenge(self, label: bytes) -> None:
        """challenge_bytes(label, 64) up to and including the forced
        permutation; the 64 output bytes are then state[0:64]."""
        self._begin_op(FLAG_M | FLAG_A, False)
        self._absorb_shared(label)
        self._begin_op(FLAG_M | FLAG_A, True)
        self._absorb_shared(WIDE.to_bytes(4, "little"))
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, False)
        # begin_op absorbed 2 header bytes, so pos != 0: the C flag always
        # forces a permutation here, exactly one final run_f
        assert self.pos == 0 and not self.cur.any(), "PRF must land on a boundary"


@functools.cache
def _shared_prefix() -> host_strobe.Strobe128:
    """Strobe state after the shared Merlin and protocol-DST prefix.

    Depends only on module constants, so it is computed once (the init runs
    a pure-Python Keccak permutation).  ``_BatchStrobe`` only reads it."""
    s = host_strobe.Strobe128(b"Merlin v1.0")
    for label, msg in ((b"dom-sep", PROTOCOL_LABEL), (b"protocol", PROTOCOL_DST)):
        s.meta_ad(label, False)
        s.meta_ad(len(msg).to_bytes(4, "little"), True)
        s.ad(msg, False)
    return s


def _bytes_to_lanes_np(block: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[200, n] uint8 -> (hi, lo) [25, n] int32 (little-endian lanes)."""
    b = block.reshape(25, 8, -1).astype(np.uint64)
    lane = np.zeros((25, b.shape[2]), dtype=np.uint64)
    for i in range(8):
        lane |= b[:, i] << np.uint64(8 * i)
    hi = (lane >> np.uint64(32)).astype(np.uint32).astype(np.int32)
    lo = (lane & np.uint64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)
    return hi, lo


def challenge_masks(context_cols, g_cols, h_cols, y1_cols, y2_cols, r1_cols, r2_cols):
    """The shared base state ((hi, lo) [25, 1] int32) and the (hi, lo)
    ``[k, 25, n]`` masks of n rows' transcripts, on the host."""
    n = g_cols.shape[0]
    bs = _BatchStrobe(_shared_prefix(), n)
    if context_cols is not None:
        bs.append_message(b"context", np.asarray(context_cols, dtype=np.uint8))
    for label, cols in (
        (b"generator-g", g_cols), (b"generator-h", h_cols),
        (b"y1", y1_cols), (b"y2", y2_cols),
        (b"r1", r1_cols), (b"r2", r2_cols),
    ):
        bs.append_message(label, np.asarray(cols, dtype=np.uint8))
    bs.finish_challenge(CHALLENGE_DST)
    base = np.frombuffer(bs.base_state, dtype=np.uint8)[:, None].copy()
    masks = [_bytes_to_lanes_np(b) for b in bs.blocks]
    return (_bytes_to_lanes_np(base),
            (np.stack([m[0] for m in masks]), np.stack([m[1] for m in masks])))


def derive_challenges_device(
    context_cols: np.ndarray | None,
    g_cols: np.ndarray,
    h_cols: np.ndarray,
    y1_cols: np.ndarray,
    y2_cols: np.ndarray,
    r1_cols: np.ndarray,
    r2_cols: np.ndarray,
    device=None,
) -> np.ndarray:
    """[n, 64] uint8 challenge bytes for n rows, the permutations on
    ``device`` (``None``: ``cuda:0``, raising without CUDA; ``"cpu"``: the
    plain version).

    Column args are [n, 32] uint8 (the context optional, any shared length).
    The wide reduction mod l is the caller's: ``sc_from_bytes_mod_order_wide``
    on the host, or :func:`.scalar_kernels.reduce_wide` of
    ``sclimbs.bytes_wide_to_limbs`` on the card."""
    n = g_cols.shape[0]
    dev = point_kernels.resolve_device("derive_challenges_device", device)
    (s_hi, s_lo), (m_hi, m_lo) = challenge_masks(
        context_cols, g_cols, h_cols, y1_cols, y2_cols, r1_cols, r2_cols)
    # the absorb chain (``_absorb_permute_chain`` in the reference): the
    # hand-written kernel on the card, its plain version on the CPU
    state = keccak_kernels.keccak_chain(*(torch.from_numpy(a).to(dev)
                                          for a in (s_hi, s_lo, m_hi, m_lo)))
    lanes = keccak.state_to_lanes(state)  # [n, 25] uint64
    return lanes[:, :8].copy().view(np.uint8).reshape(n, 64)


__all__ = ["challenge_masks", "derive_challenges_device"]
