"""GPU ``VerifierBackend`` — the device data plane behind
:class:`cpzk_tpu_torch.protocol.batch.BatchVerifier`.

Port of the single-device path of ``cpzk_tpu/ops/backend.py``.  Host side:
scalar arithmetic mod l (Python ints), window decomposition, and SoA limb
marshalling of the row points from their wire bytes (the host core's
batch decode, :func:`.curve.wires_to_device`).  Device side: the verification ladders of
:mod:`.verify`, whose point adds and doublings are the CUDA kernels of
:mod:`.point_kernels`.  The combined RLC check runs per lane chunk; if it
fails, ``verify_each`` decides per row, so accept/reject is per-proof
ground truth.

Not ported (single-device GPU path only): the jit/AOT caches, buffer
donation, mesh sharding, Pippenger routing and the device RLC scalar plane.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch

from ..core.ristretto import Ristretto255, Scalar
from ..core.scalars import L
from ..protocol.batch import BatchRow, VerifierBackend
from . import curve, verify

#: Lane-chunk size and lane-pad quantum.  These are the JAX package's
#: values, chosen on a TPU (the chunk sidesteps a TPU compiler defect on
#: large programs) and kept so shapes match the reference in the tests;
#: they are not yet measured on the H100.
LANE_CHUNK = 16384
LANE_QUANTUM = 2048

#: LRU bound on ``TorchBackend._gh_cache`` — device-resident generator-pair
#: points keyed by generator bytes.
GH_CACHE_MAX = 128


def _pad_pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def _pad_lanes(n: int, chunk: int = LANE_CHUNK) -> int:
    """Lane padding schedule: powers of two up to the quantum, then
    multiples of it (the quantum never exceeds the chunk)."""
    q = min(LANE_QUANTUM, chunk)
    if n <= q:
        return _pad_pow2(n)
    return -(-n // q) * q


def _chunk_bounds(pad: int, chunk: int = LANE_CHUNK):
    """(lo, hi) slices of a padded lane axis: full chunks plus one
    remainder chunk (a quantum multiple by construction)."""
    lo = 0
    while lo < pad:
        hi = min(lo + chunk, pad)
        yield lo, hi
        lo = hi


def _chunk_point(pt: curve.Point, lo: int, hi: int) -> curve.Point:
    return tuple(c[..., lo:hi] for c in pt)


def _elems_soa(elems: list, pad: int, device) -> curve.Point:
    """Marshal Elements by their wire bytes (native batch decode): a wire-only
    element's ``.point`` would be a Python decode each."""
    return curve.wires_to_device(b"".join(e.wire() for e in elems), pad, device)


def chunked_combined_identity(pad: int, chunk: int, r1, y1, r2, y2,
                              w_a, w_ac, w_ba, w_bac) -> bool:
    """The chunked per-row combined check: one partial point per lane chunk
    (identity-padded lanes contribute the identity), then one tree-sum and
    identity test over the partials."""
    if pad <= chunk:
        return bool(verify.combined_kernel(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac))
    parts = [
        verify.combined_partial_kernel(
            _chunk_point(r1, lo, hi), _chunk_point(y1, lo, hi),
            _chunk_point(r2, lo, hi), _chunk_point(y2, lo, hi),
            w_a[:, lo:hi], w_ac[:, lo:hi], w_ba[:, lo:hi], w_bac[:, lo:hi])
        for lo, hi in _chunk_bounds(pad, chunk)
    ]
    stacked = tuple(torch.cat([p[k] for p in parts], dim=-1) for k in range(4))
    return bool(curve.is_identity(curve.tree_sum(stacked, axis=-1)))


class TorchBackend(VerifierBackend):
    """Vectorized GPU backend.

    ``device`` is where every tensor of this instance lives: ``None`` means
    ``torch.device("cuda")`` and raises if CUDA is unavailable; the CPU is
    used only when asked for (``device="cpu"``, as the tests do), and then
    the kernels' plain PyTorch versions run.  ``lane_chunk`` overrides
    :data:`LANE_CHUNK` for this instance (below the quantum, or a multiple
    of it)."""

    prefers_combined = True

    def __init__(self, device=None, lane_chunk: int | None = None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend: CUDA is not available (pass device='cpu' "
                    "to run the plain PyTorch versions on the CPU)")
            device = torch.device("cuda")
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        chunk = LANE_CHUNK if lane_chunk is None else lane_chunk
        if chunk < 1 or chunk % min(LANE_QUANTUM, chunk):
            raise ValueError(
                f"lane_chunk={chunk} must be positive and, above "
                f"{LANE_QUANTUM}, a multiple of it")
        self.lane_chunk = chunk
        # LRU-bounded generator-pair cache, guarded: concurrent batches
        # from worker threads must marshal a cold pair once
        self._gh_cache: OrderedDict[
            tuple[bytes, bytes], tuple[curve.Point, curve.Point]
        ] = OrderedDict()
        self._gh_lock = threading.Lock()

    def _scope(self):
        """Run on this instance's card (a no-op on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _gh(self, row: BatchRow) -> tuple[curve.Point, curve.Point]:
        key = (
            Ristretto255.element_to_bytes(row.g),
            Ristretto255.element_to_bytes(row.h),
        )
        with self._gh_lock:
            pair = self._gh_cache.pop(key, None)
            if pair is None:
                # single shared points keep a size-1 batch axis ([20, 1]
                # coords) and broadcast against the [20, n] row tensors
                pair = (
                    curve.points_to_device([row.g.point], self.device),
                    curve.points_to_device([row.h.point], self.device),
                )
            self._gh_cache[key] = pair  # (re)insert most-recently-used
            while len(self._gh_cache) > GH_CACHE_MAX:
                self._gh_cache.popitem(last=False)
        return pair

    # -- VerifierBackend interface ------------------------------------------

    def verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        with self._scope():
            return self._verify_combined(rows, beta)

    def _verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        n = len(rows)
        dev = self.device
        # correction row: G in slot r1 with -sum(a s), H in slot y1 with
        # -b sum(a s); identity in the other two slots
        pad = _pad_lanes(n + 1, self.lane_chunk)
        r1 = _elems_soa([r.r1 for r in rows] + [rows[0].g], pad, dev)
        y1 = _elems_soa([r.y1 for r in rows] + [rows[0].h], pad, dev)
        r2 = _elems_soa([r.r2 for r in rows], pad, dev)
        y2 = _elems_soa([r.y2 for r in rows], pad, dev)
        b = beta.value
        a = [r.alpha.value for r in rows]
        c = [r.c.value for r in rows]
        s = [r.s.value for r in rows]
        ac = [x * y % L for x, y in zip(a, c)]
        ba = [b * x % L for x in a]
        bac = [b * x % L for x in ac]
        sum_as = sum(x * y for x, y in zip(a, s)) % L
        w_a = curve.scalar_windows(a + [(L - sum_as) % L], pad, dev)
        w_ac = curve.scalar_windows(ac + [(L - b * sum_as % L) % L], pad, dev)
        w_ba = curve.scalar_windows(ba, pad, dev)
        w_bac = curve.scalar_windows(bac, pad, dev)
        return chunked_combined_identity(
            pad, self.lane_chunk, r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac)

    def verify_each(self, rows: list[BatchRow]) -> list[bool]:
        with self._scope():
            return self._verify_each(rows)

    def _verify_each(self, rows: list[BatchRow]) -> list[bool]:
        n = len(rows)
        dev = self.device
        pad = _pad_lanes(n, self.lane_chunk)
        shared = all(r.g == rows[0].g and r.h == rows[0].h for r in rows)
        if shared:
            g, h = self._gh(rows[0])
        else:
            g = _elems_soa([r.g for r in rows], pad, dev)
            h = _elems_soa([r.h for r in rows], pad, dev)
        y1 = _elems_soa([r.y1 for r in rows], pad, dev)
        y2 = _elems_soa([r.y2 for r in rows], pad, dev)
        r1 = _elems_soa([r.r1 for r in rows], pad, dev)
        r2 = _elems_soa([r.r2 for r in rows], pad, dev)
        ws = curve.scalar_windows([r.s.value for r in rows], pad, dev)
        wc = curve.scalar_windows([r.c.value for r in rows], pad, dev)
        # per-row checks are lane-independent: tile and concatenate
        masks = []
        for lo, hi in _chunk_bounds(pad, self.lane_chunk):
            cg = g if shared else _chunk_point(g, lo, hi)
            ch = h if shared else _chunk_point(h, lo, hi)
            masks.append(verify.verify_each_kernel(
                cg, ch,
                _chunk_point(y1, lo, hi), _chunk_point(y2, lo, hi),
                _chunk_point(r1, lo, hi), _chunk_point(r2, lo, hi),
                ws[:, lo:hi], wc[:, lo:hi]))
        mask = torch.cat(masks, dim=-1)
        return [bool(v) for v in mask[:n].cpu().tolist()]
