"""GPU ``VerifierBackend`` — the device data plane behind
:class:`cpzk_tpu_torch.protocol.batch.BatchVerifier`.

Port of ``cpzk_tpu/ops/backend.py``.  Host side:
SoA limb marshalling of the row points from their wire bytes (the host
core's batch decode, :func:`.curve.wires_to_device`) and, by default, the
RLC scalar products mod l (Python ints) with their window or digit
decomposition.  Device side: the verification ladders of :mod:`.verify`,
the CUDA kernels of :mod:`.ladder_kernels` (a launch a lane chunk); if it
fails, ``verify_each`` decides per row, so accept/reject is per-proof
ground truth.

The combined RLC check takes one of two routes, as in the reference:

- below ``pippenger_min`` rows (:data:`PIPPENGER_MIN_ROWS`, by default
  never reached), the per-row ladders over n + 1 lanes (the correction row
  last), per lane chunk (:func:`chunked_combined_identity`);
- from ``pippenger_min`` rows on, one signed-digit Pippenger MSM over the
  4n + 2 terms (:func:`chunked_msm_identity`, the kernels of
  :mod:`.msm_kernels`), per lane chunk of terms.

With ``CPZK_DEVICE_RLC=1`` (read per call) the scalar products, the
corrections and their window or digit recode run on the device instead
(the kernels of :mod:`.scalar_kernels`, the reference's device scalar
plane); the host marshals the a, c, s limbs only.

Serving-plane hooks (as in the reference): each call reports its padded
lanes (``tpu.batch.pad_waste``, :func:`.flightrec.note_lanes`), its host
marshalling seconds (:func:`.flightrec.note_marshal`) and the interval the
card ran its work, timed with CUDA events on the backend's stream
(:func:`.flightrec.note_device`) — the dispatch gap of the flight recorder
is the card's idle time, not the host's.  :func:`prewarm` takes the place
of the reference's ahead-of-time compile: it builds the CUDA kernels and
runs one combined check at each serving width before a server reports
ready.

A mesh (``mesh_devices``, over the local CUDA devices or an explicit
``devices`` list) shards each batch over several devices
(:mod:`cpzk_tpu_torch.parallel.mesh`): the combined check then always
runs the Pippenger MSM, each device reducing its slice of the terms to one
partial point, and ``verify_each`` the sharded per-row ladder.  Every call
runs under :func:`device_scope`, which pins the calling thread (a serving
lane's device thread) to the instance's device.

Not ported: the jit/AOT caches and buffer donation (nothing is compiled per
shape).  Scratch is allocated per call, so one instance serves concurrent
batches.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict

import torch

from ..core.ristretto import Ristretto255, Scalar
from ..core.scalars import L
from ..observability import flightrec
from ..protocol.batch import BatchRow, VerifierBackend
from ..server import metrics
from . import curve, msm, point_kernels, scalar_kernels, verify
from . import sclimbs as sc
from .limbs import NLIMBS

#: Lane-chunk size and lane-pad quantum.  These are the JAX package's
#: values, chosen on a TPU (the chunk sidesteps a TPU compiler defect on
#: large programs) and kept so shapes match the reference in the tests;
#: they are not yet measured on the H100.
LANE_CHUNK = 16384
LANE_QUANTUM = 2048

#: Row count at or above which the combined check runs the Pippenger MSM
#: instead of the per-row ladders: ``CPZK_PIPPENGER_MIN`` at import, else
#: the reference's value, 1 << 62 (never), which it chose from A/Bs on a
#: TPU.  Not measured on the H100: ``chip_smoke.py``'s ``pippenger`` phase
#: reports the A/B there.  ``TorchBackend(pippenger_min=...)`` overrides it
#: per instance.
PIPPENGER_MIN_ROWS = int(os.environ.get("CPZK_PIPPENGER_MIN", str(1 << 62)))

#: Default LRU bound on ``TorchBackend._gh_cache``: device-resident
#: generator-pair points keyed by generator bytes.  Real deployments share
#: one generator pair; the bound keeps a huge registered-statement
#: population from growing device memory one pair at a time.
GH_CACHE_MAX = 128


@contextlib.contextmanager
def device_scope(device):
    """Pin the calling thread to one device: on a card
    ``torch.cuda.device(device)``, so launches and allocations land there.
    ``None`` and host devices are no-ops.  A per-device serving lane's
    backend enters it around every call, so each lane launches on its own
    device."""
    if device is not None and torch.device(device).type == "cuda":
        with torch.cuda.device(torch.device(device)):
            yield
    else:
        yield


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


@contextlib.contextmanager
def device_work(device: torch.device):
    """Report the interval the device ran the block's work
    (:func:`.flightrec.note_device`).  On a card it is timed with CUDA
    events recorded on the device's current stream around the block and
    ends where the host has synchronised with the end event; on the CPU
    the host clock times it."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
        end.synchronize()
        t1 = time.monotonic()
        flightrec.note_device(t1 - start.elapsed_time(end) / 1e3, t1)
    else:
        t0 = time.monotonic()
        yield
        flightrec.note_device(t0, time.monotonic())


def _chunk_point(pt: curve.Point, lo: int, hi: int) -> curve.Point:
    return tuple(c[..., lo:hi] for c in pt)


def _note_gh_cache(size: int, evicted: int) -> None:
    """Generator-pair cache telemetry: the ``tpu.gh_cache.size`` gauge and
    the ``tpu.gh_cache.evictions`` counter."""
    metrics.gauge("tpu.gh_cache.size").set(size)
    if evicted:
        metrics.counter("tpu.gh_cache.evictions").inc(evicted)


def _note_pad_waste(n: int, pad: int) -> None:
    """Batch-shape telemetry: the fraction of lanes spent on padding
    (``tpu.batch.pad_waste``) and the flight recorder's occupancy."""
    metrics.gauge("tpu.batch.pad_waste").set((pad - n) / pad if pad > 0 else 0.0)
    flightrec.note_lanes(n, pad)


def _elems_soa(elems: list, pad: int, device) -> curve.Point:
    """Marshal Elements by their wire bytes (native batch decode): a wire-only
    element's ``.point`` would be a Python decode each."""
    return curve.wires_to_device(b"".join(e.wire() for e in elems), pad, device)


def chunked_combined_identity(pad: int, chunk: int, r1, y1, r2, y2,
                              w_a, w_ac, w_ba, w_bac) -> bool:
    """The chunked per-row combined check: one partial point per lane chunk
    (identity-padded lanes contribute the identity), each written into its
    column of one ``[20, chunks]`` array, then one sum and identity test
    over the partials (on a card: a ``ladder_combined`` launch a chunk and
    one ``ladder_partials_identity``)."""
    if pad <= chunk:
        return bool(verify.combined_kernel(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac))
    bounds = list(_chunk_bounds(pad, chunk))
    parts = tuple(torch.empty((NLIMBS, len(bounds)), dtype=torch.int32, device=w_a.device)
                  for _ in range(4))
    for i, (lo, hi) in enumerate(bounds):
        verify.combined_partial_kernel(
            _chunk_point(r1, lo, hi), _chunk_point(y1, lo, hi),
            _chunk_point(r2, lo, hi), _chunk_point(y2, lo, hi),
            w_a[:, lo:hi], w_ac[:, lo:hi], w_ba[:, lo:hi], w_bac[:, lo:hi],
            out=_chunk_point(parts, i, i + 1))
    return bool(verify.partials_identity(parts))


def chunked_msm_identity(c: int, pts: curve.Point, digits: torch.Tensor,
                         chunk: int) -> bool:
    """The chunked MSM == identity check: one partial point per chunk of
    terms (zero-digit padded terms contribute nothing), then one tree-sum
    and identity test over the partials."""
    m_pad = digits.shape[-1]
    if m_pad <= chunk:
        return bool(msm.msm_is_identity_kernel(pts, digits, c))
    parts = [msm.msm_kernel(_chunk_point(pts, lo, hi), digits[:, lo:hi], c)
             for lo, hi in _chunk_bounds(m_pad, chunk)]
    stacked = tuple(torch.cat([p[k] for p in parts], dim=-1) for k in range(4))
    return bool(curve.is_identity(curve.tree_sum(stacked, axis=-1)))


# -- the device scalar plane (CPZK_DEVICE_RLC=1) ----------------------------

def _marshal_scalar_limbs(rows: list[BatchRow], beta: Scalar, pad: int, device):
    """The a, c, s limbs of the rows (zero past row n) as ``[20, pad]`` and
    beta as ``[20, 1]`` canonical limb tensors on ``device``."""
    zeros = [0] * (pad - len(rows))

    def limbs(values):
        return torch.from_numpy(sc.ints_to_limbs(values)).to(device)

    return (limbs([r.alpha.value for r in rows] + zeros),
            limbs([r.c.value for r in rows] + zeros),
            limbs([r.s.value for r in rows] + zeros),
            limbs([beta.value]))


def _rlc_scalar_groups(al, cl, sl, bl):
    """(a c, b a, b a c, -sum(a s), -b sum(a s)) mod l on the device."""
    return scalar_kernels.rlc_scalars(al, cl, sl, bl)


def _rlc_products(n: int, al, cl, sl, bl):
    """The four window columns of the per-row combined check (a, a c, b a,
    b a c, each ``[64, pad]``) with the corrections at lane n, the place of
    the host path's correction row."""
    ac, ba, bac, corr0, corr1 = _rlc_scalar_groups(al, cl, sl, bl)
    return tuple(scalar_kernels.rlc_windows((al, ac, ba, bac), corr0, corr1, n))


def _rlc_windows_device(rows: list[BatchRow], beta: Scalar, pad: int, device):
    """Device window columns for the per-row combined kernel."""
    return _rlc_products(len(rows), *_marshal_scalar_limbs(rows, beta, pad, device))


def _signed_digits(c: int, n: int, m: int, al, groups) -> torch.Tensor:
    """``[K, m]`` digits of the terms a | a c | b a | b a c | corr_G |
    corr_H | zeros from the scalar groups of :func:`_rlc_scalar_groups`."""
    ac, ba, bac, corr0, corr1 = groups
    return scalar_kernels.rlc_digits((al, ac, ba, bac), corr0, corr1, n, m, c)


def _pippenger_digits_device(rows: list[BatchRow], beta: Scalar, m: int, c: int,
                             device) -> torch.Tensor:
    """``[K, m]`` signed digits for the 4n + 2-term MSM, scalar products and
    recode on the device; the term order matches
    :meth:`TorchBackend._combined_pippenger`'s point layout."""
    n = len(rows)
    al, cl, sl, bl = _marshal_scalar_limbs(rows, beta, _pad_pow2(n), device)
    return _signed_digits(c, n, m, al, _rlc_scalar_groups(al, cl, sl, bl))


def _host_rlc_scalars(rows: list[BatchRow], beta: Scalar):
    """(a, a c, b a, b a c, -sum(a s), -b sum(a s)) mod l as Python ints."""
    b = beta.value
    a = [r.alpha.value for r in rows]
    c = [r.c.value for r in rows]
    s = [r.s.value for r in rows]
    ac = [x * y % L for x, y in zip(a, c)]
    ba = [b * x % L for x in a]
    bac = [b * x % L for x in ac]
    sum_as = sum(x * y for x, y in zip(a, s)) % L
    return a, ac, ba, bac, (L - sum_as) % L, (L - b * sum_as % L) % L


class TorchBackend(VerifierBackend):
    """Vectorized GPU backend.

    ``device`` is where every tensor of this instance lives: ``None`` means
    ``torch.device("cuda")`` and raises if CUDA is unavailable; the CPU is
    used only when asked for (``device="cpu"``, as the tests do), and then
    the kernels' plain PyTorch versions run.  ``lane_chunk`` overrides
    :data:`LANE_CHUNK` for this instance (below the quantum, or a multiple
    of it); ``gh_cache_max`` overrides :data:`GH_CACHE_MAX`;
    ``pippenger_min`` overrides :data:`PIPPENGER_MIN_ROWS`, the row count
    from which the combined check runs the Pippenger MSM.

    ``mesh_devices`` shards every batch over a mesh
    (:func:`~cpzk_tpu_torch.parallel.mesh.resolve_mesh_devices`: ``0`` every
    device of the pool, ``k`` the first k, a pool of one means no mesh);
    the pool is ``devices`` when given (an explicit list that may repeat a
    device, or a job's global mesh), else the local CUDA devices.
    ``device`` pins one device and cannot be combined with a mesh."""

    prefers_combined = True

    def __init__(self, device=None, lane_chunk: int | None = None,
                 gh_cache_max: int | None = None, pippenger_min: int | None = None,
                 mesh_devices: int | None = None, devices=None):
        if device is not None and mesh_devices is not None:
            raise ValueError(
                "TorchBackend(device=...) pins one device; it cannot also "
                "shard over a mesh (mesh_devices must be None)")
        if devices is not None and mesh_devices is None:
            raise ValueError(
                "TorchBackend(devices=...) is the pool of a mesh: pass "
                "mesh_devices too (0 = every device of the pool)")
        #: the :class:`~cpzk_tpu_torch.parallel.mesh.Mesh` this instance
        #: shards over, or None
        self.mesh = None
        self._sharded_each = self._sharded_msm = None
        if mesh_devices is not None:
            from ..parallel.mesh import (
                make_sharded_msm_check,
                make_sharded_verify_each,
                resolve_mesh_devices,
            )

            self.mesh = resolve_mesh_devices(mesh_devices, devices)
            if self.mesh is not None:
                device = self.mesh.first
                self._sharded_each = make_sharded_verify_each(self.mesh)
                self._sharded_msm = make_sharded_msm_check(self.mesh)
            elif devices is not None and len(devices):
                device = devices[0]
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
        self.pippenger_min = (
            PIPPENGER_MIN_ROWS if pippenger_min is None else pippenger_min)
        # LRU-bounded generator-pair cache, guarded: concurrent batches
        # from worker threads must marshal a cold pair once
        self._gh_cache: OrderedDict[
            tuple[bytes, bytes], tuple[curve.Point, curve.Point]
        ] = OrderedDict()
        self._gh_cache_max = max(
            1, GH_CACHE_MAX if gh_cache_max is None else gh_cache_max
        )
        self._gh_lock = threading.Lock()

    def _scope(self):
        """Pin the calling thread to this instance's device."""
        return device_scope(self.device)

    def _host(self) -> torch.device:
        """Where the row tensors are marshalled: the host for a mesh (each
        slice is copied to its own device), else the instance's device."""
        return torch.device("cpu") if self.mesh is not None else self.device

    def _device_work(self):
        """:func:`device_work` on this instance's card."""
        return device_work(self.device)

    def _gh(self, row: BatchRow) -> tuple[curve.Point, curve.Point]:
        key = (
            Ristretto255.element_to_bytes(row.g),
            Ristretto255.element_to_bytes(row.h),
        )
        evicted = 0
        with self._gh_lock:
            pair = self._gh_cache.pop(key, None)
            if pair is None:
                # single shared points keep a size-1 batch axis ([20, 1]
                # coords) and broadcast against the [20, n] row tensors
                pair = (
                    curve.points_to_device([row.g.point], self._host()),
                    curve.points_to_device([row.h.point], self._host()),
                )
            self._gh_cache[key] = pair  # (re)insert most-recently-used
            while len(self._gh_cache) > self._gh_cache_max:
                self._gh_cache.popitem(last=False)
                evicted += 1
            size = len(self._gh_cache)
        _note_gh_cache(size, evicted)
        return pair

    # -- VerifierBackend interface ------------------------------------------

    def verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        with self._scope():
            return self._verify_combined(rows, beta)

    def _verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        n = len(rows)
        device_rlc = os.environ.get("CPZK_DEVICE_RLC") == "1"
        if self._sharded_msm is not None or n >= self.pippenger_min:
            # a mesh always routes through the Pippenger MSM: each device
            # reduces its slice of the terms to one partial point
            return self._combined_pippenger(rows, beta, device_rlc)
        dev = self.device
        t0 = time.perf_counter()
        # correction row: G in slot r1 with -sum(a s), H in slot y1 with
        # -b sum(a s); identity in the other two slots
        pad = _pad_lanes(n + 1, self.lane_chunk)
        _note_pad_waste(n + 1, pad)
        r1 = _elems_soa([r.r1 for r in rows] + [rows[0].g], pad, dev)
        y1 = _elems_soa([r.y1 for r in rows] + [rows[0].h], pad, dev)
        r2 = _elems_soa([r.r2 for r in rows], pad, dev)
        y2 = _elems_soa([r.y2 for r in rows], pad, dev)
        if device_rlc:
            scalars = _marshal_scalar_limbs(rows, beta, pad, dev)
        else:
            a, ac, ba, bac, corr0, corr1 = _host_rlc_scalars(rows, beta)
            windows = (curve.scalar_windows(a + [corr0], pad, dev),
                       curve.scalar_windows(ac + [corr1], pad, dev),
                       curve.scalar_windows(ba, pad, dev),
                       curve.scalar_windows(bac, pad, dev))
        flightrec.note_marshal(time.perf_counter() - t0)
        with self._device_work():
            if device_rlc:
                windows = _rlc_products(n, *scalars)
            return chunked_combined_identity(
                pad, self.lane_chunk, r1, y1, r2, y2, *windows)

    def _combined_pippenger(self, rows: list[BatchRow], beta: Scalar,
                            device_rlc: bool) -> bool:
        """One MSM over all 4n + 2 (point, scalar) terms == identity.

        The row count, not the term count, is padded to a power of two
        (m = 4 pow2(n) + 2), so padding stays small at power-of-two batch
        sizes; past the chunk, quantum padding keeps the waste under one
        quantum of identity terms.  The window size is per chunk of terms,
        so the cost model sees the chunk length."""
        n = len(rows)
        dev = self.device
        t0 = time.perf_counter()
        elems = ([r.r1 for r in rows] + [r.y1 for r in rows] + [r.r2 for r in rows]
                 + [r.y2 for r in rows] + [rows[0].g, rows[0].h])
        m = 4 * _pad_pow2(n) + 2
        c = msm.pick_window(min(m, self.lane_chunk))
        m_pad = m if m <= self.lane_chunk else _pad_lanes(m, self.lane_chunk)
        _note_pad_waste(4 * n + 2, m_pad)
        pts = _elems_soa(elems, m_pad, self._host())
        if device_rlc:
            scalars = _marshal_scalar_limbs(rows, beta, _pad_pow2(n), dev)
        else:
            a, ac, ba, bac, corr0, corr1 = _host_rlc_scalars(rows, beta)
            terms = a + ac + ba + bac + [corr0, corr1]
            digits = torch.from_numpy(msm.scalars_to_signed_digits(
                terms + [0] * (m_pad - len(terms)), c)).to(self._host())
        flightrec.note_marshal(time.perf_counter() - t0)
        with self._device_work():
            if device_rlc:
                digits = _signed_digits(c, n, m_pad, scalars[0], _rlc_scalar_groups(*scalars))
            if self._sharded_msm is not None:
                return self._sharded_msm(pts, digits, c)
            return chunked_msm_identity(c, pts, digits, self.lane_chunk)

    def verify_each(self, rows: list[BatchRow]) -> list[bool]:
        with self._scope():
            return self._verify_each(rows)

    def _verify_each(self, rows: list[BatchRow]) -> list[bool]:
        n = len(rows)
        t0 = time.perf_counter()
        pad = _pad_lanes(n, self.lane_chunk)
        _note_pad_waste(n, pad)
        shared = all(r.g == rows[0].g and r.h == rows[0].h for r in rows)
        # a mesh shards rows that share one generator pair; any other batch
        # runs on the mesh's first device, as in the reference
        sharded = self._sharded_each is not None and shared
        dev = self._host() if sharded else self.device
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
        flightrec.note_marshal(time.perf_counter() - t0)
        with self._device_work():
            if sharded:
                mask = self._sharded_each(g, h, y1, y2, r1, r2, ws, wc)
                return [bool(v) for v in mask[:n].tolist()]
            # per-row checks are lane-independent: each lane chunk writes
            # its slice of one mask
            mask = torch.empty((pad,), dtype=torch.bool, device=dev)
            for lo, hi in _chunk_bounds(pad, self.lane_chunk):
                cg = g if shared else _chunk_point(g, lo, hi)
                ch = h if shared else _chunk_point(h, lo, hi)
                verify.verify_each_kernel(
                    cg, ch,
                    _chunk_point(y1, lo, hi), _chunk_point(y2, lo, hi),
                    _chunk_point(r1, lo, hi), _chunk_point(r2, lo, hi),
                    ws[:, lo:hi], wc[:, lo:hi], out=mask[lo:hi])
            mask = mask[:n].cpu()
        return [bool(v) for v in mask.tolist()]


def _generator_rows(n: int) -> tuple[list[BatchRow], Scalar]:
    """n valid rows made from the generators alone: statement (G, H),
    commitment (G, H), challenge 1 and response 2, so s·G = r1 + c·y1 and
    s·H = r2 + c·y2; alpha and beta are fixed non-zero weights."""
    g, h = Ristretto255.generator_g(), Ristretto255.generator_h()
    one, two = Scalar(1), Scalar(2)
    rows = [BatchRow(g=g, h=h, y1=g, y2=h, r1=g, r2=h, s=two, c=one,
                     alpha=Scalar(i + 1)) for i in range(n)]
    return rows, Scalar(3)


def prewarm(quanta, device=None) -> dict[str, float]:
    """Build the CUDA kernels (on a card: the whole library, the point,
    scalar and MSM kernels) and run one combined check at each quantum's
    padded width (``quantum`` rows plus the correction row)
    on valid rows made from the generators; the serving plane's
    replacement for the reference's ahead-of-time compile.  Returns the
    seconds each step took, keyed ``"build"`` and ``"combined/<lanes>"``.
    A build or launch failure, or a check that rejects, raises."""
    backend = TorchBackend(device=device)
    seconds: dict[str, float] = {}
    if backend.device.type == "cuda":
        t0 = time.perf_counter()
        point_kernels.library()
        seconds["build"] = time.perf_counter() - t0
    for q in quanta:
        rows, beta = _generator_rows(int(q))
        t0 = time.perf_counter()
        if not backend.verify_combined(rows, beta):
            raise RuntimeError(
                f"prewarm: the combined check rejected {q} valid rows")
        seconds[f"combined/{_pad_lanes(int(q) + 1, backend.lane_chunk)}"] = (
            time.perf_counter() - t0)
    return seconds
