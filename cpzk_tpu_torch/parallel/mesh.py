"""Batch-sharded verification and proving over an ordered list of devices.

Port of ``cpzk_tpu/parallel/mesh.py``.  Proofs are independent along the
batch axis, so every row tensor (``[20, n]`` point coordinates, ``[64, n]``
scalar windows, ``[K, m]`` MSM digits) is padded to a multiple of the mesh
size and split into contiguous slices, one per device.  Each slice is
copied to its device and runs the existing kernels there, each card's
slice in its own thread on its own CUDA stream.  The per-row check needs no
communication: its row bits concatenate.  The combined RLC check and the
MSM reduce each slice to one partial point (4 coordinates); the partials
are brought to the first device, where one ``tree_sum`` and one
``is_identity`` give the verdict.  Proving concatenates the commitment
bytes.

A :class:`Mesh` may span the ranks of a ``torch.distributed`` job
(:func:`~cpzk_tpu_torch.parallel.multihost.global_batch_mesh`): every rank
runs the same call on the same (replicated) inputs, computes the slices of
the devices it owns, and the slices' small results (row bits, partial
points, commitment bytes) are all-gathered over the process group on the
host, so every rank reaches the same verdict.

Ragged batches pad with identity points and zero windows: such a row
verifies true in the per-row check and adds the identity to the combined
sum, and is sliced off the result.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import torch


class Mesh(list):
    """An ordered list of ``torch.device`` (a device may repeat: two slices
    on one card).  ``owners[i]`` is the rank of the process that runs slice
    i and ``rank`` this process's rank; in one process every slice is its
    own.  Holds one CUDA stream per slice and a thread per local slice,
    made at first use."""

    def __init__(self, devices, owners=None, rank: int = 0):
        super().__init__(torch.device(d) for d in devices)
        if not self:
            raise ValueError("a mesh needs at least one device")
        self.owners = tuple(owners) if owners is not None else (rank,) * len(self)
        if len(self.owners) != len(self):
            raise ValueError(f"{len(self)} devices but {len(self.owners)} owners")
        self.rank = rank
        self.world = max(self.owners) + 1
        self.local = [i for i, o in enumerate(self.owners) if o == rank]
        self._lock = threading.Lock()
        self._streams: dict[int, torch.cuda.Stream] = {}
        self._pool: ThreadPoolExecutor | None = None

    @property
    def first(self) -> torch.device:
        """The device where the partial points meet: the first local one."""
        return self[self.local[0]] if self.local else torch.device("cpu")

    def _stream(self, i: int):
        with self._lock:
            if i not in self._streams:
                self._streams[i] = torch.cuda.Stream(device=self[i])
            return self._streams[i]

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=max(1, len(self.local)), thread_name_prefix="cpzk-shard")
            return self._pool

    def _caller_events(self) -> list:
        """An event on the calling thread's current stream of each local
        card.  The inputs a caller hands over may still be in flight on that
        stream (a view of a tensor on the slice's card is read in place,
        with no copy), and the slice streams are not ordered after it, so
        every slice waits on these events before it runs."""
        events = []
        for device in dict.fromkeys(self[i] for i in self.local):
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
                events.append(event)
        return events

    def _on_slice(self, i: int, fn, events: list):
        """``fn(i, device)`` on slice i's stream, after the caller's work
        (``events``).  The stream is synchronized before returning, and the
        caller holds its inputs until every slice has returned, so no input
        is freed while a slice still reads it."""
        device = self[i]
        if device.type != "cuda":
            return fn(i, device)
        stream = self._stream(i)
        with torch.cuda.device(device), torch.cuda.stream(stream):
            for event in events:
                stream.wait_event(event)
            out = fn(i, device)
            stream.synchronize()
        return out

    def run(self, fn) -> dict[int, object]:
        """``fn(i, device)`` for every slice this rank owns, concurrently
        (a thread each, each on its device's own stream, ordered after the
        caller's current streams) when a slice is on a card; then, across
        ranks, the union of every rank's results (small CPU objects) keyed
        by slice index.  Host slices run one after another: their plain
        versions hold the interpreter lock between small tensor operations,
        so threads would only contend."""
        events = self._caller_events()
        if len(self.local) == 1 or all(self[i].type != "cuda" for i in self.local):
            local = {i: self._on_slice(i, fn, events) for i in self.local}
        else:
            futs = {i: self._executor().submit(self._on_slice, i, fn, events)
                    for i in self.local}
            local = {i: f.result() for i, f in futs.items()}
        if self.world == 1:
            return local
        import torch.distributed as dist

        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local)
        merged: dict[int, object] = {}
        for part in gathered:
            merged.update(part)
        return merged


def _cuda_pool() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def batch_mesh(devices=None) -> Mesh:
    """A mesh over the given devices (a list that may repeat one device), or
    over every local CUDA device."""
    if isinstance(devices, Mesh):
        return devices
    devices = _cuda_pool() if devices is None else list(devices)
    if not devices:
        raise RuntimeError("batch_mesh: no CUDA device (pass an explicit device list)")
    return Mesh(devices)


def resolve_mesh_devices(mesh_devices: int | None, devices=None) -> Mesh | None:
    """The shared ``mesh_devices`` convention: ``None`` -> no mesh, ``0`` ->
    every device of the pool, ``k`` -> the first k.  The pool is ``devices``
    when given (an explicit list, which may repeat a device, or a
    :class:`Mesh` over the ranks of a job), else the local CUDA devices.
    Returns a mesh only when it has more than one slice.  Asking for more
    devices than the pool holds raises, naming both numbers."""
    if mesh_devices is None:
        return None
    pool = _cuda_pool() if devices is None else devices
    n_avail = len(pool)
    if mesh_devices > n_avail:
        raise ValueError(
            f"mesh_devices={mesh_devices} exceeds the {n_avail} visible "
            f"{'CUDA ' if devices is None else ''}device(s) on this host — fix "
            "the topology knob or the deployment (a silent clamp would serve "
            "at a fraction of the configured capacity)"
        )
    want = n_avail if mesh_devices == 0 else mesh_devices
    if want <= 1:
        return None
    if isinstance(pool, Mesh):
        return pool if want == n_avail else Mesh(pool[:want], pool.owners[:want], pool.rank)
    return Mesh(pool[:want])


def resolve_lane_devices(lanes: int, devices=None) -> list[torch.device] | None:
    """The devices of the per-device serving plane (``[tpu] lanes``): ``1``
    -> None (the single-lane path), ``-1`` -> one lane per device of the
    pool (None when it holds one), ``k > 1`` -> its first k devices,
    refused when k exceeds it.  The pool is ``devices`` when given (an
    explicit list, which may repeat a device), else the local CUDA
    devices, so nothing read from a config puts two lanes on one card."""
    if lanes == 1:
        return None
    pool = _cuda_pool() if devices is None else [torch.device(d) for d in devices]
    if lanes == -1:
        return pool if len(pool) > 1 else None
    if lanes > len(pool):
        raise ValueError(
            f"lanes={lanes} exceeds the {len(pool)} local "
            f"{'CUDA ' if devices is None else ''}device(s) on this host — one "
            "dispatch lane pins one local device"
        )
    return pool[:lanes]


def pad_to_multiple(pt, n_to: int):
    """Pad a ``[20, n]`` point with identity rows up to ``n_to`` lanes."""
    from ..ops import curve

    n = pt[0].shape[-1]
    if n == n_to:
        return pt
    pad = curve.identity((n_to - n,), pt[0].device)
    return tuple(torch.cat([c, pc], dim=-1) for c, pc in zip(pt, pad))


def pad_windows(w: torch.Tensor, n_to: int) -> torch.Tensor:
    """Pad a ``[k, n]`` window or digit tensor with zero lanes up to ``n_to``."""
    n = w.shape[-1]
    if n == n_to:
        return w
    return torch.cat([w, w.new_zeros(w.shape[:-1] + (n_to - n,))], dim=-1)


def _mesh_step(d: int, n: int) -> tuple[int, int]:
    """(step, n_to): the lanes one pass over the mesh takes, ``d`` times
    ``LANE_CHUNK``, and the padded total.  Padding is a d-multiple; past one
    step each device's share is rounded up to a ``LANE_QUANTUM`` multiple,
    so each device's program stays quantum-aligned and at most
    ``LANE_CHUNK`` lanes."""
    from ..ops import backend as _backend

    step = d * _backend.LANE_CHUNK
    if n <= step:
        n_to = -(-n // d) * d
    else:
        q = min(_backend.LANE_QUANTUM, _backend.LANE_CHUNK)
        per_device = -(-n // d)
        per_device = -(-per_device // q) * q
        n_to = per_device * d
    _note_occupancy(n, n_to)
    return step, n_to


def _note_occupancy(n: int, n_to: int) -> None:
    """``tpu.batch.occupancy``: true rows over padded mesh lanes."""
    from ..server import metrics

    metrics.gauge("tpu.batch.occupancy").set(n / n_to if n_to else 1.0)


def _slices(d: int, n_to: int, step: int) -> list[list[tuple[int, int]]]:
    """Per mesh slice, its ``(lo, hi)`` lane ranges, one per pass over the
    mesh (each pass a d-multiple of lanes, split in d contiguous parts)."""
    out: list[list[tuple[int, int]]] = [[] for _ in range(d)]
    for lo in range(0, n_to, step):
        hi = min(lo + step, n_to)
        per = (hi - lo) // d
        for k in range(d):
            out[k].append((lo + k * per, lo + (k + 1) * per))
    return out


def _take(pt, lo: int, hi: int, device):
    return tuple(c[..., lo:hi].to(device) for c in pt)


def _to(obj, device):
    """A tensor or a tuple of tensors (a point, a limb table) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    return tuple(_to(o, device) for o in obj)


def _partials_sum(mesh: Mesh, parts: list):
    """Stack ``[20, 1]`` CPU partial points on the mesh's first device and
    sum them (one ``[20]`` point)."""
    from ..ops import curve

    dev = mesh.first
    stacked = tuple(torch.cat([p[k] for p in parts], dim=-1).to(dev) for k in range(4))
    return curve.tree_sum(stacked, axis=-1)


def _is_identity(pt) -> bool:
    from ..ops import curve

    return bool(curve.is_identity(pt))


def _cpu_point(pt):
    return tuple(c.cpu() for c in pt)


def make_sharded_verify_each(mesh):
    """Per-row checker over ``mesh``: ``call(g, h, y1, y2, r1, r2, ws, wc)
    -> [n]`` bool (a CPU tensor); ``g``/``h`` ``[20, 1]`` (every slice gets
    a copy), the row tensors on any device."""
    from ..ops import verify

    mesh = batch_mesh(mesh)
    d = len(mesh)

    def call(g, h, y1, y2, r1, r2, ws, wc):
        n = ws.shape[-1]
        step, n_to = _mesh_step(d, n)
        y1, y2, r1, r2 = (pad_to_multiple(p, n_to) for p in (y1, y2, r1, r2))
        ws, wc = pad_windows(ws, n_to), pad_windows(wc, n_to)
        ranges = _slices(d, n_to, step)

        def work(i, dev):
            gd, hd = _to(g, dev), _to(h, dev)
            return [verify.verify_each_kernel(
                gd, hd, _take(y1, lo, hi, dev), _take(y2, lo, hi, dev),
                _take(r1, lo, hi, dev), _take(r2, lo, hi, dev),
                ws[:, lo:hi].to(dev), wc[:, lo:hi].to(dev)).cpu()
                for lo, hi in ranges[i]]

        bits = mesh.run(work)
        passes = len(ranges[0])
        return torch.cat([bits[k][s] for s in range(passes) for k in range(d)])[:n]

    return call


def sharded_verify_each(mesh, g, h, y1, y2, r1, r2, ws, wc):
    """One-shot wrapper over :func:`make_sharded_verify_each`."""
    return make_sharded_verify_each(mesh)(g, h, y1, y2, r1, r2, ws, wc)


def make_sharded_prove(mesh):
    """Bulk commitments over ``mesh``: ``call(tg, th, digits) -> (b1, b2)``,
    ``digits`` ``[64, n]`` (LSB window first), outputs ``[32, n]`` wire
    bytes on the CPU.  The comb tables are copied to each device once;
    there is nothing to combine (proofs are independent)."""
    from ..ops import prove_kernels

    mesh = batch_mesh(mesh)
    d = len(mesh)
    tables: dict[tuple, tuple] = {}
    lock = threading.Lock()

    def on(dev, tg, th):
        key = (str(dev), id(tg), id(th))
        with lock:
            if key not in tables:
                tables[key] = (_to(tg, dev), _to(th, dev))
                if dev.type == "cuda":
                    # another slice on this card reads the copy from its own
                    # stream: finish it before publishing it
                    torch.cuda.current_stream(dev).synchronize()
            return tables[key]

    def call(tg, th, digits):
        n = digits.shape[-1]
        step, n_to = _mesh_step(d, n)
        digits = pad_windows(digits, n_to)
        ranges = _slices(d, n_to, step)

        def work(i, dev):
            tgd, thd = on(dev, tg, th)
            outs = []
            for lo, hi in ranges[i]:
                b1, b2 = prove_kernels.commitments(tgd, thd, digits[:, lo:hi].to(dev))
                outs.append((b1.cpu(), b2.cpu()))
            return outs

        parts = mesh.run(work)
        order = [parts[k][s] for s in range(len(ranges[0])) for k in range(d)]
        b1 = torch.cat([p[0] for p in order], dim=-1)
        b2 = torch.cat([p[1] for p in order], dim=-1)
        return b1[:, :n], b2[:, :n]

    return call


def sharded_prove(mesh, tg, th, digits):
    """One-shot wrapper over :func:`make_sharded_prove`."""
    return make_sharded_prove(mesh)(tg, th, digits)


def make_sharded_combined_check(mesh):
    """Combined-RLC checker over ``mesh``: ``call(r1, y1, r2, y2, w_a, w_ac,
    w_ba, w_bac) -> bool``, the correction row already appended by the
    caller.  Each slice reduces to one partial point (per ``LANE_CHUNK``
    of it), and the partials' sum is tested against the identity."""
    from ..ops import backend as _backend
    from ..ops import verify

    mesh = batch_mesh(mesh)
    d = len(mesh)

    def call(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac):
        n = w_a.shape[-1]
        n_to = -(-n // d) * d
        _note_occupancy(n, n_to)
        pts = [pad_to_multiple(p, n_to) for p in (r1, y1, r2, y2)]
        ws = [pad_windows(w, n_to) for w in (w_a, w_ac, w_ba, w_bac)]
        per = n_to // d

        def work(i, dev):
            parts = []
            for lo, hi in _backend._chunk_bounds(per, _backend.LANE_CHUNK):
                lo, hi = i * per + lo, i * per + hi
                parts.append(_cpu_point(verify.combined_partial_kernel(
                    *(_take(p, lo, hi, dev) for p in pts),
                    *(w[:, lo:hi].to(dev) for w in ws))))
            return parts

        partials = mesh.run(work)
        return _is_identity(_partials_sum(mesh, [p for k in range(d) for p in partials[k]]))

    return call


def sharded_combined_check(mesh, r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac):
    """One-shot wrapper over :func:`make_sharded_combined_check`."""
    return make_sharded_combined_check(mesh)(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac)


def make_sharded_msm(mesh):
    """Pippenger MSM over ``mesh``: ``call(points, digits, c) -> point``
    (``[20]`` coordinates on the mesh's first device).  An MSM is a sum
    over its terms, so each slice runs the whole windowed MSM on its terms
    and gives one partial point per pass; the partials are summed."""
    from ..ops import msm

    mesh = batch_mesh(mesh)
    d = len(mesh)

    def call(points, digits, c: int):
        m = digits.shape[-1]
        step, m_to = _mesh_step(d, m)
        points = pad_to_multiple(points, m_to)
        digits = pad_windows(digits, m_to)
        ranges = _slices(d, m_to, step)

        def work(i, dev):
            return [_cpu_point(msm.msm_kernel(
                _take(points, lo, hi, dev), digits[:, lo:hi].to(dev), c))
                for lo, hi in ranges[i]]

        partials = mesh.run(work)
        return _partials_sum(mesh, [p for k in range(d) for p in partials[k]])

    return call


def make_sharded_msm_check(mesh):
    """Pippenger MSM == identity over ``mesh`` (:func:`make_sharded_msm`):
    ``call(points, digits, c) -> bool``."""
    total = make_sharded_msm(mesh)

    def call(points, digits, c: int):
        return _is_identity(total(points, digits, c))

    return call


def sharded_msm_check(mesh, points, digits, c: int):
    """One-shot wrapper over :func:`make_sharded_msm_check`."""
    return make_sharded_msm_check(mesh)(points, digits, c)
