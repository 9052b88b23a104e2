"""Assembly of the serving plane: the port of ``build_backend``
(``cpzk_tpu/server/__main__.py``).

``[tpu] backend = "tpu"`` selects the device plane: ``TorchBackend`` on a
CUDA card behind a :class:`~cpzk_tpu_torch.server.batching.DynamicBatcher`.
With ``[tpu] lanes`` resolving to more than one device the batcher places
each batch on one of N per-device lanes through a
:class:`~cpzk_tpu_torch.server.router.LaneRouter` (one ``TorchBackend`` per
lane device, plus a mesh lane over all of them when ``mesh_threshold > 0``);
otherwise one lane serves, sharded over a mesh when ``mesh_devices``
resolves to more than one device.

No hidden fallback: each lane serves its card bare, so a kernel launch
that fails, a CUDA fault or an out-of-memory fails its batch (and, with
lanes, opens that lane's own breaker).  The reference's card-to-host
failover is opt-in on the single lane: a caller that passes ``fallback=``
gets a :class:`~cpzk_tpu_torch.protocol.batch.FailoverBackend` over the
card and that backend, whose trips log WARNING and count
``tpu.backend.failover``.  :func:`~cpzk_tpu_torch.ops.backend.prewarm`
first builds the CUDA kernels and runs the combined check at every
configured quantum on every device that serves, so a kernel that fails to
build or to launch raises out of :func:`build_backend` before anything
serves.
"""

from __future__ import annotations

import logging
import time

from ..parallel.mesh import resolve_lane_devices, resolve_mesh_devices
from ..protocol.batch import FailoverBackend, VerifierBackend
from . import metrics
from .batching import DynamicBatcher
from .config import TpuSettings, validate_tpu

log = logging.getLogger("cpzk_tpu_torch.server.plane")


def build_backend(
    tpu: TpuSettings,
    device=None,
    fallback: VerifierBackend | None = None,
    devices=None,
) -> tuple[VerifierBackend | None, DynamicBatcher | None]:
    """(backend, batcher) for the ``[tpu]`` settings: the card behind a
    dynamic batching queue, or ``(None, None)`` when ``backend != "tpu"``
    (inline host verification, as in the reference).

    The device pool that ``lanes`` and ``mesh_devices`` resolve against is
    ``devices`` when given (an explicit list, which may repeat a device:
    the tests' CPU "devices", two lanes on one card), else ``[device]``
    when a device is pinned, else every local CUDA card; ``device=None``
    then means ``cuda:0`` and raises without CUDA.  The CPU runs only when
    asked for (the plain PyTorch versions of the kernels).  With several
    lanes the returned backend is lane 0's and the batcher carries the
    router.  ``fallback`` wraps a single lane in a ``FailoverBackend``
    with the settings' ``recovery_after_s`` and ``probe_batch_max``."""
    if tpu.backend != "tpu":
        return None, None
    validate_tpu(tpu)
    import torch

    from ..ops import backend as ops_backend

    if devices is not None and device is not None:
        raise ValueError("build_backend: pass device= or devices=, not both")
    if devices is not None:
        pool = [torch.device(d) for d in devices]
        if not pool:
            raise ValueError("build_backend: devices= is empty")
    elif device is not None:
        pool = [torch.device(device)]
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_backend: CUDA is not available (pass device='cpu' "
                "to serve on the plain PyTorch versions on the CPU)")
        pool = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    recovery_after_s = None if tpu.recovery_after_s == -1 else tpu.recovery_after_s
    quanta = tpu.parsed_prewarm_quanta()
    lane_devices = resolve_lane_devices(tpu.lanes, pool)
    if lane_devices is not None:
        from .router import LaneRouter

        _prewarm(ops_backend, quanta, lane_devices)
        lane_backends = [ops_backend.TorchBackend(device=d) for d in lane_devices]
        mesh_backend = None
        if tpu.mesh_threshold > 0:
            mesh_backend = ops_backend.TorchBackend(
                mesh_devices=len(lane_devices), devices=lane_devices)
        router = LaneRouter(
            lane_backends,
            devices=lane_devices,
            overlap=tpu.pipeline_depth > 1,
            staging_slots=max(1, tpu.pipeline_depth - 1),
            recovery_after_s=recovery_after_s,
            mesh_backend=mesh_backend,
            mesh_threshold=tpu.mesh_threshold,
        )
        metrics.gauge("tpu.lanes").set(len(lane_devices))
        log.info(
            "serving plane: %d per-device dispatch lanes over %s (of %d "
            "devices), mesh path %s",
            len(lane_devices), ", ".join(str(d) for d in lane_devices), len(pool),
            f"at >= {tpu.mesh_threshold} entries" if tpu.mesh_threshold > 0 else "off",
        )
        batcher = DynamicBatcher(
            lane_backends[0],
            max_batch=tpu.batch_max,
            window_ms=tpu.batch_window_ms,
            pipeline_depth=tpu.pipeline_depth,
            shed_expired=tpu.shed_expired,
            router=router,
        )
        return lane_backends[0], batcher

    # mesh_devices: 0 = shard over every device of the pool, k = the first
    # k; a pool of one serves that device alone
    mesh = resolve_mesh_devices(tpu.mesh_devices, pool)
    _prewarm(ops_backend, quanta, list(mesh) if mesh is not None else pool[:1])
    if mesh is not None:
        backend: VerifierBackend = ops_backend.TorchBackend(
            mesh_devices=tpu.mesh_devices, devices=pool)
    else:
        backend = ops_backend.TorchBackend(device=pool[0])
    if fallback is not None:
        backend = FailoverBackend(
            backend,
            fallback,
            recovery_after_s=recovery_after_s,
            probe_batch_max=tpu.probe_batch_max,
        )
    metrics.gauge("tpu.lanes").set(1)
    log.info(
        "serving plane: single dispatch lane on %s%s", pool[0],
        f" (mesh over {len(mesh)} devices for in-batch sharding)" if mesh is not None else "",
    )
    batcher = DynamicBatcher(
        backend,
        max_batch=tpu.batch_max,
        window_ms=tpu.batch_window_ms,
        pipeline_depth=tpu.pipeline_depth,
        shed_expired=tpu.shed_expired,
    )
    return backend, batcher


def _prewarm(ops_backend, quanta, devices) -> None:
    """Build the kernels and prewarm every quantum once on each distinct
    device that will serve."""
    seen: list = []
    for d in devices:
        if d in seen:
            continue
        seen.append(d)
        t0 = time.monotonic()
        warmed = ops_backend.prewarm(quanta, d)
        log.info(
            "prewarmed the verify kernels on %s for batch quanta %s in %.1fs (%s)",
            d, quanta, time.monotonic() - t0,
            ", ".join(f"{k} {v:.2f}s" for k, v in warmed.items()) or "nothing to build",
            extra={"prewarm_s": warmed},
        )
