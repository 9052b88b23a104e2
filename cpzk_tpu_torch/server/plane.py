"""Assembly of the single-card serving plane: the port of
``build_backend`` (``cpzk_tpu/server/__main__.py``).

``[tpu] backend = "tpu"`` selects the device plane, which here is one
CUDA card: ``TorchBackend`` behind a
:class:`~cpzk_tpu_torch.server.batching.DynamicBatcher`.

No hidden fallback: the card is served bare, so a kernel launch that
fails, a CUDA fault or an out-of-memory fails its batch and reaches the
callers.  The reference's card-to-host failover is opt-in: a caller that
passes ``fallback=`` gets a
:class:`~cpzk_tpu_torch.protocol.batch.FailoverBackend` over the card and
that backend, whose trips log WARNING and count ``tpu.backend.failover``.
Either way :func:`~cpzk_tpu_torch.ops.backend.prewarm` first builds the
CUDA kernels and runs the combined check at every configured quantum, so
a kernel that fails to build or to launch raises out of
:func:`build_backend` before anything serves.
"""

from __future__ import annotations

import logging
import time

from ..errors import InvalidParams
from ..parallel.devices import resolve_lane_devices
from ..protocol.batch import FailoverBackend, VerifierBackend
from . import metrics
from .batching import DynamicBatcher
from .config import TpuSettings, validate_tpu

log = logging.getLogger("cpzk_tpu_torch.server.plane")


def build_backend(
    tpu: TpuSettings,
    device=None,
    fallback: VerifierBackend | None = None,
) -> tuple[VerifierBackend | None, DynamicBatcher | None]:
    """(backend, batcher) for the ``[tpu]`` settings: the card behind a
    dynamic batching queue, or ``(None, None)`` when ``backend != "tpu"``
    (inline host verification, as in the reference).

    ``device=None`` means ``cuda:0`` and raises without CUDA; the CPU runs
    only when asked for (``device="cpu"``, the plain PyTorch versions of
    the kernels).  The backend is ``TorchBackend`` itself unless a
    ``fallback`` is passed: then it is a ``FailoverBackend`` that degrades
    to it, with the settings' ``recovery_after_s`` and
    ``probe_batch_max``.  A ``lanes`` setting that resolves to more than one
    device, or a mesh over more than one card, raises ``InvalidParams``:
    the multi-GPU serving plane is not ported yet, and this never serves
    such a setting on one lane."""
    if tpu.backend != "tpu":
        return None, None
    validate_tpu(tpu)
    import torch

    from ..ops import backend as ops_backend

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "build_backend: CUDA is not available (pass device='cpu' "
                "to serve on the plain PyTorch versions on the CPU)")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    lane_devices = resolve_lane_devices(tpu.lanes)
    if lane_devices is not None:
        raise InvalidParams(
            f"tpu.lanes = {tpu.lanes} resolves to {len(lane_devices)} "
            "devices, but the multi-GPU serving plane is not ported yet; "
            "set tpu.lanes = 1"
        )
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    if tpu.mesh_devices > 1 or (tpu.mesh_devices == 0 and cards > 1):
        raise InvalidParams(
            f"tpu.mesh_devices = {tpu.mesh_devices} asks for a mesh over "
            f"more than one card ({cards} visible), but the multi-GPU "
            "serving plane is not ported yet; set tpu.mesh_devices = 1"
        )

    quanta = tpu.parsed_prewarm_quanta()
    t0 = time.monotonic()
    warmed = ops_backend.prewarm(quanta, device)
    log.info(
        "prewarmed the verify kernels on %s for batch quanta %s in %.1fs (%s)",
        device, quanta, time.monotonic() - t0,
        ", ".join(f"{k} {v:.2f}s" for k, v in warmed.items()) or "nothing to build",
        extra={"prewarm_s": warmed},
    )
    backend: VerifierBackend = ops_backend.TorchBackend(device=device)
    if fallback is not None:
        recovery_after_s = (
            None if tpu.recovery_after_s == -1 else tpu.recovery_after_s
        )
        backend = FailoverBackend(
            backend,
            fallback,
            recovery_after_s=recovery_after_s,
            probe_batch_max=tpu.probe_batch_max,
        )
    metrics.gauge("tpu.lanes").set(1)
    log.info("serving plane: single dispatch lane on %s", device)
    batcher = DynamicBatcher(
        backend,
        max_batch=tpu.batch_max,
        window_ms=tpu.batch_window_ms,
        pipeline_depth=tpu.pipeline_depth,
        shed_expired=tpu.shed_expired,
    )
    return backend, batcher
