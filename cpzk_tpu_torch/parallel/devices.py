"""Lane-count discovery over the local CUDA devices: the port of
``resolve_lane_devices`` (``cpzk_tpu/parallel/mesh.py``)."""

from __future__ import annotations

import torch


def resolve_lane_devices(lanes: int) -> list[torch.device] | None:
    """The devices of the per-device serving plane (``[tpu] lanes``):
    ``1`` -> None (the single-lane path), ``-1`` -> one lane per local
    CUDA device (None when there is only one), ``k > 1`` -> the first k
    local devices, rejected when k exceeds the local count.  Returns a
    device list only when a real multi-lane plane would be built."""
    if lanes == 1:
        return None
    n_local = torch.cuda.device_count()
    if lanes == -1:
        return ([torch.device("cuda", i) for i in range(n_local)]
                if n_local > 1 else None)
    if lanes > n_local:
        raise ValueError(
            f"lanes={lanes} exceeds the {n_local} local CUDA device(s) on "
            "this host — one dispatch lane pins one local chip"
        )
    return [torch.device("cuda", i) for i in range(lanes)]
