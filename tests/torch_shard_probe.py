"""An ingest shard that reports, when the supervisor stops it, what it
imported: the target ``tests/test_torch_isolation.py`` spawns in place of
``cpzk_tpu_torch.server.ingest.run_shard``."""

from __future__ import annotations

import json
import os
import signal
import sys


def probe_shard(index: int, uds_path: str, options: dict) -> None:
    out_path = options.pop("probe_out")

    def report(*_args) -> None:
        torch = sys.modules.get("torch")
        doc = {
            "modules": sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "cpzk_tpu")),
            "torch_imported": torch is not None,
            "cuda_initialized": bool(torch is not None and torch.cuda.is_initialized()),
            "ingest_loaded": "cpzk_tpu_torch.server.ingest" in sys.modules,
        }
        with open(f"{out_path}.{index}", "w") as f:
            json.dump(doc, f)
        os._exit(0)

    signal.signal(signal.SIGTERM, report)
    from cpzk_tpu_torch.server import ingest

    ingest.run_shard(index, uds_path, options)
