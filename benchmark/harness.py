"""The benchmark's driver-independent parts: finding a cell, its
configuration, its traffic mix and its metrics by name; the run's
environment and set-up clock; the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

- a configuration: the ``file`` of its ``configs`` entry (JSON), whose
  ``entry`` names the driver module ``benchmark/drivers/<entry>.py``;
- a traffic mix: ``benchmark/traffic/<traffic>.json``, parameters that the
  driver's one generator reads;
- a metric: ``benchmark/metrics/<name>.py``, a ``read(run)`` that returns
  the metric's value from the run's record, or None when it finds nothing
  to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
#: modules whose presence after the window fails a run: JAX, and the JAX
#: package the program was ported from (compared by whole top-level names)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cpzk_tpu")


class Bench:
    """``BENCHMARK.json`` of a checkout and the files it names."""

    def __init__(self, root: Path | str | None = None):
        self.root = Path(root) if root is not None else PACKAGE_DIR.parent
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def metrics_of(self, workload: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def driver(self, entry: str):
        path = self.dir / "drivers" / f"{entry}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark.drivers.{entry}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), the set-up clock's
    zero."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED_AT


_IMPORTED_AT = time.monotonic()


def cache_env(root: Path) -> dict:
    """Fixed cache directories inside the checkout for every build or
    kernel cache a run could fill."""
    cache = root / ".bench_cache"
    return {
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "TRITON_CACHE_DIR": str(cache / "triton"),
        "CUDA_CACHE_PATH": str(cache / "nv"),
        "CPZK_FLIGHTREC_DUMP": str(cache / "flightrec.json"),
        "USE_FLAX": "0",
    }


def forbidden_loaded() -> list[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def result_line(bench: Bench, workload: str, trace: bool, run: dict) -> dict:
    """The result object: each of the cell's metrics from its reader, the
    numbers compared beside their limits last."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(workload, kind):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {
        "correct": run["correct"],
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": metrics,
        "device": run["device"],
    }
    if trace and run.get("breakdown"):
        out["breakdown"] = run["breakdown"]
    out["compared"] = run["compared"]
    return out


def compared_lines(compared: dict) -> list[str]:
    return [f"{name}: {c['value']} (limit {c['rule']} {c['limit']})"
            for name, c in compared.items()]


def check(value, rule: str, limit) -> dict:
    """A number compared beside its limit; ``ok`` whether it holds."""
    value = value.item() if hasattr(value, "item") else value
    ok = {"<=": value <= limit, ">": value > limit, ">=": value >= limit,
          "==": value == limit}[rule]
    return {"value": value, "rule": rule, "limit": limit, "ok": bool(ok)}
