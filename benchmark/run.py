"""Run one cell of the benchmark and print its result as the last line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a run under ``torch.profiler``.  The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``compared``, the result's last key.  The run fails
without a result when there is no card, when the program is absent, or
when JAX or the package the program was ported from is loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def execute(workload_name: str, seed: int, seconds: float, trace: bool, age,
            control: bool = False, traffic_over: dict | None = None) -> int:
    """One run of a cell: its result line on standard output, the numbers
    compared on standard error; the exit code.  ``control`` and
    ``traffic_over`` serve :mod:`benchmark.probe` alone."""
    from benchmark import harness

    bench = harness.Bench()
    for key, value in harness.cache_env(bench.root).items():
        os.environ.setdefault(key, value)
    workload = bench.workload(workload_name)
    config = bench.config(workload["config"])
    traffic = {**bench.traffic(workload["traffic"]), **(traffic_over or {})}

    import torch

    chips = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    driver = bench.driver(config["entry"])
    run = driver.run(config, traffic, seed, seconds, trace, chips,
                     {"age": age, "control": control})
    run["device"] = {**harness.device_info(chips), **run["device"]}
    if run["record"].get("trace"):
        run["device"]["busy_s"] = run["record"]["trace"]["busy_s"]
        run["device"]["window_s"] = run["record"]["trace"]["window_s"]
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    line = harness.result_line(bench, workload_name, trace, run)
    print(f"benchmark: record {json.dumps(run.get('notes', {}))}", file=sys.stderr)
    if run.get("examples"):
        print(f"benchmark: mismatches {json.dumps(run['examples'])}", file=sys.stderr)
    for text in harness.compared_lines(run["compared"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    from benchmark import harness

    age0 = harness.process_age_s
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    return execute(args.workload, args.seed, args.seconds, bool(args.trace), age0)


if __name__ == "__main__":
    sys.exit(main())
