"""Device time per launch of the two point kernels, for one or more builds
of their sources, in one run on one card.

    python -m cpzk_tpu_torch.bench_kernels [--ns 1,6144,16384] [--reps 50]
        [--rounds 4] [--sass] [NAME=CSRC_DIR ...]

Each ``NAME=CSRC_DIR`` names a directory holding a ``point_ops.cu`` with the
C launch interface of ``cpzk_tpu_torch/csrc/point_ops.cu``, for example an
older commit's ``cpzk_tpu_torch/csrc`` unpacked with ``git archive`` into an
ignored directory; with none, the package's own ``csrc``.  Every build is
first checked against the plain PyTorch versions at each lane count (equal
after canonicalization, output limbs within the loose bound), then timed in
turns (A B B A ...): ``reps`` back-to-back launches under torch.profiler,
after a traced warm-up step, for the kernel's own device time per launch
(the profiler can miss launches; the count it saw is reported, and a step
where it saw none is traced again).
With ``--sass``, also the static instruction count of each kernel and its
most frequent opcodes, read from ``cuobjdump -sass`` of the build.  Prints
one JSON line per build, then the card's ``nvidia-smi`` name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .ops import limbs, point_kernels as pk

KERNELS = ("point_add", "point_double_k")
K = 4  # doublings per launch on the main path


def _inputs(dev: torch.device, n: int, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-limbs.BOUND, limbs.BOUND + 1, size=(20, n))
                             .astype(np.int32)).to(dev) for _ in range(8)]


def _launcher(lib, name: str, ins: list[torch.Tensor], outs: list[torch.Tensor]):
    n = ins[0].shape[1]
    stream = torch.cuda.current_stream(ins[0].device).cuda_stream
    if name == "point_add":
        ptrs = [t.data_ptr() for t in ins + outs]

        def launch():
            rc = lib.cpzk_point_add(*ptrs, n, stream)
            if rc:
                raise RuntimeError(f"point_add launch failed: CUDA error {rc}")
    else:
        ptrs = [t.data_ptr() for t in ins[:3] + outs]

        def launch():
            rc = lib.cpzk_point_double_k(*ptrs, n, K, stream)
            if rc:
                raise RuntimeError(f"point_double_k launch failed: CUDA error {rc}")
    return launch


def _check(name: str, ins, outs) -> tuple[int, int]:
    """(max canonical error, max |limb|) of a kernel's outputs against the
    plain version on the same inputs."""
    if name == "point_add":
        ref = pk.point_add_plain(tuple(ins[:4]), tuple(ins[4:]))
    else:
        ref = pk.point_double_k_plain(tuple(ins[:4]), K)
    err = max(int((limbs.canonical(a) - limbs.canonical(r)).abs().max())
              for a, r in zip(outs, ref))
    return err, max(int(a.abs().max()) for a in outs)


def _device_us(launch, reps: int, name: str) -> tuple[float, int]:
    """Device time per launch of ``name``'s kernel over the launches the
    profiler saw of ``reps`` (it can miss some), from the second of two
    profiled steps, and how many it saw."""
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(reps):
                launch()
            torch.cuda.synchronize()
            prof.step()
    total = count = 0
    for evt in traces[-1]:
        if f"::{name}_kernel(" in evt.key:
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0))
            count += evt.count
    return (total / count if count else None), count


def sass_counts(lib_path: Path) -> dict:
    """Static SASS instruction count and the ten most frequent opcodes of
    each kernel in a built library."""
    cuobjdump = Path(pk._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300, check=True)
    ops: dict[str, collections.Counter] = {}
    current = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((k for k in KERNELS if f"{k}_kernel" in m.group(1)), None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current:
            ops.setdefault(current, collections.Counter())[m.group(1)] += 1
    return {k: {"instructions": sum(c.values()) - c["NOP"], "top": c.most_common(10)}
            for k, c in ops.items()}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", default="1,6144,16384")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("builds", nargs="*", metavar="NAME=CSRC_DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ns = [int(x) for x in args.ns.split(",")]
    specs = [b.split("=", 1) for b in args.builds] or [["this", str(pk.CSRC)]]

    builds = {}
    for name, csrc in specs:
        path, report = pk.build(Path(csrc))
        lib = pk.load(path)
        data = {n: _inputs(dev, n, n) for n in ns}
        outs = {n: [torch.empty_like(data[n][0]) for _ in range(4)] for n in ns}
        check = {}
        for k in KERNELS:
            for n in ns:
                _launcher(lib, k, data[n], outs[n])()
                torch.cuda.synchronize()
                err, limb_max = _check(k, data[n], outs[n])
                if err or limb_max > limbs.BOUND:
                    raise AssertionError(
                        f"{name} {k} n={n}: canonical error {err}, max limb {limb_max}")
                check[f"{k}/{n}"] = {"max_abs_err": err, "max_limb": limb_max}
        builds[name] = {"lib": lib, "data": data, "outs": outs, "check": check,
                        "ptxas": pk.ptxas_report(report), "csrc": csrc,
                        "sass": sass_counts(path) if args.sass else None,
                        "us": {k: {n: [] for n in ns} for k in KERNELS},
                        "seen": {k: {n: [] for n in ns} for k in KERNELS}}

    order = list(builds)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            b = builds[name]
            for k in KERNELS:
                for n in ns:
                    launch = _launcher(b["lib"], k, b["data"][n], b["outs"][n])
                    for _ in range(3):
                        us, seen = _device_us(launch, args.reps, k)
                        if seen:
                            break
                    if not seen:
                        raise RuntimeError(f"{name} {k} n={n}: the profiler saw no launch")
                    b["us"][k][n].append(us)
                    b["seen"][k][n].append(seen)

    for name, b in builds.items():
        print(json.dumps({
            "build": name, "csrc": b["csrc"], "ptxas": b["ptxas"], "sass": b["sass"],
            "check": b["check"],
            "reps": args.reps, "rounds": args.rounds,
            "us_per_launch": {k: {n: {"median": statistics.median(v), "runs": v,
                                      "launches_seen": b["seen"][k][n]}
                                  for n, v in b["us"][k].items()} for k in KERNELS},
        }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
