"""The combined check's least time (the benchmark's own count of its work,
``benchmark/yardstick/roofline.py``) over the card's time in the kernels
the check launched (the profiler's kernels inside each batch's
``device_dispatch``), in percent over the traced window's batches."""

from benchmark.yardstick.roofline import combined_work


def read(run):
    rec = run["record"]
    tr = rec.get("trace")
    if not tr:
        return None
    kernel_s = sum(tr["check_kernel_s"])
    if kernel_s <= 0:
        return None
    least = sum(combined_work(b["rows"])["least_s"] for b in rec["batches"])
    return 100.0 * least / kernel_s
