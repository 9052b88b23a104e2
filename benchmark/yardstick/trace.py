"""Reduction of a ``torch.profiler`` Chrome trace to the card's busy time,
its idle gaps by what the host was doing, and its operations by name.

The host's spans are taken on ``time.monotonic`` by the benchmark; one
``record_function`` anchor, entered at a known monotonic instant, maps them
onto the trace's clock.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys):
    """Intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys):
    """``xs`` without ``ys`` (both sorted and disjoint)."""
    out = []
    j = 0
    for a, b in xs:
        cur = a
        while j < len(ys) and ys[j][1] <= cur:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cur:
                out.append((cur, ys[k][0]))
            cur = max(cur, ys[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def total(xs) -> float:
    return sum(b - a for a, b in xs)


def kernel_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    if name.startswith("void "):
        name = name[5:]
    return name.split("<", 1)[0][:96]


def load_device_events(path, anchor: str):
    """(anchor's trace time in seconds, [(name, start s, end s, category)]
    of the card's operations) from a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    anchor_ts = None
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ts = float(e["ts"]) / 1e6
            device.append((e.get("name", cat), ts, ts + float(e.get("dur", 0.0)) / 1e6, cat))
        elif cat == "user_annotation" and e.get("name") == anchor and anchor_ts is None:
            anchor_ts = float(e["ts"]) / 1e6
    return anchor_ts, device


def reduce(device, window, spans, gc_spans, check_spans=()):
    """The card's busy seconds, idle gaps by host label and operations by
    name over ``window``; and the card's kernel seconds inside each of
    ``check_spans``.

    All times are on one clock (seconds).  ``spans`` maps a label to the
    host's intervals under it (disjoint across labels); ``gc_spans`` are
    collections, which take precedence over any label."""
    w0, w1 = window
    busy = intersect(merge((a, b) for _, a, b, _ in device), [(w0, w1)])
    idle = subtract([(w0, w1)], busy)
    gaps = defaultdict(float)
    gc = merge(gc_spans)
    gaps["gc"] = total(intersect(idle, gc))
    rest = subtract(idle, gc)
    for label, intervals in spans.items():
        part = intersect(rest, merge(intervals))
        gaps[label] += total(part)
        rest = subtract(rest, merge(intervals))
    gaps["other"] += total(rest)
    ops = defaultdict(float)
    for name, a, b, _ in device:
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            ops[kernel_name(name)] += hi - lo
    kernels = [(a, b) for _, a, b, cat in device if cat == "kernel"]
    check = []
    for a, b in check_spans:
        check.append(sum(min(y, b) - max(x, a) for x, y in kernels if min(y, b) > max(x, a)))
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1]) if v > 0][:10]
    return {
        "busy_s": total(busy),
        "window_s": w1 - w0,
        "device_ops": top(ops),
        "idle_gaps": top(gaps),
        "check_kernel_s": check,
    }
