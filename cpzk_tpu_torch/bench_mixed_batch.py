"""Backend time of the mixed 4096-entry batch of ``chip_smoke.py``'s
``serving_batch`` phase, repeated on one card, with the backend's per-call
serving hooks on and off.

    python -m cpzk_tpu_torch.bench_mixed_batch [--label NAME] [--reps 8]
        [--hooks on,off,no_events,no_gauges]

Run it from a checkout's root: it imports that checkout's ``chip_smoke.py``
for the corpus (4096 entries tiled from 256 seeded proofs, about 1%
tampered and two whose commitment wire does not decode).  To hold an older
commit against this one, unpack it with ``git archive`` into an ignored
directory, copy this file into its ``cpzk_tpu_torch/``, and run both trees
in one call, in turns (A B B A)::

    (cd _tmp/parent && python -m cpzk_tpu_torch.bench_mixed_batch --label parent)
    python -m cpzk_tpu_torch.bench_mixed_batch --label change --hooks on,off

Each rep parses the wires (deferred point validation), prepares the batch
and times ``BatchVerifier.run_prepared`` to a synchronised end: the
combined check fails on the tampered rows and ``verify_each`` decides per
row.  Each backend call is timed on the host clock, and within it the host
marshalling (``_elems_soa`` and ``curve.scalar_windows``).  ``--hooks off``
replaces the serving hooks of ``TorchBackend`` (the CUDA-event work
interval, the pad-waste and occupancy gauges, the marshal note) with
no-ops, ``no_events`` only the first, ``no_gauges`` only the other two; a
tree without them runs ``on`` only.  The modes take turns, in reversed
order every other rep.  With the hooks, it then times the hooks alone:
one call's worth (the work interval around an empty block on the idle
stream, the pad-waste note and the marshal note), 1000 times.  Prints one
JSON line per run, a summary line with the medians, and the card's
``nvidia-smi`` name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import subprocess
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--hooks", default="on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_mixed_batch: CUDA is not available", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from cpzk_tpu_torch import BatchVerifier, SecureRng
    from cpzk_tpu_torch.ops import backend as ob
    from cpzk_tpu_torch.ops import curve
    from cpzk_tpu_torch.ops import point_kernels as pk

    modes = args.hooks.split(",")
    has_hooks = hasattr(ob, "_note_pad_waste")
    if modes != ["on"] and not has_hooks:
        raise SystemExit("--hooks: this tree's backend has no serving hooks")
    pk.build()
    params, corpus, _provers = cs.make_corpus(cs.CORPUS, cs.SeededRng(cs.SEED))
    n = cs.SERVING_N
    _, mixed, bad, undecodable = cs.serving_wires(params, corpus, n)
    want_flagged = sorted([*bad, *undecodable])

    marshal = [0.0]

    def timed(fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                marshal[0] += time.perf_counter() - t0
        return wrapper

    ob._elems_soa = timed(ob._elems_soa)
    curve.scalar_windows = timed(curve.scalar_windows)

    hooks_on = {}
    if has_hooks:
        hooks_on = {"device_work": ob.TorchBackend._device_work,
                    "pad_waste": ob._note_pad_waste,
                    "note_marshal": ob.flightrec.note_marshal}

    def set_hooks(mode: str) -> None:
        if not has_hooks:
            return
        events = mode in ("on", "no_gauges")
        gauges = mode in ("on", "no_events")
        ob.TorchBackend._device_work = (
            hooks_on["device_work"] if events else lambda self: contextlib.nullcontext())
        ob._note_pad_waste = hooks_on["pad_waste"] if gauges else lambda n, pad: None
        ob.flightrec.note_marshal = hooks_on["note_marshal"] if gauges else lambda s: None

    class Split:
        """The card's backend, timing each call and its host marshalling."""

        def __init__(self, backend):
            self.backend = backend
            self.prefers_combined = backend.prefers_combined
            self.supports_deferred_decode = backend.supports_deferred_decode
            self.calls: list[dict] = []

        def _time(self, name, fn, *a):
            marshal[0] = 0.0
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            self.calls.append({"call": name, "rows": len(a[0]),
                               "s": time.perf_counter() - t0, "marshal_s": marshal[0]})
            return out

        def verify_combined(self, rows, beta):
            return self._time("combined", self.backend.verify_combined, rows, beta)

        def verify_each(self, rows):
            return self._time("each", self.backend.verify_each, rows)

    backend = ob.TorchBackend()

    def run_once() -> dict:
        proofs, statements, _, _ = cs.parse_entries(mixed, True)
        split = Split(backend)
        bv = BatchVerifier(backend=split, max_size=n)
        for (_, _, _, ctx), pr, st in zip(mixed, proofs, statements):
            bv.add_with_context(params, st, pr, ctx)
        prepared = bv.prepare_batch(SecureRng())
        gc.collect()
        t0 = time.perf_counter()
        results = bv.run_prepared(prepared)
        torch.cuda.synchronize()
        backend_s = time.perf_counter() - t0
        flagged = [i for i, r in enumerate(results) if r is not None]
        if flagged != want_flagged:
            raise AssertionError(f"flagged rows {flagged} != tampered + undecodable rows")
        return {"backend_s": backend_s, "calls": split.calls}

    set_hooks("on")
    run_once()  # warm-up: the generator-pair cache, the allocator, the library
    runs: dict[str, list[dict]] = {m: [] for m in modes}
    for rep in range(args.reps):
        for mode in (modes if rep % 2 == 0 else modes[::-1]):
            set_hooks(mode)
            r = run_once()
            runs[mode].append(r)
            print(json.dumps({"label": args.label, "hooks": mode, "rep": rep, **r}),
                  flush=True)
    set_hooks("on")

    def med(values):
        return statistics.median(values)

    summary = {"label": args.label, "n": n, "reps": args.reps,
               "device": torch.cuda.get_device_name(0)}
    for mode, rs in runs.items():
        summary[mode] = {
            "backend_s_median": med([r["backend_s"] for r in rs]),
            "backend_s_min": min(r["backend_s"] for r in rs),
            "backend_s_max": max(r["backend_s"] for r in rs),
            **{f"{c}_{k}_median": med([x[k] for r in rs for x in r["calls"] if x["call"] == c])
               for c in ("combined", "each") for k in ("s", "marshal_s")},
        }
    if has_hooks:
        reps = 1000
        with backend._scope():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                ob._note_pad_waste(n, 4096)
                with backend._device_work():
                    pass
                ob.flightrec.note_marshal(0.0)
            summary["hooks_alone_us_per_call"] = (time.perf_counter() - t0) / reps * 1e6
    print(json.dumps({"summary": summary}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
