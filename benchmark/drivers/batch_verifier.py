"""Driver of the ``batch_verifier`` entry: one caller holding wire bytes
verifies batch after batch with ``BatchVerifier`` in this process.

Set-up makes the population and a pool of batches from the seed (the
statements and commitments on the card, the challenges of every row on the
card, the responses on the host), then runs one batch of the same size
through the program to build and warm everything.  The pool holds the
batches that ``seconds`` at the mix's ``rate_ceiling`` would take, and one
more.  The window runs whole batches back to back, each parsed from its
wires and then verified, until ``seconds`` have passed; the rate is the
proofs of those batches over the time to the end of the last.  A pool that
runs out first leaves the window short, and the run is not correct.

After the window every verdict is compared with the one the batch was made
to get, and a sample drawn from the seed is checked by the group equations
from its wires alone.  Then ``check_batches`` more batches of the same size
go through the same path, batch j with one tampered row at a position drawn
from the seed inside the j-th of ``check_batches`` equal parts of its rows,
and every verdict of theirs is compared too: a path that checks only part
of a batch, in the combined check or in the per-row fallback, and answers
the rest as valid, fails them.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import tempfile
import time

from benchmark.harness import check
from benchmark.reference import proofs

ANCHOR = "benchmark.window"


class Spans:
    """Host intervals by label (``time.monotonic``), and the recorder
    handed to ``BatchVerifier.verify`` (its stages become spans)."""

    def __init__(self, profiler_marks: bool):
        self.intervals: dict[str, list] = {}
        self.marks = profiler_marks

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.monotonic()
        try:
            if self.marks:
                import torch

                with torch.profiler.record_function(f"benchmark.{name}"):
                    yield
            else:
                yield
        finally:
            self.intervals.setdefault(name, []).append((t0, time.monotonic()))


class GcSpans:
    """Garbage collections as monotonic intervals, and their seconds by
    generation."""

    def __init__(self):
        self.intervals: list = []
        self.by_generation = [0.0, 0.0, 0.0]
        self._t0 = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.monotonic()
        elif self._t0 is not None:
            t1 = time.monotonic()
            self.intervals.append((self._t0, t1))
            self.by_generation[info.get("generation", 2)] += t1 - self._t0
            self._t0 = None


def host_probe_s() -> float:
    """Seconds of a fixed pure-Python loop: the host's speed during a run,
    beside which its batch times can be read."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(2_000_000):
        acc += i * i
    return time.perf_counter() - t0


def _verdict(result):
    return None if result is None else (type(result).__name__, str(result))


def run(config, traffic, seed, seconds, trace, chips, options):
    import torch

    from cpzk_tpu_torch import BatchVerifier, Parameters, Proof, SecureRng, Statement
    from cpzk_tpu_torch.core.ristretto import Ristretto255
    from cpzk_tpu_torch.errors import Error
    from cpzk_tpu_torch.observability import flightrec
    from cpzk_tpu_torch.ops import ladder_kernels

    device = torch.device(options.get("device", "cuda:0"))
    rows = options.get("rows", config["batch_capacity"])
    pool_n = math.ceil(traffic["rate_ceiling"] * seconds / rows) + 1
    backend = options.get("backend")  # a test's CPU backend; None = the default

    # -- set-up: inputs from the seed, then one warm batch ------------------
    parts = {"start": options["age"]()}
    pop = proofs.population(seed, rows, device)
    parts["population"] = options["age"]()
    start = proofs.merlin.protocol_start(device)
    y1_items, y2_items = proofs.statement_items(pop)
    make = lambda i, tampered_rows=(): proofs.make_batch(
        pop, seed, i, traffic["context_bytes"], traffic["tampered_share"], start, tampered_rows)
    warm = make(pool_n)
    pool = [make(i) for i in range(pool_n)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    parts["pool"] = options["age"]()
    params = Parameters.new()
    rng = SecureRng()
    eb = Ristretto255.element_from_bytes

    def verify_batch(batch, spans, sink_out):
        """The program's path for one batch; its verdicts by row."""
        with spans.stage("parse"):
            parsed = Proof.from_bytes_batch(batch.items)
            statements = [Statement(eb(a), eb(b)) for a, b in zip(y1_items, y2_items)]
        verdicts = [None] * len(batch.items)
        with spans.stage("add"):
            bv = BatchVerifier(backend=backend, max_size=rows)
            queued = []
            for i, proof in enumerate(parsed):
                if isinstance(proof, Error):
                    verdicts[i] = _verdict(proof)
                    continue
                bv.add_with_context(params, statements[i], proof, batch.contexts[i])
                queued.append(i)
        sink, token = flightrec.install_sink()
        try:
            results = bv.verify(rng, stages=spans)
        finally:
            flightrec.uninstall_sink(token)
        for i, res in zip(queued, results, strict=True):
            verdicts[i] = _verdict(res)
        sink_out.append(sink)
        return verdicts

    def control_batch(batch, spans, sink_out):
        """The reference in the program's place, its challenges bound to no
        context: the guarantee the control breaks."""
        with spans.stage("control"):
            c = proofs.challenges(pop, None, start=start)
            s_want = proofs.responses(pop, c, [False] * pop.n)
            return [None if int.from_bytes(w[77:109], "little") == s else proofs.FAILED
                    for w, s in zip(batch.items, s_want)]

    path = control_batch if options.get("control") else verify_batch
    fault = options.get("fault")
    warm_spans = Spans(False)
    path(warm, warm_spans, [])
    del warm
    parts["warm"] = options["age"]()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    ladder_kernels.reset_launches()

    # -- the window -----------------------------------------------------------
    spans = Spans(trace)
    gcs = GcSpans()
    sinks: list = []
    done: list = []          # (batch, verdicts)
    bounds: list = []        # (start, end) of each batch
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    gc.callbacks.append(gcs)
    setup_s = options["age"]()
    with (torch.profiler.record_function(ANCHOR) if trace else contextlib.nullcontext()):
        anchor = t0 = time.monotonic()
    try:
        for batch in pool:
            b0 = time.monotonic()
            verdicts = path(batch, spans, sinks)
            bounds.append((b0, time.monotonic()))
            done.append((batch, verdicts))
            if bounds[-1][1] - t0 >= seconds:
                break
    finally:
        gc.callbacks.remove(gcs)
    t1 = bounds[-1][1]
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    launches = dict(ladder_kernels.LAUNCHES)
    probe_s = host_probe_s()
    del pool

    # -- the check batches: the same path, a tampered row in one part each -
    parts_n = traffic["check_batches"]
    place = proofs.rng_for(seed, 7)
    check_mismatched = 0
    for j in range(parts_n):
        lo, hi = j * rows // parts_n, (j + 1) * rows // parts_n
        batch = make(pool_n + 1 + j, tampered_rows=[lo + int(place.integers(hi - lo))])
        verdicts = path(batch, Spans(False), [])
        check_mismatched += len(batch.items) - len(verdicts)
        check_mismatched += sum(got != want for got, want in zip(verdicts, batch.expected))
        del batch

    # -- the faults a test plants: an answer altered, half the rows unanswered
    if fault == "flip":
        v = done[0][1]
        v[0] = proofs.FAILED if v[0] is None else None
    elif fault == "half":
        batch, v = done[-1]
        done[-1] = (batch, v[:len(v) // 2])

    # -- correctness, once the window has closed and its state is freed -------
    attempted = sum(len(b.items) for b, _ in done)
    mismatched = unanswered = failed = 0
    examples = []
    for bi, (batch, verdicts) in enumerate(done):
        unanswered += len(batch.items) - len(verdicts)
        failed += len(batch.items) - len(verdicts)
        for i, (got, want) in enumerate(zip(verdicts, batch.expected)):
            failed += got is not None
            if got != want:
                mismatched += 1
                if len(examples) < 5:
                    examples.append({"batch": bi, "row": i, "got": got, "want": want})
    sample_rng = proofs.rng_for(seed, 2)
    k = min(traffic["sample_rows"], attempted)
    picks = sorted({(int(b), int(i)) for b, i in zip(
        sample_rng.integers(0, len(done), k), sample_rng.integers(0, rows, k))})
    sample = [(done[b][0].contexts[i], y1_items[i], y2_items[i], done[b][0].items[i])
              for b, i in picks]
    group_ok = proofs.verify_wires(sample)
    sample_mismatched = 0
    for (b, i), ok in zip(picks, group_ok):
        want = None if ok else proofs.FAILED
        verdicts = done[b][1]
        if i >= len(verdicts) or verdicts[i] != want or done[b][0].expected[i] != want:
            sample_mismatched += 1
    on_card = launches["ladder_combined"] + launches["ladder_each"]
    compared = {
        "verdicts_mismatched": check(mismatched, "<=", 0),
        "rows_unanswered": check(unanswered, "<=", 0),
        "sample_group_mismatched": check(sample_mismatched, "<=", 0),
        "sample_rows": check(len(picks), ">", 0),
        "check_batch_mismatched": check(check_mismatched, "<=", 0),
        "window_s": check(round(t1 - t0, 4), ">=", seconds),
    }
    if device.type == "cuda":
        compared["ladder_launches"] = check(on_card, ">", 0)
    correct = all(c["ok"] for c in compared.values())

    batches = []
    for (b0, b1), sink in zip(bounds, sinks or [None] * len(bounds)):
        batches.append({"rows": rows, "start": b0, "end": b1,
                        "marshal_s": sink.marshal_s if sink else None,
                        "device_interval_s": sink.device_interval_s if sink else None,
                        "device_start": sink.device_start if sink else None})
    record = {
        "setup_s": setup_s, "window_s": t1 - t0, "rows_done": attempted,
        "batches": batches, "spans": spans.intervals, "gc": gcs.intervals,
        "launches": launches, "trace": None,
    }
    if prof is not None:
        record["trace"] = _reduce_trace(prof, anchor, t0, t1, spans, gcs, batches)
    return {
        "correct": correct, "attempted": attempted, "failed": failed,
        "device": {"memory_peak_bytes": int(memory_peak)},
        "record": record, "compared": compared, "examples": examples,
        "notes": {"setup_parts_s": parts, "batches": len(bounds), "pool_batches": pool_n,
                  "batch_s": [round(b - a, 4) for a, b in bounds],
                  "gc_s_by_generation": [round(v, 4) for v in gcs.by_generation],
                  "host_probe_s": round(probe_s, 4), "loadavg": os.getloadavg(),
                  "cpus": len(os.sched_getaffinity(0))},
        "breakdown": None if record["trace"] is None else {
            "device_ops": record["trace"]["device_ops"],
            "idle_gaps": record["trace"]["idle_gaps"]},
    }


def _reduce_trace(prof, anchor, t0, t1, spans, gcs, batches):
    """The profiler's trace on the window: the card's busy time, its idle
    gaps by the host's span, its operations, and the kernel time of each
    batch's check."""
    from benchmark.yardstick import trace as tr

    fd, path = tempfile.mkstemp(suffix=".json", prefix="benchmark-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        anchor_ts, device = tr.load_device_events(path, ANCHOR)
    finally:
        os.unlink(path)
    if anchor_ts is None:
        return None
    shift = anchor_ts - anchor
    on = lambda iv: [(a + shift, b + shift) for a, b in iv]
    labels = {}
    for name, iv in spans.intervals.items():
        if name == "device_dispatch":
            # the backend marshals before its first launch: split the stage
            # at the card's start as the backend reported it
            marshal, dispatch = [], []
            for (a, b), batch in zip(iv, batches):
                cut = batch["device_start"] if batch["device_start"] is not None else a
                cut = min(max(cut, a), b)
                marshal.append((a, cut))
                dispatch.append((cut, b))
            labels["marshal"] = on(marshal)
            labels["device_dispatch"] = on(dispatch)
        else:
            labels[name] = on(iv)
    checks = on(spans.intervals.get("device_dispatch", []))
    out = tr.reduce(device, (t0 + shift, t1 + shift), labels, on(gcs.intervals), checks)
    out["device_events"] = len(device)
    return out
