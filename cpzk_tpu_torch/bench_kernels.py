"""Device time per launch of the two point kernels, for one or more builds
of their sources, in one run on one card; then the scalar and MSM kernels
against their plain versions.

    python -m cpzk_tpu_torch.bench_kernels [--ns 1,6144,16384] [--reps 50]
        [--rounds 4] [--sass] [--no-pippenger]
        [--ladder | --prove | --small | --challenge | --decode] [--ks 1,2,8,92]
        [NAME=CSRC_DIR ...]

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
one JSON line per build.

Unless ``--no-pippenger``, then the A/B of the package's four kernels of the
Pippenger path against their plain versions, at the main path's shapes (a
4096-row Pippenger check: ``rlc_scalars`` on 4096 rows, ``scalar_recode``
into the digits of 18,432 terms at c = 11, ``msm_bucket`` and
``msm_window_reduce`` on a 16,384-term chunk at c = 11): each first checked
(exact, or equal encodings for the MSM), then timed with CUDA events in
turns (plain, kernel, kernel, plain per round): ``reps`` launches of the
kernel, or one call of the plain version, between two events.  One JSON
line.

Then the A/B of the batch prover's and the device challenges' kernels
against their plain versions at the main path's shapes (``comb_tables`` of
G; ``commitments``, ``keccak_chain`` with three masks and ``reduce_wide``
at 16,384 lanes), checked the same way and timed with CUDA events, each
kernel's ``reps`` launches held behind a spin kernel (:func:`event_ms`)
so that they run back to back, in the same turns (the plain comb tables,
some 700k launches, once); and the twins of the reference's challenge
benchmark (``benches/bench_kernels.py``'s ``challenge_native_cpp``,
``challenge_device`` and ``challenge_device_reduced``): thousands of
challenges a second of the host core's ``challenge_batch``, of
``derive_challenges_device`` on the card, and of the same with the bytes
reduced mod l on the card, best of ``rounds`` at each of 4096 and 16,384
rows.  One JSON line, then the card's ``nvidia-smi`` name and power limit.
Needs a CUDA device.

With ``--ladder``, instead of all that, the A/B of the per-row ladder
kernels (``ladder_combined``, ``ladder_each``) of each build (a directory
holding the package's ``csrc`` sources, the ladder kernels among them) at
each lane count: random valid points (sums of multiples of the base point)
and random windows, the per-row check also with g and h shared
(``ladder_each_shared``), each build first checked against the plain versions
(the combined total equal as a group element, the per-row bits equal),
then timed in turns (A B B A ...) by :func:`event_ms`, ``reps`` launches
held behind a spin kernel; with ``--sass``, each kernel's static SASS
instruction count.  One JSON line, then the ``nvidia-smi`` line.

With ``--prove``, instead, the A/B of the batch prover's kernels of each
build: ``comb_tables`` of G (``n`` 1 in the output) and ``commitments`` at
each lane count (``--ns``; digits of random scalars with 0, 1, l - 1 and
2^256 - 1, the G and H tables the build's own ``comb_tables`` made), each
build first checked (its bytes equal to ``commitments_plain``'s at every
lane count; its tables equal to the plain tables in its layout:
``table_words``', or the parent's 64 x 16 extended entries after
canonicalization), then timed in turns by :func:`event_ms`, ``reps``
launches held behind a spin kernel.  With ``--sass``, each kernel's static
SASS count; registers and spills from ``-Xptxas -v``.  One JSON line, then
the ``nvidia-smi`` line.

With ``--small``, instead, the A/B of the two small kernels of the verify
path of each build: ``ladder_partials_identity`` over k random totals for
each k of ``--ks`` (pairs P, -P of random points in scaled coordinates,
the identity for odd k) and ``rlc_scalars`` on each of ``--ns`` rows
(random scalars with 0, 1 and l - 1; its ticket zeroed by a fill launch
a call, as the parent's wrapper zeroes it, and for a build whose kernel
leaves its ticket zeroed also without it, ``rlc_scalars_kept_ticket``, as
this package's wrapper calls it), each build first checked (the partials'
verdict equal to the plain version's, valid and with one total replaced;
the scalars equal to ``rlc_scalars_plain``'s, ``torch.equal``), then
timed in turns by :func:`event_ms`, ``reps`` calls held behind a spin
kernel; beside them an empty kernel's time (``launch_floor``, from the
builds that have ``cpzk_launch_floor``).  ``ladder_partials_identity/2``
is the partials' chain floor (one add), ``rlc_scalars/1`` the scalars'
(one row).  Beside them ``scalar_recode`` of each build at the paths'
shapes (:data:`RECODE_CASES`: the digits of a 4096-row Pippenger check,
18,432 terms at c = 11; the windows of a 4096- and a 16,384-row per-row
check, 4 x 6,144 and 4 x 18,432 lanes; and its chain floor, the digits of
one row), called through the C entry point with the wrappers' arguments,
each first checked against ``rlc_digits_plain``/``rlc_windows_plain``
(``torch.equal``).  With ``--sass``, each kernel's static SASS count.  One
JSON line, then the ``nvidia-smi`` line.

With ``--decode``, instead, the A/B of ``ristretto_decode`` of each build
at each of ``--ns`` lanes (:func:`decode_case`: the generators' and the
identity's encodings, rejected cases, then random bytes), each build first
checked (words and validity equal to ``ristretto_decode_plain``'s,
``torch.equal``), then timed in turns by :func:`event_ms`, ``reps``
launches held behind a spin kernel; ``/1`` is the chain floor (one lane);
beside them the launch floor.  With ``--sass``, the kernel's static SASS
count; registers and spills from ``-Xptxas -v``.  One JSON line, then the
``nvidia-smi`` line.

With ``--challenge``, instead, the A/B of the device challenges' two
kernels of each build at each of ``--ns`` rows: ``keccak_chain`` with
three random masks and one shared random state (the path's shape) and
``reduce_wide`` of 40-limb wide values (:func:`wide_case`: 0, 1, l - 1, l,
2 l, 2^252, 2^256 - 1, 2^512 - 1, then random), each build first checked
(words and limbs equal to the plain versions', ``torch.equal``), then
timed in turns by :func:`event_ms`, ``reps`` launches held behind a spin
kernel; beside them the launch floor (an empty kernel).  ``/1`` is each
kernel's chain floor (one row).  With ``--sass``, each kernel's static
SASS count; registers and spills from ``-Xptxas -v``.  One JSON line,
then the ``nvidia-smi`` line.
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


def sass_counts(lib_path: Path, kernels=KERNELS) -> dict:
    """Static SASS instruction count and the ten most frequent opcodes of
    each of ``kernels`` in a built library."""
    cuobjdump = Path(pk._nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300, check=True)
    ops: dict[str, collections.Counter] = {}
    current = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = next((k for k in kernels if f"{k}_kernel" in m.group(1)), None)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and current:
            ops.setdefault(current, collections.Counter())[m.group(1)] += 1
    return {k: {"instructions": sum(c.values()) - c["NOP"], "top": c.most_common(10)}
            for k, c in ops.items()}


#: cycles of ``torch.cuda._sleep`` that hold the stream while the host
#: enqueues a timed run of launches (about 10 ms at 1980 MHz)
SPIN_CYCLES = 20_000_000


def event_ms(fn, calls: int = 1, hold: bool = False) -> float:
    """Milliseconds per call of ``calls`` back-to-back calls of ``fn``,
    between two CUDA events on the current stream (the caller warms ``fn``
    first).  With ``hold``, a spin kernel (``torch.cuda._sleep``) holds the
    stream until the host has enqueued every call, so that launches shorter
    than their host-side cost still run back to back on the card."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def pippenger_kernels(dev: torch.device, reps: int, rounds: int) -> dict:
    """The four kernels of the Pippenger path against their plain versions
    at a 4096-row check's shapes (see the module docstring)."""
    import random

    from .core import edwards
    from .core.scalars import L
    from .ops import curve, msm, msm_kernels as mk, scalar_kernels as sk, sclimbs as sc

    rng = random.Random(9)
    n, c, chunk = 4096, 11, 16384
    al, cl, sl = (torch.from_numpy(sc.ints_to_limbs([rng.randrange(L) for _ in range(n)]))
                  .to(dev) for _ in range(3))
    bl = torch.from_numpy(sc.ints_to_limbs([rng.randrange(L)])).to(dev)
    ac, ba, bac, corr0, corr1 = sk.rlc_scalars_plain(al, cl, sl, bl)
    groups, m = (al, ac, ba, bac), 18432
    base = curve.points_to_device(
        [edwards.pt_scalar_mul(edwards.BASEPOINT, rng.randrange(L)) for _ in range(64)], dev)
    idx = torch.from_numpy(np.random.default_rng(9).integers(0, 64, (2, chunk))).to(dev)
    pts = pk.point_add_plain(tuple(x[:, idx[0]] for x in base),
                             tuple(x[:, idx[1]] for x in base))
    digits = torch.from_numpy(msm.scalars_to_signed_digits(
        [rng.randrange(L) for _ in range(chunk)], c)).to(dev)
    buckets = msm.bucket_sums_plain(pts, digits, c)
    cases = {
        "rlc_scalars": (lambda: sk.rlc_scalars(al, cl, sl, bl),
                        lambda: sk.rlc_scalars_plain(al, cl, sl, bl)),
        "scalar_recode": (lambda: sk.rlc_digits(groups, corr0, corr1, n, m, c),
                          lambda: sk.rlc_digits_plain(groups, corr0, corr1, n, m, c)),
        "msm_bucket": (lambda: mk.msm_bucket(pts, digits, c),
                       lambda: msm.bucket_sums_plain(pts, digits, c)),
        "msm_window_reduce": (lambda: mk.msm_window_reduce(buckets, c),
                              lambda: msm.window_reduce_plain(buckets, c)),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if name.startswith("msm"):
            ok = torch.equal(curve.encode(got), curve.encode(ref))
        else:
            ok = torch.equal(got, ref) if isinstance(got, torch.Tensor) else all(
                torch.equal(g, r) for g, r in zip(got, ref))
        if not ok:
            raise AssertionError(f"{name}: kernel and plain version differ")
        k_ms, p_ms = [], []
        for _ in range(rounds):
            p_ms.append(event_ms(plain))
            k_ms.append(event_ms(kernel, reps))
            k_ms.append(event_ms(kernel, reps))
            p_ms.append(event_ms(plain))
        out[name] = {"kernel_ms": statistics.median(k_ms), "plain_ms": statistics.median(p_ms),
                     "kernel_runs": k_ms, "plain_runs": p_ms}
    return {"pippenger_kernels": out, "rows": n, "terms": m, "chunk": chunk, "c": c,
            "reps": reps, "rounds": rounds}


def prover_kernels(dev: torch.device, reps: int, rounds: int) -> dict:
    """The batch prover's and the device challenges' kernels against their
    plain versions, and the challenge benchmark's twins (see the module
    docstring)."""
    import random
    import time

    from .core import _native
    from .core.scalars import L
    from .ops import challenge, curve, keccak_kernels as kk, prove_kernels as pvk
    from .ops import sclimbs as sc
    from .ops.prove import _windows_lsb
    from .protocol.gadgets import Parameters

    rng = random.Random(10)
    np_rng = np.random.default_rng(10)
    n = 16384
    params = Parameters.new()
    g = curve.points_to_device([params.generator_g.point], dev)
    h = curve.points_to_device([params.generator_h.point], dev)
    tg, th = pvk.comb_tables(g), pvk.comb_tables(h)
    plain_tables = pvk.comb_tables_plain(g), pvk.comb_tables_plain(h)
    digits = torch.from_numpy(_windows_lsb([rng.randrange(L) for _ in range(n)])).to(dev)

    def ints(shape):
        return torch.from_numpy(np_rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    state, masks = (ints((25, 1)), ints((25, 1))), (ints((3, 25, n)), ints((3, 25, n)))
    wide = torch.from_numpy(sc.bytes_wide_to_limbs(
        np_rng.integers(0, 256, (n, 64), dtype=np.uint8))).to(dev)
    cases = {
        "comb_tables": (lambda: pvk.comb_tables(g), lambda: pvk.comb_tables_plain(g)),
        "commitments": (lambda: pvk.commitments(tg, th, digits),
                        lambda: pvk.commitments_plain(*plain_tables, digits)),
        "keccak_chain": (lambda: kk.keccak_chain(*state, *masks),
                         lambda: kk.keccak_chain_plain(*state, *masks)),
        "reduce_wide": (lambda: sc.reduce_wide(wide), lambda: sc.reduce_wide_plain(wide)),
    }
    out = {}
    for name, (kernel, plain) in cases.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if name == "comb_tables":
            ok = torch.equal(got, pvk.table_words(ref))
        else:
            ok = torch.equal(got, ref) if isinstance(got, torch.Tensor) else all(
                torch.equal(a, b) for a, b in zip(got, ref))
        if not ok:
            raise AssertionError(f"{name}: kernel and plain version differ")
        # the plain comb tables take ~10 s a call: timed once
        once = name == "comb_tables"
        k_ms, p_ms = [], []
        for r in range(rounds):
            if r == 0 or not once:
                p_ms.append(event_ms(plain))
            k_ms.append(event_ms(kernel, reps, hold=True))
            k_ms.append(event_ms(kernel, reps, hold=True))
            if not once:
                p_ms.append(event_ms(plain))
        out[name] = {"kernel_ms": statistics.median(k_ms), "plain_ms": statistics.median(p_ms),
                     "kernel_runs": k_ms, "plain_runs": p_ms}

    rates = {}
    gw, hw = params.generator_g.wire(), params.generator_h.wire()
    for m in (4096, 16384):
        cols = [np.frombuffer(np_rng.bytes(32 * m), dtype=np.uint8).reshape(m, 32)
                for _ in range(4)]
        args = (None, np.frombuffer(gw * m, dtype=np.uint8).reshape(m, 32),
                np.frombuffer(hw * m, dtype=np.uint8).reshape(m, 32), *cols)
        blobs = [gw * m, hw * m] + [c.tobytes() for c in cols]

        def native():
            return _native.challenge_batch([None] * m, *blobs)

        def device():
            return challenge.derive_challenges_device(*args, device=dev)

        def reduced():
            chal = device()
            out_ = sc.reduce_wide(torch.from_numpy(sc.bytes_wide_to_limbs(chal)).to(dev))
            torch.cuda.synchronize()
            return out_

        if device().tobytes() != native():
            raise AssertionError(f"device challenges at {m} rows differ from the host core's")
        best = {}
        for label, fn in (("challenge_native_cpp", native), ("challenge_device", device),
                          ("challenge_device_reduced", reduced)):
            fn()
            times = []
            for _ in range(rounds):
                t0 = time.perf_counter()
                fn()
                times.append(time.perf_counter() - t0)
            best[label] = m / min(times) / 1e3
        rates[m] = {"kchal_per_s": best}
    return {"prover_kernels": out, "lanes": n, "masks": 3, "reps": reps, "rounds": rounds,
            "challenges": rates}


LADDER_KERNELS = ("ladder_combined", "ladder_each")
#: the A/B's cases: the kernels, and the per-row check with g and h shared
#: (the serving path's case)
LADDER_CASES = LADDER_KERNELS + ("ladder_each_shared",)


def _ladder_inputs(dev: torch.device, n: int, seed: int):
    """Four [20, n] points (sums of two of 64 random multiples of the base
    point) and four [64, n] random windows."""
    import random

    from .core import edwards
    from .core.scalars import L
    from .ops import curve

    rng = random.Random(seed)
    base = curve.points_to_device(
        [edwards.pt_scalar_mul(edwards.BASEPOINT, rng.randrange(L)) for _ in range(64)], dev)
    idx = torch.from_numpy(np.random.default_rng(seed).integers(0, 64, (8, n))).to(dev)
    pts = [pk.point_add_plain(tuple(x[:, idx[2 * k]] for x in base),
                              tuple(x[:, idx[2 * k + 1]] for x in base)) for k in range(4)]
    wins = [torch.from_numpy(np.random.default_rng(seed + k).integers(0, 16, (64, n))
                             .astype(np.int32)).to(dev) for k in range(4)]
    return pts, wins


def _ladder_launcher(lib, name: str, pts, wins, dev: torch.device):
    """A launch of case ``name`` (:data:`LADDER_CASES`) from ``lib`` on these
    inputs (the combined check on the four points and windows; the per-row
    check with g, h, y1, y2, r1, r2 = the points 0, 1, 0, 1, 2, 3 and the
    first two windows, or with g and h lane 0's points 0 and 1, shared), and
    its outputs."""
    from .ops import ladder_kernels as lk

    combined = name == "ladder_combined"
    wkeep, wptrs, wlds, n = lk._windows(name, wins if combined else wins[:2], dev)
    g, h = pts[0], pts[1]
    if name == "ladder_each_shared":
        g, h = (tuple(c[:, :1].contiguous() for c in p) for p in (g, h))
    points = pts if combined else [g, h, pts[0], pts[1], pts[2], pts[3]]
    keep, ptrs, lds, steps = lk._points(name, points, n, dev)
    # g and h shared (steps 0) keep only the -Y tables in the scratch; a
    # build whose function takes two arguments ignores the third
    shared = not combined and steps[0] == 0 and steps[1] == 0
    scratch = torch.empty((lib.cpzk_ladder_scratch_words(n, int(not combined), int(shared)),),
                          dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if combined:
        out = [torch.empty((20, 1), dtype=torch.int32, device=dev) for _ in range(4)]
        ok = torch.empty((), dtype=torch.bool, device=dev)
        optrs, old = lk._ptrs([o.data_ptr() for o in out]), lk._i64([1])

        def launch():
            rc = lib.cpzk_ladder_combined(ptrs, lds, steps, wptrs, wlds, scratch.data_ptr(),
                                          optrs, old, ok.data_ptr(), n, stream)
            if rc:
                raise RuntimeError(f"ladder_combined launch failed: CUDA error {rc}")
        return launch, (out, ok), (keep, wkeep, scratch)
    bits = torch.empty((n,), dtype=torch.bool, device=dev)

    def launch():
        rc = lib.cpzk_ladder_each(ptrs, lds, steps, wptrs, wlds, scratch.data_ptr(),
                                  bits.data_ptr(), n, stream)
        if rc:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return launch, bits, (keep, wkeep, scratch)


def ladder_ab(dev: torch.device, specs, ns, reps: int, rounds: int, sass: bool) -> dict:
    """The ``--ladder`` A/B (see the module docstring)."""
    from .ops import curve, verify

    data = {n: _ladder_inputs(dev, n, n) for n in ns}
    refs = {}
    for n, (pts, wins) in data.items():
        first = [tuple(c[:, :1] for c in p) for p in pts[:2]]
        refs[n] = (verify.combined_partial_kernel_plain(*pts, *wins),
                   verify.verify_each_kernel_plain(pts[0], pts[1], pts[0], pts[1], pts[2],
                                                   pts[3], wins[0], wins[1]),
                   verify.verify_each_kernel_plain(*first, pts[0], pts[1], pts[2], pts[3],
                                                   wins[0], wins[1]))
    builds = {}
    for name, csrc in specs:
        path, report = pk.build(Path(csrc))
        lib = pk.load(path)
        launchers = {}
        for k in LADDER_CASES:
            for n in ns:
                launch, out, keep = _ladder_launcher(lib, k, *data[n], dev)
                launch()
                torch.cuda.synchronize()
                if k == "ladder_combined":
                    total = tuple(c[:, 0] for c in out[0])
                    if not bool(curve.eq(total, tuple(c[:, 0] for c in refs[n][0]))):
                        raise AssertionError(f"{name} {k} n={n}: total differs from plain")
                elif not torch.equal(out, refs[n][1 if k == "ladder_each" else 2]):
                    raise AssertionError(f"{name} {k} n={n}: bits differ from plain")
                launchers[(k, n)] = (launch, keep)
        builds[name] = {"launchers": launchers, "csrc": csrc,
                        "ptxas": {k: v for k, v in pk.ptxas_report(report).items()
                                  if k.startswith("ladder")},
                        "sass": sass_counts(path, LADDER_KERNELS) if sass else None,
                        "ms": {f"{k}/{n}": [] for k in LADDER_CASES for n in ns}}
    order = list(builds)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            b = builds[name]
            for (k, n), (launch, _) in b["launchers"].items():
                b["ms"][f"{k}/{n}"].append(event_ms(launch, reps, hold=True))
    return {"ladder_ab": {name: {"csrc": b["csrc"], "ptxas": b["ptxas"], "sass": b["sass"],
                                 "reps": reps, "rounds": rounds,
                                 "timed_by": "event_ms, launches held behind a spin kernel",
                                 "ms_per_launch": {key: {"median": statistics.median(v),
                                                         "runs": v}
                                                   for key, v in b["ms"].items()}}
                          for name, b in builds.items()}}


PROVE_KERNELS = ("comb_tables", "commitments")


def _canonical_extended(lim: torch.Tensor) -> torch.Tensor:
    """``[64, 16, 4, 20]`` limbs -> the same, each coordinate canonical."""
    return limbs.canonical(lim.movedim(-1, 0)).movedim(0, -1)


def prove_ab(dev: torch.device, specs, ns, reps: int, rounds: int, sass: bool) -> dict:
    """The ``--prove`` A/B (see the module docstring)."""
    import random

    from .core.scalars import L
    from .ops import curve, prove_kernels as pvk
    from .ops.prove import _windows_lsb
    from .protocol.gadgets import Parameters

    params = Parameters.new()
    gens = [curve.points_to_device([e.point], dev)
            for e in (params.generator_g, params.generator_h)]
    # the plain tables on the host (seconds), then on the card
    plain = [tuple(c.to(dev) for c in pvk.comb_tables_plain(
        tuple(c.cpu() for c in p))) for p in gens]
    # a build's tables in either layout: the package's words exactly, or the
    # parent's 64 x 16 extended entries (words of the value mod p) after
    # canonicalization
    words = [pvk.table_words(t).reshape(-1) for t in plain]
    extended = [_canonical_extended(torch.stack([c[..., 0] for c in t], dim=2))
                for t in plain]
    size = 64 * 16 * 4 * 8
    layouts = {
        "affine, 9 entries": lambda t, k: torch.equal(t[:words[k].numel()], words[k]),
        "extended, 16 entries": lambda t, k: torch.equal(_canonical_extended(
            pk.limbs_of_words(t.reshape(64, 16, 4, 8))), extended[k]),
    }
    rng = random.Random(18)
    digits, refs = {}, {}
    for n in ns:
        vals = [0, 1, L - 1, 2**256 - 1][:n] + [rng.randrange(L) for _ in range(n - 4)]
        digits[n] = torch.from_numpy(_windows_lsb(vals)).to(dev)
        refs[n] = pvk.commitments_plain(*plain, digits[n])
    stream = torch.cuda.current_stream(dev).cuda_stream
    builds = {}
    for name, csrc in specs:
        path, report = pk.build(Path(csrc))
        lib = pk.load(path)
        tables = [torch.empty((size,), dtype=torch.int32, device=dev) for _ in gens]

        def comb(k, lib=lib, tables=tables):
            rc = lib.cpzk_comb_tables(*(c.data_ptr() for c in gens[k]), tables[k].data_ptr(),
                                      stream)
            if rc:
                raise RuntimeError(f"comb_tables launch failed: CUDA error {rc}")

        for k in range(2):
            comb(k)
        torch.cuda.synchronize()
        layout = next((lay for lay, same in layouts.items()
                       if all(same(t, k) for k, t in enumerate(tables))), None)
        if layout is None:
            raise AssertionError(f"{name} comb_tables: the tables differ from plain in "
                                 f"every layout")
        launchers = {("comb_tables", 1): lambda comb=comb: comb(0)}
        for n in ns:
            out = [torch.empty((32, n), dtype=torch.uint8, device=dev) for _ in range(2)]

            def commit(lib=lib, tables=tables, n=n, out=out):
                rc = lib.cpzk_commitments(tables[0].data_ptr(), tables[1].data_ptr(),
                                          digits[n].data_ptr(), out[0].data_ptr(),
                                          out[1].data_ptr(), n, stream)
                if rc:
                    raise RuntimeError(f"commitments launch failed: CUDA error {rc}")

            commit()
            torch.cuda.synchronize()
            if not (torch.equal(out[0], refs[n][0]) and torch.equal(out[1], refs[n][1])):
                raise AssertionError(f"{name} commitments n={n}: bytes differ from plain")
            launchers[("commitments", n)] = commit
        builds[name] = {"launchers": launchers, "csrc": csrc, "layout": layout,
                        "ptxas": {k: v for k, v in pk.ptxas_report(report).items()
                                  if k in PROVE_KERNELS},
                        "sass": sass_counts(path, PROVE_KERNELS) if sass else None,
                        "ms": {f"{k}/{n}": [] for k, n in launchers}}
    order = list(builds)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            b = builds[name]
            for (k, n), launch in b["launchers"].items():
                b["ms"][f"{k}/{n}"].append(event_ms(launch, reps, hold=True))
    return {"prove_ab": {name: {key: b[key] for key in ("csrc", "layout", "ptxas", "sass")}
                         | {"reps": reps, "rounds": rounds,
                            "timed_by": "event_ms, launches held behind a spin kernel",
                            "ms_per_launch": {key: {"median": statistics.median(v), "runs": v}
                                              for key, v in b["ms"].items()}}
                         for name, b in builds.items()},
            "checked": "each build's commitments bytes equal to the plain version's at "
                       "every n; its tables equal to the plain tables in its layout"}


SMALL_KERNELS = ("ladder_partials_identity", "rlc_scalars")


def random_totals(rng: np.random.Generator, k: int, valid: bool) -> list[tuple]:
    """k host points (x, y, z, t) summing to the identity: pairs P, -P of
    random points and, for odd k, the identity, in random order; not
    ``valid``: one replaced by another random point.  Each point's
    coordinates are scaled by a random factor (projective, not Z = 1).  The
    inputs of ``ladder_partials_identity`` here, in ``chip_smoke.py`` and in
    the tests."""
    from .core import edwards
    from .core.scalars import L

    def scalar() -> int:
        return int.from_bytes(rng.bytes(64), "little") % L

    pts = []
    for _ in range(k // 2):
        p = edwards.pt_scalar_mul(edwards.BASEPOINT, scalar())
        pts += [p, ((-p[0]) % edwards.P, p[1], p[2], (-p[3]) % edwards.P)]
    pts += [edwards.IDENTITY] * (k % 2)
    pts = [pts[i] for i in rng.permutation(k)]
    if not valid:
        pts[int(rng.integers(k))] = edwards.pt_scalar_mul(edwards.BASEPOINT, scalar())
    scaled = []
    for p in pts:
        f = scalar() % (edwards.P - 1) + 1
        scaled.append(tuple(c * f % edwards.P for c in p))
    return scaled


def rlc_case(rng: np.random.Generator, case: str, n: int) -> list[list[int]]:
    """a, c, s (n scalars each) and [beta] of an ``rlc_scalars`` case:
    ``"random"`` below l with 0, 1 and l - 1 among the first rows,
    ``"l_minus_1"`` every scalar l - 1, ``"ninth_word"`` a = l - 1 and s =
    1 in every row, so that the rows' a s sum to n (l - 1): past 2^256 (the
    kernel's unreduced sum's ninth word) from 14 rows on."""
    from .core.scalars import L

    def scalars(count: int) -> list[int]:
        return [int.from_bytes(rng.bytes(64), "little") % L for _ in range(count)]

    if case == "l_minus_1":
        return [[L - 1] * n for _ in range(3)] + [[L - 1]]
    if case == "ninth_word":
        return [[L - 1] * n, scalars(n), [1] * n, scalars(1)]
    cols = [scalars(n) for _ in range(3)]
    edges = [0, 1, L - 1]
    for k, v in enumerate(cols):
        v[:min(n, 3)] = (edges[k:] + edges[:k])[:min(n, 3)]
    return cols + [scalars(1)]


def small_ab(dev: torch.device, specs, ns, ks, reps: int, rounds: int, sass: bool) -> dict:
    """The ``--small`` A/B (see the module docstring)."""
    from .ops import curve, ladder_kernels as lk, scalar_kernels as sk, sclimbs as sc, verify

    rng = np.random.default_rng(19)
    totals = {(k, valid): curve.points_to_device(random_totals(rng, k, valid), dev)
              for k in ks for valid in (True, False)}
    scalars = {n: tuple(torch.from_numpy(sc.ints_to_limbs(v)).to(dev)
                        for v in rlc_case(rng, "random", n)) for n in ns}
    refs = {n: sk.rlc_scalars_plain(*args) for n, args in scalars.items()}
    recodes = {case: recode_case(rng, dev, *shape) for case, shape in RECODE_CASES.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    builds = {}
    for name, csrc in specs:
        path, report = pk.build(Path(csrc))
        lib = pk.load(path)
        launchers = {}
        for (k, valid), parts in totals.items():
            keep, ptrs, lds, _ = lk._points("ladder_partials_identity", (parts,), k, dev)
            ok = torch.empty((), dtype=torch.bool, device=dev)

            def partials(lib=lib, ptrs=ptrs, lds=lds, ok=ok, k=k):
                rc = lib.cpzk_ladder_partials_identity(ptrs, lds, ok.data_ptr(), k, stream)
                if rc:
                    raise RuntimeError(f"ladder_partials_identity launch failed: CUDA error {rc}")

            partials()
            torch.cuda.synchronize()
            if bool(ok) is not valid or bool(verify.partials_identity_plain(parts)) is not valid:
                raise AssertionError(f"{name} ladder_partials_identity k={k} valid={valid}: "
                                     f"{bool(ok)}")
            if valid:
                launchers[("ladder_partials_identity", k)] = (partials, keep)
        for n, args in scalars.items():
            out = [torch.empty((20, n), dtype=torch.int32, device=dev) for _ in range(3)]
            corr = [torch.empty((20, 1), dtype=torch.int32, device=dev) for _ in range(2)]
            # 9 words a block: this design's partials (the parent's take 8)
            part = torch.empty((lib.cpzk_rlc_scalars_blocks(n), 9), dtype=torch.int32, device=dev)
            ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
            ptrs = [t.data_ptr() for t in args[:4]] + [t.data_ptr() for t in out] + [
                part.data_ptr(), ticket.data_ptr()] + [t.data_ptr() for t in corr]

            def rlc(lib=lib, ptrs=ptrs, ticket=ticket, n=n, zero=True):
                if zero:
                    ticket.zero_()
                rc = lib.cpzk_rlc_scalars(*ptrs, n, stream)
                if rc:
                    raise RuntimeError(f"rlc_scalars launch failed: CUDA error {rc}")

            rlc()
            torch.cuda.synchronize()
            if not all(torch.equal(g, r) for g, r in zip(out + corr, refs[n])):
                raise AssertionError(f"{name} rlc_scalars n={n}: differs from plain")
            launchers[("rlc_scalars", n)] = (rlc, (out, corr, part, ticket))
            if n > 1 and int(ticket.item()) == 0:
                # a build whose kernel leaves its ticket zeroed: also the
                # call as its wrapper makes it, without the fill launch
                launchers[("rlc_scalars_kept_ticket", n)] = (
                    lambda rlc=rlc: rlc(zero=False), None)
        for case, (args, ref) in recodes.items():
            out = torch.empty_like(ref)

            def recode(lib=lib, args=args, out=out):
                rc = lib.cpzk_scalar_recode(*args[:12], out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"scalar_recode launch failed: CUDA error {rc}")

            recode()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"{name} scalar_recode {case}: differs from plain")
            launchers[("scalar_recode", case)] = (recode, out)
        if hasattr(lib, "cpzk_launch_floor"):
            def empty(lib=lib):
                rc = lib.cpzk_launch_floor(stream)
                if rc:
                    raise RuntimeError(f"cpzk_launch_floor failed: CUDA error {rc}")

            launchers[("launch_floor", 0)] = (empty, None)
        builds[name] = {"launchers": launchers, "csrc": csrc,
                        "ptxas": {k: v for k, v in pk.ptxas_report(report).items()
                                  if k in SMALL_KERNELS + ("scalar_recode",)},
                        "sass": sass_counts(path, SMALL_KERNELS + ("scalar_recode",))
                        if sass else None,
                        "ms": {f"{k}/{n}": [] for k, n in launchers}}
    order = list(builds)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            b = builds[name]
            for (k, n), (launch, _) in b["launchers"].items():
                b["ms"][f"{k}/{n}"].append(event_ms(launch, reps, hold=True))
    return {"small_ab": {name: {key: b[key] for key in ("csrc", "ptxas", "sass")}
                         | {"reps": reps, "rounds": rounds,
                            "timed_by": "event_ms, calls held behind a spin kernel",
                            "ms_per_launch": {key: {"median": statistics.median(v), "runs": v}
                                              for key, v in b["ms"].items()}}
                         for name, b in builds.items()},
            "checked": "each build's partials verdicts (valid and tampered), "
                       "rlc_scalars outputs and scalar_recode windows and digits equal "
                       "to the plain versions'"}


#: ``scalar_recode``'s A/B cases: (mode, rows n, lanes pad, terms m, c),
#: the shapes of the paths (pad and m as ``ops/backend.py`` pads them)
RECODE_CASES = {
    "digits_4096_rows": (1, 4096, 4096, 18432, 11),
    "windows_4096_rows": (0, 4096, 6144, 0, 4),
    "windows_16384_rows": (0, 16384, 18432, 0, 4),
    "digits_1_row": (1, 1, 1, 6, 11),
}


def recode_case(rng: np.random.Generator, dev: torch.device, mode: int, n: int, pad: int,
                m: int, c: int):
    """(the C entry point's arguments but the output and the stream, the
    plain version's output) of a ``scalar_recode`` case: four random
    ``[20, pad]`` groups below l (0, 1, l - 1 and 2^253 - 1 in the first
    lanes) and two random corrections, lane n spliced (windows) or the
    first n lanes of each group as terms (digits)."""
    from .core.scalars import L
    from .ops import msm, scalar_kernels as sk, sclimbs as sc

    def limbs_of(count: int) -> torch.Tensor:
        vals = [int.from_bytes(rng.bytes(64), "little") % L for _ in range(count)]
        vals[:min(count, 4)] = [0, 1, L - 1, 2**253 - 1][:min(count, 4)]
        return torch.from_numpy(sc.ints_to_limbs(vals)).to(dev)

    groups = [limbs_of(pad) for _ in range(4)]
    corr0, corr1 = limbs_of(1), limbs_of(1)
    nwin = 64 if mode == 0 else msm.num_windows(c)
    ref = (sk.rlc_windows_plain(groups, corr0, corr1, n) if mode == 0
           else sk.rlc_digits_plain(groups, corr0, corr1, n, m, c))
    args = [*(g.data_ptr() for g in groups), corr0.data_ptr(), corr1.data_ptr(), n, pad,
            mode, c, nwin, m, (groups, corr0, corr1)]
    return args, ref


CHALLENGE_KERNELS = ("keccak_chain", "reduce_wide")
#: masks of one transcript on the device challenges' path (a 32-byte
#: context and six points absorb into three permutations)
CHALLENGE_MASKS = 3


def wide_edges() -> list[int]:
    """The wide values every ``reduce_wide`` check leads with: 0, 1, l - 1,
    l, 2 l, 2^252, 2^256 - 1 and 2^512 - 1."""
    from .core.scalars import L

    return [0, 1, L - 1, L, 2 * L, 2**252, 2**256 - 1, 2**512 - 1]


def wide_case(rng: np.random.Generator, n: int) -> np.ndarray:
    """``[n, 64]`` uint8 little-endian values below 2^512: the
    :func:`wide_edges` (as many as fit), then random ones.  The inputs of
    ``reduce_wide`` here, in ``chip_smoke.py`` and in the tests."""
    blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    for j, v in enumerate(wide_edges()[:n]):
        blobs[j] = np.frombuffer(v.to_bytes(64, "little"), dtype=np.uint8)
    return blobs


def challenge_ab(dev: torch.device, specs, ns, reps: int, rounds: int, sass: bool) -> dict:
    """The ``--challenge`` A/B (see the module docstring)."""
    from .ops import keccak_kernels as kk, sclimbs as sc

    rng = np.random.default_rng(20)

    def ints(shape):
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                .astype(np.int32)).to(dev)

    k = CHALLENGE_MASKS
    chains = {n: (ints((25, 1)), ints((25, 1)), ints((k, 25, n)), ints((k, 25, n))) for n in ns}
    wides = {n: torch.from_numpy(sc.bytes_wide_to_limbs(wide_case(rng, n))).to(dev) for n in ns}
    refs = {n: (kk.keccak_chain_plain(*chains[n]), sc.reduce_wide_plain(wides[n])) for n in ns}
    stream = torch.cuda.current_stream(dev).cuda_stream
    builds = {}
    for name, csrc in specs:
        path, report = pk.build(Path(csrc))
        lib = pk.load(path)
        launchers = {}
        for n in ns:
            state = [torch.empty((25, n), dtype=torch.int32, device=dev) for _ in range(2)]
            ptrs = [t.data_ptr() for t in chains[n]]

            def chain(lib=lib, ptrs=ptrs, state=state, n=n):
                rc = lib.cpzk_keccak_chain(ptrs[0], ptrs[1], 1, ptrs[2], ptrs[3], k, n,
                                           state[0].data_ptr(), state[1].data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"keccak_chain launch failed: CUDA error {rc}")

            reduced = torch.empty((20, n), dtype=torch.int32, device=dev)

            def reduce(lib=lib, n=n, reduced=reduced):
                rc = lib.cpzk_reduce_wide(wides[n].data_ptr(), 40, reduced.data_ptr(), n,
                                          stream)
                if rc:
                    raise RuntimeError(f"reduce_wide launch failed: CUDA error {rc}")

            chain()
            reduce()
            torch.cuda.synchronize()
            if not (torch.equal(state[0], refs[n][0][0]) and torch.equal(state[1], refs[n][0][1])):
                raise AssertionError(f"{name} keccak_chain n={n}: words differ from plain")
            if not torch.equal(reduced, refs[n][1]):
                raise AssertionError(f"{name} reduce_wide n={n}: limbs differ from plain")
            launchers[("keccak_chain", n)] = chain
            launchers[("reduce_wide", n)] = reduce
        if hasattr(lib, "cpzk_launch_floor"):
            def empty(lib=lib):
                rc = lib.cpzk_launch_floor(stream)
                if rc:
                    raise RuntimeError(f"cpzk_launch_floor failed: CUDA error {rc}")

            launchers[("launch_floor", 0)] = empty
        builds[name] = {"launchers": launchers, "csrc": csrc,
                        "ptxas": {k: v for k, v in pk.ptxas_report(report).items()
                                  if k in CHALLENGE_KERNELS},
                        "sass": sass_counts(path, CHALLENGE_KERNELS) if sass else None,
                        "ms": {f"{k}/{n}": [] for k, n in launchers}}
    order = list(builds)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            b = builds[name]
            for (kname, n), launch in b["launchers"].items():
                b["ms"][f"{kname}/{n}"].append(event_ms(launch, reps, hold=True))
    return {"challenge_ab": {name: {key: b[key] for key in ("csrc", "ptxas", "sass")}
                             | {"reps": reps, "rounds": rounds, "masks": k,
                                "timed_by": "event_ms, launches held behind a spin kernel",
                                "ms_per_launch": {key: {"median": statistics.median(v),
                                                        "runs": v}
                                                  for key, v in b["ms"].items()}}
                             for name, b in builds.items()},
            "checked": "each build's keccak_chain words (a shared state, 3 random masks) "
                       "and reduce_wide limbs (the wide edge values, then random) equal to "
                       "the plain versions' at every n"}


def decode_case(rng: np.random.Generator, n: int) -> np.ndarray:
    """``[n, 32]`` uint8 wires of a ``--decode`` case: the generators' and
    the identity's encodings, p + 2, 3 and 32 bytes of 0xff (rejected),
    then random bytes (about one in eight a point).  DECODE runs the same
    steps for every wire, so the timing does not depend on the mix."""
    from . import Parameters
    from .core import edwards

    params = Parameters.new()
    rows = [params.generator_g.wire(), params.generator_h.wire(), bytes(32),
            (edwards.P + 2).to_bytes(32, "little"), (3).to_bytes(32, "little"), b"\xff" * 32]
    rows = (rows + [rng.bytes(32) for _ in range(max(n - len(rows), 0))])[:n]
    return np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(n, 32).copy()


def decode_ab(dev: torch.device, specs, ns, reps: int, rounds: int, sass: bool) -> dict:
    """The ``--decode`` A/B (see the module docstring)."""
    from .ops import decode_kernels as dk

    rng = np.random.default_rng(21)
    wires = {n: torch.from_numpy(decode_case(rng, n)).to(dev) for n in ns}
    refs = {n: dk.ristretto_decode_plain(w) for n, w in wires.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    builds = {}
    for name, csrc in specs:
        path, report = pk.build(Path(csrc))
        lib = pk.load(path)
        launchers = {}
        for n in ns:
            words = torch.empty((4, 8, n), dtype=torch.int32, device=dev)
            valid = torch.empty((n,), dtype=torch.uint8, device=dev)
            ptrs = (wires[n].data_ptr(), n, words.data_ptr(), valid.data_ptr())

            def decode(lib=lib, ptrs=ptrs):
                rc = lib.cpzk_ristretto_decode(*ptrs, stream)
                if rc:
                    raise RuntimeError(f"ristretto_decode launch failed: CUDA error {rc}")

            words.fill_(-1)
            valid.fill_(7)
            decode()
            torch.cuda.synchronize()
            if not (torch.equal(words, refs[n][0]) and torch.equal(valid, refs[n][1])):
                raise AssertionError(f"{name} ristretto_decode n={n}: differs from plain")
            launchers[("ristretto_decode", n)] = decode
        if hasattr(lib, "cpzk_launch_floor"):
            def empty(lib=lib):
                rc = lib.cpzk_launch_floor(stream)
                if rc:
                    raise RuntimeError(f"cpzk_launch_floor failed: CUDA error {rc}")

            launchers[("launch_floor", 0)] = empty
        builds[name] = {"launchers": launchers, "csrc": csrc,
                        "ptxas": pk.ptxas_report(report).get("ristretto_decode"),
                        "sass": sass_counts(path, ("ristretto_decode",)) if sass else None,
                        "ms": {f"{k}/{n}": [] for k, n in launchers}}
    order = list(builds)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            b = builds[name]
            for (key, n), launch in b["launchers"].items():
                b["ms"][f"{key}/{n}"].append(event_ms(launch, reps, hold=True))
    return {"decode_ab": {name: {key: b[key] for key in ("csrc", "ptxas", "sass")}
                          | {"reps": reps, "rounds": rounds,
                             "timed_by": "event_ms, launches held behind a spin kernel",
                             "ms_per_launch": {key: {"median": statistics.median(v),
                                                     "runs": v}
                                               for key, v in b["ms"].items()}}
                          for name, b in builds.items()},
            "checked": "each build's words and validity equal to ristretto_decode_plain's "
                       "at every n"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ns", default="1,6144,16384")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--no-pippenger", action="store_true")
    ap.add_argument("--ladder", action="store_true")
    ap.add_argument("--prove", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--challenge", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--ks", default="1,2,8,92")
    ap.add_argument("builds", nargs="*", metavar="NAME=CSRC_DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    ns = [int(x) for x in args.ns.split(",")]
    specs = [b.split("=", 1) for b in args.builds] or [["this", str(pk.CSRC)]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    if args.small:
        ks = [int(x) for x in args.ks.split(",")]
        print(json.dumps(small_ab(dev, specs, ns, ks, args.reps, args.rounds, args.sass)),
              flush=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        return 0
    if args.challenge or args.decode:
        ab = challenge_ab if args.challenge else decode_ab
        print(json.dumps(ab(dev, specs, ns, args.reps, args.rounds, args.sass)), flush=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        return 0
    if args.ladder or args.prove:
        ab = ladder_ab if args.ladder else prove_ab
        print(json.dumps(ab(dev, specs, ns, args.reps, args.rounds, args.sass)), flush=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        return 0

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
    if not args.no_pippenger:
        print(json.dumps(pippenger_kernels(dev, args.reps, args.rounds)), flush=True)
    print(json.dumps(prover_kernels(dev, args.reps, args.rounds)), flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
