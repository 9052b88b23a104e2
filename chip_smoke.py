#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cpzk_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``cpzk_tpu_torch/csrc`` (into the ignored
``cpzk_tpu_torch/_build``), and prints one JSON line per phase:

1. ``device``  — the card (torch, and ``nvidia-smi`` name / power limit /
   max SM clock);
2. ``build``   — seconds to build the kernels, and per kernel the
   compiler's registers and spills (``-Xptxas -v``) and the block size it
   is launched with at each lane count of phase 3;
3. ``kernels_vs_plain`` — each kernel against its plain PyTorch version on
   the card at n in {1, 127, 4096, 6144, 16384, 18432} lanes (random valid
   points plus the +-9500 adversarial limb patterns): the kernels compute
   in their own radix, so values must be equal after canonicalization
   (tolerance: exact) and output limbs within |9500|; device time per call
   of kernel and plain version (torch.profiler), beside the kernel's bound;
4. ``serving_batch`` — ``BatchVerifier(backend=TorchBackend(),
   max_size=4096)`` over 4096 entries tiling a corpus of proofs made by the
   port's host prover: all-valid must accept every entry; about 1% tampered
   rows (wrong s, wrong context, swapped r1) must be rejected at exactly
   those indices with the exact error; a 64-entry sub-batch must agree with
   the port's ``CpuBackend``; the kernel launches of one all-valid
   4096-entry verify are reported on their own;
5. ``north_star`` — ``TorchBackend.verify_combined`` on 16,384 rows (16,385
   lanes with the correction row, two lane chunks) with fresh alphas: True,
   and False with one tampered row; the launches of the valid check are
   reported on their own;
6. ``profile`` — one 4096-row combined check: wall time unprofiled, then
   device time by kernel under torch.profiler (the table goes to
   ``chiprun_out/profile_4096.txt``) and the device's idle share.

Then the ``kernels`` line (launches counted over phases 4-5 only), the
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no last line; it also exits non-zero when CUDA is
unavailable or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 20261017
CORPUS = 256
SERVING_N = 4096
SUB_BATCH_N = 64
NORTH_STAR_N = 16384
KERNEL_NS = (1, 127, 4096, 6144, 16384, 18432)
#: lane width at which the kernels line reports times: one full lane chunk,
#: the shape most main-path launches of the 16,384-row check take
MAIN_N = 16384
#: the lane width of one 4096-row combined check (4097 lanes, padded)
CHUNK_4096_N = 6144
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_SM_CLOCK = 64
REPLACES = {"point_add": "cpzk_tpu/ops/pallas_kernels.py:51",
            "point_double_k": "cpzk_tpu/ops/pallas_kernels.py:87"}
SOURCES = ["cpzk_tpu_torch/csrc/point_ops.cu", "cpzk_tpu_torch/csrc/fe25519_w32.cuh"]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class SeededRng:
    """``fill_bytes`` from a seeded generator: reproducible witnesses and
    nonces for the corpus (verification itself draws from SecureRng)."""

    def __init__(self, seed: int):
        import numpy as np

        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._g.bytes(n)


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def synchronize() -> None:
    import torch

    torch.cuda.synchronize()


def launches_of(fn):
    """(fn(), kernel launches per wrapper during it)."""
    from cpzk_tpu_torch.ops import point_kernels as pk

    before = dict(pk.LAUNCHES)
    out = fn()
    return out, {k: pk.LAUNCHES[k] - before[k] for k in before}


def profiled(work):
    """(name, device us, count) of every device event of one ``work()``
    call under torch.profiler, after one warm-up call that is traced and
    discarded (tracing can drop events while it starts up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    traces = []
    synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traces.append(p.key_averages())) as prof:
        for _ in range(2):
            work()
            synchronize()
            prof.step()
    events = traces[-1]
    field = ("self_device_time_total"
             if events and hasattr(events[0], "self_device_time_total")
             else "self_cuda_time_total")
    # the step's own range appears as a device event spanning the whole
    # step; it is not a kernel
    return [(evt.key, getattr(evt, field), evt.count) for evt in events
            if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA
            and not evt.key.startswith("ProfilerStep")]


def device_ms(name: str, kernel, plain, reps: int, plain_reps: int) -> dict:
    """Device time per call of a kernel and of its plain version: the
    kernel's own events (by name) over ``reps`` calls, and every device
    event of ``plain_reps`` calls of the plain version."""

    def work():
        for _ in range(reps):
            kernel()
        for _ in range(plain_reps):
            plain()

    # the profiler can miss a step's launches altogether; such a step is
    # traced again, up to three times in all
    for _ in range(3):
        ours_us = other_us = 0.0
        ours_count = other_count = 0
        for key, us, count in profiled(work):
            if f"::{name}_kernel(" in key:
                ours_us += us
                ours_count += count
            else:
                other_us += us
                other_count += count
        if ours_count >= 1 and other_us > 0:
            break
    else:
        raise AssertionError(f"{name}: the profiler saw no device time")
    return {"ms": ours_us / 1e3 / ours_count, "plain_ms": other_us / 1e3 / plain_reps,
            "profiled_launches": ours_count, "expected_launches": reps,
            "plain_kernel_launches_per_call": other_count / plain_reps}


def kernels_vs_plain(dev, ns, int32_ops_per_s: float, gen) -> dict:
    """Phase 3: every kernel against its plain version at each lane count."""
    import numpy as np
    import torch

    from cpzk_tpu_torch.core import edwards
    from cpzk_tpu_torch.ops import curve, limbs, point_kernels as pk

    host_pts = [
        edwards.pt_scalar_mul(edwards.BASEPOINT,
                              int.from_bytes(gen.fill_bytes(32), "little"))
        for _ in range(256)
    ]
    base = curve.points_to_device(host_pts, dev)
    np_rng = np.random.default_rng(SEED)
    b = limbs.BOUND
    adversarial = np.stack([
        np.full(limbs.NLIMBS, b, dtype=np.int32),
        np.full(limbs.NLIMBS, -b, dtype=np.int32),
        np.asarray([b if i % 2 else -b for i in range(limbs.NLIMBS)], dtype=np.int32),
        np.asarray([-b] + [b] * (limbs.NLIMBS - 1), dtype=np.int32),
    ], axis=-1)
    adv = torch.from_numpy(adversarial).to(dev)  # [20, 4]

    def random_points(n: int):
        """n valid points (sums of two random basis points, loose limbs);
        from 4 lanes up, the first 4 lanes' coordinates are the adversarial
        patterns."""
        i1 = torch.from_numpy(np_rng.integers(0, 256, n)).to(dev)
        i2 = torch.from_numpy(np_rng.integers(0, 256, n)).to(dev)
        p = pk.point_add_plain(tuple(c[:, i1] for c in base),
                               tuple(c[:, i2] for c in base))
        if n >= 4:
            k = int(np_rng.integers(0, 4))
            p = tuple(torch.cat([torch.roll(adv, k + c, dims=1), p[c][:, 4:]], dim=1)
                      for c in range(4))
        return p

    def bound_ms(name: str, n: int) -> tuple[float, str]:
        if name == "point_add":
            nbytes, ops = 12 * 80 * n, pk.ADD_OPS_PER_LANE * n
        else:
            nbytes, ops = 7 * 80 * n, pk.double_k_ops_per_lane(4) * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / int32_ops_per_s * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    rows = {"point_add": [], "point_double_k": []}
    for n in ns:
        p = random_points(n)
        q = random_points(n)
        cases = {
            "point_add": (lambda p=p, q=q: pk.point_add(p, q),
                          lambda p=p, q=q: pk.point_add_plain(p, q)),
            "point_double_k": (lambda p=p: pk.point_double_k(p, 4),
                               lambda p=p: pk.point_double_k_plain(p, 4)),
        }
        for name, (kernel, plain) in cases.items():
            out = kernel()
            synchronize()
            ref = plain()
            err = max(int((limbs.canonical(a) - limbs.canonical(r)).abs().max())
                      for a, r in zip(out, ref))
            limb_max = max(int(a.abs().max()) for a in out)
            if err != 0 or limb_max > limbs.BOUND:
                raise AssertionError(
                    f"{name} n={n}: canonical error {err}, max limb {limb_max}")
            b_ms, b_by = bound_ms(name, n)
            rows[name].append({
                "n": n, "max_abs_err": err, "max_limb": limb_max,
                "limbs_identical": all(torch.equal(a, r) for a, r in zip(out, ref)),
                "bound_ms": b_ms, "bound_by": b_by,
            })
            rows[name][-1].update(device_ms(name, kernel, plain, 20, 3))
    return rows


def make_corpus(n: int, gen):
    """n distinct context-bound proofs from the port's host prover."""
    from cpzk_tpu_torch import Parameters, Prover, Ristretto255, Transcript, Witness

    params = Parameters.new()
    corpus = []
    for i in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(gen)))
        ctx = b"chip-smoke-%d" % i
        t = Transcript()
        t.append_context(ctx)
        corpus.append((prover.statement, prover.prove_with_transcript(gen, t), ctx))
    return params, corpus


def serving_batch(backend, params, corpus, n: int, sub_n: int) -> dict:
    """Phase 4: all-valid and ~1%-tampered n-entry batches through
    ``BatchVerifier``, and a sub-batch against the port's CpuBackend."""
    from cpzk_tpu_torch import BatchVerifier, CpuBackend, InvalidParams, SecureRng
    from cpzk_tpu_torch.core.ristretto import Scalar
    from cpzk_tpu_torch.protocol.gadgets import Commitment, Proof, Response

    bad = {}
    step = max(2, n // 42)
    for k, idx in enumerate(range(37 % n, n, step)):
        st, pr, ctx = corpus[idx % len(corpus)]
        how = ("wrong_s", "wrong_context", "swapped_r1")[k % 3]
        if how == "wrong_s":
            pr = Proof(pr.commitment, Response(Scalar(pr.response.s.value + 1)))
        elif how == "wrong_context":
            ctx = ctx + b"-replayed"
        else:
            other = corpus[(idx + 1) % len(corpus)][1]
            pr = Proof(Commitment(other.commitment.r1, pr.commitment.r2), pr.response)
        bad[idx] = (st, pr, ctx)

    def batch(size: int, tampered: bool, verifier_backend) -> BatchVerifier:
        bv = BatchVerifier(backend=verifier_backend, max_size=n)
        for i in range(size):
            st, pr, ctx = corpus[i % len(corpus)]
            if tampered and i in bad:
                st, pr, ctx = bad[i]
            bv.add_with_context(params, st, pr, ctx)
        return bv

    def run(bv: BatchVerifier):
        t0 = time.perf_counter()
        prepared = bv.prepare_batch(SecureRng())
        t1 = time.perf_counter()
        results = bv.run_prepared(prepared)
        synchronize()
        return results, t1 - t0, time.perf_counter() - t1

    (valid, host_s, backend_s), valid_launches = launches_of(
        lambda: run(batch(n, False, backend)))
    if valid != [None] * n:
        raise AssertionError(f"all-valid {n}-entry batch was not fully accepted")
    mixed, m_host_s, m_backend_s = run(batch(n, True, backend))
    flagged = [i for i, r in enumerate(mixed) if r is not None]
    if flagged != sorted(bad):
        raise AssertionError(f"flagged rows {flagged} != tampered rows {sorted(bad)}")
    for i in flagged:
        r = mixed[i]
        if type(r) is not InvalidParams or str(r) != "Proof verification failed":
            raise AssertionError(f"row {i}: unexpected result {r!r}")

    def as_text(results):
        return [None if r is None else (type(r).__name__, str(r)) for r in results]

    sub_dev, _, _ = run(batch(sub_n, True, backend))
    sub_cpu = batch(sub_n, True, CpuBackend()).verify(SecureRng())
    if as_text(sub_dev) != as_text(sub_cpu):
        raise AssertionError(f"{sub_n}-entry sub-batch disagrees with CpuBackend")
    return {
        "n": n, "tampered": len(bad),
        "valid_host_s": host_s, "valid_backend_s": backend_s,
        "valid_backend_rows_per_s": n / backend_s,
        "valid_verify_rows_per_s": n / (host_s + backend_s),
        "valid_launches": valid_launches,
        "mixed_host_s": m_host_s, "mixed_backend_s": m_backend_s,
        "mixed_backend_rows_per_s": n / m_backend_s,
        "mixed_verify_rows_per_s": n / (m_host_s + m_backend_s),
        "sub_batch": sub_n, "sub_batch_rejected": sum(r is not None for r in sub_dev),
    }


def north_star_rows(params, corpus, n: int, rng):
    """n backend rows tiling the corpus, each with a fresh alpha (as
    bench.py builds its rows), and beta."""
    from cpzk_tpu_torch import Ristretto255
    from cpzk_tpu_torch.core.transcript import derive_challenges_batch
    from cpzk_tpu_torch.protocol.batch import BatchRow

    eb = Ristretto255.element_to_bytes
    m = len(corpus)
    challenges = derive_challenges_batch(
        [ctx for _, _, ctx in corpus],
        [eb(params.generator_g)] * m, [eb(params.generator_h)] * m,
        [eb(st.y1) for st, _, _ in corpus], [eb(st.y2) for st, _, _ in corpus],
        [eb(pr.commitment.r1) for _, pr, _ in corpus],
        [eb(pr.commitment.r2) for _, pr, _ in corpus],
    )
    alphas = Ristretto255.random_scalars(rng, n)
    rows = []
    for i in range(n):
        st, pr, _ = corpus[i % m]
        rows.append(BatchRow(
            g=params.generator_g, h=params.generator_h, y1=st.y1, y2=st.y2,
            r1=pr.commitment.r1, r2=pr.commitment.r2, s=pr.response.s,
            c=challenges[i % m], alpha=alphas[i]))
    return rows, Ristretto255.random_scalar(rng)


def north_star(backend, rows, beta) -> dict:
    """Phase 5: the combined check on all rows, valid then one tampered."""
    from cpzk_tpu_torch.core.ristretto import Scalar
    from cpzk_tpu_torch.protocol.batch import BatchRow

    n = len(rows)
    t0 = time.perf_counter()
    ok, valid_launches = launches_of(lambda: backend.verify_combined(rows, beta))
    synchronize()
    valid_s = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f"{n}-row combined check rejected a valid batch")
    bad = list(rows)
    k = (7 * n) // 15
    r = bad[k]
    bad[k] = BatchRow(r.g, r.h, r.y1, r.y2, r.r1, r.r2,
                      Scalar(r.s.value + 1), r.c, r.alpha)
    t0 = time.perf_counter()
    ok_bad = backend.verify_combined(bad, beta)
    synchronize()
    tampered_s = time.perf_counter() - t0
    if ok_bad is not False:
        raise AssertionError(f"{n}-row combined check accepted a tampered row")
    return {"rows": n, "lanes": n + 1, "valid_s": valid_s, "tampered_s": tampered_s,
            "backend_rows_per_s": n / valid_s, "valid_launches": valid_launches}


def profile_combined(backend, rows, beta) -> dict:
    """Phase 6: wall time of one combined check, then its device time by
    kernel under the profiler."""
    backend.verify_combined(rows, beta)  # warm
    synchronize()
    t0 = time.perf_counter()
    backend.verify_combined(rows, beta)
    synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {key: (us / 1e3, count) for key, us, count in
                 profiled(lambda: backend.verify_combined(rows, beta))}
    busy_ms = sum(v[0] for v in by_kernel.values())
    ours = {name: v for k, v in by_kernel.items()
            for name in ("point_add", "point_double_k") if f"::{name}_kernel(" in k}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "profile_4096.txt"), "w") as f:
        for key, (ms, count) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0]):
            f.write(f"{ms:10.3f} ms {count:6d}  {key}\n")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "rows": len(rows), "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1 - busy_ms / wall_ms,
        "point_kernels_ms": {k: v[0] for k, v in ours.items()},
        "point_kernel_launches": {k: v[1] for k, v in ours.items()},
        "other_device_ms": busy_ms - sum(v[0] for v in ours.values()),
        "other_kernel_launches": sum(v[1] for v in by_kernel.values()) - sum(
            v[1] for v in ours.values()),
        "top": [[k[:100], v[0], v[1]] for k, v in top],
    }


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from cpzk_tpu_torch import SecureRng
        from cpzk_tpu_torch.ops import point_kernels as pk
        from cpzk_tpu_torch.ops.backend import TorchBackend
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    card = {"device": kind, "nvidia_smi": smi}
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "max_sm_mhz": max_sm_mhz, "sms": sms, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    t0 = time.perf_counter()
    lib_path, report = pk.build()
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    per_kernel = pk.ptxas_report(report)
    for name in REPLACES:
        per_kernel.setdefault(name, {})["block_threads"] = {
            n: pk.block_threads(n, dev) for n in KERNEL_NS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib_path.name, "kernels": per_kernel, "ptxas": ptxas})

    # 3. kernels against their plain versions
    gen = SeededRng(SEED)
    int32_ops_per_s = sms * INT32_OPS_PER_SM_CLOCK * max_sm_mhz * 1e6
    kernel_rows = kernels_vs_plain(dev, KERNEL_NS, int32_ops_per_s, gen)
    emit({"phase": "kernels_vs_plain", "tolerance": "exact after canonicalization", **card,
          "results": kernel_rows})

    t0 = time.perf_counter()
    params, corpus = make_corpus(CORPUS, gen)
    emit({"phase": "corpus", "proofs": CORPUS, "seconds": time.perf_counter() - t0})
    rows, beta = north_star_rows(params, corpus, NORTH_STAR_N, SecureRng())

    # 4-5. the main path, with the launch counts set to 0 just before it
    backend = TorchBackend()
    pk.reset_launches()
    serving = serving_batch(backend, params, corpus, SERVING_N, SUB_BATCH_N)
    emit({"phase": "serving_batch", **serving, **card})
    star = north_star(backend, rows, beta)
    launches = dict(pk.LAUNCHES)
    emit({"phase": "north_star", **star, "launches": launches, **card})
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was never launched on the main path")

    # 6. where the time goes
    prof = profile_combined(backend, rows[:SERVING_N], beta)
    emit({"phase": "profile", **prof, **card})

    kernels = []
    for name, results in kernel_rows.items():
        main_row = next(r for r in results if r["n"] == MAIN_N)
        chunk_row = next(r for r in results if r["n"] == CHUNK_4096_N)
        kernels.append({
            "name": name, "route": "cuda",
            "source": SOURCES[0], "sources": SOURCES,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": None, "n": MAIN_N,
            f"ms_{CHUNK_4096_N}": chunk_row["ms"], f"bound_ms_{CHUNK_4096_N}": chunk_row["bound_ms"],
            "registers": per_kernel[name].get("registers"),
            "spill_bytes": per_kernel[name].get("spill_store_bytes"),
            "launches_per_4096_verify": serving["valid_launches"][name],
            "launches_per_16384_check": star["valid_launches"][name],
        })
    emit({"phase": "done", "total_s": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
