"""Bulk audit CLI: generate / replay / verify proof logs offline.

The port of ``cpzk_tpu/audit/__main__.py``.  Subcommands::

    python -m cpzk_tpu_torch.audit generate --n 100000 --out proofs.log
    python -m cpzk_tpu_torch.audit run --log proofs.log --report report.json
    python -m cpzk_tpu_torch.audit verify-report --report report.json

``run`` replays on the card (``--backend tpu``, the default: TorchBackend
on ``cuda:0``; without CUDA it exits 2) or on the host (``--backend
cpu``).  It checkpoints a resumable cursor next to the report after every
batch quantum: SIGKILL it at any point, rerun the same command, and the
final signed report is byte-identical to an uninterrupted run.
``verify-report`` needs ONLY the report file — the Schnorr signature and
totals-consistency checks run fully offline.

Exit codes: 0 done (or checkpointed), 3 when the replay found mismatched
verdicts, 1 when ``verify-report`` refuses the report, 2 on usage, OS or
value errors (CUDA missing included).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import errors


def cmd_generate(args) -> int:
    """A synthetic proof log: ``--n`` records over ``--users`` synthetic
    statements, ``--reject-frac`` of them with corrupted proofs (logged
    verdict 0, audit agrees) and ``--mismatch-frac`` with a LYING logged
    verdict (what a tampered or buggy serving plane would leave behind —
    the audit's whole reason to exist)."""
    from .. import Parameters, Prover, SecureRng, Transcript, Witness
    from ..core.ristretto import Ristretto255
    from .log import ProofLogWriter, proof_record

    rng = SecureRng()
    params = Parameters.new()
    eb = Ristretto255.element_to_bytes
    provers = [
        Prover(params, Witness(Ristretto255.random_scalar(rng)))
        for _ in range(max(1, args.users))
    ]
    writer = ProofLogWriter(args.out, fsync="off")
    t0 = time.monotonic()
    pending: list[dict] = []
    n_reject = n_mismatch = 0
    for i in range(args.n):
        prover = provers[i % len(provers)]
        ctx = rng.fill_bytes(32)
        t = Transcript()
        t.append_context(ctx)
        wire = prover.prove_with_transcript(rng, t).to_bytes()
        verdict = True
        if args.reject_frac > 0 and (i % max(1, int(1 / args.reject_frac))) == 1:
            # corrupt the response scalar: parses fine, verifies False
            wire = wire[:-1] + bytes([wire[-1] ^ 1])
            verdict = False
            n_reject += 1
        if args.mismatch_frac > 0 and (
            i % max(1, int(1 / args.mismatch_frac))
        ) == 2:
            verdict = not verdict  # the log lies; the audit must notice
            n_mismatch += 1
        pending.append(proof_record(
            f"u{i % len(provers)}",
            eb(prover.statement.y1), eb(prover.statement.y2),
            ctx, wire, verdict,
        ))
        if len(pending) >= 1024:
            writer.append_proofs(pending)
            pending.clear()
    writer.append_proofs(pending)
    writer.close()
    dt = time.monotonic() - t0
    print(json.dumps({
        "generated": args.n, "path": args.out, "bytes": writer.size,
        "rejects": n_reject, "mismatches": n_mismatch,
        "seconds": round(dt, 2),
        "records_per_s": round(args.n / dt, 1) if dt > 0 else None,
    }))
    return 0


def cmd_run(args) -> int:
    from .pipeline import run_audit

    t0 = time.monotonic()

    # optional ops plane: a long bulk replay is a fleet workload too —
    # expose /metrics (the proof-log families and the kernel launches),
    # /healthz, and the ring dumps on a daemon-thread HTTP server while
    # the synchronous pipeline runs
    ops_plane = None
    if args.opsplane_port is not None:
        from ..observability.opsplane import OpsPlane, OpsSources

        ops_plane = OpsPlane(
            OpsSources(role="audit"),
            host=args.opsplane_host, port=args.opsplane_port,
        )
        bound = ops_plane.start_in_thread()
        print(
            f"# ops plane on http://{args.opsplane_host}:{bound} "
            "(/metrics /healthz /statusz)",
            file=sys.stderr, flush=True,
        )

    def progress(state) -> None:
        if not args.quiet:
            dt = time.monotonic() - t0
            rate = state.records / dt if dt > 0 else 0.0
            print(
                f"# audited {state.audited} (+{state.skipped} skipped, "
                f"{state.mismatched} mismatched) @ {rate:,.0f} rec/s",
                file=sys.stderr, flush=True,
            )

    try:
        report = run_audit(
            args.log, args.report,
            cursor_path=args.cursor,
            key_path=args.key,
            quantum=args.quantum,
            backend=args.backend,
            mesh_devices=args.mesh_devices,
            lanes=args.lanes,
            resume=not args.fresh,
            max_batches=args.max_batches,
            progress=progress,
        )
    finally:
        if ops_plane is not None:
            ops_plane.stop_thread()
    if report is None:
        print(json.dumps({"status": "checkpointed", "report": None}))
        return 0
    out = {"status": "complete", "report_path": args.report,
           "totals": report["totals"], "digest": report["digest"]}
    print(json.dumps(out))
    # a mismatch means the log's recorded verdicts and the re-verification
    # disagree — the audit FOUND something; exit nonzero so operators and
    # CI cannot miss it
    return 3 if report["totals"]["mismatched"] else 0


def cmd_verify_report(args) -> int:
    from .pipeline import verify_report_file

    ok, reason, report = verify_report_file(args.report)
    print(json.dumps({
        "ok": ok, "reason": reason,
        "totals": (report or {}).get("totals"),
        "digest": (report or {}).get("digest"),
    }))
    return 0 if ok else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cpzk_tpu_torch.audit",
        description="bulk offline proof-log audit pipeline",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="write a synthetic proof log")
    g.add_argument("--n", type=int, required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--users", type=int, default=16)
    g.add_argument("--reject-frac", type=float, default=0.0)
    g.add_argument("--mismatch-frac", type=float, default=0.0)
    g.set_defaults(fn=cmd_generate)

    r = sub.add_parser("run", help="replay a proof log, write a signed report")
    r.add_argument("--log", required=True,
                   help="the proof log file, or a rotated-segment "
                        "directory (sealed *.seg files + active tail "
                        "replay as one log)")
    r.add_argument("--report", required=True)
    r.add_argument("--cursor", default=None,
                   help="checkpoint path (default <report>.cursor)")
    r.add_argument("--key", default=None,
                   help="signing-key path (default <report>.key; minted "
                        "0600 when absent)")
    r.add_argument("--quantum", type=int, default=4096,
                   help="records per device batch (the serving batch "
                        "quantum)")
    r.add_argument("--backend", choices=("cpu", "tpu"), default="tpu",
                   help="tpu = the card (TorchBackend on cuda:0, the "
                        "default; exits 2 without CUDA), cpu = the host")
    r.add_argument("--mesh-devices", type=int, default=0,
                   help="0 = every local card, k = the first k (tpu "
                        "backend; one card means no mesh)")
    r.add_argument("--lanes", type=int, default=1,
                   help="-1 = one lane per local card (tpu) or host core "
                        "(cpu), k = exactly k lanes, 1 = direct "
                        "single-engine replay; quanta fan out across the "
                        "lanes and the signed report is the same bytes")
    r.add_argument("--fresh", action="store_true",
                   help="ignore an existing cursor and restart from byte 0")
    r.add_argument("--max-batches", type=int, default=None,
                   help="stop (checkpointed) after this many quanta — "
                        "test hook modelling a crash between checkpoints")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--opsplane-port", type=int, default=None,
                   help="serve the HTTP ops plane (/metrics /healthz "
                        "/statusz) on this port while the replay runs "
                        "(0 = OS-assigned)")
    r.add_argument("--opsplane-host", default="127.0.0.1")
    r.set_defaults(fn=cmd_run)

    v = sub.add_parser("verify-report", help="offline signed-report check")
    v.add_argument("--report", required=True)
    v.set_defaults(fn=cmd_verify_report)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "run" and args.quantum < 1:
        print("audit quantum must be positive", file=sys.stderr)
        return 2
    try:
        return args.fn(args)
    except (OSError, ValueError, errors.InvalidParams) as e:
        print(f"audit: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
