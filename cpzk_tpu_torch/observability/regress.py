"""Perf-regression gate CLI: compare two PerfSnapshot files (port of
``cpzk_tpu/observability/regress.py`` over :mod:`.perf`).

Usage::

    python -m cpzk_tpu_torch.observability.regress OLD NEW [--threshold 0.35]
                                                   [--json]

Exit codes: 0 = no regression, 1 = at least one entry regressed past its
noise-adjusted gate, 2 = usage / unreadable snapshot.
"""

from __future__ import annotations

import argparse
import json
import sys

from .perf import compare_files, format_report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cpzk_tpu_torch.observability.regress",
        description="compare two cpzk-perf-snapshot files",
    )
    ap.add_argument("old", help="baseline snapshot (e.g. BENCH_BASELINE_CPU.json)")
    ap.add_argument("new", help="candidate snapshot")
    ap.add_argument(
        "--threshold", type=float, default=0.35,
        help="base relative-regression gate before the per-entry noise "
             "allowance (default 0.35 = 35%%)",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit the machine-readable report instead of text",
    )
    args = ap.parse_args(argv)
    if not 0 < args.threshold < 10:
        print(f"--threshold out of range: {args.threshold}", file=sys.stderr)
        return 2

    try:
        report = compare_files(args.old, args.new, threshold=args.threshold)
    except (OSError, ValueError, KeyError, json.JSONDecodeError) as exc:
        print(f"cannot compare snapshots: {exc}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(
            {
                "passed": report["passed"],
                "compared": report["compared"],
                "threshold": args.threshold,
                "regressions": [
                    {
                        "name": d.key[0], "backend": d.key[1],
                        "n": d.key[2], "unit": d.key[3],
                        "lanes": d.key[4], "wire": d.key[5],
                        "old": d.old, "new": d.new,
                        "change": d.change, "limit": d.limit,
                    }
                    for d in report["regressions"]
                ],
                "only_old": [list(k) for k in report["only_old"]],
                "only_new": [list(k) for k in report["only_new"]],
            },
            indent=2, sort_keys=True,
        ))
    else:
        print(format_report(report, args.threshold))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
