"""cpzk-lint CLI.

Usage::

    python -m cpzk_tpu_torch.analysis [paths ...] [--format text|json|sarif]
                                [--json] [--rules IDS]
                                [--list-rules] [--audit-waivers]

Exit codes: 0 — clean; 1 — findings; 2 — usage or I/O error.  The JSON
report schema is pinned by tests/test_torch_static_analysis.py (CI uploads it
as an artifact); ``--format sarif`` emits the same findings as a SARIF
2.1.0 document so CI can annotate PRs (exit codes and the default human
output are unchanged — ``--json`` stays an alias for ``--format json``).
``--audit-waivers`` lists every live waiver with its reason and liveness
(a stale one — whose rule would no longer fire — is also a WAIVER-002
finding on a normal run).
"""

from __future__ import annotations

import argparse
import json
import sys

from .engine import all_rule_ids, analyze_paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cpzk-lint",
        description="AST-based invariant analyzer (constant-time, "
        "secret-hygiene, lock, async, abort-path discipline)",
    )
    p.add_argument(
        "paths", nargs="*", default=["cpzk_tpu_torch"],
        help="files or directories to analyze (default: cpzk_tpu_torch)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="machine-readable report (alias for --format json)",
    )
    p.add_argument(
        "--format", dest="fmt", choices=("text", "json", "sarif"),
        default=None,
        help="output format: text (default), json (the schema-v2 report), "
        "or sarif (SARIF 2.1.0 for CI annotation)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule ids to run (default: all)",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule inventory and exit",
    )
    p.add_argument(
        "--audit-waivers", action="store_true",
        help="list every live waiver (path:line, rules, reason, liveness) "
        "instead of findings",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        from .engine import REGISTRY, _load_rules

        _load_rules()
        for rule_id in all_rule_ids():
            print(f"{rule_id}: {REGISTRY[rule_id].summary}")
        return 0
    rules = None
    if args.rules is not None:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in all_rule_ids()]
        if unknown:
            print(f"unknown rule ids: {', '.join(unknown)}", file=sys.stderr)
            return 2
    try:
        report = analyze_paths(args.paths, rules=rules)
    except OSError as e:
        print(f"cpzk-lint: {e}", file=sys.stderr)
        return 2
    if args.audit_waivers:
        for w in report.waivers:
            print(w.render())
        stale = sum(1 for w in report.waivers if w.stale)
        print(
            f"cpzk-lint: {len(report.waivers)} waivers "
            f"({stale} stale)"
        )
        return 1 if stale else 0
    fmt = args.fmt or ("json" if args.json else "text")
    if fmt == "json":
        json.dump(report.to_dict(), sys.stdout, indent=2, sort_keys=True)
        print()
    elif fmt == "sarif":
        json.dump(report.to_sarif(), sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for f in report.findings:
            print(f.render())
        print(
            f"cpzk-lint: {report.files} files, "
            f"{len(report.findings)} findings, "
            f"{len(report.waived)} waived"
        )
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
