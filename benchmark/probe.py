"""Runs of a cell that are not the benchmark's own: the control that
``correct`` must reject, and an open loop offered at another rate (the
sweep that finds the knee).  Each prints a result line as ``benchmark.run``
does; such a line belongs to no cell and is never a measurement of one.

    python3 -m benchmark.probe --workload <name> --seed <n> --seconds <s> --control
    python3 -m benchmark.probe --workload <name> --seed <n> --seconds <s> --rate <r>
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from benchmark import harness, run

    age0 = harness.process_age_s
    p = argparse.ArgumentParser(prog="benchmark.probe")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    what = p.add_mutually_exclusive_group(required=True)
    what.add_argument("--control", action="store_true",
                      help="the reference, its challenges bound to no context, in the program's place")
    what.add_argument("--rate", type=float, help="an open loop's offered rate in place of its mix's")
    args = p.parse_args(argv)
    over = {"rate": args.rate} if args.rate is not None else None
    return run.execute(args.workload, args.seed, args.seconds, False, age0,
                       control=args.control, traffic_over=over)


if __name__ == "__main__":
    sys.exit(main())
