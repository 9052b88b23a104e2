"""Shared fuzz driver of the port's fuzz targets (a copy of the reference
package's ``fuzz/common.py``; the targets beside it are port-owned copies
of ``fuzz/fuzz_*.py`` that drive ``cpzk_tpu_torch``).

Uses Atheris (libFuzzer for Python) when importable; otherwise falls back to
a built-in seeded mutation engine: byte flips, truncations, insertions,
splices, and length-field tampering over a seed corpus, plus pure random
blobs.  Deterministic under --seed, time- or run-bounded, exits nonzero on
the first invariant violation with the reproducing input hex-dumped.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

# the repository root, three levels up (tests/torch_fuzz/common.py)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _mutate(rng: random.Random, data: bytes) -> bytes:
    buf = bytearray(data)
    for _ in range(rng.randint(1, 4)):
        op = rng.randrange(6)
        if op == 0 and buf:  # bit flip
            i = rng.randrange(len(buf))
            buf[i] ^= 1 << rng.randrange(8)
        elif op == 1 and buf:  # byte set
            buf[rng.randrange(len(buf))] = rng.randrange(256)
        elif op == 2 and buf:  # truncate
            del buf[rng.randrange(len(buf)):]
        elif op == 3:  # insert
            i = rng.randrange(len(buf) + 1)
            buf[i:i] = bytes(rng.randrange(256) for _ in range(rng.randint(1, 8)))
        elif op == 4 and len(buf) >= 8:  # length-field tamper (u32 BE)
            i = rng.randrange(len(buf) - 4)
            buf[i : i + 4] = rng.randrange(2**32).to_bytes(4, "big")
        elif op == 5 and buf:  # splice with random block
            i = rng.randrange(len(buf))
            j = min(len(buf), i + rng.randint(1, 16))
            buf[i:j] = os.urandom(j - i)
    return bytes(buf)


def run_bounded(one_input, seeds: list[bytes], runs: int = 0,
                seconds: float = 15.0, seed: int = 0) -> int:
    """Built-in engine, bounded by ``runs`` (when nonzero) or ``seconds``.
    Deterministic under a fixed ``seed`` apart from the raw-random-blob
    draws.  Returns the number of executions; raises on the first
    invariant violation with the reproducing input hex-dumped.  This is
    the entry point the CI fuzz-smoke tests drive directly (Atheris, when
    installed, would ignore bounds and fuzz forever)."""
    rng = random.Random(seed)
    corpus = list(seeds) + [b"", b"\x01", os.urandom(109)]
    deadline = time.monotonic() + seconds
    done = 0
    while (runs and done < runs) or (not runs and time.monotonic() < deadline):
        if rng.random() < 0.15:
            data = os.urandom(rng.randint(0, 160))
        else:
            data = _mutate(rng, rng.choice(corpus))
        try:
            one_input(data)
        except Exception:
            print(f"INVARIANT VIOLATION after {done} runs", file=sys.stderr)
            print("input:", data.hex(), file=sys.stderr)
            raise
        done += 1
    return done


def run_fuzzer(one_input, seeds: list[bytes], argv=None) -> None:
    """Drive ``one_input(data: bytes)``; Atheris when present, else the
    built-in engine.  ``one_input`` must raise only on invariant violations
    (expected parse failures are part of the harness)."""
    try:
        import atheris  # type: ignore

        atheris.Setup([sys.argv[0]], one_input)
        atheris.Fuzz()
        return
    except ImportError:
        pass

    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=0, help="0 = until --seconds")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    runs = run_bounded(one_input, seeds, runs=args.runs,
                       seconds=args.seconds, seed=args.seed)
    print(f"ok: {runs} runs, no invariant violations")
