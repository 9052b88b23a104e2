"""Make a population of users from the seed on the card and write it to a
file, in a process of its own that ends before the program under test
starts, so that one process at a time uses the card.

    python3 -m benchmark.drivers.population --seed <n> --users <n> --out <file.npz>

The file holds each user's witness and commitment nonce (32 bytes, little
endian) and the wires of the statement and the commitment.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def to_rows(values) -> np.ndarray:
    raw = b"".join(v.to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype=np.uint8).reshape(len(values), 32)


def from_rows(rows: np.ndarray) -> list[int]:
    raw = rows.tobytes()
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") for i in range(rows.shape[0])]


def main(argv=None) -> int:
    from benchmark.reference import proofs

    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--users", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    pop = proofs.population(args.seed, args.users, args.device)
    np.savez(args.out, x=to_rows(pop.x), k=to_rows(pop.k), **pop.wires)
    return 0


def load(path):
    """(x, k, wires) of a population file."""
    with np.load(path) as f:
        wires = {name: f[name] for name in ("y1", "y2", "r1", "r2")}
        return from_rows(f["x"]), from_rows(f["k"]), wires


if __name__ == "__main__":
    sys.exit(main())
