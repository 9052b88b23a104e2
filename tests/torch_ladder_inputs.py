"""Seeded inputs of the per-row ladders for the port's tests: Chaum-Pedersen
proof rows made with the port's host arithmetic from a numpy seed, laid out
as numpy ``[20, lanes]`` int32 limb arrays and ``[64, lanes]`` windows, the
layout both packages take (``convert.point``/``convert.tensor`` carry them
to the port; the JAX functions take them as they are).  Lanes past the rows
hold the identity with zero windows.  Imports no JAX, so the card's tests
use it too."""

import numpy as np

from cpzk_tpu_torch.bench_kernels import random_totals
from cpzk_tpu_torch.core import edwards as he
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.ops import curve, limbs

def make_rows(seed: int, n: int, tampered: dict | None = None,
              per_lane_generators: bool = False) -> dict:
    """n proof rows {g, h, y1, y2, r1, r2: host points; s, c: scalars};
    ``tampered`` maps a row to how it is tampered: ``"s"``, its response off
    by one (both equations fail), or ``"r1"``/``"r2"``, that commitment
    moved by G (only its equation fails).  The generators are G and H in
    every row, or a random pair per row."""
    rng = np.random.default_rng(seed)

    def scalar() -> int:
        return int.from_bytes(rng.bytes(64), "little") % L

    G, H = he.BASEPOINT, Ristretto255.generator_h().point
    out = {k: [] for k in ("g", "h", "y1", "y2", "r1", "r2", "s", "c")}
    for i in range(n):
        g, h = ((he.pt_scalar_mul(G, scalar()), he.pt_scalar_mul(G, scalar()))
                if per_lane_generators else (G, H))
        x, k, c = scalar(), scalar(), scalar()
        row = {"g": g, "h": h, "y1": he.pt_scalar_mul(g, x), "y2": he.pt_scalar_mul(h, x),
               "r1": he.pt_scalar_mul(g, k), "r2": he.pt_scalar_mul(h, k),
               "c": c, "s": (k + c * x) % L}
        kind = (tampered or {}).get(i)
        if kind == "s":
            row["s"] = (row["s"] + 1) % L
        elif kind in ("r1", "r2"):
            row[kind] = he.pt_add(row[kind], G)
        for key, value in row.items():
            out[key].append(value)
    return out


def soa(points: list, lanes: int) -> tuple[np.ndarray, ...]:
    """Host points -> identity-padded ``[20, lanes]`` int32 limbs x 4."""
    pts = points + [he.IDENTITY] * (lanes - len(points))
    return tuple(limbs.ints_to_limbs([p[k] for p in pts]) for k in range(4))


def windows(values: list[int], lanes: int) -> np.ndarray:
    """Scalars -> zero-padded ``[64, lanes]`` int32 windows, MSB first."""
    return curve.scalars_to_windows(values + [0] * (lanes - len(values)))


def each_inputs(rows: dict, lanes: int, shared_generators: bool) -> tuple:
    """(g, h, y1, y2, r1, r2, ws, wc) of ``verify_each_kernel``: g and h
    ``[20, 1]`` when shared, else per lane (the identity past the rows)."""
    if shared_generators:
        g, h = soa(rows["g"][:1], 1), soa(rows["h"][:1], 1)
    else:
        g, h = soa(rows["g"], lanes), soa(rows["h"], lanes)
    pts = tuple(soa(rows[k], lanes) for k in ("y1", "y2", "r1", "r2"))
    return (g, h) + pts + (windows(rows["s"], lanes), windows(rows["c"], lanes))


def combined_inputs(rows: dict, alphas: list[int], beta: int, lanes: int) -> tuple:
    """(r1, y1, r2, y2, w_a, w_ac, w_ba, w_bac) of the combined check with
    the correction row (G in r1's slot, H in y1's, windows of -sum(a s) and
    -b sum(a s)) at lane n, as the backend lays it out (rows' generators
    must be G and H)."""
    a = alphas
    ac = [x * c % L for x, c in zip(a, rows["c"])]
    ba = [beta * x % L for x in a]
    bac = [beta * x % L for x in ac]
    sum_as = sum(x * s for x, s in zip(a, rows["s"])) % L
    G, H = he.BASEPOINT, Ristretto255.generator_h().point
    return (soa(rows["r1"] + [G], lanes), soa(rows["y1"] + [H], lanes),
            soa(rows["r2"], lanes), soa(rows["y2"], lanes),
            windows(a + [(L - sum_as) % L], lanes),
            windows(ac + [(L - beta * sum_as % L) % L], lanes),
            windows(ba, lanes), windows(bac, lanes))


def weights(seed: int, n: int) -> tuple[list[int], int]:
    """n alphas and a beta from a numpy seed."""
    rng = np.random.default_rng(seed)
    return ([int.from_bytes(rng.bytes(64), "little") % L for _ in range(n)],
            int.from_bytes(rng.bytes(64), "little") % L)


def tile(rows: dict, n: int) -> dict:
    """The rows repeated to n (wide inputs without n fresh proofs)."""
    reps = -(-n // len(rows["s"]))
    return {k: (v * reps)[:n] for k, v in rows.items()}


def partial_totals(seed: int, k: int, valid: bool) -> tuple[np.ndarray, ...]:
    """k chunk totals as ``[20, k]`` int32 limbs x 4: ``bench_kernels``'
    ``random_totals`` from a numpy seed (pairs P, -P and, for odd k, the
    identity, in scaled coordinates; not ``valid``: one replaced)."""
    pts = random_totals(np.random.default_rng(seed), k, valid)
    return tuple(np.ascontiguousarray(limbs.ints_to_limbs([p[c] for p in pts]))
                 for c in range(4))
