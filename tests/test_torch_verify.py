"""Differential tests: the port's per-proof verification ladder
(:func:`cpzk_tpu_torch.ops.verify.verify_each_kernel`) against the JAX
package's (jitted on the CPU backend); the combined check is in
tests/test_torch_combined.py, which shares this file's batch.

One small batch: 6 proof rows (one with a tampered response) in 8 lanes,
the rest identity-padded; the combined check adds the correction row at
lane 6.  Points and windows are built once as numpy arrays and handed to
both packages through :mod:`cpzk_tpu_torch.convert`.  The per-lane masks
must be equal (tolerance: exact)."""

import numpy as np
import pytest

import jax

from cpzk_tpu.ops import curve as jc
from cpzk_tpu.ops import verify as jv
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.core import edwards as he
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.ops import verify as tv

ROWS = 6
LANES = 8
TAMPERED = 3


def make_batch():
    """6 proofs (y1, y2, r1, r2, c, s per row), alphas and beta, from a
    numpy seed."""
    rng = np.random.default_rng(99)

    def scalar():
        return int.from_bytes(rng.bytes(64), "little") % L

    G = he.BASEPOINT
    H = Ristretto255.generator_h().point
    rows = []
    for _ in range(ROWS):
        x, k, c = scalar(), scalar(), scalar()
        rows.append({
            "y1": he.pt_scalar_mul(G, x), "y2": he.pt_scalar_mul(H, x),
            "r1": he.pt_scalar_mul(G, k), "r2": he.pt_scalar_mul(H, k),
            "c": c, "s": (k + c * x) % L,
        })
    alphas = [scalar() for _ in range(ROWS)]
    beta = scalar()
    return G, H, rows, alphas, beta


@pytest.fixture(scope="module")
def batch():
    return make_batch()


def soa(points):
    return jc.points_to_device(points + [he.IDENTITY] * (LANES - len(points)))


def windows(values):
    return jc.scalars_to_windows(values + [0] * (LANES - len(values)))


def s_values(rows, tampered):
    return [(r["s"] + (1 if tampered and i == TAMPERED else 0)) % L
            for i, r in enumerate(rows)]


def combined_inputs(G, H, rows, alphas, beta, tampered):
    s = s_values(rows, tampered)
    a = alphas
    ac = [x * r["c"] % L for x, r in zip(a, rows)]
    ba = [beta * x % L for x in a]
    bac = [beta * x % L for x in ac]
    sum_as = sum(x * y for x, y in zip(a, s)) % L
    pts = (
        soa([r["r1"] for r in rows] + [G]),
        soa([r["y1"] for r in rows] + [H]),
        soa([r["r2"] for r in rows]),
        soa([r["y2"] for r in rows]),
    )
    wins = (
        windows(a + [(L - sum_as) % L]),
        windows(ac + [(L - beta * sum_as % L) % L]),
        windows(ba),
        windows(bac),
    )
    return pts, wins


def to_torch(pts, wins):
    return [convert.point(p, "cpu") for p in pts] + [convert.tensor(w, "cpu") for w in wins]


def test_verify_each_kernel_matches_jax(batch):
    G, H, rows, _, _ = batch
    g = jc.points_to_device([G])
    h = jc.points_to_device([H])
    pts = [soa([r[k] for r in rows]) for k in ("y1", "y2", "r1", "r2")]
    ws = windows(s_values(rows, tampered=True))
    wc = windows([r["c"] for r in rows])
    jmask = np.asarray(jax.jit(jv.verify_each_kernel)(g, h, *pts, ws, wc))
    tmask = tv.verify_each_kernel(
        convert.point(g, "cpu"), convert.point(h, "cpu"),
        *[convert.point(p, "cpu") for p in pts],
        convert.tensor(ws, "cpu"), convert.tensor(wc, "cpu"))
    np.testing.assert_array_equal(jmask, convert.to_numpy(tmask))
    expect = [i != TAMPERED for i in range(LANES)]  # padded lanes pass
    assert list(convert.to_numpy(tmask)) == expect
