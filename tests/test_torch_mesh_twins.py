"""The port's sharded functions (``cpzk_tpu_torch/parallel/mesh.py``)
against the JAX package's (``cpzk_tpu/parallel/mesh.py``), side by side
on the same seeded rows: per-row bits, the per-row combined check, the MSM
check and its total's canonical encoding (held against the JAX package's
host arithmetic), and the commitments' bytes.  The port runs over two CPU
"devices" (the kernels' plain versions), the JAX package over two of its
forced host devices (``tests/conftest.py``); the JAX side's shard_map
programs compile once each (most of this file's time).
"""

import dataclasses

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.core.scalars import L
from cpzk_tpu.ops import backend as jbackend
from cpzk_tpu.ops import curve as jcurve
from cpzk_tpu.ops import msm as jmsm
from cpzk_tpu.ops import prove as jprove
from cpzk_tpu.parallel import mesh as jmesh
from cpzk_tpu_torch.ops import backend as tbackend
from cpzk_tpu_torch.ops import curve as tcurve
from cpzk_tpu_torch.ops import msm as tmsm
from cpzk_tpu_torch.ops.prove import BatchProver
from cpzk_tpu_torch.parallel import mesh as tmesh

from test_torch_mesh import CPU2, SeededRng, make_entries, to_jax_row


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_mesh(d):
    import jax

    return jmesh.batch_mesh(jax.devices()[:d])


@pytest.fixture(scope="module")
def case():
    """Eight seeded rows (row 3 tampered in the copy), beta, and each
    package's marshalled inputs of the sharded functions."""
    entries = make_entries(5, 8)
    bv = T.BatchVerifier(backend=T.CpuBackend())
    for p, st, pr in entries:
        bv.add(p, st, pr)
    rows = bv.prepare_rows(SeededRng(6))
    bad = dataclasses.replace(rows[3], s=T.Scalar((rows[3].s.value + 1) % L))
    tampered = rows[:3] + [bad] + rows[4:]
    beta = T.Scalar(12345)
    return {"rows": rows, "tampered": tampered, "beta": beta}


def port_inputs(rows, beta):
    """(pad, per-row route inputs, (points, digits, c), terms) on the host,
    as ``TorchBackend`` marshals them."""
    n = len(rows)
    a, ac, ba, bac, corr0, corr1 = tbackend._host_rlc_scalars(rows, beta)
    pad = n + 1
    per_row = (tbackend._elems_soa([r.r1 for r in rows] + [rows[0].g], pad, "cpu"),
               tbackend._elems_soa([r.y1 for r in rows] + [rows[0].h], pad, "cpu"),
               tbackend._elems_soa([r.r2 for r in rows], pad, "cpu"),
               tbackend._elems_soa([r.y2 for r in rows], pad, "cpu"),
               tcurve.scalar_windows(a + [corr0], pad, "cpu"),
               tcurve.scalar_windows(ac + [corr1], pad, "cpu"),
               tcurve.scalar_windows(ba, pad, "cpu"), tcurve.scalar_windows(bac, pad, "cpu"))
    elems = ([r.r1 for r in rows] + [r.y1 for r in rows] + [r.r2 for r in rows]
             + [r.y2 for r in rows] + [rows[0].g, rows[0].h])
    terms = a + ac + ba + bac + [corr0, corr1]
    c = tmsm.pick_window(len(terms))
    digits = tmsm.scalars_to_signed_digits(terms, c)
    return pad, per_row, (tbackend._elems_soa(elems, len(terms), "cpu"),
                          torch.from_numpy(digits), c), (elems, terms)


def jax_inputs(rows, beta):
    """The same inputs marshalled by the JAX package."""
    jrows = [to_jax_row(r) for r in rows]
    n = len(jrows)
    a, ac, ba, bac, corr0, corr1 = tbackend._host_rlc_scalars(rows, beta)
    pad = n + 1
    soa = jbackend._elems_soa
    per_row = (soa([r.r1 for r in jrows] + [jrows[0].g], pad),
               soa([r.y1 for r in jrows] + [jrows[0].h], pad),
               soa([r.r2 for r in jrows], pad), soa([r.y2 for r in jrows], pad),
               jcurve.scalar_windows(a + [corr0], pad), jcurve.scalar_windows(ac + [corr1], pad),
               jcurve.scalar_windows(ba, pad), jcurve.scalar_windows(bac, pad))
    elems = ([r.r1 for r in jrows] + [r.y1 for r in jrows] + [r.r2 for r in jrows]
             + [r.y2 for r in jrows] + [jrows[0].g, jrows[0].h])
    terms = a + ac + ba + bac + [corr0, corr1]
    c = jmsm.pick_window(len(terms))
    import jax.numpy as jnp

    return pad, per_row, (soa(elems, len(terms)),
                          jnp.asarray(jmsm.scalars_to_signed_digits(terms, c)), c)


def host_sum(elems, terms) -> bytes:
    """sum_i terms_i * elems_i by the JAX package's host arithmetic."""
    acc = J.Ristretto255.identity()
    for e, k in zip(elems, terms):
        p = J.Ristretto255.element_from_bytes(e.wire())
        acc = J.Ristretto255.element_mul(acc, J.Ristretto255.scalar_mul(p, J.Scalar(k)))
    return J.Ristretto255.element_to_bytes(acc)


def encoding(point) -> bytes:
    return bytes(tcurve.encode(tuple(c.cpu()[:, None] for c in point))
                 .to(torch.uint8)[:, 0].tolist())


# --- the sharded functions, side by side ----------------------------------------


def test_sharded_verify_each_matches_the_reference(case):
    """Per-row bits of eight rows (row 3 tampered) over two slices: the
    port's and the JAX package's are the same, and right."""
    tm, jm = tmesh.batch_mesh(CPU2), jax_mesh(2)
    rows, tampered = case["rows"], case["tampered"]
    g, h = rows[0].g, rows[0].h
    tg = tcurve.points_to_device([g.point], "cpu")
    th = tcurve.points_to_device([h.point], "cpu")
    jg = jcurve.points_to_device([J.Ristretto255.element_from_bytes(g.wire()).point])
    jh = jcurve.points_to_device([J.Ristretto255.element_from_bytes(h.wire()).point])
    n = len(rows)
    port_rows = [tbackend._elems_soa([getattr(r, k) for r in tampered], n, "cpu")
                 for k in ("y1", "y2", "r1", "r2")]
    jrows = [to_jax_row(r) for r in tampered]
    jax_rows = [jbackend._elems_soa([getattr(r, k) for r in jrows], n)
                for k in ("y1", "y2", "r1", "r2")]
    ws = [r.s.value for r in tampered]
    wc = [r.c.value for r in tampered]
    bits = tmesh.sharded_verify_each(tm, tg, th, *port_rows, tcurve.scalar_windows(ws, n, "cpu"),
                                     tcurve.scalar_windows(wc, n, "cpu"))
    jbits = jmesh.sharded_verify_each(jm, jg, jh, *jax_rows, jcurve.scalar_windows(ws, n),
                                      jcurve.scalar_windows(wc, n))
    assert bits.tolist() == [bool(b) for b in np.asarray(jbits)] == [i != 3 for i in range(n)]


@pytest.mark.parametrize("which", ["valid", "tampered"])
def test_sharded_combined_and_msm_checks_match_the_reference(case, which):
    """The per-row combined check and the Pippenger MSM check over two
    slices: the same verdicts as the JAX package's, and the MSM's total is
    the JAX package's host sum as a canonical encoding (the identity for
    valid rows)."""
    tm, jm = tmesh.batch_mesh(CPU2), jax_mesh(2)
    rows = case["rows"] if which == "valid" else case["tampered"]
    want = which == "valid"
    pad, per_row, (pts, digits, c), (elems, terms) = port_inputs(rows, case["beta"])
    jpad, jper_row, (jpts, jdigits, jc) = jax_inputs(rows, case["beta"])
    assert (pad, c) == (jpad, jc)
    assert tmesh.sharded_combined_check(tm, *per_row) is want
    assert bool(jmesh.sharded_combined_check(jm, *jper_row)) is want
    assert tmesh.sharded_msm_check(tm, pts, digits, c) is want
    assert bool(jmesh.sharded_msm_check(jm, jpts, jdigits, jc)) is want
    total = encoding(tmesh.make_sharded_msm(tm)(pts, digits, c))
    assert total == host_sum(elems, terms)
    assert (total == bytes(32)) is want


def test_sharded_prove_matches_the_reference():
    """The commitments of five scalars over two slices: the port's bytes
    are the JAX package's sharded prover's."""
    tm, jm = tmesh.batch_mesh(CPU2), jax_mesh(2)
    port_prover = BatchProver(T.Parameters.new(), device="cpu")
    jax_prover = jprove.BatchProver(J.Parameters.new())
    scalars = [T.Ristretto255.random_scalar(SeededRng(8)).value for _ in range(5)]
    digits = np.array(jprove._windows_lsb(scalars))
    b1, b2 = tmesh.sharded_prove(tm, port_prover._tg, port_prover._th, torch.from_numpy(digits))
    j1, j2 = jmesh.sharded_prove(jm, jax_prover._tg, jax_prover._th, digits)
    assert np.array_equal(b1.numpy().astype(np.uint8), np.asarray(j1, dtype=np.uint8))
    assert np.array_equal(b2.numpy().astype(np.uint8), np.asarray(j2, dtype=np.uint8))
