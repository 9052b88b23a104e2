"""Twin of ``__graft_entry__.py``'s ``dryrun_multichip(8)`` (the run
``MULTICHIP_r05.json`` records): the sharded combined check, the per-proof
check, the Pippenger MSM and the sharded prover over an 8-device mesh,
the port's over 8 CPU "devices" (the kernels' plain versions) and the JAX
package's over its 8 forced host devices, on the same seeded rows (one
valid row per two devices, as the dry run has, and a copy with row 2
tampered, which lands on slice 2): the same verdicts (both checks accept
the valid rows and reject the tampered copy), row bits and commitment
bytes, and the MSM's totals the JAX package's host sums.
"""

import dataclasses

import numpy as np
import pytest
import torch

import cpzk_tpu as J
import cpzk_tpu_torch as T
from cpzk_tpu.core.scalars import L
from cpzk_tpu.ops import curve as jcurve
from cpzk_tpu.ops import prove as jprove
from cpzk_tpu.parallel import mesh as jmesh
from cpzk_tpu_torch.ops import curve as tcurve
from cpzk_tpu_torch.ops.prove import BatchProver
from cpzk_tpu_torch.parallel import mesh as tmesh

from test_torch_mesh import SeededRng, make_entries, to_jax_row
from test_torch_mesh_twins import encoding, host_sum, jax_inputs, port_inputs

D = 8


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_dryrun_multichip_twin():
    import jax

    if jax.device_count() < D:
        pytest.skip(f"needs {D} forced host devices (tests/conftest.py)")
    tm, jm = tmesh.batch_mesh(["cpu"] * D), jmesh.batch_mesh(jax.devices()[:D])
    entries = make_entries(21, D // 2)
    bv = T.BatchVerifier(backend=T.CpuBackend())
    for p, st, pr in entries:
        bv.add(p, st, pr)
    rows = bv.prepare_rows(SeededRng(22))
    bad = 2  # off slice 0: slice 2 of the per-row routes
    tampered = list(rows)
    tampered[bad] = dataclasses.replace(rows[bad], s=T.Scalar((rows[bad].s.value + 1) % L))
    beta = T.Scalar(987654321)

    # the combined check (per-row route, correction row appended): the
    # valid rows accept, the tampered copy rejects, in both packages
    inputs = {}
    for name, rs, want in (("valid", rows, True), ("tampered", tampered, False)):
        _, per_row, msm_in, terms = port_inputs(rs, beta)
        _, jper_row, jmsm_in = jax_inputs(rs, beta)
        assert tmesh.sharded_combined_check(tm, *per_row) is want, name
        assert bool(jmesh.sharded_combined_check(jm, *jper_row)) is want, name
        inputs[name] = (msm_in, terms, jmsm_in)

    # the per-proof path on the same mesh, over the tampered copy
    n = len(rows)
    g, h = rows[0].g, rows[0].h
    jrows = [to_jax_row(r) for r in tampered]
    port_pts = [tcurve.points_soa([getattr(r, k).point for r in tampered], n, "cpu")
                for k in ("y1", "y2", "r1", "r2")]
    jax_pts = [jcurve.points_soa([getattr(r, k).point for r in jrows], n)
               for k in ("y1", "y2", "r1", "r2")]
    ws, wc = [r.s.value for r in tampered], [r.c.value for r in tampered]
    bits = tmesh.sharded_verify_each(
        tm, tcurve.points_to_device([g.point], "cpu"), tcurve.points_to_device([h.point], "cpu"),
        *port_pts, tcurve.scalar_windows(ws, n, "cpu"), tcurve.scalar_windows(wc, n, "cpu"))
    jbits = jmesh.sharded_verify_each(
        jm, jcurve.points_to_device([jrows[0].g.point]),
        jcurve.points_to_device([jrows[0].h.point]),
        *jax_pts, jcurve.scalar_windows(ws, n), jcurve.scalar_windows(wc, n))
    assert bits.tolist() == [bool(b) for b in np.asarray(jbits)] == [i != bad for i in range(n)]

    # the Pippenger MSM over the 4n + 2 terms: the valid total is the
    # identity, the tampered one is the host's sum and not the identity
    for name, want in (("valid", True), ("tampered", False)):
        (pts, digits, c), (elems, terms), (jpts, jdigits, jc) = inputs[name]
        assert tmesh.sharded_msm_check(tm, pts, digits, c) is want, name
        assert bool(jmesh.sharded_msm_check(jm, jpts, jdigits, jc)) is want, name
        if want:
            total = encoding(tmesh.make_sharded_msm(tm)(pts, digits, c))
            assert total == host_sum(elems, terms) == bytes(32)

    # the sharded prover
    scalars = [T.Ristretto255.random_scalar(SeededRng(23)).value for _ in range(n)]
    port_prover = BatchProver(T.Parameters.new(), device="cpu")
    jax_prover = jprove.BatchProver(J.Parameters.new())
    lsb = np.array(jprove._windows_lsb(scalars))
    b1, b2 = tmesh.sharded_prove(tm, port_prover._tg, port_prover._th, torch.from_numpy(lsb))
    j1, j2 = jmesh.sharded_prove(jm, jax_prover._tg, jax_prover._th, lsb)
    assert np.array_equal(b1.numpy().astype(np.uint8), np.asarray(j1, dtype=np.uint8))
    assert np.array_equal(b2.numpy().astype(np.uint8), np.asarray(j2, dtype=np.uint8))
