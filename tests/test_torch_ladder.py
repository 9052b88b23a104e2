"""Differential tests: the port's per-row ladders on the CPU against the JAX
package's (jitted on the CPU backend).  On a CPU tensor the port's
:func:`verify.verify_each_kernel`, :func:`verify.combined_partial_kernel`,
:func:`verify.combined_kernel`, :func:`verify.partials_identity` and
:func:`backend.chunked_combined_identity` run their plain versions, the
composition a CUDA tensor hands to the ladder kernels of
:mod:`cpzk_tpu_torch.ops.ladder_kernels`.

Inputs from a numpy seed (``tests/torch_ladder_inputs.py``): valid rows and
rows tampered three ways (a response off by one; a commitment of either
equation swapped), shared and per-lane generators, the combined check's
correction row, identity-padded lanes with zero windows, ragged widths
(21 and 14 lanes) and a check split into three lane chunks.  Bits and
verdicts must be equal; partial points equal after ``limbs.canonical``
(tolerance: exact)."""

import numpy as np
import pytest
import torch

import jax

from cpzk_tpu.ops import backend as jb
from cpzk_tpu.ops import limbs as jl
from cpzk_tpu.ops import verify as jv
from cpzk_tpu_torch import convert
from cpzk_tpu_torch.ops import backend as tb
from cpzk_tpu_torch.ops import ladder_kernels as lk
from cpzk_tpu_torch.ops import limbs as tl
from cpzk_tpu_torch.ops import verify as tv
from torch_ladder_inputs import (combined_inputs, each_inputs, make_rows, partial_totals,
                                 weights)

EACH_ROWS, EACH_LANES = 18, 21
EACH_TAMPERED = {2: "s", 5: "r1", 11: "r2"}
COMBINED_ROWS = 13
CHUNK, CHUNKED_ROWS, CHUNKED_PAD = 8, 20, 24


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the plain ladders run many small tensor ops, and
    a full thread team each, beside the suite's other workers,
    oversubscribes the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def no_launches():
    """On the CPU no wrapper launches a kernel."""
    before = dict(lk.LAUNCHES)
    yield
    assert lk.LAUNCHES == before


def to_port(arrays, points: int):
    return ([convert.point(p, "cpu") for p in arrays[:points]]
            + [convert.tensor(w, "cpu") for w in arrays[points:]])


def assert_points_equal(jpoint, tpoint):
    for j, t in zip(jpoint, tpoint):
        np.testing.assert_array_equal(np.asarray(jl.canonical(j)),
                                      convert.to_numpy(tl.canonical(t)))


@pytest.mark.parametrize("shared", [True, False], ids=["shared_generators", "per_lane"])
def test_verify_each_matches_jax(shared):
    rows = make_rows(7 if shared else 8, EACH_ROWS, EACH_TAMPERED,
                     per_lane_generators=not shared)
    arrays = each_inputs(rows, EACH_LANES, shared)
    jmask = np.asarray(jax.jit(jv.verify_each_kernel)(*arrays))
    port = to_port(arrays, 6)
    tmask = tv.verify_each_kernel(*port)
    np.testing.assert_array_equal(jmask, convert.to_numpy(tmask))
    # padded lanes (identity points, zero windows) pass
    expect = [i not in EACH_TAMPERED for i in range(EACH_ROWS)]
    assert list(convert.to_numpy(tmask)) == expect + [True] * (EACH_LANES - EACH_ROWS)
    # the same bits through out=, into a slice of a larger mask
    mask = torch.zeros((EACH_LANES + 3,), dtype=torch.bool)
    tv.verify_each_kernel(*port, out=mask[1:EACH_LANES + 1])
    assert torch.equal(mask[1:EACH_LANES + 1], tmask)
    assert not bool(mask[0]) and not bool(mask[-1])


@pytest.mark.parametrize("lanes,tampered", [(COMBINED_ROWS + 1, False), (16, True)],
                         ids=["ragged_valid", "padded_tampered"])
def test_combined_matches_jax(lanes, tampered):
    rows = make_rows(11, COMBINED_ROWS, {4: "s"} if tampered else None)
    alphas, beta = weights(12, COMBINED_ROWS)
    arrays = combined_inputs(rows, alphas, beta, lanes)
    jtotal = jax.jit(jv.combined_partial_kernel)(*arrays)
    jok = bool(jax.jit(jv.combined_kernel)(*arrays))
    port = to_port(arrays, 4)
    ttotal = tv.combined_partial_kernel(*port)
    assert all(tuple(c.shape) == (20, 1) for c in ttotal)
    assert_points_equal(jtotal, ttotal)
    tok = tv.combined_kernel(*port)
    assert tok.shape == () and tok.dtype == torch.bool
    assert jok is bool(tok) is (not tampered)


@pytest.mark.parametrize("tampered", [False, True], ids=["valid", "tampered"])
def test_chunked_combined_matches_jax(tampered):
    """Three lane chunks of 8: the chunk partials equal the JAX package's,
    their sum's identity test equals ``backend._partials_impl``'s, and the
    port's ``chunked_combined_identity`` gives the same verdict.  Each port
    partial is written into its column of one array (``out=``)."""
    rows = make_rows(21, CHUNKED_ROWS, {17: "s"} if tampered else None)
    alphas, beta = weights(22, CHUNKED_ROWS)
    arrays = combined_inputs(rows, alphas, beta, CHUNKED_PAD)
    j_partial = jax.jit(jv.combined_partial_kernel)
    jparts = [j_partial(*(tuple(c[:, lo:lo + CHUNK] for c in p) for p in arrays[:4]),
                        *(w[:, lo:lo + CHUNK] for w in arrays[4:]))
              for lo in range(0, CHUNKED_PAD, CHUNK)]
    jstacked = tuple(np.concatenate([np.asarray(p[k]) for p in jparts], axis=-1)
                     for k in range(4))
    jok = bool(jax.jit(jb._partials_impl)(jstacked))
    port = to_port(arrays, 4)
    tparts = tuple(torch.empty((20, CHUNKED_PAD // CHUNK), dtype=torch.int32)
                   for _ in range(4))
    for i, lo in enumerate(range(0, CHUNKED_PAD, CHUNK)):
        tv.combined_partial_kernel(*(tuple(c[:, lo:lo + CHUNK] for c in p) for p in port[:4]),
                                   *(w[:, lo:lo + CHUNK] for w in port[4:]),
                                   out=tuple(c[:, i:i + 1] for c in tparts))
    assert_points_equal(jstacked, tparts)
    assert bool(tv.partials_identity(tparts)) is jok is (not tampered)
    assert tb.chunked_combined_identity(CHUNKED_PAD, CHUNK, *port) is jok


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "tampered"])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_partials_identity_matches_jax(k, valid):
    """k chunk totals from one numpy seed (pairs P, -P and the identity for
    odd k, in scaled coordinates; one replaced when tampered) through
    ``backend._partials_impl`` and the port's ``partials_identity_plain``
    (and ``partials_identity``, which routes CPU tensors to it): the same
    verdict, the expected one."""
    arrays = partial_totals(60 + k, k, valid)
    jok = bool(jax.jit(jb._partials_impl)(arrays))
    parts = convert.point(arrays, "cpu")
    assert jok is bool(tv.partials_identity_plain(parts)) is valid
    assert bool(tv.partials_identity(parts)) is valid
