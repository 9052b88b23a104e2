"""``cpzk_tpu_torch.ops.decode_kernels``: the ristretto DECODE kernel's
wrapper on the CPU (its plain version) against the JAX package's
``curve.decode``, its layouts and its routing.

The wrapper takes the kernel's layout only (``[n, 32]`` uint8 wires) and
returns ``[4, 8, n]`` canonical words and ``[n]`` validity bytes; it runs
on ``cuda:0`` unless the caller passes a device and raises without CUDA.
The kernel itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``'s ``decode`` phase); its lane body is held against the
plain version on the host in ``tests/test_torch_kernel_host.py``."""

import numpy as np
import pytest
import torch

from cpzk_tpu_torch.core import edwards
from cpzk_tpu_torch.ops import decode_kernels as dk, limbs

#: the reference's rejected cases (tests/test_ristretto.py), p, the
#: identity, the base point, its double and random bytes
ROWS = [
    (edwards.P + 2).to_bytes(32, "little"), (3).to_bytes(32, "little"), b"\xff" * 32,
    edwards.P.to_bytes(32, "little"), bytes(32), edwards.ristretto_encode(edwards.BASEPOINT),
    edwards.ristretto_encode(edwards.pt_add(edwards.BASEPOINT, edwards.BASEPOINT)),
] + [np.random.default_rng(3).bytes(32) for _ in range(9)]


@pytest.fixture(scope="module")
def wires():
    return np.frombuffer(b"".join(ROWS), dtype=np.uint8).reshape(len(ROWS), 32).copy()


def test_cpu_route_matches_the_jax_decode(wires):
    """The wrapper on the CPU equals the JAX ``curve.decode`` (validity
    exact, points after canonicalization) and the pure decode."""
    import jax.numpy as jnp

    from cpzk_tpu.ops import curve as jax_curve

    dk.reset_launches()
    words, valid = dk.ristretto_decode(torch.from_numpy(wires), device="cpu")
    assert dk.LAUNCHES == {"ristretto_decode": 0}  # the plain version launches nothing
    assert words.dtype == torch.int32 and words.shape == (4, 8, len(ROWS))
    assert valid.dtype == torch.uint8 and valid.shape == (len(ROWS),)
    point, jax_valid = jax_curve.decode(jnp.asarray(wires.T.astype(np.int32)))
    assert np.array_equal(np.asarray(jax_valid), valid.numpy().astype(bool))
    assert torch.equal(dk.limbs_to_words(tuple(torch.from_numpy(np.asarray(c)) for c in point)),
                       words)
    assert [bool(v) for v in valid] == [edwards.ristretto_decode(r) is not None for r in ROWS]
    assert valid[:7].tolist() == [0, 0, 0, 0, 1, 1, 1]


def test_words_and_limbs_round_trip(wires):
    """``words_to_limbs`` gives the canonical limbs of the decoded point,
    ``limbs_to_words`` takes them back, and the point is the pure decode's."""
    words, valid = dk.ristretto_decode(torch.from_numpy(wires), device="cpu")
    point = dk.words_to_limbs(words)
    assert all(c.shape == (20, len(ROWS)) and c.dtype == torch.int32 for c in point)
    assert torch.equal(dk.limbs_to_words(point), words)
    j = 5  # the base point
    x, y, z, t = (limbs.limbs_to_int(c[:, j].numpy()) for c in point)
    assert edwards.pt_eq((x, y, z, t), edwards.ristretto_decode(ROWS[j]))


def test_layout_and_device_are_checked(wires, monkeypatch):
    w = torch.from_numpy(wires)
    for bad in (w.t().contiguous(), w.to(torch.int32), w[:0], w[:, :31]):
        with pytest.raises(ValueError):
            dk.ristretto_decode(bad, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        dk.ristretto_decode(w, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dk.ristretto_decode(w)


def test_decode_work_counts_bytes_and_operations():
    nbytes, ops = dk.decode_work(16384)
    assert nbytes == 161 * 16384 and ops == dk.DECODE_OPS * 16384
    assert dk.DECODE_OPS > 257 * 100  # a few hundred field operations a lane


def test_decode_phase_rehearsal():
    """``chip_smoke.py``'s ``decode`` phase on the CPU at small widths (the
    kernel's plain version; nothing timed or counted): its own checks (the
    validity and canonical words equal to the plain version and to the
    host core's, invalid lanes the identity, every listed case decided as
    the reference decides it, the ``matmulfold`` multiply bit for bit the
    schoolbook one) must hold."""
    import pathlib
    import runpy

    smoke = runpy.run_path(str(pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"),
                           run_name="chip_smoke_rehearsal")
    _, corpus, _ = smoke["make_corpus"](4, smoke["SeededRng"](1))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small plain ops beside the suite's other workers
    try:
        out = smoke["decode_phase"](torch.device("cpu"), corpus, (48, 16), 48, 1, 1e12,
                                    smoke["SeededRng"](2), on_card=False)
    finally:
        torch.set_num_threads(threads)
    assert [r["n"] for r in out["results"]] == [48, 16]
    for r in out["results"]:
        assert r["max_abs_err"] == r["host_max_abs_err"] == 0
        assert r["cases"] == {"p+2": 0, "odd": 0, "all-ones": 0, "p": 0, "p-1": 0,
                              "bit-255": 0, "identity": 1}
        assert r["bound_by"] == "operations"
    assert out["mul_variants"]["bit_equal"]
