"""The port's batched Keccak-f[1600] and device Fiat-Shamir derivation
(:mod:`cpzk_tpu_torch.ops.keccak`, :mod:`.ops.challenge`) on the CPU, where
the hand-written ``keccak_chain`` kernel runs its plain PyTorch version:
twins of the six cases of ``tests/test_ops_keccak.py``, and the same seeded
inputs through the JAX package's ``keccak_f1600``, ``_absorb_permute_chain``
and ``derive_challenges_device``.

And the kernels' own bodies, compiled for the host through
``csrc/host_shim.cpp``: ``keccak_chain``'s row body (both threads of a
row's pair) and ``reduce_wide``'s lane body on the same seeded states,
masks and wide values as the JAX package's ``_absorb_permute_chain`` and
``sclimbs.reduce_wide``.

Tolerance: exact (lane words bit for bit, challenge bytes, scalars)."""

import numpy as np
import pytest
import torch

import jax

from cpzk_tpu.ops import challenge as jchallenge
from cpzk_tpu.ops import keccak as jkeccak
from cpzk_tpu.ops import sclimbs as jsclimbs
from cpzk_tpu_torch.bench_kernels import wide_case
from cpzk_tpu_torch.core import keccak as host
from cpzk_tpu_torch.core.scalars import sc_from_bytes_mod_order_wide
from cpzk_tpu_torch.core.transcript import (
    CHALLENGE_DST, PROTOCOL_DST, PROTOCOL_LABEL, MerlinTranscript, derive_challenges_batch,
)
from cpzk_tpu_torch.ops import challenge, keccak, keccak_kernels as kk, sclimbs as sc
import torch_host_shim
import torch_reference_core


@pytest.fixture(autouse=True, scope="module")
def reference_core():
    """The reference's host core, built under a lock (see
    ``tests/torch_reference_core.py``) and loaded in this worker."""
    return torch_reference_core.require()


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return torch_host_shim.build(tmp_path_factory)


def random_lanes(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**64, size=(n, 25), dtype=np.uint64)


def jax_permute(lanes):
    return jkeccak.state_to_lanes(jax.jit(jkeccak.keccak_f1600)(jkeccak.lanes_to_state(lanes)))


def test_device_permutation_matches_host():
    n = 17
    lanes = random_lanes(1, n)
    got = keccak.state_to_lanes(keccak.keccak_f1600(keccak.lanes_to_state(lanes, "cpu")))
    for i in range(n):
        assert [int(v) for v in got[i]] == host.keccak_f1600([int(v) for v in lanes[i]]), i
    assert np.array_equal(got, jax_permute(lanes))


def test_device_permutation_zero_and_ones():
    for lanes in (np.zeros((1, 25), dtype=np.uint64),
                  np.full((1, 25), 0xFFFFFFFFFFFFFFFF, dtype=np.uint64)):
        got = keccak.state_to_lanes(keccak.keccak_f1600(keccak.lanes_to_state(lanes, "cpu")))
        assert [int(v) for v in got[0]] == host.keccak_f1600([int(v) for v in lanes[0]])
        assert np.array_equal(got, jax_permute(lanes))


def test_device_permutation_iterated():
    """Three chained permutations stay in lockstep with the host (no
    sign-extension drift across applications); the wrapper's one-mask
    form too."""
    lanes = np.array([[i * 0x9E3779B97F4A7C15 % (1 << 64) for i in range(25)]],
                     dtype=np.uint64)
    st = keccak.lanes_to_state(lanes, "cpu")
    wst = st
    exp = [int(v) for v in lanes[0]]
    for _ in range(3):
        st = keccak.keccak_f1600(st)
        wst = kk.keccak_f1600(wst)
        exp = host.keccak_f1600(exp)
    assert [int(v) for v in keccak.state_to_lanes(st)[0]] == exp
    assert torch.equal(st[0], wst[0]) and torch.equal(st[1], wst[1])


def test_absorb_chain_matches_jax():
    """The plain absorb chain against the JAX ``_absorb_permute_chain`` on
    one seeded state per row and three seeded masks."""
    rng = np.random.default_rng(4)
    n, k = 11, 3
    s_hi, s_lo = (rng.integers(-2**31, 2**31, (25, n), dtype=np.int64).astype(np.int32)
                  for _ in range(2))
    m_hi, m_lo = (rng.integers(-2**31, 2**31, (k, 25, n), dtype=np.int64).astype(np.int32)
                  for _ in range(2))
    got = kk.keccak_chain(*(torch.from_numpy(a) for a in (s_hi, s_lo, m_hi, m_lo)))
    want = jchallenge._absorb_permute_chain(s_hi, s_lo, m_hi, m_lo)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("shared,k", [(False, 3), (True, 3), (True, 1), (False, 0)])
def test_chain_row_body_matches_jax(host_lib, shared, k):
    """``keccak_chain``'s row body from ``csrc/keccak_u64.cuh`` (compiled
    for the host: both threads of each row's pair at once) on seeded states
    (one a row, or one shared) and k seeded masks: the words of the JAX
    ``_absorb_permute_chain`` on the same arrays (the state broadcast)."""
    rng = np.random.default_rng(40 + k + shared)
    n = 33
    width = 1 if shared else n
    s_hi, s_lo = (rng.integers(-2**31, 2**31, (25, width), dtype=np.int64).astype(np.int32)
                  for _ in range(2))
    m_hi, m_lo = (rng.integers(-2**31, 2**31, (k, 25, n), dtype=np.int64).astype(np.int32)
                  for _ in range(2))
    tensors = [torch.from_numpy(a) for a in (s_hi, s_lo, m_hi, m_lo)]
    out = [torch.empty((25, n), dtype=torch.int32) for _ in range(2)]
    host_lib.host_keccak_chain(*(t.data_ptr() for t in tensors[:2]), int(shared),
                               *(t.data_ptr() for t in tensors[2:]), k, n,
                               out[0].data_ptr(), out[1].data_ptr())
    want = (np.broadcast_to(s_hi, (25, n)), np.broadcast_to(s_lo, (25, n)))
    if k:
        want = jchallenge._absorb_permute_chain(*want, m_hi, m_lo)
    assert np.array_equal(out[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(out[1].numpy(), np.asarray(want[1]))


def test_reduce_wide_lane_body_matches_jax(host_lib):
    """``reduce_wide``'s lane body from ``csrc/sc25519_w32.cuh`` (the fold at
    bit 252, compiled for the host) on seeded 64-byte values led by 0, 1,
    l - 1, l, 2 l, 2^252, 2^256 - 1 and 2^512 - 1: the limbs of the JAX
    ``sclimbs.reduce_wide``."""
    blobs = wide_case(np.random.default_rng(41), 96)
    wide = torch.from_numpy(sc.bytes_wide_to_limbs(blobs))
    out = torch.empty((20, wide.shape[1]), dtype=torch.int32)
    host_lib.host_reduce_wide(wide.data_ptr(), 40, out.data_ptr(), wide.shape[1])
    want = np.asarray(jax.jit(jsclimbs.reduce_wide)(wide.numpy()))
    assert np.array_equal(out.numpy(), want)


def columns(seed, n, names, width=32):
    rng = np.random.default_rng(seed)
    return {name: np.frombuffer(rng.bytes(width * n), dtype=np.uint8).reshape(n, width).copy()
            for name in names}


POINTS = (("g", b"generator-g"), ("h", b"generator-h"), ("y1", b"y1"), ("y2", b"y2"),
          ("r1", b"r1"), ("r2", b"r2"))


def host_row(cols, ctx, i):
    t = MerlinTranscript(PROTOCOL_LABEL)
    t.append_message(b"protocol", PROTOCOL_DST)
    if ctx is not None:
        t.append_message(b"context", ctx[i].tobytes())
    for name, label in POINTS:
        t.append_message(label, cols[name][i].tobytes())
    return t.challenge_bytes(CHALLENGE_DST, 64)


def test_device_challenge_derivation_matches_host():
    """Byte-identical to the per-row Merlin transcript, with and without a
    context, and to the JAX package's device derivation."""
    n = 9
    cols = columns(5, n, ("ctx", "g", "h", "y1", "y2", "r1", "r2"))
    for with_ctx in (True, False):
        ctx = cols["ctx"] if with_ctx else None
        args = (ctx, *(cols[name] for name, _ in POINTS))
        got = challenge.derive_challenges_device(*args, device="cpu")
        assert got.dtype == np.uint8 and got.shape == (n, 64)
        for i in range(n):
            assert got[i].tobytes() == host_row(cols, ctx, i), (with_ctx, i)
        assert np.array_equal(got, jchallenge.derive_challenges_device(*args))


def test_device_challenge_odd_context_length():
    """A 147-byte context pushes the first message across the 166-byte
    STROBE rate boundary (a permutation mid-message)."""
    n = 3
    ctx = columns(6, n, ("ctx",), width=147)["ctx"]
    pts = columns(7, n, [name for name, _ in POINTS])
    args = (ctx, *(pts[name] for name, _ in POINTS))
    got = challenge.derive_challenges_device(*args, device="cpu")
    for i in range(n):
        assert got[i].tobytes() == host_row(pts, ctx, i), i
    assert np.array_equal(got, jchallenge.derive_challenges_device(*args))


def test_device_challenges_match_host_batch_api():
    """The same Scalars as the host core's ``derive_challenges_batch``
    (no context, a 32-byte one, an empty one), reduced on the host and by
    ``sclimbs.reduce_wide`` (the plain version of the ``reduce_wide``
    kernel)."""
    n = 6
    rng = np.random.default_rng(8)
    cols = [[rng.bytes(32) for _ in range(n)] for _ in range(6)]

    def as_cols(xs):
        blob = b"".join(xs)
        if not blob:
            return np.zeros((len(xs), 0), dtype=np.uint8)
        return np.frombuffer(blob, dtype=np.uint8).reshape(len(xs), -1)

    for contexts in ([None] * n, [b"X" * 32] * n, [b""] * n):
        expected = [s.value for s in derive_challenges_batch(contexts, *cols)]
        ctx = None if contexts[0] is None else as_cols(contexts)
        chal = challenge.derive_challenges_device(ctx, *(as_cols(c) for c in cols),
                                                  device="cpu")
        assert [sc_from_bytes_mod_order_wide(chal[i].tobytes()) for i in range(n)] == expected
        limbs = sc.reduce_wide(torch.from_numpy(sc.bytes_wide_to_limbs(chal)))
        assert sc.limbs_to_ints(limbs) == expected


def test_device_challenges_need_cuda_unless_asked_for_cpu(monkeypatch):
    """``device=None`` means the card and raises without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cols = columns(9, 2, [name for name, _ in POINTS])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        challenge.derive_challenges_device(None, *(cols[name] for name, _ in POINTS))
