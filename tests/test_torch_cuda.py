"""The CUDA kernels on the card, against their plain PyTorch versions on the
same CUDA tensors: the point kernels equal after canonicalization with every
output limb within the loose bound (they compute in their own radix); the
scalar kernels exact (``torch.equal``: both canonical); the MSM kernels
equal as group elements (the encodings: the order of the adds differs).
The Keccak chain and the wide reduction exact (the chain also at 17, 33
and 4097 rows with k = 0 to 5; the reduction also on edge values and 24
limbs); the comb tables equal
after canonicalization; the commitments' bytes identical (and equal to the
host core's comb).  The ristretto DECODE kernel's canonical words and
validity exact, on valid, random and rejected encodings, also at lane
counts that leave a block partly past n; the scalar recode exact at
ragged row and term counts; the matmulfold
multiply bit for bit the schoolbook one in float64 on the card.  The
per-row ladder kernels against their plain versions (the step-by-step
composition over the point kernels): per-row bits and combined verdicts
exact, chunk totals equal as group elements (``curve.eq``), on valid and
tampered rows, shared and per-lane generators, ragged widths (lane counts
that are no multiple of a warp's lanes, one lane, a full chunk) and a check of
three lane chunks; the partials' sum over 1 to 92 random totals; the
scalar products at a ragged row count, at every scalar l - 1 and with the
rows' a s summing past 2^256.  Also the launch counters and the block size.  Needs an NVIDIA GPU
with nvcc: marked ``cuda`` and skipped elsewhere.  On the machine with the
card (no JAX there, so without tests/conftest.py):
``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q``."""

import random

import numpy as np
import pytest
import torch

from cpzk_tpu_torch.bench_kernels import rlc_case, wide_edges
from cpzk_tpu_torch.core import edwards as he
from cpzk_tpu_torch.core.scalars import L
from cpzk_tpu_torch.ops import curve, limbs, msm, msm_kernels as mk, point_kernels as pk
from cpzk_tpu_torch.ops import scalar_kernels as sk, sclimbs as sc
from cpzk_tpu_torch.ops import decode_kernels as dk
from cpzk_tpu_torch.ops import keccak_kernels as kk, prove_kernels as pvk
from cpzk_tpu_torch.ops import backend, ladder_kernels as lk, verify
from torch_ladder_inputs import (combined_inputs, each_inputs, make_rows, partial_totals, tile,
                                 weights)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def coords(dev, n, count, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-limbs.BOUND, limbs.BOUND + 1, size=(20, n))
                             .astype(np.int32)).to(dev) for _ in range(count)]


def assert_canonical_equal(out, ref):
    for a, b in zip(out, ref):
        assert torch.equal(limbs.canonical(a), limbs.canonical(b))
        assert int(a.abs().max()) <= limbs.BOUND


@pytest.mark.parametrize("n", [1, 127, 4096])
def test_kernels_match_plain_on_card(dev, n):
    c = coords(dev, n, 8, n)
    pk.reset_launches()
    out = pk.point_add(tuple(c[:4]), tuple(c[4:]))
    ref = pk.point_add_plain(tuple(c[:4]), tuple(c[4:]))
    assert_canonical_equal(out, ref)
    out = pk.point_double_k(tuple(c[:4]), 4)
    ref = pk.point_double_k_plain(tuple(c[:4]), 4)
    torch.cuda.synchronize()
    assert_canonical_equal(out, ref)
    assert pk.LAUNCHES == {"point_add": 1, "point_double_k": 1}


def test_block_size_covers_every_sm(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (1, 127, 32 * sms, 6144, 16384, 18432, 1 << 20):
        threads = pk.block_threads(n, dev)
        assert threads % 32 == 0 and 32 <= threads <= 256
        if n >= 32 * sms:
            assert -(-n // threads) >= sms


def scalars(dev, n, seed):
    rng = random.Random(seed)
    vals = [rng.randrange(L) for _ in range(n)]
    vals[: min(n, 3)] = [0, 1, L - 1][: min(n, 3)]
    return torch.from_numpy(sc.ints_to_limbs(vals)).to(dev)


@pytest.mark.parametrize("n", [1, 127, 4096])
def test_scalar_kernels_match_plain_on_card(dev, n):
    al, cl, sl = (scalars(dev, n, n + k) for k in range(3))
    bl = scalars(dev, 1, 7 * n)
    sk.reset_launches()
    got = sk.rlc_scalars(al, cl, sl, bl)
    torch.cuda.synchronize()
    ref = sk.rlc_scalars_plain(al, cl, sl, bl)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    groups = (al, *ref[:3])
    lane = n // 2
    assert torch.equal(sk.rlc_windows(groups, ref[3], ref[4], lane),
                       sk.rlc_windows_plain(groups, ref[3], ref[4], lane))
    for c in (4, 11, 13):
        m = 4 * n + 5
        assert torch.equal(sk.rlc_digits(groups, ref[3], ref[4], n, m, c),
                           sk.rlc_digits_plain(groups, ref[3], ref[4], n, m, c))
    assert sk.LAUNCHES == {"rlc_scalars": 1, "scalar_recode": 4, "reduce_wide": 0}


@pytest.mark.parametrize("case,n", [("random", 77), ("l_minus_1", 130), ("ninth_word", 1500),
                                    ("random", 16384)])
def test_rlc_scalars_edges_on_card(dev, case, n):
    """``rlc_scalars`` exact against its plain version: 77 rows (no block
    divides them), every scalar l - 1, rows whose a s sum past 2^256 (a =
    l - 1, s = 1), and the 16,384-row check's width."""
    al, cl, sl, bl = (torch.from_numpy(sc.ints_to_limbs(v)).to(dev)
                      for v in rlc_case(np.random.default_rng(n), case, n))
    sk.reset_launches()
    got = sk.rlc_scalars(al, cl, sl, bl)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["rlc_scalars"] == 1
    assert all(torch.equal(g, r) for g, r in zip(got, sk.rlc_scalars_plain(al, cl, sl, bl)))


def msm_case(dev, m, c, seed, kind="mixed"):
    """m valid points (sums of two of 64 random points) and [K, m] digits of
    random scalars with 0, 1, l - 1; for ``mixed`` window 1 all +-2^(c-1)
    (the top bucket) and window 2 all 3 (one crowded bucket); for ``equal``
    every digit 5 (each window's terms in one bucket)."""
    rng = random.Random(seed)
    base = curve.points_to_device(
        [he.pt_scalar_mul(he.BASEPOINT, rng.randrange(L)) for _ in range(64)], dev)
    i1 = torch.tensor([rng.randrange(64) for _ in range(m)], device=dev)
    i2 = torch.tensor([rng.randrange(64) for _ in range(m)], device=dev)
    pts = pk.point_add_plain(tuple(x[:, i1] for x in base), tuple(x[:, i2] for x in base))
    vals = [rng.randrange(L) for _ in range(m - 3)] + [0, 1, L - 1]
    digits = msm.scalars_to_signed_digits(vals, c)
    half = 1 << (c - 1)
    if kind == "mixed":
        digits[1] = [half if i % 3 else -half for i in range(m)]
        digits[2] = 3
    elif kind == "equal":
        digits[:] = 5
    return pts, torch.from_numpy(digits).to(dev)


@pytest.mark.parametrize("m,c,kind", [(64, 5, "mixed"), (2048, 11, "mixed"),
                                      (16384, 11, "random"), (16384, 11, "equal"),
                                      (2048, 16, "mixed")])
def test_msm_kernels_match_plain_on_card(dev, m, c, kind):
    pts, digits = msm_case(dev, m, c, m + c, kind)
    mk.reset_launches()
    buckets = mk.msm_bucket(pts, digits, c)
    out = mk.msm_window_reduce(buckets, c)
    torch.cuda.synchronize()
    ref_buckets = msm.bucket_sums_plain(pts, digits, c)
    assert torch.equal(curve.encode(buckets), curve.encode(ref_buckets))
    assert torch.equal(curve.encode(out), curve.encode(msm.window_reduce_plain(ref_buckets, c)))
    assert mk.LAUNCHES == {"msm_bucket": 1, "msm_window_reduce": 1}
    # msm_kernel routes a CUDA tensor to the two kernels
    assert torch.equal(curve.encode(msm.msm_kernel(pts, digits, c)), curve.encode(out))
    assert mk.LAUNCHES == {"msm_bucket": 2, "msm_window_reduce": 2}


@pytest.mark.parametrize("rounds", [1, 64, 253])
def test_msm_quad_chain_matches_plain_on_card(dev, rounds):
    """The library's quad doubling chain (one warp, a quad a doubling, the
    schedule of msm_window_reduce's scale step) against the plain
    doublings, as group elements; no wrapper counts it."""
    pts, _ = msm_case(dev, 1, 11, rounds)
    words = pk.words_of_limbs(torch.stack([limbs.canonical(x)[:, 0] for x in pts]))
    words = words.reshape(-1).contiguous()
    got = torch.empty_like(words)
    mk.reset_launches()
    rc = pk.library().cpzk_msm_quad_chain(words.data_ptr(), got.data_ptr(), rounds,
                                          torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    lim = pk.limbs_of_words(got.reshape(4, 8))
    out = tuple(lim[i][:, None] for i in range(4))
    assert torch.equal(curve.encode(out), curve.encode(pk.point_double_k_plain(pts, rounds)))
    assert mk.LAUNCHES == {"msm_bucket": 0, "msm_window_reduce": 0}


@pytest.mark.parametrize("n", [1, 127, 4096])
def test_keccak_chain_matches_plain_on_card(dev, n):
    rng = np.random.default_rng(n)
    ints = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(dev)
    kk.reset_launches()
    for width, k in ((n, 3), (1, 3), (n, 1)):
        s_hi, s_lo, m_hi, m_lo = ints((25, width)), ints((25, width)), ints((k, 25, n)), \
            ints((k, 25, n))
        got = kk.keccak_chain(s_hi, s_lo, m_hi, m_lo)
        torch.cuda.synchronize()
        ref = kk.keccak_chain_plain(s_hi, s_lo, m_hi, m_lo)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert kk.LAUNCHES == {"keccak_chain": 3}


@pytest.mark.parametrize("n", [1, 17, 33, 4097])
def test_keccak_chain_edge_shapes_on_card(dev, n):
    """Row counts that leave the last pair of threads and the last warp
    partly empty, a shared and a per-row state, k = 0, 1, 3, 5: words equal
    to the plain version's, one launch a call."""
    rng = np.random.default_rng(300 + n)
    ints = lambda shape: torch.from_numpy(  # noqa: E731
        rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)).to(dev)
    kk.reset_launches()
    for width in (1, n):
        for k in (0, 1, 3, 5):
            s_hi, s_lo, m_hi, m_lo = ints((25, width)), ints((25, width)), \
                ints((k, 25, n)), ints((k, 25, n))
            got = kk.keccak_chain(s_hi, s_lo, m_hi, m_lo)
            torch.cuda.synchronize()
            ref = kk.keccak_chain_plain(s_hi, s_lo, m_hi, m_lo)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (width, k)
    assert kk.LAUNCHES == {"keccak_chain": 8}


@pytest.mark.parametrize("rows", [40, 24])
def test_reduce_wide_edges_on_card(dev, rows):
    """W = rows limbs: the edge values that fit (0, 1, l - 1, l, 2 l, 2^252,
    2^256 - 1, 2^512 - 1), the largest value W limbs hold, values of every
    bit length and random ones over 4097 lanes: limbs equal to the plain
    version's and to the value mod l, one launch."""
    rng = random.Random(400 + rows)
    top = 2 ** min(512, 13 * rows)
    values = [v for v in wide_edges() if v < top] + [top - 1]
    values += [rng.getrandbits(bits) | 1 << (bits - 1) for bits in range(1, top.bit_length())]
    values += [rng.randrange(top) for _ in range(4097 - len(values))]
    wide = torch.tensor([[(v >> (13 * i)) & 0x1FFF for v in values] for i in range(rows)],
                        dtype=torch.int32).to(dev)
    sk.reset_launches()
    got = sc.reduce_wide(wide)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.reduce_wide_plain(wide))
    assert sc.limbs_to_ints(got) == [v % L for v in values]
    assert sk.LAUNCHES["reduce_wide"] == 1


@pytest.mark.parametrize("n", [1, 127, 4096])
def test_reduce_wide_matches_plain_on_card(dev, n):
    rng = np.random.default_rng(n + 1)
    blobs = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    blobs[0] = 0xFF
    wide = torch.from_numpy(sc.bytes_wide_to_limbs(blobs)).to(dev)
    sk.reset_launches()
    got = sc.reduce_wide(wide)
    torch.cuda.synchronize()
    assert torch.equal(got, sc.reduce_wide_plain(wide))
    assert sk.LAUNCHES["reduce_wide"] == 1


def test_prover_kernels_match_plain_on_card(dev):
    from cpzk_tpu_torch import Parameters, Ristretto255, Scalar

    params = Parameters.new()
    g = curve.points_to_device([params.generator_g.point], dev)
    h = curve.points_to_device([params.generator_h.point], dev)
    pvk.reset_launches()
    tg, th = pvk.comb_tables(g), pvk.comb_tables(h)
    torch.cuda.synchronize()
    plain = pvk.comb_tables_plain(g), pvk.comb_tables_plain(h)
    for got, table in zip((tg, th), plain):
        assert torch.equal(got, pvk.table_words(table))
    rng = random.Random(5)
    for n in (1, 127, 4096):
        vals = [rng.randrange(L) for _ in range(n)]
        # 2^256 - 1: every nibble 15, the top window over two steps
        vals[: min(n, 4)] = [0, 1, L - 1, 2**256 - 1][: min(n, 4)]
        digits = torch.from_numpy(np.ascontiguousarray(
            curve.scalars_to_windows(vals)[::-1])).to(dev)
        r1, r2 = pvk.commitments(tg, th, digits)
        torch.cuda.synchronize()
        ref = pvk.commitments_plain(*plain, digits)
        assert torch.equal(r1, ref[0]) and torch.equal(r2, ref[1])
        for j in range(min(n, 4)):
            y1, y2 = Ristretto255.double_base_mul(params.generator_g, params.generator_h,
                                                  Scalar(vals[j] % L))
            assert bytes(r1[:, j].tolist()) == y1.wire() and bytes(r2[:, j].tolist()) == y2.wire()
    assert pvk.LAUNCHES == {"comb_tables": 2, "commitments": 3}
    with pytest.raises(ValueError, match="words"):
        pvk.commitments(plain[0], th, digits)
    assert pvk.LAUNCHES["commitments"] == 3


def test_ristretto_decode_matches_plain_on_card(dev):
    from cpzk_tpu_torch import Parameters
    from cpzk_tpu_torch.core import edwards

    params = Parameters.new()
    valid = [params.generator_g.wire(), params.generator_h.wire(), bytes(32)]
    special = [(edwards.P + 2).to_bytes(32, "little"), (3).to_bytes(32, "little"),
               b"\xff" * 32, edwards.P.to_bytes(32, "little")]
    rng = np.random.default_rng(11)
    for n in (1, 127, 4096):
        rows = (valid + special + [rng.bytes(32) for _ in range(n)])[:n]
        wires = torch.from_numpy(np.frombuffer(b"".join(rows), dtype=np.uint8)
                                 .reshape(n, 32).copy()).to(dev)
        dk.reset_launches()
        words, ok = dk.ristretto_decode(wires)
        torch.cuda.synchronize()
        assert dk.LAUNCHES == {"ristretto_decode": 1}
        assert words.device == dev and words.shape == (4, 8, n) and ok.shape == (n,)
        ref_words, ref_ok = dk.ristretto_decode_plain(wires)
        assert torch.equal(ok, ref_ok) and torch.equal(words, ref_words)
        for j in range(min(n, 7)):
            assert bool(ok[j]) == (j < 3)
    with pytest.raises(ValueError, match=r"\[n, 32\] uint8"):
        dk.ristretto_decode(wires.t().contiguous())
    assert dk.LAUNCHES == {"ristretto_decode": 1}


@pytest.mark.parametrize("n", [1, 31, 33, 4097])
def test_ristretto_decode_edge_widths_on_card(dev, n):
    """DECODE at lane counts that leave a block partly past n (one lane, a
    short warp, a warp and a lane, a lane past 4096): one launch, words and
    validity exact against the plain version."""
    from cpzk_tpu_torch.bench_kernels import decode_case

    wires = torch.from_numpy(decode_case(np.random.default_rng(n), n)).to(dev)
    ref_words, ref_ok = dk.ristretto_decode_plain(wires)
    dk.reset_launches()
    words, ok = dk.ristretto_decode(wires)
    torch.cuda.synchronize()
    assert dk.LAUNCHES == {"ristretto_decode": 1}
    assert torch.equal(ok, ref_ok) and torch.equal(words, ref_words)


@pytest.mark.parametrize("n", [1, 3, 5, 127, 130])
def test_scalar_recode_ragged_on_card(dev, n):
    """``scalar_recode`` at row counts that are no multiple of a thread's
    four lanes: windows at pad n + 1 (the splice in the last lane) and n +
    3, digits at m = 4 n + 2 (rows 8-byte aligned every other one) and
    4 n + 5 for c = 4, 11, 16; ``torch.equal`` to the plain versions."""
    for pad in (n + 1, n + 3):
        groups = [scalars(dev, pad, 5 * n + pad + k) for k in range(4)]
        corr = [scalars(dev, 1, 9 * n + k) for k in range(2)]
        assert torch.equal(sk.rlc_windows(groups, *corr, n),
                           sk.rlc_windows_plain(groups, *corr, n))
        for c in (4, 11, 16):
            for m in (4 * n + 2, 4 * n + 5):
                assert torch.equal(sk.rlc_digits(groups, *corr, n, m, c),
                                   sk.rlc_digits_plain(groups, *corr, n, m, c)), (pad, c, m)


def test_matmulfold_matches_schoolbook_on_card(dev, monkeypatch):
    a, b = coords(dev, 4096, 2, 12)
    a[:, 0], b[:, 0] = limbs.BOUND, -limbs.BOUND
    monkeypatch.setattr(limbs, "MUL_VARIANT", "schoolbook")
    school = limbs.mul(a, b)
    monkeypatch.setattr(limbs, "MUL_VARIANT", "matmulfold")
    assert torch.equal(limbs.mul(a, b), school)
    assert torch.equal(limbs._mul_matmulfold(a, b), limbs._raw_schoolbook(a, b, 20))


@pytest.fixture(scope="module")
def ladder_rows():
    """33 rows (a response off by one at row 5, a swapped commitment of each
    equation at rows 9 and 20) and 33 valid rows, with per-lane generators
    for the per-row check."""
    tampered = {5: "s", 9: "r1", 20: "r2"}
    return (make_rows(200, 33), make_rows(201, 33, tampered), tampered,
            make_rows(202, 33, tampered, per_lane_generators=True))


def on_card(dev, arrays, points):
    return ([tuple(torch.from_numpy(c).to(dev) for c in p) for p in arrays[:points]]
            + [torch.from_numpy(w).to(dev) for w in arrays[points:]])


@pytest.mark.parametrize("n", [1, 127, 2048, 13, 16384])
def test_ladder_each_matches_plain_on_card(dev, ladder_rows, n):
    _, bad, tampered, per_lane = ladder_rows
    for rows, shared in ((bad, True), (per_lane, False)):
        args = on_card(dev, each_inputs(tile(rows, n), n, shared), 6)
        lk.reset_launches()
        pk.reset_launches()
        bits = verify.verify_each_kernel(*args)
        torch.cuda.synchronize()
        assert lk.LAUNCHES == {"ladder_combined": 0, "ladder_partials_identity": 0,
                               "ladder_each": 1}
        assert pk.LAUNCHES == {"point_add": 0, "point_double_k": 0}
        assert bits.device == dev and bits.dtype == torch.bool and bits.shape == (n,)
        assert torch.equal(bits, verify.verify_each_kernel_plain(*args))
        assert bits.tolist() == [i % 33 not in tampered for i in range(n)]


@pytest.mark.parametrize("n", [7, 127, 6144, 2, 13, 16384])
def test_ladder_combined_matches_plain_on_card(dev, ladder_rows, n):
    good, bad, tampered, _ = ladder_rows
    # n - 1 rows of the tampered set hold a tampered one from n = 7 on
    for rows, want in ((good, True), (bad, not any(i % 33 in tampered for i in range(n - 1)))):
        rows = tile(rows, n - 1)
        alphas, beta = weights(n, n - 1)
        args = on_card(dev, combined_inputs(rows, alphas, beta, n), 4)
        lk.reset_launches()
        total, ok = lk.ladder_combined(*args)
        torch.cuda.synchronize()
        assert lk.LAUNCHES["ladder_combined"] == 1
        ref = verify.combined_partial_kernel_plain(*args)
        assert bool(curve.eq(tuple(c[:, 0] for c in total), tuple(c[:, 0] for c in ref)))
        assert bool(ok) is bool(verify.combined_kernel_plain(*args)) is want
        assert bool(verify.combined_kernel(*args)) is want


def test_ladder_chunked_check_on_card(dev, ladder_rows):
    """Three lane chunks (chunk 2048, pad 6144): three ``ladder_combined``
    launches writing their columns and one ``ladder_partials_identity``,
    no point kernel; the verdict equals the plain partials' identity test."""
    good, bad, _, _ = ladder_rows
    for rows, want in ((good, True), (bad, False)):
        rows = tile(rows, 6000)
        alphas, beta = weights(7, 6000)
        args = on_card(dev, combined_inputs(rows, alphas, beta, 6144), 4)
        lk.reset_launches()
        pk.reset_launches()
        assert backend.chunked_combined_identity(6144, 2048, *args) is want
        assert lk.LAUNCHES == {"ladder_combined": 3, "ladder_partials_identity": 1,
                               "ladder_each": 0}
        assert pk.LAUNCHES == {"point_add": 0, "point_double_k": 0}
        parts = [verify.combined_partial_kernel_plain(
            *(tuple(c[:, lo:lo + 2048] for c in p) for p in args[:4]),
            *(w[:, lo:lo + 2048] for w in args[4:])) for lo in (0, 2048, 4096)]
        stacked = tuple(torch.cat([p[k] for p in parts], dim=-1) for k in range(4))
        assert bool(verify.partials_identity_plain(stacked)) is want
        assert bool(verify.partials_identity(stacked)) is want


@pytest.mark.parametrize("valid", [True, False], ids=["valid", "tampered"])
@pytest.mark.parametrize("k", [1, 2, 3, 8, 92])
def test_ladder_partials_identity_matches_plain_on_card(dev, k, valid):
    """One ``ladder_partials_identity`` launch over k random totals (pairs P,
    -P and the identity for odd k, scaled coordinates; one replaced when
    tampered): the plain version's verdict and the expected one."""
    parts = tuple(torch.from_numpy(c).to(dev) for c in partial_totals(300 + k, k, valid))
    lk.reset_launches()
    ok = verify.partials_identity(parts)
    torch.cuda.synchronize()
    assert lk.LAUNCHES == {"ladder_combined": 0, "ladder_partials_identity": 1,
                           "ladder_each": 0}
    assert bool(ok) is bool(verify.partials_identity_plain(parts)) is valid
