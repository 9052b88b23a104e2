"""The frozen count of the combined check's work against hand counts."""

from __future__ import annotations

import math

import pytest

from benchmark.yardstick import roofline as r


def test_field_and_point_counts():
    assert r.MUL_OPS == 170          # 64 word products x 2, 16 carries, the fold's 26
    assert r.SQ_OPS == 130           # 36 products x 2, 16 doublings, 16 carries, 26
    assert r.ADD_OPS == 8 * 170 + 8 * 16 == 1488
    assert r.DBL_OPS == 4 * 130 + 3 * 170 + 6 * 16 == 1126


def test_straus_by_hand():
    # 252 shared doublings, 64 windows x 4 terms and 4 tables of 14 additions
    assert r.straus_ops(1) == 252 * 1126 + (4 * 64 + 4 * 14) * 1488 == 748_008
    assert r.straus_ops(10) == 10 * 748_008


def test_pippenger_by_hand():
    ops, c = r.pippenger_ops(65536)
    terms = 4 * 65536 + 2
    assert c == 15
    assert ops == math.ceil(254 / 15) * (terms + 2 * 2**14) * 1488 + 252 * 1126 == 7_460_428_296


@pytest.mark.parametrize("n", [1, 2, 64, 1000, 4096, 65536, 1 << 20])
def test_least_work_is_the_smaller_count(n):
    w = r.combined_work(n)
    assert w["ops"] == min(r.straus_ops(n), r.pippenger_ops(n)[0])
    assert w["bytes"] == n * 256
    assert w["least_s"] == max(w["ops"] / r.INT32_OPS_PER_S, w["bytes"] / r.HBM_BYTES_PER_S)


def test_peaks():
    assert r.INT32_OPS_PER_S == pytest.approx(132 * 64 * 1.98e9)
    assert r.combined_work(65536)["least_s"] == pytest.approx(7_460_428_296 / (132 * 64 * 1.98e9))
