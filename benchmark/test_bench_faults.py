"""Whole runs of each cell on the CPU at a tiny size, without the look for
a card: the program's path comes out correct, and ``correct`` comes out
false with the reference bound to no context in the program's place (the
control), with one answer altered where it is produced, with half of the
answers never given, with a program that verifies only half of each batch
and answers the rest as valid (in the whole path or in the combined check
alone), and with a pool that runs out before the window ends."""

from __future__ import annotations

import pytest

from benchmark import harness

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def bench():
    return harness.Bench()


def _bulk(bench, backend=None, seconds=0.0, traffic=None, **opts):
    from cpzk_tpu_torch.ops.backend import TorchBackend

    w = bench.workload("bulk_verify.valid64k")
    cfg = bench.config(w["config"])
    return bench.driver(cfg["entry"]).run(
        cfg, {**bench.traffic(w["traffic"]), **(traffic or {})}, SEED, seconds, False, 1,
        {"age": harness.process_age_s, "device": "cpu", "rows": 8,
         "backend": backend or TorchBackend(device="cpu"), **opts})


def _login(bench, **opts):
    w = bench.workload("batch_login.gateways")
    cfg = bench.config(w["config"])
    return bench.driver(cfg["entry"]).run(
        cfg, dict(bench.traffic(w["traffic"]), rate=25.0), SEED, 2.0, True, 1,
        {"age": harness.process_age_s, "device": "cpu", "backend": "cpu", "users": 128, **opts})


CASES = [({}, True), ({"control": True}, False), ({"fault": "flip"}, False),
         ({"fault": "half"}, False)]


@pytest.mark.parametrize("opts,correct", CASES, ids=["program", "control", "flip", "half"])
def test_bulk_cell(bench, opts, correct):
    run = _bulk(bench, **opts)
    assert run["correct"] is correct, run["compared"]
    assert all(c["ok"] for c in run["compared"].values()) is correct


def _half_verify(monkeypatch):
    """``BatchVerifier.verify`` checks the first half of its entries and
    answers the rest as valid."""
    from cpzk_tpu_torch.protocol.batch import BatchVerifier

    verify = BatchVerifier.verify

    def half(self, rng, stages=None):
        rest = len(self.entries) - len(self.entries) // 2
        self.entries = self.entries[:len(self.entries) // 2]
        return verify(self, rng, stages) + [None] * rest

    monkeypatch.setattr(BatchVerifier, "verify", half)


def _half_combined_backend():
    """A backend whose combined check sums only the first half of the rows
    (the per-row fallback stays whole)."""
    from cpzk_tpu_torch.ops.backend import TorchBackend

    class HalfCombined(TorchBackend):
        def verify_combined(self, rows, beta):
            return super().verify_combined(rows[:len(rows) // 2], beta)

    return HalfCombined(device="cpu")


@pytest.mark.parametrize("where", ["whole_path", "combined_check"])
def test_bulk_cell_half_verified(bench, monkeypatch, where):
    if where == "whole_path":
        _half_verify(monkeypatch)
        run = _bulk(bench)
    else:
        run = _bulk(bench, backend=_half_combined_backend())
    assert run["correct"] is False
    assert run["compared"]["check_batch_mismatched"]["value"] > 0
    # the window's batches are all valid: only the check batches see it
    assert run["compared"]["verdicts_mismatched"]["value"] == 0


def test_bulk_cell_pool_run_out(bench):
    run = _bulk(bench, seconds=60.0, traffic={"rate_ceiling": 1e-9})
    assert run["notes"]["pool_batches"] == 2
    assert run["correct"] is False
    assert run["compared"]["window_s"]["ok"] is False


@pytest.mark.parametrize("opts,correct", CASES, ids=["program", "control", "flip", "half"])
def test_login_cell(bench, opts, correct):
    run = _login(bench, **opts)
    assert run["correct"] is correct, run["compared"]
    run = dict(run, device={"platform": "gpu", **run["device"]})
    e2e = harness.result_line(bench, "batch_login.gateways", False, run)["metrics"]
    layers = harness.result_line(bench, "batch_login.gateways", True, run)["metrics"]
    if correct:
        assert e2e["logins_per_s"]["value"] == pytest.approx(25.0)
        assert layers["login_p95_ms.daemon"]["value"] > 0
