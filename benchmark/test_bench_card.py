"""On the card, at sizes a test run holds: each cell's program path comes
out correct and its control (the reference bound to no context in the
program's place) does not.  Run on a machine with an NVIDIA GPU:

    python3 -m pytest benchmark -m cuda
"""

from __future__ import annotations

import pytest

from benchmark import harness

SEEDS = [3_300_000_001, 3_300_000_002, 3_300_000_003]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return harness.Bench()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_bulk_program_and_control(card, seed):
    w = card.workload("bulk_verify.valid64k")
    cfg = card.config(w["config"])
    drv = card.driver(cfg["entry"])
    opts = {"age": harness.process_age_s, "rows": 4096}
    run = drv.run(cfg, card.traffic(w["traffic"]), seed, 0.0, False, 1, opts)
    assert run["correct"], run["compared"]
    run = drv.run(cfg, card.traffic(w["traffic"]), seed, 0.0, False, 1, dict(opts, control=True))
    assert not run["correct"]
    assert run["compared"]["verdicts_mismatched"]["value"] > 0


@pytest.mark.cuda
def test_login_program_and_control(card):
    w = card.workload("batch_login.gateways")
    cfg = card.config(w["config"])
    drv = card.driver(cfg["entry"])
    opts = {"age": harness.process_age_s, "users": 4096}
    traffic = dict(card.traffic(w["traffic"]), rate=200.0)
    run = drv.run(cfg, traffic, SEEDS[0], 3.0, False, 1, opts)
    assert run["correct"], run["compared"]
    run = drv.run(cfg, traffic, SEEDS[0], 3.0, False, 1, dict(opts, control=True))
    assert not run["correct"]
    assert run["compared"]["logins_mismatched"]["value"] > 0
