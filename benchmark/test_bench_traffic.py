"""Seeded traffic: the same seed gives the same bytes, another seed other
bytes, and every seed the same amount of work."""

from __future__ import annotations

import numpy as np

from benchmark.drivers import loadgen
from benchmark.reference import proofs

SEED = 2**31 + 17


def _batch(seed, index=0):
    pop = proofs.population(seed, 4, "cpu")
    return pop, proofs.make_batch(pop, seed, index, 32, tampered_share=0.25)


def test_batches_repeat_by_seed():
    pop_a, a = _batch(SEED)
    pop_b, b = _batch(SEED)
    assert a.items == b.items and a.contexts == b.contexts and a.expected == b.expected
    assert all(np.array_equal(pop_a.wires[k], pop_b.wires[k]) for k in pop_a.wires)
    _, c = _batch(SEED + 1)
    assert not set(a.items) & set(c.items)
    assert not set(a.contexts) & set(c.contexts)


def test_batches_of_one_run_are_fresh():
    pop = proofs.population(SEED, 4, "cpu")
    a = proofs.make_batch(pop, SEED, 0, 32)
    b = proofs.make_batch(pop, SEED, 1, 32)
    assert not set(a.contexts) & set(b.contexts)
    # same statements and commitments, fresh responses
    assert [w[:77] for w in a.items] == [w[:77] for w in b.items]
    assert not {w[77:] for w in a.items} & {w[77:] for w in b.items}


def test_login_schedule_repeats_by_seed_with_fixed_work():
    a = loadgen.schedule(SEED, 800.0, 45.0, 65536, 0.01, 8)
    b = loadgen.schedule(SEED, 800.0, 45.0, 65536, 0.01, 8)
    c = loadgen.schedule(SEED + 1, 800.0, 45.0, 65536, 0.01, 8)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["due"], c["due"])
    assert len(a["due"]) == len(c["due"]) == 36000
    assert a["tampered"].sum() == c["tampered"].sum() == 360
    assert (np.diff(a["due"]) >= 0).all() and a["due"][-1] < 45.0
    # every user logs in at most once while the window has fewer logins than users
    assert len(set(a["user"].tolist())) == 36000


class _Shed:
    def __init__(self, metadata):
        self.metadata = metadata

    def trailing_metadata(self):
        return self.metadata


POLICY = {"max_attempts": 3, "initial_backoff_ms": 50.0, "max_backoff_ms": 1000.0,
          "multiplier": 2.0, "budget": 10.0, "token_ratio": 0.1}


def test_shed_challenge_waits_for_the_pushback():
    limits = loadgen.RetryLimits(POLICY, np.random.default_rng(1))
    push = loadgen.pushback_ms(_Shed((("cpzk-retry-after-ms", "250"),)))
    assert limits.wait_s("RESOURCE_EXHAUSTED", 1, push) == 0.25
    assert limits.wait_s("RESOURCE_EXHAUSTED", 1, 60_000.0) == loadgen.MAX_PUSHBACK_S
    waits = [limits.wait_s("UNAVAILABLE", k, loadgen.pushback_ms(_Shed(()))) for k in (1, 2)]
    assert 0 <= waits[0] <= 0.05 and 0 <= waits[1] <= 0.1


def test_retries_stop_at_the_attempts_the_budget_and_a_refusal():
    limits = loadgen.RetryLimits(POLICY, np.random.default_rng(2))
    assert limits.wait_s("RESOURCE_EXHAUSTED", 3, None) is None
    assert limits.wait_s("RESOURCE_EXHAUSTED", 1, -1.0) is None
    assert limits.wait_s("INVALID_ARGUMENT", 1, None) is None
    # ten tokens, one a retry; a success gives a tenth back (ten tenths sum
    # to just under one in floating point, as in the client's own budget)
    assert all(limits.wait_s("RESOURCE_EXHAUSTED", 1, None) is not None for _ in range(10))
    assert limits.wait_s("RESOURCE_EXHAUSTED", 1, None) is None
    for _ in range(11):
        limits.success()
    assert limits.wait_s("RESOURCE_EXHAUSTED", 1, None) is not None
    assert limits.wait_s("RESOURCE_EXHAUSTED", 1, None) is None
