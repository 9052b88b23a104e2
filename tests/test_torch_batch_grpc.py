"""The port's batch RPCs: twins of ``tests/test_batch_grpc.py`` (all nine:
multi-valid, mixed validity, malformed batches, a single proof, batch
registration with duplicates, challenges consumed even on failure,
duplicate challenge ids where the first wins, the session cap enforced mid
batch, and a 100-user batch).

Each case runs one seeded scenario against the reference's server and the
port's (``tests/torch_grpc_twins.py``), both driven by the reference's
``AuthClient``, and requires every response to agree exactly (success
flags, messages, status codes, details, trailers, token shapes), plus the
state counts the reference test reads.  No case of the reference file
waits.
"""

import pytest

from torch_grpc_twins import serving, twin_check


async def all_valid(t):
    users = await t.register_users(5, "bv")
    t.note(await t.client.verify_proof_batch(*await t.challenge_and_prove(users)))


async def mixed_validity(t):
    users = await t.register_users(6, "mx")
    batch = await t.challenge_and_prove(users, wrong_context_for={1, 4})
    t.note(await t.client.verify_proof_batch(*batch))


async def rejects_malformed(t):
    c = t.client
    t.note(await t.call(c.verify_proof_batch([], [], [])))
    t.note(await t.call(c.verify_proof_batch(["a"], [], [])))
    t.note(await t.call(c.verify_proof_batch(["u"] * 1001, [b"c"] * 1001, [b"p"] * 1001)))


async def single_proof(t):
    users = await t.register_users(1, "solo")
    t.note(await t.client.verify_proof_batch(*await t.challenge_and_prove(users)))


async def registration_with_duplicates(t):
    from cpzk_tpu.core.ristretto import Ristretto255

    eb = Ristretto255.element_to_bytes
    provers = [t.prover() for _ in range(3)]
    y1s = [eb(p.statement.y1) for p in provers]
    y2s = [eb(p.statement.y2) for p in provers]
    t.note(await t.client.register_batch(["br0", "br1", "br0"], y1s, y2s))
    # bad element bytes: per-item failures, the batch still succeeds
    t.note(await t.client.register_batch(
        ["br2", "br3"], [b"\x00" * 32, y1s[0]], [y2s[0], b"garbage" + b"\x00" * 25]))


async def challenge_consumed_even_on_failure(t):
    users = await t.register_users(2, "cc")
    batch = await t.challenge_and_prove(users, wrong_context_for={0})
    t.note(await t.client.verify_proof_batch(*batch))
    t.note(("challenges", await t.state.challenge_count()))


async def duplicate_challenge_id_first_wins(t):
    users = await t.register_users(1, "dup")
    ids, cids, proofs = await t.challenge_and_prove(users)
    t.note(await t.client.verify_proof_batch(ids * 2, cids * 2, proofs * 2))
    t.note(("challenges", await t.state.challenge_count()))


async def session_cap_enforced_mid_batch(t):
    cap = t.pkg.state_mod.MAX_SESSIONS_PER_USER
    t.note(("cap", cap))
    users = await t.register_users(2, "cap")
    for _ in range(cap):  # fill cap0's sessions through repeated logins
        t.note(await t.client.verify_proof_batch(*await t.challenge_and_prove(users[:1])))
    # both users in one batch: cap0 verifies but cannot mint a session
    t.note(await t.client.verify_proof_batch(*await t.challenge_and_prove(users)))


async def large_batch_100_users(t):
    users = await t.register_batch([f"big{i}" for i in range(100)])
    resp = await t.client.verify_proof_batch(*await t.challenge_and_prove(users))
    t.note(resp, ("distinct tokens", len({r.session_token for r in resp.results})))


def _fields(o):
    return dict(o[1])


def _results(o):
    return [_fields(r) for r in _fields(o)["results"]]


EXPECTED = {
    all_valid: lambda obs: all(r["success"] and r["session_token"] for r in _results(obs[0])),
    mixed_validity: lambda obs: (
        [r.get("success", False) for r in _results(obs[0])] == [True, False, True, True, False, True]
        and _results(obs[0])[1]["message"] == "Authentication failed"),
    rejects_malformed: lambda obs: (
        obs[0][:3] == ("error", "INVALID_ARGUMENT", "Empty batch")
        and "Mismatched array lengths" in obs[1][2]
        and "maximum limit of 1000" in obs[2][2]),
    single_proof: lambda obs: [r.get("success") for r in _results(obs[0])] == [True],
    registration_with_duplicates: lambda obs: (
        [r.get("success", False) for r in _results(obs[0])] == [True, True, False]
        and "already registered" in _results(obs[0])[2]["message"]
        and [r.get("success", False) for r in _results(obs[1])] == [False, False]),
    challenge_consumed_even_on_failure: lambda obs: (
        [r.get("success", False) for r in _results(obs[0])] == [False, True]
        and obs[1] == ("challenges", 0)),
    duplicate_challenge_id_first_wins: lambda obs: (
        [r.get("success", False) for r in _results(obs[0])] == [True, False]
        and "Authentication failed" in _results(obs[0])[1]["message"]
        and obs[1] == ("challenges", 0)),
    session_cap_enforced_mid_batch: lambda obs: (
        all(_results(o)[0]["success"] for o in obs[1:-1])
        and not _results(obs[-1])[0].get("success", False)
        and "session" in _results(obs[-1])[0]["message"].lower()
        and _results(obs[-1])[1]["success"] and _results(obs[-1])[1]["session_token"]),
    large_batch_100_users: lambda obs: (
        len(_results(obs[0])) == 100 and all(r["success"] for r in _results(obs[0]))
        and obs[1] == ("distinct tokens", 100)),
}


@pytest.mark.parametrize("scenario", list(EXPECTED), ids=lambda f: f.__name__)
def test_batch_grpc_twin(scenario):
    obs = twin_check(serving(scenario), seed=23)
    assert EXPECTED[scenario](obs), obs
