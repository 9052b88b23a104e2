"""The port's gRPC service end to end: twins of ``tests/test_integration.py``
(register -> challenge -> prove -> verify -> session, duplicate
registration, single-use challenges, a wrong password, the per-user
challenge cap, the health endpoint).

Each case runs the same seeded scenario against the reference's server and
the port's (``tests/torch_grpc_twins.py``), both driven by the reference's
``AuthClient``, and requires every response to agree: success flags,
messages, gRPC status codes and details, trailers, and session tokens of
the same form.  Tolerance: exact.  No case of the reference file waits.
"""

import pytest

from torch_grpc_twins import serving, twin_check


async def full_auth_flow(t):
    prover, resp = await t.register("alice")
    t.note(resp)
    ch = await t.client.create_challenge("alice")
    t.note(ch)
    v = await t.call(t.client.verify_proof(
        "alice", bytes(ch.challenge_id), t.prove(prover, bytes(ch.challenge_id))))
    t.note(v)


async def duplicate_registration(t):
    prover, resp = await t.register("bob")
    t.note(resp)
    _, again = await t.register("bob", prover)
    t.note(again)


async def challenge_single_use(t):
    (user, prover), = await t.register_users(1, "carol")
    ids, cids, proofs = await t.challenge_and_prove([(user, prover)])
    t.note(await t.call(t.client.verify_proof(user, cids[0], proofs[0])))
    # replay: the challenge is consumed, PERMISSION_DENIED, opaque message
    t.note(await t.call(t.client.verify_proof(user, cids[0], proofs[0])))


async def wrong_password_rejected(t):
    (user, _right), = await t.register_users(1, "dave")
    wrong = t.prover()
    ch = await t.client.create_challenge(user)
    cid = bytes(ch.challenge_id)
    t.note(await t.call(t.client.verify_proof(user, cid, t.prove(wrong, cid))))


async def max_three_challenges(t):
    await t.register_users(1, "erin")
    for _ in range(4):
        t.note(await t.call(t.client.create_challenge("erin0")))


async def health_endpoint(t):
    t.note(await t.client.health_check())
    t.server.health.serving = False
    t.note(await t.client.health_check())


EXPECTED = {
    full_auth_flow: lambda obs: (
        obs[0][1] == (("success", True), ("message", "User 'alice' registered successfully"))
        and obs[2][0] == "VerificationResponse"
        and dict(obs[2][1])["success"] is True
        and dict(obs[2][1])["session_token"][1] == 64),
    duplicate_registration: lambda obs: (
        obs[1][:2] == ("error", "ALREADY_EXISTS")
        and obs[1][2] == "Registration failed: User 'bob' already registered"),
    challenge_single_use: lambda obs: (
        dict(obs[0][1])["success"] is True
        and obs[1] == ("error", "PERMISSION_DENIED", "Authentication failed", ())),
    wrong_password_rejected: lambda obs: obs[0][:2] == ("error", "PERMISSION_DENIED"),
    max_three_challenges: lambda obs: (
        all(o[0] == "ChallengeResponse" for o in obs[:3])
        and obs[3][:2] == ("error", "RESOURCE_EXHAUSTED")
        and obs[3][3] == (("cpzk-retry-after-ms", "50"),)),
    health_endpoint: lambda obs: [dict(o[1]).get("status") for o in obs] == [1, 2],
}


@pytest.mark.parametrize("scenario", list(EXPECTED), ids=lambda f: f.__name__)
def test_integration_twin(scenario):
    obs = twin_check(serving(scenario), seed=11)
    assert EXPECTED[scenario](obs), obs
