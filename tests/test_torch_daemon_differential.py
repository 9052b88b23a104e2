"""A differential of the two daemons: ``cpzk_tpu``'s and
``cpzk_tpu_torch``'s, each booted through its own ``amain`` in its own
subprocess on an ephemeral port, answer the same seeded login scenario
with equal responses, error codes and messages (random tokens and
challenge ids compared by shape, ``tests/torch_grpc_twins.py``), shut down
on SIGTERM with exit 0 and a snapshot, and each restores the snapshot the
other wrote.

Both daemons read one TOML.  In the first case both verify on the host
(``backend = "cpu"``); in the second the port serves ``backend = "tpu"``,
its card path, on the CUDA kernels' plain versions, against the
reference's host path.  ``[admission] enabled = false`` in the shared file
keeps the reference's default admission controller out, as the port has
none yet.
"""

import asyncio
import re

import pytest

import cpzk_tpu as J
from cpzk_tpu.client import AuthClient
from torch_daemon_harness import Daemon
from torch_grpc_twins import SIDES, Twin, assert_twins_agree

SEED = 1017

BAD_POINT = b"\xff" * 32


def _toml(state_file) -> str:
    return (
        f'state_file = "{state_file}"\n'
        "[rate_limit]\nrequests_per_minute = 1000000\nburst = 100000\n"
        "[admission]\nenabled = false\n"
        '[tpu]\nbackend = "cpu"\nbatch_max = 64\nbatch_window_ms = 20.0\n'
    )


async def login_scenario(twin: Twin) -> None:
    """Registration, challenges, single and batch logins with every kind
    of failure the service reports, replays and health."""
    eb = J.Ristretto255.element_to_bytes
    users = []
    for i in range(3):
        prover, resp = await twin.register(f"alice{i}")
        twin.note(resp)
        users.append((f"alice{i}", prover))
    _, dup = await twin.register("alice0")
    twin.note(dup)
    twin.note(await twin.call(twin.client.register("bad user!", b"x" * 32, b"y" * 32)))
    p = twin.prover()
    twin.note(await twin.call(twin.client.register(
        "pointless", BAD_POINT, eb(p.statement.y2))))
    batch_provers = [twin.prover() for _ in range(3)]
    twin.note(await twin.call(twin.client.register_batch(
        ["bob0", "bob1", "alice1"],
        [eb(q.statement.y1) for q in batch_provers],
        [eb(q.statement.y2) for q in batch_provers])))
    users += [("bob0", batch_provers[0]), ("bob1", batch_provers[1])]

    twin.note(await twin.call(twin.client.create_challenge("nobody")))
    # a single login, then its replay, then a wrong context
    cid, proof = (await twin.challenge_and_prove(users[:1]))[1:]
    ok = await twin.call(twin.client.verify_proof("alice0", cid[0], proof[0]))
    twin.note(ok)
    twin.note(await twin.call(twin.client.verify_proof("alice0", cid[0], proof[0])))
    ids, cids, proofs = await twin.challenge_and_prove(users[1:2], wrong_context_for=(0,))
    twin.note(await twin.call(twin.client.verify_proof(ids[0], cids[0], proofs[0])))

    # a batch: valid, wrong context, truncated, empty, undecodable point
    ids, cids, proofs = await twin.challenge_and_prove(users, wrong_context_for=(1,))
    proofs[2] = proofs[2][:50]
    proofs[3] = b""
    proofs[4] = proofs[4][:5] + BAD_POINT + proofs[4][37:]
    twin.note(await twin.call(twin.client.verify_proof_batch(ids, cids, proofs)))
    twin.note(await twin.call(twin.client.verify_proof_batch(ids, cids, proofs)))  # replay
    twin.note(await twin.call(twin.client.verify_proof_batch(
        ["ghost"], [cids[0]], [proofs[0]])))
    twin.note(await twin.call(twin.client.verify_proof_batch([], [], [])))
    # a clean batch whose sessions land in the snapshot
    ids, cids, proofs = await twin.challenge_and_prove(users)
    twin.note(await twin.call(twin.client.verify_proof_batch(ids, cids, proofs)))
    twin.note(await twin.call(twin.client.health_check()))
    twin.users = users


async def restored_login(twin: Twin, users) -> None:
    """After a restore: the restored users log in, unknown ones do not."""
    ids, cids, proofs = await twin.challenge_and_prove(users)
    twin.note(await twin.call(twin.client.verify_proof_batch(ids, cids, proofs)))
    twin.note(await twin.call(twin.client.create_challenge("pointless")))


def _drive(daemon: Daemon, twin: Twin, body, *args) -> None:
    async def main():
        twin.client = AuthClient(f"127.0.0.1:{daemon.port}")
        try:
            await asyncio.wait_for(body(twin, *args), 120)
        finally:
            await twin.client.close()

    asyncio.run(main())


@pytest.mark.parametrize("port_backend", ["cpu", "tpu"])
def test_daemons_answer_alike_and_restore_each_others_snapshots(tmp_path, port_backend):
    twins, snapshots = {}, {}
    for side in SIDES:
        state_file = tmp_path / f"{side}.json"
        argv = ("--backend", port_backend) if side == "port" else ()
        daemon = Daemon(side, tmp_path / side, _toml(state_file), argv=argv)
        try:
            daemon.wait_listening()
            twin = Twin(side, SEED)
            _drive(daemon, twin, login_scenario)
        finally:
            rc = daemon.terminate()
        assert rc == 0, daemon.logs()[-3000:]
        assert state_file.exists(), daemon.logs()[-3000:]
        twins[side], snapshots[side] = twin, state_file
    assert_twins_agree(twins)

    # each side boots on the other's snapshot and logs its users in
    restored, restored_counts = {}, {}
    for side, other in (("reference", "port"), ("port", "reference")):
        argv = ("--backend", port_backend) if side == "port" else ()
        daemon = Daemon(side, tmp_path / f"{side}-restored", _toml(snapshots[other]),
                        argv=argv)
        try:
            daemon.wait_listening()
            counts = re.search(r"restored state snapshot: (\d+) users, (\d+) sessions",
                               daemon.logs())
            assert counts, daemon.logs()[-3000:]
            restored_counts[side] = counts.groups()
            twin = twins[side]
            twin.log = []
            _drive(daemon, twin, restored_login, twins[other].users)
        finally:
            assert daemon.terminate() == 0, daemon.logs()[-3000:]
        restored[side] = twin
    log = assert_twins_agree(restored)
    assert log[0][0] == "BatchVerificationResponse"
    assert restored_counts["reference"] == restored_counts["port"] == ("5", "7")
