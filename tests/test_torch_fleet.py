"""Twins of ``tests/test_fleet.py`` for the port's fleet layer
(``cpzk_tpu_torch/fleet/``): the partition map, server-side ownership
enforcement and its redirect trailers, client-side routing, the
crash-resumable split at every ``SPLIT_CRASH_POINTS`` stage, proof-log
rotation and shipping, the three-partition chaos acceptance, the
``[fleet]`` config surface and the standby addresses of the v2 map, class
by class under the reference's names.

Each case runs one scenario on the reference package and then on the
port (``torch_repl_twins.twin``), on seeded statements, and requires
equal notes; the reference test's assertions hold inside the scenario on
both sides.  The port's audit replays run ``backend="cpu"`` (its default
is the card).

Beyond the twins: a split by either package's CLI (``python -m
cpzk_tpu_torch.fleet split`` against ``python -m cpzk_tpu.fleet split``)
on the same partition files gives the same map bytes and moves the same
users, and the port's ``init``/``set-standby``/``route``/``show`` answer
as the reference's.
"""

import asyncio
import dataclasses
import json
import os
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import urllib.error
import urllib.request
import zlib

import grpc
import pytest

from torch_repl_twins import BOTH, PORT, REF, Statements, run, twin, wait_for

ROOT = pathlib.Path(__file__).resolve().parent.parent


def uid_on_partition(pmap, index: int, tag: str = "u") -> str:
    i = 0
    while True:
        uid = f"{tag}{i}"
        if pmap.partition_for(uid).index == index:
            return uid
        i += 1


def audit_mods(pkg):
    """(log module, run_audit on the host) of ``pkg``'s audit trail."""
    if pkg is PORT:
        from cpzk_tpu_torch.audit import log
        from cpzk_tpu_torch.audit.pipeline import run_audit

        return log, lambda *a, **kw: run_audit(*a, backend="cpu", **kw)
    from cpzk_tpu.audit import log
    from cpzk_tpu.audit.pipeline import run_audit

    return log, run_audit


# --- the partition map ------------------------------------------------------------


MALFORMED = [
    ("schema", lambda d: d.update(schema="nope"), "schema"),
    ("version", lambda d: d.update(version=0), "version"),
    ("address", lambda d: d["partitions"][0].update(address=""), "address"),
    ("range", lambda d: d["partitions"][0]["ranges"][0].__setitem__(1, 99), "overlap|gap"),
    ("pop", lambda d: d["partitions"].pop(), "gap|indexes"),
    ("index", lambda d: d["partitions"][0].update(index=5), "indexes"),
    ("digest", lambda d: d.update(digest="0" * 64), "digest"),
    ("list", lambda d: d.update(partitions="zzz"), "list"),
]


class TestPartitionMap:
    def test_uniform_routing_is_total_and_stable(self, tmp_path):
        def scenario(pkg, _):
            pmap = pkg.PartitionMap.uniform(["a:1", "b:2", "c:3"])
            out = [pmap.version]
            for uid in ["alice", "", "猫" * 40, "x" * 300, "u-1.2_3", "\x00"]:
                p = pmap.partition_for(uid)
                assert p.covers(pkg.user_hash(uid))
                assert sum(q.covers(pkg.user_hash(uid)) for q in pmap.partitions) == 1
                out.append(p.index)
            assert pkg.user_hash("alice") == zlib.crc32(b"alice")
            return out

        twin(scenario, tmp_path)

    def test_ranges_are_disjoint_and_exhaustive(self, tmp_path):
        def scenario(pkg, _):
            pmap = pkg.PartitionMap.uniform([f"h:{i}" for i in range(7)])
            spans = sorted((lo, hi) for p in pmap.partitions for lo, hi in p.ranges)
            cursor = 0
            for lo, hi in spans:
                assert lo == cursor
                cursor = hi
            assert cursor == 1 << 32
            return spans

        twin(scenario, tmp_path)

    @pytest.mark.parametrize("name,mutate,match", MALFORMED, ids=[m[0] for m in MALFORMED])
    def test_from_doc_rejects_malformed(self, tmp_path, name, mutate, match):
        def scenario(pkg, _):
            doc = pkg.PartitionMap.uniform(["a:1", "b:2"]).to_doc()
            had_digest = doc.pop("digest")
            mutate(doc)
            if "digest" not in doc:
                doc.pop("digest", None)
            with pytest.raises(ValueError, match=match) as exc:
                pkg.PartitionMap.from_doc(doc)
            good = pkg.PartitionMap.uniform(["a:1", "b:2"]).to_doc()
            assert pkg.PartitionMap.from_doc(good).digest == had_digest
            return str(exc.value)

        twin(scenario, tmp_path)

    def test_split_bumps_version_moves_upper_half(self, tmp_path):
        def scenario(pkg, _):
            pmap = pkg.PartitionMap.uniform(["a:1", "b:2", "c:3"])
            new_map, moved = pmap.split(1, "d:4")
            assert new_map.version == pmap.version + 1 and len(new_map.partitions) == 4
            assert new_map.partitions[3].address == "d:4"
            assert new_map.partitions[3].ranges == moved
            n_moved = 0
            for i in range(500):
                uid = f"u{i}"
                before = pmap.partition_for(uid).index
                after = new_map.partition_for(uid).index
                if before != after:
                    assert (before, after) == (1, 3)
                    assert any(lo <= pkg.user_hash(uid) < hi for lo, hi in moved)
                    n_moved += 1
            return [list(r) for r in moved], n_moved, new_map.to_json()

        twin(scenario, tmp_path)

    def test_store_load_roundtrip_and_digest(self, tmp_path):
        def scenario(pkg, workdir):
            pmap, _ = pkg.PartitionMap.uniform(["a:1", "b:2"]).split(0, "c:3")
            path = str(workdir / "map.json")
            pmap.store(path)
            loaded = pkg.PartitionMap.load(path)
            assert loaded.version == pmap.version == 2
            assert loaded.digest == pmap.digest and loaded.to_json() == pmap.to_json()
            assert loaded.index_of_address("c:3") == 2
            with pytest.raises(ValueError, match="not in the partition map"):
                loaded.index_of_address("nope:9")
            return (workdir / "map.json").read_bytes()

        twin(scenario, tmp_path)

    def test_router_n1_fast_path_never_hashes(self, monkeypatch):
        for pkg in BOTH:
            router = pkg.FleetRouter(pkg.PartitionMap.uniform(["only:1"]), 0)

            def boom(_uid):  # pragma: no cover - the point is it never runs
                raise AssertionError("N=1 owns() computed a hash")

            monkeypatch.setattr(f"{pkg.top.__name__}.fleet.partition_map.user_hash", boom)
            assert router.owns("anything") is True
            assert router.owns("") is True

    def test_router_reload_adopts_strictly_newer(self, tmp_path):
        def scenario(pkg, workdir):
            path = str(workdir / "map.json")
            v1 = pkg.PartitionMap.uniform(["a:1", "b:2"])
            v1.store(path)
            router = pkg.FleetRouter(v1, 0, map_path=path)
            out = [router.reload()]
            v2, _ = v1.split(1, "c:3")
            v2.store(path)
            out += [router.reload(), router.map.version, router.status()]
            return out

        notes = twin(scenario, tmp_path)
        assert notes[:3] == [False, True, 2] and notes[3]["map_version"] == 2


# --- server-side enforcement over real gRPC ---------------------------------------


async def two_partition_fleet(pkg):
    """Two plain servers + a v1 map over their real ports; routers
    installed on both.  Returns (pmap, states, servers, ports)."""
    states = [pkg.ServerState(), pkg.ServerState()]
    srv0, p0 = await pkg.serve(states[0], pkg.RateLimiter(10**6, 10**6), port=0)
    srv1, p1 = await pkg.serve(states[1], pkg.RateLimiter(10**6, 10**6), port=0)
    pmap = pkg.PartitionMap.uniform([f"127.0.0.1:{p0}", f"127.0.0.1:{p1}"])
    srv0.auth_service.fleet = pkg.FleetRouter(pmap, 0)
    srv1.auth_service.fleet = pkg.FleetRouter(pmap, 1)
    return pmap, states, (srv0, srv1), (p0, p1)


def redirect_of(err, ports) -> tuple:
    """An error's code, details and trailers with the ephemeral ports
    named by their partition."""
    def named(text):
        for i, port in enumerate(ports):
            text = text.replace(f"127.0.0.1:{port}", f"P{i}")
        return text

    tmd = {k: named(v) for k, v in err.trailing_metadata() or ()}
    return err.code().name, named(err.details()), tmd


class TestEnforcement:
    def test_wrong_partition_redirect_trailers(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            u1 = uid_on_partition(pmap, 1)
            before = pkg.metrics.read("fleet.redirects")
            try:
                c = pkg.AuthClient(partition_map=pmap)
                assert "Registered" in await pkg.do_register(c, u1, "pw")
                assert "Login OK" in await pkg.do_login(c, u1, "pw")
                assert u1 in states[1]._users and u1 not in states[0]._users
                notes = [c.redirects]
                await c.close()
                c2 = pkg.AuthClient(f"127.0.0.1:{ports[0]}")
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c2.create_challenge(u1)
                notes.append(redirect_of(exc.value, ports))
                await c2.close()
                assert pkg.metrics.read("fleet.redirects") >= before + 1
                notes.append(servers[0].auth_service.fleet.redirects >= 1)
                return notes
            finally:
                for s in servers:
                    await s.stop(None)

        notes = twin(scenario, tmp_path)
        code, details, tmd = notes[1]
        assert notes[0] == 0 and code == "FAILED_PRECONDITION" and "partition 1" in details
        assert tmd == {"cpzk-partition-map-version": "1", "cpzk-partition-owner": "P1"}

    def test_write_time_fence_answers_the_redirect_contract(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            u0 = uid_on_partition(pmap, 0)
            states[0].attach_owner_fence(
                lambda uid: f"wrong partition: user '{uid}' moved" if uid == u0 else None)
            try:
                stmt = Statements(pkg, 60)()
                eb = pkg.Ristretto255.element_to_bytes
                c = pkg.AuthClient(f"127.0.0.1:{ports[0]}")
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c.register(u0, eb(stmt.y1), eb(stmt.y2))
                await c.close()
                return [redirect_of(exc.value, ports), u0 in states[0]._users]
            finally:
                for s in servers:
                    await s.stop(None)

        notes = twin(scenario, tmp_path)
        assert notes[0][0] == "FAILED_PRECONDITION" and "wrong partition" in notes[0][1]
        assert notes[0][2] == {"cpzk-partition-map-version": "1", "cpzk-partition-owner": "P0"}
        assert notes[1] is False

    def test_verify_proof_redirect_never_consumes_challenge(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            u1 = uid_on_partition(pmap, 1)
            try:
                prover = pkg.Prover(pkg.Parameters.new(),
                                    pkg.Witness(pkg.password_to_scalar("pw", u1)))
                eb = pkg.Ristretto255.element_to_bytes
                owner = pkg.AuthClient(f"127.0.0.1:{ports[1]}")
                await owner.register(u1, eb(prover.statement.y1), eb(prover.statement.y2))
                ch = await owner.create_challenge(u1)
                cid = bytes(ch.challenge_id)
                t = pkg.Transcript()
                t.append_context(cid)
                wire = prover.prove_with_transcript(pkg.SecureRng(), t).to_bytes()
                wrong = pkg.AuthClient(f"127.0.0.1:{ports[0]}")
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await wrong.verify_proof(u1, cid, wire)
                await wrong.close()
                resp = await owner.verify_proof(u1, cid, wire)
                await owner.close()
                return [exc.value.code().name, resp.success]
            finally:
                for s in servers:
                    await s.stop(None)

        assert twin(scenario, tmp_path) == ["FAILED_PRECONDITION", True]

    def test_batch_and_stream_answer_misrouted_entries_individually(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            u0 = uid_on_partition(pmap, 0)
            u1 = uid_on_partition(pmap, 1)
            try:
                eb = pkg.Ristretto255.element_to_bytes
                params = pkg.Parameters.new()
                pr0 = pkg.Prover(params, pkg.Witness(pkg.password_to_scalar("p0", u0)))
                pr1 = pkg.Prover(params, pkg.Witness(pkg.password_to_scalar("p1", u1)))
                c0 = pkg.AuthClient(f"127.0.0.1:{ports[0]}")
                resp = await c0.register_batch(
                    [u0, u1], [eb(pr0.statement.y1), eb(pr1.statement.y1)],
                    [eb(pr0.statement.y2), eb(pr1.statement.y2)])
                notes = [[(r.success, re.sub(r"127\.0\.0\.1:\d+", "P", r.message))
                          for r in resp.results], u1 in states[0]._users]
                ch = await c0.create_challenge(u0)
                cid = bytes(ch.challenge_id)
                t = pkg.Transcript()
                t.append_context(cid)
                wire = pr0.prove_with_transcript(pkg.SecureRng(), t).to_bytes()
                verdicts = []
                async for v in c0.verify_proof_stream([(u0, cid, wire),
                                                       (u1, b"\x01" * 32, wire)]):
                    verdicts.append((v.ok, re.sub(r"127\.0\.0\.1:\d+", "P", v.message)))
                notes.append(verdicts)
                await c0.close()
                return notes
            finally:
                for s in servers:
                    await s.stop(None)

        notes = twin(scenario, tmp_path)
        assert notes[0][0][0] and not notes[0][1][0] and "wrong partition" in notes[0][1][1]
        assert notes[2][0][0] and not notes[2][1][0] and "wrong partition" in notes[2][1][1]

    def test_standby_refusal_counts_admission_shed(self, tmp_path):
        async def scenario(pkg, workdir):
            sstate = pkg.ServerState()
            smgr = pkg.DurabilityManager(sstate, pkg.DurabilitySettings(enabled=True),
                                         str(workdir / "s.json"))
            await smgr.recover()
            replica = pkg.StandbyReplica(sstate, smgr, pkg.ReplicationSettings(
                enabled=True, role="standby", lease_ms=5000, renew_interval_ms=100))
            sserver, sport = await pkg.serve(sstate, pkg.RateLimiter(10**6, 10**6), port=0,
                                             replica=replica)
            before = pkg.metrics.read("admission.shed.standby")
            try:
                async with pkg.AuthClient(f"127.0.0.1:{sport}") as c:
                    with pytest.raises(grpc.aio.AioRpcError) as exc:
                        await c.create_challenge("alice")
                return [exc.value.code().name,
                        pkg.metrics.read("admission.shed.standby") - before]
            finally:
                await replica.stop()
                await sserver.stop(None)

        assert twin(scenario, tmp_path) == ["UNAVAILABLE", 1.0]


# --- client-side routing ----------------------------------------------------------


class TestClientRouting:
    def test_batch_fanout_preserves_entry_order(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            try:
                users = [f"bu{i}" for i in range(8)]
                params = pkg.Parameters.new()
                provers = {u: pkg.Prover(params, pkg.Witness(pkg.password_to_scalar("pw", u)))
                           for u in users}
                eb = pkg.Ristretto255.element_to_bytes
                c = pkg.AuthClient(partition_map=pmap)
                resp = await c.register_batch(
                    users, [eb(provers[u].statement.y1) for u in users],
                    [eb(provers[u].statement.y2) for u in users])
                assert all(r.success for r in resp.results)
                placed = []
                for u in users:
                    idx = pmap.partition_for(u).index
                    assert u in states[idx]._users and u not in states[1 - idx]._users
                    placed.append(idx)
                cids, wires = [], []
                for u in users:
                    cid = bytes((await c.create_challenge(u)).challenge_id)
                    t = pkg.Transcript()
                    t.append_context(cid)
                    cids.append(cid)
                    wires.append(provers[u].prove_with_transcript(pkg.SecureRng(), t).to_bytes())
                vresp = await c.verify_proof_batch(users, cids, wires)
                await c.close()
                return [placed, [r.success for r in vresp.results],
                        [len(r.session_token) for r in vresp.results]]
            finally:
                for s in servers:
                    await s.stop(None)

        notes = twin(scenario, tmp_path)
        assert notes[1] == [True] * 8

    def test_stale_map_client_converges_in_one_redirect(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            u1 = uid_on_partition(pmap, 1)
            refreshes = []
            try:
                c = pkg.AuthClient(partition_map=pmap)
                assert "Registered" in await pkg.do_register(c, u1, "pw")
                await c.close()
                stale = pkg.PartitionMap.uniform([f"127.0.0.1:{ports[0]}"])

                def refresh():
                    refreshes.append(1)
                    return pkg.PartitionMap.from_doc(pmap.to_doc())

                c2 = pkg.AuthClient(partition_map=stale, map_refresh=refresh)
                out = await pkg.do_login(c2, u1, "pw")
                notes = ["Login OK" in out, c2.redirects, len(refreshes)]
                await c2.close()
                return notes
            finally:
                for s in servers:
                    await s.stop(None)

        notes = twin(scenario, tmp_path)
        assert notes[0] and notes[1] <= 2 and notes[2] >= 1

    def test_redirect_charges_the_retry_budget(self, tmp_path):
        async def scenario(pkg, _):
            pmap, states, servers, ports = await two_partition_fleet(pkg)
            u1 = uid_on_partition(pmap, 1)
            try:
                stale = pkg.PartitionMap.uniform([f"127.0.0.1:{ports[0]}"])
                policy = pkg.RetryPolicy(budget=pkg.RetryBudget(tokens=10.0))
                c = pkg.AuthClient(partition_map=stale, retry=policy)
                before = policy.budget.tokens
                with pytest.raises(grpc.aio.AioRpcError):
                    await c.register(u1, b"\x00", b"\x00")
                notes = [policy.budget.tokens < before, c.redirects]
                await c.close()
                drained = pkg.RetryPolicy(budget=pkg.RetryBudget(tokens=1.0))
                drained.budget._tokens = 0.5
                c2 = pkg.AuthClient(partition_map=stale, retry=drained)
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c2.create_challenge(u1)
                notes += [exc.value.code().name, c2.redirects]
                await c2.close()
                return notes
            finally:
                for s in servers:
                    await s.stop(None)

        assert twin(scenario, tmp_path) == [True, 1, "FAILED_PRECONDITION", 0]

    def test_plain_failed_precondition_is_not_a_redirect(self):
        class FakeErr:
            def __init__(self, md):
                self._md = md

            def trailing_metadata(self):
                return self._md

        cases = [
            (),
            (("cpzk-partition-owner", "a:1"),),
            (("cpzk-partition-map-version", "3"),),
            (("cpzk-partition-map-version", "garbage"), ("cpzk-partition-owner", "a:1")),
            (("cpzk-partition-map-version", b"3"), ("cpzk-partition-owner", b"a:1")),
        ]
        got = {pkg.name: [pkg.rpc._redirect_info(FakeErr(md)) for md in cases]
               for pkg in BOTH}
        assert got["port"] == got["reference"] == [(None, None)] * 4 + [("a:1", 3)]


# --- the split flow ---------------------------------------------------------------


async def seed_partition(pkg, tmp_path, tag: str, users: int, seed: int = 70):
    """A stopped partition's durable file set with ``users`` registered,
    one session and one challenge mixed in."""
    stmts = Statements(pkg, seed)
    state = pkg.ServerState()
    mgr = pkg.DurabilityManager(state, pkg.DurabilitySettings(enabled=True, fsync="always"),
                                str(tmp_path / f"{tag}.json"))
    await mgr.recover()
    for i in range(users):
        await state.register_user(pkg.UserData(f"user-{i:03d}", stmts(), 1))
    await state.create_sessions([(state.tag_session_token("user-000", "ab" * 32), "user-000")])
    cid = state.tag_challenge_id("user-001", stmts.gen.fill_bytes(32))
    await state.create_challenge("user-001", cid)
    await mgr.close()
    return str(tmp_path / f"{tag}.json")


async def recovered(pkg, state_file: str):
    state = pkg.ServerState()
    await pkg.recover_state(state, state_file, state_file + ".wal")
    return state


N_USERS = 30


def assert_disjoint_exhaustive(s0, s1, newmap):
    u0, u1 = set(s0._users), set(s1._users)
    assert not (u0 & u1)
    assert u0 | u1 == {f"user-{i:03d}" for i in range(N_USERS)}
    for uid in u0:
        assert newmap.partition_for(uid).index == 0
    for uid in u1:
        assert newmap.partition_for(uid).index == 1
    return sorted(u0), sorted(u1)


class TestSplit:
    def test_split_acceptance_disjoint_exhaustive_ownership(self, tmp_path):
        async def scenario(pkg, workdir):
            src = await seed_partition(pkg, workdir, "p0", N_USERS)
            tgt = str(workdir / "p1.json")
            map_path = str(workdir / "map.json")
            pkg.PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            report = await pkg.run_split(map_path, 0, "127.0.0.1:2", src, tgt,
                                         segment_bytes=512)
            assert report["new_version"] == 2 and report["segments"] >= 2
            assert report["moved_users"] == report["dropped_users"] > 0
            newmap = pkg.PartitionMap.load(map_path)
            s0, s1 = await recovered(pkg, src), await recovered(pkg, tgt)
            owners = assert_disjoint_exhaustive(s0, s1, newmap)
            sess_owner = newmap.partition_for("user-000").index
            holder, other = (s0, s1)[sess_owner], (s1, s0)[sess_owner]
            assert len(holder._sessions) == 1 and len(other._sessions) == 0
            assert pkg.load_epoch(tgt + ".epoch") == report["epoch"] >= 2
            assert not os.path.exists(pkg.manifest_path(map_path))
            return [report, owners, open(map_path, "rb").read()]

        twin(scenario, tmp_path)

    @pytest.mark.parametrize("point", REF.SPLIT_CRASH_POINTS)
    def test_sigkill_at_any_stage_resumes_consistent(self, tmp_path, point):
        assert PORT.SPLIT_CRASH_POINTS == REF.SPLIT_CRASH_POINTS

        async def scenario(pkg, workdir):
            src = await seed_partition(pkg, workdir, "p0", N_USERS)
            tgt = str(workdir / "p1.json")
            map_path = str(workdir / "map.json")
            pkg.PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            plan = pkg.FaultPlan().crash_on(point)
            with pytest.raises(pkg.CrashPoint):
                await pkg.run_split(map_path, 0, "127.0.0.1:2", src, tgt,
                                    segment_bytes=512, faults=plan)
            mid = pkg.PartitionMap.load(map_path).version
            assert mid in (1, 2)
            report = await pkg.run_split(map_path, 0, "127.0.0.1:2", src, tgt,
                                         segment_bytes=512)
            newmap = pkg.PartitionMap.load(map_path)
            assert report["new_version"] == newmap.version == 2
            s0, s1 = await recovered(pkg, src), await recovered(pkg, tgt)
            owners = assert_disjoint_exhaustive(s0, s1, newmap)
            assert not os.path.exists(pkg.manifest_path(map_path))
            return [mid, owners, open(map_path, "rb").read()]

        twin(scenario, tmp_path)

    def test_mismatched_resume_manifest_refused(self, tmp_path):
        async def scenario(pkg, workdir):
            src = await seed_partition(pkg, workdir, "p0", 8)
            tgt = str(workdir / "p1.json")
            map_path = str(workdir / "map.json")
            pkg.PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            with pytest.raises(pkg.CrashPoint):
                await pkg.run_split(map_path, 0, "127.0.0.1:2", src, tgt,
                                    faults=pkg.FaultPlan().crash_on("pre_copy"))
            with pytest.raises(pkg.SplitError, match="different split") as exc:
                await pkg.run_split(map_path, 0, "127.0.0.1:OTHER", src, tgt)
            return str(exc.value).replace(str(workdir), "W")

        twin(scenario, tmp_path)

    def test_post_split_fleet_serves_and_stale_client_redirects(self, tmp_path):
        async def scenario(pkg, workdir):
            src = await seed_partition(pkg, workdir, "p0", 6)
            tgt = str(workdir / "p1.json")
            map_path = str(workdir / "map.json")
            pkg.PartitionMap.uniform(["127.0.0.1:1"]).store(map_path)
            await pkg.run_split(map_path, 0, "127.0.0.1:2", src, tgt)
            s0, s1 = await recovered(pkg, src), await recovered(pkg, tgt)
            srv0, p0 = await pkg.serve(s0, pkg.RateLimiter(10**6, 10**6), port=0)
            srv1, p1 = await pkg.serve(s1, pkg.RateLimiter(10**6, 10**6), port=0)
            disk = pkg.PartitionMap.load(map_path)
            live = pkg.PartitionMap.from_doc({
                "schema": "cpzk-partition-map/1", "version": disk.version,
                "partitions": [
                    {"index": 0, "address": f"127.0.0.1:{p0}",
                     "ranges": [list(r) for r in disk.partitions[0].ranges]},
                    {"index": 1, "address": f"127.0.0.1:{p1}",
                     "ranges": [list(r) for r in disk.partitions[1].ranges]},
                ],
            })
            srv0.auth_service.fleet = pkg.FleetRouter(live, 0)
            srv1.auth_service.fleet = pkg.FleetRouter(live, 1)
            try:
                c = pkg.AuthClient(partition_map=live)
                for idx in (0, 1):
                    uid = uid_on_partition(live, idx, tag="fresh")
                    assert "Registered" in await pkg.do_register(c, uid, "pw")
                    assert "Login OK" in await pkg.do_login(c, uid, "pw")
                notes = [c.redirects]
                await c.close()
                moved = uid_on_partition(live, 1, tag="fresh")
                stale = pkg.PartitionMap.uniform([f"127.0.0.1:{p0}"])
                c2 = pkg.AuthClient(partition_map=stale,
                                    map_refresh=lambda: pkg.PartitionMap.from_doc(live.to_doc()))
                notes.append("Login OK" in await pkg.do_login(c2, moved, "pw"))
                assert 1 <= c2.redirects <= 2
                notes.append(c2.partition_map.version == live.version)
                await c2.close()
                return notes
            finally:
                await srv0.stop(None)
                await srv1.stop(None)

        assert twin(scenario, tmp_path) == [0, True, True]


# --- proof-log rotation + shipping ------------------------------------------------


#: the first seeded record's time (2023-11-14 22:13:20 UTC)
SEEDED_PROOFS_T0 = 1_700_000_000


def seeded_proofs(pkg, n: int, seed: int, users: int):
    """``n`` proof-record payloads over seeded contexts and a seeded
    prover (the same bytes for either package: the records' times are
    fixed too, so that the two runs' digests do not depend on whether they
    fall in the same second)."""
    log, _ = audit_mods(pkg)
    stmts = Statements(pkg, seed)
    prover = stmts.prover()
    eb = pkg.Ristretto255.element_to_bytes
    out = []
    for i in range(n):
        ctx = stmts.gen.fill_bytes(32)
        t = pkg.Transcript()
        t.append_context(ctx)
        wire = prover.prove_with_transcript(stmts.gen, t).to_bytes()
        out.append(log.proof_record(f"u{i % users}", eb(prover.statement.y1),
                                    eb(prover.statement.y2), ctx, wire, True,
                                    now=SEEDED_PROOFS_T0 + i))
    return out


class TestAuditRotation:
    def test_rotation_seals_and_resumes_numbering(self, tmp_path):
        def scenario(pkg, workdir):
            log, _ = audit_mods(pkg)
            path = str(workdir / "proofs.log")
            w = log.ProofLogWriter(path, fsync="off", segment_bytes=512)
            rec = lambda i: log.proof_record(  # noqa: E731
                f"u{i}", b"\x01" * 32, b"\x02" * 32, b"c" * 32, b"p" * 64, True)
            for i in range(40):
                w.append_proofs([rec(i)])
            segs = log.sealed_segments(path)
            assert w.rotations >= 2 and len(segs) == w.rotations and segs == sorted(segs)
            prev = 0
            for seg in segs:
                records, valid, size = log.read_log(seg)
                assert valid == size and records and records[0]["seq"] == prev + 1
                prev = records[-1]["seq"]
            st = w.status()
            notes = [w.rotations, st["rotations_this_boot"], st["sealed_segments"],
                     [os.path.basename(s) for s in segs],
                     [open(s, "rb").read() for s in segs]]
            w.close()
            w2 = log.ProofLogWriter(path, fsync="off", segment_bytes=512)
            notes.append(w2.seq)
            w2.append_proofs([rec(99)])
            notes.append(w2.seq)
            w2.close()
            return notes

        notes = twin(scenario, tmp_path)
        assert notes[-2:] == [40, 41]

    def test_directory_replay_equals_single_log_replay(self, tmp_path):
        def scenario(pkg, workdir):
            log, run_audit = audit_mods(pkg)
            rot_dir = workdir / "rotated"
            rot_dir.mkdir()
            payloads = seeded_proofs(pkg, 24, 71, 4)
            rot = log.ProofLogWriter(str(rot_dir / "proofs.log"), fsync="off",
                                     segment_bytes=600)
            flat = log.ProofLogWriter(str(workdir / "flat.log"), fsync="off")
            for p in payloads:
                rot.append_proofs([dict(p)])
                flat.append_proofs([dict(p)])
            rot.close()
            flat.close()
            assert rot.rotations >= 2
            rep_dir = run_audit(str(rot_dir), str(workdir / "dir-report.json"), quantum=7)
            rep_flat = run_audit(str(workdir / "flat.log"), str(workdir / "flat-report.json"),
                                 quantum=7)
            assert rep_dir["digest"] == rep_flat["digest"]
            assert rep_dir["totals"] == rep_flat["totals"]
            return [rot.rotations, rep_dir["digest"], rep_dir["totals"]]

        notes = twin(scenario, tmp_path)
        assert notes[2]["verified"] == 24

    def test_sealed_segments_survive_machine_death(self, tmp_path):
        async def scenario(pkg, workdir):
            log, run_audit = audit_mods(pkg)
            pri, sby = workdir / "pri", workdir / "sby"
            pri.mkdir()
            sby.mkdir()
            w = log.ProofLogWriter(str(pri / "proofs.log"), fsync="off", segment_bytes=512)
            sstate = pkg.ServerState()
            smgr = pkg.DurabilityManager(sstate, pkg.DurabilitySettings(enabled=True),
                                         str(sby / "state.json"))
            await smgr.recover()
            replica = pkg.StandbyReplica(sstate, smgr, pkg.ReplicationSettings(
                enabled=True, role="standby", lease_ms=5000, renew_interval_ms=100),
                audit_path=str(sby / "proofs.log"))
            sserver, sport = await pkg.serve(sstate, pkg.RateLimiter(10**6, 10**6), port=0,
                                             replica=replica)
            pstate = pkg.ServerState()
            pmgr = pkg.DurabilityManager(pstate, pkg.DurabilitySettings(enabled=True),
                                         str(pri / "state.json"))
            await pmgr.recover()
            shipper = pkg.SegmentShipper(pstate, pmgr, pkg.ReplicationSettings(
                enabled=True, role="primary", peer=f"127.0.0.1:{sport}", lease_ms=5000,
                renew_interval_ms=30, mode="async"), audit_log=w)
            shipper.start()
            try:
                for p in seeded_proofs(pkg, 30, 72, 30):
                    w.append_proofs([p])
                n_sealed = len(w.sealed_segments())
                assert n_sealed >= 2
                await wait_for(lambda: shipper.audit_segments_shipped >= n_sealed)
                assert replica.audit_segments_received >= n_sealed
                assert shipper.status()["audit_segments_shipped"] >= n_sealed
                assert replica.status()["audit_segments_received"] >= n_sealed
                await shipper.kill()
                got = log.sealed_segments(str(sby / "proofs.log"))
                assert len(got) == n_sealed
                blobs = []
                for a, b in zip(sorted(w.sealed_segments()), got, strict=True):
                    with open(a, "rb") as fa, open(b, "rb") as fb:
                        blobs.append(fa.read())
                        assert blobs[-1] == fb.read()
                report = run_audit(str(sby), str(workdir / "sby-report.json"), quantum=8)
                t = report["totals"]
                assert t["skipped"] == 0 and t["mismatched"] == 0 and t["audited"] > 0
                return [n_sealed, blobs, t]
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)

        twin(scenario, tmp_path)

    def test_stale_epoch_audit_segment_is_fenced(self, tmp_path):
        async def scenario(pkg, workdir):
            sby = workdir / "sby"
            sby.mkdir()
            sstate = pkg.ServerState()
            smgr = pkg.DurabilityManager(sstate, pkg.DurabilitySettings(enabled=True),
                                         str(sby / "state.json"))
            await smgr.recover()
            replica = pkg.StandbyReplica(sstate, smgr, pkg.ReplicationSettings(
                enabled=True, role="standby", lease_ms=5000, renew_interval_ms=100),
                audit_path=str(sby / "proofs.log"))
            replica.applier.epoch = 5
            pb2 = replica.pb2
            resp = await replica.ship_segment(pb2.ShipSegmentRequest(
                epoch=3, kind="audit", frames=b"junk", crc32=0, first_seq=1, last_seq=1), None)
            replica.audit_path = None
            resp2 = await replica.ship_segment(pb2.ShipSegmentRequest(
                epoch=5, kind="audit", frames=b"junk", crc32=0, first_seq=1, last_seq=1), None)
            return [(resp.accepted, resp.message), (resp2.accepted, resp2.message)]

        notes = twin(scenario, tmp_path)
        assert not notes[0][0] and "fenced" in notes[0][1]
        assert not notes[1][0] and "no audit plane" in notes[1][1]


def test_promoted_standby_proof_log_continues_the_shipped_trail(tmp_path):
    """The port's departure from the reference: a standby's own proof-log
    writer opens at boot, before any segment is shipped to it, and its
    promotion moves the numbering past the shipped segments.  The
    promoted node's first record follows the primary's last shipped one,
    and its directory replays as one whole log; a shipment after the
    promotion is fenced and changes nothing."""
    log, run_audit = audit_mods(PORT)
    pkg = PORT

    async def scenario():
        pri, sby = tmp_path / "pri", tmp_path / "sby"
        pri.mkdir()
        sby.mkdir()
        w = log.ProofLogWriter(str(pri / "proofs.log"), fsync="off", segment_bytes=512)
        own = log.ProofLogWriter(str(sby / "proofs.log"), fsync="off", segment_bytes=512)
        assert own.seq == 0
        sstate = pkg.ServerState()
        smgr = pkg.DurabilityManager(sstate, pkg.DurabilitySettings(enabled=True),
                                     str(sby / "state.json"))
        await smgr.recover()
        replica = pkg.StandbyReplica(sstate, smgr, pkg.ReplicationSettings(
            enabled=True, role="standby", lease_ms=5000, renew_interval_ms=100),
            audit_path=own.path, audit_log=own)
        sserver, sport = await pkg.serve(sstate, pkg.RateLimiter(10**6, 10**6), port=0,
                                         replica=replica)
        pstate = pkg.ServerState()
        pmgr = pkg.DurabilityManager(pstate, pkg.DurabilitySettings(enabled=True),
                                     str(pri / "state.json"))
        await pmgr.recover()
        shipper = pkg.SegmentShipper(pstate, pmgr, pkg.ReplicationSettings(
            enabled=True, role="primary", peer=f"127.0.0.1:{sport}", lease_ms=5000,
            renew_interval_ms=30, mode="async"), audit_log=w)
        shipper.start()
        try:
            payloads = seeded_proofs(pkg, 40, 73, 40)
            for p in payloads[:30]:
                w.append_proofs([p])
            n_sealed = len(w.sealed_segments())
            assert n_sealed >= 2
            await wait_for(lambda: shipper.audit_segments_shipped >= n_sealed)
            await shipper.kill()
            shipped_last = log.read_log(w.sealed_segments()[-1])[0][-1]["seq"]
            assert own.seq == 0  # no rescan while a standby
            report = await replica.promote(reason="operator")
            assert report["promoted"] and own.seq == shipped_last
            resp = await replica.ship_segment(replica.pb2.ShipSegmentRequest(
                epoch=replica.epoch, kind="audit", frames=b"junk", crc32=0,
                first_seq=shipped_last + 1, last_seq=shipped_last + 1), None)
            assert not resp.accepted and "fenced" in resp.message
            assert own.seq == shipped_last
            for p in payloads[30:]:
                own.append_proofs([p])
            own.close()
            seqs = [r["seq"] for f in [*log.sealed_segments(own.path), own.path]
                    for r in log.read_log(f)[0]]
            assert seqs == list(range(1, own.seq + 1))
            return shipped_last, own.seq
        finally:
            await shipper.kill()
            await replica.stop()
            await sserver.stop(None)

    shipped_last, last = run(scenario())
    assert last == shipped_last + 10
    report = run_audit(str(tmp_path / "sby"), str(tmp_path / "sby-report.json"), quantum=8)
    t = report["totals"]
    assert t["records"] == t["audited"] == t["verified"] == last
    assert t["skipped"] == 0 and t["mismatched"] == 0
    assert report["log"]["valid_bytes"] == report["log"]["file_bytes"]
    assert (report["log"]["first_seq"], report["log"]["last_seq"]) == (1, last)


# --- chaos acceptance: 3-partition fleet ------------------------------------------


class TestFleetChaos:
    def test_kill_one_partition_others_serve_uninterrupted(self, tmp_path):
        """Partition 0 is a replicated pair (sync, fsync=always), 1 and 2
        plain primaries; partition 0's primary dies mid-traffic, its
        standby promotes and completes a pre-crash user's login with zero
        acknowledged loss, partitions 1 and 2 never error meanwhile, and a
        stale-map client is redirected and logs in."""

        async def scenario(pkg, workdir):
            sstate = pkg.ServerState()
            smgr = pkg.DurabilityManager(
                sstate, pkg.DurabilitySettings(enabled=True, fsync="always"),
                str(workdir / "p0-standby.json"))
            await smgr.recover()
            replica = pkg.StandbyReplica(sstate, smgr, pkg.ReplicationSettings(
                enabled=True, role="standby", lease_ms=400, renew_interval_ms=40,
                mode="sync"))
            sserver, sport = await pkg.serve(sstate, pkg.RateLimiter(10**6, 10**6), port=0,
                                             replica=replica)
            replica.start()
            pstate = pkg.ServerState()
            pmgr = pkg.DurabilityManager(
                pstate, pkg.DurabilitySettings(enabled=True, fsync="always"),
                str(workdir / "p0-primary.json"))
            await pmgr.recover()
            shipper = pkg.SegmentShipper(pstate, pmgr, pkg.ReplicationSettings(
                enabled=True, role="primary", peer=f"127.0.0.1:{sport}", lease_ms=400,
                renew_interval_ms=40, mode="sync"))
            pmgr.attach_shipper(shipper)
            pstate.attach_replication_barrier(shipper.wait_replicated)
            pserver, pport = await pkg.serve(pstate, pkg.RateLimiter(10**6, 10**6), port=0)
            shipper.start()
            s1, s2 = pkg.ServerState(), pkg.ServerState()
            srv1, port1 = await pkg.serve(s1, pkg.RateLimiter(10**6, 10**6), port=0)
            srv2, port2 = await pkg.serve(s2, pkg.RateLimiter(10**6, 10**6), port=0)
            pmap = pkg.PartitionMap.uniform(
                [f"127.0.0.1:{pport}", f"127.0.0.1:{port1}", f"127.0.0.1:{port2}"])
            pserver.auth_service.fleet = pkg.FleetRouter(pmap, 0)
            srv1.auth_service.fleet = pkg.FleetRouter(pmap, 1)
            srv2.auth_service.fleet = pkg.FleetRouter(pmap, 2)
            u0 = uid_on_partition(pmap, 0)
            pools = {i: [uid_on_partition(pmap, i, tag=f"s{k}-") for k in range(5)]
                     for i in (1, 2)}
            logins_done: dict[str, int] = {}
            survivor_errors: list[str] = []
            stop_traffic = asyncio.Event()

            async def survivor_traffic():
                c = pkg.AuthClient(partition_map=pmap)
                k = 0
                try:
                    while not stop_traffic.is_set():
                        for idx in (1, 2):
                            uid = pools[idx][k % len(pools[idx])]
                            if logins_done.get(uid, 0) >= 4:
                                continue
                            out = await pkg.do_login(c, uid, "pw-" + uid)
                            logins_done[uid] = logins_done.get(uid, 0) + 1
                            if "Login OK" not in out:
                                survivor_errors.append(out)
                        k += 1
                        await asyncio.sleep(0.01)
                finally:
                    await c.close()

            try:
                c = pkg.AuthClient(partition_map=pmap)
                for uid in [u0] + pools[1] + pools[2]:
                    assert "Registered" in await pkg.do_register(c, uid, "pw-" + uid)
                assert "Login OK" in await pkg.do_login(c, u0, "pw-" + u0)
                await c.close()
                assert replica.applied_seq == pmgr.wal.seq
                traffic = asyncio.get_running_loop().create_task(survivor_traffic())
                await asyncio.sleep(0.1)
                await shipper.kill()
                await pserver.stop(None)
                await wait_for(lambda: replica.role == "primary", timeout=8.0)
                notes = [replica.epoch]
                await asyncio.sleep(0.2)
                stop_traffic.set()
                await traffic
                assert not survivor_errors, survivor_errors[:3]
                assert sum(logins_done.values()) >= 4
                async with pkg.AuthClient(f"127.0.0.1:{sport}") as c2:
                    notes.append("Login OK" in await pkg.do_login(c2, u0, "pw-" + u0))
                promoted = pkg.PartitionMap.from_doc({
                    "schema": "cpzk-partition-map/1", "version": 2,
                    "partitions": [
                        {"index": i, "address": f"127.0.0.1:{p}",
                         "ranges": [list(r) for r in pmap.partitions[i].ranges]}
                        for i, p in enumerate((sport, port1, port2))],
                })
                sserver.auth_service.fleet = pkg.FleetRouter(promoted, 0)
                srv1.auth_service.fleet = pkg.FleetRouter(promoted, 1)
                srv2.auth_service.fleet = pkg.FleetRouter(promoted, 2)
                stale = pkg.PartitionMap.uniform([f"127.0.0.1:{port1}"])
                c3 = pkg.AuthClient(partition_map=stale, map_refresh=lambda: promoted)
                notes.append("Login OK" in await pkg.do_login(c3, u0, "pw-" + u0))
                assert 1 <= c3.redirects <= 2
                notes.append(c3.partition_map.version)
                await c3.close()
                return notes
            finally:
                stop_traffic.set()
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                await srv1.stop(None)
                await srv2.stop(None)

        assert twin(scenario, tmp_path) == [2, True, True, 2]


# --- config surface ---------------------------------------------------------------


class TestFleetConfig:
    def test_env_layering_and_validation(self, tmp_path, monkeypatch):
        for pkg in BOTH:
            map_path = str(tmp_path / f"{pkg.name}-map.json")
            pkg.PartitionMap.uniform(["a:1"]).store(map_path)
            monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "none.toml"))
            monkeypatch.setenv("SERVER_FLEET_ENABLED", "1")
            monkeypatch.setenv("SERVER_FLEET_MAP_PATH", map_path)
            monkeypatch.setenv("SERVER_FLEET_PARTITION", "0")
            monkeypatch.setenv("SERVER_FLEET_ADVERTISE", "a:1")
            cfg = pkg.ServerConfig.from_env()
            assert dataclasses.asdict(cfg.fleet) == {
                "enabled": True, "map_path": map_path, "partition": 0, "advertise": "a:1"}
            cfg.validate()
            errors = []
            for mutate, match in (
                    (lambda c: setattr(c.fleet, "enabled", True), "map_path"),
                    (lambda c: setattr(c.fleet, "partition", -2), "partition"),
                    (lambda c: setattr(c.audit, "segment_bytes", -1), "segment_bytes")):
                bad = pkg.ServerConfig()
                mutate(bad)
                with pytest.raises(ValueError, match=match) as exc:
                    bad.validate()
                errors.append(str(exc.value))
            if pkg is REF:
                ref_errors = errors
            else:
                assert errors == ref_errors

    def test_fleet_config_keys_documented(self):
        keys = [f.name for f in dataclasses.fields(PORT.FleetSettings)]
        assert keys == [f.name for f in dataclasses.fields(REF.FleetSettings)]
        toml_text = (ROOT / "config" / "server.toml.example").read_text()
        m = re.search(r"^\[fleet\]$", toml_text, re.M)
        assert m
        section = toml_text[m.end():].split("\n[", 1)[0]
        env_text = (ROOT / ".env.example").read_text()
        docs = (ROOT / "docs" / "operations.md").read_text()
        for key in keys:
            assert re.search(rf"^{key}\s*=", section, re.M), key
            assert f"SERVER_FLEET_{key.upper()}" in env_text, key
            assert f"`fleet.{key}`" in docs, key

    def test_repl_fleet_command(self, tmp_path):
        async def scenario(pkg, workdir):
            state = pkg.ServerState()
            notes = [(await pkg.handle("/fleet", state))[0]]
            map_path = str(workdir / "map.json")
            v1 = pkg.PartitionMap.uniform(["a:1", "b:2"])
            v1.store(map_path)
            router = pkg.FleetRouter(v1, 1, map_path=map_path)
            notes.append((await pkg.handle("/fleet", state, fleet=router))[0])
            notes.append((await pkg.handle("/fleet reload", state, fleet=router))[0])
            v2, _ = v1.split(0, "c:3")
            v2.store(map_path)
            notes.append((await pkg.handle("/fleet reload", state, fleet=router))[0])
            return notes

        notes = twin(scenario, tmp_path)
        assert "fleet routing disabled" in notes[0]
        assert "partition=1/2" in notes[1] and "map=v1" in notes[1]
        assert "map unchanged" in notes[2]
        assert "map=v2" in notes[3] and "partition=1/3" in notes[3]

    def test_statusz_and_partitionmap_endpoint(self, tmp_path):
        async def scenario(pkg, _):
            pmap, _s = pkg.PartitionMap.uniform(["a:1", "b:2"]).split(1, "c:3")
            router = pkg.FleetRouter(pmap, 2)
            engine = pkg.SloEngine(pkg.SloSettings())
            engine.partition = "2"
            plane = pkg.OpsPlane(pkg.OpsSources(fleet=router, slo=engine), port=0)
            port = await plane.start()

            def get(p, path):
                with urllib.request.urlopen(f"http://127.0.0.1:{p}{path}") as r:
                    return json.loads(r.read())

            try:
                statusz = await asyncio.to_thread(get, port, "/statusz")
                doc = await asyncio.to_thread(get, port, "/partitionmap")
                fetched = pkg.PartitionMap.from_doc(doc)
                assert fetched.digest == pmap.digest
                slo = await asyncio.to_thread(get, port, "/slo")
                bare = pkg.OpsPlane(pkg.OpsSources(), port=0)
                bport = await bare.start()
                try:
                    with pytest.raises(urllib.error.HTTPError) as exc:
                        await asyncio.to_thread(get, bport, "/partitionmap")
                    code = exc.value.code
                finally:
                    await bare.stop()
                return [statusz["fleet"], doc, fetched.version, slo["partition"], code]
            finally:
                await plane.stop()

        notes = twin(scenario, tmp_path)
        assert notes[0]["partition"] == 2 and notes[0]["map_version"] == 2
        assert notes[0]["partitions"] == 3 and notes[2:] == [2, "2", 404]

    def test_fleet_gauges_exported(self):
        for pkg in BOTH:
            pkg.FleetRouter(pkg.PartitionMap.uniform(["a:1", "b:2"]), 1)
            assert pkg.metrics.read("fleet.partition", "g") == 1.0
            assert pkg.metrics.read("fleet.map_version", "g") == 1.0


# --- standby addresses: map v2 + client failover dial ------------------------------


class TestStandbyAddresses:
    def test_v2_roundtrip_and_v1_byte_compat(self, tmp_path):
        def scenario(pkg, workdir):
            plain = pkg.PartitionMap.uniform(["a:1", "b:2"])
            assert plain.to_doc()["schema"] == "cpzk-partition-map/1"
            assert all(p.standby is None for p in plain.partitions)
            v2 = pkg.PartitionMap.uniform(["a:1", "b:2"], standbys=["a:9", None])
            doc = v2.to_doc()
            assert doc["schema"] == "cpzk-partition-map/2"
            assert doc["partitions"][0]["standby"] == "a:9"
            assert "standby" not in doc["partitions"][1]
            path = str(workdir / "map.json")
            v2.store(path)
            loaded = pkg.PartitionMap.load(path)
            assert loaded.partitions[0].standby == "a:9"
            assert loaded.partitions[1].standby is None and loaded.digest == v2.digest
            assert plain.to_json() == pkg.PartitionMap.uniform(["a:1", "b:2"]).to_json()
            return [plain.to_json(), v2.to_json()]

        twin(scenario, tmp_path)

    def test_set_and_swap_standby(self, tmp_path):
        def scenario(pkg, _):
            pmap = pkg.PartitionMap.uniform(["a:1", "b:2"])
            with_sb = pmap.set_standby(0, "a:9")
            assert with_sb.version == pmap.version + 1
            assert with_sb.partitions[0].standby == "a:9"
            assert with_sb.partitions[1].standby is None
            assert with_sb.set_standby(0, None).partitions[0].standby is None
            flipped = with_sb.swap_standby(0)
            assert flipped.version == with_sb.version + 1
            assert flipped.partitions[0].address == "a:9"
            assert flipped.partitions[0].standby == "a:1"
            with pytest.raises(ValueError, match="no standby"):
                with_sb.swap_standby(1)
            return [with_sb.to_json(), flipped.to_json()]

        twin(scenario, tmp_path)

    def test_split_preserves_standby(self, tmp_path):
        def scenario(pkg, _):
            pmap = pkg.PartitionMap.uniform(["a:1", "b:2"], standbys=["a:9", "b:9"])
            new_map, _ = pmap.split(0, "c:3")
            return [p.standby for p in new_map.partitions]

        assert twin(scenario, tmp_path) == ["a:9", "b:9", None]

    def test_v2_rejections(self, tmp_path):
        def scenario(pkg, _):
            errors = []
            with pytest.raises(ValueError, match="standbys") as exc:
                pkg.PartitionMap.uniform(["a:1", "b:2"], standbys=["a:9"])
            errors.append(str(exc.value))
            with pytest.raises(ValueError, match="standby") as exc:
                pkg.PartitionMap.uniform(["a:1"], standbys=["a:1"])
            errors.append(str(exc.value))
            doc = pkg.PartitionMap.uniform(["a:1"], standbys=["a:9"]).to_doc()
            doc["partitions"][0]["standby"] = 7
            doc.pop("digest")
            with pytest.raises(ValueError, match="standby") as exc:
                pkg.PartitionMap.from_doc(doc)
            errors.append(str(exc.value))
            return errors

        twin(scenario, tmp_path)

    def test_client_dials_standby_on_unavailable(self, tmp_path):
        async def scenario(pkg, _):
            state = pkg.ServerState()
            server, live = await pkg.serve(state, pkg.RateLimiter(10**6, 10**6), port=0)
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            dead = s.getsockname()[1]
            s.close()
            try:
                pmap = pkg.PartitionMap.uniform([f"127.0.0.1:{dead}"],
                                                standbys=[f"127.0.0.1:{live}"])
                policy = pkg.RetryPolicy(budget=pkg.RetryBudget(tokens=10.0))
                c = pkg.AuthClient(partition_map=pmap, retry=policy)
                before = policy.budget.tokens
                p = Statements(pkg, 73).prover()
                eb = pkg.Ristretto255.element_to_bytes
                resp = await c.register("sb-user", eb(p.statement.y1), eb(p.statement.y2))
                notes = [resp.success, c.standby_dials, policy.budget.tokens == before,
                         "sb-user" in state._users]
                flipped = pkg.PartitionMap.uniform([f"127.0.0.1:{live}"],
                                                   standbys=[f"127.0.0.1:{dead}"])
                c2 = pkg.AuthClient(partition_map=flipped)
                ch = await c2.create_challenge("sb-user")
                notes += [len(ch.challenge_id), c2.standby_dials]
                await c.close()
                await c2.close()
                return notes
            finally:
                await server.stop(None)

        assert twin(scenario, tmp_path) == [True, 1, True, True, 32, 0]


# --- the CLI: both packages on the same files -----------------------------------------


def fleet_cli(pkg, *args, cwd):
    mod = f"{pkg.top.__name__}.fleet"
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", mod, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def test_split_by_either_cli_gives_the_same_map_and_moved_users(tmp_path):
    """``python -m cpzk_tpu_torch.fleet`` and ``python -m cpzk_tpu.fleet``
    on copies of one stopped partition: ``init`` and ``set-standby`` write
    the same map bytes, ``route`` and ``show`` print the same lines, and
    ``split`` writes the same new map and leaves the same users on each
    side."""
    base = tmp_path / "base"
    base.mkdir()
    src = run(seed_partition(REF, base, "p0", 24, seed=74))
    outs = {}
    for pkg in BOTH:
        work = tmp_path / pkg.name
        shutil.copytree(base, work)
        init = fleet_cli(pkg, "init", "--addresses", "127.0.0.1:1", "--out", "map.json",
                         cwd=work)
        stand = fleet_cli(pkg, "set-standby", "--map", "map.json", "--partition", "0",
                          "--standby", "127.0.0.1:9", cwd=work)
        route = fleet_cli(pkg, "route", "--map", "map.json", "user-000", "user-013", cwd=work)
        show = fleet_cli(pkg, "show", "--map", "map.json", cwd=work)
        split = fleet_cli(pkg, "split", "--map", "map.json", "--source", "0",
                          "--new-address", "127.0.0.1:2", "--source-state",
                          str(work / os.path.basename(src)), "--target-state",
                          str(work / "p1.json"), "--segment-bytes", "512", cwd=work)
        for done in (init, stand, route, show, split):
            assert done.returncode == 0, done.stderr
        s0 = run(recovered(pkg, str(work / "p0.json")))
        s1 = run(recovered(pkg, str(work / "p1.json")))
        report = json.loads(split.stdout.strip().splitlines()[-1])
        outs[pkg.name] = {
            "init": json.loads(init.stdout)["digest"], "standby": stand.stdout,
            "route": route.stdout, "show": show.stdout,
            "map": (work / "map.json").read_bytes(), "report": report,
            "users": (sorted(s0._users), sorted(s1._users)),
            "sessions": (sorted(s0._sessions), sorted(s1._sessions)),
            "challenges": (sorted(c.hex() for c in s0._challenges),
                           sorted(c.hex() for c in s1._challenges)),
        }
    assert outs["port"] == outs["reference"]
    assert outs["port"]["report"]["moved_users"] > 0
