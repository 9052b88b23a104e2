"""Twins of ``tests/test_replication.py`` for the port's replication plane
(``cpzk_tpu_torch/replication/``): sharded state, segments, shipping and
promotion over real gRPC, the ``[replication]`` config surface, the
segmented WAL under replication and the coordinated handover, class by
class under the reference's names.

Each case runs one scenario on the reference package and then on the
port (``torch_repl_twins.twin``), on seeded statements, and requires
equal notes; the reference test's assertions hold inside the scenario on
both sides.

Beyond the twins:
- twins of ``tests/test_chaos.py``'s replication cases
  (``test_kill_primary_promote_login_zero_acknowledged_loss``,
  ``test_promotion_after_ship_crash_points`` with both parameters, and
  ``test_sigkill_primary_two_process_failover_zero_loss``, marked slow as
  the reference marks it) and the replication half of
  ``tests/test_opsplane.py::test_statusz_e2e_with_replication_and_audit``;
- the port's own contracts: a sync-mode pair loses no acknowledged
  registration, challenge or session to a primary death at every WAL
  crash point of an acknowledgement, ``RegisterBatch`` awaits the
  barrier once per RPC on its last sequence number, and compaction stops
  at the smaller of the standby's acknowledged offset and the oldest live
  challenge's record, in both orders;
- cross-package parity: segments sealed by either package are
  byte-equal, and a primary of either package ships to a standby of the
  other over gRPC, both promoting to the same state;
- the daemon: a primary and a standby of ``python -m
  cpzk_tpu_torch.server`` (the kernels' plain versions), where the
  standby refuses auth RPCs, SIGTERM hands over, and the shutdown order
  ships the primary's last sealed proof-log segment.
"""

import asyncio
import dataclasses
import json
import os
import pathlib
import re
import signal
import sys
import time
import urllib.request
import zlib

import grpc
import pytest

from torch_repl_twins import (
    BOTH,
    PORT,
    REF,
    Statements,
    make_pair,
    run,
    twin,
    wait_for,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def uid_on_shard(state, shard: int, avoid: set | None = None) -> str:
    avoid = avoid or set()
    i = 0
    while True:
        uid = f"user-{i}"
        if uid not in avoid and state._shard_index(uid) == shard:
            return uid
        i += 1


def make_records(pkg, stmts, n, start_seq=1, rtype="register_user"):
    eb = pkg.Ristretto255.element_to_bytes
    sts = [stmts() for _ in range(n)]
    return [
        {
            "seq": start_seq + i, "type": rtype, "user_id": f"user-{i}",
            "y1": eb(sts[i].y1).hex(), "y2": eb(sts[i].y2).hex(),
            "registered_at": 1,
        }
        for i in range(n)
    ]


def user(pkg, uid, st):
    return pkg.UserData(uid, st, 1)


# --- sharded state ----------------------------------------------------------------


class TestShardedState:
    def test_shard_count_bounds(self, tmp_path):
        def scenario(pkg, _):
            for bad in (0, 257):
                with pytest.raises(ValueError):
                    pkg.ServerState(shards=bad)
            return pkg.ServerState(shards=1).num_shards

        assert twin(scenario, tmp_path) == 1

    def test_stable_hash_and_tags(self, tmp_path):
        def scenario(pkg, _):
            st = pkg.ServerState(shards=8)
            idx = st._shard_index("alice")
            assert idx == zlib.crc32(b"alice") % 8
            cid = st.tag_challenge_id("alice", b"\xff" * 32)
            assert cid[0] == idx and cid[1:] == b"\xff" * 31 and len(cid) == 32
            tok = st.tag_session_token("alice", "f" * 64)
            assert tok == f"{idx:02x}" + "f" * 62
            return idx, cid.hex(), tok

        twin(scenario, tmp_path)

    def test_tagged_routing_and_untagged_fallback(self, tmp_path):
        async def scenario(pkg, _):
            stmts = Statements(pkg, 1)
            st = pkg.ServerState(shards=8)
            await st.register_user(user(pkg, "alice", stmts()))
            cid = st.tag_challenge_id("alice", os.urandom(32))
            await st.create_challenge("alice", cid)
            located = st._locate_challenge(cid) == st._shard_index("alice")
            got = (await st.consume_challenge(cid)).user_id
            raw = b"c" * 32
            await st.create_challenge("alice", raw)
            untagged = (await st.consume_challenge(raw)).user_id
            tok = st.tag_session_token("alice", "a" * 64)
            await st.create_session(tok, "alice")
            tagged_sess = await st.validate_session(tok)
            await st.create_session("tok", "alice")
            plain_sess = await st.validate_session("tok")
            await st.revoke_session("tok")
            with pytest.raises(Exception, match="Invalid session token"):
                await st.validate_session("tok")
            return located, got, untagged, tagged_sess, plain_sess

        assert twin(scenario, tmp_path) == (True, "alice", "alice", "alice", "alice")

    def test_distinct_users_do_not_serialize(self, tmp_path):
        async def scenario(pkg, _):
            stmts = Statements(pkg, 2)
            st = pkg.ServerState(shards=4)
            a = uid_on_shard(st, 0)
            same = uid_on_shard(st, 0, avoid={a})
            other = uid_on_shard(st, 1)
            async with st._shard_for_user(a).lock:
                await asyncio.wait_for(
                    st.register_user(user(pkg, other, stmts())), timeout=2.0)
                with pytest.raises(asyncio.TimeoutError):
                    await asyncio.wait_for(
                        st.register_user(user(pkg, same, stmts())), timeout=0.1)
            await st.register_user(user(pkg, same, stmts()))
            return await st.user_count()

        assert twin(scenario, tmp_path) == 2

    def test_views_merge_shards(self, tmp_path):
        async def scenario(pkg, _):
            stmts = Statements(pkg, 3)
            st = pkg.ServerState(shards=4)
            uids = [uid_on_shard(st, i) for i in range(4)]
            for u in uids:
                await st.register_user(user(pkg, u, stmts()))
                await st.create_session(st.tag_session_token(u, os.urandom(32).hex()), u)
            assert sorted(st._users) == sorted(uids)
            for tok, sess in st._sessions.items():
                assert st._sessions[tok] is sess and tok in st._sessions
            assert "nope" not in st._sessions
            return sorted(st._users), len(st._sessions)

        twin(scenario, tmp_path)


# --- segments ---------------------------------------------------------------------


class TestSegments:
    def test_seal_split_validate_roundtrip(self, tmp_path):
        def scenario(pkg, _):
            records = make_records(pkg, Statements(pkg, 4), 5)
            segs = pkg.split_records(records, epoch=1, first_index=0, segment_bytes=400)
            assert len(segs) == 3
            assert segs[0].sealed and not segs[-1].sealed
            seen = []
            for seg in segs:
                got, err = pkg.validate_segment(seg)
                assert err is None
                seen.extend(r["seq"] for r in got)
            assert seen == [r["seq"] for r in records]
            # the bytes: a segment is its frames and their CRC
            return [(s.index, s.first_seq, s.last_seq, s.sealed, s.crc, s.frames.hex())
                    for s in segs]

        twin(scenario, tmp_path)

    def test_validation_rejects_torn_and_tampered(self, tmp_path):
        def scenario(pkg, _):
            seg = pkg.seal_segment(1, 0, make_records(pkg, Statements(pkg, 5), 3))
            ok, err = pkg.validate_segment(seg)
            assert err is None and len(ok) == 3
            flipped = bytearray(seg.frames)
            flipped[12] ^= 0x40
            reasons = [
                pkg.validate_segment(dataclasses.replace(
                    seg, frames=seg.frames[: len(seg.frames) // 2]))[1],
                pkg.validate_segment(dataclasses.replace(seg, frames=bytes(flipped)))[1],
                pkg.validate_segment(dataclasses.replace(seg, first_seq=99))[1],
                pkg.validate_segment(dataclasses.replace(seg, last_seq=99))[1],
                pkg.validate_segment(dataclasses.replace(seg, frames=b""))[1],
            ]
            assert all(reasons)
            assert "CRC" in reasons[1] and "first_seq" in reasons[2]
            assert "last_seq" in reasons[3]
            return reasons

        twin(scenario, tmp_path)

    def test_applier_semantics(self, tmp_path):
        def scenario(pkg, _):
            stmts = Statements(pkg, 6)
            state = pkg.ServerState()
            applier = pkg.SegmentApplier(state, epoch=2)
            records = make_records(pkg, stmts, 4)
            notes = []
            accepted, _, new = applier.prepare(pkg.seal_segment(2, 0, records[:2]))
            assert accepted and len(new) == 2
            applier.commit(new)
            notes.append((applier.applied_seq, run(state.user_count())))
            accepted, msg, new = applier.prepare(pkg.seal_segment(2, 0, records[:2]))
            assert accepted and not new and "duplicate" in msg
            gap = pkg.seal_segment(2, 5, make_records(pkg, stmts, 1, start_seq=5))
            accepted, msg, _ = applier.prepare(gap)
            assert not accepted and "gap" in msg
            notes.append(msg)
            accepted, msg, _ = applier.prepare(pkg.seal_segment(1, 9, records[2:]))
            assert not accepted and "fenced" in msg and applier.fenced == 1
            notes.append(msg)
            accepted, _, new = applier.prepare(pkg.seal_segment(3, 1, records[2:]))
            assert accepted and applier.epoch == 3
            applier.commit(new)
            notes.append(run(state.user_count()))
            overlap = pkg.seal_segment(3, 2, make_records(pkg, stmts, 3, start_seq=3))
            accepted, _, new = applier.prepare(overlap)
            assert accepted and [r["seq"] for r in new] == [5]
            applier.commit(new)
            assert applier.records_skipped == 1 and applier.applied_seq == 5
            bad = pkg.seal_segment(3, 3, [
                {"seq": 6, "type": "register_user", "user_id": "bad user!",
                 "y1": "00", "y2": "00", "registered_at": 1},
            ])
            accepted, _, new = applier.prepare(bad)
            assert accepted
            applier.commit(new)
            assert applier.records_skipped == 2 and applier.applied_seq == 6
            notes.append((applier.segments_received, applier.segments_rejected,
                          applier.records_applied, applier.records_skipped))
            return notes

        twin(scenario, tmp_path)

    def test_epoch_file_roundtrip(self, tmp_path):
        def scenario(pkg, workdir):
            path = str(workdir / "node.epoch")
            out = [pkg.load_epoch(path)]
            pkg.store_epoch(path, 7)
            out.append(pkg.load_epoch(path))
            out.append(oct(os.stat(path).st_mode & 0o777))
            (workdir / "node.epoch").write_text("garbage")
            out.append(pkg.load_epoch(path))
            return out

        assert twin(scenario, tmp_path) == [1, 7, "0o600", 1]


# --- shipping + promotion over a real gRPC link -------------------------------------


class TestShipAndPromote:
    def test_sync_barrier_and_warm_standby(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 7)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _) = (
                await make_pair(pkg, workdir))
            try:
                for i in range(5):
                    await pstate.register_user(user(pkg, f"u{i}", stmts()))
                assert shipper.acked_seq == pmgr.wal.seq == replica.applied_seq
                assert replica.applier.records_applied == 5
                assert shipper.segments_shipped >= 1
                srecords, valid, total = pkg.read_frames(smgr.wal.path)
                assert valid == total
                with open(pmgr.wal.path, "rb") as f:
                    primary_bytes = f.read()
                with open(smgr.wal.path, "rb") as f:
                    standby_bytes = f.read()
                # the standby's own WAL holds the primary's frames verbatim
                assert standby_bytes == primary_bytes
                return ([r["seq"] for r in srecords], await sstate.user_count(),
                        replica.status()["role"], shipper.status()["lag_records"])
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)

        assert twin(scenario, tmp_path) == ([1, 2, 3, 4, 5], 5, "standby", 0)

    def test_promotion_on_lease_expiry_and_epoch_fencing(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 8)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport) = (
                await make_pair(pkg, workdir, lease_ms=300, renew_ms=30))
            try:
                await pstate.register_user(user(pkg, "alice", stmts()))
                assert replica.applied_seq == 1 and sserver.health.standby is True
                await shipper.kill()
                await wait_for(lambda: replica.role == "primary")
                notes = [replica.epoch, sserver.health.standby,
                         pkg.load_epoch(replica.epoch_path)]
                deposed = pkg.SegmentShipper(pstate, pmgr, pkg.ReplicationSettings(
                    enabled=True, role="primary", peer=f"127.0.0.1:{sport}",
                    lease_ms=300, renew_interval_ms=30))
                notes.append(deposed.epoch)
                pstate.attach_replication_barrier(None)
                await pstate.register_user(user(pkg, "evil", stmts()))
                deposed.start()
                await wait_for(lambda: deposed.fenced)
                notes.append(await sstate.get_user("evil") is None)
                assert replica.applier.fenced >= 1
                await deposed.kill()
                report = await replica.promote(reason="operator")
                notes.append((report["promoted"], report["message"]))
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)

        assert twin(scenario, tmp_path) == [2, False, 2, 1, True, (False, "already primary")]

    def test_pre_promote_crash_point_is_retryable(self, tmp_path):
        async def scenario(pkg, workdir):
            plan = pkg.FaultPlan().crash_on("pre_promote", occurrence=0)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _) = (
                await make_pair(pkg, workdir, standby_faults=plan, auto_promote=False))
            try:
                await pstate.register_user(user(pkg, "alice", Statements(pkg, 9)()))
                await shipper.kill()
                with pytest.raises(pkg.CrashPoint):
                    await replica.promote(reason="operator")
                notes = [replica.role, pkg.load_epoch(replica.epoch_path)]
                report = await replica.promote(reason="operator")
                notes += [report["promoted"], replica.epoch,
                          await sstate.get_user("alice") is not None]
                return notes
            finally:
                await replica.stop()
                await sserver.stop(None)

        assert twin(scenario, tmp_path) == ["standby", 1, True, 2, True]

    def test_sync_mode_refuses_to_ack_without_standby(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 10)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _) = (
                await make_pair(pkg, workdir))
            shipper.settings.sync_timeout_ms = 200.0
            await pstate.register_user(user(pkg, "ok", stmts()))
            await replica.stop()
            await sserver.stop(None)
            with pytest.raises(pkg.ReplicationTimeout) as exc:
                await pstate.register_user(user(pkg, "lost", stmts()))
            await shipper.kill()
            return re.sub(r"\(acked \d+\)", "", str(exc.value))

        twin(scenario, tmp_path)

    def test_restarted_primary_catches_up_against_warm_standby(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 11)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport) = (
                await make_pair(pkg, workdir))
            try:
                for i in range(3):
                    await pstate.register_user(user(pkg, f"u{i}", stmts()))
                applied_before = replica.applier.records_applied
                await shipper.kill()
                shipper2 = pkg.SegmentShipper(pstate, pmgr, pkg.ReplicationSettings(
                    enabled=True, role="primary", peer=f"127.0.0.1:{sport}",
                    lease_ms=400, renew_interval_ms=40, mode="sync"))
                pmgr.attach_shipper(shipper2)
                pstate.attach_replication_barrier(shipper2.wait_replicated)
                shipper2.start()
                await wait_for(lambda: shipper2.acked_offset == pmgr.wal.size)
                notes = [replica.applier.records_applied == applied_before,
                         replica.applied_seq]
                await pstate.register_user(user(pkg, "u3", stmts()))
                notes += [replica.applied_seq, await sstate.get_user("u3") is not None]
                await shipper2.kill()
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)

        assert twin(scenario, tmp_path) == [True, 3, 4, True]

    def test_compaction_clamped_to_standby_ack(self, tmp_path):
        class StalledShipper:
            def __init__(self):
                self.rebased = 0

            def safe_compact_offset(self):
                return 0

            def note_compacted(self, freed):
                self.rebased += freed

        class CaughtUpShipper(StalledShipper):
            def safe_compact_offset(self):
                return 10**9

        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 12)
            state = pkg.ServerState()
            mgr = pkg.DurabilityManager(
                state, pkg.DurabilitySettings(enabled=True, compact_bytes=0),
                str(workdir / "p.json"))
            await mgr.recover()
            stalled = StalledShipper()
            mgr.attach_shipper(stalled)
            for i in range(4):
                await state.register_user(user(pkg, f"u{i}", stmts()))
            size = mgr.wal.size
            await mgr.checkpoint()
            notes = [mgr.wal.size == size, stalled.rebased]
            caught = CaughtUpShipper()
            mgr.attach_shipper(caught)
            state._persist_dirty = True
            await mgr.checkpoint()
            notes += [mgr.wal.size, caught.rebased == size]
            return notes

        assert twin(scenario, tmp_path) == [True, 0, 0, True]


# --- config surface -----------------------------------------------------------------


def _config_layers(pkg, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    cfg = pkg.ServerConfig.from_env()
    notes = [(cfg.replication.enabled, cfg.replication.role, cfg.replication.mode)]
    (tmp_path / "server.toml").write_text(
        "state_file = 's.json'\n[durability]\nenabled = true\n"
        '[replication]\nenabled = true\nrole = "standby"\n'
        "lease_ms = 2000.0\nshards = 32\n")
    monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
    cfg = pkg.ServerConfig.from_env()
    cfg.validate()
    notes.append(dataclasses.asdict(cfg.replication))
    for key, value in (("ROLE", "PRIMARY"), ("PEER", "10.0.0.2:50051"), ("MODE", "SYNC"),
                       ("RENEW_INTERVAL_MS", "250"), ("AUTO_PROMOTE", "false"),
                       ("SEGMENT_BYTES", "1024"), ("SYNC_TIMEOUT_MS", "750"),
                       ("EPOCH_FILE", "/tmp/e"), ("SHARDS", "64")):
        monkeypatch.setenv(f"SERVER_REPLICATION_{key}", value)
    cfg = pkg.ServerConfig.from_env()
    cfg.validate()
    notes.append(dataclasses.asdict(cfg.replication))
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    return notes


VALIDATION_CASES = [
    ("role", lambda c: setattr(c.replication, "role", "observer"), "role"),
    ("mode", lambda c: setattr(c.replication, "mode", "eventual"), "mode"),
    ("renew0", lambda c: setattr(c.replication, "renew_interval_ms", 0.0),
     "renew_interval_ms"),
    ("lease-eq-renew", lambda c: setattr(c.replication, "lease_ms", 500.0) or
     setattr(c.replication, "renew_interval_ms", 500.0), "lease_ms"),
    ("lease-lt-renew", lambda c: setattr(c.replication, "lease_ms", 100.0) or
     setattr(c.replication, "renew_interval_ms", 500.0), "lease_ms"),
    ("segment0", lambda c: setattr(c.replication, "segment_bytes", 0), "segment_bytes"),
    ("sync-timeout0", lambda c: setattr(c.replication, "sync_timeout_ms", 0.0),
     "sync_timeout_ms"),
    ("shards0", lambda c: setattr(c.replication, "shards", 0), "shards"),
    ("shards257", lambda c: setattr(c.replication, "shards", 257), "shards"),
]


class TestReplicationConfig:
    def test_layering_env_precedence_and_validation(self, tmp_path, monkeypatch):
        notes = {}
        for pkg in BOTH:
            workdir = tmp_path / pkg.name
            workdir.mkdir()
            notes[pkg.name] = _config_layers(pkg, workdir, monkeypatch)
        assert notes["port"] == notes["reference"]
        assert notes["port"][2]["mode"] == "sync" and notes["port"][2]["shards"] == 64

    @pytest.mark.parametrize("name,mutate,match", VALIDATION_CASES,
                             ids=[c[0] for c in VALIDATION_CASES])
    def test_validation_rejects(self, name, mutate, match):
        errors = {}
        for pkg in BOTH:
            cfg = pkg.ServerConfig()
            mutate(cfg)
            with pytest.raises(ValueError, match=match) as exc:
                cfg.validate()
            errors[pkg.name] = str(exc.value)
        assert errors["port"] == errors["reference"]

    def test_enabled_requires_durability_and_peer(self):
        for pkg in BOTH:
            cfg = pkg.ServerConfig()
            cfg.replication.enabled = True
            with pytest.raises(ValueError, match="requires durability"):
                cfg.validate()
            cfg.state_file = "s.json"
            cfg.durability.enabled = True
            with pytest.raises(ValueError, match="peer"):
                cfg.validate()
            cfg.replication.peer = "10.0.0.2:50051"
            cfg.validate()
            cfg.replication.peer = ""
            cfg.replication.role = "standby"
            cfg.validate()
            # the port keeps ingest shards refused on a standby
            cfg.server.ingest_shards = 2
            with pytest.raises(ValueError, match="ingest_shards"):
                cfg.validate()

    def test_replication_config_keys_documented(self):
        keys = [f.name for f in dataclasses.fields(PORT.ReplicationSettings)]
        assert keys == [f.name for f in dataclasses.fields(REF.ReplicationSettings)]
        toml_text = (ROOT / "config" / "server.toml.example").read_text()
        m = re.search(r"^\[replication\]$", toml_text, re.M)
        assert m
        section = toml_text[m.end():].split("\n[", 1)[0]
        env_text = (ROOT / ".env.example").read_text()
        docs = (ROOT / "docs" / "operations.md").read_text()
        for key in keys:
            assert re.search(rf"^{key}\s*=", section, re.M), key
            assert f"SERVER_REPLICATION_{key.upper()}" in env_text, key
            assert f"`replication.{key}`" in docs, key

    def test_repl_commands(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 13)
            notes = [(await pkg.handle("/replication", pkg.ServerState()))[0],
                     (await pkg.handle("/promote", pkg.ServerState()))[0]]
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _) = (
                await make_pair(pkg, workdir, auto_promote=False))
            try:
                await pstate.register_user(user(pkg, "alice", stmts()))
                out, _ = await pkg.handle("/replication", pstate, durability=pmgr,
                                          replication=shipper)
                notes.append(re.sub(r" peer=\S+", "", out))
                out, _ = await pkg.handle("/replication", sstate, durability=smgr,
                                          replication=replica)
                notes.append(re.sub(r" lease=\S+", "", out))
                await shipper.kill()
                out, _ = await pkg.handle("/promote", sstate, durability=smgr,
                                          replication=replica)
                assert "PROMOTED" in out and "epoch=2" in out
                notes.append(out)
                notes.append((await pkg.handle("/promote", sstate, durability=smgr,
                                               replication=replica))[0])
                return notes
            finally:
                await replica.stop()
                await sserver.stop(None)

        notes = twin(scenario, tmp_path)
        assert "replication disabled" in notes[0] and "nothing to promote" in notes[1]
        assert "role=primary" in notes[2] and "acked_seq=1" in notes[2]
        assert "role=standby" in notes[3] and "applied_seq=1" in notes[3]
        assert "not promoted" in notes[5]


def test_shipped_frames_are_canonical(tmp_path):
    def scenario(pkg, _):
        records = make_records(pkg, Statements(pkg, 14), 3)
        frames = b"".join(pkg.encode_record(r) for r in records)
        parsed, valid = pkg.iter_frames(frames)
        assert valid == len(frames)
        assert b"".join(pkg.encode_record(r) for r in parsed) == frames
        return frames.hex()

    twin(scenario, tmp_path)


# --- segmented WAL under replication ------------------------------------------------


class TestSegmentedWalReplication:
    def test_shipping_promotion_and_clamp_across_segment_boundaries(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 15)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, mode="sync", wal_segment_bytes=600,
                                segment_bytes=700, auto_promote=False))
            try:
                kept = {}
                for i in range(30):
                    kept[i] = stmts()
                    await pstate.register_user(user(pkg, f"user-{i}", kept[i]))
                assert shipper.acked_seq == pmgr.wal.seq
                await asyncio.to_thread(pmgr.wal.sync, True)
                await asyncio.to_thread(smgr.wal.sync, True)
                notes = [pmgr.wal.segment_count > 0, await sstate.user_count()]
                pmgr.settings.compact_bytes = 0
                size_before = pmgr.wal.size
                await pmgr.checkpoint()
                notes += [pmgr.wal.size < size_before,
                          shipper.safe_compact_offset() <= pmgr.wal.size]
                await pstate.register_user(user(pkg, "user-99", stmts()))
                await wait_for(lambda: replica.applied_seq == pmgr.wal.seq)
                await shipper.kill()
                report = await replica.promote(reason="test")
                notes += [report["promoted"], await sstate.user_count()]
                for i in (0, 7, 29):
                    u = await sstate.get_user(f"user-{i}")
                    assert u is not None and u.statement == kept[i]
                await sstate.register_user(user(pkg, "post-promote", stmts()))
                notes.append(await sstate.user_count())
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        assert twin(scenario, tmp_path) == [True, 30, True, True, True, 31, 32]

    def test_standby_reboot_recovers_rotated_wal(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 16)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, mode="sync", wal_segment_bytes=500,
                                auto_promote=False))
            try:
                for i in range(20):
                    await pstate.register_user(user(pkg, f"user-{i}", stmts()))
                applied = replica.applied_seq
                assert applied == pmgr.wal.seq
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()
            sstate2 = pkg.ServerState()
            smgr2 = pkg.DurabilityManager(
                sstate2, pkg.DurabilitySettings(enabled=True, wal_segment_bytes=500),
                str(workdir / "standby.json"))
            report = await smgr2.recover()
            notes = [report.next_seq == applied, await sstate2.user_count()]
            smgr2.wal.close()
            return notes

        assert twin(scenario, tmp_path) == [True, 20]


# --- coordinated handover -----------------------------------------------------------


class TestCoordinatedHandover:
    def test_handover_end_to_end(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 17)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport) = (
                await make_pair(pkg, workdir, auto_promote=False))
            try:
                kept = {}
                for i in range(8):
                    kept[i] = stmts()
                    await pstate.register_user(user(pkg, f"user-{i}", kept[i]))
                report = await shipper.run_handover(reason="test")
                assert report["fence_seq"] == pmgr.wal.seq
                assert report["applied_seq"] >= report["fence_seq"]
                notes = [report["ok"], report["epoch"], replica.role, replica.epoch,
                         await sstate.user_count()]
                for i in (0, 3, 7):
                    u = await sstate.get_user(f"user-{i}")
                    assert u is not None and u.statement == kept[i]
                await sstate.register_user(user(pkg, "post-handover", stmts()))
                assert shipper.redirect_address == f"127.0.0.1:{sport}"
                st = shipper.handover_status()
                notes += [shipper.fenced, st["stage"], st["completed"], st["aborted"],
                          st["last_duration_s"] is not None]
                with pytest.raises(pkg.WrongPartition, match="handover"):
                    await pstate.register_user(user(pkg, "too-late", stmts()))
                notes.append(await pstate.get_user("user-0") is not None)
                with pytest.raises(pkg.HandoverError, match="fenced") as exc:
                    await shipper.run_handover()
                notes.append(str(exc.value))
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        assert twin(scenario, tmp_path)[:10] == [True, 2, "primary", 2, 8, True, "deposed",
                                                 1, 0, True]

    def test_stale_standby_aborts_and_primary_keeps_serving(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 18)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, mode="async", auto_promote=False))
            try:
                await pstate.register_user(user(pkg, "before", stmts()))
                await wait_for(lambda: shipper.acked_seq == pmgr.wal.seq)
                await replica.stop()
                await sserver.stop(None)
                await pstate.register_user(user(pkg, "unshipped", stmts()))
                with pytest.raises(pkg.HandoverError, match="stale standby"):
                    await shipper.run_handover(timeout_ms=400.0)
                st = shipper.handover_status()
                notes = [st["stage"], st["aborted"], st["completed"], shipper.fenced,
                         shipper.redirect_address]
                await pstate.register_user(user(pkg, "after-abort", stmts()))
                notes.append(await pstate.user_count())
                return notes
            finally:
                await shipper.kill()
                pmgr.wal.close()
                smgr.wal.close()

        assert twin(scenario, tmp_path) == ["aborted", 1, 0, False, None, 3]

    @pytest.mark.parametrize("point", [
        "pre_handover_fence",
        "post_handover_fence",
        "pre_handover_promote",
        "post_handover_promote",
    ])
    def test_primary_crash_at_every_stage_degrades_to_lease_failover(self, tmp_path, point):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 19)
            plan = pkg.FaultPlan().crash_on(point, occurrence=0)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, primary_faults=plan))
            try:
                for i in range(5):
                    await pstate.register_user(user(pkg, f"user-{i}", stmts()))
                with pytest.raises(pkg.CrashPoint):
                    await shipper.run_handover(reason="crash-test")
                notes = [shipper.handovers_aborted, await sstate.user_count()]
                if point == "post_handover_promote":
                    notes += [replica.role, replica.epoch, shipper.fenced,
                              shipper.handover_status()["stage"]]
                    with pytest.raises(pkg.WrongPartition):
                        await pstate.register_user(user(pkg, "forked", stmts()))
                    await sstate.register_user(user(pkg, "new-primary", stmts()))
                else:
                    notes += [replica.role, shipper.fenced, shipper.redirect_address,
                              shipper.handover_status()["stage"]]
                    await pstate.register_user(user(pkg, "still-primary", stmts()))
                    await wait_for(lambda: replica.applied_seq == pmgr.wal.seq)
                    await shipper.kill()
                    await wait_for(lambda: replica.role == "primary", timeout=10.0)
                    notes += [replica.epoch, await sstate.user_count()]
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        notes = twin(scenario, tmp_path)
        assert notes[:2] == [1, 5]

    def test_standby_crash_at_pre_handover_ack_then_retry_succeeds(self, tmp_path):
        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 20)
            plan = pkg.FaultPlan().crash_on("pre_handover_ack", occurrence=0)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, standby_faults=plan, auto_promote=False))
            try:
                for i in range(3):
                    await pstate.register_user(user(pkg, f"user-{i}", stmts()))
                with pytest.raises(grpc.RpcError):
                    await shipper.run_handover(reason="crash-test")
                notes = [replica.role, shipper.fenced,
                         shipper.handover_status()["stage"], shipper.handovers_aborted]
                await pstate.register_user(user(pkg, "between", stmts()))
                report = await shipper.run_handover(reason="retry")
                notes += [report["ok"], report["epoch"], replica.role,
                          await sstate.user_count()]
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        assert twin(scenario, tmp_path) == ["standby", False, "aborted", 1, True, 2,
                                            "primary", 4]

    def test_wire_initiate_and_rolling_restart_cli(self, tmp_path):
        from types import SimpleNamespace

        async def scenario(pkg, workdir):
            stmts = Statements(pkg, 21)
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport) = (
                await make_pair(pkg, workdir, auto_promote=False))
            pserver, pport = await pkg.serve(
                pstate, pkg.RateLimiter(100_000, 100_000), port=0, replica=shipper)
            try:
                for i in range(4):
                    await pstate.register_user(user(pkg, f"user-{i}", stmts()))
                mpath = workdir / "fleet.json"
                pkg.PartitionMap.uniform([f"127.0.0.1:{pport}"],
                                         standbys=[f"127.0.0.1:{sport}"]).store(str(mpath))
                rc = await pkg.roll_fleet(SimpleNamespace(map=str(mpath), timeout=15.0))
                flipped = pkg.PartitionMap.load(str(mpath))
                assert flipped.partitions[0].address == f"127.0.0.1:{sport}"
                assert flipped.partitions[0].standby == f"127.0.0.1:{pport}"
                doc = json.loads(mpath.read_text())
                return [rc, replica.role, replica.epoch, shipper.fenced, flipped.version,
                        doc["schema"], await sstate.user_count()]
            finally:
                await shipper.kill()
                await replica.stop()
                await pserver.stop(None)
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        assert twin(scenario, tmp_path) == [0, "primary", 2, True, 2,
                                            "cpzk-partition-map/2", 4]

    def test_deposed_primary_redirects_challenge_flow(self, tmp_path):
        async def scenario(pkg, workdir):
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport) = (
                await make_pair(pkg, workdir))
            pserver, pport = await pkg.serve(
                pstate, pkg.RateLimiter(100_000, 100_000), port=0, replica=shipper)
            stale = standby_cli = None
            try:
                stmts = Statements(pkg, 22)
                prover = stmts.prover()
                await pstate.register_user(user(pkg, "ho-user", prover.statement))
                await shipper.run_handover()
                stale = pkg.AuthClient(f"127.0.0.1:{pport}")
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await stale.create_challenge("ho-user")
                notes = [exc.value.code().name, exc.value.details().replace(
                    f"127.0.0.1:{sport}", "STANDBY")]
                tmd = {k: v for k, v in exc.value.trailing_metadata() or ()}
                assert tmd["cpzk-partition-owner"] == f"127.0.0.1:{sport}"
                standby_cli = pkg.AuthClient(f"127.0.0.1:{sport}")
                ch = await standby_cli.create_challenge("ho-user")
                cid = bytes(ch.challenge_id)
                t = pkg.Transcript()
                t.append_context(cid)
                proof = prover.prove_with_transcript(stmts.gen, t)
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await stale.verify_proof("ho-user", cid, proof.to_bytes())
                notes.append(exc.value.code().name)
                assert "handover in progress" in exc.value.details()
                resp = await standby_cli.verify_proof("ho-user", cid, proof.to_bytes())
                notes.append(resp.success)
                return notes
            finally:
                for c in (stale, standby_cli):
                    if c is not None:
                        await c.close()
                await shipper.kill()
                await replica.stop()
                await pserver.stop(None)
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        notes = twin(scenario, tmp_path)
        assert notes[0] == "FAILED_PRECONDITION" and "handover in progress" in notes[1]
        assert notes[2:] == ["FAILED_PRECONDITION", True]

    def test_handover_repl_command(self, tmp_path):
        async def scenario(pkg, workdir):
            notes = [(await pkg.handle("/handover", pkg.ServerState()))[0]]
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, auto_promote=False))
            try:
                await pstate.register_user(user(pkg, "alice", Statements(pkg, 23)()))
                notes.append((await pkg.handle("/handover", sstate, durability=smgr,
                                               replication=replica))[0])
                out, _ = await pkg.handle("/handover", pstate, durability=pmgr,
                                          replication=shipper)
                notes.append(re.sub(r"in \d+ms", "in Nms", out))
                notes.append(replica.role)
                notes.append((await pkg.handle("/handover", pstate, durability=pmgr,
                                               replication=shipper))[0])
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        notes = twin(scenario, tmp_path)
        assert "nothing to hand over" in notes[0] and "nothing to hand over" in notes[1]
        assert "HANDOVER complete" in notes[2] and "epoch=2" in notes[2]
        assert notes[3] == "primary" and "ABORTED" in notes[4]

    def test_statusz_handover_block(self, tmp_path):
        async def scenario(pkg, workdir):
            (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _p) = (
                await make_pair(pkg, workdir, auto_promote=False))
            try:
                src = pkg.OpsSources(state=pstate, replication=shipper)
                doc = src.statusz()
                notes = [doc["handover"]["stage"], doc["handover"]["attempts"]]
                await shipper.run_handover(reason="test")
                doc = src.statusz()
                notes += [doc["handover"]["stage"], doc["handover"]["completed"],
                          pkg.OpsSources(state=sstate, replication=replica
                                         ).statusz()["handover"]]
                return notes
            finally:
                await shipper.kill()
                await replica.stop()
                await sserver.stop(None)
                pmgr.wal.close()
                smgr.wal.close()

        assert twin(scenario, tmp_path) == ["idle", 0, "deposed", 1, None]


# --- twins of tests/test_chaos.py's replication cases ---------------------------------


async def make_served_pair(pkg, tmp_path, lease_ms=400.0, renew_ms=40.0, mode="sync",
                           primary_faults=None):
    """``tests/test_chaos.py``'s ``_make_repl_pair``: both sides serving
    real gRPC, ``fsync = "always"``."""
    (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport) = await make_pair(
        pkg, tmp_path, lease_ms=lease_ms, renew_ms=renew_ms, mode=mode,
        primary_faults=primary_faults)
    pserver, pport = await pkg.serve(pstate, pkg.RateLimiter(100_000, 100_000), port=0)
    return ((pstate, pmgr, shipper, pserver, pport),
            (sstate, smgr, replica, sserver, sport))


async def await_role(replica, role, timeout=5.0):
    deadline = time.monotonic() + timeout
    while replica.role != role:
        assert time.monotonic() < deadline, f"standby never became {role}"
        await asyncio.sleep(0.02)


def test_kill_primary_promote_login_zero_acknowledged_loss(tmp_path):
    """The failover acceptance scenario, end to end over real gRPC."""

    async def scenario(pkg, workdir):
        pside, sside = await make_served_pair(pkg, workdir, lease_ms=400, renew_ms=40)
        pstate, pmgr, shipper, pserver, pport = pside
        sstate, smgr, replica, sserver, sport = sside
        try:
            async with pkg.AuthClient(f"127.0.0.1:{pport}") as c:
                assert "Registered" in await pkg.do_register(c, "alice", "pw-a")
                out = await pkg.do_login(c, "alice", "pw-a")
                assert "Login OK" in out
                pre_crash_token = out.split("session: ")[1].strip()
                assert "Registered" in await pkg.do_register(c, "bob", "pw-b")
            assert replica.applied_seq == pmgr.wal.seq
            notes = [replica.applied_seq]
            hst = pkg.load_health_pb2().HealthCheckResponse.ServingStatus
            async with pkg.AuthClient(f"127.0.0.1:{sport}") as c:
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c.create_challenge("alice")
                notes += [exc.value.code().name, exc.value.details()]
                notes.append((await c.health_check(service="readiness")).status
                             == hst.NOT_SERVING)
                notes.append((await c.health_check()).status == hst.SERVING)
            t0 = time.monotonic()
            await shipper.kill()
            await pserver.stop(None)
            await await_role(replica, "primary")
            assert time.monotonic() - t0 < 5.0
            notes.append(replica.epoch)
            async with pkg.AuthClient(f"127.0.0.1:{sport}") as c:
                notes.append((await c.health_check(service="readiness")).status
                             == hst.SERVING)
                notes.append("Login OK" in await pkg.do_login(c, "alice", "pw-a"))
                notes.append("Login OK" in await pkg.do_login(c, "bob", "pw-b"))
                notes.append("Login OK" in await pkg.do_login(c, "alice", "wrong"))
            notes.append(await sstate.validate_session(pre_crash_token))
            deposed = pkg.SegmentShipper(pstate, pmgr, pkg.ReplicationSettings(
                enabled=True, role="primary", peer=f"127.0.0.1:{sport}",
                lease_ms=400, renew_interval_ms=40))
            pstate.attach_replication_barrier(None)
            await pstate.register_user(user(pkg, "fork", Statements(pkg, 30)()))
            fenced_before = replica.applier.fenced
            deposed.start()
            await wait_for(lambda: deposed.fenced)
            notes += [replica.applier.fenced > fenced_before,
                      await sstate.get_user("fork") is None]
            await deposed.kill()
            return notes
        finally:
            await shipper.kill()
            await replica.stop()
            await sserver.stop(None)

    notes = twin(scenario, tmp_path)
    assert notes[1:] == ["UNAVAILABLE",
                         "standby replica: not promoted (writes go to the primary)",
                         True, True, 2, True, True, True, False, "alice", True, True]


@pytest.mark.parametrize("point,occurrence,expect_applied", [
    ("pre_ship", 0, 0),
    ("mid_segment", 1, 1),
])
def test_promotion_after_ship_crash_points(tmp_path, point, occurrence, expect_applied):
    async def scenario(pkg, workdir):
        stmts = Statements(pkg, 31)
        plan = pkg.FaultPlan().crash_on(point, occurrence=occurrence)
        pside, sside = await make_served_pair(pkg, workdir, lease_ms=300, renew_ms=30,
                                              mode="async", primary_faults=plan)
        pstate, pmgr, shipper, pserver, pport = pside
        sstate, smgr, replica, sserver, sport = sside
        try:
            await wait_for(lambda: replica.lease_remaining_s is not None, interval=0.01)
            await pstate.register_user(user(pkg, "u0", stmts()))
            if occurrence > 0:
                await wait_for(lambda: replica.applied_seq >= 1, interval=0.01)
                await pstate.register_user(user(pkg, "u1", stmts()))
            await wait_for(lambda: shipper.crashed is not None, interval=0.01)
            await pserver.stop(None)
            await await_role(replica, "primary")
            notes = [replica.applied_seq]
            if point == "mid_segment":
                notes += [replica.applier.segments_rejected >= 1,
                          await sstate.get_user("u0") is not None,
                          await sstate.get_user("u1") is None]
            else:
                notes.append(await sstate.user_count())
            return notes
        finally:
            await shipper.kill()
            await replica.stop()
            await sserver.stop(None)

    notes = twin(scenario, tmp_path)
    assert notes[0] == expect_applied
    assert notes[1:] == ([True, True, True] if point == "mid_segment" else [0])


_REPL_KILL_CHILD = """
import asyncio, sys
sys.path.insert(0, {root!r})

from cpzk_tpu_torch.client.kdf import password_to_scalar
from cpzk_tpu_torch import Parameters, Prover, Witness
from cpzk_tpu_torch.durability import DurabilityManager
from cpzk_tpu_torch.replication import SegmentShipper
from cpzk_tpu_torch.server.config import DurabilitySettings, ReplicationSettings
from cpzk_tpu_torch.server.state import ServerState, UserData

async def main():
    port = int(sys.argv[1])
    state = ServerState()
    mgr = DurabilityManager(
        state, DurabilitySettings(enabled=True, fsync="always"), {state_file!r},
    )
    await mgr.recover()
    settings = ReplicationSettings(
        enabled=True, role="primary", peer="127.0.0.1:%d" % port,
        lease_ms=800, renew_interval_ms=40, mode="sync",
    )
    shipper = SegmentShipper(state, mgr, settings)
    mgr.attach_shipper(shipper)
    state.attach_replication_barrier(shipper.wait_replicated)
    shipper.start()
    params = Parameters.new()
    i = 0
    while True:
        uid = "user-%04d" % i
        st = Prover(params, Witness(password_to_scalar("pw-" + uid, uid))).statement
        await state.register_user(UserData(uid, st, 1))
        # returned: locally fsynced AND standby-applied (sync mode)
        print("ACK " + uid, flush=True)
        i += 1

asyncio.run(main())
"""


@pytest.mark.slow
def test_sigkill_primary_two_process_failover_zero_loss(tmp_path):
    """The twin of the reference's two-process failover on the port: the
    port's primary is a separate OS process registering users over sync
    replication, SIGKILLed mid-traffic; the port's in-parent standby
    promotes on lease expiry, holds every acknowledged write, and serves a
    full login for a pre-kill user."""
    pkg = PORT
    script = _REPL_KILL_CHILD.format(root=str(ROOT),
                                     state_file=str(tmp_path / "primary.json"))

    async def main():
        sstate = pkg.ServerState()
        smgr = pkg.DurabilityManager(
            sstate, pkg.DurabilitySettings(enabled=True, fsync="always"),
            str(tmp_path / "standby.json"))
        await smgr.recover()
        replica = pkg.StandbyReplica(sstate, smgr, pkg.ReplicationSettings(
            enabled=True, role="standby", lease_ms=800, renew_interval_ms=40))
        sserver, sport = await pkg.serve(sstate, pkg.RateLimiter(100_000, 100_000),
                                         port=0, replica=replica)
        replica.start()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-u", "-c", script, str(sport),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE,
            cwd=str(ROOT))
        acked = []
        try:
            while len(acked) < 6:
                line = await asyncio.wait_for(proc.stdout.readline(), timeout=120)
                assert line, (await proc.stderr.read()).decode()
                if line.startswith(b"ACK "):
                    acked.append(line.split()[1].decode())
            proc.send_signal(signal.SIGKILL)
            await proc.wait()
            await await_role(replica, "primary", timeout=15.0)
            for uid in acked:
                assert await sstate.get_user(uid) is not None, uid
            async with pkg.AuthClient(f"127.0.0.1:{sport}") as c:
                uid = acked[len(acked) // 2]
                assert "Login OK" in await pkg.do_login(c, uid, "pw-" + uid)
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
            await replica.stop()
            await sserver.stop(None)

    run(main())


# --- the port's own contracts -----------------------------------------------------------

#: (crash point, occurrence, where it is armed): a primary death at each
#: site an acknowledgement passes through — the WAL append of a record,
#: the shipment of its segment
ZERO_LOSS_POINTS = [
    ("pre_append", 5, "wal"),
    ("mid_frame", 6, "wal"),
    ("post_append_pre_fsync", 7, "wal"),
    ("pre_ship", 3, "shipper"),
    ("mid_segment", 4, "shipper"),
]


@pytest.mark.parametrize("point,occurrence,armed", ZERO_LOSS_POINTS,
                         ids=[p[0] for p in ZERO_LOSS_POINTS])
def test_sync_pair_loses_no_acknowledged_write_at_crash_points(
        tmp_path, point, occurrence, armed):
    """A sync-mode pair under registrations, challenges and logins: the
    primary dies (a scheduled crash point, then its shipper is killed)
    part way; every registration, challenge and session it acknowledged
    is at the standby after promotion, and nothing it refused is."""

    async def scenario(pkg, workdir):
        stmts = Statements(pkg, 40)
        plan = pkg.FaultPlan().crash_on(point, occurrence=occurrence)
        (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _) = await make_pair(
            pkg, workdir, lease_ms=300, renew_ms=30,
            primary_faults=plan if armed == "shipper" else None)
        if armed == "wal":
            pmgr.wal._faults = plan
        acked = {"users": [], "challenges": [], "sessions": []}
        died = None
        try:
            for i in range(6):
                uid = f"u{i}"
                try:
                    await pstate.register_user(user(pkg, uid, stmts()))
                    acked["users"].append(uid)
                    cid = pstate.tag_challenge_id(uid, bytes([i]) * 32)
                    await pstate.create_challenge(uid, cid)
                    acked["challenges"].append(cid)
                    if i % 2:
                        await pstate.consume_challenge(cid)
                        acked["challenges"].remove(cid)
                        tok = pstate.tag_session_token(uid, f"{i:02x}" * 32)
                        await pstate.create_session(tok, uid)
                        acked["sessions"].append(tok)
                except (pkg.CrashPoint, pkg.ReplicationTimeout) as e:
                    died = type(e).__name__
                    break
            await shipper.kill()
            await await_role(replica, "primary")
            for uid in acked["users"]:
                assert await sstate.get_user(uid) is not None, uid
            for cid in acked["challenges"]:
                assert (await sstate.get_challenge(cid)) is not None, cid.hex()
            for tok in acked["sessions"]:
                assert await sstate.validate_session(tok) is not None
            return [died, {k: len(v) for k, v in acked.items()}]
        finally:
            await shipper.kill()
            await replica.stop()
            await sserver.stop(None)

    died, counts = twin(scenario, tmp_path)
    assert died is not None and counts["users"] >= 1


def test_register_batch_one_barrier_per_rpc_zero_loss(tmp_path):
    """``RegisterBatch`` under ``mode = "sync"``: the port syncs the WAL
    once per RPC, so it awaits the replication barrier once, on the RPC's
    last sequence number, before it answers; a primary death right after
    the answer loses none of the acknowledged entries."""
    pkg = PORT

    async def main():
        stmts = Statements(pkg, 41)
        (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, _) = await make_pair(
            pkg, tmp_path, lease_ms=300, renew_ms=30)
        calls = []

        async def barrier(seq):
            await shipper.wait_replicated(seq)
            calls.append((seq, replica.applied_seq))

        pstate.attach_replication_barrier(barrier)
        pserver, pport = await pkg.serve(pstate, pkg.RateLimiter(100_000, 100_000), port=0)
        eb = pkg.Ristretto255.element_to_bytes
        try:
            users = [f"batch-{i}" for i in range(12)]
            sts = [stmts() for _ in users]
            async with pkg.AuthClient(f"127.0.0.1:{pport}") as c:
                resp = await c.register_batch(users, [eb(s.y1) for s in sts],
                                              [eb(s.y2) for s in sts])
            assert all(r.success for r in resp.results)
            # one barrier, on the last record, met before the answer
            assert calls == [(pmgr.wal.seq, pmgr.wal.seq)] and pmgr.wal.seq == 12
            await shipper.kill()
            await pserver.stop(None)
            await await_role(replica, "primary")
            for uid, st in zip(users, sts):
                got = await sstate.get_user(uid)
                assert got is not None and got.statement == st
        finally:
            await shipper.kill()
            await replica.stop()
            await sserver.stop(None)

    run(main())


@pytest.mark.parametrize("order", ["shipper_first", "challenge_first"])
def test_compaction_takes_the_smaller_of_both_clamps(tmp_path, order):
    """With a shipper attached, compaction stops at the smaller of the
    standby's acknowledged offset and the oldest live challenge's record
    (the port's challenge pin), whichever comes first in the log; the
    challenge's record survives either way."""
    pkg = PORT

    class Shipper:
        def __init__(self, offset):
            self.offset = offset
            self.freed = 0

        def safe_compact_offset(self):
            return self.offset

        def note_compacted(self, freed):
            self.freed += freed

    async def main():
        stmts = Statements(pkg, 42)
        state = pkg.ServerState()
        mgr = pkg.DurabilityManager(
            state, pkg.DurabilitySettings(enabled=True, compact_bytes=0),
            str(tmp_path / "p.json"))
        await mgr.recover()
        for i in range(8):
            await state.register_user(user(pkg, f"u{i}", stmts()))
        pin = mgr.wal.size  # the challenge's record starts here
        cid = state.tag_challenge_id("u0", b"\x07" * 32)
        await state.create_challenge("u0", cid)
        await state.register_user(user(pkg, "u8", stmts()))
        size = mgr.wal.size
        offset = pin // 2 if order == "shipper_first" else size
        shipper = Shipper(offset)
        mgr.attach_shipper(shipper)
        await mgr.checkpoint()
        want = min(pin, offset)
        assert shipper.freed == want and mgr.wal.size == size - want
        mgr.wal.close()
        # a reboot from these files still holds the live challenge
        state2 = pkg.ServerState()
        await pkg.recover_state(state2, str(tmp_path / "p.json"), str(tmp_path / "p.json.wal"))
        assert await state2.get_challenge(cid) is not None
        assert await state2.user_count() == 9

    run(main())


# --- cross-package parity ---------------------------------------------------------------


def test_segments_sealed_by_either_package_are_byte_equal():
    records = make_records(REF, Statements(REF, 50), 9)
    out = {}
    for pkg in BOTH:
        segs = pkg.split_records([dict(r) for r in records], 3, 5, 500)
        single = pkg.seal_segment(3, 0, [dict(r) for r in records])
        out[pkg.name] = ([(s.epoch, s.index, s.first_seq, s.last_seq, s.sealed, s.crc,
                           s.frames) for s in segs],
                         (single.crc, single.frames))
        # each package validates the other's segments
        other = REF if pkg is PORT else PORT
        for seg in segs:
            got, err = other.validate_segment(seg)
            assert err is None and got == [r for r in records
                                           if seg.first_seq <= r["seq"] <= seg.last_seq]
    assert out["port"] == out["reference"]


@pytest.mark.parametrize("primary,standby", [("reference", "port"), ("port", "reference")])
def test_cross_package_primary_ships_to_standby(tmp_path, primary, standby):
    """A primary of one package ships to a standby of the other in
    process over gRPC; the standby's log holds the primary's bytes, and
    both directions promote to the same state."""
    pkgs = {p.name: p for p in BOTH}
    P, S = pkgs[primary], pkgs[standby]

    async def main():
        stmts = Statements(P, 51)
        sstate = S.ServerState()
        smgr = S.DurabilityManager(sstate, S.DurabilitySettings(enabled=True),
                                   str(tmp_path / "standby.json"))
        await smgr.recover()
        replica = S.StandbyReplica(sstate, smgr, S.ReplicationSettings(
            enabled=True, role="standby", lease_ms=300, renew_interval_ms=30))
        sserver, sport = await S.serve(sstate, S.RateLimiter(100_000, 100_000), port=0,
                                       replica=replica)
        replica.start()
        pstate = P.ServerState()
        pmgr = P.DurabilityManager(pstate, P.DurabilitySettings(enabled=True),
                                   str(tmp_path / "primary.json"))
        await pmgr.recover()
        shipper = P.SegmentShipper(pstate, pmgr, P.ReplicationSettings(
            enabled=True, role="primary", peer=f"127.0.0.1:{sport}", lease_ms=300,
            renew_interval_ms=30, mode="sync", segment_bytes=600))
        pmgr.attach_shipper(shipper)
        pstate.attach_replication_barrier(shipper.wait_replicated)
        shipper.start()
        try:
            for i in range(6):
                await pstate.register_user(P.UserData(f"x{i}", stmts(), 1))
            for i in range(3):
                cid = pstate.tag_challenge_id(f"x{i}", bytes([i + 1]) * 32)
                await pstate.create_challenge(f"x{i}", cid)
            await pstate.consume_challenge(pstate.tag_challenge_id("x0", b"\x01" * 32))
            await pstate.create_session(pstate.tag_session_token("x0", "ab" * 32), "x0")
            assert replica.applied_seq == pmgr.wal.seq
            with open(pmgr.wal.path, "rb") as f:
                pbytes = f.read()
            with open(smgr.wal.path, "rb") as f:
                sbytes = f.read()
            assert sbytes == pbytes
            await shipper.kill()
            await await_role(replica, "primary")
            eb = S.Ristretto255.element_to_bytes
            users = {}
            for uid in sorted(sstate._users):
                u = sstate._users[uid]
                users[uid] = (eb(u.statement.y1).hex(), eb(u.statement.y2).hex())
            return (replica.epoch, users, sorted(c.hex() for c in sstate._challenges),
                    sorted(sstate._sessions))
        finally:
            await shipper.kill()
            await replica.stop()
            await sserver.stop(None)

    got = run(main())
    assert got[0] == 2 and len(got[1]) == 6 and len(got[2]) == 2 and len(got[3]) == 1
    # the same statements promote to the same state in either direction
    (tmp_path / "again").mkdir()
    assert got[1:] == _reference_to_reference(tmp_path / "again")


def _reference_to_reference(tmp_path):
    """The state a reference standby holds after the same writes from a
    reference primary, without gRPC: the records applied through its
    ``SegmentApplier``."""
    stmts = Statements(REF, 51)
    st = REF.ServerState()

    async def writes():
        for i in range(6):
            await st.register_user(REF.UserData(f"x{i}", stmts(), 1))
        for i in range(3):
            await st.create_challenge(f"x{i}", st.tag_challenge_id(f"x{i}", bytes([i + 1]) * 32))
        await st.consume_challenge(st.tag_challenge_id("x0", b"\x01" * 32))
        await st.create_session(st.tag_session_token("x0", "ab" * 32), "x0")

    run(writes())
    eb = REF.Ristretto255.element_to_bytes
    users = {uid: (eb(st._users[uid].statement.y1).hex(), eb(st._users[uid].statement.y2).hex())
             for uid in sorted(st._users)}
    return (users, sorted(c.hex() for c in st._challenges), sorted(st._sessions))


# --- the daemon: python -m cpzk_tpu_torch.server as a pair ---------------------------------


def _pair_toml(workdir, role: str, peer: str = "", mode: str = "sync", lease_ms=3000.0,
               renew_ms=500.0, extra: str = "") -> str:
    return (f'state_file = "{workdir / "state.json"}"\n'
            '[tpu]\nbackend = "cpu"\n'
            "[rate_limit]\nrequests_per_minute = 1000000\nburst = 100000\n"
            "[opsplane]\nenabled = true\nport = 0\n"
            '[durability]\nenabled = true\nfsync = "always"\n'
            f'[replication]\nenabled = true\nrole = "{role}"\npeer = "{peer}"\n'
            f'mode = "{mode}"\nlease_ms = {lease_ms}\nrenew_interval_ms = {renew_ms}\n'
            + extra)


def _statusz(daemon) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{daemon.ops_port}/statusz",
                                timeout=10) as r:
        return json.loads(r.read())


def _wait_ops(daemon, timeout=30.0):
    deadline = time.monotonic() + timeout
    while daemon.ops_port is None:
        assert time.monotonic() < deadline, daemon.logs()[-3000:]
        daemon.wait_listening()
        time.sleep(0.05)
    return daemon


def test_daemon_pair_standby_refuses_and_sigterm_hands_over(tmp_path):
    """Two ``python -m cpzk_tpu_torch.server`` daemons as a sync pair: the
    standby refuses auth RPCs until promoted and applies every record the
    primary acknowledged; SIGTERM on the primary runs the coordinated
    handover (the standby promoted at epoch 2, the primary exits 0), and
    the promoted standby logs every user in."""
    from torch_daemon_harness import Daemon

    pkg = PORT
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    b = Daemon("port", b_dir, _pair_toml(b_dir, "standby"))
    a = None
    try:
        _wait_ops(b.wait_listening())
        a = Daemon("port", a_dir, _pair_toml(a_dir, "primary", f"127.0.0.1:{b.port}"))
        _wait_ops(a.wait_listening())

        async def before():
            async with pkg.AuthClient(f"127.0.0.1:{b.port}") as c:
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await c.create_challenge("alice")
                assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
                assert exc.value.details() == (
                    "standby replica: not promoted (writes go to the primary)")
            async with pkg.AuthClient(f"127.0.0.1:{a.port}") as c:
                for uid in ("alice", "bob", "carol"):
                    assert "Registered" in await pkg.do_register(c, uid, "pw-" + uid)
                assert "Login OK" in await pkg.do_login(c, "alice", "pw-alice")

        run(before())
        primary, standby = _statusz(a)["replication"], _statusz(b)["replication"]
        assert primary["role"] == "primary" and primary["mode"] == "sync"
        assert standby["role"] == "standby"
        assert standby["applied_seq"] == primary["wal_seq"] == primary["acked_seq"] > 0
        assert a.terminate(timeout=60) == 0
        assert "handover complete: standby promoted at epoch 2" in a.logs()
        doc = _statusz(b)
        assert doc["replication"]["role"] == "primary" and doc["replication"]["epoch"] == 2
        assert doc["health"]["ready"] is True

        async def after():
            async with pkg.AuthClient(f"127.0.0.1:{b.port}") as c:
                for uid in ("alice", "bob", "carol"):
                    assert "Login OK" in await pkg.do_login(c, uid, "pw-" + uid)

        run(after())
        assert b.terminate(timeout=60) == 0
    finally:
        for d in (a, b):
            if d is not None:
                d.kill()


def test_daemon_shutdown_ships_last_sealed_audit_segment(tmp_path):
    """The port's shutdown order: the listener stops, the proof log
    closes, and only then does the shipper's final flush tick run, so the
    proof-log segments the primary sealed while serving reach the standby
    byte for byte — here with no shipping tick between the logins and the
    stop (async mode, a 30 s cadence), so only the final flush ships
    them."""
    from torch_daemon_harness import Daemon

    pkg = PORT
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"
    slow = dict(mode="async", lease_ms=60000.0, renew_ms=30000.0)
    b = Daemon("port", b_dir, _pair_toml(b_dir, "standby", **slow),
               env={"SERVER_AUDIT_LOG_PATH": str(b_dir / "proofs.log")})
    a = None
    try:
        _wait_ops(b.wait_listening())
        a = Daemon("port", a_dir, _pair_toml(a_dir, "primary", f"127.0.0.1:{b.port}", **slow),
                   env={"SERVER_AUDIT_ENABLED": "1",
                        "SERVER_AUDIT_LOG_PATH": str(a_dir / "proofs.log"),
                        "SERVER_AUDIT_SEGMENT_BYTES": "600"})
        _wait_ops(a.wait_listening())

        async def logins():
            async with pkg.AuthClient(f"127.0.0.1:{a.port}") as c:
                for i in range(4):
                    assert "Registered" in await pkg.do_register(c, f"u{i}", "pw")
                    for _ in range(2):
                        assert "Login OK" in await pkg.do_login(c, f"u{i}", "pw")

        run(logins())
        sealed = sorted(p.name for p in a_dir.glob("proofs.log.*.seg"))
        assert len(sealed) >= 2
        assert _statusz(a)["replication"]["audit_segments_shipped"] == 0
        a.proc.send_signal(signal.SIGINT)  # a plain stop: no handover
        assert a.wait_exit(60) == 0
        assert "handover" not in a.logs()
        shipped = sorted(p.name for p in b_dir.glob("proofs.log.*.seg"))
        assert shipped == sealed
        for name in sealed:
            assert (b_dir / name).read_bytes() == (a_dir / name).read_bytes()
        assert _statusz(b)["replication"]["audit_segments_received"] == len(sealed)
        assert b.terminate(timeout=60) == 0
    finally:
        for d in (a, b):
            if d is not None:
                d.kill()


def test_daemon_promoted_standby_audit_trail_follows_the_primary(tmp_path):
    """Both daemons of a sync pair with ``[audit] enabled``: the primary's
    sealed proof-log segments ship to the standby, a SIGTERM hands the
    partition over, and the promoted standby's own verdicts continue the
    shipped trail, so its directory replays as one whole log from seq 1
    (the port's departure: the reference's standby writer would number
    from 1 again over the shipped segments)."""
    from cpzk_tpu_torch.audit.pipeline import run_audit
    from torch_daemon_harness import Daemon

    pkg = PORT
    a_dir, b_dir = tmp_path / "a", tmp_path / "b"

    def audit_env(d):
        return {"SERVER_AUDIT_ENABLED": "1", "SERVER_AUDIT_LOG_PATH": str(d / "proofs.log"),
                "SERVER_AUDIT_SEGMENT_BYTES": "600"}

    b = Daemon("port", b_dir, _pair_toml(b_dir, "standby"), env=audit_env(b_dir))
    a = None
    try:
        _wait_ops(b.wait_listening())
        a = Daemon("port", a_dir, _pair_toml(a_dir, "primary", f"127.0.0.1:{b.port}"),
                   env=audit_env(a_dir))
        _wait_ops(a.wait_listening())
        users = [f"u{i}" for i in range(4)]

        async def logins(port, register):
            async with pkg.AuthClient(f"127.0.0.1:{port}") as c:
                for uid in users:
                    if register:
                        assert "Registered" in await pkg.do_register(c, uid, "pw")
                    for _ in range(2):
                        assert "Login OK" in await pkg.do_login(c, uid, "pw")

        run(logins(a.port, True))
        sealed = sorted(p.name for p in a_dir.glob("proofs.log.*.seg"))
        assert len(sealed) >= 2
        deadline = time.monotonic() + 30
        while _statusz(a)["replication"]["audit_segments_shipped"] < len(sealed):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        shipped_last = int(re.search(r"-(\d+)\.seg$", sealed[-1]).group(1))
        assert _statusz(b)["audit"]["seq"] == 0
        assert a.terminate(timeout=60) == 0
        assert "handover complete: standby promoted at epoch 2" in a.logs()
        assert f"audit_seq={shipped_last}" in b.logs()
        run(logins(b.port, False))
        last = _statusz(b)["audit"]["seq"]
        assert last == shipped_last + 2 * len(users)
        assert b.terminate(timeout=60) == 0
        for name in sealed:
            assert (b_dir / name).read_bytes() == (a_dir / name).read_bytes()
        report = run_audit(str(b_dir), str(tmp_path / "report.json"), backend="cpu")
        assert (report["log"]["first_seq"], report["log"]["last_seq"]) == (1, last)
        assert report["log"]["valid_bytes"] == report["log"]["file_bytes"]
        t = report["totals"]
        assert t["records"] == t["audited"] == t["verified"] == last
        assert t["mismatched"] == t["skipped"] == 0
    finally:
        for d in (a, b):
            if d is not None:
                d.kill()


_CPU_LAUNCHER = (
    "import asyncio, sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from cpzk_tpu_torch.server.__main__ import amain, parse_args\n"
    "asyncio.run(amain(parse_args(sys.argv[1:]), device='cpu'))\n"
)


def test_replication_phase_rehearsal(tmp_path, monkeypatch):
    """The ``replication`` phase of ``chip_smoke.py`` through its
    ``launcher`` seam, on the kernels' plain versions: four daemons, 160
    users, 48 logins in RPCs of 10, 16 challenges at C with the SIGKILL
    after 8, 2 KiB proof-log segments, and a lease and sync timeout that
    CPU cores shared with other tests keep (6 s, 20 s); the phase's own
    checks (exact
    verdicts, one redirect for the one-partition client, the standbys'
    refusals and applied sequence numbers, the handover at epoch 2 with A
    exiting 0 and its sealed segments at B, every acknowledged challenge
    logged in at the promoted D, the promoted standbys' waves, and their
    proof logs replaying as one trail after their primaries') must hold."""
    import runpy

    import torch

    monkeypatch.chdir(tmp_path)  # the daemons' logs land in ./chiprun_out
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke_rehearsal")
    _, corpus, provers = smoke["make_corpus"](16, smoke["SeededRng"](1))
    # The two trail replays run in this process on the plain ladders, whose
    # ops (lanes padded to 2048) are wide enough for torch's intra-op pool.
    # A pool of one thread per core, on cores the other test workers keep
    # busy, waits at every op's join for descheduled threads: under the
    # suite's load one replay took 391 s against 19 s on one thread.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = smoke["replication_phase"](
            corpus, provers, 160, 48, 10, 16, 8, lease_ms=6000.0, audit_segment_bytes=2048,
            sync_timeout_ms=20000.0, launcher=[sys.executable, "-c", _CPU_LAUNCHER],
            on_card=False)
    finally:
        torch.set_num_threads(threads)
    assert out["register"]["users"] == 160 and out["wave"]["entries"] == 48
    assert out["wave"]["sessions"] == out["wave"]["valid"]
    assert out["stale_map_client"] == {"success": True, "redirects": 1, "map_version": 3}
    for pair in ("ab", "cd"):
        assert out["applied"][pair]["applied_seq"] == out["applied"][pair]["wal_seq"] > 0
    planned = out["planned"]
    assert planned["exit_code"] == 0 and planned["b_epoch"] == 2
    assert planned["b_holds"] == planned["a_acknowledged"]
    seg = planned["audit_segments"]
    assert seg["a"] == seg["b"] == seg["byte_equal"] >= 1
    unplanned = out["unplanned"]
    assert unplanned["acked"] >= 8 and unplanned["exit_code"] < 0
    assert unplanned["d_epoch"] == 2 and unplanned["logins"]["sessions"] == unplanned["acked"] - 1
    for name in ("b", "d"):
        assert out["promoted"][name]["sessions"] == out["promoted"][name]["valid"]
        assert out["promoted"][name]["failover"] == 0
    assert out["sheds_by_tier"]["verify"] == 0
    for name in ("b", "d"):
        trail = out["promoted_trails"][name]
        assert trail["whole"] and trail["first_seq"] == 1 and trail["shipped_last_seq"] >= 1
        assert trail["last_seq"] == trail["shipped_last_seq"] + trail["own_records"]
        assert trail["totals"]["mismatched"] == 0
    assert (tmp_path / "chiprun_out" / "daemon_repl_d.log").exists()
