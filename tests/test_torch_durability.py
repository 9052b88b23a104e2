"""Twins of ``tests/test_durability.py`` for the port's durability subsystem
(``cpzk_tpu_torch/durability/``): the write-ahead log, crash recovery and
``DurabilityManager``, with the WAL crash points of the port's
``FaultPlan``.

Every case runs one scenario on the reference package and then on the
port, on the same seeded statements (numpy), each in a directory of its
own, and requires equal observations; the reference test's assertions
hold inside the scenario on both sides.  The WAL files the two packages
write from the same mutations are compared byte for byte where the
records carry no wall-clock time; so are the proof logs of
``TestFormatVersionStamps::test_proof_log_stamped_and_refuses_newer``.

Beyond the twins: a log and snapshot written by either package recover in
the other to the same users, sessions and challenges; the port's daemon
is SIGKILLed mid-traffic with ``fsync = "always"`` and every acknowledged
registration recovers; and ``chip_smoke.py``'s ``durable_daemon`` phase is
rehearsed at 48 logins on the kernels' plain versions.
"""

import asyncio
import dataclasses
import inspect
import json
import os
import pathlib
import re
import runpy
import shutil
import sys
import time
import types

import numpy as np
import pytest

import cpzk_tpu as J
import cpzk_tpu.durability as j_dur
import cpzk_tpu.durability.wal as j_wal
import cpzk_tpu.resilience.faults as j_faults
import cpzk_tpu.server.__main__ as j_main
import cpzk_tpu.server.config as j_config
import cpzk_tpu.server.metrics as j_metrics
import cpzk_tpu.server.state as j_state
import cpzk_tpu_torch as T
import cpzk_tpu_torch.durability as t_dur
import cpzk_tpu_torch.durability.wal as t_wal
import cpzk_tpu_torch.resilience.faults as t_faults
import cpzk_tpu_torch.server.__main__ as t_main
import cpzk_tpu_torch.server.config as t_config
import cpzk_tpu_torch.server.metrics as t_metrics
import cpzk_tpu_torch.server.state as t_state
from torch_daemon_harness import Daemon

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _pkg(name, top, dur, wal, faults, metrics, state, config, main, service_mod,
         serve_kw):
    return types.SimpleNamespace(
        name=name, Parameters=top.Parameters, Prover=top.Prover, Witness=top.Witness,
        Ristretto255=top.Ristretto255, Transcript=top.Transcript, dur=dur, wal=wal,
        FaultPlan=faults.FaultPlan, CrashPoint=faults.CrashPoint, metrics=metrics,
        st=state, cfg=config, main=main, service=service_mod, serve_kw=serve_kw,
        top_name=top.__name__,
    )


def _ref():
    import cpzk_tpu.server.service as svc

    return _pkg("reference", J, j_dur, j_wal, j_faults, j_metrics, j_state, j_config,
                j_main, svc, {})


def _port():
    import cpzk_tpu_torch.server.service as svc
    from cpzk_tpu_torch.protocol.batch import CpuBackend

    # the port's serve() with no backend means the card: ask for the host
    return _pkg("port", T, t_dur, t_wal, t_faults, t_metrics, t_state, t_config,
                t_main, svc, {"backend": CpuBackend()})


REF, PORT = _ref(), _port()


def run(coro):
    return asyncio.run(coro)


class SeededRng:
    """The ``fill_bytes`` source both packages' ``random_scalar`` read."""

    def __init__(self, seed: int):
        self._gen = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._gen.bytes(n)


def make_statement(pkg, seed: int):
    gen = SeededRng(seed)
    witness = pkg.Witness(pkg.Ristretto255.random_scalar(gen))
    return pkg.Prover(pkg.Parameters.new(), witness).statement


def twin(scenario, tmp_path, *args):
    """``scenario(pkg, workdir, *args)`` on the reference, then on the port
    (each in a directory of its own); the port's notes must equal the
    reference's.  Returns the port's."""
    notes = {}
    for pkg in (REF, PORT):
        workdir = tmp_path / pkg.name
        workdir.mkdir()
        out = scenario(pkg, workdir, *args)
        if inspect.iscoroutine(out):
            out = run(out)
        notes[pkg.name] = out
    assert notes["port"] == notes["reference"]
    return notes["port"]


def make_manager(pkg, workdir, plan=None, **settings):
    state = pkg.st.ServerState()
    cfg = pkg.cfg.DurabilitySettings(enabled=True, **settings)
    mgr = pkg.dur.DurabilityManager(state, cfg, str(workdir / "state.json"), faults=plan)
    return state, mgr


async def register(pkg, state, i, stmt=None):
    stmt = stmt if stmt is not None else make_statement(pkg, 1000 + i)
    await state.register_user(pkg.st.UserData(f"u{i}", stmt, 100 + i))


def eb(pkg, element) -> bytes:
    return pkg.Ristretto255.element_to_bytes(element)


def dump_state(pkg, state) -> dict:
    """Users (statement bytes), sessions and challenges of a state, as
    plain values comparable across the packages."""
    return {
        "users": sorted((uid, eb(pkg, u.statement.y1), eb(pkg, u.statement.y2),
                         u.registered_at) for uid, u in state._users.items()),
        "sessions": sorted((tok, s.user_id, s.created_at, s.expires_at)
                           for tok, s in state._sessions.items()),
        "challenges": sorted((bytes(cid), c.user_id, c.created_at, c.expires_at)
                             for cid, c in state._challenges.items()),
    }


def report_fields(report) -> dict:
    out = dataclasses.asdict(report)
    for key in ("snapshot_quarantined", "wal_quarantined"):
        out[key] = out[key] is not None
    return out


# --- WAL unit behavior ------------------------------------------------------


def test_wal_frame_roundtrip_and_torn_tail(tmp_path):
    def scenario(pkg, d):
        path = str(d / "log.wal")
        wal = pkg.dur.WriteAheadLog(path, fsync="always")
        s1 = wal.append("register_user", {"user_id": "a"})
        s2 = wal.append("create_session", {"token": "t"})
        assert (s1, s2) == (1, 2)
        wal.close()
        assert os.stat(path).st_mode & 0o777 == 0o600
        records, valid, total = pkg.dur.read_frames(path)
        assert valid == total == os.path.getsize(path)
        assert [r["type"] for r in records] == ["register_user", "create_session"]
        raw = open(path, "rb").read()
        frame1_end = len(pkg.dur.encode_record(records[0]))
        cuts = []
        for cut in (frame1_end + 1, frame1_end + 7, len(raw) - 1):
            got, v = pkg.dur.iter_frames(raw[:cut])
            assert [r["seq"] for r in got] == [1] and v == frame1_end
            cuts.append(v)
        flipped = bytearray(raw)
        flipped[frame1_end + 12] ^= 0x40
        got, v = pkg.dur.iter_frames(bytes(flipped))
        assert [r["seq"] for r in got] == [1] and v == frame1_end
        dup = raw + pkg.dur.encode_record({"seq": 2, "type": "register_user"})
        got, v = pkg.dur.iter_frames(dup)
        assert [r["seq"] for r in got] == [1, 2] and v == len(raw)
        return raw, records, cuts

    raw, _, _ = twin(scenario, tmp_path)
    # the bytes on disk are the reference's, frame for frame
    assert raw == (tmp_path / "reference" / "log.wal").read_bytes()


def test_wal_fsync_policies(tmp_path):
    def scenario(pkg, d):
        notes = []
        always = pkg.dur.WriteAheadLog(str(d / "a.wal"), fsync="always")
        base = pkg.metrics.read("state.wal.fsyncs")
        always.append("register_user", {})
        notes.append((always.needs_sync(), always.sync()))
        notes.append(pkg.metrics.read("state.wal.fsyncs") - base)
        notes.append(always.needs_sync())
        always.close()
        off = pkg.dur.WriteAheadLog(str(d / "b.wal"), fsync="off")
        off.append("register_user", {})
        notes.append((off.needs_sync(), off.sync(), off.sync(force=True)))
        off.close()
        iv = pkg.dur.WriteAheadLog(str(d / "c.wal"), fsync="interval",
                                   fsync_interval_ms=10_000.0)
        iv.append("register_user", {})
        notes.append((iv.needs_sync(), iv.sync(), iv.pending))
        iv._last_fsync -= 11.0
        notes.append((iv.needs_sync(), iv.sync()))
        iv.close()
        with pytest.raises(ValueError, match="fsync policy") as exc:
            pkg.dur.WriteAheadLog(str(d / "d.wal"), fsync="sometimes")
        notes.append(str(exc.value))
        return notes

    notes = twin(scenario, tmp_path)
    assert notes[:3] == [(True, True), 1.0, False]
    assert notes[3] == (False, False, True)
    assert notes[4] == (False, False, 1) and notes[5] == (True, True)


def test_journal_logs_every_acknowledged_mutation(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        await register(pkg, state, 0)
        await state.create_session("tok", "u0")
        await state.revoke_session("tok")
        await state.create_session("tok2", "u0")
        state._sessions["dead"] = pkg.st.SessionData(
            token="dead", user_id="u0", created_at=1, expires_at=2)
        state._user_sessions.setdefault("u0", []).append("dead")
        assert await state.cleanup_expired_sessions() == 1
        mgr.wal.close()
        records = pkg.dur.read_frames(mgr.wal_path)[0]
        sess = records[1]
        assert sess["token"] == "tok" and sess["user_id"] == "u0"
        assert sess["expires_at"] - sess["created_at"] == pkg.st.SESSION_EXPIRY_SECONDS
        return [(r["seq"], r["type"]) for r in records], records[0]

    seqs, first = twin(scenario, tmp_path)
    assert seqs == [(1, "register_user"), (2, "create_session"), (3, "revoke_session"),
                    (4, "create_session"), (5, "expire_sessions")]
    assert first["user_id"] == "u0" and first["registered_at"] == 100


# --- recovery ---------------------------------------------------------------


def test_recovery_replays_only_suffix_beyond_snapshot(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        stmts = {i: make_statement(pkg, i) for i in range(4)}
        for i in range(2):
            await register(pkg, state, i, stmts[i])
        assert await mgr.checkpoint() is True
        for i in range(2, 4):
            await register(pkg, state, i, stmts[i])
        await state.create_session("tok", "u3")
        base = pkg.metrics.read("state.recovery.replayed")
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        assert report.snapshot_loaded and (report.users, report.sessions) == (2, 0)
        assert report.covered_seq == 2 and report.replayed == 3
        assert pkg.metrics.read("state.recovery.replayed") == base + 3
        for i in range(4):
            u = await state2.get_user(f"u{i}")
            assert u is not None and u.statement == stmts[i]
        assert await state2.validate_session("tok") == "u3"
        assert json.load(open(mgr2.state_file))["wal_seq"] == 2
        return report_fields(report), dump_state(pkg, state2)["users"]

    report, _ = twin(scenario, tmp_path)
    assert report["skipped"] == 0 and report["truncated_bytes"] == 0


@pytest.mark.parametrize("point", ["pre_append", "mid_frame", "post_append_pre_fsync"])
def test_crash_point_recovers_exactly_the_acknowledged_prefix(tmp_path, point):
    acked = 3

    async def scenario(pkg, d):
        plan = pkg.FaultPlan().crash_on(point, occurrence=acked)
        state, mgr = make_manager(pkg, d, plan=plan)
        await mgr.recover()
        for i in range(acked):
            await register(pkg, state, i)
        with pytest.raises(pkg.CrashPoint):
            await register(pkg, state, acked)
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        for i in range(acked):
            assert await state2.get_user(f"u{i}") is not None
        extra = await state2.get_user(f"u{acked}") is not None
        if point == "mid_frame":
            assert report.truncated_bytes > 0 and not extra
            assert os.path.getsize(mgr2.wal_path) == pkg.dur.read_frames(mgr2.wal_path)[1]
        elif point == "pre_append":
            assert report.truncated_bytes == 0 and not extra
        else:
            assert report.truncated_bytes == 0
        await register(pkg, state2, 90)
        state3, mgr3 = make_manager(pkg, d)
        await mgr3.recover()
        assert await state3.get_user("u90") is not None
        return report_fields(report), extra, (d / "state.json.wal").read_bytes()

    twin(scenario, tmp_path)


def test_crash_pre_rename_leaves_compaction_all_or_nothing(tmp_path):
    async def scenario(pkg, d):
        plan = pkg.FaultPlan().crash_on("pre_rename", occurrence=0)
        state, mgr = make_manager(pkg, d, plan=plan, compact_bytes=0)
        await mgr.recover()
        for i in range(3):
            await register(pkg, state, i)
        size_before = mgr.wal.size
        with pytest.raises(pkg.CrashPoint):
            await mgr.checkpoint()
        assert os.path.getsize(mgr.wal_path) == size_before
        state2, mgr2 = make_manager(pkg, d, compact_bytes=0)
        await mgr2.recover()
        assert await state2.user_count() == 3
        await register(pkg, state2, 3)
        await mgr2.checkpoint()
        assert os.path.getsize(mgr2.wal_path) == 0
        state3, mgr3 = make_manager(pkg, d)
        report = await mgr3.recover()
        assert await state3.user_count() == 4 and report.replayed == 0
        return size_before, report_fields(report)

    twin(scenario, tmp_path)


def test_compaction_triggers_past_size_threshold(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d, compact_bytes=10_000)
        await mgr.recover()
        for i in range(4):
            await register(pkg, state, i)
        await mgr.checkpoint()
        under = mgr.wal.size
        assert under > 0
        for i in range(4, 60):
            await register(pkg, state, i)
        over = mgr.wal.size
        assert over > 10_000
        await mgr.checkpoint()
        assert mgr.wal.size == 0
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        assert await state2.user_count() == 60 and report.replayed == 0
        return under, over

    twin(scenario, tmp_path)


def test_shutdown_close_truncates_covered_wal(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        for i in range(5):
            await register(pkg, state, i)
        assert mgr.wal.size > 0
        await mgr.close()
        assert os.path.getsize(mgr.wal_path) == 0
        with pytest.raises(OSError, match="closed"):
            mgr.wal.append("register_user", {})
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        assert await state2.user_count() == 5 and report.replayed == 0
        return report_fields(report)

    twin(scenario, tmp_path)


# --- quarantine paths -------------------------------------------------------


def test_unreadable_wal_quarantined_boots_from_snapshot(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        for i in range(3):
            await register(pkg, state, i)
        await mgr.checkpoint()
        mgr.wal.close()
        with open(mgr.wal_path, "wb") as f:
            f.write(b"\xff" * 64)
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        assert report.wal_quarantined is not None and os.path.exists(report.wal_quarantined)
        assert ".corrupt-" in report.wal_quarantined
        assert os.stat(report.wal_quarantined).st_mode & 0o777 == 0o600
        assert await state2.user_count() == 3
        await register(pkg, state2, 3)
        assert pkg.dur.read_frames(mgr2.wal_path)[0][0]["type"] == "register_user"
        return report_fields(report)

    twin(scenario, tmp_path)


def test_corrupt_snapshot_quarantined_boots_from_wal(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        for i in range(3):
            await register(pkg, state, i)
        await state.create_session("tok", "u1")
        await mgr.checkpoint()
        mgr.wal.close()
        doc = open(mgr.state_file).read()
        with open(mgr.state_file, "w") as f:
            f.write(doc[: len(doc) // 2])
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        assert report.snapshot_quarantined is not None and not report.snapshot_loaded
        assert re.search(r"\.corrupt-\d+", report.snapshot_quarantined)
        assert os.stat(report.snapshot_quarantined).st_mode & 0o777 == 0o600
        assert report.replayed == 4
        assert await state2.user_count() == 3
        assert await state2.validate_session("tok") == "u1"
        return report_fields(report)

    twin(scenario, tmp_path)


def test_corrupt_snapshot_without_durability_quarantines_not_crashloops(
        tmp_path, monkeypatch):
    def scenario(pkg, d):
        monkeypatch.chdir(d)  # no stray config/server.toml pickup
        path = d / "state.json"
        path.write_text('{"version": 1, "users": {"bad user!": ')
        os.chmod(path, 0o600)
        cfg = pkg.cfg.ServerConfig()
        cfg.state_file = str(path)

        async def main():
            state, durability = await pkg.main.load_state(cfg)
            assert durability is None
            assert await state.user_count() == 0
            assert not path.exists()
            corrupt = [p for p in d.iterdir() if ".corrupt-" in p.name]
            assert len(corrupt) == 1
            assert os.stat(corrupt[0]).st_mode & 0o777 == 0o600
            return len(corrupt)

        return run(main())

    twin(scenario, tmp_path)


def test_load_state_with_durability_end_to_end(tmp_path, monkeypatch):
    def scenario(pkg, d):
        monkeypatch.chdir(d)
        cfg = pkg.cfg.ServerConfig()
        cfg.state_file = str(d / "state.json")
        cfg.durability.enabled = True
        cfg.validate()

        async def main():
            state, durability = await pkg.main.load_state(cfg)
            assert durability is not None and durability.wal is not None
            await register(pkg, state, 0)
            state2, durability2 = await pkg.main.load_state(cfg)
            assert await state2.user_count() == 1
            seq = json.load(open(cfg.state_file))["wal_seq"]
            assert seq == durability2.wal.seq
            return seq, dump_state(pkg, state2)

        return run(main())

    twin(scenario, tmp_path)


# --- replay validation ------------------------------------------------------


def test_replay_rejects_what_the_rpc_would(tmp_path):
    def scenario(pkg, d):
        st = pkg.st.ServerState()
        good = make_statement(pkg, 5)
        y1, y2 = eb(pkg, good.y1).hex(), eb(pkg, good.y2).hex()
        ok = st.replay_journal_record({
            "seq": 1, "type": "register_user", "user_id": "alice",
            "y1": y1, "y2": y2, "registered_at": 5})
        assert ok is None and "alice" in st._users
        cases = [
            ({"seq": 2, "type": "register_user", "user_id": "bad user!",
              "y1": y1, "y2": y2, "registered_at": 1}, "invalid characters"),
            ({"seq": 3, "type": "register_user", "user_id": "eve",
              "y1": "00" * 32, "y2": y2, "registered_at": 1}, "identity"),
            ({"seq": 4, "type": "register_user", "user_id": "alice",
              "y1": y1, "y2": y2, "registered_at": 1}, "already registered"),
            ({"seq": 5, "type": "create_session", "token": "t",
              "user_id": "nobody", "created_at": 10, "expires_at": 20}, "unregistered"),
            ({"seq": 6, "type": "create_session", "token": "t",
              "user_id": "alice", "created_at": 10, "expires_at": 10 ** 9}, "expiry"),
            ({"seq": 7, "type": "revoke_session", "token": "ghost"}, "not found"),
            ({"seq": 8, "type": "mint_money", "amount": 1}, "unknown record"),
            ({"seq": 9, "type": "register_user"}, "malformed"),
            ({"seq": 10, "type": "register_user", "user_id": "mallory",
              "y1": "zz", "y2": y2, "registered_at": 1}, "malformed"),
            ({"seq": 11, "type": "create_challenge", "challenge_id": "aa" * 32,
              "user_id": "nobody", "created_at": 10, "expires_at": 20}, "unregistered"),
            ({"seq": 12, "type": "create_challenge", "challenge_id": "aa" * 32,
              "user_id": "alice", "created_at": 10, "expires_at": 10 ** 9}, "expiry"),
            ({"seq": 13, "type": "consume_challenge", "challenge_id": "bb" * 32},
             "not found"),
            ({"seq": 14, "type": "create_challenge", "challenge_id": "zz",
              "user_id": "alice", "created_at": 10, "expires_at": 20}, "malformed"),
        ]
        messages = []
        for rec, needle in cases:
            msg = st.replay_journal_record(rec)
            assert msg is not None and needle in msg, (rec, msg)
            messages.append(msg)
        assert list(st._users) == ["alice"] and not st._sessions
        return messages

    twin(scenario, tmp_path)


def test_replayed_expiry_sweep_matches_original(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        await register(pkg, state, 0)
        await state.create_session("live", "u0")
        state._sessions["dead"] = pkg.st.SessionData(
            token="dead", user_id="u0", created_at=1, expires_at=2)
        state._user_sessions["u0"].append("dead")
        await state.cleanup_expired_sessions()
        state2, mgr2 = make_manager(pkg, d)
        await mgr2.recover()
        assert await state2.validate_session("live") == "u0"
        assert "dead" not in state2._sessions
        return sorted(state2._sessions)

    twin(scenario, tmp_path)


def test_session_expiry_has_clock_skew_guard(tmp_path):
    def scenario(pkg, d):
        now = int(time.time())
        ttl = pkg.st.SESSION_EXPIRY_SECONDS
        skewed = pkg.st.SessionData(token="t", user_id="u", created_at=now - 2 * ttl,
                                    expires_at=now + 1000)
        fresh = pkg.st.SessionData(token="t", user_id="u")
        return (ttl, skewed.is_expired(), fresh.is_expired(),
                fresh.is_expired(now + ttl + 1), fresh.is_expired(now + 10))

    assert twin(scenario, tmp_path)[1:] == (True, False, True, False)


# --- config + drift guard ---------------------------------------------------


def test_durability_config_layering_and_validation(tmp_path, monkeypatch):
    def scenario(pkg, d):
        monkeypatch.chdir(d)
        for key in list(os.environ):
            if key.startswith("SERVER_"):
                monkeypatch.delenv(key)
        monkeypatch.setenv("SERVER_CONFIG_PATH", str(d / "none.toml"))
        cfg = pkg.cfg.ServerConfig.from_env()
        notes = [(cfg.durability.enabled, cfg.durability.fsync)]
        (d / "server.toml").write_text(
            '[durability]\nenabled = true\nfsync = "interval"\ncompact_bytes = 4096\n')
        monkeypatch.setenv("SERVER_CONFIG_PATH", str(d / "server.toml"))
        monkeypatch.setenv("SERVER_STATE_FILE", str(d / "s.json"))
        cfg = pkg.cfg.ServerConfig.from_env()
        notes.append(dataclasses.asdict(cfg.durability))
        cfg.validate()
        monkeypatch.setenv("SERVER_DURABILITY_FSYNC", "OFF")
        monkeypatch.setenv("SERVER_DURABILITY_FSYNC_INTERVAL_MS", "125")
        monkeypatch.setenv("SERVER_DURABILITY_WAL_PATH", "/tmp/x.wal")
        notes.append(dataclasses.asdict(pkg.cfg.ServerConfig.from_env().durability))
        for key in ("SERVER_DURABILITY_FSYNC", "SERVER_DURABILITY_FSYNC_INTERVAL_MS",
                    "SERVER_DURABILITY_WAL_PATH", "SERVER_STATE_FILE"):
            monkeypatch.delenv(key)
        for field, value, match in (("enabled", True, "requires state_file"),
                                    ("fsync", "sometimes", "durability.fsync"),
                                    ("compact_bytes", -1, "compact_bytes")):
            bad = pkg.cfg.ServerConfig()
            setattr(bad.durability, field, value)
            with pytest.raises(ValueError, match=match) as exc:
                bad.validate()
            notes.append(str(exc.value))
        return notes

    notes = twin(scenario, tmp_path)
    assert notes[0] == (False, "always")
    assert notes[1]["fsync"] == "interval" and notes[1]["compact_bytes"] == 4096
    assert (notes[2]["fsync"], notes[2]["fsync_interval_ms"], notes[2]["wal_path"]) == (
        "off", 125.0, "/tmp/x.wal")


def test_durability_config_keys_documented():
    """The port's ``[durability]`` keys are the reference's, so the
    reference's drift guard (TOML example, .env example, operations-doc
    knob inventory) covers them."""
    keys = [f.name for f in dataclasses.fields(t_config.DurabilitySettings)]
    assert keys == [f.name for f in dataclasses.fields(j_config.DurabilitySettings)]
    assert dataclasses.asdict(t_config.DurabilitySettings()) == dataclasses.asdict(
        j_config.DurabilitySettings())
    toml_text = (ROOT / "config" / "server.toml.example").read_text()
    m = re.search(r"^\[durability\]$", toml_text, re.M)
    assert m
    section = toml_text[m.end():].split("\n[", 1)[0]
    env_text = (ROOT / ".env.example").read_text()
    docs = (ROOT / "docs" / "operations.md").read_text()
    for key in keys:
        assert re.search(rf"^{key}\s*=", section, re.M), key
        assert f"SERVER_DURABILITY_{key.upper()}" in env_text, key
        assert f"`durability.{key}`" in docs, key


def test_persist_repl_command(tmp_path):
    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        off, quit_ = await pkg.main.handle_command("/persist", state, None, None)
        assert "durability disabled" in off and not quit_
        await register(pkg, state, 0)
        await mgr.checkpoint()
        out, quit_ = await pkg.main.handle_command("/persist", state, None, mgr)
        assert not quit_
        assert f"seq={mgr.wal.seq}" in out and f"covered_seq={mgr.covered_seq}" in out
        assert "fsync=always" in out and "last_fsync_age=" in out
        assert "snapshot_age=" in out and "n/a" not in out
        assert pkg.metrics.read("state.snapshot.age_seconds", "g") >= 0.0
        out = out.replace(str(d), "<dir>")
        return off, re.sub(r"age=[0-9.]+s", "age=<s>", out)

    off, out = twin(scenario, tmp_path)
    assert out.startswith("wal=<dir>/state.json.wal bytes=")


# --- over gRPC (the reference's client against each package's server) --------


def test_grpc_crash_recovery_without_any_snapshot(tmp_path):
    from cpzk_tpu.client import AuthClient
    from cpzk_tpu.client.__main__ import do_login, do_register

    async def scenario(pkg, d):
        limiter = pkg.cfg.RateLimiter(1000, 1000)
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        server, port = await pkg.service.serve(state, limiter, port=0, **pkg.serve_kw)
        async with AuthClient(f"127.0.0.1:{port}") as c:
            assert "Registered" in await do_register(c, "carol", "pw-carol")
            assert "Login OK" in await do_login(c, "carol", "pw-carol")
        await server.stop(None)
        assert not os.path.exists(mgr.state_file)
        state2, mgr2 = make_manager(pkg, d)
        report = await mgr2.recover()
        assert report.replayed >= 2
        assert await state2.session_count() == 1
        server2, port2 = await pkg.service.serve(state2, pkg.cfg.RateLimiter(1000, 1000),
                                                 port=0, **pkg.serve_kw)
        async with AuthClient(f"127.0.0.1:{port2}") as c:
            again = "Login OK" in await do_login(c, "carol", "pw-carol")
            wrong = "Login OK" in await do_login(c, "carol", "wrong")
        await server2.stop(None)
        assert again and not wrong
        return report.replayed, report.covered_seq

    twin(scenario, tmp_path)


def test_crash_mid_login_recovers_inflight_challenge(tmp_path):
    from cpzk_tpu.client import AuthClient
    from cpzk_tpu.client.__main__ import do_register
    from cpzk_tpu.client.kdf import password_to_scalar

    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d)
        await mgr.recover()
        server, port = await pkg.service.serve(state, pkg.cfg.RateLimiter(1000, 1000),
                                               port=0, **pkg.serve_kw)
        async with AuthClient(f"127.0.0.1:{port}") as c:
            assert "Registered" in await do_register(c, "carol", "pw-carol")
            cid = bytes((await c.create_challenge("carol")).challenge_id)
        assert await mgr.checkpoint() is True
        await server.stop(None)
        types_ = [r["type"] for r in pkg.dur.read_frames(mgr.wal_path)[0]]
        assert "create_challenge" in types_
        state2, mgr2 = make_manager(pkg, d)
        await mgr2.recover()
        assert await state2.challenge_count() == 1
        server2, port2 = await pkg.service.serve(state2, pkg.cfg.RateLimiter(1000, 1000),
                                                 port=0, **pkg.serve_kw)
        async with AuthClient(f"127.0.0.1:{port2}") as c:
            prover = J.Prover(J.Parameters.new(), J.Witness(password_to_scalar("pw-carol", "carol")))
            t = J.Transcript()
            t.append_context(cid)
            proof = prover.prove_with_transcript(J.SecureRng(), t)
            resp = await c.verify_proof("carol", cid, proof.to_bytes())
            assert resp.success and resp.session_token
        await server2.stop(None)
        state3, mgr3 = make_manager(pkg, d)
        await mgr3.recover()
        assert await state3.challenge_count() == 0
        assert await state3.session_count() == 1
        for m in (mgr3, mgr2, mgr):
            m.wal.close()
        return types_, resp.message

    twin(scenario, tmp_path)


# --- the real thing: SIGKILL the port's daemon mid-traffic ---------------------


def test_sigkill_mid_traffic_recovers_every_acknowledged_write(tmp_path):
    """The port's daemon (``amain``, ``fsync = "always"``) registers users
    over gRPC until it is SIGKILLed mid-traffic; then both packages'
    recovery of the files it left finds every acknowledged registration,
    no torn record, and the same state."""
    import grpc

    from cpzk_tpu.client import AuthClient

    state_file = tmp_path / "daemon" / "state.json"
    toml = (f'state_file = "{state_file}"\n'
            '[tpu]\nbackend = "cpu"\n'
            "[rate_limit]\nrequests_per_minute = 1000000\nburst = 100000\n"
            '[durability]\nenabled = true\nfsync = "always"\n')
    stmts = [make_statement(REF, 2000 + i) for i in range(64)]
    acked: list[str] = []
    daemon = Daemon("port", tmp_path / "daemon", toml).wait_listening()
    try:
        async def traffic():
            in_flight = asyncio.Semaphore(8)
            async with AuthClient(f"127.0.0.1:{daemon.port}") as client:
                async def one(i, st):
                    async with in_flight:
                        if daemon.proc.poll() is not None:
                            return
                        try:
                            resp = await client.register(
                                f"user-{i:04d}", eb(REF, st.y1), eb(REF, st.y2))
                        except grpc.RpcError:
                            return
                    assert resp.success, resp.message
                    acked.append(f"user-{i:04d}")  # the response arrived: acknowledged
                    if len(acked) == 24:
                        daemon.kill()  # SIGKILL, no grace, with RPCs in flight

                await asyncio.gather(*[one(i, st) for i, st in enumerate(stmts)])

        run(traffic())
    finally:
        daemon.kill()
    assert 24 <= len(acked) < len(stmts), acked

    dumps = {}
    for pkg in (REF, PORT):
        d = tmp_path / f"boot-{pkg.name}"
        shutil.copytree(state_file.parent, d)

        async def reboot(pkg=pkg, d=d):
            state = pkg.st.ServerState()
            mgr = pkg.dur.DurabilityManager(
                state, pkg.cfg.DurabilitySettings(enabled=True), str(d / "state.json"))
            report = await mgr.recover()
            for uid in acked:
                assert await state.get_user(uid) is not None, (uid, report)
            records, valid, total = pkg.dur.read_frames(mgr.wal_path)
            assert valid == total
            for uid in state._users:
                assert re.fullmatch(r"user-\d{4}", uid)
            mgr.wal.close()
            return dump_state(pkg, state), report_fields(report)

        dumps[pkg.name] = run(reboot())
    assert dumps["port"] == dumps["reference"]


def _batch_wires(stmts):
    return ([eb(REF, st.y1) for st in stmts], [eb(REF, st.y2) for st in stmts])


def test_register_batch_syncs_once_per_rpc(tmp_path):
    """``RegisterBatch`` with ``fsync = "always"`` on both packages: the same
    answers (a malformed entry and re-registrations among them) and the
    same WAL records, ``registered_at`` aside.  The port syncs the journal
    once per RPC that registered anyone, the reference once per registered
    entry (the departure in ROADMAP section C)."""
    from cpzk_tpu.client import AuthClient

    stmts = [make_statement(REF, 3000 + i) for i in range(12)]
    y1s, y2s = _batch_wires(stmts)
    y1s[2] = b""  # refused before the state: no record, no sync
    batches = [range(0, 8), range(4, 12), range(4, 8)]

    async def scenario(pkg, d):
        state, mgr = make_manager(pkg, d, fsync="always")
        await mgr.recover()
        server, port = await pkg.service.serve(state, pkg.cfg.RateLimiter(1000, 1000),
                                               port=0, **pkg.serve_kw)
        answers, syncs = [], []
        async with AuthClient(f"127.0.0.1:{port}") as c:
            for idx in batches:
                before = pkg.metrics.read("state.wal.fsyncs")
                resp = await c.register_batch([f"u{i}" for i in idx],
                                              [y1s[i] for i in idx], [y2s[i] for i in idx])
                syncs.append(pkg.metrics.read("state.wal.fsyncs") - before)
                answers.append([(r.success, r.message) for r in resp.results])
        await server.stop(None)
        records = [{k: v for k, v in rec.items() if k != "registered_at"}
                   for rec in pkg.dur.read_frames(mgr.wal_path)[0]]
        mgr.wal.close()
        return answers, records, syncs

    notes = {}
    for pkg in (REF, PORT):
        (tmp_path / pkg.name).mkdir()
        notes[pkg.name] = run(scenario(pkg, tmp_path / pkg.name))
    answers, records, _ = notes["port"]
    assert (answers, records) == notes["reference"][:2]
    assert [sum(ok for ok, _ in a) for a in answers] == [7, 4, 0]
    assert [r["user_id"] for r in records] == [f"u{i}" for i in (0, 1, *range(3, 12))]
    assert notes["port"][2] == [1.0, 1.0, 0.0]
    assert notes["reference"][2] == [7.0, 4.0, 0.0]


def test_register_batch_sigkill_after_answer_recovers_every_entry(tmp_path):
    """The port's daemon (``fsync = "always"``) answers one ``RegisterBatch``
    and is SIGKILLed the moment the answer arrives: both packages' recovery
    of the files it left finds every acknowledged entry, and no other."""
    from cpzk_tpu.client import AuthClient

    state_file = tmp_path / "daemon" / "state.json"
    toml = (f'state_file = "{state_file}"\n'
            '[tpu]\nbackend = "cpu"\n'
            '[durability]\nenabled = true\nfsync = "always"\n')
    stmts = [make_statement(REF, 4000 + i) for i in range(32)]
    y1s, y2s = _batch_wires(stmts)
    y2s[5] = b"\x01" * 32  # not a canonical point: refused
    uids = [f"user-{i:04d}" for i in range(32)]
    daemon = Daemon("port", tmp_path / "daemon", toml).wait_listening()
    try:
        async def one_batch():
            async with AuthClient(f"127.0.0.1:{daemon.port}") as client:
                resp = await client.register_batch(uids, y1s, y2s)
            daemon.kill()  # SIGKILL, no grace, as soon as the answer is in
            return resp

        resp = run(one_batch())
    finally:
        daemon.kill()
    acked = {uid for uid, r in zip(uids, resp.results) if r.success}
    assert acked == set(uids) - {uids[5]}

    for pkg in (REF, PORT):
        d = tmp_path / f"boot-{pkg.name}"
        shutil.copytree(state_file.parent, d)

        async def reboot(pkg=pkg, d=d):
            state, mgr = make_manager(pkg, d)
            report = await mgr.recover()
            mgr.wal.close()
            return set(state._users), report

        users, report = run(reboot())
        assert users == acked, (pkg.name, report)
        assert report.replayed == len(acked) and not report.wal_quarantined


def _compaction_past_a_live_challenge(segment_bytes):
    async def scenario(pkg, d):
        """A challenge acknowledged before a compaction whose snapshot covers
        its record, then a crash (no close)."""
        state, mgr = make_manager(pkg, d, compact_bytes=0, wal_segment_bytes=segment_bytes)
        await mgr.recover()
        for i in range(12):
            await register(pkg, state, i)
        await state.create_challenge("u3", b"\x07" * 32)
        for i in range(12, 16):
            await register(pkg, state, i)
        before = mgr.wal.size
        assert await mgr.checkpoint() is True
        assert mgr.covered_seq == mgr.wal.seq == 17
        held = dump_state(pkg, state)
        after = mgr.wal.size
        mgr.wal.close()
        state2, mgr2 = make_manager(pkg, d, compact_bytes=0, wal_segment_bytes=segment_bytes)
        await mgr2.recover()
        recovered = dump_state(pkg, state2)
        return state2, mgr2, held, recovered, before, after

    return scenario


@pytest.mark.parametrize("segment_bytes", [0, 500], ids=["single_file", "segmented"])
def test_compaction_keeps_live_challenge_across_crash(tmp_path, segment_bytes):
    """Snapshots hold no challenges, so the port's compaction stops at the
    oldest live challenge's create_challenge record: a challenge
    acknowledged before a compaction survives a crash after it, and logs
    in.  The reference's compaction drops the record and loses the
    challenge (the departure in ROADMAP section C).  Once the challenge is
    consumed, the next sweep compacts the rest."""
    scenario = _compaction_past_a_live_challenge(segment_bytes)
    ref = tmp_path / "reference"
    ref.mkdir()
    state, mgr, held, recovered, _, after = run(scenario(REF, ref))
    mgr.wal.close()
    assert len(held["challenges"]) == 1 and recovered["challenges"] == []
    assert after == 0

    port = tmp_path / "port"
    port.mkdir()

    async def port_side():
        state, mgr, held, recovered, before, after = await scenario(PORT, port)
        assert recovered == held and len(held["challenges"]) == 1
        # the prefix before the record went, the record and what follows stayed
        assert 0 < after < before
        assert "create_challenge" in [r["type"] for r in PORT.dur.read_frames(mgr.wal_path)[0]
                                      + [r for seg in t_wal.wal_sealed_segments(mgr.wal_path)
                                         for r in PORT.dur.read_frames(seg)[0]]]
        assert state.oldest_challenge_record() == 0  # replayed: pins the recovered log
        assert await state.consume_challenge(b"\x07" * 32)
        await register(PORT, state, 16)
        assert await mgr.checkpoint() is True
        assert mgr.wal.size == 0 and state.oldest_challenge_record() is None
        mgr.wal.close()

    run(port_side())


# --- one log, both packages ----------------------------------------------------------


async def _write_history(pkg, d):
    """A daemon's state history on ``pkg``: registrations, a covering
    snapshot, then (past it) more registrations, sessions, a revoke and
    challenges created and consumed, left uncompacted as a crash leaves
    them (no close).  Returns the writer's own view of the state."""
    state, mgr = make_manager(pkg, d, compact_bytes=1 << 30)
    await mgr.recover()
    for i in range(6):
        await register(pkg, state, i)
    await state.create_session("tok-a", "u0")
    await state.create_challenge("u1", b"\x01" * 32)
    assert await mgr.checkpoint() is True
    for i in range(6, 12):
        await register(pkg, state, i)
    await state.create_sessions([("tok-b", "u7"), ("tok-c", "u8")])
    await state.revoke_session("tok-a")
    for k in range(2, 6):
        await state.create_challenge(f"u{k}", bytes([k]) * 32)
    assert await state.consume_challenges([b"\x01" * 32, b"\x03" * 32]) != [None, None]
    mgr.wal.sync(True)
    return dump_state(pkg, state)


async def _recover(pkg, d):
    state, mgr = make_manager(pkg, d)
    report = await mgr.recover()
    mgr.wal.close()
    return dump_state(pkg, state), report_fields(report)


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_history_recovers_in_the_other_package(tmp_path, writer, reader):
    """A WAL and snapshot written by one package's state recover in the
    other to the users, sessions and challenges the writer holds — and to
    what the writer's own recovery finds."""
    pkgs = {"reference": REF, "port": PORT}
    written = tmp_path / "written"
    written.mkdir()
    held = run(_write_history(pkgs[writer], written))
    assert len(held["users"]) == 12 and len(held["sessions"]) == 2
    assert len(held["challenges"]) == 3
    dumps = {}
    for side in (writer, reader):
        d = tmp_path / f"read-{side}"
        shutil.copytree(written, d)
        dumps[side] = run(_recover(pkgs[side], d))
    assert dumps[reader] == dumps[writer]
    assert dumps[reader][0] == held
    assert dumps[reader][1]["snapshot_loaded"] and dumps[reader][1]["replayed"] > 0
    assert not dumps[reader][1]["wal_quarantined"]


# --- segmented WAL -------------------------------------------------------------------


class TestSegmentedWal:
    def test_rotation_recovery_compaction_roundtrip(self, tmp_path):
        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d, wal_segment_bytes=500, compact_bytes=0)
            await mgr.recover()
            stmts = {i: make_statement(pkg, i) for i in range(40)}
            for i in range(40):
                await register(pkg, state, i, stmts[i])
            segments = mgr.wal.segment_count
            assert segments > 3
            names = [os.path.basename(p) for p in pkg.wal.wal_sealed_segments(mgr.wal_path)]
            assert names == sorted(names)
            state2, mgr2 = make_manager(pkg, d, wal_segment_bytes=500, compact_bytes=0)
            report = await mgr2.recover()
            assert report.replayed == 40 and await state2.user_count() == 40
            for i in (0, 17, 39):
                u = await state2.get_user(f"u{i}")
                assert u is not None and u.statement == stmts[i]
            await mgr2.checkpoint()
            assert mgr2.wal.size == 0 and mgr2.wal.segment_count == 0
            assert pkg.wal.wal_sealed_segments(mgr2.wal_path) == []
            await register(pkg, state2, 40)
            await mgr2.close()
            state3, mgr3 = make_manager(pkg, d, wal_segment_bytes=500)
            report3 = await mgr3.recover()
            assert await state3.user_count() == 41 and report3.replayed == 0
            mgr3.wal.close()
            return segments, names

        twin(scenario, tmp_path)

    def test_segmented_compaction_never_copies(self, tmp_path, monkeypatch):
        copies = []
        real_mkstemp = t_wal.tempfile.mkstemp  # one tempfile module for both

        def spy_mkstemp(*args, **kwargs):
            if ".compact." in kwargs.get("prefix", ""):
                copies.append(kwargs["prefix"])
            return real_mkstemp(*args, **kwargs)

        monkeypatch.setattr(t_wal.tempfile, "mkstemp", spy_mkstemp)

        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d, wal_segment_bytes=400, compact_bytes=0)
            await mgr.recover()
            for i in range(30):
                await register(pkg, state, i)
            before = mgr.wal.segment_count
            assert before > 2
            await mgr.checkpoint()
            after = mgr.wal.segment_count
            assert after < before
            assert copies == [], "segmented compaction copied the tail"
            mgr.wal.close()
            return before, after

        twin(scenario, tmp_path)

    @pytest.mark.parametrize("point", ["pre_seal", "pre_unlink"])
    def test_segment_crash_points_recover_exactly(self, tmp_path, point):
        async def scenario(pkg, d):
            plan = pkg.FaultPlan().crash_on(point, occurrence=0)
            state, mgr = make_manager(pkg, d, plan=plan, wal_segment_bytes=400,
                                      compact_bytes=0)
            await mgr.recover()
            crashed = False
            for i in range(30):
                try:
                    await register(pkg, state, i)
                except pkg.CrashPoint:
                    crashed = True
                    break
            acked = 0
            for i in range(30):
                if (await state.get_user(f"u{i}")) is not None:
                    acked += 1
            if point == "pre_unlink":
                assert not crashed
                with pytest.raises(pkg.CrashPoint):
                    await mgr.checkpoint()
            else:
                assert crashed
            state2, mgr2 = make_manager(pkg, d, wal_segment_bytes=400, compact_bytes=0)
            await mgr2.recover()
            assert await state2.user_count() == acked
            for i in range(acked):
                assert await state2.get_user(f"u{i}") is not None
            await register(pkg, state2, 90)
            await mgr2.checkpoint()
            state3, mgr3 = make_manager(pkg, d, wal_segment_bytes=400, compact_bytes=0)
            await mgr3.recover()
            assert await state3.get_user("u90") is not None
            mgr3.wal.close()
            mgr2.wal.close()
            return crashed, acked

        twin(scenario, tmp_path)

    def test_corrupt_sealed_segment_quarantines_suffix(self, tmp_path):
        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d, wal_segment_bytes=400, compact_bytes=10**9)
            await mgr.recover()
            for i in range(30):
                await register(pkg, state, i)
            mgr.wal.close()
            segs = pkg.wal.wal_sealed_segments(mgr.wal_path)
            assert len(segs) >= 3
            with open(segs[1], "r+b") as f:
                f.write(b"\xff" * 32)
            state2, mgr2 = make_manager(pkg, d, wal_segment_bytes=400)
            report = await mgr2.recover()
            assert report.wal_quarantined is not None
            count = await state2.user_count()
            assert 0 < count < 30
            remaining = pkg.wal.wal_sealed_segments(mgr2.wal_path)
            assert all(".corrupt-" not in p for p in remaining)
            mgr2.wal.close()
            return count, len(segs), len(remaining)

        twin(scenario, tmp_path)

    def test_wal_segment_bytes_config_layering(self, tmp_path, monkeypatch):
        def scenario(pkg, d):
            monkeypatch.chdir(d)
            (d / "server.toml").write_text(
                "[durability]\nenabled = true\nwal_segment_bytes = 4096\n")
            monkeypatch.setenv("SERVER_CONFIG_PATH", str(d / "server.toml"))
            monkeypatch.setenv("SERVER_STATE_FILE", str(d / "s.json"))
            monkeypatch.delenv("SERVER_DURABILITY_WAL_SEGMENT_BYTES", raising=False)
            cfg = pkg.cfg.ServerConfig.from_env()
            notes = [cfg.durability.wal_segment_bytes]
            cfg.validate()
            monkeypatch.setenv("SERVER_DURABILITY_WAL_SEGMENT_BYTES", "8192")
            notes.append(pkg.cfg.ServerConfig.from_env().durability.wal_segment_bytes)
            bad = pkg.cfg.ServerConfig()
            bad.durability.wal_segment_bytes = -1
            with pytest.raises(ValueError, match="wal_segment_bytes") as exc:
                bad.validate()
            notes.append(str(exc.value))
            return notes

        assert twin(scenario, tmp_path)[:2] == [4096, 8192]


# --- format-version stamps -----------------------------------------------------------


class TestFormatVersionStamps:
    def test_wal_records_and_snapshot_are_stamped(self, tmp_path):
        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d)
            await mgr.recover()
            await register(pkg, state, 0)
            await register(pkg, state, 1)
            mgr.wal.sync(True)
            with open(mgr.wal_path, "rb") as f:
                records, _ = pkg.dur.iter_frames(f.read())
            assert records and all(r["fmt"] == pkg.dur.WAL_FORMAT_VERSION for r in records)
            await mgr.checkpoint()
            doc = json.loads((d / "state.json").read_text())
            assert doc["version"] == pkg.st.ServerState.SNAPSHOT_VERSION
            mgr.wal.close()
            return pkg.dur.WAL_FORMAT_VERSION, doc["version"], records

        twin(scenario, tmp_path)

    def test_proof_log_stamped_and_refuses_newer(self, tmp_path):
        def scenario(pkg, d):
            writer_cls = __import__(f"{pkg.top_name}.audit.log",
                                    fromlist=["ProofLogWriter"]).ProofLogWriter
            path = str(d / "proofs.log")
            w = writer_cls(path)
            w.append_proofs([{"user_id": "a", "ok": True}])
            w.close()
            with open(path, "rb") as f:
                raw = f.read()
            records, _ = pkg.dur.iter_frames(raw)
            assert records[0]["fmt"] == pkg.dur.WAL_FORMAT_VERSION
            # reopening over a record from a newer build refuses at init
            with open(path, "ab") as f:
                f.write(pkg.dur.encode_record({
                    "seq": 2, "type": "proof",
                    "fmt": pkg.dur.WAL_FORMAT_VERSION + 1, "user_id": "b",
                }))
            with pytest.raises(pkg.dur.NewerFormatError) as exc:
                writer_cls(path)
            msg = str(exc.value)
            assert "proof log" in msg
            assert f"format version {pkg.dur.WAL_FORMAT_VERSION + 1}" in msg
            # the unstamped/older prefix alone reopens fine
            w2 = writer_cls(str(d / "other.log"))
            w2.append_proofs([{"user_id": "c", "ok": False}])
            w2.close()
            assert writer_cls(str(d / "other.log")).seq == 1
            return raw, msg.replace(str(d), "<dir>")

        twin(scenario, tmp_path)

    def test_recovery_refuses_newer_wal_record(self, tmp_path):
        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d)
            await mgr.recover()
            await register(pkg, state, 0)
            mgr.wal.sync(True)
            seq = mgr.wal.seq
            mgr.wal.close()
            stmt = make_statement(pkg, 77)
            fmt = pkg.dur.WAL_FORMAT_VERSION
            with open(mgr.wal_path, "ab") as f:
                f.write(pkg.dur.encode_record({
                    "seq": seq + 1, "type": "register_user", "fmt": fmt + 1,
                    "user_id": "future", "y1": eb(pkg, stmt.y1).hex(),
                    "y2": eb(pkg, stmt.y2).hex(), "registered_at": 1}))
            _, mgr2 = make_manager(pkg, d)
            with pytest.raises(pkg.dur.NewerFormatError) as exc:
                await mgr2.recover()
            msg = str(exc.value)
            assert f"format version {fmt + 1}" in msg and f"({fmt})" in msg
            assert "state.json.wal" in msg
            assert os.path.exists(mgr.wal_path)
            assert not [p for p in os.listdir(d) if ".corrupt-" in p]
            return msg.replace(str(d), "<dir>")

        twin(scenario, tmp_path)

    def test_unintelligible_wal_stamp_refuses(self, tmp_path):
        async def scenario(pkg, d):
            _, mgr = make_manager(pkg, d)
            await mgr.recover()
            mgr.wal.close()
            with open(mgr.wal_path, "ab") as f:
                f.write(pkg.dur.encode_record({"seq": 1, "type": "register_user",
                                               "fmt": "two"}))
            _, mgr2 = make_manager(pkg, d)
            with pytest.raises(pkg.dur.NewerFormatError, match="unintelligible") as exc:
                await mgr2.recover()
            return str(exc.value).replace(str(d), "<dir>")

        twin(scenario, tmp_path)

    def test_unstamped_wal_records_keep_loading(self, tmp_path):
        async def scenario(pkg, d):
            stmt = make_statement(pkg, 78)
            with open(d / "state.json.wal", "wb") as f:
                f.write(pkg.dur.encode_record({
                    "seq": 1, "type": "register_user", "user_id": "old",
                    "y1": eb(pkg, stmt.y1).hex(), "y2": eb(pkg, stmt.y2).hex(),
                    "registered_at": 1}))
            state, mgr = make_manager(pkg, d)
            report = await mgr.recover()
            assert report.replayed == 1 and (await state.get_user("old")) is not None
            mgr.wal.close()
            return report_fields(report)

        twin(scenario, tmp_path)

    def test_snapshot_newer_version_refuses_not_quarantines(self, tmp_path):
        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d)
            await mgr.recover()
            await register(pkg, state, 0)
            await mgr.checkpoint()
            mgr.wal.close()
            snap = d / "state.json"
            doc = json.loads(snap.read_text())
            version = pkg.st.ServerState.SNAPSHOT_VERSION
            doc["version"] = version + 1
            snap.write_text(json.dumps(doc))
            _, mgr2 = make_manager(pkg, d)
            with pytest.raises(pkg.dur.NewerFormatError) as exc:
                await mgr2.recover()
            msg = str(exc.value)
            assert f"version {version + 1}" in msg and "newer than this build" in msg
            assert "state.json" in msg and snap.exists()
            assert not [p for p in os.listdir(d) if ".corrupt-" in p]
            doc["version"] = "zzz"
            snap.write_text(json.dumps(doc))
            _, mgr3 = make_manager(pkg, d)
            with pytest.raises(pkg.dur.NewerFormatError, match="zzz") as exc2:
                await mgr3.recover()
            return msg.replace(str(d), "<dir>"), str(exc2.value).replace(str(d), "<dir>")

        twin(scenario, tmp_path)

    def test_unstamped_snapshot_keeps_loading(self, tmp_path):
        async def scenario(pkg, d):
            state, mgr = make_manager(pkg, d)
            await mgr.recover()
            await register(pkg, state, 0)
            await mgr.checkpoint()
            mgr.wal.close()
            snap = d / "state.json"
            doc = json.loads(snap.read_text())
            del doc["version"]
            snap.write_text(json.dumps(doc))
            state2, mgr2 = make_manager(pkg, d)
            report = await mgr2.recover()
            assert report.snapshot_loaded and (await state2.get_user("u0")) is not None
            mgr2.wal.close()
            return report_fields(report)

        twin(scenario, tmp_path)


# --- chip_smoke.py's durable_daemon phase, rehearsed on the CPU ------------------------


# one intra-op thread: the daemon's plain point arithmetic runs on tensors
# of a few dozen rows, and a full thread team each, beside the test
# suite's other workers, oversubscribes the host's cores many times over
_CPU_LAUNCHER = (
    "import asyncio, sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from cpzk_tpu_torch.server.__main__ import amain, parse_args\n"
    "asyncio.run(amain(parse_args(sys.argv[1:]), device='cpu'))\n"
)


def test_durable_daemon_phase_rehearsal(tmp_path, monkeypatch):
    """The ``durable_daemon`` phase of ``chip_smoke.py`` through its
    ``launcher`` seam, on the kernels' plain versions: 96 users, 8 held
    challenges, 48 logins in RPCs of 10, 16 further challenges with the
    SIGKILL after 8, and a ``compact_bytes`` small enough for these
    numbers; the phase's own checks (every acknowledged registration,
    session and challenge recovered, nothing quarantined, a sweep that held
    its compaction back at the held challenges, each acknowledged challenge
    logged in, the consumed challenge refused before the batcher, exit 0
    with the WAL truncated, no tier-0 shed) must hold."""
    monkeypatch.chdir(tmp_path)  # the daemons' logs land in ./chiprun_out
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke_rehearsal")
    _, corpus, provers = smoke["make_corpus"](16, smoke["SeededRng"](1))
    out = smoke["durable_daemon_phase"](
        corpus, provers, 96, 48, 10, 8, 16, 8,
        launcher=[sys.executable, "-c", _CPU_LAUNCHER], on_card=False, compact_bytes=4096)
    a, b = out["boot_a"], out["boot_b"]
    assert a["users"] == 96 and a["logins"]["sessions"] == a["logins"]["valid"]
    assert a["held_challenges"] == 8 and a["compactions_held"]
    assert out["kill"]["acked"] >= 8 and out["kill"]["exit_code"] < 0
    assert b["state"]["users"] == 96 and b["quarantined"] == 0
    assert b["state"]["sessions"] == a["logins"]["sessions"]
    assert b["logins"]["entries"] == b["logins"]["sessions"] == 8 + out["kill"]["acked"]
    assert b["replay"] == {"code": "PERMISSION_DENIED", "message": "Authentication failed",
                           "reached_card": False}
    assert b["exit_code"] == 0 and b["wal_bytes_after_exit"] == 0
    assert out["sheds_by_tier"]["verify"] == 0
    assert a["wal"]["fsyncs"] > 0 and a["wal"]["bytes"] > 0
    assert 0 < a["register_wal"]["fsyncs"] and a["register_wal"]["appends"] == 96
    assert out["fsync_probe"]["records"] == 256
    assert (tmp_path / "chiprun_out" / "daemon_durable_b.log").exists()
