"""Twins of ``tests/test_soak_state.py`` for the port's state plane
(``cpzk_tpu_torch/server/state.py``, ``durability/``): streaming
snapshots, time-wheel expiry, churn-leak pins, maintained counters, and
the scaled-down soak smoke, all 15 cases on the port.

What they pin (the reference's soak harness measures it at 1M users):

- the per-user-list churn leak is dead (maps return to their pre-churn
  size after every session/challenge is revoked/consumed);
- the maintained global counters never drift from the map truth;
- a sweep's cost scales with the EXPIRED count, not the live count
  (operation-counting spy over ``last_sweep_stats``), and the journaled
  one-timestamp ``expire_sessions`` record still replays to exactly the
  removed set;
- the streaming per-shard snapshot is byte-identical to the old
  monolithic ``json.dump`` document, restores equivalently, and the
  early WAL watermark stays safe under replay idempotency;
- the 20k-user smoke: snapshot pause bounded, sweep examines nothing
  when nothing is due, RSS sanity.
"""

import asyncio
import json

import pytest

from cpzk_tpu_torch import Parameters, Prover, SecureRng, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.durability import DurabilityManager
from cpzk_tpu_torch.durability.wal import read_frames
from cpzk_tpu_torch.server import metrics
from cpzk_tpu_torch.server.config import DurabilitySettings
from cpzk_tpu_torch.server.state import (
    EXPIRY_WHEEL_GRANULARITY_S,
    SESSION_EXPIRY_SECONDS,
    ChallengeData,
    ServerState,
    SessionData,
    UserData,
)

rng = SecureRng()
params = Parameters.new()


def run(coro):
    return asyncio.run(coro)


def make_statement():
    return Prover(params, Witness(Ristretto255.random_scalar(rng))).statement


SHARED_STMT = make_statement()  # state size matters here, not keygen


async def register_many(state, n, stmt=None):
    for i in range(n):
        await state.register_user(
            UserData(f"u{i}", stmt or SHARED_STMT, 1)
        )


def map_sizes(state):
    return {
        "users": sum(len(s._users) for s in state._shards),
        "sessions": sum(len(s._sessions) for s in state._shards),
        "challenges": sum(len(s._challenges) for s in state._shards),
        "user_sessions": sum(len(s._user_sessions) for s in state._shards),
        "user_challenges": sum(
            len(s._user_challenges) for s in state._shards
        ),
        "session_wheel": sum(
            len(b) for s in state._shards for b in s._session_wheel.values()
        ),
        "challenge_wheel": sum(
            len(b) for s in state._shards
            for b in s._challenge_wheel.values()
        ),
    }


def assert_counters_exact(state):
    """The maintained counters ARE the map truth (funnel integrity)."""
    assert state._total_users() == sum(
        len(s._users) for s in state._shards
    )
    assert state._total_sessions() == sum(
        len(s._sessions) for s in state._shards
    )
    assert state._total_challenges() == sum(
        len(s._challenges) for s in state._shards
    )


# --- churn leak (satellite 1) ------------------------------------------------


def test_churn_returns_maps_to_pre_churn_size():
    """revoke/consume used to leave the emptied per-user list entries
    behind forever — the dicts grew with every user that ever held a
    session.  Pin: after full churn the index maps are back to their
    pre-churn size, and the wheels are empty too."""

    async def main():
        state = ServerState()
        await register_many(state, 200)
        before = map_sizes(state)
        assert before["user_sessions"] == 0
        for round_ in range(3):
            for i in range(200):
                tok = state.tag_session_token(
                    f"u{i}", f"{round_:02d}{i:038d}"[:40]
                )
                await state.create_session(tok, f"u{i}")
                cid = state.tag_challenge_id(f"u{i}", bytes([0] * 32))
                cid = bytes([cid[0], round_, i % 256]) + cid[3:]
                await state.create_challenge(f"u{i}", cid)
            assert state._total_sessions() == 200
            for i in range(200):
                tok = state.tag_session_token(
                    f"u{i}", f"{round_:02d}{i:038d}"[:40]
                )
                await state.revoke_session(tok)
                cid = state.tag_challenge_id(f"u{i}", bytes([0] * 32))
                cid = bytes([cid[0], round_, i % 256]) + cid[3:]
                await state.consume_challenge(cid)
            after = map_sizes(state)
            assert after == before, f"round {round_}: churn leaked {after}"
            assert_counters_exact(state)

    run(main())


def test_sweep_churn_also_deletes_emptied_lists():
    async def main():
        state = ServerState()
        await register_many(state, 50)
        for i in range(50):
            state._sessions[f"dead{i}"] = SessionData(
                token=f"dead{i}", user_id=f"u{i}",
                created_at=1, expires_at=2,
            )
            state._user_sessions.setdefault(f"u{i}", []).append(f"dead{i}")
        assert await state.cleanup_expired_sessions() == 50
        assert map_sizes(state)["user_sessions"] == 0
        assert_counters_exact(state)

    run(main())


# --- maintained counters (satellite 2) --------------------------------------


def test_counters_track_view_writes_and_deletes():
    async def main():
        state = ServerState()
        await register_many(state, 10)
        state._sessions["viewtok"] = SessionData(
            token="viewtok", user_id="u1"
        )
        assert state._total_sessions() == 1
        # replace (same key) must not double-count
        state._sessions["viewtok"] = SessionData(
            token="viewtok", user_id="u1"
        )
        assert state._total_sessions() == 1
        del state._sessions["viewtok"]
        assert state._total_sessions() == 0
        state._challenges[b"c" * 32] = ChallengeData(
            challenge_id=b"c" * 32, user_id="u2"
        )
        assert state._total_challenges() == 1
        del state._challenges[b"c" * 32]
        assert state._total_challenges() == 0
        assert_counters_exact(state)
        with pytest.raises(KeyError):
            del state._sessions["viewtok"]

    run(main())


def test_caps_enforced_exactly_through_counters():
    async def main():
        state = ServerState(max_users=5, max_sessions=3, max_challenges=2)
        for i in range(5):
            await state.register_user(UserData(f"u{i}", SHARED_STMT, 1))
        from cpzk_tpu_torch.errors import InvalidParams

        with pytest.raises(InvalidParams, match="maximum user capacity"):
            await state.register_user(UserData("u5", SHARED_STMT, 1))
        out = await state.create_sessions(
            [(state.tag_session_token(f"u{i}", f"{i:040d}"), f"u{i}")
             for i in range(4)]
        )
        # bulk mint processes in shard-index order, so WHICH entry hits
        # the cap depends on hashing — exactly one must, three succeed
        assert out.count(None) == 3
        rejected = [m for m in out if m is not None]
        assert len(rejected) == 1
        assert "maximum session capacity (3)" in rejected[0]
        for i in range(2):
            await state.create_challenge(
                f"u{i}", state.tag_challenge_id(f"u{i}", bytes([i]) * 32)
            )
        with pytest.raises(InvalidParams, match="maximum challenge capacity"):
            await state.create_challenge(
                "u3", state.tag_challenge_id("u3", b"x" * 32)
            )

    run(main())


# --- time-wheel expiry (tentpole c) ------------------------------------------


def test_sweep_examines_expired_not_live():
    """The operation-counting spy: 5000 live sessions cost the sweep
    NOTHING (no due buckets), and 40 expired ones cost O(40)."""

    async def main():
        state = ServerState()
        await register_many(state, 100)
        pairs = [
            (state.tag_session_token(f"u{i % 100}", f"{i:040d}"),
             f"u{i % 100}")
            for i in range(500)
        ]
        out = await state.create_sessions(pairs)
        assert all(m is None for m in out)
        removed = await state.cleanup_expired_sessions()
        assert removed == 0
        examined, removed_, _dur = state.last_sweep_stats["sessions"]
        assert examined == 0, (
            f"sweep examined {examined} entries with nothing due — "
            "the wheel is not bounding sweep cost"
        )
        # now 40 expired entries among the 500 live
        for i in range(40):
            state._sessions[f"exp{i}"] = SessionData(
                token=f"exp{i}", user_id=f"u{i}",
                created_at=10, expires_at=20,
            )
        removed = await state.cleanup_expired_sessions()
        assert removed == 40
        examined, removed_, _dur = state.last_sweep_stats["sessions"]
        assert removed_ == 40
        assert examined <= 80, (
            f"sweep examined {examined} entries for 40 expired — "
            "cost is not O(expired)"
        )
        assert_counters_exact(state)

    run(main())


def test_challenge_sweep_examines_expired_not_live():
    async def main():
        state = ServerState()
        await register_many(state, 100)
        for i in range(300):
            await state.create_challenge(
                f"u{i % 100}",
                state.tag_challenge_id(
                    f"u{i % 100}", bytes([i % 256, i // 256]) + b"c" * 30
                ),
            )
        assert await state.cleanup_expired_challenges() == 0
        assert state.last_sweep_stats["challenges"][0] == 0
        for i in range(25):
            cid = bytes([255, i]) + b"e" * 30
            state._challenges[cid] = ChallengeData(
                challenge_id=cid, user_id=f"u{i}",
                created_at=10, expires_at=20,
            )
        assert await state.cleanup_expired_challenges() == 25
        examined = state.last_sweep_stats["challenges"][0]
        assert examined <= 50
        assert_counters_exact(state)

    run(main())


def test_wheel_handles_clock_skew_guard_bucket():
    """An entry whose 2x-age guard fires before its expires_at must be
    bucketed by the EARLIER instant — otherwise the sweep would miss
    what ``is_expired`` already rejects."""

    async def main():
        state = ServerState()
        await register_many(state, 1)
        # expires_at far future, but created long ago: the age guard
        # (created + 2*TTL) is what expires it
        skewed = SessionData(
            token="skew", user_id="u0",
            created_at=100,
            expires_at=100 + 100 * SESSION_EXPIRY_SECONDS,
        )
        state._sessions["skew"] = skewed
        assert skewed.is_expired()  # the guard has long since fired
        assert await state.cleanup_expired_sessions() == 1
        assert "skew" not in state._sessions

    run(main())


def test_sweep_journal_replay_equivalence(tmp_path):
    """The one-timestamp ``expire_sessions`` record still replays to
    exactly the removed set with the wheel-driven chunked sweep: a
    journal holding aged create_session records plus the sweep's expire
    record rebuilds the post-sweep state."""

    async def main():
        state = ServerState()
        mgr = DurabilityManager(
            state, DurabilitySettings(enabled=True),
            str(tmp_path / "s.json"),
        )
        await mgr.recover()
        await register_many(state, 30)
        # 30 aged sessions: journaled create records with old timestamps
        # (what a long-lived server's WAL really holds), mirrored into
        # the live maps
        for i in range(30):
            tok = f"old{i:037d}"
            mgr.wal.append("create_session", {
                "token": tok, "user_id": f"u{i}",
                "created_at": 10,
                "expires_at": 10 + SESSION_EXPIRY_SECONDS,
            })
            state._sessions[tok] = SessionData(
                token=tok, user_id=f"u{i}", created_at=10,
                expires_at=10 + SESSION_EXPIRY_SECONDS,
            )
        # 10 live ones through the ordinary journaled path
        for i in range(10):
            await state.create_session(
                state.tag_session_token(f"u{i}", f"b{i:039d}"), f"u{i}"
            )
        removed = await state.cleanup_expired_sessions()
        assert removed == 30
        live = sorted(t for s in state._shards for t in s._sessions)
        assert len(live) == 10
        mgr.wal.close()

        # replay the whole journal into a fresh state: identical final set
        records = read_frames(mgr.wal_path)[0]
        assert any(r["type"] == "expire_sessions" for r in records)
        state2 = ServerState()
        for rec in records:
            state2.replay_journal_record(rec)
        live2 = sorted(t for s in state2._shards for t in s._sessions)
        assert live2 == live
        assert_counters_exact(state2)

    run(main())


def test_chunked_sweep_survives_interleaved_mutations(monkeypatch):
    """Bounded lock holds mean mutations interleave mid-sweep; the sweep
    must neither crash nor remove live entries."""

    async def main():
        from cpzk_tpu_torch.server import state as state_mod

        monkeypatch.setattr(state_mod, "SWEEP_CHUNK", 16)
        state = ServerState(shards=2)
        await register_many(state, 8)
        for i in range(200):
            state._sessions[f"old{i}"] = SessionData(
                token=f"old{i}", user_id=f"u{i % 8}",
                created_at=10, expires_at=20,
            )

        minted = []

        async def mutator():
            for i in range(40):
                tok = state.tag_session_token(f"u{i % 8}", f"m{i:039d}")
                await state.create_session(tok, f"u{i % 8}")
                minted.append(tok)
                await asyncio.sleep(0)

        sweep_task = asyncio.ensure_future(
            state.cleanup_expired_sessions()
        )
        await mutator()
        removed = await sweep_task
        assert removed == 200
        for tok in minted:
            assert await state.validate_session(tok)
        assert_counters_exact(state)

    run(main())


# --- streaming snapshot (tentpole b) -----------------------------------------


def monolithic_doc(state, wal_seq=None):
    """The exact document the pre-streaming writer json.dump'ed."""
    eb = Ristretto255.element_to_bytes
    doc = {
        "version": state.SNAPSHOT_VERSION,
        "users": {
            uid: {
                "y1": eb(u.statement.y1).hex(),
                "y2": eb(u.statement.y2).hex(),
                "registered_at": u.registered_at,
            }
            for shard in state._shards
            for uid, u in shard._users.items()
        },
        "sessions": [
            {
                "token": s.token,
                "user_id": s.user_id,
                "created_at": s.created_at,
                "expires_at": s.expires_at,
            }
            for shard in state._shards
            for s in shard._sessions.values()
            if not s.is_expired()
        ],
    }
    if wal_seq is not None:
        doc["wal_seq"] = wal_seq
    return doc


def test_streaming_snapshot_byte_identical_to_monolithic(tmp_path):
    async def main():
        state = ServerState()
        await register_many(state, 64, make_statement())
        for i in range(40):
            await state.create_session(
                state.tag_session_token(f"u{i}", f"{i:040d}"), f"u{i}"
            )
        # an expired session must be filtered out, both ways
        state._sessions["dead"] = SessionData(
            token="dead", user_id="u0", created_at=1, expires_at=2
        )
        expected = json.dumps(monolithic_doc(state))
        path = str(tmp_path / "snap.json")
        assert await state.snapshot(path) is True
        with open(path) as f:
            got = f.read()
        assert got == expected, "streaming writer diverged from json.dump"

        # restore-equivalence
        state2 = ServerState()
        nu, ns = await state2.restore(path)
        assert (nu, ns) == (64, 40)
        assert_counters_exact(state2)

    run(main())


def test_streaming_snapshot_with_wal_seq_byte_identical(tmp_path):
    async def main():
        state = ServerState()
        mgr = DurabilityManager(
            state, DurabilitySettings(enabled=True),
            str(tmp_path / "s.json"),
        )
        await mgr.recover()
        await register_many(state, 8, make_statement())
        await state.create_session(
            state.tag_session_token("u0", "0" * 40), "u0"
        )
        expected = json.dumps(monolithic_doc(state, wal_seq=mgr.wal.seq))
        path = str(tmp_path / "snap.json")
        assert await state.snapshot(path) is True
        with open(path) as f:
            assert f.read() == expected
        mgr.wal.close()

    run(main())


def test_snapshot_cuts_per_shard_and_yields(tmp_path):
    """Structure pin: one pause observation per shard lands in the
    ``state.snapshot.pause_ms`` histogram, and a concurrently scheduled
    task gets the loop between cuts."""

    async def main():
        state = ServerState()
        await register_many(state, 256)
        base_count, _ = metrics.read_histogram("state.snapshot.pause_ms")
        ticks = []

        async def ticker():
            while True:
                ticks.append(1)
                await asyncio.sleep(0)

        t = asyncio.ensure_future(ticker())
        before = len(ticks)
        assert await state.snapshot(str(tmp_path / "s.json")) is True
        during = len(ticks) - before
        t.cancel()
        count, _ = metrics.read_histogram("state.snapshot.pause_ms")
        assert count - base_count == state.num_shards
        assert during >= state.num_shards, (
            f"ticker ran {during} times during the snapshot — the cut "
            "is not yielding between shards"
        )
        assert state.snapshot_max_pause_ms >= 0.0

    run(main())


def test_early_watermark_replay_idempotency(tmp_path):
    """The streaming cut captures the WAL watermark BEFORE the shards:
    a snapshot may therefore contain mutations whose records sit past
    ``wal_seq``.  Restore + suffix replay must converge — duplicated
    creates skip, revokes of absent entries no-op."""

    async def main():
        state = ServerState()
        mgr = DurabilityManager(
            state, DurabilitySettings(enabled=True),
            str(tmp_path / "s.json"),
        )
        await mgr.recover()
        await register_many(state, 4, make_statement())
        tok = state.tag_session_token("u0", "a" * 40)
        await state.create_session(tok, "u0")
        watermark = mgr.wal.seq - 1  # pretend the cut preceded the mint

        # craft the worst-case document by hand: session present in the
        # snapshot, its create record PAST the embedded watermark
        doc = monolithic_doc(state, wal_seq=watermark)
        path = str(tmp_path / "crafted.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        mgr.wal.close()

        state2 = ServerState()
        mgr2 = DurabilityManager(
            state2, DurabilitySettings(enabled=True),
            str(tmp_path / "crafted.json"),
        )
        mgr2.wal_path = mgr.wal_path
        report = await mgr2.recover()
        # the duplicated create was SKIPPED, not applied twice
        assert report.skipped >= 1
        assert await state2.validate_session(tok) == "u0"
        assert state2._total_sessions() == 1
        assert_counters_exact(state2)

        # and the reverse shape: revoked-after-watermark -> the session
        # is absent from the doc, the revoke record replays as a no-op
        await state2.revoke_session(tok)
        assert state2._total_sessions() == 0

    run(main())


# --- scaled-down soak smoke (satellite 3) ------------------------------------


def test_soak_smoke_20k_users(tmp_path):
    """The tier-1 slice of the 1M soak: 20k registered users + 20k live
    sessions; the streaming snapshot's longest synchronous cut stays
    bounded, the sweep examines nothing when nothing is due, and RSS
    stays sane."""

    def vm_rss_mb() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) / 1024.0
        except OSError:
            pass
        return 0.0

    async def main():
        users = 20_000
        rss_before = vm_rss_mb()
        state = ServerState(
            max_users=users * 2, max_sessions=users * 2,
            max_challenges=users,
        )
        await register_many(state, users)
        pairs = [
            (state.tag_session_token(f"u{i}", f"{i:040d}"), f"u{i}")
            for i in range(users)
        ]
        for lo in range(0, users, 2000):
            out = await state.create_sessions(pairs[lo:lo + 2000])
            assert all(m is None for m in out)
        assert state._total_sessions() == users

        # snapshot pause: per-shard reference copies, not serialization
        path = str(tmp_path / "snap.json")
        assert await state.snapshot(path) is True
        assert state.snapshot_max_pause_ms < 250.0, (
            f"snapshot cut paused the loop {state.snapshot_max_pause_ms}ms "
            "at 20k users — the streaming cut is not streaming"
        )

        # sweep: all live, nothing due -> zero entries examined
        assert await state.cleanup_expired_sessions() == 0
        assert state.last_sweep_stats["sessions"][0] == 0
        assert await state.cleanup_expired_challenges() == 0
        assert state.last_sweep_stats["challenges"][0] == 0

        # restore-equivalence at size
        state2 = ServerState(max_users=users * 2, max_sessions=users * 2)
        nu, ns = await state2.restore(path)
        assert (nu, ns) == (users, users)
        assert_counters_exact(state2)

        # RSS sanity: holding 20k users + 20k sessions costs a bounded
        # slice of memory (the 1M-user number is BENCH_SOAK.json's).
        # Delta of CURRENT VmRSS, not process peak — a shared pytest
        # process has already peaked on unrelated suites.
        grew_mb = vm_rss_mb() - rss_before
        assert grew_mb < 1024, f"state build grew RSS {grew_mb:.0f} MB"

    run(main())


# --- wheel bucket math --------------------------------------------------------


def test_wheel_granularity_covers_expiry_exactly():
    """Entries land in the bucket of their effective expiry instant:
    everything in a bucket strictly below ``now // G`` is expired."""
    from cpzk_tpu_torch.server.state import (
        _challenge_wheel_key,
        _session_wheel_key,
    )

    s = SessionData(token="t", user_id="u", created_at=1000,
                    expires_at=1000 + SESSION_EXPIRY_SECONDS)
    k = _session_wheel_key(s)
    bucket_end = (k + 1) * EXPIRY_WHEEL_GRANULARITY_S
    assert s.is_expired(bucket_end)
    assert not s.is_expired(k * EXPIRY_WHEEL_GRANULARITY_S - 1)

    c = ChallengeData(challenge_id=b"c" * 32, user_id="u",
                      created_at=50, expires_at=10_000_000)
    k = _challenge_wheel_key(c)  # the 2x-age guard dominates
    assert c.is_expired((k + 1) * EXPIRY_WHEEL_GRANULARITY_S)
