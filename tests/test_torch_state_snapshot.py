"""The port's ``ServerState`` snapshots: twins of ``tests/test_state_snapshot.py``
and the two-way restore between the packages.

Every twin runs one scenario on the reference's ``ServerState`` and the
port's, with the same statements (made from a numpy seed), and requires
the same observations: restore counts, user statements and registration
times, session owners, error types and messages, file modes and the files
left behind.  The two packages write one snapshot format, so a snapshot
written by either restores in the other with the same users (y1/y2 bytes),
sessions and counts.  The reference's ``SnapshotFaults`` patches
``os.fsync``; :func:`fsync_errors` here does the same for both sides.
Waiting for the daemon's ``ServerConfig`` (A5c):
``test_state_file_config_layering``.
"""

import asyncio
import contextlib
import json
import os
import random

import pytest

import cpzk_tpu as J
import cpzk_tpu.errors as j_errors
import cpzk_tpu.server.state as j_state
import cpzk_tpu_torch as T
import cpzk_tpu_torch.errors as t_errors
import cpzk_tpu_torch.server.state as t_state
from torch_grpc_twins import SeededRng, twin_check

SIDES = {
    "reference": (j_state, J, j_errors.Error),
    "port": (t_state, T, t_errors.Error),
}


def run(coro):
    return asyncio.run(coro)


def statement_wires(n: int, seed: int = 61) -> list[tuple[bytes, bytes]]:
    rng = SeededRng(seed)
    eb = J.Ristretto255.element_to_bytes
    out = []
    for _ in range(n):
        st = J.Prover(J.Parameters.new(), J.Witness(J.Ristretto255.random_scalar(rng))).statement
        out.append((eb(st.y1), eb(st.y2)))
    return out


class Side:
    """One package's state types, and statements built from shared bytes."""

    def __init__(self, name: str):
        self.name = name
        self.state_mod, self.pkg, self.Error = SIDES[name]
        self.wires = statement_wires(4)

    def state(self):
        return self.state_mod.ServerState()

    def statement(self, i: int):
        R = self.pkg.Ristretto255
        y1, y2 = self.wires[i]
        return self.pkg.Statement(R.element_from_bytes(y1), R.element_from_bytes(y2))

    def user(self, uid: str, i: int, registered_at: int):
        return self.state_mod.UserData(uid, self.statement(i), registered_at)

    def user_bytes(self, u) -> tuple:
        eb = self.pkg.Ristretto255.element_to_bytes
        return (u.user_id, eb(u.statement.y1), eb(u.statement.y2), u.registered_at)


async def outcome(coro, Error):
    """What a state call returned, or the type and message it raised."""
    try:
        return ("ok", await coro)
    except (Error, ValueError, KeyError, TypeError, OSError) as e:
        return ("raised", type(e).__name__, str(e))


@contextlib.contextmanager
def fsync_errors(n: int):
    """``os.fsync`` raises ``OSError`` for the next ``n`` calls: a write
    that fails after the document reached the temporary file and before
    the rename (the reference's ``SnapshotFaults``)."""
    orig = os.fsync
    left = [n]

    def fsync(fd):
        if left[0] > 0:
            left[0] -= 1
            raise OSError(5, "injected I/O error mid-snapshot-write")
        return orig(fd)

    os.fsync = fsync
    try:
        yield
    finally:
        os.fsync = orig


async def snapshot_restore_roundtrip(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    for i in range(3):
        await st.register_user(s.user(f"u{i}", i, 1234 + i))
    await st.create_session("tok-a", "u0")
    await st.create_session("tok-b", "u1")
    await st.create_challenge("u0", b"c" * 32)  # challenges are not persisted
    log.append(await st.snapshot(path))
    st2 = s.state()
    log.append(await st2.restore(path))
    for i in range(3):
        log.append(s.user_bytes(await st2.get_user(f"u{i}")))
    log.append(await st2.validate_session("tok-a"))
    log.append(await st2.challenge_count())
    for i in range(4):  # the restored per-user session index enforces the cap
        await st2.create_session(f"x{i}", "u0")
    log.append(await outcome(st2.create_session("x5", "u0"), s.Error))
    log.append(oct(os.stat(path).st_mode & 0o777))


async def restore_rejects_bad_input(s, d, log):
    path = str(d / "state.json")

    def write(doc):
        with open(path, "w") as f:
            json.dump(doc, f)

    write({"version": 99, "users": {}, "sessions": []})
    log.append(await outcome(s.state().restore(path), s.Error))
    write({"version": 1, "sessions": [],
           "users": {"evil": {"y1": "ff" * 32, "y2": "ff" * 32, "registered_at": 1}}})
    log.append(await outcome(s.state().restore(path), s.Error))
    st = s.state()
    await st.register_user(s.user("u", 0, 1))
    write({"version": 1, "users": {}, "sessions": []})
    log.append(await outcome(st.restore(path), s.Error))


async def restore_applies_registration_invariants(s, d, log):
    path = str(d / "state.json")
    y1, y2 = s.wires[0]
    good = {"y1": y1.hex(), "y2": y2.hex(), "registered_at": 1}

    def write(doc):
        with open(path, "w") as f:
            json.dump(doc, f)

    st = s.state()  # every rejection on ONE instance: all or nothing
    write({"version": 1, "sessions": [],
           "users": {"u": {"y1": "00" * 32, "y2": good["y2"], "registered_at": 1}}})
    log.append(await outcome(st.restore(path), s.Error))
    for uid in ["", "x" * 257, "bad user!"]:
        write({"version": 1, "users": {"ok-user": dict(good), uid: dict(good)},
               "sessions": []})
        log.append(await outcome(st.restore(path), s.Error))
    sess = {"token": "tok", "user_id": "u", "created_at": 10**10, "expires_at": 10**10 + 60}
    write({"version": 1, "users": {"u": dict(good)}, "sessions": [dict(sess), dict(sess)]})
    log.append(await outcome(st.restore(path), s.Error))
    log.append(await st.user_count())
    write({"version": 1, "users": {"u": dict(good)}, "sessions": [dict(sess)]})
    log.append(await st.restore(path))


async def concurrent_snapshots_leave_no_debris(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    await st.register_user(s.user("u0", 0, 1))
    writes = []
    for i in range(4):
        await st.create_session(f"tok-{i}", "u0")  # re-dirty between writes
        writes.append(st.snapshot(path))
    log.append(any(await asyncio.gather(*writes)))
    log.append(json.load(open(path))["version"])
    log.append(os.listdir(d))


async def restore_drops_expired_sessions(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    await st.register_user(s.user("u0", 0, 1))
    await st.create_session("live", "u0")
    st._sessions["dead"] = s.state_mod.SessionData(
        token="dead", user_id="u0", created_at=1, expires_at=2)
    st._user_sessions.setdefault("u0", []).append("dead")
    await st.snapshot(path)
    st2 = s.state()
    log.append(await st2.restore(path))
    log.append(await st2.validate_session("live"))
    log.append(await outcome(st2.validate_session("dead"), s.Error))


async def snapshot_skips_when_clean(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    await st.register_user(s.user("u", 0, 1))
    log.append(await st.snapshot(path))
    log.append(await st.snapshot(path))  # nothing changed
    await st.create_session("t", "u")
    log.append(await st.snapshot(path))


async def snapshot_oserror_mid_write_preserves_previous(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    await st.register_user(s.user("u0", 0, 1))
    log.append(await st.snapshot(path))  # a good baseline
    await st.create_session("tok", "u0")  # re-dirty
    with fsync_errors(1):
        log.append(await outcome(st.snapshot(path), s.Error))
    log.append(await s.state().restore(path))  # the previous snapshot, intact
    log.append(sorted(os.listdir(d)))  # no temporary file left holding tokens
    log.append(await st.snapshot(path))  # the dirty flag re-armed
    st3 = s.state()
    log.append(await st3.restore(path))
    log.append(await st3.validate_session("tok"))


async def snapshot_repeated_io_errors_then_recovery(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    await st.register_user(s.user("u0", 0, 1))
    log.append(await st.snapshot(path))
    with fsync_errors(3):
        for i in range(3):
            await st.create_session(f"tok-{i}", "u0")
            log.append(await outcome(st.snapshot(path), s.Error))
            log.append(json.load(open(path))["sessions"])  # untouched
        log.append(await st.snapshot(path))  # the fault budget is spent
    log.append(await s.state().restore(path))


async def restore_partial_write_leaves_state_empty_and_retryable(s, d, log):
    path = str(d / "state.json")
    st = s.state()
    await st.register_user(s.user("u0", 0, 1))
    await st.create_session("tok", "u0")
    await st.snapshot(path)
    good = open(path, "rb").read()
    fresh = s.state()
    for cut in (1, len(good) // 2, len(good) - 2):
        with open(path, "wb") as f:
            f.write(good[:cut])  # a torn write
        log.append((await outcome(fresh.restore(path), s.Error))[:2])
        log.append(await fresh.user_count())
    with open(path, "wb") as f:
        f.write(good)
    log.append(await fresh.restore(path))


async def restore_survives_mutated_snapshots(s, d, log):
    """Random structural mutations of a valid snapshot either load or raise
    an Error/ValueError-family exception, the same way in both packages."""
    path = str(d / "state.json")
    st = s.state()
    for i in range(2):
        await st.register_user(s.user(f"u{i}", i, i))
    await st.create_session("tok", "u0")
    await st.snapshot(path)
    good = open(path).read()
    # the token's expiry varies with the clock: mutate a fixed document
    doc0 = json.loads(good)
    doc0["sessions"][0].update(created_at=10**10, expires_at=10**10 + 60)
    good = json.dumps(doc0)
    r = random.Random(1234)
    for _ in range(120):
        doc = bytearray(good.encode())
        for _ in range(r.randint(1, 6)):
            op, i = r.random(), r.randrange(len(doc))
            if op < 0.4:
                doc[i] = r.randrange(256)
            elif op < 0.7:
                del doc[i]
            else:
                doc.insert(i, r.randrange(32, 127))
        with open(path, "wb") as f:
            f.write(doc)
        try:
            got = await s.state().restore(path)
        except (s.Error, ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            got = type(e).__name__
        log.append(got)


SCENARIOS = [
    snapshot_restore_roundtrip,
    restore_rejects_bad_input,
    restore_applies_registration_invariants,
    concurrent_snapshots_leave_no_debris,
    restore_drops_expired_sessions,
    snapshot_skips_when_clean,
    snapshot_oserror_mid_write_preserves_previous,
    snapshot_repeated_io_errors_then_recovery,
    restore_partial_write_leaves_state_empty_and_retryable,
    restore_survives_mutated_snapshots,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_state_snapshot_twin(scenario, tmp_path):
    logs = {}
    for name in SIDES:
        d = tmp_path / name
        d.mkdir()
        logs[name] = []
        run(scenario(Side(name), d, logs[name]))
    assert logs["reference"] == logs["port"]
    assert logs["port"]


def test_state_snapshot_twin_expectations(tmp_path):
    """The values the reference's own tests assert, read off the port."""
    s = Side("port")
    log = []
    run(snapshot_restore_roundtrip(s, tmp_path, log))
    assert log[0] is True and log[1] == (3, 2)
    assert log[2] == ("u0", *s.wires[0], 1234)
    assert log[5:7] == ["u0", 0]
    assert log[7][0] == "raised" and "maximum session limit" in log[7][2]
    assert log[8] == oct(0o600)
    log = []
    run(restore_rejects_bad_input(s, tmp_path, log))
    assert [o[0] for o in log] == ["raised"] * 3
    assert "version" in log[0][2] and "empty state" in log[2][2]


def test_grpc_restart_with_snapshot(tmp_path):
    """Register on one server, snapshot, restore into a fresh server, and
    log in without registering again: through both packages' servers."""
    from cpzk_tpu.client.__main__ import do_login, do_register

    async def scenario(t):
        path = str(tmp_path / f"{t.side}.json")
        await t.start()
        t.note(("register", "Registered" in await do_register(t.client, "carol", "pw-carol")))
        await t.state.snapshot(path)
        await t.stop()
        state2 = t.pkg.ServerState()
        t.note(("restored", await state2.restore(path)))
        await t.start(state=state2)
        try:
            t.note(("login", "Login OK" in await do_login(t.client, "carol", "pw-carol")))
            t.note(("wrong", "Login OK" in await do_login(t.client, "carol", "wrong")))
        finally:
            await t.stop()

    obs = twin_check(scenario, seed=67)
    assert obs == [("register", True), ("restored", (1, 0)), ("login", True), ("wrong", False)]


async def _populated(side: Side, path: str):
    st = side.state()
    for i in range(4):
        await st.register_user(side.user(f"user-{i}", i, 1000 + i))
    await st.create_session("tok-0", "user-0")
    await st.create_session("tok-1", "user-0")
    await st.create_session("tok-2", "user-3")
    assert await st.snapshot(path)
    return st


async def _contents(side: Side, st) -> tuple:
    users = [side.user_bytes(await st.get_user(f"user-{i}")) for i in range(4)]
    sessions = [await st.validate_session(t) for t in ("tok-0", "tok-1", "tok-2")]
    return users, sessions, await st.user_count(), await st.session_count()


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_snapshot_restores_across_packages(writer, reader, tmp_path):
    """A snapshot written by one package's ``ServerState`` restores in the
    other's with the same users (y1/y2 bytes), sessions and counts."""
    path = str(tmp_path / "state.json")
    w, r = Side(writer), Side(reader)

    async def main():
        src = await _populated(w, path)
        dst = r.state()
        counts = await dst.restore(path)
        return counts, await _contents(w, src), await _contents(r, dst)

    counts, written, restored = run(main())
    assert counts == (4, 3)
    assert restored == written
    assert restored[1] == ["user-0", "user-0", "user-3"]
    assert restored[2:] == (4, 3)
