"""In-memory server state: users, single-use challenges, sessions.

A copy of ``cpzk_tpu/server/state.py`` (the port imports nothing of the
JAX package).  Its snapshot file format is the reference's, so a snapshot
written by either package restores in the other.  The durability journal,
replication barrier and ownership fence hooks stay ``None`` until the host
control plane attaches them through the ``attach_*`` methods
(durability, ``replication/``, ``fleet/``); a fleet split exports and
drops a user subset through :meth:`ServerState.export_user_records` and
:meth:`ServerState.drop_users`.

Reference parity (``src/verifier/state.rs``): same TTLs (challenge 300 s
with a 2x-age clock-skew guard, session 3600 s), per-user caps (3
challenges, 5 sessions), global caps (10k users / 50k challenges / 100k
sessions), consume-once challenge semantics, and cleanup sweeps.

Design deviation (deliberate): the registries are split into
``NUM_STATE_SHARDS`` independently-locked shards keyed by a stable hash
of the owning ``user_id``.  The reference takes five ``RwLock``s in
inconsistent order between ``create_challenge`` and ``consume_challenge``
(``state.rs:165-167`` vs ``:205-206``) — a deadlock hazard under
contention; here everything about one user
(registration, challenges, per-user lists, sessions) lives behind ONE
shard lock, so no operation ever holds two locks and distinct users stop
serializing on a single global lock.

Routing without a scan: challenge ids carry their owning user's shard
index in byte 0 and session tokens carry it in the first two hex chars
(stamped by :meth:`ServerState.tag_challenge_id` /
:meth:`ServerState.tag_session_token` at mint time), so ``VerifyProof``
and ``validate_session`` land directly on the shard that issued them.
Untagged ids (tests, snapshots written before sharding) fall back to a
bounded scan over the shard dicts — correctness never depends on the tag.

Lock discipline (the reference enforces it with its linter): every
mutation of a shard's maps happens lexically inside ``async with
shard.lock`` for that same shard, and every ``_journal_append`` happens
under the mutating shard's lock — which pins WAL order to in-memory
application order per shard (cross-shard interleaving on the single
event loop is itself the application order).  Global capacity caps read
maintained counters (every map mutation routes through the
``_*_insert``/``_*_remove`` funnels): the event loop cannot interleave
another coroutine into a synchronous block, so the check-then-insert
under one shard lock stays exact — at O(1) per check instead of the
O(shards) sum the bulk paths used to pay per entry.

Expiry is indexed by per-shard time-wheels (coarse buckets keyed on the
effective expiry instant, maintained at mint/revoke/consume), so a
cleanup sweep does O(expired) work instead of scanning every live entry,
with lock holds bounded at ``SWEEP_CHUNK`` entries — the two O(total-
state) cliffs a million-user soak exposed.  Snapshots cut
and serialize one shard at a time with event-loop yields in between; see
:meth:`ServerState.snapshot` for why the early WAL watermark is safe.
"""

from __future__ import annotations

import asyncio
import time
import zlib
from collections.abc import MutableMapping
from dataclasses import dataclass, field

from ..errors import Error, InvalidParams, UnsupportedFormat, WrongPartition
from ..protocol.gadgets import Statement
from . import metrics

CHALLENGE_EXPIRY_SECONDS = 300
MAX_CHALLENGES_PER_USER = 3
SESSION_EXPIRY_SECONDS = 3600
MAX_SESSIONS_PER_USER = 5

MAX_TOTAL_USERS = 10_000
MAX_TOTAL_CHALLENGES = 50_000
MAX_TOTAL_SESSIONS = 100_000

MAX_USER_ID_LEN = 256

#: Expiry time-wheel bucket width.  Each shard indexes its sessions and
#: challenges by ``effective_expiry // granularity`` so a cleanup sweep
#: visits only the buckets that are due — O(expired) work per tick
#: instead of a full scan of every live entry (the O(live) cliff the
#: million-user soak exposed).  Coarse on purpose: a bucket is a hint
#: set, membership is re-checked against the map under the shard lock.
EXPIRY_WHEEL_GRANULARITY_S = 60

#: Max entries examined per shard-lock hold during a sweep: bounds the
#: event-loop stall of one lock acquisition even when millions of
#: entries expire at once (the sweep yields between chunks).
SWEEP_CHUNK = 4096

#: Default shard count.  Shard indexes are embedded in challenge ids
#: (byte 0) and session tokens (first two hex chars), so the count is
#: capped at 256 and must agree across a replicated pair — a promoted
#: standby routes by tags the primary stamped ([replication] shards).
NUM_STATE_SHARDS = 16
MAX_STATE_SHARDS = 256


def _valid_user_id_chars(user_id: str) -> bool:
    return all(c.isalnum() or c in "_-." for c in user_id)


def user_id_error(user_id: str) -> str | None:
    """Registration-time user-id rules (service.rs:37-56 twin): non-empty,
    <=256 chars, ``[A-Za-z0-9._-]`` only.  Shared by the gRPC service and
    the snapshot-restore trust boundary so the two can never drift."""
    if not user_id:
        return "User ID cannot be empty"
    if len(user_id) > MAX_USER_ID_LEN:
        return "User ID too long"
    if not _valid_user_id_chars(user_id):
        return "User ID contains invalid characters"
    return None


def _now() -> int:
    return int(time.time())


@dataclass
class UserData:
    user_id: str
    statement: Statement
    registered_at: int


@dataclass
class ChallengeData:
    challenge_id: bytes
    user_id: str
    created_at: int = field(default_factory=_now)
    expires_at: int = 0

    def __post_init__(self) -> None:
        if not self.expires_at:
            self.expires_at = self.created_at + CHALLENGE_EXPIRY_SECONDS

    def is_expired(self, now: int | None = None) -> bool:
        """TTL check with the reference's 2x-age clock-skew guard
        (state.rs:101-111)."""
        if now is None:
            now = _now()
        age = max(0, now - self.created_at)
        return now >= self.expires_at or age >= 2 * CHALLENGE_EXPIRY_SECONDS


@dataclass
class SessionData:
    token: str
    user_id: str
    created_at: int = field(default_factory=_now)
    expires_at: int = 0

    def __post_init__(self) -> None:
        if not self.expires_at:
            self.expires_at = self.created_at + SESSION_EXPIRY_SECONDS

    def is_expired(self, now: int | None = None) -> bool:
        """Same 2x-age clock-skew guard as :meth:`ChallengeData.is_expired`
        (state.rs:101-111): a wall clock stepping backward after mint must
        not silently extend a bearer token's lifetime past twice its TTL."""
        if now is None:
            now = _now()
        age = max(0, now - self.created_at)
        return now >= self.expires_at or age >= 2 * SESSION_EXPIRY_SECONDS


#: Every Nth shard-lock acquisition is timed into the
#: ``state.shard.lock_wait`` histogram (uniform stride, so the mean an
#: operator reads is unbiased; per-acquire timing on the serving path
#: would cost two clock reads per state op for a signal that only
#: matters in aggregate).
_LOCK_WAIT_STRIDE = 16


class _SampledLock(asyncio.Lock):
    """An ``asyncio.Lock`` that stride-samples acquisition wait into the
    cross-plane ``state.shard.lock_wait`` histogram — the shard-contention
    signal the ops plane's ``/statusz`` surfaces.  Drop-in: every
    ``async with shard.lock`` site stays untouched."""

    def __init__(self) -> None:
        super().__init__()
        self._acquires = 0

    async def acquire(self) -> bool:
        self._acquires += 1
        if self._acquires % _LOCK_WAIT_STRIDE:
            return await super().acquire()
        t0 = time.monotonic()
        result = await super().acquire()
        metrics.histogram("state.shard.lock_wait").observe(
            time.monotonic() - t0
        )
        return result


def _session_wheel_key(data: SessionData) -> int:
    """Wheel bucket for a session: its *effective* expiry instant — the
    earlier of ``expires_at`` and the 2x-age clock-skew guard — so an
    entry is expired exactly when ``now`` reaches its bucket's span."""
    eff = min(data.expires_at, data.created_at + 2 * SESSION_EXPIRY_SECONDS)
    return eff // EXPIRY_WHEEL_GRANULARITY_S


def _challenge_wheel_key(data: ChallengeData) -> int:
    eff = min(data.expires_at, data.created_at + 2 * CHALLENGE_EXPIRY_SECONDS)
    return eff // EXPIRY_WHEEL_GRANULARITY_S


class StateShard:
    """One lock + the five registries it guards, for one hash slice of the
    user keyspace.  Everything about a user — registration, challenges,
    sessions, and the per-user index lists — lives in exactly one shard,
    so no state operation ever needs two locks."""

    __slots__ = (
        "lock", "_users", "_challenges", "_user_challenges",
        "_sessions", "_user_sessions", "_session_wheel", "_challenge_wheel",
    )

    def __init__(self) -> None:
        self.lock = _SampledLock()
        self._users: dict[str, UserData] = {}
        self._challenges: dict[bytes, ChallengeData] = {}
        self._user_challenges: dict[str, list[bytes]] = {}
        self._sessions: dict[str, SessionData] = {}
        self._user_sessions: dict[str, list[str]] = {}
        # expiry time-wheels: effective-expiry bucket -> member keys.
        # Hint indexes maintained at mint/revoke/consume so a sweep
        # visits only due buckets; the maps above stay the truth.
        self._session_wheel: dict[int, set[str]] = {}
        self._challenge_wheel: dict[int, set[bytes]] = {}


class _ShardedView(MutableMapping):
    """A merged mutable view over one registry across all shards.

    Test/inspection seam only — the RPC paths go straight at the shards.
    Writes route by the owning user (taken from the key for the
    user-keyed maps, from the value's ``user_id`` for sessions and
    challenges); reads try the tag-routed shard first and fall back to a
    scan, so untagged fixture keys behave exactly as the single-map
    design did."""

    __slots__ = ("_state", "_attr", "_kind")

    def __init__(self, state: "ServerState", attr: str, kind: str):
        self._state = state
        self._attr = attr
        self._kind = kind  # "user" | "session" | "challenge"

    def _maps(self):
        return [getattr(s, self._attr) for s in self._state._shards]

    def _shard_for_key(self, key) -> "StateShard":
        st = self._state
        if self._kind == "user":
            return st._shard_for_user(key)
        if self._kind == "session":
            idx = st._locate_session(key)
        else:
            idx = st._locate_challenge(key)
        if idx is None:
            raise KeyError(key)
        return st._shards[idx]

    def _map_for_key(self, key):
        return getattr(self._shard_for_key(key), self._attr)

    def __getitem__(self, key):
        return self._map_for_key(key)[key]

    def __setitem__(self, key, value) -> None:
        # writes route through the mutation funnels so the maintained
        # counters and expiry wheels stay exact even for fixture writes
        st = self._state
        if self._kind == "user":
            shard = st._shard_for_user(key)
            if self._attr == "_users" and key not in shard._users:
                st._n_users += 1
            getattr(shard, self._attr)[key] = value
            return
        owner = getattr(value, "user_id", None)
        shard = (
            st._shard_for_user(owner)
            if owner is not None
            else st._shards[0]
        )
        if self._kind == "session" and getattr(value, "token", None) == key:
            st._session_insert(shard, value)
        elif (
            self._kind == "challenge"
            and getattr(value, "challenge_id", None) == key
        ):
            st._challenge_insert(shard, value)
        else:  # key-mismatched fixture write: raw set, count new keys
            m = getattr(shard, self._attr)
            if key not in m:
                if self._kind == "session":
                    st._n_sessions += 1
                else:
                    st._n_challenges += 1
            m[key] = value

    def __delitem__(self, key) -> None:
        st = self._state
        shard = self._shard_for_key(key)
        m = getattr(shard, self._attr)
        if key not in m:
            raise KeyError(key)
        if self._attr == "_sessions":
            st._session_remove(shard, key)
        elif self._attr == "_challenges":
            st._challenge_remove(shard, key)
        elif self._attr == "_users":
            st._user_remove(shard, key)
        else:
            del m[key]

    def __iter__(self):
        for m in self._maps():
            yield from m

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps())

    def __contains__(self, key) -> bool:
        # membership must check the key, not only that a shard resolves:
        # the user-keyed maps route ANY key to some shard, so the old
        # resolve-only check answered True for every user id
        try:
            m = self._map_for_key(key)
        except KeyError:
            return False
        return key in m


class ServerState:
    """All server registries behind per-shard locks (see module docstring)."""

    def __init__(
        self,
        shards: int = NUM_STATE_SHARDS,
        max_users: int = MAX_TOTAL_USERS,
        max_challenges: int = MAX_TOTAL_CHALLENGES,
        max_sessions: int = MAX_TOTAL_SESSIONS,
    ) -> None:
        if not 1 <= shards <= MAX_STATE_SHARDS:
            raise ValueError(
                f"shards must be in [1, {MAX_STATE_SHARDS}], got {shards}"
            )
        if min(max_users, max_challenges, max_sessions) < 1:
            raise ValueError("capacity caps must be >= 1")
        self.num_shards = shards
        self._shards = [StateShard() for _ in range(shards)]
        # global capacity caps: the reference constants by default,
        # raised via [server] max_* for million-user deployments
        self.max_users = max_users
        self.max_challenges = max_challenges
        self.max_sessions = max_sessions
        # maintained global counts, updated by the _*_insert/_*_remove
        # funnels below: O(1) cap checks instead of an O(shards) sum per
        # entry inside the shard lock — semantics
        # unchanged because every map mutation routes through the funnels
        self._n_users = 0
        self._n_challenges = 0
        self._n_sessions = 0
        # sweep introspection: kind -> (examined, removed, duration_s) of
        # the last expiry sweep (the operation-counting spy tests and the
        # soak harness read this; the metrics carry the same numbers)
        self.last_sweep_stats: dict[str, tuple[int, int, float]] = {}
        # longest synchronous per-shard snapshot cut this process has
        # paid, milliseconds (the acceptance number of the streaming
        # snapshot: the event loop never stalls longer than one cut)
        self.snapshot_max_pause_ms = 0.0
        # longest whole-sweep wall time, milliseconds (soak acceptance)
        self.sweep_max_ms = 0.0
        # serializes whole snapshot() calls: overlapping writers (cleanup
        # sweep vs shutdown) must rename in document-build order, or an
        # older doc can land over a newer one with _persist_dirty false
        self._snapshot_lock = asyncio.Lock()
        # set on any change to persisted data (users/sessions); lets the
        # periodic snapshot skip writes on an idle server
        self._persist_dirty = True
        # durability journal hook (WriteAheadLog | None): when attached,
        # every acknowledged mutation to persisted data is appended —
        # under the mutating shard's lock, so WAL order always equals
        # application order — and fsynced (per policy) before the RPC
        # returns
        self.journal = None
        # live challenge id -> the journal position (``WriteAheadLog.
        # position``) of its create_challenge record; 0 for one replayed
        # at boot, whose place in the recovered log is not tracked.
        # Snapshots hold no challenges, so DurabilityManager.checkpoint
        # never compacts past the oldest of these (a departure from the
        # reference, whose compaction drops them: ROADMAP section C)
        self._challenge_records: dict[bytes, int] = {}
        # synchronous-replication barrier (async callable(seq) | None):
        # when attached by a sync-mode SegmentShipper, acknowledged
        # mutations additionally wait until the warm standby has applied
        # the journal up to their sequence number (zero-loss failover)
        self.repl_barrier = None
        # write-time ownership fence (callable(user_id) -> str | None,
        # attached where a fleet router exists): re-verifies partition
        # ownership INSIDE the shard lock, in the same synchronous
        # section as the mutation itself.  The entry-point ownership
        # check alone cannot fence multi-await handlers — VerifyProof
        # awaits the batcher between its check and create_session,
        # register awaits the shard lock — and a live split's map flip
        # can land inside any of those awaits.  Because the split's
        # export -> flip runs with no await and this check-then-mutate
        # is equally synchronous, event-loop non-interleaving totally
        # orders the two: a fenced mutation either precedes the export
        # (and ships with it) or follows the flip (and is rejected with
        # the redirect message — never acknowledged, never stranded).
        self.owner_fence = None
        # WAL sequence number the last-restored snapshot covered
        self.restored_wal_seq = 0
        # (seq, byte offset) of the journal at the last snapshot write:
        # the compaction watermark — everything before it is covered
        self.snapshot_covered_seq = 0
        self.snapshot_covered_offset = 0

    # --- shard routing ----------------------------------------------------

    def _shard_index(self, user_id: str) -> int:
        """Stable user->shard hash (crc32: identical across processes, so
        a promoted standby routes the tags the primary stamped)."""
        return zlib.crc32(user_id.encode()) % self.num_shards

    def _shard_for_user(self, user_id: str) -> StateShard:
        return self._shards[self._shard_index(user_id)]

    def tag_challenge_id(self, user_id: str, challenge_id: bytes) -> bytes:
        """Stamp the owning user's shard index into byte 0 of a freshly
        minted challenge id, so ``consume_challenge`` lands on the issuing
        shard without a scan (31 of the 32 random bytes remain)."""
        return bytes([self._shard_index(user_id)]) + challenge_id[1:]

    def tag_session_token(self, user_id: str, token: str) -> str:
        """Stamp the owning user's shard index into the first two hex
        chars of a freshly minted session token (same routing contract as
        :meth:`tag_challenge_id`)."""
        return f"{self._shard_index(user_id):02x}" + token[2:]

    def _locate_challenge(self, challenge_id: bytes) -> int | None:
        """Shard index holding ``challenge_id``: the tag byte when it
        routes to a hit, else a bounded scan (untagged test/legacy ids);
        ``None`` when no shard holds it.  Synchronous — callers re-check
        under the shard lock before mutating."""
        if challenge_id:
            idx = challenge_id[0]
            if idx < self.num_shards and challenge_id in self._shards[idx]._challenges:
                return idx
        for i, shard in enumerate(self._shards):
            if challenge_id in shard._challenges:
                return i
        return None

    def _locate_session(self, token: str) -> int | None:
        """Shard index holding ``token`` (tag-routed, scan fallback)."""
        if len(token) >= 2:
            try:
                idx = int(token[:2], 16)
            except ValueError:
                idx = -1
            if 0 <= idx < self.num_shards and token in self._shards[idx]._sessions:
                return idx
        for i, shard in enumerate(self._shards):
            if token in shard._sessions:
                return i
        return None

    # --- mutation funnels (counter + wheel + per-user-list upkeep) --------
    #
    # EVERY mutation of a shard's registries goes through one of these six
    # methods (RPC paths, restore, and the _ShardedView
    # test seam alike).  That single funnel is what lets the global counts
    # be maintained integers instead of O(shards) sums, keeps the expiry
    # wheels consistent with the maps, and fixes the per-user-list churn
    # leak in one place: a remove that empties a user's session/challenge
    # list also deletes the dict entry, so the per-user index dicts no
    # longer grow with every user that ever held a session.
    # Direct registry writes outside these six methods are a FUNNEL-001
    # finding; lock discipline is the CALLER's obligation (LOCK-001 at
    # the call sites — parameter-rooted mutations carry no waivers here).

    def _user_insert(self, shard: StateShard, data: UserData) -> None:
        if data.user_id not in shard._users:
            self._n_users += 1
        shard._users[data.user_id] = data

    def _user_remove(self, shard: StateShard, user_id: str) -> UserData | None:
        data = shard._users.pop(user_id, None)
        if data is not None:
            self._n_users -= 1
        return data

    def _session_insert(self, shard: StateShard, data: SessionData) -> None:
        old = shard._sessions.get(data.token)
        if old is None:
            self._n_sessions += 1
        else:  # replace (test seam): drop the old wheel entry first
            self._wheel_discard(
                shard._session_wheel, _session_wheel_key(old), data.token
            )
        shard._sessions[data.token] = data
        shard._session_wheel.setdefault(
            _session_wheel_key(data), set()
        ).add(data.token)

    def _session_remove(self, shard: StateShard, token: str) -> SessionData | None:
        data = shard._sessions.pop(token, None)
        if data is None:
            return None
        self._n_sessions -= 1
        self._wheel_discard(
            shard._session_wheel, _session_wheel_key(data), token
        )
        per_user = shard._user_sessions.get(data.user_id)
        if per_user is not None:
            if token in per_user:
                per_user.remove(token)
            if not per_user:  # churn-leak fix: delete-on-empty
                del shard._user_sessions[data.user_id]
        return data

    def _challenge_insert(self, shard: StateShard, data: ChallengeData) -> None:
        old = shard._challenges.get(data.challenge_id)
        if old is None:
            self._n_challenges += 1
        else:
            self._wheel_discard(
                shard._challenge_wheel, _challenge_wheel_key(old),
                data.challenge_id,
            )
        shard._challenges[data.challenge_id] = data
        shard._challenge_wheel.setdefault(
            _challenge_wheel_key(data), set()
        ).add(data.challenge_id)

    def _challenge_remove(
        self, shard: StateShard, challenge_id: bytes
    ) -> ChallengeData | None:
        data = shard._challenges.pop(challenge_id, None)
        self._challenge_records.pop(challenge_id, None)
        if data is None:
            return None
        self._n_challenges -= 1
        self._wheel_discard(
            shard._challenge_wheel, _challenge_wheel_key(data), challenge_id
        )
        per_user = shard._user_challenges.get(data.user_id)
        if per_user is not None:
            if challenge_id in per_user:
                per_user.remove(challenge_id)
            if not per_user:  # churn-leak fix: delete-on-empty
                del shard._user_challenges[data.user_id]
        return data

    @staticmethod
    def _wheel_discard(wheel: dict[int, set], key: int, member) -> None:
        bucket = wheel.get(key)
        if bucket is not None:
            bucket.discard(member)
            if not bucket:
                del wheel[key]

    # --- global counts (maintained integers; see the funnels above) -------

    def _total_users(self) -> int:
        return self._n_users

    def _total_challenges(self) -> int:
        return self._n_challenges

    def _total_sessions(self) -> int:
        return self._n_sessions

    # --- per-shard introspection (ops plane /statusz + /metrics) ----------

    def shard_stats(self) -> list[dict]:
        """Per-shard registry sizes, shard-index order.  Synchronous dict
        ``len()`` reads — a consistent-enough cut for an operator surface,
        with zero lock traffic on the serving path."""
        return [
            {
                "shard": i,
                "users": len(s._users),
                "sessions": len(s._sessions),
                "challenges": len(s._challenges),
            }
            for i, s in enumerate(self._shards)
        ]

    def export_shard_gauges(self) -> None:
        """Refresh the per-shard ``state.shard.size{shard,kind}`` gauges
        (pull-style: called by the ops plane right before an exposition
        render rather than on every mutation — per-mutation gauge writes
        would tax the serving path for a scrape-time number)."""
        gauge = metrics.gauge("state.shard.size", labelnames=("shard", "kind"))
        for row in self.shard_stats():
            idx = str(row["shard"])
            gauge.labels(shard=idx, kind="users").set(row["users"])
            gauge.labels(shard=idx, kind="sessions").set(row["sessions"])
            gauge.labels(shard=idx, kind="challenges").set(row["challenges"])

    # --- merged views (test/inspection seam; RPC paths use shards) --------

    @property
    def _users(self) -> _ShardedView:
        return _ShardedView(self, "_users", "user")

    @property
    def _sessions(self) -> _ShardedView:
        return _ShardedView(self, "_sessions", "session")

    @property
    def _challenges(self) -> _ShardedView:
        return _ShardedView(self, "_challenges", "challenge")

    @property
    def _user_sessions(self) -> _ShardedView:
        return _ShardedView(self, "_user_sessions", "user")

    @property
    def _user_challenges(self) -> _ShardedView:
        return _ShardedView(self, "_user_challenges", "user")

    # --- owned-key subset iteration (fleet split: fleet/split.py) ----------

    def export_user_records(self, predicate) -> list[dict]:
        """Journal-style records (``type`` set, no ``seq``) for every user
        matched by ``predicate(user_id)`` — the owned-key subset a fleet
        split ships to the new partition.  Per user: the registration,
        then live challenges, then live sessions, in the order the replay
        validators require (a session/challenge record is rejected unless
        its user is already registered).

        One synchronous pass in a deterministic order (shard index, then
        sorted user id): the event loop cannot interleave a mutating
        handler, so the export is a consistent cut — the same guarantee
        :meth:`snapshot` leans on — and two exports of the same state are
        byte-identical, which keeps a resumed split's segment stream
        stable."""
        from ..core.ristretto import Ristretto255

        eb = Ristretto255.element_to_bytes
        out: list[dict] = []
        for shard in self._shards:
            for uid in sorted(shard._users):
                if not predicate(uid):
                    continue
                user = shard._users[uid]
                out.append({
                    "type": "register_user",
                    "user_id": uid,
                    "y1": eb(user.statement.y1).hex(),
                    "y2": eb(user.statement.y2).hex(),
                    "registered_at": user.registered_at,
                })
                for cid in shard._user_challenges.get(uid, ()):
                    ch = shard._challenges.get(cid)
                    if ch is None or ch.is_expired():
                        continue
                    out.append({
                        "type": "create_challenge",
                        "challenge_id": cid.hex(),
                        "user_id": uid,
                        "created_at": ch.created_at,
                        "expires_at": ch.expires_at,
                    })
                for token in shard._user_sessions.get(uid, ()):
                    s = shard._sessions.get(token)
                    if s is None or s.is_expired():
                        continue
                    out.append({
                        "type": "create_session",
                        "token": token,
                        "user_id": uid,
                        "created_at": s.created_at,
                        "expires_at": s.expires_at,
                    })
        return out

    # cpzk-lint: disable=LOCK-001 -- split drain runs single-threaded on offline partition files, like replay_journal_record
    def drop_users(self, predicate) -> tuple[int, int, int]:
        """Remove every user matched by ``predicate(user_id)`` together
        with their challenges, sessions, and per-user lists — the drain
        stage of a fleet split, after the moved subset is durable on the
        new partition and the map has flipped.  Single-threaded offline
        use only (the split tool operates on a stopped partition's
        files); returns ``(users, challenges, sessions)`` removed."""
        n_users = n_chal = n_sess = 0
        for shard in self._shards:
            doomed = [uid for uid in shard._users if predicate(uid)]
            for uid in doomed:
                self._user_remove(shard, uid)
                n_users += 1
                for cid in list(shard._user_challenges.get(uid, ())):
                    if self._challenge_remove(shard, cid) is not None:
                        n_chal += 1
                for token in list(shard._user_sessions.get(uid, ())):
                    if self._session_remove(shard, token) is not None:
                        n_sess += 1
                shard._user_challenges.pop(uid, None)
                shard._user_sessions.pop(uid, None)
        if n_users or n_chal or n_sess:
            self._persist_dirty = True
        return n_users, n_chal, n_sess

    # --- durability journal ---

    def attach_journal(self, wal) -> None:
        """Install the write-ahead log as this state's journal hook (done
        once by ``DurabilityManager.recover`` before serving starts)."""
        self.journal = wal

    def attach_owner_fence(self, fence) -> None:
        """Install the write-time partition-ownership fence: a SYNCHRONOUS
        ``callable(user_id) -> str | None`` returning the wrong-partition
        redirect message when this daemon no longer owns ``user_id``
        under the live fleet map, else ``None``.  Checked inside the
        shard lock immediately before every acknowledged user-keyed
        mutation (see the ``owner_fence`` constructor comment for why
        the entry-point check alone cannot fence multi-await handlers
        across a live split's map flip).  Reads and challenge consumes
        stay unfenced on purpose: removing a stale copy the split
        already exported cannot lose an acknowledged write, and leaving
        the consume unfenced lets an in-flight login retry at the new
        owner with its challenge intact there."""
        self.owner_fence = fence

    def _fence(self, user_id: str) -> None:
        """Raise :class:`WrongPartition` when the fence rejects
        ``user_id``.  Callers hold the mutating shard's lock; the raise
        precedes the insert/remove funnel AND the journal append, so a
        fenced mutation leaves no trace in memory or in the WAL."""
        fence = self.owner_fence
        if fence is None:
            return
        msg = fence(user_id)
        if msg is not None:
            raise WrongPartition(msg)

    def attach_replication_barrier(self, barrier) -> None:
        """Install a sync-replication barrier: an async callable awaited
        with the journal's sequence number after fsync and before the
        mutation is acknowledged (``SegmentShipper.wait_replicated`` in
        ``mode = "sync"``)."""
        self.repl_barrier = barrier

    # cpzk-lint: disable=LOCK-001 -- append funnel: every caller holds the mutating shard's lock (docstring contract)
    def _journal_append(self, rtype: str, payload: dict) -> None:
        """Append one record — callers hold the mutating shard's ``lock``,
        which pins WAL order to in-memory application order."""
        if self.journal is not None:
            self.journal.append(rtype, payload)

    def oldest_challenge_record(self) -> int | None:
        """The journal position of the oldest live challenge's
        create_challenge record, or ``None`` when no journaled challenge
        is live."""
        return min(self._challenge_records.values(), default=None)

    async def _journal_sync(self) -> None:
        """Make appended records durable per the WAL's fsync policy; called
        AFTER the shard lock is released (fsync flushes every earlier
        append too, so interleaved mutations stay individually durable)
        and BEFORE the mutation is acknowledged to the caller.  With a
        sync-replication barrier attached, the acknowledgement further
        waits for the warm standby to apply up to this sequence number."""
        wal = self.journal
        if wal is not None and wal.needs_sync():
            await asyncio.to_thread(wal.sync)
        barrier = self.repl_barrier
        if barrier is not None and wal is not None:
            await barrier(wal.seq)

    # cpzk-lint: disable=LOCK-001 -- boot-time replay runs single-threaded before serving starts
    def replay_journal_record(self, rec: dict) -> str | None:
        """Boot-time (and standby-side) replay of one WAL record through
        the same trust-boundary validators as :meth:`restore` — a tampered
        log cannot smuggle in what the live RPC would reject.
        Single-threaded (recovery runs before serving starts; the standby
        applies segments before it is promoted to serve), so no lock.
        Returns None when applied, else the skip reason; never raises on
        malformed input (the fuzz harness holds this as an invariant)."""
        from ..core.ristretto import Ristretto255

        try:
            rtype = rec.get("type")
            if rtype == "register_user":
                uid = str(rec["user_id"])
                msg = user_id_error(uid)
                if msg is not None:
                    return msg
                shard = self._shard_for_user(uid)
                if uid in shard._users:
                    return "already registered"
                if self._total_users() >= self.max_users:
                    return "user capacity cap"
                y1 = Ristretto255.element_from_bytes(bytes.fromhex(rec["y1"]))
                y2 = Ristretto255.element_from_bytes(bytes.fromhex(rec["y2"]))
                if Ristretto255.is_identity(y1) or Ristretto255.is_identity(y2):
                    return "identity statement element"
                self._user_insert(shard, UserData(
                    user_id=uid,
                    statement=Statement(y1, y2),
                    registered_at=int(rec["registered_at"]),
                ))
                self._persist_dirty = True
                return None
            if rtype == "create_session":
                token, uid = str(rec["token"]), str(rec["user_id"])
                created, expires = int(rec["created_at"]), int(rec["expires_at"])
                if expires <= created or expires - created > SESSION_EXPIRY_SECONDS:
                    return "invalid session expiry"
                shard = self._shard_for_user(uid)
                if uid not in shard._users:
                    return "unregistered user"
                if self._locate_session(token) is not None:
                    return "duplicate session token"
                if self._total_sessions() >= self.max_sessions:
                    return "session capacity cap"
                data = SessionData(
                    token=token, user_id=uid, created_at=created, expires_at=expires
                )
                if data.is_expired():
                    return None  # same silent drop as restore()
                if len(shard._user_sessions.get(uid, ())) >= MAX_SESSIONS_PER_USER:
                    return "per-user session cap"
                self._session_insert(shard, data)
                shard._user_sessions.setdefault(uid, []).append(token)
                self._persist_dirty = True
                return None
            if rtype == "revoke_session":
                token = str(rec["token"])
                idx = self._locate_session(token)
                if idx is None:
                    return "session not found"
                self._session_remove(self._shards[idx], token)
                self._persist_dirty = True
                return None
            if rtype == "expire_sessions":
                now = int(rec["now"])
                for shard in self._shards:
                    for t in [
                        t for t, d in shard._sessions.items() if d.is_expired(now)
                    ]:
                        self._session_remove(shard, t)
                self._persist_dirty = True
                return None
            if rtype == "create_challenge":
                cid, uid = bytes.fromhex(rec["challenge_id"]), str(rec["user_id"])
                created, expires = int(rec["created_at"]), int(rec["expires_at"])
                if (
                    expires <= created
                    or expires - created > CHALLENGE_EXPIRY_SECONDS
                ):
                    return "invalid challenge expiry"
                shard = self._shard_for_user(uid)
                if uid not in shard._users:
                    return "unregistered user"
                if self._locate_challenge(cid) is not None:
                    return "duplicate challenge id"
                if self._total_challenges() >= self.max_challenges:
                    return "challenge capacity cap"
                data = ChallengeData(
                    challenge_id=cid, user_id=uid,
                    created_at=created, expires_at=expires,
                )
                if data.is_expired():
                    return None  # stale in-flight login: drop silently
                if len(shard._user_challenges.get(uid, ())) >= MAX_CHALLENGES_PER_USER:
                    return "per-user challenge cap"
                self._challenge_insert(shard, data)
                shard._user_challenges.setdefault(uid, []).append(cid)
                # somewhere in the recovered log: pin all of it
                self._challenge_records[cid] = 0
                return None
            if rtype == "consume_challenge":
                cid = bytes.fromhex(rec["challenge_id"])
                idx = self._locate_challenge(cid)
                if idx is None:
                    return "challenge not found"
                self._challenge_remove(self._shards[idx], cid)
                return None
            return f"unknown record type {rtype!r}"
        except Exception as e:  # malformed fields are a rejection, not a crash
            return f"malformed record: {e!r}"

    # --- users (state.rs:136-161) ---

    async def register_user(self, user_data: UserData) -> None:
        (err,) = await self.register_users([user_data])
        if err is not None:
            raise err

    async def register_users(self, users: list[UserData]) -> list[Exception | None]:
        """Register each of ``users`` in order, with ONE journal sync for
        the whole batch: the ``RegisterBatch`` RPC acknowledges its
        entries together, so one fsync before it answers makes every
        acknowledged registration durable (the reference syncs once per
        entry; ROADMAP section C).  Returns per entry ``None``
        (registered) or the protocol error its registration raised."""
        out: list[Exception | None] = []
        for user_data in users:
            shard = self._shard_for_user(user_data.user_id)
            async with shard.lock:
                try:
                    self._register_locked(shard, user_data)
                except Error as e:
                    out.append(e)
                    continue
            out.append(None)
        if any(r is None for r in out):
            await self._journal_sync()
        return out

    # cpzk-lint: disable=LOCK-001 -- callers hold the user's shard lock
    def _register_locked(self, shard: StateShard, user_data: UserData) -> None:
        """The insert (and its journal record) of one registration; the
        caller holds ``shard.lock``."""
        # fence BEFORE the duplicate check: post-flip the source may
        # still hold the user's stale copy, and "already registered"
        # from a non-owner would mask the redirect
        self._fence(user_data.user_id)
        if self._total_users() >= self.max_users:
            raise InvalidParams(
                f"Server has reached maximum user capacity ({self.max_users})"
            )
        if user_data.user_id in shard._users:
            raise InvalidParams(f"User '{user_data.user_id}' already registered")
        self._user_insert(shard, user_data)
        self._persist_dirty = True
        if self.journal is not None:
            from ..core.ristretto import Ristretto255

            eb = Ristretto255.element_to_bytes
            self._journal_append(
                "register_user",
                {
                    "user_id": user_data.user_id,
                    "y1": eb(user_data.statement.y1).hex(),
                    "y2": eb(user_data.statement.y2).hex(),
                    "registered_at": user_data.registered_at,
                },
            )

    async def get_user(self, user_id: str) -> UserData | None:
        return (await self.get_users([user_id]))[0]

    async def get_users(self, user_ids: list[str]) -> list[UserData | None]:
        out: dict[int, UserData | None] = {}
        by_shard: dict[int, list[tuple[int, str]]] = {}
        for i, uid in enumerate(user_ids):
            by_shard.setdefault(self._shard_index(uid), []).append((i, uid))
        for idx in sorted(by_shard):
            shard = self._shards[idx]
            async with shard.lock:
                for i, uid in by_shard[idx]:
                    out[i] = shard._users.get(uid)
        return [out[i] for i in range(len(user_ids))]

    # --- challenges (state.rs:164-249) ---

    async def create_challenge(self, user_id: str, challenge_id: bytes) -> int:
        shard = self._shard_for_user(user_id)
        async with shard.lock:
            self._fence(user_id)
            if self._total_challenges() >= self.max_challenges:
                raise InvalidParams(
                    f"Server has reached maximum challenge capacity ({self.max_challenges})"
                )
            if user_id not in shard._users:
                raise InvalidParams(f"User '{user_id}' not found")
            if len(shard._user_challenges.get(user_id, ())) >= MAX_CHALLENGES_PER_USER:
                raise InvalidParams(f"Too many active challenges for user '{user_id}'")
            data = ChallengeData(challenge_id=challenge_id, user_id=user_id)
            shard._user_challenges.setdefault(user_id, []).append(challenge_id)
            self._challenge_insert(shard, data)
            if self.journal is not None:
                self._challenge_records[challenge_id] = self.journal.position
            # journaled so a crash-reboot (and a promoted standby) does not
            # strand every in-flight login — replayed
            # through the same validators as the other record types
            self._journal_append(
                "create_challenge",
                {
                    "challenge_id": challenge_id.hex(),
                    "user_id": user_id,
                    "created_at": data.created_at,
                    "expires_at": data.expires_at,
                },
            )
        await self._journal_sync()
        return data.expires_at

    async def get_challenge(self, challenge_id: bytes) -> ChallengeData | None:
        idx = self._locate_challenge(challenge_id)
        if idx is None:
            return None
        shard = self._shards[idx]
        async with shard.lock:
            return shard._challenges.get(challenge_id)

    async def consume_challenge(self, challenge_id: bytes) -> ChallengeData:
        """Single-use removal; expired challenges are removed AND rejected.
        Thin wrapper over the bulk form so the two can never desync."""
        data = (await self.consume_challenges([challenge_id]))[0]
        if data is None:
            raise InvalidParams("Invalid or expired challenge")
        return data

    # cpzk-lint: disable=FENCE-001 -- consume stays unfenced on purpose: burning a stale copy the split already exported cannot lose an acked write, and an unfenced consume lets an in-flight login retry at the new owner with its challenge intact there (the serving layer redirects BEFORE consuming)
    async def consume_challenges(self, ids: list[bytes]) -> list[ChallengeData | None]:
        """Bulk consume-once, one lock acquisition per touched shard (the
        batch RPC's hot path: n sequential ``consume_challenge`` awaits
        cost n event-loop round-trips).  Per-id semantics identical to
        :meth:`consume_challenge`, with ``None`` standing in for the
        invalid/expired rejection; duplicate ids in one batch behave as
        they would sequentially (first wins — duplicates always route to
        the same shard)."""
        out: dict[int, ChallengeData | None] = {}
        by_shard: dict[int, list[tuple[int, bytes]]] = {}
        for i, cid in enumerate(ids):
            idx = self._locate_challenge(cid)
            if idx is None:
                out[i] = None
            else:
                by_shard.setdefault(idx, []).append((i, cid))
        journaled = False
        now = int(time.time())  # one clock read for the whole batch
        for idx in sorted(by_shard):
            shard = self._shards[idx]
            async with shard.lock:
                for i, cid in by_shard[idx]:
                    # re-check under the lock: located synchronously above,
                    # and a duplicate earlier in this batch may have won
                    data = shard._challenges.get(cid)
                    if data is None:
                        out[i] = None
                        continue
                    self._challenge_remove(shard, cid)
                    if self.journal is not None:
                        # payload built only when a journal exists: the
                        # hex + dict per id is measurable at stream depth
                        self._journal_append(
                            "consume_challenge", {"challenge_id": cid.hex()}
                        )
                        journaled = True
                    out[i] = None if data.is_expired(now=now) else data
        if journaled:
            await self._journal_sync()
        return [out[i] for i in range(len(ids))]

    async def cleanup_expired_challenges(self) -> int:
        # no journal record: expiry is deterministic from the timestamps a
        # create_challenge record carries, so replay drops them on its own
        return await self._sweep_expired("challenges")

    # cpzk-lint: disable=FENCE-001 -- expiry GC removes only entries past their validity: a post-flip sweep of a moved user's expired entry is a no-op the split drain performs anyway, so ownership never gates garbage collection
    async def _sweep_expired(self, kind: str) -> int:
        """One expiry sweep over the time-wheels: visit only the buckets
        whose span is due, re-check each member against the map under the
        shard lock, remove what is expired — O(expired) work instead of
        the pre-wheel full scan of every live entry.  Lock holds are
        bounded at ``SWEEP_CHUNK`` entries with an event-loop yield
        between chunks, so a million simultaneous expiries never stall
        serving for the whole sweep.  Journal semantics unchanged: one
        ``expire_sessions {now}`` record per shard that removed something,
        with the single timestamp captured before any removal — replay
        still produces exactly the removed set (interleaved mints carry
        later timestamps and are never expired at ``now``; interleaved
        revokes journal their own records)."""
        is_sessions = kind == "sessions"
        now = _now()
        due = now // EXPIRY_WHEEL_GRANULARITY_S
        t0 = time.monotonic()
        removed = examined = 0
        journaled = False
        for shard in self._shards:
            wheel = (
                shard._session_wheel if is_sessions
                else shard._challenge_wheel
            )
            registry = shard._sessions if is_sessions else shard._challenges
            async with shard.lock:
                pending: list = []
                for k in [k for k in wheel if k <= due]:
                    pending.extend(wheel.pop(k))
            if not pending:
                continue
            shard_removed = 0
            survivors: list = []
            for lo in range(0, len(pending), SWEEP_CHUNK):
                async with shard.lock:
                    for key in pending[lo:lo + SWEEP_CHUNK]:
                        examined += 1
                        data = registry.get(key)
                        if data is None:
                            continue  # consumed/revoked since: stale hint
                        if data.is_expired(now):
                            if is_sessions:
                                self._session_remove(shard, key)
                            else:
                                self._challenge_remove(shard, key)
                            shard_removed += 1
                        else:
                            survivors.append(key)
                await asyncio.sleep(0)  # bounded hold: yield between chunks
            async with shard.lock:
                # the partially-due bucket's survivors go back on the wheel
                for key in survivors:
                    data = registry.get(key)
                    if data is None:
                        continue
                    wk = (
                        _session_wheel_key(data) if is_sessions
                        else _challenge_wheel_key(data)
                    )
                    wheel.setdefault(wk, set()).add(key)
                if shard_removed and is_sessions:
                    self._persist_dirty = True
                    # one record per shard that expired something: replay
                    # applies the sweep globally, so repeats are no-ops
                    self._journal_append("expire_sessions", {"now": now})
                    journaled = True
            removed += shard_removed
        if journaled:
            await self._journal_sync()
        duration = time.monotonic() - t0
        self.last_sweep_stats[kind] = (examined, removed, duration)
        self.sweep_max_ms = max(self.sweep_max_ms, duration * 1000.0)
        metrics.gauge("state.sweep.max_ms").set(self.sweep_max_ms)
        metrics.histogram(
            "state.sweep.duration", labelnames=("kind",)
        ).labels(kind=kind).observe(duration)
        metrics.counter(
            "state.sweep.examined", labelnames=("kind",)
        ).labels(kind=kind).inc(examined)
        return removed

    # --- sessions (state.rs:252-327) ---

    async def create_session(self, token: str, user_id: str) -> None:
        """Thin wrapper over the bulk form so the two can never desync."""
        msg = (await self.create_sessions([(token, user_id)]))[0]
        if msg is not None:
            # distinguish the fence rejection so the serving layer can
            # answer a redirect instead of INTERNAL: ownership moves are
            # monotone within one flip, so re-asking the fence here is
            # race-free (still rejected <=> the entry failed the fence)
            fence = self.owner_fence
            if fence is not None and fence(user_id) is not None:
                raise WrongPartition(msg)
            raise InvalidParams(msg)

    async def create_sessions(self, pairs: list[tuple[str, str]]) -> list[str | None]:
        """Bulk session mint, one lock acquisition per touched shard:
        per-(token, user_id) result is ``None`` on success or the same
        error message :meth:`create_session` would raise.  Caps are
        enforced exactly as a sequential loop would within each shard;
        across shards the loop runs in shard-index order (the global cap
        stays exact — counts are synchronous sums)."""
        out: dict[int, str | None] = {}
        by_shard: dict[int, list[tuple[int, str, str]]] = {}
        for i, (token, user_id) in enumerate(pairs):
            by_shard.setdefault(self._shard_index(user_id), []).append(
                (i, token, user_id)
            )
        journaled = False
        for idx in sorted(by_shard):
            shard = self._shards[idx]
            async with shard.lock:
                for i, token, user_id in by_shard[idx]:
                    fence = self.owner_fence
                    if fence is not None:
                        fmsg = fence(user_id)
                        if fmsg is not None:
                            out[i] = fmsg
                            continue
                    if self._total_sessions() >= self.max_sessions:
                        out[i] = (
                            f"Server has reached maximum session capacity ({self.max_sessions})"
                        )
                        continue
                    if len(shard._user_sessions.get(user_id, ())) >= MAX_SESSIONS_PER_USER:
                        out[i] = (
                            f"User '{user_id}' has reached maximum session limit ({MAX_SESSIONS_PER_USER})"
                        )
                        continue
                    data = SessionData(token=token, user_id=user_id)
                    self._session_insert(shard, data)
                    shard._user_sessions.setdefault(user_id, []).append(token)
                    self._persist_dirty = True
                    self._journal_append(
                        "create_session",
                        {
                            "token": data.token,
                            "user_id": data.user_id,
                            "created_at": data.created_at,
                            "expires_at": data.expires_at,
                        },
                    )
                    journaled = True
                    out[i] = None
        if journaled:
            await self._journal_sync()
        return [out[i] for i in range(len(pairs))]

    async def validate_session(self, token: str) -> str:
        idx = self._locate_session(token)
        if idx is None:
            raise InvalidParams("Invalid session token")
        shard = self._shards[idx]
        async with shard.lock:
            data = shard._sessions.get(token)
            if data is None:
                raise InvalidParams("Invalid session token")
            if data.is_expired():
                raise InvalidParams("Session expired")
            return data.user_id

    async def revoke_session(self, token: str) -> None:
        idx = self._locate_session(token)
        if idx is None:
            raise InvalidParams("Session not found")
        shard = self._shards[idx]
        async with shard.lock:
            existing = shard._sessions.get(token)
            if existing is None:
                raise InvalidParams("Session not found")
            # fenced like every acked mutation: revoking only the stale
            # copy post-flip would ack a revoke the new owner never saw
            self._fence(existing.user_id)
            data = self._session_remove(shard, token)
            if data is None:
                raise InvalidParams("Session not found")
            self._persist_dirty = True
            self._journal_append("revoke_session", {"token": token})
        await self._journal_sync()

    async def cleanup_expired_sessions(self) -> int:
        return await self._sweep_expired("sessions")

    # --- counts (state.rs:330-342) ---

    async def user_count(self) -> int:
        return self._total_users()

    async def session_count(self) -> int:
        return self._total_sessions()

    async def challenge_count(self) -> int:
        return self._total_challenges()

    # --- snapshot / restore (checkpoint-resume) -------------
    #
    # The reference has no persistence: a restart loses everything
    # (state.rs holds only in-memory maps).  In-memory remains this
    # framework's default for parity; snapshots are OPT-IN new capability
    # (--state-file).  Scope: users and sessions — challenges are 300-second
    # single-use nonces, and persisting them in the long-lived snapshot
    # would extend their attack window across restarts for no operational
    # benefit; in-flight logins instead survive through their journaled
    # create/consume WAL records, which recovery replays regardless of the
    # snapshot's covered sequence number (bounded by WAL compaction — see
    # docs/operations.md).  Format: versioned JSON, public data only
    # (statements are public by protocol design; session tokens are bearer
    # secrets, so the file must be protected like a session store — written
    # 0600).  With a durability journal attached, each snapshot also
    # records the WAL sequence number it covers ("wal_seq"), so boot-time
    # recovery replays only the log suffix beyond it (the durability journal).

    SNAPSHOT_VERSION = 1

    async def snapshot(self, path: str) -> bool:
        """Write users + live sessions to ``path`` (JSON); returns whether
        a write happened (skipped when nothing changed since the last
        snapshot).

        **Streaming per-shard cut**: the WAL watermark
        (``journal.seq``, ``journal.size``) is captured in ONE synchronous
        block FIRST, then the shards are cut one at a time — each cut is a
        synchronous C-speed copy of that shard's item references — with an
        event-loop yield between shards, and ALL serialization + fsync +
        atomic rename happen on a worker thread over the captured
        references (UserData/SessionData are immutable once minted, so the
        writer thread reads them race-free).  The event loop therefore
        never stalls longer than one shard's pointer copy, instead of the
        multi-second whole-document build the monolithic cut paid at 1M
        users.  Mutations that land between the early watermark and a
        later shard's cut may appear in the document even though
        ``wal_seq`` predates them — safe by replay idempotency: recovery
        replays the WAL suffix past ``wal_seq`` through the journal's
        replay validators, where a duplicated create is
        skipped and a revoke/consume of an absent entry is a no-op, so
        restore + suffix-replay converges to the acknowledged state.  The
        on-disk format is byte-identical to the monolithic writer's
        ``json.dump`` output (pinned by test).  Whole calls serialize on a
        snapshot lock so overlapping writers (cleanup sweep vs shutdown)
        rename in document-build order."""
        import asyncio as _asyncio
        import json
        import os

        from ..core.ristretto import Ristretto255

        eb = Ristretto255.element_to_bytes
        async with self._snapshot_lock:
            if not self._persist_dirty:
                return False
            covered: tuple[int, int] | None = None
            wal_seq: int | None = None
            if self.journal is not None:
                # the watermark comes FIRST, before any shard is cut: a
                # mutation after this point is either absent from the
                # document (replayed from the suffix) or present in it
                # (suffix replay skips the duplicate) — both converge
                wal_seq = self.journal.seq
                covered = (self.journal.seq, self.journal.size)
            self._persist_dirty = False
            now = _now()
            cuts: list[tuple[list, list]] = []
            max_pause_ms = 0.0
            # pause the cyclic collector for the cut loop: the burst of
            # list allocations otherwise triggers a gen-2 collection that
            # traverses EVERY live user/session object inside the timed
            # block (~900ms at 1M users, measured) — the cut itself is a
            # C-level reference copy (~5ms/shard at that scale)
            import gc

            gc_was_enabled = gc.isenabled()
            gc.disable()
            try:
                for shard in self._shards:
                    t0 = time.monotonic()
                    # one shard's consistent cut: list() is a synchronous
                    # reference copy, no serialization on the event loop
                    cuts.append((
                        list(shard._users.items()),
                        list(shard._sessions.values()),
                    ))
                    pause_ms = (time.monotonic() - t0) * 1000.0
                    max_pause_ms = max(max_pause_ms, pause_ms)
                    metrics.histogram("state.snapshot.pause_ms").observe(
                        pause_ms
                    )
                    await _asyncio.sleep(0)  # yield between shard cuts
            finally:
                if gc_was_enabled:
                    gc.enable()
            self.snapshot_max_pause_ms = max(
                self.snapshot_max_pause_ms, max_pause_ms
            )
            metrics.gauge("state.snapshot.max_pause_ms").set(
                self.snapshot_max_pause_ms
            )

            def write() -> None:
                # unique tmp name so a racing writer can never rename a
                # torn document; a distinctive prefix lets us sweep debris
                # a hard crash (SIGKILL between mkstemp and rename) left
                # behind — those files hold live bearer tokens
                import tempfile

                d = os.path.dirname(os.path.abspath(path)) or "."
                prefix = "." + os.path.basename(path) + ".tmp."
                for stale in os.listdir(d):
                    if stale.startswith(prefix):
                        try:
                            os.unlink(os.path.join(d, stale))
                        except OSError:
                            pass
                # mkstemp creates 0600 — the bearer-token protection requirement
                fd, tmp = tempfile.mkstemp(prefix=prefix, dir=d)
                dumps = json.dumps
                try:
                    with os.fdopen(fd, "w") as f:
                        # streamed shard by shard, byte-identical to
                        # json.dump of the equivalent monolithic document
                        # (default separators: ", " / ": ")
                        f.write('{"version": %d, "users": {'
                                % self.SNAPSHOT_VERSION)
                        first = True
                        for users_items, _sessions in cuts:
                            if not users_items:
                                continue
                            rows = ", ".join(
                                dumps(uid) + ": " + dumps({
                                    "y1": eb(u.statement.y1).hex(),
                                    "y2": eb(u.statement.y2).hex(),
                                    "registered_at": u.registered_at,
                                })
                                for uid, u in users_items
                            )
                            f.write(("" if first else ", ") + rows)
                            first = False
                        f.write('}, "sessions": [')
                        first = True
                        for _users, sess_values in cuts:
                            rows = ", ".join(
                                dumps({
                                    "token": sd.token,
                                    "user_id": sd.user_id,
                                    "created_at": sd.created_at,
                                    "expires_at": sd.expires_at,
                                })
                                for sd in sess_values
                                if not sd.is_expired(now)
                            )
                            if not rows:
                                continue
                            f.write(("" if first else ", ") + rows)
                            first = False
                        f.write("]")
                        if wal_seq is not None:
                            f.write(', "wal_seq": %d' % wal_seq)
                        f.write("}")
                        f.flush()
                        os.fsync(f.fileno())  # data durable before the rename
                    os.replace(tmp, path)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise

            try:
                await _asyncio.to_thread(write)
            except BaseException:
                self._persist_dirty = True  # retry next sweep
                raise
            if covered is not None:
                # commit the watermark only once the document is on disk:
                # a failed write must not let compaction drop uncovered
                # records on the strength of a snapshot that never landed
                self.snapshot_covered_seq, self.snapshot_covered_offset = covered
            return True

    # cpzk-lint: disable=FENCE-001,ACK-001 -- boot-time snapshot load runs single-threaded before serving starts: no fleet map or fence is attached yet, the WAL replay that follows supplies durability, and nothing is acknowledged to any client
    async def restore(self, path: str) -> tuple[int, int]:
        """Load a snapshot into an empty state; returns (users, sessions).

        The file is a trust boundary: statements re-validate through the
        canonical decoder, every capacity cap is enforced, sessions must
        reference registered users and carry sane expiries — a corrupt or
        tampered file fails loudly rather than registering garbage."""
        import asyncio as _asyncio
        import json

        from ..core.ristretto import Ristretto255

        def _read() -> dict:
            with open(path, encoding="utf-8") as f:
                return json.load(f)

        # worker thread: a multi-MB snapshot read must not stall the loop
        doc = await _asyncio.to_thread(_read)
        # forward-compat gate: refuse only snapshots NEWER than this
        # build writes (naming both versions — the operator needs to know
        # which binary to run), accept unstamped pre-versioning files
        # (absence IS version 1) and any older stamp, refuse junk stamps
        ver = doc.get("version")
        if ver is not None and (
            not isinstance(ver, int) or isinstance(ver, bool)
        ):
            raise UnsupportedFormat(
                f"Unsupported state snapshot version: {ver!r}"
            )
        if ver is not None and ver > self.SNAPSHOT_VERSION:
            raise UnsupportedFormat(
                f"State snapshot is version {ver}, newer than this build "
                f"supports ({self.SNAPSHOT_VERSION}) — run a binary at "
                "least as new as the one that wrote it"
            )
        # WAL sequence number this document covers (0 for pre-durability
        # snapshots); recovery replays only journal records beyond it
        wal_seq = int(doc.get("wal_seq", 0))
        # Validate and build into locals first, commit only after the FULL
        # document passes: a mid-document rejection must not leave a
        # partially-populated state (a caller catching the error and
        # serving anyway would be running half the tampered snapshot).
        if len(doc["users"]) > self.max_users:
            raise InvalidParams("Snapshot exceeds the user capacity cap")
        if len(doc["sessions"]) > self.max_sessions:
            raise InvalidParams("Snapshot exceeds the session capacity cap")
        users: dict[str, UserData] = {}
        for uid, u in doc["users"].items():
            # same rules a live registration passes (service.rs:37-56,
            # :93-97): a tampered snapshot must not smuggle in what the
            # RPC would reject
            msg = user_id_error(uid)
            if msg is not None:
                raise InvalidParams(f"Snapshot user {uid!r}: {msg}")
            st = Statement(
                Ristretto255.element_from_bytes(bytes.fromhex(u["y1"])),
                Ristretto255.element_from_bytes(bytes.fromhex(u["y2"])),
            )
            if Ristretto255.is_identity(st.y1) or Ristretto255.is_identity(st.y2):
                raise InvalidParams(
                    f"Snapshot user {uid!r} has an identity statement element"
                )
            users[uid] = UserData(
                user_id=uid, statement=st, registered_at=int(u["registered_at"])
            )
        sessions: dict[str, SessionData] = {}
        user_sessions: dict[str, list[str]] = {}
        seen_tokens: set[str] = set()
        for s in doc["sessions"]:
            created, expires = int(s["created_at"]), int(s["expires_at"])
            if expires <= created or expires - created > SESSION_EXPIRY_SECONDS:
                raise InvalidParams("Snapshot session has an invalid expiry")
            data = SessionData(
                token=str(s["token"]),
                user_id=str(s["user_id"]),
                created_at=created,
                expires_at=expires,
            )
            if data.user_id not in users:
                raise InvalidParams(
                    "Snapshot session references an unregistered user"
                )
            if data.token in seen_tokens:
                raise InvalidParams("Snapshot contains a duplicate session token")
            seen_tokens.add(data.token)
            if data.is_expired():
                continue
            per_user = user_sessions.setdefault(data.user_id, [])
            if len(per_user) >= MAX_SESSIONS_PER_USER:
                raise InvalidParams("Snapshot exceeds a per-user session cap")
            sessions[data.token] = data
            per_user.append(data.token)
        # commit: distribute into the owning shards.  Boot-time and
        # single-threaded, so no locks.
        if self._total_users() or self._total_sessions():
            raise InvalidParams("restore requires an empty state")
        for uid, u in users.items():
            self._user_insert(self._shard_for_user(uid), u)
        for token, sd in sessions.items():
            self._session_insert(self._shard_for_user(sd.user_id), sd)
        for uid, toks in user_sessions.items():
            self._shard_for_user(uid)._user_sessions[uid] = toks
        self._persist_dirty = True  # freshly-restored state is unsaved
        self.restored_wal_seq = wal_seq
        return len(users), len(sessions)
