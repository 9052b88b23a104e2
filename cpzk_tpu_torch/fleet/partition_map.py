"""Versioned partition map: the fleet's routing contract.

A copy of ``cpzk_tpu/fleet/partition_map.py``: the map document, its
validation, routing, the split/standby operations and
:class:`FleetRouter`, the daemon-side ownership check.  The client
(:mod:`cpzk_tpu_torch.client.rpc`) routes by the map, the auth service
enforces it through the router and names its redirect trailers.

A **partition map** is a static consistent hash of the ``user_id``
keyspace onto N partitions, serialized with a monotonically increasing
``version`` and a content ``digest``, stored as one JSON file every
daemon and client loads, so the whole fleet agrees on who owns whom.

Hash scheme
-----------

``user_hash(user_id) = crc32(user_id) over the 32-bit space`` — the SAME
stable hash the state shards use (``server/state.py``), so a user's
placement is identical across processes and languages with a crc32.  The
map carries, per partition, a set of half-open ``[lo, hi)`` ranges over
``[0, 2**32)``; the ranges of all partitions are **disjoint and
exhaustive** (validated on every load — a map with a gap or an overlap
refuses to parse), which makes :meth:`PartitionMap.partition_for` a
total function over arbitrary user ids: every id routes to exactly one
partition, always.

Range-based rather than ring-based on purpose: a **split**
(:meth:`PartitionMap.split`) is then a pure map operation — halve the
source partition's largest range, hand the upper half to a new
partition, bump the version — and "the users that moved" is exactly "the
ids whose hash lands in the moved ranges", which is what the live split
flow (:mod:`cpzk_tpu_torch.fleet.split`) snapshots and replays over the
WAL replication plane.

Versioning and the redirect contract
------------------------------------

The version is the fleet's fencing token for routing: servers enforce
ownership against *their* loaded map and answer wrong-partition requests
with ``FAILED_PRECONDITION`` carrying ``cpzk-partition-map-version`` and
``cpzk-partition-owner`` in trailing metadata (the same trailer
discipline as the admission plane's ``cpzk-retry-after-ms``); clients
route by *their* map and, on a redirect, refresh + re-route **once per
attempt** (``client/rpc.py``).  A stale client therefore converges in
one redirect.

The digest covers the canonical JSON of everything except itself, so two
operators (or a drift monitor) can compare maps by 12 hex chars.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import tempfile
import zlib
from dataclasses import dataclass

#: Schema tags of the serialized map document.  v1 routes to one address
#: per partition; v2 additionally carries the partition's
#: warm-standby address so clients can fail over / follow a handover
#: without a map flip.  A v2 map with no standbys serializes as v1 — old
#: digests (and old readers) stay stable.
SCHEMA = "cpzk-partition-map/1"
SCHEMA_V2 = "cpzk-partition-map/2"
_SCHEMAS = (SCHEMA, SCHEMA_V2)

#: The hash keyspace: crc32 — shared with the state-shard router so one
#: hash places a user both onto a partition and onto a shard within it.
HASH_SPACE = 1 << 32

#: Trailing-metadata keys of the wrong-partition redirect contract.  The
#: version tells the client *why* (its map is stale or the server's is);
#: the owner is the address to re-route to under the server's map.
PARTITION_MAP_VERSION_KEY = "cpzk-partition-map-version"
PARTITION_OWNER_KEY = "cpzk-partition-owner"

#: Sanity cap: partition indexes ride in JSON and per-partition channel
#: pools; a hostile map must not allocate unboundedly.
MAX_PARTITIONS = 4096


def user_hash(user_id: str) -> int:
    """Stable placement hash of one user id (crc32 over the 32-bit
    space; identical across processes — and to the state-shard hash for
    every id the server would accept).  Total over arbitrary Python
    strings: lone surrogates (which strict UTF-8 refuses) hash via
    surrogatepass rather than raising — routing is a total function,
    and the service's own user-id validation rejects such ids long
    before any state is touched."""
    return zlib.crc32(user_id.encode("utf-8", "surrogatepass")) & 0xFFFFFFFF


@dataclass(frozen=True)
class Partition:
    """One partition: an index, the serving address of its primary
    (in a replicated deployment: the pair's stable/VIP address), the
    hash ranges it owns (half-open ``[lo, hi)``), and — in a v2 map —
    the optional address of its warm standby (``None`` on v1 maps and
    unreplicated partitions)."""

    index: int
    address: str
    ranges: tuple[tuple[int, int], ...]
    standby: str | None = None

    def span(self) -> int:
        return sum(hi - lo for lo, hi in self.ranges)

    def covers(self, h: int) -> bool:
        return any(lo <= h < hi for lo, hi in self.ranges)


class PartitionMap:
    """The validated, routable form of one map document."""

    def __init__(self, version: int, partitions: list[Partition]):
        self.version = int(version)
        self.partitions = list(partitions)
        _validate(self.version, self.partitions)
        # routing index: range starts sorted, owner per start — bisect
        # makes partition_for O(log ranges) and allocation-free
        edges: list[tuple[int, int, int]] = []
        for p in self.partitions:
            for lo, hi in p.ranges:
                edges.append((lo, hi, p.index))
        edges.sort()
        self._starts = [lo for lo, _hi, _idx in edges]
        self._owners = [idx for _lo, _hi, idx in edges]

    # -- routing (total over arbitrary user ids) ---------------------------

    def partition_for_hash(self, h: int) -> Partition:
        i = bisect.bisect_right(self._starts, h % HASH_SPACE) - 1
        return self.partitions[self._owners[i]]

    def partition_for(self, user_id: str) -> Partition:
        """The owning partition of ``user_id`` — a total function: the
        ranges are validated disjoint + exhaustive, so every id (any
        unicode, any length) lands on exactly one partition."""
        return self.partition_for_hash(user_hash(user_id))

    def index_of_address(self, address: str) -> int:
        """The partition index serving at ``address`` (boot-time self
        discovery when ``[fleet] partition`` is left at -1)."""
        for p in self.partitions:
            if p.address == address:
                return p.index
        raise ValueError(
            f"address {address!r} is not in the partition map "
            f"(v{self.version}: {[p.address for p in self.partitions]})"
        )

    # -- construction ------------------------------------------------------

    @classmethod
    def uniform(
        cls, addresses: list[str], version: int = 1,
        standbys: list[str | None] | None = None,
    ) -> "PartitionMap":
        """An initial map: the hash space sliced into ``len(addresses)``
        equal contiguous ranges, one per address.  ``standbys`` (same
        length, entries may be ``None``) stamps each partition's warm
        standby for a replicated fleet (a v2 map)."""
        n = len(addresses)
        if n < 1:
            raise ValueError("a partition map needs at least one address")
        if standbys is not None and len(standbys) != n:
            raise ValueError(
                f"standbys must match addresses ({len(standbys)} != {n})"
            )
        bounds = [HASH_SPACE * i // n for i in range(n)] + [HASH_SPACE]
        return cls(version, [
            Partition(
                i, addr, ((bounds[i], bounds[i + 1]),),
                standby=standbys[i] if standbys is not None else None,
            )
            for i, addr in enumerate(addresses)
        ])

    def split(
        self, source: int, new_address: str
    ) -> tuple["PartitionMap", tuple[tuple[int, int], ...]]:
        """``(new_map, moved_ranges)``: halve the source partition's
        largest range, hand the upper half to a new partition appended at
        index N, bump the version.  The moved ranges are what the live
        split flow uses to select the users that change owner."""
        if not 0 <= source < len(self.partitions):
            raise ValueError(f"no partition {source} in map v{self.version}")
        src = self.partitions[source]
        lo, hi = max(src.ranges, key=lambda r: r[1] - r[0])
        if hi - lo < 2:
            raise ValueError(
                f"partition {source} owns no splittable range (largest is "
                f"[{lo}, {hi}))"
            )
        mid = (lo + hi) // 2
        moved = ((mid, hi),)
        kept = tuple(r for r in src.ranges if r != (lo, hi)) + ((lo, mid),)
        parts = list(self.partitions)
        parts[source] = Partition(
            src.index, src.address, kept, standby=src.standby
        )
        parts.append(Partition(len(parts), new_address, moved))
        return PartitionMap(self.version + 1, parts), moved

    def set_standby(self, index: int, standby: str | None) -> "PartitionMap":
        """A copy with partition ``index``'s warm-standby address set (or
        cleared with ``None``), version bumped — the ``fleet set-standby``
        CLI's operation."""
        if not 0 <= index < len(self.partitions):
            raise ValueError(f"no partition {index} in map v{self.version}")
        parts = list(self.partitions)
        p = parts[index]
        parts[index] = Partition(p.index, p.address, p.ranges,
                                 standby=standby)
        return PartitionMap(self.version + 1, parts)

    def swap_standby(self, index: int) -> "PartitionMap":
        """A copy with partition ``index``'s primary and standby addresses
        swapped, version bumped — the map flip after a coordinated
        handover (the old standby now serves; the restarted old primary
        comes back as the standby)."""
        if not 0 <= index < len(self.partitions):
            raise ValueError(f"no partition {index} in map v{self.version}")
        p = self.partitions[index]
        if not p.standby:
            raise ValueError(
                f"partition {index} has no standby to swap with"
            )
        parts = list(self.partitions)
        parts[index] = Partition(p.index, p.standby, p.ranges,
                                 standby=p.address)
        return PartitionMap(self.version + 1, parts)

    # -- (de)serialization -------------------------------------------------

    def to_doc(self) -> dict:
        # the standby key (and the /2 schema tag) appear only when some
        # partition actually has one: a standby-free map round-trips to
        # the exact v1 document, digest included
        has_standby = any(p.standby for p in self.partitions)
        doc = {
            "schema": SCHEMA_V2 if has_standby else SCHEMA,
            "version": self.version,
            "partitions": [
                {
                    "index": p.index,
                    "address": p.address,
                    "ranges": [[lo, hi] for lo, hi in p.ranges],
                    **({"standby": p.standby} if p.standby else {}),
                }
                for p in self.partitions
            ],
        }
        doc["digest"] = _digest(doc)
        return doc

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_doc(cls, doc: dict) -> "PartitionMap":
        """Parse + validate one map document.  The file (and the ops
        plane's ``/partitionmap`` body) is a trust boundary for routing:
        anything structurally off — wrong schema, non-integer version,
        overlapping or non-exhaustive ranges, digest mismatch — raises
        ``ValueError`` (never anything else; the fuzz harness holds
        that)."""
        try:
            if not isinstance(doc, dict):
                raise ValueError("partition map must be a JSON object")
            if doc.get("schema") not in _SCHEMAS:
                raise ValueError(
                    f"unknown partition-map schema: {doc.get('schema')!r}"
                )
            claimed = doc.get("digest")
            if claimed is not None and claimed != _digest(doc):
                raise ValueError("partition map digest mismatch")
            raw = doc.get("partitions")
            if not isinstance(raw, list):
                raise ValueError("partitions must be a list")
            parts = []
            for entry in raw:
                if not isinstance(entry, dict):
                    raise ValueError("partition entry must be an object")
                address = entry.get("address")
                if not isinstance(address, str) or not address:
                    raise ValueError("partition address must be non-empty")
                ranges = entry.get("ranges")
                if not isinstance(ranges, list) or not ranges:
                    raise ValueError("partition ranges must be non-empty")
                standby = entry.get("standby")
                if standby is not None and (
                    not isinstance(standby, str) or not standby
                ):
                    raise ValueError(
                        "partition standby must be a non-empty string "
                        "when present"
                    )
                parts.append(Partition(
                    int(entry.get("index")),
                    address,
                    tuple((int(lo), int(hi)) for lo, hi in ranges),
                    standby=standby,
                ))
            return cls(int(doc.get("version")), parts)
        except ValueError:
            raise
        except Exception as e:  # hostile structure -> one exception type
            raise ValueError(f"malformed partition map: {e!r}") from None

    @classmethod
    def from_json(cls, text: str | bytes) -> "PartitionMap":
        try:
            doc = json.loads(text)
        except Exception as e:
            raise ValueError(f"partition map is not JSON: {e}") from None
        return cls.from_doc(doc)

    @classmethod
    def load(cls, path: str) -> "PartitionMap":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())

    def store(self, path: str) -> None:
        """Atomic write (tmp + fsync + rename): a reader — or a split
        SIGKILLed mid-flip — sees the old map or the new one, never a
        torn document."""
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(
            prefix="." + os.path.basename(path) + ".tmp.", dir=d
        )
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.to_json())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        # the map is routing config, not a secret: world-readable like
        # any deploy manifest
        os.chmod(path, 0o644)

    @property
    def digest(self) -> str:
        return _digest(self.to_doc())

    def short_digest(self) -> str:
        return self.digest[:12]


def fetch_partition_map(url: str, timeout: float = 5.0) -> PartitionMap:
    """Fetch + validate a map from an ops plane's ``/partitionmap`` (or
    any HTTP source).  Synchronous — async callers wrap it in
    ``asyncio.to_thread`` or pass ``lambda: asyncio.to_thread(...)`` as
    ``AuthClient(map_refresh=...)``."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return PartitionMap.from_json(r.read())


def _digest(doc: dict) -> str:
    body = {k: v for k, v in doc.items() if k != "digest"}
    return hashlib.sha256(
        json.dumps(body, separators=(",", ":"), sort_keys=True).encode()
    ).hexdigest()


def _validate(version: int, partitions: list[Partition]) -> None:
    if version < 1:
        raise ValueError(f"partition map version must be >= 1, got {version}")
    if not partitions:
        raise ValueError("a partition map needs at least one partition")
    if len(partitions) > MAX_PARTITIONS:
        raise ValueError(
            f"partition map exceeds {MAX_PARTITIONS} partitions"
        )
    if [p.index for p in partitions] != list(range(len(partitions))):
        raise ValueError(
            "partition indexes must be exactly 0..N-1 in order"
        )
    ranges: list[tuple[int, int, int]] = []
    for p in partitions:
        if not p.address:
            raise ValueError(f"partition {p.index} has an empty address")
        if p.standby is not None and p.standby == p.address:
            raise ValueError(
                f"partition {p.index} standby equals its primary address "
                f"({p.address!r})"
            )
        for lo, hi in p.ranges:
            if not (0 <= lo < hi <= HASH_SPACE):
                raise ValueError(
                    f"partition {p.index} range [{lo}, {hi}) is outside "
                    f"[0, {HASH_SPACE})"
                )
            ranges.append((lo, hi, p.index))
    ranges.sort()
    # disjoint AND exhaustive: sorted ranges must tile [0, HASH_SPACE)
    # exactly — this is what makes routing a total function
    cursor = 0
    for lo, hi, idx in ranges:
        if lo != cursor:
            kind = "overlap" if lo < cursor else "gap"
            raise ValueError(
                f"partition ranges have a {kind} at {min(lo, cursor)} "
                f"(partition {idx})"
            )
        cursor = hi
    if cursor != HASH_SPACE:
        raise ValueError(
            f"partition ranges end at {cursor}, not {HASH_SPACE} (gap at "
            "the top of the hash space)"
        )


class FleetRouter:
    """One daemon's view of the map: *this* partition's index plus the
    loaded :class:`PartitionMap`, with the ownership check the service
    layer runs on every auth RPC.

    The N=1 fast path is structural: a single-partition map makes
    :meth:`owns` a constant ``True`` with **no hash computed** — a daemon
    with fleet routing on a one-partition map pays nothing on the hot
    path.
    """

    def __init__(self, pmap: PartitionMap, self_index: int,
                 map_path: str = ""):
        if not 0 <= self_index < len(pmap.partitions):
            raise ValueError(
                f"partition index {self_index} is not in map "
                f"v{pmap.version} ({len(pmap.partitions)} partitions)"
            )
        self.map = pmap
        self.self_index = self_index
        self.map_path = map_path
        self.redirects = 0  # process-lifetime count behind /statusz
        self._single = len(pmap.partitions) == 1
        self._export_gauges()

    def _export_gauges(self) -> None:
        from ..server import metrics

        metrics.gauge("fleet.partition").set(float(self.self_index))
        metrics.gauge("fleet.map_version").set(float(self.map.version))

    # -- the ownership check (the service's hot path) ----------------------

    def owns(self, user_id: str) -> bool:
        """Whether this partition owns ``user_id``.  Single-partition
        maps short-circuit before hashing (the N=1 fast path)."""
        if self._single:
            return True
        return self.map.partition_for(user_id).index == self.self_index

    def owner(self, user_id: str) -> Partition:
        return self.map.partition_for(user_id)

    # -- reload (operator REPL / split runbook) ----------------------------

    def reload(self) -> bool:
        """Re-read the map file; adopt it when its version is strictly
        newer (a split flipped it).  Returns whether the map changed.
        The self partition keeps its index — a reload that drops this
        partition from the map raises rather than silently serving an
        unowned keyspace."""
        if not self.map_path:
            return False
        pmap = PartitionMap.load(self.map_path)
        if pmap.version <= self.map.version:
            return False
        if self.self_index >= len(pmap.partitions):
            raise ValueError(
                f"map v{pmap.version} has {len(pmap.partitions)} "
                f"partitions; this daemon is partition {self.self_index}"
            )
        self.map = pmap
        self._single = len(pmap.partitions) == 1
        self._export_gauges()
        return True

    # -- introspection (/statusz fleet block) ------------------------------

    def status(self) -> dict:
        me = self.map.partitions[self.self_index]
        return {
            "partition": self.self_index,
            "partitions": len(self.map.partitions),
            "map_version": self.map.version,
            "map_digest": self.map.short_digest(),
            "address": me.address,
            "standby": me.standby,
            "owned_ranges": [[lo, hi] for lo, hi in me.ranges],
            "owned_span_fraction": round(me.span() / HASH_SPACE, 6),
            "redirects": self.redirects,
        }
