"""Fuzz target: partition-map parse/apply totality + routing invariants.

(A port-owned copy of the reference package's ``fuzz/fuzz_partition_map.py``,
driving ``cpzk_tpu_torch``.)

The partition map is the fleet's routing contract: every
daemon and client loads it from a file or the ops plane's
``/partitionmap`` body, so the parser is a trust boundary and routing
must be a **total function** over arbitrary user ids.

Invariants:
- ``PartitionMap.from_json`` / ``from_doc`` never raise anything but
  ``ValueError`` on arbitrary bytes/structures (parse totality);
- a map that parses is valid by construction: ranges disjoint AND
  exhaustive over the hash space, so ``partition_for`` answers exactly
  one partition for EVERY user id (routing totality), and the answer
  agrees with the owning partition's own ranges;
- serialization round-trips: ``from_json(to_json(m))`` reproduces the
  same version, digest, and routing;
- ``split`` is version-monotonic (+1), produces a map that is again
  disjoint + exhaustive, moves ONLY users from the split partition to
  the new one (every other id keeps its owner), and the moved set is
  exactly the ids hashing into the returned moved ranges — the property
  the live split flow's copy/drain stages rest on.

Run: python tests/torch_fuzz/fuzz_partition_map.py [--seconds 15] [--seed 0]
"""

from __future__ import annotations

import json
import random

from common import run_fuzzer

from cpzk_tpu_torch.fleet.partition_map import (
    HASH_SPACE,
    PartitionMap,
    user_hash,
)


def _seeds() -> list[bytes]:
    m1 = PartitionMap.uniform(["a:1"])
    m3 = PartitionMap.uniform(["a:1", "b:2", "c:3"])
    m4, _ = m3.split(1, "d:4")
    return [
        m1.to_json().encode(),
        m3.to_json().encode(),
        m4.to_json().encode(),
        b"{}",
        b"[1,2,3]",
        json.dumps({"schema": "cpzk-partition-map/1", "version": 1,
                    "partitions": []}).encode(),
    ]


def _user_ids(rng: random.Random, data: bytes) -> list[str]:
    """Arbitrary user ids derived from the input: raw decodes, slices,
    and random unicode — routing must be total over all of them."""
    ids = [
        data.decode("utf-8", "replace")[:64],
        data.decode("latin-1")[:64],
        "",
        "u" * 300,
    ]
    for _ in range(8):
        n = rng.randint(0, 24)
        ids.append("".join(chr(rng.randint(1, 0x10FFF)) for _ in range(n)))
    return ids


def _check_routing(pmap: PartitionMap, ids: list[str]) -> None:
    for uid in ids:
        p = pmap.partition_for(uid)
        h = user_hash(uid)
        assert p.covers(h), "owner's ranges do not cover the id's hash"
        owners = [q.index for q in pmap.partitions if q.covers(h)]
        assert owners == [p.index], "id covered by more than one partition"


def _check_tiling(pmap: PartitionMap) -> None:
    spans = sorted(
        (lo, hi) for p in pmap.partitions for lo, hi in p.ranges
    )
    cursor = 0
    for lo, hi in spans:
        assert lo == cursor, "ranges overlap or gap"
        cursor = hi
    assert cursor == HASH_SPACE, "ranges do not exhaust the hash space"


def one_input(data: bytes) -> None:
    rng = random.Random(len(data) ^ (data[0] if data else 0))

    # 1. parse totality: only ValueError may escape
    pmap = None
    try:
        pmap = PartitionMap.from_json(data)
    except ValueError:
        pass
    if pmap is None:
        return

    # 2. a parsed map is valid: tiling + routing totality
    _check_tiling(pmap)
    ids = _user_ids(rng, data)
    _check_routing(pmap, ids)

    # 3. serialization round-trip: version/digest/routing stable
    again = PartitionMap.from_json(pmap.to_json())
    assert again.version == pmap.version
    assert again.digest == pmap.digest
    for uid in ids:
        assert (
            again.partition_for(uid).index == pmap.partition_for(uid).index
        )

    # 4. split: version monotonic, disjoint+exhaustive, ownership moves
    #    exactly for the moved ranges
    source = rng.randrange(len(pmap.partitions))
    try:
        new_map, moved = pmap.split(source, "new:9")
    except ValueError:
        return  # unsplittable (single-point range): a legitimate refusal
    assert new_map.version == pmap.version + 1
    _check_tiling(new_map)
    new_index = len(pmap.partitions)
    assert new_map.partitions[new_index].ranges == moved
    for uid in ids:
        before = pmap.partition_for(uid).index
        after = new_map.partition_for(uid).index
        in_moved = any(lo <= user_hash(uid) < hi for lo, hi in moved)
        if in_moved:
            assert before == source and after == new_index
        else:
            assert after == before, "split moved an id outside its ranges"


if __name__ == "__main__":
    run_fuzzer(one_input, _seeds())
