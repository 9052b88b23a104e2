"""Fleet CLI: build, inspect, and grow the partition map.

Subcommands::

    python -m cpzk_tpu_torch.fleet init --addresses a:1,b:2,c:3 --out map.json
    python -m cpzk_tpu_torch.fleet show --map map.json
    python -m cpzk_tpu_torch.fleet route --map map.json USER_ID [USER_ID ...]
    python -m cpzk_tpu_torch.fleet split --map map.json --source 0 \\
        --new-address d:4 --source-state p0.json --target-state p3.json
    python -m cpzk_tpu_torch.fleet set-standby --map map.json --partition 0 \\
        --standby a2:1
    python -m cpzk_tpu_torch.fleet rolling-restart --map map.json

``split`` is crash-resumable: SIGKILL it at any stage and re-running the
identical command completes the split (see ``fleet/split.py`` and the
reference's runbook, ``docs/operations.md`` §"Partitioned fleet").

``rolling-restart`` walks an N-partition replicated fleet one partition
at a time: coordinated handover to the partition's warm
standby (zero acked-write loss, write blackout bounded by one ship RTT +
promotion), verify the new primary serves, flip the map entry
(``swap_standby``), then move on — refusing to touch the next partition
while the previous one is unhealthy.  The deposed primaries are left
draining for the operator to restart (they come back as the standbys the
flipped map already names).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def cmd_init(args) -> int:
    from .partition_map import PartitionMap

    addresses = [a.strip() for a in args.addresses.split(",") if a.strip()]
    standbys = None
    if args.standbys:
        standbys = [
            (s.strip() or None) for s in args.standbys.split(",")
        ]
        if len(standbys) != len(addresses):
            raise ValueError(
                f"--standbys needs {len(addresses)} comma-separated "
                f"entries (blank = no standby), got {len(standbys)}"
            )
    pmap = PartitionMap.uniform(addresses, standbys=standbys)
    pmap.store(args.out)
    print(json.dumps({
        "path": args.out, "version": pmap.version,
        "partitions": len(pmap.partitions), "digest": pmap.short_digest(),
    }))
    return 0


def cmd_set_standby(args) -> int:
    from .partition_map import PartitionMap

    pmap = PartitionMap.load(args.map).set_standby(
        args.partition, args.standby or None
    )
    pmap.store(args.map)
    print(json.dumps({
        "path": args.map, "version": pmap.version,
        "partition": args.partition,
        "standby": pmap.partitions[args.partition].standby,
        "digest": pmap.short_digest(),
    }))
    return 0


def cmd_show(args) -> int:
    from .partition_map import PartitionMap

    pmap = PartitionMap.load(args.map)
    print(pmap.to_json(), end="")
    return 0


def cmd_route(args) -> int:
    from .partition_map import PartitionMap, user_hash

    pmap = PartitionMap.load(args.map)
    for uid in args.user_ids:
        p = pmap.partition_for(uid)
        print(json.dumps({
            "user_id": uid, "hash": user_hash(uid),
            "partition": p.index, "address": p.address,
            "map_version": pmap.version,
        }))
    return 0


def cmd_split(args) -> int:
    from .split import SplitError, run_split

    try:
        report = asyncio.run(run_split(
            args.map, args.source, args.new_address,
            args.source_state, args.target_state,
            source_wal=args.source_wal,
            target_wal=args.target_wal,
            source_epoch_file=args.source_epoch,
            target_epoch_file=args.target_epoch,
            segment_bytes=args.segment_bytes,
        ))
    except SplitError as e:
        print(f"split: {e}", file=sys.stderr)
        return 2
    print(json.dumps(report))
    return 0


async def _replication_status(address: str, timeout: float):
    """One ReplicationStatus probe (no lease renewal) — returns the
    response or raises."""
    import grpc

    from ..replication.wire import ReplicationStub

    channel = grpc.aio.insecure_channel(address)
    try:
        stub = ReplicationStub(channel)
        return await stub.replication_status(
            stub.pb2.ReplicationStatusRequest(), timeout=timeout
        )
    finally:
        await channel.close()


async def _serving_primary(address: str, timeout: float) -> bool:
    try:
        resp = await _replication_status(address, timeout)
    except Exception:
        return False
    return resp.role == "primary"


async def _roll_fleet(args) -> int:
    import grpc

    from ..replication.wire import ReplicationStub
    from .partition_map import PartitionMap

    pmap = PartitionMap.load(args.map)
    rolled = []
    prev_primary: str | None = None
    for index in range(len(pmap.partitions)):
        pmap = PartitionMap.load(args.map)  # pick up our own flips
        p = pmap.partitions[index]
        if not p.standby:
            print(json.dumps({
                "partition": index, "address": p.address,
                "skipped": "no standby in the map",
            }))
            continue
        # the safety rail: never take partition N down while partition
        # N-1's new primary is not verifiably serving
        if prev_primary is not None and not await _serving_primary(
            prev_primary, args.timeout
        ):
            print(
                f"rolling-restart: REFUSING to roll partition {index} — "
                f"previous partition's new primary {prev_primary} is not "
                "healthy; fix it and re-run (completed partitions are "
                "already flipped in the map)",
                file=sys.stderr,
            )
            return 3
        channel = grpc.aio.insecure_channel(p.address)
        try:
            stub = ReplicationStub(channel)
            resp = await stub.handover(
                stub.pb2.HandoverRequest(
                    phase="initiate", reason="rolling-restart"
                ),
                timeout=args.timeout,
            )
        except grpc.aio.AioRpcError as e:
            print(
                f"rolling-restart: partition {index} primary {p.address} "
                f"unreachable ({e.code().name}); stopping",
                file=sys.stderr,
            )
            return 3
        finally:
            await channel.close()
        if not resp.ok:
            print(
                f"rolling-restart: partition {index} handover refused: "
                f"{resp.message}; stopping",
                file=sys.stderr,
            )
            return 3
        # verify the promoted standby actually serves as primary at the
        # new epoch before flipping the map and moving on
        deadline = asyncio.get_running_loop().time() + args.timeout
        promoted = False
        while asyncio.get_running_loop().time() < deadline:
            try:
                st = await _replication_status(p.standby, args.timeout)
                if st.role == "primary" and st.epoch >= resp.epoch:
                    promoted = True
                    break
            except Exception:
                pass
            await asyncio.sleep(0.1)
        if not promoted:
            print(
                f"rolling-restart: partition {index} standby {p.standby} "
                f"did not surface as primary at epoch {resp.epoch}; "
                "stopping (map NOT flipped for this partition)",
                file=sys.stderr,
            )
            return 3
        pmap = pmap.swap_standby(index)
        pmap.store(args.map)
        rolled.append(index)
        prev_primary = pmap.partitions[index].address
        print(json.dumps({
            "partition": index, "new_primary": prev_primary,
            "old_primary": pmap.partitions[index].standby,
            "epoch": int(resp.epoch), "fence_seq": int(resp.fence_seq),
            "handover_ms": round(resp.duration_s * 1000.0, 1),
            "map_version": pmap.version,
        }))
    print(json.dumps({
        "rolled": rolled, "partitions": len(pmap.partitions),
        "map_version": pmap.version,
    }))
    return 0


def cmd_rolling_restart(args) -> int:
    return asyncio.run(_roll_fleet(args))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cpzk_tpu_torch.fleet",
        description="partition-map fleet tooling",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    i = sub.add_parser("init", help="write an initial uniform partition map")
    i.add_argument("--addresses", required=True,
                   help="comma-separated partition addresses, index order")
    i.add_argument("--standbys", default="",
                   help="comma-separated warm-standby addresses, index "
                        "order (blank entry = no standby); makes a "
                        "schema-v2 map")
    i.add_argument("--out", required=True)
    i.set_defaults(fn=cmd_init)

    s = sub.add_parser("show", help="print a validated partition map")
    s.add_argument("--map", required=True)
    s.set_defaults(fn=cmd_show)

    r = sub.add_parser("route", help="resolve user ids to partitions")
    r.add_argument("--map", required=True)
    r.add_argument("user_ids", nargs="+")
    r.set_defaults(fn=cmd_route)

    sp = sub.add_parser(
        "split",
        help="move half the source partition's largest hash range onto a "
             "new partition (crash-resumable; see fleet/split.py)",
    )
    sp.add_argument("--map", required=True)
    sp.add_argument("--source", type=int, required=True,
                    help="index of the partition to split")
    sp.add_argument("--new-address", required=True,
                    help="serving address of the new partition")
    sp.add_argument("--source-state", required=True,
                    help="the source partition's state_file")
    sp.add_argument("--target-state", required=True,
                    help="the new partition's state_file (created)")
    sp.add_argument("--source-wal", default=None,
                    help="default <source-state>.wal")
    sp.add_argument("--target-wal", default=None,
                    help="default <target-state>.wal")
    sp.add_argument("--source-epoch", default=None,
                    help="default <source-state>.epoch")
    sp.add_argument("--target-epoch", default=None,
                    help="default <target-state>.epoch")
    sp.add_argument("--segment-bytes", type=int, default=65536)
    sp.set_defaults(fn=cmd_split)

    ss = sub.add_parser(
        "set-standby",
        help="stamp (or clear) a partition's warm-standby address in the "
             "map (bumps the version; a standby-free map stays schema v1)",
    )
    ss.add_argument("--map", required=True)
    ss.add_argument("--partition", type=int, required=True)
    ss.add_argument("--standby", default="",
                    help="standby address; empty clears it")
    ss.set_defaults(fn=cmd_set_standby)

    rr = sub.add_parser(
        "rolling-restart",
        help="coordinated handover across the fleet, one partition at a "
             "time (zero acked-write loss; refuses to proceed past an "
             "unhealthy partition)",
    )
    rr.add_argument("--map", required=True)
    rr.add_argument("--timeout", type=float, default=15.0,
                    help="per-step deadline in seconds (handover RPC, "
                         "promotion poll, health probe)")
    rr.set_defaults(fn=cmd_rolling_restart)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError) as e:
        print(f"fleet: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
