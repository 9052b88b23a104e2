"""Shared harness of the replication and fleet twins
(``tests/test_torch_replication.py``, ``tests/test_torch_fleet.py``).

Each twin runs one scenario on the reference package and then on the
port, each in a directory of its own, on statements made from a numpy
seed, and requires the two packages' notes to be equal; the reference
test's own assertions hold inside the scenario on both sides.  ``REF``
and ``PORT`` name everything a scenario touches, so one scenario body
serves both packages.  The port's servers are given ``CpuBackend`` (with
no backend they mean the card).
"""

from __future__ import annotations

import asyncio
import inspect
import types

import numpy as np

import cpzk_tpu as J
import cpzk_tpu_torch as T


class SeededRng:
    """The ``fill_bytes`` source both packages' ``random_scalar`` read."""

    def __init__(self, seed: int):
        self._gen = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._gen.bytes(n)


def _ref() -> types.SimpleNamespace:
    from cpzk_tpu import errors
    from cpzk_tpu.client import __main__ as client_main
    from cpzk_tpu.client import rpc
    from cpzk_tpu.client.kdf import password_to_scalar
    from cpzk_tpu.durability import DurabilityManager
    from cpzk_tpu.durability import recovery, wal
    from cpzk_tpu.fleet import FleetRouter, PartitionMap, run_split, user_hash
    from cpzk_tpu.fleet import __main__ as fleet_main
    from cpzk_tpu.fleet import split
    from cpzk_tpu.observability.opsplane import OpsPlane, OpsSources
    from cpzk_tpu.observability.slo import SloEngine
    from cpzk_tpu import replication
    from cpzk_tpu.resilience import faults, retry
    from cpzk_tpu.server import __main__ as server_main
    from cpzk_tpu.server import config, metrics, proto, service, state

    async def handle(cmd, st, *, durability=None, replication=None, fleet=None):
        return await server_main.handle_command(
            cmd, st, None, durability, None, replication, None, fleet)

    return _pkg("reference", J, errors, client_main, rpc, password_to_scalar,
                DurabilityManager, recovery, wal, FleetRouter, PartitionMap, run_split,
                user_hash, fleet_main, split, OpsPlane, OpsSources, SloEngine, replication,
                faults, retry, config, metrics, proto, service, state, handle, {})


def _port() -> types.SimpleNamespace:
    from cpzk_tpu_torch import errors
    from cpzk_tpu_torch.client import __main__ as client_main
    from cpzk_tpu_torch.client import rpc
    from cpzk_tpu_torch.client.kdf import password_to_scalar
    from cpzk_tpu_torch.durability import DurabilityManager
    from cpzk_tpu_torch.durability import recovery, wal
    from cpzk_tpu_torch.fleet import FleetRouter, PartitionMap, run_split, user_hash
    from cpzk_tpu_torch.fleet import __main__ as fleet_main
    from cpzk_tpu_torch.fleet import split
    from cpzk_tpu_torch.observability.opsplane import OpsPlane, OpsSources
    from cpzk_tpu_torch.observability.slo import SloEngine
    from cpzk_tpu_torch import replication
    from cpzk_tpu_torch.protocol.batch import CpuBackend
    from cpzk_tpu_torch.resilience import faults, retry
    from cpzk_tpu_torch.server import __main__ as server_main
    from cpzk_tpu_torch.server import config, metrics, proto, service, state

    async def handle(cmd, st, *, durability=None, replication=None, fleet=None):
        return await server_main.handle_command(
            cmd, st, None, durability, None, replication=replication, fleet=fleet)

    # the port's serve() with no backend means the card: ask for the host
    return _pkg("port", T, errors, client_main, rpc, password_to_scalar,
                DurabilityManager, recovery, wal, FleetRouter, PartitionMap, run_split,
                user_hash, fleet_main, split, OpsPlane, OpsSources, SloEngine, replication,
                faults, retry, config, metrics, proto, service, state, handle,
                {"backend": CpuBackend()})


def _pkg(name, top, errors, client_main, rpc, password_to_scalar, DurabilityManager,
         recovery, wal, FleetRouter, PartitionMap, run_split, user_hash, fleet_main, split,
         OpsPlane, OpsSources, SloEngine, replication, faults, retry, config, metrics,
         proto, service, state, handle, serve_kw) -> types.SimpleNamespace:
    def serve(st, limiter, **kw):
        return service.serve(st, limiter, **{**serve_kw, **kw})

    return types.SimpleNamespace(
        name=name, top=top, Parameters=top.Parameters, Prover=top.Prover,
        Witness=top.Witness, Transcript=top.Transcript, SecureRng=top.SecureRng,
        Ristretto255=top.Ristretto255, errors=errors, WrongPartition=errors.WrongPartition,
        AuthClient=rpc.AuthClient, rpc=rpc, do_login=client_main.do_login,
        do_register=client_main.do_register, password_to_scalar=password_to_scalar,
        DurabilityManager=DurabilityManager, recover_state=recovery.recover_state,
        wal=wal, encode_record=wal.encode_record, iter_frames=wal.iter_frames,
        read_frames=wal.read_frames, WriteAheadLog=wal.WriteAheadLog,
        FleetRouter=FleetRouter, PartitionMap=PartitionMap, run_split=run_split,
        user_hash=user_hash, fleet_main=fleet_main, roll_fleet=fleet_main._roll_fleet,
        SPLIT_CRASH_POINTS=split.SPLIT_CRASH_POINTS, SplitError=split.SplitError,
        manifest_path=split.manifest_path, OpsPlane=OpsPlane, OpsSources=OpsSources,
        SloEngine=SloEngine, repl=replication, Segment=replication.Segment,
        SegmentApplier=replication.SegmentApplier,
        SegmentShipper=replication.SegmentShipper,
        StandbyReplica=replication.StandbyReplica, load_epoch=replication.load_epoch,
        store_epoch=replication.store_epoch, seal_segment=replication.seal_segment,
        split_records=replication.split_records,
        validate_segment=replication.validate_segment,
        ReplicationTimeout=replication.ReplicationTimeout,
        HandoverError=replication.HandoverError, faults=faults,
        FaultPlan=faults.FaultPlan, CrashPoint=faults.CrashPoint, retry=retry,
        RetryPolicy=retry.RetryPolicy, RetryBudget=retry.RetryBudget, config=config,
        ServerConfig=config.ServerConfig, DurabilitySettings=config.DurabilitySettings,
        ReplicationSettings=config.ReplicationSettings, FleetSettings=config.FleetSettings,
        SloSettings=config.SloSettings, RateLimiter=config.RateLimiter, metrics=metrics,
        load_health_pb2=proto.load_health_pb2, service=service, serve=serve,
        ServerState=state.ServerState, UserData=state.UserData, handle=handle,
    )


REF, PORT = _ref(), _port()
BOTH = (REF, PORT)


def run(coro):
    return asyncio.run(coro)


def twin(scenario, tmp_path, *args):
    """``scenario(pkg, workdir, *args)`` on the reference, then on the port
    (each in a directory of its own); the port's notes must equal the
    reference's.  Returns the port's."""
    notes = {}
    for pkg in BOTH:
        workdir = tmp_path / pkg.name
        workdir.mkdir()
        out = scenario(pkg, workdir, *args)
        if inspect.iscoroutine(out):
            out = run(out)
        notes[pkg.name] = out
    assert notes["port"] == notes["reference"]
    return notes["port"]


class Statements:
    """Seeded statements (and their provers) for one package: the k-th
    call gives both packages the same witness."""

    def __init__(self, pkg, seed: int):
        self.pkg = pkg
        self.gen = SeededRng(seed)
        self.params = pkg.Parameters.new()

    def prover(self):
        pkg = self.pkg
        return pkg.Prover(self.params, pkg.Witness(pkg.Ristretto255.random_scalar(self.gen)))

    def __call__(self):
        return self.prover().statement


async def wait_for(predicate, timeout=5.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition not reached in time")
        await asyncio.sleep(interval)


async def make_pair(pkg, tmp_path, lease_ms=400.0, renew_ms=40.0, mode="sync",
                    segment_bytes=65536, standby_faults=None, primary_faults=None,
                    auto_promote=True, wal_segment_bytes=0, fsync="always"):
    """(primary side, standby side) wired over a real gRPC link: the
    reference test's ``make_pair`` for either package."""
    sstate = pkg.ServerState()
    smgr = pkg.DurabilityManager(
        sstate,
        pkg.DurabilitySettings(enabled=True, fsync=fsync,
                               wal_segment_bytes=wal_segment_bytes),
        str(tmp_path / "standby.json"), faults=standby_faults,
    )
    await smgr.recover()
    ssettings = pkg.ReplicationSettings(
        enabled=True, role="standby", lease_ms=lease_ms,
        renew_interval_ms=renew_ms, mode=mode, auto_promote=auto_promote,
    )
    replica = pkg.StandbyReplica(sstate, smgr, ssettings, faults=standby_faults)
    sserver, sport = await pkg.serve(
        sstate, pkg.RateLimiter(100_000, 100_000), port=0, replica=replica
    )
    replica.start()

    pstate = pkg.ServerState()
    pmgr = pkg.DurabilityManager(
        pstate,
        pkg.DurabilitySettings(enabled=True, fsync=fsync,
                               wal_segment_bytes=wal_segment_bytes),
        str(tmp_path / "primary.json"), faults=primary_faults,
    )
    await pmgr.recover()
    psettings = pkg.ReplicationSettings(
        enabled=True, role="primary", peer=f"127.0.0.1:{sport}",
        lease_ms=lease_ms, renew_interval_ms=renew_ms, mode=mode,
        segment_bytes=segment_bytes,
    )
    shipper = pkg.SegmentShipper(pstate, pmgr, psettings, faults=primary_faults)
    pmgr.attach_shipper(shipper)
    if mode == "sync":
        pstate.attach_replication_barrier(shipper.wait_replicated)
    shipper.start()
    return (pstate, pmgr, shipper), (sstate, smgr, replica, sserver, sport)
