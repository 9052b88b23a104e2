"""Twins of ``tests/test_ingest.py`` for the port's sharded ingest
(``cpzk_tpu_torch/server/ingest.py``): N SO_REUSEPORT listener processes
feeding the dispatch/state process over the CRC-framed unix-socket seam.

The shards are the port's own processes (spawned, never forked) and the
handlers behind the seam are the port's ``AuthServiceImpl`` with its
``CpuBackend`` passed explicitly (the port's ``serve`` with no backend
means the card).  The client is the reference's ``AuthClient``; the
malformed-batch case holds the sharded answers to the reference's
in-process server as well as to the port's.
"""

import asyncio
import contextlib
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import cpzk_tpu as J
from cpzk_tpu.client import AuthClient
from cpzk_tpu.server import RateLimiter as JRateLimiter
from cpzk_tpu.server import ServerState as JServerState
from cpzk_tpu.server.service import serve as j_serve
from cpzk_tpu_torch.protocol.batch import CpuBackend
from cpzk_tpu_torch.server import ingest as ingest_mod
from cpzk_tpu_torch.server.config import RateLimiter
from cpzk_tpu_torch.server.service import serve
from cpzk_tpu_torch.server.state import ServerState

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(coro):
    return asyncio.run(coro)


class SeededRng:
    def __init__(self, seed: int):
        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._g.bytes(n)


# --- framing ------------------------------------------------------------------


def test_frame_roundtrip_and_corruption():
    async def main():
        payload = b"x" * 1000
        frame = ingest_mod.pack_frame(payload)
        reader = asyncio.StreamReader()
        reader.feed_data(frame)
        reader.feed_eof()
        assert await ingest_mod.read_frame(reader) == payload
        assert await ingest_mod.read_frame(reader) is None  # clean EOF

        # CRC corruption: torn down, never surfaced as a frame
        bad = bytearray(frame)
        bad[-1] ^= 1
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(bad))
        reader.feed_eof()
        with pytest.raises(ValueError, match="CRC"):
            await ingest_mod.read_frame(reader)

        # garbage length field: bounded allocation, loud failure
        reader = asyncio.StreamReader()
        reader.feed_data(b"\xff\xff\xff\xff\x00\x00\x00\x00" + b"z" * 64)
        reader.feed_eof()
        with pytest.raises(ValueError, match="out of bounds"):
            await ingest_mod.read_frame(reader)
    run(main())
    # the same bytes as the reference's frame
    from cpzk_tpu.server import ingest as j_ingest

    assert ingest_mod.pack_frame(b"abc" * 7) == j_ingest.pack_frame(b"abc" * 7)


def test_frame_payload_cap():
    with pytest.raises(ValueError, match="exceeds"):
        ingest_mod.pack_frame(b"x" * (ingest_mod.MAX_INGEST_FRAME + 1))


# --- end-to-end through real shard processes ----------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.asynccontextmanager
async def _sharded_stack(shards: int = 2):
    state = ServerState()
    server, bound = await serve(
        state, RateLimiter(10**9, 10**9), port=0, backend=CpuBackend(),
        listen=False)
    assert bound is None
    port = _free_port()
    sup = ingest_mod.IngestSupervisor(
        server.auth_service, server.health,
        shards=shards, host="127.0.0.1", port=port,
    )
    await sup.start()
    try:
        # wait for every shard to bind + connect the dispatch seam
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if all(s["connected"] for s in sup.shard_stats.values()):
                break
            await asyncio.sleep(0.1)
        else:
            raise AssertionError(f"shards never connected: {sup.status()}")
        yield sup, port, state, server
    finally:
        await sup.stop()
        await server.stop(None)


def _corpus(n=4, seed=7):
    rng = SeededRng(seed)
    params = J.Parameters.new()
    provers = [J.Prover(params, J.Witness(J.Ristretto255.random_scalar(rng)))
               for _ in range(n)]
    return rng, provers


async def _login_wave(client, provers, rng, prefix):
    eb = J.Ristretto255.element_to_bytes
    ids = [f"{prefix}{i}" for i in range(len(provers))]
    resp = await client.register_batch(
        ids,
        [eb(p.statement.y1) for p in provers],
        [eb(p.statement.y2) for p in provers],
    )
    assert all(r.success for r in resp.results), [
        r.message for r in resp.results]
    cids, proofs = [], []
    for uid, p in zip(ids, provers):
        ch = await client.create_challenge(uid)
        cid = bytes(ch.challenge_id)
        t = J.Transcript()
        t.append_context(cid)
        cids.append(cid)
        proofs.append(p.prove_with_transcript(rng, t).to_bytes())
    return ids, cids, proofs


def test_sharded_ingest_serves_batch_stream_health():
    rng, provers = _corpus()

    async def main():
        async with _sharded_stack(shards=2) as (sup, port, _state, _server):
            async with AuthClient(f"127.0.0.1:{port}") as client:
                ids, cids, proofs = await _login_wave(
                    client, provers, rng, "w")
                resp = await client.verify_proof_batch(ids, cids, proofs)
                assert all(r.success for r in resp.results), [
                    r.message for r in resp.results]
                # stream through the proxy (reader/responder + credits)
                ids, cids, proofs = [], [], []
                for i, p in enumerate(provers):
                    ch = await client.create_challenge(f"w{i}")
                    cid = bytes(ch.challenge_id)
                    t = J.Transcript()
                    t.append_context(cid)
                    ids.append(f"w{i}")
                    cids.append(cid)
                    proofs.append(p.prove_with_transcript(rng, t).to_bytes())
                n_ok = 0
                async for chunk in client.verify_proof_stream_chunks(
                    list(zip(ids, cids, proofs)), chunk=2
                ):
                    n_ok += sum(chunk[1])
                assert n_ok == len(provers)
                # health proxied too
                hc = await client.health_check()
                assert hc is not None
            st = sup.status()
            assert sum(s["rpcs"] for s in st["per_shard"]) > 0
            assert sum(s["parses"] for s in st["per_shard"]) > 0
    run(main())


def test_sharded_malformed_batch_parity_with_in_process():
    """A coalesced batch with malformed wires answers through the shard
    seam exactly as the port's and the reference's in-process native
    paths do."""

    async def _mixed_wave(client, seed):
        rng, provers = _corpus(seed=seed)
        ids, cids, proofs = await _login_wave(client, provers, rng, "m")
        proofs[1] = proofs[1][:50]
        proofs[2] = b""
        resp = await client.verify_proof_batch(ids, cids, proofs)
        return [(r.success, r.message) for r in resp.results]

    async def in_process(serve_fn, state, limiter, **kw):
        server, port = await serve_fn(state, limiter, port=0, wire="native", **kw)
        try:
            async with AuthClient(f"127.0.0.1:{port}") as client:
                return await _mixed_wave(client, 11)
        finally:
            await server.stop(None)

    async def sharded():
        async with _sharded_stack(shards=2) as (_sup, port, _state, _server):
            async with AuthClient(f"127.0.0.1:{port}") as client:
                return await _mixed_wave(client, 11)

    ref = run(in_process(j_serve, JServerState(), JRateLimiter(10**9, 10**9)))
    a = run(in_process(serve, ServerState(), RateLimiter(10**9, 10**9),
                       backend=CpuBackend()))
    b = run(sharded())
    assert a == b == ref
    assert a[0][0] is True and a[3][0] is True
    assert a[1] == (False, "Invalid proof: Truncated proof: incomplete r2 data")
    assert a[2] == (False, "Empty proof 2")


def test_shard_sigkill_respawn_and_serving_through_it():
    rng, provers = _corpus(2)

    async def main():
        async with _sharded_stack(shards=2) as (sup, port, _state, _server):
            async with AuthClient(f"127.0.0.1:{port}") as client:
                ids, cids, proofs = await _login_wave(
                    client, provers, rng, "k")
                resp = await client.verify_proof_batch(ids, cids, proofs)
                assert all(r.success for r in resp.results)
            # SIGKILL shard 0: the daemon keeps serving (remaining shard
            # accepts new connections), and the supervisor respawns it
            victim = sup.shard_stats[0]["pid"]
            os.kill(victim, signal.SIGKILL)
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                row = sup.shard_stats[0]
                if row["respawns"] >= 1 and row["pid"] not in (None, victim):
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError(f"shard never respawned: {sup.status()}")
            assert sup.respawns >= 1
            # serving survived the whole time; retry absorbs the window
            # where a connection could still land on the dying listener
            for attempt in range(10):
                try:
                    async with AuthClient(f"127.0.0.1:{port}") as client:
                        ids, cids, proofs = await _login_wave(
                            client, [provers[0]], rng, f"k2-{attempt}-")
                        resp = await client.verify_proof_batch(
                            ids, cids, proofs)
                        assert all(r.success for r in resp.results)
                    break
                except Exception:
                    await asyncio.sleep(0.5)
            else:
                raise AssertionError("daemon stopped serving after the kill")
            # the respawned shard reconnects the dispatch seam
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                if sup.shard_stats[0]["connected"]:
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError("respawned shard never reconnected")
    run(main())


_SINGLE_SHARD_SCRIPT = """
import asyncio, signal, sys
import cpzk_tpu_torch.server.__main__ as daemon

args = daemon.parse_args(["--no-repl", "--port", "0"])

async def main():
    loop = asyncio.get_running_loop()
    task = loop.create_task(daemon.amain(args, device="cpu"))
    # the daemon installs its signal handlers right after the listener
    # binds: the observable "bound and ready for a clean TERM" marker
    deadline = loop.time() + 60.0
    while loop.time() < deadline:
        if task.done():
            await task  # surface the boot failure
            raise AssertionError("daemon exited before being signalled")
        if signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
            break
        await asyncio.sleep(0.05)
    else:
        raise AssertionError("daemon never installed its signal handlers")
    assert "cpzk_tpu_torch.server.ingest" not in sys.modules, "ingest imported!"
    signal.raise_signal(signal.SIGTERM)
    await task

asyncio.run(main())
assert "cpzk_tpu_torch.server.ingest" not in sys.modules
print("SINGLE-SHARD-STRUCTURAL-OK")
"""


def test_ingest_shards_1_structurally_unchanged(tmp_path):
    """At the default ``ingest_shards = 1`` the daemon (the card's path,
    here on the kernels' plain versions) binds in-process and the ingest
    machinery is never imported, let alone constructed."""
    env = dict(os.environ)
    for key in list(env):
        if key.startswith("SERVER_"):
            env.pop(key)
    env["SERVER_CONFIG_PATH"] = str(tmp_path / "none.toml")  # no config pickup
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run(
        [sys.executable, "-c", _SINGLE_SHARD_SCRIPT],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert "SINGLE-SHARD-STRUCTURAL-OK" in result.stdout
