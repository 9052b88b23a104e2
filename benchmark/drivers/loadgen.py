"""The login clients of the ``daemon`` entry: an open loop of independent
users and the gateways that batch their proofs, in a process of its own.

    python3 -m benchmark.drivers.loadgen --port <grpc> --population <npz>
        --traffic <json> --retry <json> --seed <n> --seconds <s>
        --proc <i> --procs <n> --out <npz>

Every process draws the same schedule from the seed (the logins of the
window, their due times, users and the tampered ones) and serves the logins
of its own gateways (gateway g belongs to process g mod procs).  A login
sends ``CreateChallenge`` at its due time, computes its proof for the
challenge and hands it to its gateway; a gateway sends one
``VerifyProofBatch`` when it holds ``batch_max`` proofs or ``gather_ms``
after its first.  A refused ``CreateChallenge`` is sent again by the
protocol client's retry policy (``RetryLimits``, the configuration's
``client_retry``: attempts, backoff, a retry budget for the process's
channel, the server's pushback); ``VerifyProofBatch`` is never sent again,
since the server consumes its challenges.  After a short warm-up the process prints ``ready`` and
waits for ``go <monotonic start>`` on standard input; it writes what each
login got to ``--out`` once every login has an answer or the drain time has
passed.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
import time

import numpy as np

from benchmark.drivers import population, wire
from benchmark.reference import group, merlin, proofs

#: the trailing metadata key of the server's retry pushback
RETRY_PUSHBACK_KEY = "cpzk-retry-after-ms"
#: the longest server pushback a client honours
MAX_PUSHBACK_S = 30.0
#: outcome codes of a login (0: no answer); SHED: refused by the server's
#: admission (RESOURCE_EXHAUSTED) after the retries the policy allows
ANSWERED, CHALLENGE_FAILED, VERIFY_FAILED, SHED = 1, 2, 3, 4


def schedule(seed: int, rate: float, seconds: float, users: int, tampered_share: float,
             gateways: int) -> dict:
    """The window's logins: their count is rate x seconds for every seed;
    their due times uniform order statistics over the window (a Poisson
    process given its count), each a user of a seeded permutation, and
    round(share x count) of them tampered."""
    rng = proofs.rng_for(seed, 3)
    n = int(round(rate * seconds))
    due = np.sort(rng.random(n) * seconds)
    order = rng.permutation(users)
    user = order[np.arange(n) % users]
    tampered = np.zeros(n, dtype=bool)
    tampered[rng.choice(n, size=int(round(tampered_share * n)), replace=False)] = True
    return {"due": due, "user": user, "tampered": tampered,
            "gateway": np.arange(n) % gateways}


class RetryLimits:
    """The protocol client's retry policy (gRFC A6): at most
    ``max_attempts`` sends of a call, retried only on UNAVAILABLE or
    RESOURCE_EXHAUSTED; each retry takes a token of a budget shared by the
    channel (``budget`` tokens, ``token_ratio`` back a success), and waits
    the server's pushback (a negative one: no retry) or else full-jitter
    backoff from ``initial_backoff_ms``, times ``multiplier`` a retry, at
    most ``max_backoff_ms``."""

    RETRYABLE = ("RESOURCE_EXHAUSTED", "UNAVAILABLE")

    def __init__(self, policy: dict, rng):
        self.p = policy
        self.rng = rng
        self.tokens = float(policy["budget"])
        self.lock = threading.Lock()

    def success(self) -> None:
        with self.lock:
            self.tokens = min(float(self.p["budget"]), self.tokens + self.p["token_ratio"])

    def wait_s(self, code: str, attempt: int, pushback_ms) -> float | None:
        """Seconds to wait before sending attempt ``attempt + 1``, or None
        when the call is not sent again."""
        if pushback_ms is not None and pushback_ms < 0:
            return None
        if code not in self.RETRYABLE or attempt >= self.p["max_attempts"]:
            return None
        with self.lock:
            if self.tokens < 1.0:
                return None
            self.tokens -= 1.0
        if pushback_ms is not None:
            return min(MAX_PUSHBACK_S, pushback_ms / 1e3)
        cap = min(self.p["max_backoff_ms"],
                  self.p["initial_backoff_ms"] * self.p["multiplier"] ** (attempt - 1))
        return float(self.rng.random()) * cap / 1e3


def pushback_ms(error) -> float | None:
    for key, value in error.trailing_metadata() or ():
        if key == RETRY_PUSHBACK_KEY:
            try:
                return float(value)
            except ValueError:
                return None
    return None


def user_id(i: int) -> str:
    return f"user{i:06d}"


class Clients:
    def __init__(self, channel, pop, traffic, start_state):
        self.x, self.k, self.wires = pop
        self.start = start_state
        self.challenge = channel.unary_unary(wire.SERVICE + "CreateChallenge")
        self.verify = channel.unary_unary(wire.SERVICE + "VerifyProofBatch")
        self.timeout = traffic["rpc_timeout_s"]
        self.tasks: set = set()

    def proofs_for(self, users, cids, tampered) -> list[bytes]:
        """The proof wires of these logins (one numpy transcript a batch of
        equal-length challenge ids)."""
        out = [b""] * len(users)
        by_len: dict[int, list[int]] = {}
        for j, cid in enumerate(cids):
            by_len.setdefault(len(cid), []).append(j)
        for _, idx in by_len.items():
            u = np.asarray([users[j] for j in idx])
            ctx = np.frombuffer(b"".join(cids[j] for j in idx), dtype=np.uint8).reshape(len(idx), -1)
            w = {name: self.wires[name][u] for name in ("y1", "y2", "r1", "r2")}
            c = merlin.reduce_wide(merlin.challenge_wide(
                self.start, ctx, proofs.G_BYTES, proofs.H_BYTES, w["y1"], w["y2"], w["r1"], w["r2"]))
            for pos, j in enumerate(idx):
                ui = users[j]
                s = (self.k[ui] + c[pos] * self.x[ui] + (1 if tampered[j] else 0)) % group.L
                out[j] = (b"\x01" + b"\x00\x00\x00\x20" + w["r1"][pos].tobytes()
                          + b"\x00\x00\x00\x20" + w["r2"][pos].tobytes()
                          + b"\x00\x00\x00\x20" + s.to_bytes(32, "little"))
        return out


class Gateway:
    """Gathers proofs into ``VerifyProofBatch`` requests."""

    def __init__(self, clients: Clients, record, handed, batch_max: int, gather_s: float):
        self.c = clients
        self.record = record
        self.record_handed = handed
        self.batch_max = batch_max
        self.gather_s = gather_s
        self.items: list = []
        self.timer = None

    def put(self, item):
        self.items.append(item)
        if len(self.items) >= self.batch_max:
            self.flush()
        elif self.timer is None:
            self.timer = asyncio.get_running_loop().call_later(self.gather_s, self.flush)

    def flush(self):
        if self.timer is not None:
            self.timer.cancel()
            self.timer = None
        items, self.items = self.items, []
        if items:
            task = asyncio.get_running_loop().create_task(self.send(items))
            self.c.tasks.add(task)
            task.add_done_callback(self.c.tasks.discard)

    async def send(self, items):
        js = [j for j, _, _, _ in items]
        users = [u for _, u, _, _ in items]
        cids = [cid for _, _, cid, _ in items]
        proof_wires = self.c.proofs_for(users, cids, [t for _, _, _, t in items])
        req = wire.batch_verify_request([user_id(u) for u in users], cids, proof_wires)
        self.record_handed(js)
        try:
            resp = await self.c.verify(req, timeout=self.c.timeout)
            res = wire.results(resp)
        except Exception as e:  # grpc.aio.AioRpcError: every entry failed
            res = None
            code = getattr(e, "code", lambda: e)()
            err = f"VerifyProofBatch: {code}"
            status = SHED if getattr(code, "name", "") == "RESOURCE_EXHAUSTED" else VERIFY_FAILED
        now = time.monotonic()
        for pos, j in enumerate(js):
            if res is None:
                self.record(j, status, now, False, err, None, cids[pos], proof_wires[pos])
            else:
                ok, msg, token = res[pos]
                self.record(j, ANSWERED, now, ok, msg, token, cids[pos], proof_wires[pos])


async def drive(args, traffic, pop, sched, mine, go_at, warm):
    import grpc

    start = merlin.protocol_start("numpy")
    n = len(sched["due"])
    out = {
        "status": np.zeros(n, dtype=np.int8), "sent": np.zeros(n), "end": np.zeros(n),
        "challenged": np.zeros(n), "handed": np.zeros(n), "retries": np.zeros(n, dtype=np.int16),
        "success": np.zeros(n, dtype=bool), "token": np.zeros(n, dtype=bool),
        "cid": np.zeros((n, 64), dtype=np.uint8), "cid_len": np.zeros(n, dtype=np.int16),
        "proof": np.zeros((n, proofs.WIRE), dtype=np.uint8), "messages": {},
    }
    remaining = {"n": 0}
    done = asyncio.Event()
    limits = RetryLimits(json.loads(args.retry), proofs.rng_for(args.seed, 6, args.proc))

    def record(j, status, now, ok, msg, token, cid, proof_wire):
        if j < 0:
            return
        out["status"][j] = status
        out["end"][j] = now - go_at
        out["success"][j] = ok
        out["token"][j] = bool(token)
        out["messages"][int(j)] = msg
        if cid:
            out["cid"][j, :len(cid)] = np.frombuffer(cid, dtype=np.uint8)
            out["cid_len"][j] = len(cid)
        if proof_wire:
            out["proof"][j] = np.frombuffer(proof_wire, dtype=np.uint8)
        remaining["n"] -= 1
        if remaining["n"] == 0:
            done.set()

    async with grpc.aio.insecure_channel(f"127.0.0.1:{args.port}") as channel:
        clients = Clients(channel, pop, traffic, start)
        def handed(js):
            now = time.monotonic() - go_at
            for j in js:
                if j >= 0:
                    out["handed"][j] = now

        gws = {g: Gateway(clients, record, handed, traffic["batch_max"], traffic["gather_ms"] / 1e3)
               for g in range(traffic["gateways"]) if g % args.procs == args.proc}

        async def login(j, u, t, g):
            attempt = 1
            while True:
                try:
                    resp = await clients.challenge(wire.challenge_request(user_id(u)),
                                                   timeout=clients.timeout)
                    limits.success()
                    break
                except grpc.aio.AioRpcError as e:
                    code = e.code().name
                    wait = limits.wait_s(code, attempt, pushback_ms(e))
                    if wait is None:
                        record(j, SHED if code == "RESOURCE_EXHAUSTED" else CHALLENGE_FAILED,
                               time.monotonic(), False, f"CreateChallenge: {e.code()}",
                               None, b"", b"")
                        return
                    if j >= 0:
                        out["retries"][j] += 1
                    attempt += 1
                    await asyncio.sleep(wait)
            if j >= 0:
                out["challenged"][j] = time.monotonic() - go_at
            gws[g].put((j, u, wire.challenge_id(resp), t))

        def spawn(coro):
            task = asyncio.get_running_loop().create_task(coro)
            clients.tasks.add(task)
            task.add_done_callback(clients.tasks.discard)

        # warm-up: a few logins of users the window does not start with
        for i, u in enumerate(warm):
            spawn(login(-1, int(u), False, list(gws)[i % len(gws)]))
        while clients.tasks:
            await asyncio.sleep(0.05)
        print("ready", flush=True)
        line = await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
        go_at = float(line.split()[1])
        remaining["n"] = len(mine)
        if len(mine) == 0:
            done.set()
        for j in mine:
            due = go_at + sched["due"][j]
            delay = due - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            out["sent"][j] = time.monotonic() - go_at
            spawn(login(int(j), int(sched["user"][j]), bool(sched["tampered"][j]),
                        int(sched["gateway"][j])))
        try:
            await asyncio.wait_for(done.wait(), timeout=traffic["drain_s"])
        except asyncio.TimeoutError:
            pass
        for task in list(clients.tasks):
            task.cancel()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--population", required=True)
    p.add_argument("--traffic", required=True, help="the mix's parameters, as JSON")
    p.add_argument("--retry", required=True, help="the client's retry policy, as JSON")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--proc", type=int, required=True)
    p.add_argument("--procs", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    traffic = json.loads(args.traffic)
    pop = population.load(args.population)
    users = len(pop[0])
    sched = schedule(args.seed, traffic["rate"], args.seconds, users, traffic["tampered_share"],
                     traffic["gateways"])
    mine = np.nonzero(sched["gateway"] % args.procs == args.proc)[0]
    # warm-up users: the last ones of the permutation's order
    warm = proofs.rng_for(args.seed, 4, args.proc).choice(users, traffic["warm_logins"], replace=False)
    out = asyncio.run(drive(args, traffic, pop, sched, mine, 0.0, warm))
    messages = out.pop("messages")
    np.savez(args.out, mine=mine, **out)
    with open(args.out + ".messages.json", "w") as f:
        json.dump({str(k): v for k, v in messages.items()}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
