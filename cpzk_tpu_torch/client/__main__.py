"""Interactive auth client REPL + bulk subcommands.

The port of ``cpzk_tpu/client/__main__.py``, on the port's host core.

REPL commands (+ short aliases, client.rs:47-123): /register /r,
/login /l, /batch-register /br, /batch-login /bl, /stream-login /sl,
/status /st, /help /h /?, /quit /exit /q.  Passwords never leave the
client; registration sends the statement (y1, y2) derived via the
Argon2id KDF and login proves knowledge of the derived scalar against a
single-use server challenge.

Subcommands (the two bulk workload surfaces, drivable end to end):

- ``python -m cpzk_tpu_torch.client stream --proofs 10000``: register
  ephemeral users (random witnesses, no password KDF), then push proofs
  through the ``VerifyProofStream`` bidi RPC and report throughput +
  verdict counts;
- ``python -m cpzk_tpu_torch.client audit run|verify-report|generate ...``:
  the bulk offline audit pipeline (forwards to ``cpzk_tpu_torch.audit``).

The REPL's password commands derive the witness with Argon2id and need
the ``argon2`` package; ``stream`` and ``audit`` do not.

Run the REPL: ``python -m cpzk_tpu_torch.client --server 127.0.0.1:50051``
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys

import grpc

from .. import Parameters, Prover, SecureRng, Transcript, Witness
from ..core.ristretto import Ristretto255
from .kdf import password_to_scalar
from .rpc import AuthClient


def _c(color: str, text: str) -> str:
    codes = {"green": "32", "red": "31", "yellow": "33", "cyan": "36", "white": "37"}
    if not sys.stdout.isatty():
        return text
    return f"\x1b[{codes[color]}m{text}\x1b[0m"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="cpzk-client", description="Chaum-Pedersen auth client")
    p.add_argument(
        "-s", "--server", default=os.environ.get("AUTH_SERVER", "127.0.0.1:50051")
    )
    p.add_argument(
        "--no-retry", action="store_true",
        help="disable transient-error retries (backoff + budget; "
             "idempotent-safe RPCs only — logins are never retried)",
    )
    sub = p.add_subparsers(dest="cmd")
    st = sub.add_parser(
        "stream",
        help="bulk streaming verification: register ephemeral users, "
             "push proofs through VerifyProofStream, report throughput",
    )
    st.add_argument("--users", type=int, default=64)
    st.add_argument("--proofs", type=int, default=1024)
    st.add_argument("--chunk", type=int, default=512,
                    help="entries packed per stream message")
    st.add_argument("--mint-sessions", action="store_true",
                    help="mint a session per verified proof (unary login "
                         "parity; bulk runs usually skip it)")
    st.add_argument("--client-id", default=None,
                    help="cpzk-client-id for keyed fair admission")
    au = sub.add_parser(
        "audit",
        help="bulk offline audit pipeline (see python -m "
             "cpzk_tpu_torch.audit)",
    )
    au.add_argument("rest", nargs=argparse.REMAINDER,
                    help="arguments forwarded to cpzk_tpu_torch.audit "
                         "(run / verify-report / generate ...)")
    return p.parse_args(argv)


def build_retry_policy(args):
    """Retry policy from the resolved [retry] config (SERVER_RETRY_* env /
    server.toml) unless --no-retry; None = straight-through calls."""
    if args.no_retry:
        return None
    from ..server.config import ServerConfig

    return ServerConfig.from_env().retry.build_policy()


async def do_register(client: AuthClient, user: str, password: str) -> str:
    """client.rs:206-233."""
    x = password_to_scalar(password, user)
    prover = Prover(Parameters.new(), Witness(x))
    st = prover.statement
    try:
        resp = await client.register(
            user,
            Ristretto255.element_to_bytes(st.y1),
            Ristretto255.element_to_bytes(st.y2),
        )
    except grpc.aio.AioRpcError as e:
        return _c("red", f"Failed: {e.details()}")
    color = "green" if resp.success else "red"
    word = "Registered" if resp.success else "Failed"
    return _c(color, f"{word}: {resp.message}")


async def do_login(client: AuthClient, user: str, password: str) -> str:
    """client.rs:235-285: challenge -> prove with challenge-id context -> verify."""
    try:
        ch = await client.create_challenge(user)
        cid = bytes(ch.challenge_id)
        x = password_to_scalar(password, user)
        prover = Prover(Parameters.new(), Witness(x))
        transcript = Transcript()
        transcript.append_context(cid)
        proof = prover.prove_with_transcript(SecureRng(), transcript)
        resp = await client.verify_proof(user, cid, proof.to_bytes())
    except grpc.aio.AioRpcError as e:
        return _c("red", f"Login failed: {e.details()}")
    if resp.success:
        return _c("green", f"Login OK: {resp.message}\n  session: {resp.session_token}")
    return _c("red", f"Login failed: {resp.message}")


async def do_batch_register(client: AuthClient, users: list[str], passwords: list[str]) -> str:
    """client.rs:287-340."""
    y1s, y2s = [], []
    for user, password in zip(users, passwords, strict=True):
        prover = Prover(Parameters.new(), Witness(password_to_scalar(password, user)))
        y1s.append(Ristretto255.element_to_bytes(prover.statement.y1))
        y2s.append(Ristretto255.element_to_bytes(prover.statement.y2))
    try:
        resp = await client.register_batch(users, y1s, y2s)
    except grpc.aio.AioRpcError as e:
        return _c("red", f"Batch register failed: {e.details()}")
    lines = []
    for user, r in zip(users, resp.results):
        color = "green" if r.success else "red"
        lines.append(_c(color, f"  {user}: {r.message}"))
    ok = sum(1 for r in resp.results if r.success)
    lines.append(_c("cyan", f"{ok}/{len(users)} registered"))
    return "\n".join(lines)


async def do_batch_login(client: AuthClient, users: list[str], passwords: list[str]) -> str:
    """client.rs:342-411: per-user challenges, one batch verification RPC."""
    rng = SecureRng()
    ids, cids, proofs = [], [], []
    errors = {}
    for user, password in zip(users, passwords, strict=True):
        try:
            ch = await client.create_challenge(user)
        except grpc.aio.AioRpcError as e:
            errors[user] = e.details()
            continue
        cid = bytes(ch.challenge_id)
        prover = Prover(Parameters.new(), Witness(password_to_scalar(password, user)))
        transcript = Transcript()
        transcript.append_context(cid)
        proofs.append(prover.prove_with_transcript(rng, transcript).to_bytes())
        ids.append(user)
        cids.append(cid)
    lines = [_c("red", f"  {u}: challenge failed: {msg}") for u, msg in errors.items()]
    if ids:
        try:
            resp = await client.verify_proof_batch(ids, cids, proofs)
        except grpc.aio.AioRpcError as e:
            return _c("red", f"Batch login failed: {e.details()}")
        for user, r in zip(ids, resp.results):
            if r.success:
                lines.append(_c("green", f"  {user}: OK session={r.session_token[:16]}..."))
            else:
                lines.append(_c("red", f"  {user}: {r.message}"))
    return "\n".join(lines) if lines else _c("yellow", "nothing to do")


async def do_stream_login(client: AuthClient, users: list[str], passwords: list[str]) -> str:
    """Authenticate several users over ONE VerifyProofStream (the
    streaming twin of /batch-login): per-user challenges, proofs pushed
    down the stream, sessions minted per verified entry."""
    rng = SecureRng()
    entries = []
    order: list[str] = []
    errors = {}
    for user, password in zip(users, passwords, strict=True):
        try:
            ch = await client.create_challenge(user)
        except grpc.aio.AioRpcError as e:
            errors[user] = e.details()
            continue
        cid = bytes(ch.challenge_id)
        prover = Prover(Parameters.new(), Witness(password_to_scalar(password, user)))
        transcript = Transcript()
        transcript.append_context(cid)
        proof = prover.prove_with_transcript(rng, transcript)
        entries.append((user, cid, proof.to_bytes()))
        order.append(user)
    lines = [_c("red", f"  {u}: challenge failed: {msg}")
             for u, msg in errors.items()]
    if entries:
        try:
            k = 0
            async for v in client.verify_proof_stream(
                entries, mint_sessions=True
            ):
                user = order[k]
                k += 1
                if v.ok:
                    token = (v.session_token or "")[:16]
                    lines.append(_c("green", f"  {user}: OK session={token}..."))
                else:
                    lines.append(_c("red", f"  {user}: {v.message}"))
        except grpc.aio.AioRpcError as e:
            return _c("red", f"Stream login failed: {e.details()}")
    return "\n".join(lines) if lines else _c("yellow", "nothing to do")


async def do_status(client: AuthClient, server_addr: str) -> str:
    """client.rs:497-528: probe the server with a timeout'd RPC."""
    try:
        resp = await client.health_check(timeout=2.0)
        if resp.status == 1:
            return _c("green", f"Server {server_addr}: SERVING")
        return _c("yellow", f"Server {server_addr}: NOT SERVING (status={resp.status})")
    except Exception:
        pass
    try:
        await client.create_challenge("__status_probe__", timeout=2.0)
        return _c("green", f"Server {server_addr}: reachable")
    except grpc.aio.AioRpcError as e:
        if e.code() in (grpc.StatusCode.NOT_FOUND, grpc.StatusCode.INVALID_ARGUMENT,
                        grpc.StatusCode.RESOURCE_EXHAUSTED):
            return _c("green", f"Server {server_addr}: reachable")
        return _c("red", f"Server {server_addr}: unreachable ({e.code().name})")


HELP = """Available commands:
  /register <user> <password>            (/r)   register a new user
  /login <user> <password>               (/l)   authenticate
  /batch-register <u1,u2> <p1,p2>        (/br)  register several users
  /batch-login <u1,u2> <p1,p2>           (/bl)  authenticate several users
  /stream-login <u1,u2> <p1,p2>          (/sl)  authenticate over ONE
                                                VerifyProofStream
  /status                                (/st)  probe the server
  /help                                  (/h)   this help
  /quit                                  (/q)   exit"""


async def handle_line(line: str, client: AuthClient, server_addr: str) -> tuple[str, bool]:
    line = line.strip()
    if not line:
        return "", False
    if not line.startswith("/"):
        return "Commands must start with '/'. Type /help for available commands.", False
    parts = line.split(" ", 3)
    cmd = parts[0].lower()

    def two_args(usage: str):
        if len(parts) < 3:
            return None
        return parts[1], parts[2]

    if cmd in ("/register", "/r"):
        args = two_args("/register")
        if args is None:
            return "Usage: /register <user_id> <password>", False
        return await do_register(client, *args), False
    if cmd in ("/login", "/l"):
        args = two_args("/login")
        if args is None:
            return "Usage: /login <user_id> <password>", False
        return await do_login(client, *args), False
    if cmd in ("/batch-register", "/br", "/batch-login", "/bl",
               "/stream-login", "/sl"):
        args = two_args(cmd)
        if args is None:
            return f"Usage: {cmd} <user1,user2,...> <pass1,pass2,...>", False
        users = [u.strip() for u in args[0].split(",")]
        passwords = [p.strip() for p in args[1].split(",")]
        if len(users) != len(passwords):
            return (
                f"Number of users ({len(users)}) must match number of passwords ({len(passwords)})",
                False,
            )
        if cmd in ("/batch-register", "/br"):
            return await do_batch_register(client, users, passwords), False
        if cmd in ("/stream-login", "/sl"):
            return await do_stream_login(client, users, passwords), False
        return await do_batch_login(client, users, passwords), False
    if cmd in ("/status", "/st"):
        return await do_status(client, server_addr), False
    if cmd in ("/help", "/h", "/?"):
        return HELP, False
    if cmd in ("/quit", "/exit", "/q"):
        return "bye", True
    return f"Unknown command: {cmd}. Type /help for available commands.", False


async def stream_main(args) -> int:
    """Bulk streaming verification driver: ephemeral users, per-proof
    challenges (untimed setup), then one timed ``VerifyProofStream``
    pass.  Prints a JSON summary line — the CLI face of the workload
    ``benches/bench_e2e_curve.py`` measures."""
    import json
    import time as _time

    from .. import SecureRng
    from ..core.ristretto import Ristretto255

    rng = SecureRng()
    n_users = max(1, args.users)
    provers = [
        Prover(Parameters.new(), Witness(Ristretto255.random_scalar(rng)))
        for _ in range(n_users)
    ]
    eb = Ristretto255.element_to_bytes
    run_tag = os.urandom(4).hex()
    names = [f"stream-{run_tag}-{i}" for i in range(n_users)]
    async with AuthClient(
        args.server, retry=build_retry_policy(args), client_id=args.client_id
    ) as client:
        resp = await client.register_batch(
            names,
            [eb(p.statement.y1) for p in provers],
            [eb(p.statement.y2) for p in provers],
        )
        if not all(r.success for r in resp.results):
            print(_c("red", "ephemeral user registration failed"), file=sys.stderr)
            return 1
        # proofs are prepared per wave (the per-user outstanding-challenge
        # cap bounds how many can be pending at once) so each timed pass
        # measures the streaming path, not client-side proving
        ok = bad = shed = 0
        dt = 0.0
        done = 0
        wave_cap = n_users * 3  # MAX_CHALLENGES_PER_USER parity
        while done < args.proofs:
            wave = min(args.proofs - done, wave_cap)
            entries = []
            for k in range(wave):
                u = k % n_users
                ch = await client.create_challenge(names[u])
                cid = bytes(ch.challenge_id)
                t = Transcript()
                t.append_context(cid)
                entries.append(
                    (names[u], cid,
                     provers[u].prove_with_transcript(rng, t).to_bytes())
                )
            t0 = _time.perf_counter()
            async for v in client.verify_proof_stream(
                entries, chunk=args.chunk, mint_sessions=args.mint_sessions
            ):
                if v.ok:
                    ok += 1
                elif v.retry_after_ms:
                    shed += 1
                else:
                    bad += 1
            dt += _time.perf_counter() - t0
            done += wave
        print(json.dumps({
            "metric": "stream_cli",
            "proofs": args.proofs,
            "verified": ok,
            "rejected": bad,
            "shed": shed,
            "seconds": round(dt, 3),
            "proofs_per_s": round(args.proofs / dt, 1) if dt > 0 else None,
        }))
        return 0 if bad == 0 else 1


async def amain(args) -> None:
    async with AuthClient(args.server, retry=build_retry_policy(args)) as client:
        print(_c("cyan", f"Connected to {args.server}. Type /help for commands."))
        while True:
            try:
                line = await asyncio.to_thread(input, "> ")
            except (EOFError, KeyboardInterrupt):
                print()
                return
            out, quit_ = await handle_line(line, client, args.server)
            if out:
                print(out)
            if quit_:
                return


def main() -> None:
    args = parse_args()
    if args.cmd == "stream":
        sys.exit(asyncio.run(stream_main(args)))
    if args.cmd == "audit":
        from ..audit.__main__ import main as audit_main

        sys.exit(audit_main(args.rest))
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
