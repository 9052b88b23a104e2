"""Driver of the ``daemon`` entry: the program's server,
``python -m cpzk_tpu_torch.server --no-repl``, as a subprocess over
loopback gRPC, with its users registered in set-up and logins from the
clients of :mod:`.loadgen` in processes of their own.

Set-up: the population is made on the card by a process that ends before
the daemon starts; the daemon boots on a TOML written from the
configuration; the users register by ``RegisterBatch``; the client
processes warm up.  The window: logins due in ``seconds``, timed from each
one's due time to its verdict.  The daemon's counters and flight records
are read at the window's start and end.  After the window every login's
verdict, message and session token is compared with what its proof must
get, and a sample drawn from the seed is checked by the group equations
from its wires alone.  A login that the server's admission refused
(RESOURCE_EXHAUSTED, after the client's retries) was answered, not wrongly:
it counts as failed and is missing from the rate and the latency, not from
``correct``.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

from benchmark.harness import check
from benchmark.reference import proofs

LISTENING = re.compile(r"AuthService listening on [^:\s]+:(\d+)")
OPSPLANE = re.compile(r"ops plane on http://[^:\s]+:(\d+)")
LADDERS = ("ladder_combined", "ladder_partials_identity", "ladder_each")


def toml(sections: dict) -> str:
    """A TOML text of top-level keys and one level of tables."""
    def value(v):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return json.dumps(v)
        return repr(v)

    top = [f"{k} = {value(v)}" for k, v in sections.items() if not isinstance(v, dict)]
    tables = [f"[{k}]\n" + "\n".join(f"{kk} = {value(vv)}" for kk, vv in v.items())
              for k, v in sections.items() if isinstance(v, dict)]
    return "\n".join(top) + "\n\n" + "\n\n".join(tables) + "\n"


class Daemon:
    """The server subprocess: its output kept in a file, its ports read
    from it, stopped with SIGTERM (and its process group killed)."""

    def __init__(self, argv, cwd, env, log_path):
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, stdout=self.log,
                                     stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL,
                                     start_new_session=True)
        self.port = self.ops_port = None

    def text(self) -> str:
        return Path(self.log_path).read_text(errors="replace")

    def wait_listening(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            text = self.text()
            if (m := LISTENING.search(text)) is not None:
                self.port = int(m.group(1))
            if (m := OPSPLANE.search(text)) is not None:
                self.ops_port = int(m.group(1))
            if self.port and self.ops_port:
                return
            if self.proc.poll() is not None:
                raise RuntimeError(f"daemon exited {self.proc.returncode}:\n{text[-3000:]}")
            time.sleep(0.05)
        raise RuntimeError(f"daemon not listening within {timeout} s:\n{self.text()[-3000:]}")

    def get(self, path: str) -> str:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.ops_port}{path}", timeout=30) as r:
            return r.read().decode()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()
        self.log.close()


def scrape(text: str) -> dict:
    """Samples of a Prometheus text exposition, keyed by name and labels."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            with contextlib.suppress(ValueError):
                out[key] = float(val)
    return out


def counters(d: Daemon) -> dict:
    s = scrape(d.get("/metrics"))
    get = lambda k: s.get(k, 0.0)
    out = {"launches": {k: get(f'tpu_kernel_launches{{kernel="{k}"}}') for k in LADDERS},
           "failover": get("tpu_backend_failover_total")}
    for rpc in ("CreateChallenge", "VerifyProofBatch"):
        out[rpc] = (get(f'rpc_duration_sum{{rpc="{rpc}"}}'), get(f'rpc_duration_count{{rpc="{rpc}"}}'))
    out["queue_wait"] = (get("tpu_batch_queue_wait_sum"), get("tpu_batch_queue_wait_count"))
    return out


def card_memory_used() -> int | None:
    """Bytes in use on card 0 by every process (``nvidia-smi``)."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return int(float(res.stdout.split()[0]) * 2**20)
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def register(port: int, pop_wires, users: int, batch: int) -> None:
    import grpc

    from benchmark.drivers import loadgen, wire

    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        call = ch.unary_unary(wire.SERVICE + "RegisterBatch")
        y1, y2 = pop_wires["y1"], pop_wires["y2"]
        bad = []

        def one(lo):
            hi = min(users, lo + batch)
            req = wire.batch_register_request(
                [loadgen.user_id(i) for i in range(lo, hi)],
                [y1[i].tobytes() for i in range(lo, hi)], [y2[i].tobytes() for i in range(lo, hi)])
            res = wire.results(call(req, timeout=120))
            bad.extend(m for ok, m, _ in res if not ok)

        threads = [threading.Thread(target=lambda k=k: [one(lo) for lo in range(k * batch, users, 4 * batch)])
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if bad:
            raise RuntimeError(f"{len(bad)} registrations failed: {bad[:3]}")


def run(config, traffic, seed, seconds, trace, chips, options):
    root = Path(__file__).resolve().parents[2]
    users = options.get("users", config["users"])
    rate = traffic["rate"]
    work = Path(tempfile.mkdtemp(prefix="benchmark-daemon-"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    procs: list = []
    daemon = None
    try:
        # -- set-up ------------------------------------------------------------
        setup_parts = {"start": options["age"]()}
        pop_file = work / "population.npz"
        subprocess.run([sys.executable, "-m", "benchmark.drivers.population", "--seed", str(seed),
                        "--users", str(users), "--out", str(pop_file),
                        "--device", options.get("device", "cuda:0")],
                       cwd=root, env=env, check=True)
        server = json.loads(json.dumps(config["server"]))
        if "backend" in options:
            server["tpu"]["backend"] = options["backend"]
        (work / "server.toml").write_text(toml(server))
        denv = dict(env, SERVER_CONFIG_PATH=str(work / "server.toml"))
        daemon = Daemon([sys.executable, "-m", "cpzk_tpu_torch.server", "--no-repl", "--port", "0"],
                        root, denv, work / "daemon.log")
        setup_parts["population"] = options["age"]()
        daemon.wait_listening(config["boot_timeout_s"])
        setup_parts["booted"] = options["age"]()
        from benchmark.drivers import loadgen, population

        x, k, wires = population.load(pop_file)
        register(daemon.port, wires, users, config["register_batch"])
        setup_parts["registered"] = options["age"]()
        nproc = traffic["client_processes"]
        tjson = json.dumps(traffic)
        for i in range(nproc):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.drivers.loadgen", "--port", str(daemon.port),
                 "--population", str(pop_file), "--traffic", tjson,
                 "--retry", json.dumps(config["client_retry"]), "--seed", str(seed),
                 "--seconds", str(seconds), "--proc", str(i),
                 "--procs", str(nproc), "--out", str(work / f"clients{i}.npz")],
                cwd=root, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
        for p in procs:
            line = p.stdout.readline()
            if line.strip() != "ready":
                raise RuntimeError(f"client process said {line!r}")

        # -- the window --------------------------------------------------------
        before = counters(daemon)
        seq0 = max([r["seq"] for r in json.loads(daemon.get("/flightrec"))["records"]], default=0)
        setup_s = options["age"]()
        go = time.monotonic() + 0.2
        for p in procs:
            p.stdin.write(f"go {go!r}\n")
            p.stdin.flush()
        mem = []
        while time.monotonic() < go + seconds:
            if options.get("device", "cuda:0") != "cpu":
                mem.append(card_memory_used())
            time.sleep(min(2.0, max(0.0, go + seconds - time.monotonic())))
        wall_end = time.time()
        after = counters(daemon)
        records = [r for r in json.loads(daemon.get("/flightrec"))["records"]
                   if r["seq"] > seq0 and r["ts"] <= wall_end]
        wall_start = wall_end - (time.monotonic() - go)
        for p in procs:
            if p.wait(timeout=traffic["drain_s"] + 60) != 0:
                raise RuntimeError(f"a client process exited {p.returncode}")
        failover = counters(daemon)["failover"]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if daemon is not None:
            daemon.stop()

    # -- results, once the window has closed ---------------------------------
    sched = loadgen.schedule(seed, rate, seconds, users, traffic["tampered_share"], traffic["gateways"])
    n = len(sched["due"])
    status = np.zeros(n, dtype=np.int8)
    end = np.full(n, np.inf)
    success = np.zeros(n, dtype=bool)
    token = np.zeros(n, dtype=bool)
    sent = np.zeros(n)
    challenged = np.zeros(n)
    retries = np.zeros(n, dtype=np.int16)
    handed = np.zeros(n)
    cid = np.zeros((n, 64), dtype=np.uint8)
    cid_len = np.zeros(n, dtype=np.int16)
    proof = np.zeros((n, proofs.WIRE), dtype=np.uint8)
    messages = {}
    for i in range(len(procs)):
        with np.load(work / f"clients{i}.npz") as f:
            mine = f["mine"]
            for name, arr in (("status", status), ("success", success), ("token", token),
                              ("sent", sent), ("cid", cid), ("cid_len", cid_len), ("proof", proof),
                              ("challenged", challenged), ("handed", handed),
                              ("retries", retries)):
                arr[mine] = f[name][mine]
            answered = f["status"][mine] != 0
            end[mine[answered]] = f["end"][mine][answered]
        messages.update(json.loads((work / f"clients{i}.npz.messages.json").read_text()))
    shutil.rmtree(work, ignore_errors=True)

    expected_ok = ~sched["tampered"]
    want_msg = [f"User '{loadgen.user_id(int(u))}' authenticated successfully" if ok
                else "Authentication failed" for u, ok in zip(sched["user"], expected_ok)]
    if options.get("control"):
        # the reference in the program's place, its challenges bound to no
        # context: the guarantee the control breaks
        success, token = _control(x, k, wires, sched, cid, cid_len, proof, status)
        messages = {str(j): ("User '%s' authenticated successfully" % loadgen.user_id(int(sched["user"][j]))
                             if success[j] else "Authentication failed") for j in range(n)}
    fault = options.get("fault")
    if fault == "flip" and n:
        success[0] = not success[0]
    elif fault == "half":
        status[n // 2:] = 0
        end[n // 2:] = np.inf
    answered = status == loadgen.ANSWERED
    shed = int((status == loadgen.SHED).sum())
    unanswered = int(n - answered.sum()) - shed
    mismatched = tokens_wrong = 0
    examples = []
    for j in range(n):
        if not answered[j]:
            continue
        msg = messages.get(str(j), "")
        bad = success[j] != expected_ok[j] or msg != want_msg[j]
        mismatched += bad
        tokens_wrong += token[j] != expected_ok[j]
        if bad and len(examples) < 5:
            examples.append({"login": j, "success": bool(success[j]), "message": msg,
                             "want": want_msg[j]})
    # a sample drawn from the seed, checked from its wires alone
    rng = proofs.rng_for(seed, 5)
    picks = sorted(set(rng.integers(0, n, min(traffic["sample_logins"], n)).tolist())) if n else []
    picks = [j for j in picks if answered[j]]
    rows = [(cid[j, :cid_len[j]].tobytes(), wires["y1"][sched["user"][j]].tobytes(),
             wires["y2"][sched["user"][j]].tobytes(), proof[j].tobytes()) for j in picks]
    group_ok = proofs.verify_wires(rows)
    sample_bad = sum(1 for j, ok in zip(picks, group_ok) if ok != bool(success[j]) or ok != expected_ok[j])

    on_card = options.get("device", "cuda:0") != "cpu"
    launches = {k: after["launches"][k] - before["launches"][k] for k in LADDERS}
    compared = {
        "logins_mismatched": check(mismatched, "<=", 0),
        "logins_unanswered": check(unanswered, "<=", 0),
        "tokens_mismatched": check(int(tokens_wrong), "<=", 0),
        "sample_group_mismatched": check(sample_bad, "<=", 0),
        "sample_logins": check(len(picks), ">", 0),
        "failovers": check(failover, "<=", 0),
    }
    if on_card:
        compared["ladder_launches"] = check(launches["ladder_combined"] + launches["ladder_each"], ">", 0)
    correct = all(c["ok"] for c in compared.values())

    latency = (end - sched["due"]) * 1e3
    late = (sent - sched["due"])[answered] * 1e3 if answered.any() else np.zeros(1)
    right = int(answered.sum()) - int(mismatched)
    delta = lambda key: (after[key][0] - before[key][0], after[key][1] - before[key][1])
    record = {
        "setup_s": setup_s, "window_s": seconds, "logins_offered": n, "logins_right": right,
        "latency_ms": latency.tolist(), "latencies_finite": bool(np.isfinite(latency).all()),
        "generator_late_ms": {"mean": float(np.mean(late)), "max": float(np.max(late))},
        "rpc": {"CreateChallenge": delta("CreateChallenge"),
                "VerifyProofBatch": delta("VerifyProofBatch")},
        "queue_wait": delta("queue_wait"), "flight_records": records,
        "flight_window_s": wall_end - wall_start, "launches": launches, "trace": None,
    }
    failures: dict = {}
    for j in np.nonzero(~answered)[0]:
        msg = messages.get(str(j), "no answer")
        failures[msg] = failures.get(msg, 0) + 1
    third = max(1, n // 3)
    notes = {
        "rate": rate, "generator_late_ms": record["generator_late_ms"],
        "median_ms_first_third": float(np.median(latency[:third])) if n else None,
        "median_ms_last_third": float(np.median(latency[-third:])) if n else None,
        "unanswered": unanswered, "shed": shed, "failures": failures,
        "device_batches": len(records),
        "challenges_shed": int(retries.sum()), "logins_shed_once": int((retries > 0).sum()),
        "challenge_rtt_ms_median": float(np.median((challenged - sent)[answered]) * 1e3) if answered.any() else None,
        "gather_ms_median": float(np.median((handed - challenged)[answered]) * 1e3) if answered.any() else None,
        "verify_rtt_ms_median": float(np.median((end - handed)[answered]) * 1e3) if answered.any() else None,
        "setup_parts_s": setup_parts,
    }
    busy = sum(r["device_interval_s"] for r in records)
    stages: dict = {}
    for r in records:
        for name, v in r["stages_s"].items():
            stages[name] = stages.get(name, 0.0) + v
    peak = max([m for m in mem if m is not None], default=0)
    return {
        "correct": correct, "attempted": int(n), "failed": int(unanswered + shed + mismatched),
        "device": {"memory_peak_bytes": int(peak), **({"busy_s": busy, "window_s": seconds} if trace else {})},
        "record": record, "compared": compared, "examples": examples, "notes": notes,
        "breakdown": {
            "device_ops": [["device batches (CUDA-event intervals)", busy]],
            # no profiler trace of the daemon: the dispatch lane's stages by
            # the host seconds its batches spent in each
            "idle_gaps": [[f"dispatch stage {k}", v]
                          for k, v in sorted(stages.items(), key=lambda kv: -kv[1])][:10],
        } if trace else None,
    }


def _control(x, k, wires, sched, cid, cid_len, proof, status):
    """Verdicts of the logins by the reference with no context bound."""
    from benchmark.reference import merlin
    from benchmark.reference.group import L

    n = len(sched["due"])
    success = np.zeros(n, dtype=bool)
    idx = np.nonzero(status != 0)[0]
    if len(idx):
        u = sched["user"][idx]
        c = merlin.reduce_wide(merlin.challenge_wide(
            merlin.protocol_start("numpy"), None, proofs.G_BYTES, proofs.H_BYTES,
            wires["y1"][u], wires["y2"][u], wires["r1"][u], wires["r2"][u]))
        for pos, j in enumerate(idx):
            s = int.from_bytes(proof[j, 77:109].tobytes(), "little")
            success[j] = s == (k[u[pos]] + c[pos] * x[u[pos]]) % L
    return success, success.copy()
