"""Twins of ``tests/test_audit.py`` for the port's audit trail
(``cpzk_tpu_torch/audit/``), and the checks that hold it to the reference:

- the proof log (WAL-framed, append-only), the bulk replay pipeline
  (resumable cursor, byte-exact resume after ``max_batches`` and after a
  real SIGKILL, mismatch detection), the Schnorr-signed report (offline
  verification, a single flipped byte fails), the service-side trail
  (unary, batch and stream paths append records), the ``[audit]`` config
  section and the CLI: the reference's 16 cases, on the port;
- the port's ``CpuBackend`` report equal to the reference's byte for byte
  on the same log and key, and a log written by either package replayed
  by the other;
- the card path (``backend="tpu"``) on the kernels' plain versions
  (``device="cpu"``) equal in ``totals`` and ``digest`` to the host's;
- the port's defaults: the card unless ``backend="cpu"``, no CUDA means an
  error (CLI exit 2), and ``lanes != 1`` and a mesh replay through the
  lane router and the sharded backend to the direct replay's bytes;
- the daemon with ``[audit]`` on: the proof log it writes replays to the
  same ``totals`` and ``digest`` through both packages' ``audit run``.

Every replay here asks for the host (``backend="cpu"``) or for the plain
versions (``device="cpu"``): with neither, the port replays on the card.
"""

import asyncio
import dataclasses
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import pytest

import torch_reference_core  # noqa: F401  (the reference's host core, built under a lock)
from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.audit import (
    ProofLogWriter,
    proof_record,
    read_log,
    run_audit,
    scan_records,
    verify_report_file,
)
from cpzk_tpu_torch.audit import sign as audit_sign
from cpzk_tpu_torch.audit.log import validate_proof_record
from cpzk_tpu_torch.audit.pipeline import AuditState
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.errors import InvalidParams
from cpzk_tpu_torch.server.config import AuditSettings, ServerConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent


def run(coro):
    return asyncio.run(coro)


class _SeededRng:
    """``fill_bytes`` from a seeded numpy generator (witnesses, nonces)."""

    def __init__(self, seed: int):
        import numpy as np

        self._g = np.random.default_rng(seed)

    def fill_bytes(self, n: int) -> bytes:
        return self._g.bytes(n)


def make_log(
    path, n, users=4, reject_every=0, mismatch_every=0, rng=None, writer_cls=None,
    now=None,
):
    """A proof log of ``n`` REAL records (same construction as the
    service's trail): returns (writer_seq, provers).  ``writer_cls`` and
    ``now`` let the cross-package cases write with either package's
    writer at a pinned time."""
    rng = rng or SecureRng()
    params = Parameters.new()
    eb = Ristretto255.element_to_bytes
    provers = [
        Prover(params, Witness(Ristretto255.random_scalar(rng)))
        for _ in range(users)
    ]
    writer = (writer_cls or ProofLogWriter)(str(path))
    payloads = []
    for i in range(n):
        prover = provers[i % users]
        ctx = rng.fill_bytes(32)
        t = Transcript()
        t.append_context(ctx)
        wire = prover.prove_with_transcript(rng, t).to_bytes()
        verdict = True
        if reject_every and i % reject_every == 1:
            wire = wire[:-1] + bytes([wire[-1] ^ 1])
            verdict = False
        if mismatch_every and i % mismatch_every == 2:
            verdict = not verdict
        payloads.append(proof_record(
            f"u{i % users}",
            eb(prover.statement.y1), eb(prover.statement.y2),
            ctx, wire, verdict, now=now,
        ))
    writer.append_proofs(payloads)
    writer.close()
    return writer.seq, provers


# --- proof log ---------------------------------------------------------------


def test_proof_log_roundtrip_seq_resume_and_perms(tmp_path):
    path = tmp_path / "p.log"
    seq, _ = make_log(path, 5)
    assert seq == 5
    records, valid, total = read_log(str(path))
    assert [r["seq"] for r in records] == [1, 2, 3, 4, 5]
    assert valid == total
    assert all(validate_proof_record(r) is None for r in records)
    assert oct(path.stat().st_mode & 0o777) == "0o600"

    # reopening resumes the sequence, keeping the prefix contract intact
    w2 = ProofLogWriter(str(path))
    assert w2.seq == 5
    w2.append_proofs([records[0] | {}])  # payload fields reused; new seq
    w2.close()
    records2, valid2, total2 = read_log(str(path))
    assert [r["seq"] for r in records2] == [1, 2, 3, 4, 5, 6]
    assert valid2 == total2


def test_validate_proof_record_rejections():
    good = proof_record("u", b"\x01" * 32, b"\x02" * 32, b"c" * 32,
                        b"p" * 109, True)
    good["type"] = "proof"
    assert validate_proof_record(good) is None
    assert validate_proof_record({"type": "register_user"}) is not None
    for key in ("y1", "y2", "ctx", "p"):
        bad = dict(good)
        bad[key] = "zz-not-hex"
        assert validate_proof_record(bad) == f"bad-{key}"
        bad[key] = ""
        assert validate_proof_record(bad) == f"bad-{key}"
    bad = dict(good)
    bad["v"] = 2
    assert validate_proof_record(bad) == "bad-verdict"
    bad["v"] = True  # JSON booleans are not the 0/1 the service writes
    assert validate_proof_record(bad) == "bad-verdict"
    bad = dict(good)
    bad["u"] = 7
    assert validate_proof_record(bad) == "bad-user"


def test_scan_records_split_resume_equivalence(tmp_path):
    """Scanning from a cursor (offset, prev_seq) at ANY frame boundary
    yields exactly the whole-buffer scan's suffix — the property SIGKILL
    resume rests on."""
    path = tmp_path / "p.log"
    make_log(path, 9)
    buf = path.read_bytes()
    records, valid = scan_records(buf)
    assert len(records) == 9 and valid == len(buf)
    from cpzk_tpu_torch.durability.wal import HEADER_BYTES, _HEADER

    off = 0
    for k in range(9):
        tail, tail_valid = scan_records(
            buf, offset=off, prev_seq=records[k - 1]["seq"] if k else None
        )
        assert tail == records[k:]
        assert tail_valid == valid
        length, _ = _HEADER.unpack_from(buf, off)
        off += HEADER_BYTES + length


# --- pipeline ----------------------------------------------------------------


def test_pipeline_report_totals_and_offline_signature(tmp_path):
    log = tmp_path / "p.log"
    make_log(log, 40, reject_every=10, mismatch_every=13)
    report_path = str(tmp_path / "report.json")
    report = run_audit(str(log), report_path, quantum=16, backend="cpu")
    t = report["totals"]
    assert t["records"] == 40
    assert t["audited"] == 40
    assert t["verified"] + t["rejected"] == 40
    assert t["rejected"] == 4       # i % 10 == 1
    assert t["mismatched"] == 3     # i % 13 == 2 (and not also a reject)
    ok, reason, loaded = verify_report_file(report_path)
    assert ok, reason
    assert loaded["digest"] == report["digest"]
    # the cursor is gone after a completed run
    assert not os.path.exists(report_path + ".cursor")
    # exit-code contract: mismatches are a FINDING
    from cpzk_tpu_torch.audit.__main__ import main as audit_main

    assert audit_main([
        "verify-report", "--report", report_path
    ]) == 0


def test_pipeline_resume_is_byte_exact(tmp_path):
    log = tmp_path / "p.log"
    make_log(log, 30, reject_every=7)
    a = str(tmp_path / "a.json")
    b = str(tmp_path / "b.json")
    key = str(tmp_path / "audit.key")
    full = run_audit(str(log), a, key_path=key, quantum=8, backend="cpu")
    assert full is not None
    # interrupted run: 2 quanta then stop (modelling a crash after the
    # checkpoint landed), then resume to completion
    assert run_audit(str(log), b, key_path=key, quantum=8,
                     max_batches=2, backend="cpu") is None
    assert os.path.exists(b + ".cursor")
    resumed = run_audit(str(log), b, key_path=key, quantum=8, backend="cpu")
    assert resumed is not None
    assert open(a).read() == open(b).read()  # signature included
    assert resumed["digest"] == full["digest"]


def test_pipeline_skips_garbage_and_stops_at_corruption(tmp_path):
    from cpzk_tpu_torch.durability.wal import encode_record

    log = tmp_path / "p.log"
    make_log(log, 6)
    # append a non-proof record (skipped) and a bad-hex proof record
    # (skipped), then a torn tail (scan stops, never raises)
    with open(log, "ab") as f:
        f.write(encode_record({"seq": 7, "type": "register_user", "u": "x"}))
        f.write(encode_record({
            "seq": 8, "type": "proof", "u": "x", "y1": "zz", "y2": "zz",
            "ctx": "00", "p": "00", "v": 1, "t": 0,
        }))
        f.write(b"\x00\x00\x00\x10CORRUPTED-TAIL")
    report = run_audit(str(log), str(tmp_path / "r.json"), quantum=4, backend="cpu")
    t = report["totals"]
    assert t["records"] == 8
    assert t["audited"] == 6 and t["verified"] == 6
    assert t["skipped"] == 2
    assert report["log"]["valid_bytes"] < report["log"]["file_bytes"]
    ok, reason, _ = verify_report_file(str(tmp_path / "r.json"))
    assert ok, reason


def test_report_single_flipped_byte_fails_offline_verify(tmp_path):
    log = tmp_path / "p.log"
    make_log(log, 8)
    report_path = str(tmp_path / "r.json")
    run_audit(str(log), report_path, quantum=4, backend="cpu")
    blob = bytearray(open(report_path, "rb").read())
    # flip one byte in several structurally different places
    for pos in (blob.find(b'"verified"') + 12,
                blob.find(b'"digest"') + 12,
                blob.find(b'"public_key"') + 16):
        tampered = bytearray(blob)
        tampered[pos] = tampered[pos] ^ 0x01 or 0x31
        bad_path = str(tmp_path / "bad.json")
        open(bad_path, "wb").write(bytes(tampered))
        ok, reason, _ = verify_report_file(bad_path)
        assert not ok, f"tamper at {pos} went unnoticed"


def test_wrong_log_for_cursor_refused(tmp_path):
    log1, log2 = tmp_path / "one.log", tmp_path / "two.log"
    make_log(log1, 12)
    make_log(log2, 12)
    report = str(tmp_path / "r.json")
    assert run_audit(str(log1), report, quantum=4, max_batches=1, backend="cpu") is None
    with pytest.raises(ValueError, match="cursor belongs to"):
        run_audit(str(log2), report, quantum=4, backend="cpu")


# --- signatures --------------------------------------------------------------


def test_schnorr_sign_verify_roundtrip(tmp_path):
    key = audit_sign.generate_key()
    pub = audit_sign.public_key(key)
    msg = b"the audit transcript digest"
    r, s = audit_sign.sign(key, msg)
    assert audit_sign.verify(pub, msg, r, s)
    assert not audit_sign.verify(pub, b"another message", r, s)
    other = audit_sign.generate_key()
    assert not audit_sign.verify(audit_sign.public_key(other), msg, r, s)
    # deterministic: same (key, message) -> same signature bytes
    assert audit_sign.sign(key, msg) == (r, s)
    # malformed inputs answer False, never raise
    assert not audit_sign.verify(b"\x00" * 32, msg, r, s)
    assert not audit_sign.verify(pub, msg, b"junk", s)
    assert not audit_sign.verify(pub, msg, r, b"short")


def test_key_file_minted_0600_and_reloaded(tmp_path):
    path = tmp_path / "audit.key"
    k1 = audit_sign.load_or_create_key(str(path))
    assert oct(path.stat().st_mode & 0o777) == "0o600"
    k2 = audit_sign.load_or_create_key(str(path))
    assert k1 == k2
    path.write_text("not hex")
    with pytest.raises(ValueError, match="not hex"):
        audit_sign.load_or_create_key(str(path))


# --- fold-state invariants ---------------------------------------------------


def test_audit_state_cursor_roundtrip(tmp_path):
    st = AuditState()
    st.note({"seq": 1, "type": "proof"}, b"V")
    st.note({"seq": 2, "type": "proof"}, b"R", mismatch=True)
    st.note({"seq": 3, "type": "junk"}, b"S")
    st.offset = 123
    cur = st.to_cursor("/var/log/proofs.log")
    back = AuditState.from_cursor(cur, "/elsewhere/proofs.log")
    assert back.chain == st.chain
    assert back.records == 3 and back.audited == 2
    assert back.mismatched == 1 and back.skipped == 1
    assert back.prev_seq == 3 and back.first_seq == 1
    with pytest.raises(ValueError, match="cursor belongs to"):
        AuditState.from_cursor(cur, "/var/log/other.log")


# --- service-side trail ------------------------------------------------------


def test_service_appends_records_on_all_verify_paths(tmp_path):
    """Unary VerifyProof, VerifyProofBatch, and VerifyProofStream all
    append (statement, challenge, proof, verdict) records; the bulk
    pipeline then re-verifies the trail to an all-clean report.  The
    port's client drives the port's server."""
    import grpc

    from cpzk_tpu_torch.client import AuthClient
    from cpzk_tpu_torch.protocol.batch import CpuBackend
    from cpzk_tpu_torch.server.batching import DynamicBatcher
    from cpzk_tpu_torch.server.config import RateLimiter
    from cpzk_tpu_torch.server.service import serve
    from cpzk_tpu_torch.server.state import ServerState

    log_path = tmp_path / "service.log"

    async def main():
        rng = SecureRng()
        params = Parameters.new()
        provers = [
            Prover(params, Witness(Ristretto255.random_scalar(rng)))
            for _ in range(6)
        ]
        eb = Ristretto255.element_to_bytes
        backend = CpuBackend()
        batcher = DynamicBatcher(backend, max_batch=64, window_ms=1.0)
        audit_log = ProofLogWriter(str(log_path))
        server, port = await serve(
            ServerState(), RateLimiter(10**9, 10**9), port=0,
            backend=backend, batcher=batcher, audit_log=audit_log,
        )
        try:
            async with AuthClient(f"127.0.0.1:{port}") as client:
                for i, p in enumerate(provers):
                    r = await client.register(
                        f"u{i}", eb(p.statement.y1), eb(p.statement.y2))
                    assert r.success

                async def login_args(i):
                    ch = await client.create_challenge(f"u{i}")
                    cid = bytes(ch.challenge_id)
                    t = Transcript()
                    t.append_context(cid)
                    return cid, provers[i].prove_with_transcript(
                        rng, t).to_bytes()

                # unary (1 record)
                cid, wire = await login_args(0)
                assert (await client.verify_proof("u0", cid, wire)).success
                # unary failure (1 record, verdict 0) — bad proof byte
                cid, wire = await login_args(1)
                bad = wire[:-1] + bytes([wire[-1] ^ 1])
                with pytest.raises(grpc.aio.AioRpcError):
                    await client.verify_proof("u1", cid, bad)
                # batch (2 records)
                pairs = [await login_args(i) for i in (2, 3)]
                resp = await client.verify_proof_batch(
                    ["u2", "u3"], [p[0] for p in pairs],
                    [p[1] for p in pairs])
                assert all(r.success for r in resp.results)
                # stream (2 records)
                entries = []
                for i in (4, 5):
                    cid, wire = await login_args(i)
                    entries.append((f"u{i}", cid, wire))
                oks = [
                    v.ok async for v in client.verify_proof_stream(entries)
                ]
                assert oks == [True, True]
        finally:
            await batcher.stop()
            audit_log.close()
            await server.stop(None)

    run(main())
    records, valid, total = read_log(str(log_path))
    assert len(records) == 6
    assert sum(r["v"] for r in records) == 5
    # the trail replays clean: recorded verdicts match re-verification
    report = run_audit(
        str(log_path), str(log_path) + ".report.json", quantum=4, backend="cpu")
    assert report["totals"]["mismatched"] == 0
    assert report["totals"]["verified"] == 5
    assert report["totals"]["rejected"] == 1


# --- SIGKILL resume (real process) ------------------------------------------


def _audit_cli(*args):
    return [sys.executable, "-m", "cpzk_tpu_torch.audit", *args]


def test_pipeline_sigkill_resume_byte_exact(tmp_path):
    """Kill -9 the pipeline mid-run; the rerun's signed report is
    byte-identical to an uninterrupted run (on the host: ``--backend
    cpu``, as the card is the port's default)."""
    log = tmp_path / "p.log"
    make_log(log, 400, reject_every=11)
    key = str(tmp_path / "k.key")
    ref = str(tmp_path / "ref.json")
    assert run_audit(str(log), ref, key_path=key, quantum=50, backend="cpu") is not None

    out = str(tmp_path / "killed.json")
    argv = _audit_cli("run", "--log", str(log), "--report", out, "--key", key,
                      "--quantum", "50", "--quiet", "--backend", "cpu")
    proc = subprocess.Popen(argv, cwd=str(ROOT))
    # wait for the first checkpoint, then SIGKILL mid-run
    deadline = time.monotonic() + 60
    cursor = out + ".cursor"
    while time.monotonic() < deadline and proc.poll() is None:
        if os.path.exists(cursor):
            break
        time.sleep(0.005)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=30)
    # resume (fresh process) and compare byte-for-byte
    done = subprocess.run(argv, cwd=str(ROOT), capture_output=True, timeout=180)
    assert done.returncode == 0, done.stderr
    assert open(out).read() == open(ref).read()


# --- config ------------------------------------------------------------------


def test_audit_config_layering_and_validation(tmp_path, monkeypatch):
    for key in list(os.environ):
        if key.startswith("SERVER_"):
            monkeypatch.delenv(key)
    monkeypatch.chdir(tmp_path)
    cfg = ServerConfig.from_env()
    assert cfg.audit.enabled is False
    assert cfg.audit.fsync == "off"

    (tmp_path / "server.toml").write_text(
        '[audit]\nenabled = true\nlog_path = "proofs.log"\n'
        'fsync = "interval"\n'
    )
    monkeypatch.setenv("SERVER_CONFIG_PATH", str(tmp_path / "server.toml"))
    cfg = ServerConfig.from_env()
    assert cfg.audit.enabled is True
    assert cfg.audit.log_path == "proofs.log"
    assert cfg.audit.fsync == "interval"
    cfg.validate()
    monkeypatch.setenv("SERVER_AUDIT_FSYNC", "ALWAYS")
    monkeypatch.setenv("SERVER_AUDIT_FSYNC_INTERVAL_MS", "77")
    monkeypatch.setenv("SERVER_AUDIT_LOG_PATH", "/tmp/other.log")
    cfg = ServerConfig.from_env()
    assert cfg.audit.fsync == "always"
    assert cfg.audit.fsync_interval_ms == 77.0
    assert cfg.audit.log_path == "/tmp/other.log"

    bad = ServerConfig()
    bad.audit.enabled = True  # without a log_path
    with pytest.raises(ValueError, match="requires log_path"):
        bad.validate()
    bad = ServerConfig()
    bad.audit.fsync = "sometimes"
    with pytest.raises(ValueError, match="audit.fsync"):
        bad.validate()
    bad = ServerConfig()
    bad.audit.fsync_interval_ms = 0
    with pytest.raises(ValueError, match="fsync_interval_ms"):
        bad.validate()
    # stream knobs ride [tpu]
    bad = ServerConfig()
    bad.tpu.stream_window = 0
    with pytest.raises(ValueError, match="stream_window"):
        bad.validate()
    bad = ServerConfig()
    bad.tpu.stream_entry_deadline_ms = -1
    with pytest.raises(ValueError, match="stream_entry_deadline_ms"):
        bad.validate()


def test_audit_config_keys_documented():
    """Every ``[audit]`` knob of the port's config ships in the TOML
    example, the .env example and the operations-doc knob inventory."""
    keys = [f.name for f in dataclasses.fields(AuditSettings)]
    assert keys

    toml_text = (ROOT / "config" / "server.toml.example").read_text()
    m = re.search(r"^\[audit\]$", toml_text, re.M)
    assert m, "[audit] section missing from config/server.toml.example"
    section = toml_text[m.end():].split("\n[", 1)[0]
    env_text = (ROOT / ".env.example").read_text()
    docs = (ROOT / "docs" / "operations.md").read_text()
    for key in keys:
        assert re.search(rf"^{key}\s*=", section, re.M), (
            f"[audit] key {key!r} missing from config/server.toml.example"
        )
        assert f"SERVER_AUDIT_{key.upper()}" in env_text, (
            f"SERVER_AUDIT_{key.upper()} missing from .env.example"
        )
        assert f"`audit.{key}`" in docs, (
            f"`audit.{key}` missing from the docs/operations.md "
            "knob inventory"
        )
    # the streaming knobs live in [tpu]; guard them too
    for key in ("stream_window", "stream_entry_deadline_ms"):
        assert f"`tpu.{key}`" in docs, (
            f"`tpu.{key}` missing from the docs/operations.md knob "
            "inventory"
        )


def test_cli_generate_run_verify(tmp_path, monkeypatch):
    """The CLI surface end to end in-process: generate -> run (on the
    host) -> tamper -> verify-report exit codes."""
    from cpzk_tpu_torch.audit.__main__ import main as audit_main

    log = str(tmp_path / "g.log")
    rc = audit_main(["generate", "--n", "30", "--out", log,
                     "--users", "3", "--reject-frac", "0.2"])
    assert rc == 0
    report = str(tmp_path / "g.json")
    rc = audit_main(["run", "--log", log, "--report", report,
                     "--quantum", "8", "--quiet", "--backend", "cpu"])
    assert rc == 0  # rejects recorded as rejects are not mismatches
    assert audit_main(["verify-report", "--report", report]) == 0
    blob = open(report).read().replace('"mismatched":0', '"mismatched":1')
    open(report, "w").write(blob)
    assert audit_main(["verify-report", "--report", report]) == 1


# --- held against the reference ----------------------------------------------


def test_report_byte_identical_to_reference(tmp_path):
    """The port's ``CpuBackend`` replay and the reference's
    ``run_audit(..., backend="cpu")`` of the same log with the same key
    file sign the same report to the same bytes; the key file minted by
    either package loads in the other to the same scalar."""
    from cpzk_tpu.audit import run_audit as j_run_audit
    from cpzk_tpu.audit import sign as j_sign

    log = tmp_path / "p.log"
    make_log(log, 48, reject_every=9, mismatch_every=11)
    key = str(tmp_path / "audit.key")
    port = run_audit(str(log), str(tmp_path / "port.json"), key_path=key, quantum=16,
                     backend="cpu")
    ref = j_run_audit(str(log), str(tmp_path / "ref.json"), key_path=key, quantum=16,
                      backend="cpu")
    assert port == ref
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert port["totals"]["mismatched"] > 0 and port["totals"]["rejected"] > 0
    # the reference's key file, and its signature of another message
    jkey = str(tmp_path / "ref.key")
    j_scalar = j_sign.load_or_create_key(jkey)
    p_scalar = audit_sign.load_or_create_key(jkey)
    assert j_scalar.value == p_scalar.value
    msg = b"a message both packages sign"
    assert audit_sign.sign(p_scalar, msg) == j_sign.sign(j_scalar, msg)
    assert audit_sign.public_key(p_scalar) == j_sign.public_key(j_scalar)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_log_replayed_by_the_other_package(tmp_path, writer):
    """A proof log written by either package (records stamped at a pinned
    time) has the same bytes as the other's and replays through both to
    the same signed report."""
    from cpzk_tpu.audit import ProofLogWriter as JProofLogWriter
    from cpzk_tpu.audit import run_audit as j_run_audit

    cls = JProofLogWriter if writer == "reference" else ProofLogWriter
    log = tmp_path / f"{writer}.log"
    make_log(log, 20, reject_every=6, mismatch_every=7,
             rng=_SeededRng(5), writer_cls=cls, now=1_700_000_000)
    other = tmp_path / "other.log"
    make_log(other, 20, reject_every=6, mismatch_every=7,
             rng=_SeededRng(5), writer_cls=ProofLogWriter if writer == "reference"
             else JProofLogWriter, now=1_700_000_000)
    assert log.read_bytes() == other.read_bytes()
    key = str(tmp_path / "audit.key")
    port = run_audit(str(log), str(tmp_path / "port.json"), key_path=key, quantum=8,
                     backend="cpu")
    ref = j_run_audit(str(log), str(tmp_path / "ref.json"), key_path=key, quantum=8,
                      backend="cpu")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert port["totals"] == ref["totals"] and port["totals"]["records"] == 20


def test_card_path_on_the_plain_versions_matches_the_host(tmp_path):
    """``backend="tpu"`` with ``device="cpu"`` (TorchBackend on the
    kernels' plain versions) replays to the same ``totals`` and ``digest``
    as ``CpuBackend``; only ``engine.backend`` (and so the signature)
    differs.  One quantum of 16 records, with rejects and mismatches, so
    the combined check fails and the per-row ladders decide."""
    log = tmp_path / "p.log"
    make_log(log, 16, reject_every=8, mismatch_every=13)
    key = str(tmp_path / "audit.key")
    host = run_audit(str(log), str(tmp_path / "host.json"), key_path=key, quantum=16,
                     backend="cpu")
    card = run_audit(str(log), str(tmp_path / "card.json"), key_path=key, quantum=16,
                     backend="tpu", device="cpu")
    assert card["totals"] == host["totals"] and card["digest"] == host["digest"]
    assert card["totals"]["rejected"] == 2 and card["totals"]["mismatched"] == 2
    assert card["engine"] == {"backend": "tpu", "quantum": 16}
    assert host["engine"] == {"backend": "cpu", "quantum": 16}
    assert verify_report_file(str(tmp_path / "card.json"))[0]


def test_the_card_is_the_default_and_lanes_and_a_mesh_replay(tmp_path, monkeypatch):
    """``run_audit`` and the CLI default to the card: without CUDA they
    raise (exit 2), never replaying on the host.  ``lanes != 1`` replays
    through the lane router and a mesh shards each quantum, for either
    backend, to the report bytes of the direct replay; a lane count or a
    mesh larger than the device pool is refused."""
    import torch

    from cpzk_tpu_torch.audit.__main__ import main as audit_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    log = tmp_path / "p.log"
    make_log(log, 4)
    report = str(tmp_path / "r.json")
    key = str(tmp_path / "k.key")
    with pytest.raises(InvalidParams, match="CUDA is not available"):
        run_audit(str(log), report)
    assert audit_main(["run", "--log", str(log), "--report", report, "--quiet"]) == 2
    assert not os.path.exists(report)
    for backend, kw in (("cpu", {}), ("tpu", {"devices": ["cpu"] * 2})):
        direct = run_audit(str(log), str(tmp_path / f"{backend}.json"), key_path=key,
                           quantum=4, backend=backend, **({"device": "cpu"}
                                                          if backend == "tpu" else {}))
        routed = run_audit(str(log), str(tmp_path / f"{backend}-lanes.json"),
                           key_path=key, quantum=4, backend=backend, lanes=2, **kw)
        assert routed == direct
        assert ((tmp_path / f"{backend}.json").read_bytes()
                == (tmp_path / f"{backend}-lanes.json").read_bytes())
    meshed = run_audit(str(log), str(tmp_path / "mesh.json"), key_path=key, quantum=4,
                       backend="tpu", mesh_devices=2, devices=["cpu"] * 2)
    assert (tmp_path / "mesh.json").read_bytes() == (tmp_path / "tpu.json").read_bytes()
    assert meshed["totals"]["verified"] == 4
    with pytest.raises(InvalidParams, match="lanes=2 exceeds the 1 local device"):
        run_audit(str(log), report, backend="tpu", lanes=2, device="cpu")
    with pytest.raises(InvalidParams, match="mesh_devices=2 exceeds the 1 visible device"):
        run_audit(str(log), report, backend="tpu", mesh_devices=2, device="cpu")
    assert audit_main(["run", "--log", str(log), "--report", report, "--quiet",
                       "--backend", "cpu", "--lanes", "-1", "--key", key]) == 0
    assert json.loads(open(report).read())["digest"] == direct["digest"]


# --- the daemon's trail, replayed by both packages ----------------------------------


def test_daemon_audit_trail_replays_through_both_packages(tmp_path):
    """``python -m cpzk_tpu_torch.server`` with ``[audit]`` on (rotating
    segments): logins through the port's client, SIGTERM logs "audit trail
    closed at seq N" with N the verdicts the client received, and the
    trail directory replays through both packages' ``audit run`` to equal
    ``totals`` and ``digest`` with the tampered logins rejected."""
    import grpc

    from cpzk_tpu_torch.client import AuthClient

    trail = tmp_path / "trail"
    trail.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("SERVER_")}
    env.update(SERVER_AUDIT_ENABLED="1", SERVER_AUDIT_LOG_PATH=str(trail / "proofs.log"),
               SERVER_AUDIT_SEGMENT_BYTES="3000",
               SERVER_RATE_LIMIT_REQUESTS_PER_MINUTE="100000000",
               SERVER_RATE_LIMIT_BURST="1000000",
               SERVER_CONFIG_PATH=str(tmp_path / "none.toml"),
               PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cpzk_tpu_torch.server", "--no-repl", "--port", "0",
         "--backend", "cpu"],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: list[str] = []
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"AuthService listening on [^:\s]+:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port is not None, "".join(lines)

        async def logins():
            rng = _SeededRng(11)
            params = Parameters.new()
            provers = [Prover(params, Witness(Ristretto255.random_scalar(rng)))
                       for _ in range(6)]
            eb = Ristretto255.element_to_bytes
            names = [f"aud-{i}" for i in range(6)]
            verdicts = []
            async with AuthClient(f"127.0.0.1:{port}") as client:
                await client.register_batch(
                    names, [eb(p.statement.y1) for p in provers],
                    [eb(p.statement.y2) for p in provers])

                async def proof(i, tamper=False):
                    cid = bytes((await client.create_challenge(names[i])).challenge_id)
                    t = Transcript()
                    t.append_context(cid)
                    wire = provers[i].prove_with_transcript(rng, t).to_bytes()
                    return cid, (wire[:-1] + bytes([wire[-1] ^ 1])) if tamper else wire

                for i in range(2):  # unary: one valid, one tampered
                    cid, wire = await proof(i, tamper=i == 1)
                    try:
                        verdicts.append((await client.verify_proof(names[i], cid,
                                                                   wire)).success)
                    except grpc.aio.AioRpcError:
                        verdicts.append(False)
                pairs = [await proof(i, tamper=i == 3) for i in range(6)]
                resp = await client.verify_proof_batch(names, [p[0] for p in pairs],
                                                       [p[1] for p in pairs])
                verdicts += [r.success for r in resp.results]
                entries = []
                for i in range(4):
                    cid, wire = await proof(i)
                    entries.append((names[i], cid, wire))
                verdicts += [v.ok async for v in client.verify_proof_stream(entries)]
            return verdicts

        verdicts = run(logins())
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    text = "".join(lines)
    assert proc.returncode == 0, text
    m = re.search(r"audit trail closed at seq (\d+)", text)
    assert m and int(m.group(1)) == len(verdicts) == 12, text
    assert verdicts.count(False) == 2
    assert [n for n in os.listdir(trail) if n.endswith(".seg")], os.listdir(trail)

    from cpzk_tpu.audit import run_audit as j_run_audit

    key = str(tmp_path / "audit.key")
    port_report = run_audit(str(trail), str(tmp_path / "port.json"), key_path=key,
                            quantum=5, backend="cpu")
    ref_report = j_run_audit(str(trail), str(tmp_path / "ref.json"), key_path=key,
                             quantum=5, backend="cpu")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert port_report["totals"] == ref_report["totals"] == {
        "records": 12, "audited": 12, "verified": 10, "rejected": 2,
        "mismatched": 0, "skipped": 0}


def test_audit_repl_command_and_statusz_block(tmp_path):
    """``/audit`` answers as the reference's does with a writer attached,
    naming the port's replay command; ``/statusz`` fills the audit block
    (the audit half of the reference's
    ``test_statusz_e2e_with_replication_and_audit`` is in
    ``tests/test_torch_opsplane.py``)."""
    from cpzk_tpu.audit import ProofLogWriter as JProofLogWriter
    from cpzk_tpu.server import __main__ as j_main
    from cpzk_tpu.server.state import ServerState as JServerState
    from cpzk_tpu_torch.server import __main__ as t_main
    from cpzk_tpu_torch.server.state import ServerState

    t_log = ProofLogWriter(str(tmp_path / "t.log"))
    j_log = JProofLogWriter(str(tmp_path / "j.log"))
    try:
        for w in (t_log, j_log):
            w.append_proofs([proof_record("u", b"\x01" * 32, b"\x02" * 32, b"c" * 32,
                                          b"p" * 109, True, now=1)])
        port, _ = run(t_main.handle_command("/audit", ServerState(), audit_log=t_log))
        ref, _ = run(j_main.handle_command("/audit", JServerState(), audit_log=j_log))
    finally:
        t_log.close()
        j_log.close()
    assert "python -m cpzk_tpu_torch.audit run --log" in port
    assert port.replace("cpzk_tpu_torch", "cpzk_tpu").replace("t.log", "j.log") == ref
    assert t_log.status() == {**j_log.status(), "path": t_log.path}


# --- chip_smoke.py's audit phase, rehearsed on the CPU ------------------------------

# one intra-op thread: the daemon's plain point arithmetic runs on tensors
# of a few dozen rows, beside the test suite's other workers
_CPU_LAUNCHER = (
    "import asyncio, sys, torch\n"
    "torch.set_num_threads(1)\n"
    "from cpzk_tpu_torch.server.__main__ import amain, parse_args\n"
    "asyncio.run(amain(parse_args(sys.argv[1:]), device='cpu'))\n"
)


def test_audit_phase_rehearsal(tmp_path, monkeypatch):
    """The ``audit`` phase of ``chip_smoke.py`` through its ``launcher``
    seam, on the kernels' plain versions: 48 batch logins in RPCs of 10,
    24 streamed proofs over 4 users, 3 unary logins, 4 KB segments, a
    40-record synthetic log at quantum 32; the phase's own checks (the
    closing seq equal to the verdicts received, at least two sealed
    segments, the trail replayed to those records with the planted tampers
    rejected and nothing mismatched, the liars found, the SIGKILLed CLI run
    resumed from a cursor above 0 to the same bytes, the Pippenger-route
    run the same bytes, ``verify-report`` 0 on every report and 1 on the
    flipped one) must hold."""
    import runpy

    monkeypatch.chdir(tmp_path)  # the daemon's log lands in ./chiprun_out
    smoke = runpy.run_path(str(ROOT / "chip_smoke.py"), run_name="chip_smoke_rehearsal")
    _, corpus, provers = smoke["make_corpus"](16, smoke["SeededRng"](1))
    out = smoke["audit_phase"](
        corpus, provers, 48, 10, stream_users=4, stream_proofs=24, unary=3,
        segment_bytes=4096, synth_n=40, quantum=32,
        launcher=[sys.executable, "-c", _CPU_LAUNCHER], on_card=False)
    assert out["trail"]["records"] == 24 + 48 + 3 and out["trail"]["segments"] >= 2
    assert out["trail_replay"]["totals"]["rejected"] == out["logins"]["planted"]
    assert out["A"]["totals"]["mismatched"] == out["generate"]["mismatches"] == 1
    assert out["B"]["cursor_offset"] > 0 and out["B"]["exit"] == 3
    assert out["verify_report"]["A-flipped"] == 1
    assert out["engine"] == {"A": {"backend": "tpu", "quantum": 32},
                             "C": {"backend": "cpu", "quantum": 32}}
