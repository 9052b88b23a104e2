"""Bulk offline audit: replay a proof log through the batch engine.

A copy of ``cpzk_tpu/audit/pipeline.py`` on the port's engine.
``python -m cpzk_tpu_torch.audit run`` turns the serving plane's proof log
(:mod:`cpzk_tpu_torch.audit.log`) back into work for the card: records
stream through :class:`~cpzk_tpu_torch.protocol.batch.BatchVerifier` via
the SAME dispatch seam the serving path uses
(:meth:`~cpzk_tpu_torch.server.dispatch.DispatchLane.verify_once`) at a
full batch quantum per dispatch, on :class:`~cpzk_tpu_torch.ops.backend.
TorchBackend` on ``cuda:0`` by default (``backend="tpu"``, the
reference's name for the accelerator engine, as the daemon's ``[tpu]
backend`` keeps it), or on the host's :class:`~cpzk_tpu_torch.protocol.
batch.CpuBackend` when asked (``backend="cpu"``), then emits a
Schnorr-signed report (:mod:`cpzk_tpu_torch.audit.sign`) stating what it
found.  There is no fallback from the card to the host: without CUDA, or
when a kernel fails to build or launch, the run raises.  ``lanes != 1``
replays through the serving plane's lane router (each quantum fanned out
over one lane per device), and ``mesh_devices`` shards each quantum over
a mesh; either way the signed report is the same bytes.

Resumability contract (the SIGKILL test pins it exactly):

- After every quantum the pipeline atomically checkpoints a **cursor**
  (byte offset, last sequence number, running totals, running transcript
  digest) via write-to-temp + rename — a crash leaves either the old or
  the new cursor, never a torn one.
- The running digest is a SHA-256 chain folded over every record IN
  ORDER (canonical record JSON + the audit outcome byte), so a resumed
  run recomputes the identical digest — and because report signing is
  deterministic (:func:`cpzk_tpu_torch.audit.sign._nonce`), a run that is
  SIGKILLed at ANY point and resumed produces a byte-exact-identical
  signed report to an uninterrupted run.

The report body names the engine (``engine.backend``), so reports of the
same log by the card and by the host differ in those bytes (and so in the
signature) while their ``totals`` and ``digest`` are equal.  The route
the card verifies by (per-row ladders or the Pippenger check) and the
backend's lane padding do not enter the report.

Audit semantics per record:

- frame fails CRC/parse/sequence rules -> the scan stops (WAL prefix
  contract); everything before the violation is still audited and the
  report carries the valid byte count.
- record parses but is not a well-formed ``proof`` record (unknown type,
  missing/oversized/non-hex fields, bad statement encoding) ->
  **skipped**, never handed to the backend.
- proof wire malformed -> **rejected** (an invalid proof is a
  verification outcome, exactly as the serving path answers it).
- otherwise the batch engine decides: **verified** or **rejected**; a
  computed verdict that contradicts the recorded one increments
  **mismatched** (the number an auditor actually cares about).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

from .. import errors
from ..core.ristretto import Ristretto255
from ..core.rng import SecureRng
from ..protocol.batch import BatchEntry
from ..protocol.gadgets import Parameters, Proof, Statement
from .log import scan_records, validate_proof_record
from .sign import load_or_create_key, sign_report

SCHEMA = "cpzk-audit-report/1"
CURSOR_SCHEMA = "cpzk-audit-cursor/1"
DEFAULT_QUANTUM = 4096

#: Audit outcome bytes folded into the digest chain (one per record, in
#: record order) — part of the signed transcript, so a tampered log that
#: still parses but audits differently changes the digest.
OUTCOME_VERIFIED = b"V"
OUTCOME_REJECTED = b"R"
OUTCOME_SKIPPED = b"S"

_ZERO_CHAIN = "0" * 64


def _fold(chain_hex: str, rec: dict, outcome: bytes) -> str:
    h = hashlib.sha256()
    h.update(bytes.fromhex(chain_hex))
    h.update(json.dumps(rec, separators=(",", ":"), sort_keys=True).encode())
    h.update(outcome)
    return h.hexdigest()


class AuditState:
    """Running totals + digest chain — everything the cursor persists.

    Pure fold state: :meth:`note` consumes records in order with their
    audit outcomes; the fuzz harness drives it directly (no crypto) to
    hold the monotonicity/consistency invariants."""

    def __init__(self):
        self.offset = 0
        self.prev_seq: int | None = None
        self.first_seq: int | None = None
        self.records = 0
        self.verified = 0
        self.rejected = 0
        self.mismatched = 0
        self.skipped = 0
        self.chain = _ZERO_CHAIN

    @property
    def audited(self) -> int:
        return self.verified + self.rejected

    def note(self, rec: dict, outcome: bytes, mismatch: bool = False) -> None:
        self.records += 1
        seq = rec.get("seq")
        if isinstance(seq, int) and not isinstance(seq, bool):
            if self.first_seq is None:
                self.first_seq = seq
            self.prev_seq = seq
        if outcome == OUTCOME_VERIFIED:
            self.verified += 1
        elif outcome == OUTCOME_REJECTED:
            self.rejected += 1
        else:
            self.skipped += 1
        if mismatch:
            self.mismatched += 1
        self.chain = _fold(self.chain, rec, outcome)

    # -- cursor (de)serialization -------------------------------------------

    def to_cursor(self, log_path: str) -> dict:
        return {
            "schema": CURSOR_SCHEMA,
            "log_path": os.path.basename(log_path),
            "offset": self.offset,
            "prev_seq": self.prev_seq,
            "first_seq": self.first_seq,
            "records": self.records,
            "verified": self.verified,
            "rejected": self.rejected,
            "mismatched": self.mismatched,
            "skipped": self.skipped,
            "chain": self.chain,
        }

    @classmethod
    def from_cursor(cls, cur: dict, log_path: str) -> "AuditState":
        if cur.get("schema") != CURSOR_SCHEMA:
            raise ValueError(f"unknown cursor schema: {cur.get('schema')!r}")
        if cur.get("log_path") != os.path.basename(log_path):
            raise ValueError(
                f"cursor belongs to {cur.get('log_path')!r}, "
                f"not {os.path.basename(log_path)!r}"
            )
        st = cls()
        st.offset = int(cur["offset"])
        st.prev_seq = cur["prev_seq"]
        st.first_seq = cur["first_seq"]
        st.records = int(cur["records"])
        st.verified = int(cur["verified"])
        st.rejected = int(cur["rejected"])
        st.mismatched = int(cur["mismatched"])
        st.skipped = int(cur["skipped"])
        chain = str(cur["chain"])
        bytes.fromhex(chain)  # ValueError on a tampered cursor
        if len(chain) != 64:
            raise ValueError("cursor chain must be 32 hex bytes")
        st.chain = chain
        return st


def _atomic_write_json(path: str, obj: dict) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix="." + os.path.basename(path) + ".", dir=d)
    try:
        payload = json.dumps(obj, separators=(",", ":"), sort_keys=True)
        os.write(fd, payload.encode() + b"\n")
        os.fsync(fd)
        os.close(fd)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.close(fd)
        except OSError:
            pass
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def log_files(log_path: str) -> list[str]:
    """The ordered file list of one logical proof log: the path itself,
    or — when it is a rotated-segment **directory** — every sealed
    ``*.seg`` file in name order (zero-padded names sort in sequence
    order) followed by the active log file(s) they rotated out of.
    Sequence numbers strictly increase across that concatenation, so the
    WAL prefix scan treats it as one log."""
    if not os.path.isdir(log_path):
        return [log_path]
    from .log import _SEG_RE

    names = sorted(os.listdir(log_path))
    segs = [n for n in names if _SEG_RE.search(n)]
    bases: list[str] = []
    for n in segs:
        base = _SEG_RE.sub("", n)
        if base not in bases:
            bases.append(base)
    files = [os.path.join(log_path, n) for n in segs]
    files += [
        os.path.join(log_path, b) for b in sorted(bases)
        if os.path.isfile(os.path.join(log_path, b))
    ]
    if not files:
        raise ValueError(
            f"{log_path} is a directory with no proof-log segments "
            "(*.seg) in it"
        )
    return files


def _read_log_bytes(log_path: str) -> bytes:
    parts = []
    for path in log_files(log_path):
        with open(path, "rb") as f:
            parts.append(f.read())
    return b"".join(parts)


def _device_pool(device, devices):
    """The devices ``lanes`` and ``mesh_devices`` resolve against:
    ``devices``, else ``[device]``, else None (the local CUDA cards)."""
    if devices is not None:
        return devices
    return [device] if device is not None else None


def build_backend(backend_name: str, mesh_devices: int = 0, device=None,
                  devices=None):
    """The audit compute plane: ``"tpu"`` is :class:`~cpzk_tpu_torch.ops.
    backend.TorchBackend` (``device=None`` means ``cuda:0`` and raises
    without CUDA; ``"cpu"`` runs the kernels' plain versions, for the
    tests), sharded over a mesh when ``mesh_devices`` resolves to more than
    one device of the pool (``devices`` when given, an explicit list that
    may repeat a device, else the local CUDA cards); ``"cpu"`` the host's
    ``CpuBackend``."""
    if backend_name == "tpu":
        import torch

        from ..ops.backend import TorchBackend
        from ..parallel.mesh import resolve_mesh_devices

        if device is None and devices is None and not torch.cuda.is_available():
            raise errors.InvalidParams(
                "CUDA is not available; backend 'tpu' replays on "
                "the card (backend 'cpu' replays on the host)"
            )
        pool = _device_pool(device, devices)
        try:
            mesh = resolve_mesh_devices(mesh_devices, pool)
        except ValueError as e:
            raise errors.InvalidParams(str(e)) from e
        if mesh is not None:
            return TorchBackend(mesh_devices=len(mesh), devices=mesh)
        return TorchBackend(device=pool[0] if pool else None)
    if backend_name != "cpu":
        raise ValueError(f"unknown audit backend: {backend_name!r}")
    from ..protocol.batch import CpuBackend

    return CpuBackend()


def build_router(backend_name: str, lanes: int, quantum: int, device=None,
                 devices=None):
    """The audit pipeline's multi-lane compute plane — the SAME
    :class:`~cpzk_tpu_torch.server.router.LaneRouter` the serving daemon
    places batches on, attached via its synchronous seam
    (``verify_blocking``): each quantum fans out across every lane.

    ``lanes`` semantics match ``[tpu] lanes``: 1 = no router, -1 = one
    lane per device of the pool (tpu backend; the pool as in
    :func:`build_backend`) or per host core (cpu backend), k = exactly k
    lanes.  Returns None when one lane resolves — the caller keeps the
    direct ``verify_once`` path.  The tpu lanes are prewarmed at
    ``quantum`` on every lane device."""
    if lanes == 1:
        return None
    from ..server.router import LaneRouter

    if backend_name == "tpu":
        from ..ops.backend import TorchBackend, prewarm
        from ..parallel.mesh import resolve_lane_devices

        try:
            lane_devices = resolve_lane_devices(lanes, _device_pool(device, devices))
        except ValueError as e:
            raise errors.InvalidParams(str(e)) from e
        if lane_devices is None:
            return None
        for d in dict.fromkeys(lane_devices):
            prewarm([quantum], d)
        return LaneRouter(
            [TorchBackend(device=d) for d in lane_devices], devices=lane_devices,
        )
    from ..protocol.batch import CpuBackend

    n = lanes if lanes > 0 else (os.cpu_count() or 1)
    if n <= 1:
        return None
    # CPU lanes: the native verify releases the GIL, so N lanes = real
    # host-core parallelism through the identical router seam
    return LaneRouter([CpuBackend() for _ in range(n)])


def _record_entry(rec: dict) -> tuple[BatchEntry | None, str | None]:
    """(entry, skip_reason): decode one validated proof record into a
    batch entry, or say why it cannot be audited.  A proof wire that
    parses as *malformed proof* is NOT a skip — the caller maps it to a
    rejected outcome via the entry-less ``(None, None)`` convention plus
    ``rec['_parse_error']``."""
    reason = validate_proof_record(rec)
    if reason is not None:
        return None, reason
    try:
        y1 = Ristretto255.element_from_bytes(bytes.fromhex(rec["y1"]))
        y2 = Ristretto255.element_from_bytes(bytes.fromhex(rec["y2"]))
        statement = Statement(y1, y2)
        statement.validate()
        if Ristretto255.is_identity(y1) or Ristretto255.is_identity(y2):
            return None, "bad-statement"
    except errors.Error:
        return None, "bad-statement"
    return (
        BatchEntry(
            Parameters.new(), statement,
            None,  # type: ignore[arg-type]  # proof attached after bulk parse
            bytes.fromhex(rec["ctx"]),
        ),
        None,
    )


def run_audit(
    log_path: str,
    report_path: str,
    cursor_path: str | None = None,
    key_path: str | None = None,
    quantum: int = DEFAULT_QUANTUM,
    backend: str = "tpu",
    mesh_devices: int = 0,
    lanes: int = 1,
    resume: bool = True,
    max_batches: int | None = None,
    progress=None,
    device=None,
    devices=None,
) -> dict | None:
    """Replay ``log_path`` through the batch engine and write a signed
    report to ``report_path``.  Returns the report dict, or ``None`` when
    ``max_batches`` stopped the run early (checkpoint saved — rerun with
    ``resume=True`` to continue; the test harness uses this to model a
    SIGKILL between checkpoints).

    ``cursor_path`` defaults to ``<report_path>.cursor``; ``key_path``
    defaults to ``<report_path>.key`` (minted 0600 when absent).

    ``log_path`` may be a **rotated-segment directory** (a log written
    with ``[audit] segment_bytes`` — or a standby's shipped copy): the
    sealed ``*.seg`` files plus the active tail replay as one logical
    log, cursor offsets indexing into their concatenation (stable:
    sealing only renames bytes in place within the order).

    ``backend="tpu"`` (the default) verifies on the card: ``device=None``
    means ``cuda:0`` and raises without CUDA, ``device="cpu"`` runs the
    kernels' plain versions (a Python-level keyword for the tests, as the
    daemon's ``amain(..., device=)`` is).  ``backend="cpu"`` is the host's
    ``CpuBackend``.  ``lanes != 1`` replays through the lane router
    (:func:`build_router`) and ``mesh_devices`` shards over a mesh
    (:func:`build_backend`), both resolved against ``devices`` when given
    (an explicit device list that may repeat a device), else the local
    CUDA cards; the report is the same bytes either way.
    """
    if quantum < 1:
        raise ValueError("audit quantum must be positive")
    cursor_path = cursor_path or report_path + ".cursor"
    key_path = key_path or report_path + ".key"
    state = AuditState()
    if resume and os.path.exists(cursor_path):
        with open(cursor_path, encoding="utf-8") as f:
            state = AuditState.from_cursor(json.load(f), log_path)

    buf = _read_log_bytes(log_path)
    if state.offset > len(buf):
        raise ValueError(
            f"cursor offset {state.offset} is beyond the log "
            f"({len(buf)} bytes) — wrong log file?"
        )

    router = build_router(backend, lanes, quantum, device=device, devices=devices)
    engine = None if router is not None else build_backend(
        backend, mesh_devices=mesh_devices, device=device, devices=devices)
    rng = SecureRng()
    # ONE scan of the remaining suffix (the parse cost is linear in what
    # is left, not quadratic in batch count); quanta then slice the
    # parsed records, with the cursor offset advanced frame-wise
    records, valid = scan_records(
        buf, offset=state.offset, prev_seq=state.prev_seq
    )
    batches = 0
    idx = 0
    if router is not None:
        router.start_in_thread()
    try:
        while idx < len(records):
            batch = records[idx: idx + quantum]
            idx += len(batch)
            _audit_batch(batch, state, engine, rng, router=router)
            state.offset = _advance(buf, state.offset, len(batch))
            batches += 1
            _atomic_write_json(cursor_path, state.to_cursor(log_path))
            if progress is not None:
                progress(state)
            if (
                max_batches is not None and batches >= max_batches
                and idx < len(records)
            ):
                return None
    finally:
        if router is not None:
            router.stop_thread()
    state.offset = max(state.offset, valid)

    report = _build_report(
        log_path, state, valid_bytes=state.offset,
        file_bytes=len(buf), backend=backend, quantum=quantum,
    )
    sign_report(report, load_or_create_key(key_path))
    _atomic_write_json(report_path, report)
    # the run is complete: the cursor has served its purpose (keeping it
    # would make a LATER run against an appended-to log resume silently)
    try:
        os.unlink(cursor_path)
    except OSError:
        pass
    return report


def _advance(buf: bytes, offset: int, n_frames: int) -> int:
    """Byte offset after ``n_frames`` well-formed frames from ``offset``
    (frame sizes only — the frames were already validated this scan)."""
    from ..durability.wal import _HEADER, HEADER_BYTES

    off = offset
    for _ in range(n_frames):
        length, _crc = _HEADER.unpack_from(buf, off)
        off += HEADER_BYTES + length
    return off


def _audit_batch(
    records: list[dict], state: AuditState, engine, rng, router=None
) -> None:
    """Verify one quantum of records through the serving dispatch seam —
    the direct ``verify_once`` engine, or the lane router's synchronous
    fan-out (``verify_blocking``) — and fold the outcomes into ``state``
    IN RECORD ORDER (lane placement, the backend's lane padding and the
    route it verifies by never reorder the fold)."""
    from ..server.dispatch import DispatchLane

    entries: list[BatchEntry] = []
    plan: list[tuple[dict, str | None, bool]] = []  # (rec, skip, parse_fail)
    wires: list[bytes] = []
    for rec in records:
        entry, skip = _record_entry(rec)
        if skip is not None:
            plan.append((rec, skip, False))
            continue
        wires.append(bytes.fromhex(rec["p"]))
        entries.append(entry)
        plan.append((rec, None, False))
    # bulk proof parse (deferred point decodes settle inside the batch
    # engine with exact eager-parse semantics, like the serving path)
    parsed = Proof.from_bytes_batch(wires, defer_point_validation=True)
    live: list[BatchEntry] = []
    k = 0
    for i, (rec, skip, _) in enumerate(plan):
        if skip is not None:
            continue
        proof = parsed[k]
        entry = entries[k]
        k += 1
        if isinstance(proof, errors.Error):
            plan[i] = (rec, None, True)  # malformed proof -> rejected
            continue
        entry.proof = proof
        live.append(entry)
    if not live:
        results = []
    elif router is not None:
        results = router.verify_blocking(live)
    else:
        results = DispatchLane.verify_once(engine, rng, live)
    it = iter(results)
    for rec, skip, parse_fail in plan:
        if skip is not None:
            state.note(rec, OUTCOME_SKIPPED)
            continue
        if parse_fail:
            computed = False
        else:
            computed = next(it) is None
        outcome = OUTCOME_VERIFIED if computed else OUTCOME_REJECTED
        mismatch = bool(rec.get("v", 0)) != computed
        state.note(rec, outcome, mismatch=mismatch)


def _build_report(
    log_path: str,
    state: AuditState,
    valid_bytes: int,
    file_bytes: int,
    backend: str,
    quantum: int,
) -> dict:
    """The deterministic (pre-signature) report body: no wall-clock
    timestamps, no absolute paths — two runs over the same log bytes
    produce the same bytes here, which is what makes SIGKILL-resume
    equivalence byte-exact."""
    return {
        "schema": SCHEMA,
        "log": {
            "name": os.path.basename(log_path),
            "valid_bytes": valid_bytes,
            "file_bytes": file_bytes,
            "first_seq": state.first_seq,
            "last_seq": state.prev_seq,
        },
        "engine": {"backend": backend, "quantum": quantum},
        "totals": {
            "records": state.records,
            "audited": state.audited,
            "verified": state.verified,
            "rejected": state.rejected,
            "mismatched": state.mismatched,
            "skipped": state.skipped,
        },
        "digest": state.chain,
    }


def verify_report_file(report_path: str) -> tuple[bool, str, dict | None]:
    """Offline ``verify-report``: ``(ok, reason, report)``.  Total over
    arbitrary files — a tampered report answers False, never raises."""
    from .sign import verify_report

    try:
        with open(report_path, encoding="utf-8") as f:
            report = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"unreadable report: {e}", None
    if not isinstance(report, dict):
        return False, "report is not a JSON object", None
    if report.get("schema") != SCHEMA:
        return False, f"unknown report schema: {report.get('schema')!r}", report
    ok, reason = verify_report(report)
    return ok, reason, report
