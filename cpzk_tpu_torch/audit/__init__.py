"""Proof-log subsystem: the audit trail and its bulk replay on the card.

The port of ``cpzk_tpu/audit/``:

- :mod:`.log` — the append-only, CRC-framed proof log the service writes
  behind ``[audit]`` (WAL framing, the reference's bytes, own metrics
  namespace);
- :mod:`.pipeline` — the bulk replay pipeline (``python -m
  cpzk_tpu_torch.audit run``): proof log -> batch engine on the card at a
  full batch quantum, resumable cursor, deterministic digest chain;
- :mod:`.sign` — Schnorr-signed (ristretto255 + Merlin) audit reports
  with a fully offline ``verify-report`` mode.

Importing this package imports no torch: the card's engine is built when
a replay starts.
"""

from .log import ProofLogWriter, proof_record, read_log, scan_records
from .pipeline import AuditState, run_audit, verify_report_file
from .sign import load_or_create_key, sign_report, verify_report

__all__ = [
    "AuditState",
    "ProofLogWriter",
    "load_or_create_key",
    "proof_record",
    "read_log",
    "run_audit",
    "scan_records",
    "sign_report",
    "verify_report",
    "verify_report_file",
]
