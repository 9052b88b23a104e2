"""FRAME-001: the length+CRC32 frame discipline has exactly one home.

Three planes now speak the same byte framing — ``length u32 | crc32 u32
| payload``, both big-endian, CRC over the payload only: the durability
WAL, the audit proof log, and the sharded-ingest unix pipe.  The framing
helpers live in :mod:`cpzk_tpu_torch.durability.wal` (``frame_payload`` /
``encode_record`` on the write side, ``iter_frames`` /
``unpack_frame_header`` / ``frame_crc_ok`` on the read side).  A module
that re-rolls the header with ``struct.pack`` and a manual ``crc32``
works today and then drifts: a masked-vs-unmasked CRC, a flipped
endianness, a header width change in one copy — and two planes that are
supposed to interoperate (the standby replays shipped WAL frames, the
dispatch process parses shard frames) silently disagree at the byte
level.

Two patterns are findings anywhere outside ``durability/wal.py``:

- a ``pack(...)`` call (``struct.pack`` or a prebuilt ``Struct.pack``)
  whose arguments contain a ``crc32(...)`` call, or a local that was
  bound from one — hand-rolled frame *construction*;
- declaring the frame-header struct itself (``struct.Struct(">II")`` or
  ``struct.pack/unpack(">II", ...)``) — a private copy of the shared
  header that can drift from the canonical one.

Whole-object CRCs that never enter a packed header (the replication
segment checksum riding a protobuf field, the crc32-based shard/partition
hashes) are out of scope and do not fire.
"""

from __future__ import annotations

import ast

from ..contexts import call_name
from ..engine import Finding, Module, Rule, register

#: The one module allowed to define the framing (it IS the helper).
_CANONICAL = ("durability", "wal.py")

_HEADER_FMT = ">II"


def _contains_crc32(expr: ast.expr, crc_locals: set[str]) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call) and call_name(sub.func) == "crc32":
            return True
        if isinstance(sub, ast.Name) and sub.id in crc_locals:
            return True
    return False


@register
class HandRolledFraming(Rule):
    id = "FRAME-001"
    summary = (
        "length+CRC framing is built/parsed only via the shared WAL "
        "framing helpers"
    )
    rationale = (
        "the WAL, proof log, and ingest pipe interoperate on one frame "
        "header; a module hand-rolling struct.pack + crc32 is a second "
        "copy of that contract, one endianness/mask/width drift away "
        "from two planes silently disagreeing at the byte level — use "
        "durability.wal.frame_payload/encode_record/iter_frames"
    )

    def check(self, module: Module) -> list[Finding]:
        if (
            module.plane == _CANONICAL[0]
            and module.filename == _CANONICAL[1]
        ):
            return []
        out: list[Finding] = []
        # locals bound from a crc32(...) expression, module-wide (cheap
        # over-approximation; the pack call is the finding anchor)
        crc_locals: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and _contains_crc32(
                node.value, set()
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        crc_locals.add(t.id)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node.func)
            if name == "pack" and any(
                _contains_crc32(a, crc_locals) for a in node.args
            ):
                out.append(self.finding(
                    module, node,
                    "hand-rolled length+CRC frame construction; use "
                    "durability.wal.frame_payload (or encode_record for "
                    "WAL-style JSON records) so every plane shares one "
                    "header",
                ))
            elif name in ("Struct", "pack", "unpack", "pack_into",
                          "unpack_from") and node.args:
                first = node.args[0]
                if (
                    isinstance(first, ast.Constant)
                    and first.value == _HEADER_FMT
                ):
                    out.append(self.finding(
                        module, node,
                        "module declares its own copy of the shared "
                        f"frame header ({_HEADER_FMT!r}); import the "
                        "framing helpers from durability.wal instead of "
                        "re-rolling the struct",
                    ))
        return out
