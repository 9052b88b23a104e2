"""Native zero-copy wire path for the three hot request messages.

A copy of ``cpzk_tpu/server/wire.py`` on the port's own host core.  The
transport's cost is request bytes -> protobuf message objects -> per-field
Python materialization -> per-proof joins back into packed buffers for the
native parse and the marshalling to the card.  This module closes the loop
the way the reference stack does (tonic decodes proto in native code
straight off the socket): the C++ scanner in ``native/wire.cpp`` indexes
the request's fields in one pass over the socket bytes, the proof wires
are gathered natively into ONE contiguous buffer
(``proofs_packed``), and that buffer flows to
``Proof.from_bytes_batch(packed=...)`` and the dispatch lane's prep
thread without ever being re-joined from per-entry Python objects.  The
scanner is part of the host core library (``core/_native.py``): a library
that fails to build raises ``NativeCoreError``, as everywhere in the port's
host core; no request silently takes another parser because of it.

Deserializer contract (the gRPC ``request_deserializer`` seam):

- the native parser accepts only messages it is bit-for-bit sure the
  Python protobuf runtime decodes identically (known fields, valid
  UTF-8, well-formed varints/lengths) — ANYTHING else falls back to
  ``<pb2 class>.FromString`` unconditionally, so an unknown message
  shape or adversarial bytes behave exactly like the Python path, error
  messages included;
- an accepted message yields a ``Native*Request`` view whose attribute
  surface (``user_ids``/``challenge_ids``/``proofs``/``ids``/
  ``mint_sessions``/``user_id``) is list/str/bytes-identical to the
  protobuf message, pinned by ``tests/test_torch_wire.py``.

Telemetry: ``transport.parse.native{rpc}`` / ``transport.parse.fallback
{rpc}`` count the two paths, ``transport.parse.duration`` times the
native parse, ``transport.parse.bytes`` totals the bytes it handled, and
each handler attaches a ``wire_parse`` span to its trace so /tracez
shows the parse cost next to the other stages.
"""

from __future__ import annotations

import re
import time

from ..core import _native
from ..observability import get_tracer
from . import metrics

__all__ = [
    "NativeChallengeRequest",
    "NativeBatchVerificationRequest",
    "NativeStreamVerifyRequest",
    "WIRE_MODES",
    "make_deserializer",
    "note_wire_parse",
]

#: Valid values of the ``[server] wire`` knob.
WIRE_MODES = ("native", "python")

#: The one wire size a valid proof has (gadgets.PROOF_WIRE_SIZE; kept as
#: a local constant so this module stays import-light on the hot path).
_PROOF_WIRE_SIZE = 109


# -- bulk materialization helpers --------------------------------------------
#
# The protobuf runtime (upb) materializes repeated fields in C at
# ~0.16 us/entry; a naive per-entry Python slice loop costs ~0.9 us.  The
# helpers below keep materialization in C for the canonical shapes: one
# native gather into a contiguous blob, then one fixed-stride re.findall
# (uniform-length fields: every 109-byte proof, every tagged challenge
# id) or one whole-blob utf-8 decode + str slicing for user ids.

_STRIDE_RE: dict[int, re.Pattern] = {}


def _stride_split(packed: bytes, stride: int) -> list[bytes]:
    pat = _STRIDE_RE.get(stride)
    if pat is None:
        pat = _STRIDE_RE[stride] = re.compile(
            (".{%d}" % stride).encode(), re.S
        )
    return pat.findall(packed)


def _lens_list(lens, n: int) -> list[int]:
    return lens[:n] if n else []


def _gather_bytes(data: bytes, offs, lens, n: int, lens_l: list[int]):
    """(items, packed_or_None): one native gather + stride split when the
    lengths are uniform, else per-entry slices (rare: hand-built or
    adversarial requests)."""
    if n == 0:
        return [], b""
    total = sum(lens_l)
    uniform = lens_l[0] if total == lens_l[0] * n else 0
    if uniform > 0:
        packed = _native.wire_gather(data, offs, lens, n, total)
        return _stride_split(packed, uniform), packed
    return [bytes(data[o:o + l]) for o, l in zip(offs[:n], lens_l)], None


def _gather_strs(data: bytes, offs, lens, n: int) -> list[str]:
    if n == 0:
        return []
    lens_l = _lens_list(lens, n)
    blob = _native.wire_gather(data, offs, lens, n, sum(lens_l))
    text = blob.decode("utf-8")  # per-field UTF-8 already validated in C
    if blob.isascii():  # byte offsets == char offsets: slice one str
        out = []
        pos = 0
        for ln in lens_l:
            out.append(text[pos:pos + ln])
            pos += ln
        return out
    return [str(data[o:o + l], "utf-8") for o, l in zip(offs[:n], lens_l)]


# -- request views ------------------------------------------------------------


class NativeChallengeRequest:
    """``auth.ChallengeRequest`` decoded by the native parser."""

    __slots__ = ("user_id", "_parse_s")

    def __init__(self, user_id: str, parse_s: float = 0.0):
        self.user_id = user_id
        self._parse_s = parse_s


class NativeBatchVerificationRequest:
    """``auth.BatchVerificationRequest`` decoded by the native parser.

    ``proofs_packed`` is the zero-copy payoff: when every proof wire has
    the canonical 109-byte size, the proofs were gathered natively into
    ONE contiguous buffer straight off the socket bytes —
    ``Proof.from_bytes_batch(packed=...)`` validates it in a single
    native pass with no Python re-join."""

    __slots__ = ("user_ids", "challenge_ids", "proofs", "proofs_packed",
                 "_parse_s")

    def __init__(self, user_ids, challenge_ids, proofs, proofs_packed,
                 parse_s: float = 0.0):
        self.user_ids = user_ids
        self.challenge_ids = challenge_ids
        self.proofs = proofs
        self.proofs_packed = proofs_packed
        self._parse_s = parse_s

    def packed_proofs(self, count: int):
        """The packed proof buffer when it covers exactly the first
        ``count`` == all proofs at canonical size, else None (callers
        that screened a subset fall back to the join path)."""
        packed = self.proofs_packed
        if packed is not None and count == len(self.proofs):
            return packed
        return None


class NativeStreamVerifyRequest:
    """One ``auth.StreamVerifyRequest`` chunk decoded by the native
    parser (same packed-proofs contract as the batch view)."""

    __slots__ = ("ids", "user_ids", "challenge_ids", "proofs",
                 "proofs_packed", "mint_sessions", "_parse_s")

    def __init__(self, ids, user_ids, challenge_ids, proofs, proofs_packed,
                 mint_sessions: bool, parse_s: float = 0.0):
        self.ids = ids
        self.user_ids = user_ids
        self.challenge_ids = challenge_ids
        self.proofs = proofs
        self.proofs_packed = proofs_packed
        self.mint_sessions = mint_sessions
        self._parse_s = parse_s

    def packed_proofs(self, count: int):
        packed = self.proofs_packed
        if packed is not None and count == len(self.proofs):
            return packed
        return None


# -- parsers ------------------------------------------------------------------


def _parse_challenge(data: bytes):
    idx = _native.wire_index(_native.WIRE_CHALLENGE, data)
    if idx is None:
        return None
    counts, offs, lens, _vals, _mint = idx
    n = counts[0]
    if n == 0:
        return NativeChallengeRequest("")  # absent field: proto3 default
    o, ln = offs[0][n - 1], lens[0][n - 1]  # last occurrence wins
    return NativeChallengeRequest(str(data[o:o + ln], "utf-8"))


def _parse_batch_verify(data: bytes):
    idx = _native.wire_index(_native.WIRE_BATCH_VERIFY, data)
    if idx is None:
        return None
    counts, offs, lens, _vals, _mint = idx
    user_ids = _gather_strs(data, offs[0], lens[0], counts[0])
    cids, _ = _gather_bytes(
        data, offs[1], lens[1], counts[1], _lens_list(lens[1], counts[1])
    )
    plens = _lens_list(lens[2], counts[2])
    proofs, packed = _gather_bytes(data, offs[2], lens[2], counts[2], plens)
    if packed is not None and (not plens or plens[0] != _PROOF_WIRE_SIZE):
        packed = None  # uniform but not proof-sized: no fast-parse claim
    return NativeBatchVerificationRequest(user_ids, cids, proofs, packed)


def _parse_stream_chunk(data: bytes):
    idx = _native.wire_index(_native.WIRE_STREAM_CHUNK, data)
    if idx is None:
        return None
    counts, offs, lens, vals, mint = idx
    ids = vals[:counts[3]] if counts[3] else []
    user_ids = _gather_strs(data, offs[0], lens[0], counts[0])
    cids, _ = _gather_bytes(
        data, offs[1], lens[1], counts[1], _lens_list(lens[1], counts[1])
    )
    plens = _lens_list(lens[2], counts[2])
    proofs, packed = _gather_bytes(data, offs[2], lens[2], counts[2], plens)
    if packed is not None and (not plens or plens[0] != _PROOF_WIRE_SIZE):
        packed = None
    return NativeStreamVerifyRequest(ids, user_ids, cids, proofs, packed, mint)


_PARSERS = {
    "CreateChallenge": _parse_challenge,
    "VerifyProofBatch": _parse_batch_verify,
    "VerifyProofStream": _parse_stream_chunk,
}


def make_deserializer(rpc: str, pb2_cls):
    """Native-first request deserializer for one of the three hot RPCs:
    tries the native parser, falls back to ``pb2_cls.FromString`` for
    anything outside its recognized subset (including EVERY malformed
    input, so rejection semantics are the protobuf runtime's own).
    Returns None for RPCs without a native parser — the caller keeps
    the plain ``FromString``."""
    parser = _PARSERS.get(rpc)
    if parser is None:
        return None
    native_ctr = metrics.counter(
        "transport.parse.native", labelnames=("rpc",)
    ).labels(rpc=rpc)
    fallback_ctr = metrics.counter(
        "transport.parse.fallback", labelnames=("rpc",)
    ).labels(rpc=rpc)
    bytes_ctr = metrics.counter("transport.parse.bytes")
    duration = metrics.histogram("transport.parse.duration")

    def deserialize(data: bytes):
        t0 = time.perf_counter()
        view = parser(data)
        if view is None:
            fallback_ctr.inc()
            return pb2_cls.FromString(data)
        dt = time.perf_counter() - t0
        view._parse_s = dt
        native_ctr.inc()
        bytes_ctr.inc(len(data))
        duration.observe(dt)
        return view

    return deserialize


def note_wire_parse(request, trace_id: str | None) -> None:
    """Attach the native parse cost as a ``wire_parse`` span on the
    RPC's trace (no-op for protobuf-parsed requests): /tracez then shows
    the transport decode next to queue/device stages."""
    parse_s = getattr(request, "_parse_s", 0.0)
    if not parse_s or not trace_id:
        return
    now = time.monotonic()
    get_tracer().add_span(
        trace_id, "wire_parse", now - parse_s, parse_s, path="native"
    )
