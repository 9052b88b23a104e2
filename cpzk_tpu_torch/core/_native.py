"""ctypes binding for the port's C++ host core (``cpzk_tpu_torch/native/``).

``merlin.cpp`` (STROBE-128/Merlin transcripts and the threaded batch
challenge derivation), ``ristretto.cpp`` (RFC 9496 decode/encode, the
threaded row verifier, batch decode and proof parse, and the constant-time
fixed-base comb for secret scalars) and ``wire.cpp`` (the request-wire
scanner of the gRPC service's three hot messages) are built together into
one shared library at first use, with ``g++`` called directly, into the ignored
``cpzk_tpu_torch/_build/``.  The library's name is a hash of the sources,
the compiler, its flags and the host's CPU model (``-march=native`` code
must not be loaded on another CPU); concurrent first builds take an
exclusive file lock, compile to a per-process temporary file and
``os.replace`` it into place, so every process loads one complete library.

:func:`build_sanitizer_driver` links ``native/tsan_driver.cpp`` (the row
pool, threaded challenges and the comb rwlock under churn) with the same
``SOURCES`` under ThreadSanitizer or AddressSanitizer with UBSan, so an
instrumented run covers exactly what serving loads.

There is no silent fallback: a failed build or load raises
:class:`NativeCoreError` with the compiler's output in the message.  The
pure-Python twins of these functions live beside their callers under
explicit names (``PureTranscript``, ``derive_challenges_batch_pure``,
``Ristretto255.element_from_bytes_pure``, ``Proof.from_bytes_pure``,
``Verifier.verify_pure``, ``CpuBackend.verify_each_pure``) and are reached
only by asking for them.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PACKAGE_DIR / "native"
SOURCES = (SRC_DIR / "merlin.cpp", SRC_DIR / "ristretto.cpp", SRC_DIR / "wire.cpp")
BUILD_DIR = PACKAGE_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
#: ``cpzk_abi_version()`` that ``ristretto.cpp`` must report.
ABI_VERSION = 4
#: The sanitizer driver and its builds: the flags of the reference
#: Makefile's ``tsan`` / ``asan-ubsan`` targets (``SAN_CXXFLAGS`` plus each
#: kind's own), keyed by the ``-fsanitize=`` value.
SAN_DRIVER = SRC_DIR / "tsan_driver.cpp"
SAN_CXX_FLAGS = ("-O1", "-g", "-std=c++17", "-Wall", "-Wextra")
SANITIZERS = {
    "thread": ("-fsanitize=thread",),
    "address,undefined": ("-fsanitize=address,undefined", "-fno-sanitize-recover=all"),
}

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_char_p
_N = ctypes.c_size_t


class NativeCoreError(RuntimeError):
    """The host core could not be built or loaded."""


def _arch_flags() -> tuple[str, ...]:
    return ("-march=native",) if platform.machine() in ("x86_64", "AMD64") else ()


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "Model", "CPU part")):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _digest(cxx: str, flags: tuple[str, ...], sources: tuple[Path, ...]) -> str:
    """Hash of a build: compiler, flags, CPU and every source's bytes."""
    h = hashlib.sha256()
    for part in (cxx, *flags, *_arch_flags(), platform.machine(), _cpu_model()):
        h.update(part.encode() + b"\0")
    for src in sources:
        h.update(src.name.encode() + b"\0")
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_name(cxx: str | None = None) -> str:
    """File name of the library these sources, compiler, flags and CPU give."""
    return f"libcpzk_host_{_digest(cxx or CXX, CXX_FLAGS, SOURCES)}.so"


def _compile(out: Path, cmd_for, what: str) -> Path:
    """Build ``out`` unless it exists: under an exclusive lock beside it,
    ``cmd_for(tmp)`` compiles to a per-process temporary name that is
    renamed into place, so every process finds one complete file."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = cmd_for(tmp)
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise NativeCoreError(f"{what} build failed: {' '.join(cmd)}: {exc}") from exc
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeCoreError(
                f"{what} build failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stderr}{res.stdout}")
        os.replace(tmp, out)
    return out


def build(cxx: str | None = None, out_dir: Path | None = None) -> Path:
    """Compile the sources with ``cxx`` (default :data:`CXX`) into
    ``out_dir`` (default :data:`BUILD_DIR`) unless a library for them
    already exists there; returns its path.  Raises :class:`NativeCoreError`
    with the compiler's output when the compiler fails."""
    cxx = cxx or CXX
    return _compile(
        Path(out_dir or BUILD_DIR) / library_name(cxx),
        lambda tmp: [cxx, *CXX_FLAGS, *_arch_flags(), "-o", str(tmp),
                     *map(str, SOURCES), "-lpthread"],
        "host core")


def build_sanitizer_driver(kind: str, cxx: str | None = None,
                           out_dir: Path | None = None) -> Path:
    """The sanitizer driver executable for ``kind`` (a key of
    :data:`SANITIZERS`: ``"thread"`` or ``"address,undefined"``): the
    library's own :data:`SOURCES` plus :data:`SAN_DRIVER`, built with
    :data:`SAN_CXX_FLAGS` into ``out_dir`` (default :data:`BUILD_DIR`)
    unless it exists there.  Raises :class:`NativeCoreError` as
    :func:`build` does, and ``ValueError`` for an unknown ``kind``."""
    if kind not in SANITIZERS:
        raise ValueError(f"sanitizer {kind!r} is not one of {tuple(SANITIZERS)}")
    cxx = cxx or CXX
    flags = SAN_CXX_FLAGS + SANITIZERS[kind]
    sources = SOURCES + (SAN_DRIVER,)
    tag = "tsan" if kind == "thread" else "asan"
    return _compile(
        Path(out_dir or BUILD_DIR) / f"cpzk_{tag}_driver_{_digest(cxx, flags, sources)}",
        lambda tmp: [cxx, *flags, *_arch_flags(), "-o", str(tmp),
                     *map(str, sources), "-lpthread"],
        f"{kind} sanitizer driver")


def _declare(lib: ctypes.CDLL) -> None:
    """restype/argtypes of every symbol the library exports."""
    lib.cpzk_abi_version.restype = ctypes.c_int
    lib.cpzk_abi_version.argtypes = []
    lib.cpzk_transcript_new.restype = ctypes.c_void_p
    lib.cpzk_transcript_new.argtypes = [_P, _N]
    lib.cpzk_transcript_free.restype = None
    lib.cpzk_transcript_free.argtypes = [ctypes.c_void_p]
    lib.cpzk_transcript_append.restype = None
    lib.cpzk_transcript_append.argtypes = [ctypes.c_void_p, _P, _N, _P, _N]
    lib.cpzk_transcript_challenge.restype = None
    lib.cpzk_transcript_challenge.argtypes = [ctypes.c_void_p, _P, _N, _P, _N]
    lib.cpzk_challenge_batch.restype = None
    lib.cpzk_challenge_batch.argtypes = [
        _N, _P, ctypes.POINTER(ctypes.c_uint32), _P, _P, _P, _P, _P, _P, _P, _P,
        ctypes.c_int]
    lib.cpzk_verify_rows.restype = ctypes.c_int
    lib.cpzk_verify_rows.argtypes = [_N] + [_P] * 9 + [ctypes.c_int]
    lib.cpzk_point_roundtrip.restype = ctypes.c_int
    lib.cpzk_point_roundtrip.argtypes = [_P, _P]
    lib.cpzk_point_validate.restype = ctypes.c_int
    lib.cpzk_point_validate.argtypes = [_P]
    lib.cpzk_batch_decode.restype = ctypes.c_int
    lib.cpzk_batch_decode.argtypes = [_N, _P, _P, _P, ctypes.c_int]
    lib.cpzk_parse_proofs.restype = ctypes.c_int
    lib.cpzk_parse_proofs.argtypes = [_N, _P, _P, ctypes.c_int, ctypes.c_int]
    lib.cpzk_sc_mul_beta.restype = ctypes.c_int
    lib.cpzk_sc_mul_beta.argtypes = [_P, _P, _P]
    lib.cpzk_scalarmul.restype = ctypes.c_int
    lib.cpzk_scalarmul.argtypes = [_P, _P, _P]
    lib.cpzk_point_add.restype = ctypes.c_int
    lib.cpzk_point_add.argtypes = [_P, _P, _P]
    lib.cpzk_basemul_init.restype = ctypes.c_int
    lib.cpzk_basemul_init.argtypes = [_P, _P]
    lib.cpzk_double_basemul.restype = ctypes.c_int
    lib.cpzk_double_basemul.argtypes = [_P, _P, _P, _P, _P]
    lib.cpzk_wire_scan.restype = ctypes.c_int
    lib.cpzk_wire_scan.argtypes = [ctypes.c_int, _P, _N, ctypes.POINTER(ctypes.c_size_t)]
    lib.cpzk_wire_fill.restype = ctypes.c_int
    lib.cpzk_wire_fill.argtypes = (
        [ctypes.c_int, _P, _N] + [ctypes.POINTER(ctypes.c_uint64)] * 7 + [_P])
    lib.cpzk_wire_gather.restype = ctypes.c_size_t
    lib.cpzk_wire_gather.argtypes = [
        _P, _N, ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64), _N, _P]


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library, declare its symbols and check its ABI version."""
    try:
        lib = ctypes.CDLL(str(path))
        _declare(lib)
    except (OSError, AttributeError) as exc:
        raise NativeCoreError(f"host core {path} does not load: {exc}") from exc
    abi = lib.cpzk_abi_version()
    if abi != ABI_VERSION:
        raise NativeCoreError(
            f"host core {path} reports ABI version {abi}, expected {ABI_VERSION}")
    return lib


def load() -> ctypes.CDLL:
    """The host core, built on first use.  Raises :class:`NativeCoreError`."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = open_library(build())
        return _LIB


def default_threads() -> int:
    """Threads the native pools use when a caller passes ``threads=0``
    (``std::thread::hardware_concurrency()`` in ``merlin.cpp``; the online
    CPUs, as ``os.cpu_count()`` reports them)."""
    return os.cpu_count() or 1


def _check_columns(n: int, **cols: bytes) -> None:
    for name, col in cols.items():
        if len(col) != 32 * n:
            raise ValueError(f"{name} must be {32 * n} bytes (n*32), got {len(col)}")


def challenge_batch(contexts: list[bytes | None], gs: bytes, hs: bytes,
                    y1s: bytes, y2s: bytes, r1s: bytes, r2s: bytes,
                    threads: int = 0) -> bytes:
    """n 64-byte Fiat-Shamir challenges on the native thread pool
    (``threads=0``: one thread per online CPU).  Point args are n*32-byte
    concatenations; ``contexts[i] is None`` means no context append for row
    i (distinct from ``b""``)."""
    lib = load()
    n = len(contexts)
    _check_columns(n, gs=gs, hs=hs, y1s=y1s, y2s=y2s, r1s=r1s, r2s=r2s)
    has_ctx = bytes(0 if c is None else 1 for c in contexts)
    blob = b"".join(c or b"" for c in contexts)
    offsets = (ctypes.c_uint32 * (n + 1))()
    off = 0
    for i, c in enumerate(contexts):
        offsets[i] = off
        off += len(c or b"")
    offsets[n] = off
    out = ctypes.create_string_buffer(64 * n)
    lib.cpzk_challenge_batch(n, blob, offsets, has_ctx, gs, hs, y1s, y2s, r1s, r2s,
                             out, threads)
    return out.raw


def verify_rows(g: bytes, h: bytes, y1s: bytes, y2s: bytes, r1s: bytes, r2s: bytes,
                ss: bytes, cs: bytes, threads: int = 0) -> list[int]:
    """Verify n Chaum-Pedersen rows (s*G == R1 + c*Y1 and the H/Y2 twin)
    sharing the 32-byte generators ``g``, ``h``; the six columns are
    n*32-byte concatenations.  Per-row status: 1 pass, 0 fail, 2 a
    commitment wire that does not decode (deferred-parse rows)."""
    lib = load()
    if len(g) != 32 or len(h) != 32:
        raise ValueError("g and h must be 32-byte encodings")
    if len(ss) % 32 != 0:
        raise ValueError(f"ss must be a multiple of 32 bytes, got {len(ss)}")
    n = len(ss) // 32
    _check_columns(n, y1s=y1s, y2s=y2s, r1s=r1s, r2s=r2s, ss=ss, cs=cs)
    if threads <= 0:
        threads = min(default_threads(), max(1, n))
    out = ctypes.create_string_buffer(n)
    lib.cpzk_verify_rows(n, g, h, y1s, y2s, r1s, r2s, ss, cs, out, threads)
    return list(out.raw)


def _decode_threads(n: int, threads: int) -> int:
    return threads if threads > 0 else min(default_threads(), max(1, n // 256 + 1))


def batch_decode(wires: bytes, threads: int = 0) -> tuple[bytes, bytes]:
    """Decode n concatenated 32-byte wires to extended coordinates on the
    worker pool: ``(coords, ok)``, coords n*128 bytes (X|Y|Z|T, canonical
    little-endian field bytes each), ok n flag bytes."""
    lib = load()
    if len(wires) % 32:
        raise ValueError("wires must be a multiple of 32 bytes")
    n = len(wires) // 32
    coords = ctypes.create_string_buffer(128 * n)
    ok = ctypes.create_string_buffer(n)
    lib.cpzk_batch_decode(n, wires, coords, ok, _decode_threads(n, threads))
    return coords.raw, ok.raw


def batch_decode_into(wires: bytes, coords, ok, threads: int = 0) -> None:
    """:func:`batch_decode` into caller-provided writable C-contiguous
    buffers (numpy uint8 arrays): ``coords`` of at least 128*n bytes, ``ok``
    of at least n, for n = len(wires)/32."""
    lib = load()
    if len(wires) % 32:
        raise ValueError("wires must be a multiple of 32 bytes")
    n = len(wires) // 32
    if coords.nbytes < 128 * n or ok.nbytes < n:
        raise ValueError("staging buffers too small for the wire count")
    if not (coords.flags.c_contiguous and ok.flags.c_contiguous):
        raise ValueError("staging buffers must be C-contiguous")
    cbuf = (ctypes.c_char * (128 * n)).from_buffer(coords)
    obuf = (ctypes.c_char * n).from_buffer(ok)
    lib.cpzk_batch_decode(n, wires, cbuf, obuf, _decode_threads(n, threads))


def parse_proofs(packed: bytes, deep: bool = True, threads: int = 0) -> bytes:
    """Validate n packed 109-byte proof wires; n flag bytes, 1 when item i
    is a complete valid proof, 0 when it must be re-parsed on the Python
    parser for its exact error.  ``deep=False`` skips the two commitment
    point decodes (deferred parsing: the verify stage settles them)."""
    lib = load()
    if len(packed) % 109:
        raise ValueError("packed must be a multiple of 109 bytes")
    n = len(packed) // 109
    ok = ctypes.create_string_buffer(n)
    if threads <= 0:
        threads = 1 if not deep else min(default_threads(), max(1, n // 512 + 1))
    lib.cpzk_parse_proofs(n, packed, ok, 1 if deep else 0, threads)
    return ok.raw


def point_validate(wire: bytes) -> bool:
    """Whether ``wire`` is a canonical ristretto255 encoding (decode only:
    RFC 9496 decoding rejects every non-canonical encoding)."""
    lib = load()
    if len(wire) != 32:
        return False
    return bool(lib.cpzk_point_validate(wire))


def sc_mul_beta(beta16: bytes, scalar: bytes) -> bytes:
    """(beta * scalar) mod l with a 16-byte little-endian beta (the merged
    row check's weight math)."""
    lib = load()
    if len(beta16) != 16 or len(scalar) != 32:
        raise ValueError("beta must be 16 bytes and scalar 32 bytes")
    out = ctypes.create_string_buffer(32)
    if not lib.cpzk_sc_mul_beta(beta16, scalar, out):
        raise ValueError("scalar out of domain (must be < 2^253)")
    return out.raw


def point_roundtrip(wire: bytes) -> bytes:
    """Decode and re-encode; ``b""`` when the encoding is rejected."""
    lib = load()
    if len(wire) != 32:
        return b""
    out = ctypes.create_string_buffer(32)
    if not lib.cpzk_point_roundtrip(wire, out):
        return b""
    return out.raw


def scalarmul(point: bytes, scalar: bytes) -> bytes:
    """scalar * point (variable time, public inputs); ``b""`` when the point
    does not decode."""
    lib = load()
    if len(point) != 32 or len(scalar) != 32:
        raise ValueError("point and scalar must be 32 bytes")
    out = ctypes.create_string_buffer(32)
    if not lib.cpzk_scalarmul(point, scalar, out):
        return b""
    return out.raw


def point_add(a: bytes, b: bytes) -> bytes:
    """a + b; ``b""`` when either point does not decode."""
    lib = load()
    if len(a) != 32 or len(b) != 32:
        raise ValueError("points must be 32 bytes")
    out = ctypes.create_string_buffer(32)
    if not lib.cpzk_point_add(a, b, out):
        return b""
    return out.raw


def basemul_init(g: bytes, h: bytes) -> bool:
    """(Re)build the comb tables for a generator pair; False when a
    generator does not decode."""
    lib = load()
    if len(g) != 32 or len(h) != 32:
        raise ValueError("g and h must be 32 bytes")
    return bool(lib.cpzk_basemul_init(g, h))


def double_basemul(g: bytes, h: bytes, scalar: bytes) -> tuple[bytes, bytes] | None:
    """Constant-time (s*G, s*H) on the fixed-base comb; None when a
    generator does not decode or another thread swapped the comb's
    generator pair between its build and this read (the caller rebuilds
    once and retries).  Table builds and reads are serialized by a rwlock
    in C: ctypes releases the GIL around the call."""
    lib = load()
    if len(g) != 32 or len(h) != 32 or len(scalar) != 32:
        raise ValueError("g, h and scalar must be 32 bytes")
    out1 = ctypes.create_string_buffer(32)
    out2 = ctypes.create_string_buffer(32)
    if not lib.cpzk_double_basemul(g, h, scalar, out1, out2):
        return None
    return out1.raw, out2.raw


# --- request-wire parse (native/wire.cpp) ----------------------------------

#: Message kinds, mirroring the enum in ``native/wire.cpp``.
WIRE_CHALLENGE = 1       # auth.ChallengeRequest
WIRE_BATCH_VERIFY = 2    # auth.BatchVerificationRequest
WIRE_STREAM_CHUNK = 3    # auth.StreamVerifyRequest


def wire_index(kind: int, data: bytes):
    """Index one request message's known fields natively.

    Returns ``(counts, offs, lens, vals, mint)``: per-bucket counts
    ``(n0, n1, n2, n_vals)``, per-bucket ctypes uint64 offset/length arrays
    into ``data``, the decoded uint64 ``ids`` values, and the final
    ``mint_sessions`` bool; or ``None`` when the message is outside the
    parser's recognized subset (the caller then parses it with the protobuf
    runtime, which makes accept/reject and field values identical by
    construction)."""
    lib = load()
    counts = (ctypes.c_size_t * 4)()
    if not lib.cpzk_wire_scan(kind, data, len(data), counts):
        return None
    n0, n1, n2, nv = counts[0], counts[1], counts[2], counts[3]
    offs = tuple((ctypes.c_uint64 * max(n, 1))() for n in (n0, n1, n2))
    lens = tuple((ctypes.c_uint64 * max(n, 1))() for n in (n0, n1, n2))
    vals = (ctypes.c_uint64 * max(nv, 1))()
    flags = ctypes.create_string_buffer(1)
    if not lib.cpzk_wire_fill(
        kind, data, len(data),
        offs[0], lens[0], offs[1], lens[1], offs[2], lens[2], vals, flags,
    ):
        return None  # the fill walks as the scan did: unreachable
    return (n0, n1, n2, nv), offs, lens, vals, flags.raw[0:1] == b"\x01"


def wire_gather(data: bytes, offs, lens, n: int, total: int) -> bytes:
    """Concatenate ``n`` (offset, length) ranges of ``data`` (``total``
    bytes in all) into a fresh bytes object."""
    lib = load()
    buf = ctypes.create_string_buffer(total)
    written = lib.cpzk_wire_gather(data, len(data), offs, lens, n, buf)
    if written != total:
        raise ValueError("wire gather ranges out of bounds")
    return buf.raw


class NativeMerlin:
    """Incremental Merlin transcript on the host core (``MerlinTranscript``
    twin, byte for byte)."""

    __slots__ = ("_h", "_lib")

    def __init__(self, label: bytes):
        self._lib = load()
        self._h = self._lib.cpzk_transcript_new(label, len(label))

    def append_message(self, label: bytes, message: bytes) -> None:
        self._lib.cpzk_transcript_append(self._h, label, len(label), message, len(message))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._lib.cpzk_transcript_challenge(self._h, label, len(label), out, n)
        return out.raw

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cpzk_transcript_free(h)
            self._h = None
