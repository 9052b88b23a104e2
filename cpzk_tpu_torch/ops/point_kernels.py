"""The two hand-written CUDA point kernels, their wrappers, their plain
PyTorch versions and their launch counters.

=====================  ======================================================
kernel                 replaces
=====================  ======================================================
``point_add``          ``cpzk_tpu/ops/pallas_kernels.py::_add_kernel``
``point_double_k``     ``cpzk_tpu/ops/pallas_kernels.py::_double_k_kernel``
=====================  ======================================================

Sources: ``csrc/fe25519_w32.cuh`` (field and point arithmetic for one lane,
``__host__ __device__``) and ``csrc/point_ops.cu`` (the ``__global__``
kernels, their block size and a plain C launch interface), built with
``nvcc`` for ``sm_90a`` into a shared library at first use (:func:`build`)
and loaded with ``ctypes``.

Design.  One thread per lane (batch column) of the limb-major ``[20, n]``
layout, so a warp's load of one limb is 32 consecutive words.  The thread
converts its coordinates once to 8 unsigned 32-bit words (value below
2^256, not reduced below p), keeps its point in registers through the
whole operation (the 9 field multiplications of an add, and all k rounds
of ``double_k`` with no stores between rounds, which is what the Pallas
kernels kept in VMEM), and stores limbs in [0, 2^13) once.  A multiply is
64 word products with the thread's 32x32->64-bit multiply-add, folded by
38 (2^256 = 38 mod p); a square is 36 products.  The TPU kernels' 20x13
signed-limb schedule exists because the TPU has no widening multiply;
copied onto the H100 it cost about 1.2k instructions a multiply and made
each launch as slow as one lane's dependent chain at every width.  The
kernels have their own radix, so their outputs equal the plain versions'
after :func:`limbs.canonical`, not limb for limb; every output limb is
within :data:`limbs.BOUND`, so every plain op downstream takes them.

What bounds them on an H100.  Per lane an add moves 12 coordinate arrays
(960 B) and a ``double_k(4)`` 7 arrays (560 B); the int32 operations the
function needs are the fewer of two counts (:data:`ADD_OPS_PER_LANE`,
:func:`double_k_ops_per_lane`).  Against 3.35 TB/s and the card's int32
rate (132 SMs x 64 operations a clock) the add is bound by bytes and
``double_k(4)`` by operations.  A launch of a few thousand lanes is still
one dependent chain per thread, so the block size follows n
(:func:`block_threads`): one-warp blocks spread the warps over every SM's
schedulers.  ``PERF.md`` holds the measured times beside these bounds.

Routing: each wrapper runs the plain version for a tensor on the CPU and
launches its kernel for a CUDA tensor; any other device raises.  There is
no fallback from a CUDA tensor to the plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from . import limbs
from .limbs import NLIMBS

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build output (listed in .gitignore); one library per source hash
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"point_add": 0, "point_double_k": 0}

#: int32 operations one lane needs, the count behind the kernels' bound: the
#: fewer of two schedules' counts, so that the bound is the least work.
#:
#: 20x13-bit limbs (the TPU schedule, :mod:`.limbs`): a field multiply is
#: 400 schoolbook multiply-adds, a squaring 210 (20 squares, 190 cross
#: products) plus 19 doublings of the cross operand, and each ends in one
#: carry pass (19 multiply-adds folding the upper product limbs by 608,
#: then a shift, a mask and an add per limb, and the top fold).  Limbs have
#: headroom for the sums between multiplies, so an add/sub or a doubling
#: (``mul_small(., 2)``) is 20 operations.  (:mod:`.limbs` itself runs a
#: longer carry schedule, about 1.2k operations a multiply, not counted.)
CARRY_OPS = 19 + 3 * 20 + 1
MUL_OPS = 400 + CARRY_OPS
SQ_OPS = 210 + 19 + CARRY_OPS
LINEAR_OPS = 20
#:
#: 8x32-bit words (``csrc/fe25519_w32.cuh``): a word product is 2 operations
#: (the low and the high multiply-add, each taking its addend and carry), and
#: each row of products ends in one carry add.  A multiply is 64 products
#: and 8 row carries; a square 28 cross products and 7 row carries, 16
#: shifts to double them, 8 squares and 8 carry adds.  Both end in the fold:
#: 8 multiply-adds by 38 (2 operations each), the carry out times 38 (1)
#: and its chain over 8 words (8), and the last fold into word 0 (1).  An
#: add, sub or x2 is one 8-word chain plus the last three of the fold.
W32_FOLD_OPS = 8 * 2 + 1 + 8 + 1
W32_MUL_OPS = 64 * 2 + 8 + W32_FOLD_OPS
W32_SQ_OPS = 28 * 2 + 7 + 16 + 8 * 2 + 8 + W32_FOLD_OPS
W32_LINEAR_OPS = 8 + 1 + 8


def _add_ops(mul: int, linear: int) -> int:
    """9 multiplies, one doubling and 8 add/sub."""
    return 9 * mul + 9 * linear


def _double_k_ops(k: int, mul: int, sq: int, linear: int) -> int:
    """k rounds of 4 squarings, 3 multiplies, one doubling and 5 add/sub,
    then the final T multiply."""
    return k * (4 * sq + 3 * mul + 6 * linear) + mul


ADD_OPS_PER_LANE = min(_add_ops(MUL_OPS, LINEAR_OPS),
                       _add_ops(W32_MUL_OPS, W32_LINEAR_OPS))


def double_k_ops_per_lane(k: int) -> int:
    """int32 operations one lane of ``point_double_k(p, k)`` needs (the
    fewer of the two schedules' counts)."""
    return min(_double_k_ops(k, MUL_OPS, SQ_OPS, LINEAR_OPS),
               _double_k_ops(k, W32_MUL_OPS, W32_SQ_OPS, W32_LINEAR_OPS))


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (transcriptions of the Pallas kernel bodies)
# ---------------------------------------------------------------------------

def point_add_plain(p: Point, q: Point) -> Point:
    """Unified a=-1 extended addition (add-2008-hwcd-3), as
    ``pallas_kernels._add_kernel`` computes it."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = limbs.mul(limbs.sub(Y1, X1), limbs.sub(Y2, X2))
    B = limbs.mul(limbs.add(Y1, X1), limbs.add(Y2, X2))
    C = limbs.mul(limbs.mul(T1, limbs.on(limbs.D2, T1.device)), T2)
    Dv = limbs.mul_small(limbs.mul(Z1, Z2), 2)
    E = limbs.sub(B, A)
    F = limbs.sub(Dv, C)
    G = limbs.add(Dv, C)
    H = limbs.add(B, A)
    return (limbs.mul(E, F), limbs.mul(G, H), limbs.mul(F, G), limbs.mul(E, H))


def point_double_k_plain(p: Point, k: int) -> Point:
    """k fused a=-1 doublings (dbl-2008-hwcd), as
    ``pallas_kernels._double_k_kernel`` computes them: only X, Y, Z pass
    between rounds, T comes from the last round."""
    if k < 1:
        raise ValueError("point_double_k needs k >= 1")
    X, Y, Z = p[0], p[1], p[2]
    for _ in range(k):
        A = limbs.square(X)
        B = limbs.square(Y)
        C = limbs.mul_small(limbs.square(Z), 2)
        H = limbs.add(A, B)
        E = limbs.sub(H, limbs.square(limbs.add(X, Y)))
        G = limbs.sub(A, B)
        F = limbs.add(C, G)
        X, Y, Z = limbs.mul(E, F), limbs.mul(G, H), limbs.mul(F, G)
    return (X, Y, Z, limbs.mul(E, H))


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()
_P = ctypes.c_void_p


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(csrc: Path = CSRC) -> tuple[Path, str]:
    """Compile ``point_ops.cu`` of ``csrc`` (by default the package's own
    sources) into ``_build/`` unless a library for those sources already
    exists.  Returns the library path and the compiler's report
    (``-Xptxas -v``: registers and spills per kernel), kept beside the
    library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libcpzk_points_{h.hexdigest()[:16]}.so"
    report = out.with_suffix(".ptxas.txt")
    if out.exists() and report.exists():
        return out, report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / "point_ops.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    report.write_text(res.stderr)
    os.replace(tmp, out)
    return out, res.stderr


def ptxas_report(report: str) -> dict[str, dict[str, int]]:
    """Registers and stack and spill bytes per kernel (keyed by wrapper
    name) from the ``-Xptxas -v`` report that :func:`build` returns."""
    out: dict[str, dict[str, int]] = {}
    current = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = next((k for k in LAUNCHES if f"{k}_kernel" in m.group(1)), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, {}).update(
                stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return out


def load(path: Path) -> ctypes.CDLL:
    """Load a library built from ``point_ops.cu`` and declare its two launch
    entry points."""
    lib = ctypes.CDLL(str(path))
    lib.cpzk_point_add.argtypes = [_P] * 12 + [ctypes.c_int, _P]
    lib.cpzk_point_add.restype = ctypes.c_int
    lib.cpzk_point_double_k.argtypes = [_P] * 7 + [ctypes.c_int] * 2 + [_P]
    lib.cpzk_point_double_k.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build()
            lib = load(path)
            lib.cpzk_block_threads.argtypes = [ctypes.c_int]
            lib.cpzk_block_threads.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def block_threads(n: int, device: torch.device | str = "cuda") -> int:
    """Threads per block the kernels launch with for n lanes on ``device``
    (``cpzk_block_threads`` in ``csrc/point_ops.cu``)."""
    lib = _lib()
    with torch.cuda.device(device):
        return lib.cpzk_block_threads(n)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _lanes(coords, device: torch.device) -> tuple[list[torch.Tensor], tuple[int, ...]]:
    """Broadcast coordinate tensors to one ``[20, ...]`` shape and flatten
    them to contiguous ``[20, n]``; reject what the kernels do not take."""
    shape = torch.broadcast_shapes(*(c.shape for c in coords))
    if len(shape) < 2 or shape[0] != NLIMBS:
        raise ValueError(f"point coordinates must be [20, ...], got {tuple(shape)}")
    for c in coords:
        if c.dtype != torch.int32 or c.device != device:
            raise ValueError(
                f"point coordinates must be int32 on {device}, got {c.dtype} on {c.device}")
    flat = [c.expand(shape).reshape(NLIMBS, -1).contiguous() for c in coords]
    if flat[0].shape[1] < 1:
        raise ValueError("point kernels need at least one lane")
    return flat, tuple(shape)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def point_add(p: Point, q: Point) -> Point:
    """p + q per lane; operands broadcast to a common ``[20, ...]`` shape."""
    device = p[0].device
    if device.type == "cpu":
        return point_add_plain(p, q)
    if device.type != "cuda":
        raise ValueError(f"point_add: unsupported device {device}")
    flat, shape = _lanes(list(p) + list(q), device)
    n = flat[0].shape[1]
    out = [torch.empty((NLIMBS, n), dtype=torch.int32, device=device) for _ in range(4)]
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_point_add(
            *(c.data_ptr() for c in flat), *(o.data_ptr() for o in out), n, stream)
    _check(rc, "point_add")
    LAUNCHES["point_add"] += 1
    return tuple(o.reshape(shape) for o in out)


def point_double_k(p: Point, k: int) -> Point:
    """k fused doublings of p (k >= 1); T of the input is not read."""
    if k < 1:
        raise ValueError("point_double_k needs k >= 1")
    device = p[0].device
    if device.type == "cpu":
        return point_double_k_plain(p, k)
    if device.type != "cuda":
        raise ValueError(f"point_double_k: unsupported device {device}")
    flat, shape = _lanes(list(p[:3]), device)
    n = flat[0].shape[1]
    out = [torch.empty((NLIMBS, n), dtype=torch.int32, device=device) for _ in range(4)]
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_point_double_k(
            *(c.data_ptr() for c in flat), *(o.data_ptr() for o in out), n, k, stream)
    _check(rc, "point_double_k")
    LAUNCHES["point_double_k"] += 1
    return tuple(o.reshape(shape) for o in out)
