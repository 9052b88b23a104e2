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
kernels, their block size and a plain C launch interface).  This module
also builds the kernel library of the whole package: every ``csrc/*.cu``
(these kernels, :mod:`.ladder_kernels`', :mod:`.scalar_kernels`',
:mod:`.msm_kernels`', :mod:`.keccak_kernels`', :mod:`.prove_kernels`' and
:mod:`.decode_kernels`') compiled with ``nvcc`` for ``sm_90a``, in
parallel, and linked into one shared library at first use (:func:`build`,
:func:`library`), loaded with ``ctypes``.

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
import sys
import threading
from pathlib import Path

import torch

from . import limbs
from .limbs import NLIMBS

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: build output (listed in .gitignore); one library per source hash
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
#: flags of each source's compile (``-Xptxas -v``: registers and spills)
#: and of the link of their objects into one shared library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LINK_FLAGS = ("-shared",)

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


#: Guards every kernel module's ``LAUNCHES`` increments: lanes and mesh
#: slices launch from several threads at once.
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def count_launch(launches: dict, name: str) -> None:
    """Add one to ``launches[name]`` (a kernel module's ``LAUNCHES``), and
    to the calling thread's open :func:`thread_launches` tally."""
    with _COUNT_LOCK:
        launches[name] += 1
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1


class thread_launches:
    """Context manager: the kernels the calling thread launches inside the
    block, counted by name into the dict it yields (a serving lane's share
    of launches while other lanes launch from their own threads)."""

    def __enter__(self) -> dict:
        self._prev = getattr(_TALLY, "counts", None)
        _TALLY.counts = {}
        return _TALLY.counts

    def __exit__(self, *exc) -> None:
        _TALLY.counts = self._prev


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
    """Compile every ``*.cu`` of ``csrc`` (by default the package's own
    sources: the point, ladder, scalar, MSM, Keccak, prover and DECODE
    kernels) into ``_build/`` unless a library for those sources already
    exists: one ``nvcc -c`` per source, all started together, then one link
    into a shared library.  Returns the library path and the compiler's report
    (``-Xptxas -v``: registers and spills per kernel), kept beside the
    library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(csrc.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libcpzk_kernels_{h.hexdigest()[:16]}.so"
    report = out.with_suffix(".ptxas.txt")
    if out.exists() and report.exists():
        return out, report.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = _nvcc()
    sources = sorted(csrc.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(sources, objs))]
    stderr = []
    try:
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            stderr.append(err)
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    text = "".join(stderr)
    report.write_text(text)
    os.replace(tmp, out)
    return out, text


def kernel_modules() -> tuple:
    """The modules of the library's kernels: this one, :mod:`.ladder_kernels`,
    :mod:`.scalar_kernels`, :mod:`.msm_kernels`, :mod:`.keccak_kernels`,
    :mod:`.prove_kernels` and :mod:`.decode_kernels`.  The one registry of
    the kernels: each module's ``LAUNCHES`` keys are its kernels' wrapper
    names."""
    from . import (decode_kernels, keccak_kernels, ladder_kernels, msm_kernels, prove_kernels,
                   scalar_kernels)

    return (sys.modules[__name__], ladder_kernels, scalar_kernels, msm_kernels, keccak_kernels,
            prove_kernels, decode_kernels)


def kernel_names() -> tuple[str, ...]:
    """Every kernel of the library, by wrapper name."""
    return tuple(name for module in kernel_modules() for name in module.LAUNCHES)


def all_launches() -> dict[str, int]:
    """Every kernel wrapper's launch count."""
    return {name: count for module in kernel_modules() for name, count in
            module.LAUNCHES.items()}


def reset_all_launches() -> None:
    for module in kernel_modules():
        module.reset_launches()


def ptxas_report(report: str) -> dict[str, dict]:
    """Registers and stack and spill bytes per kernel (keyed by wrapper
    name) from the ``-Xptxas -v`` report that :func:`build` returns.  A
    wrapper whose call launches several ``__global__`` functions (named
    ``<wrapper>_<step>_kernel``) gets each under ``globals``, beside their
    largest register count and stack and the sums of their spills."""
    per_fn: dict[str, dict[str, dict[str, int]]] = {}
    names = kernel_names()
    entry = None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            entry = None
            for k in names:
                g = re.search(rf"{k}(?:_[a-z]+)?_kernel", m.group(1))
                if g:
                    entry = per_fn.setdefault(k, {}).setdefault(g.group(0), {})
                    break
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                         spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    out: dict[str, dict] = {}
    for name, fns in per_fn.items():
        if len(fns) == 1:
            out[name] = next(iter(fns.values()))
            continue
        info: dict = {"globals": fns}
        for key, join in (("stack_bytes", max), ("spill_store_bytes", sum),
                          ("spill_load_bytes", sum), ("registers", max)):
            vals = [f[key] for f in fns.values() if key in f]
            if vals:
                info[key] = join(vals)
        out[name] = info
    return out


#: the C entry points of the library and their arguments: pointers (and
#: the stream) as ``c_void_p``, ints as ``c_int``
_I = ctypes.c_int
ENTRY_POINTS = {
    "cpzk_point_add": [_P] * 12 + [_I, _P],
    "cpzk_point_double_k": [_P] * 7 + [_I] * 2 + [_P],
    "cpzk_block_threads": [_I],
    "cpzk_rlc_scalars": [_P] * 11 + [_I, _P],
    "cpzk_rlc_scalars_blocks": [_I],
    "cpzk_launch_floor": [_P],
    "cpzk_scalar_recode": [_P] * 6 + [_I] * 6 + [_P] * 2,
    "cpzk_msm_bucket": [_P] * 10 + [_I] * 3 + [_P],
    "cpzk_msm_bucket_scratch": [_I] * 3,
    "cpzk_msm_window_reduce": [_P] * 9 + [_I] * 2 + [_P],
    "cpzk_msm_quad_chain": [_P, _P, _I, _P],
    "cpzk_reduce_wide": [_P, _I, _P, _I, _P],
    "cpzk_keccak_chain": [_P, _P, _I, _P, _P, _I, _I, _P, _P, _P],
    "cpzk_comb_tables": [_P] * 6,
    "cpzk_commitments": [_P] * 5 + [_I, _P],
    "cpzk_ristretto_decode": [_P, _I, _P, _P, _P],
    "cpzk_ladder_scratch_words": [_I, _I, _I],
    "cpzk_ladder_combined": [_P] * 9 + [_I, _P],
    "cpzk_ladder_partials_identity": [_P] * 3 + [_I, _P],
    "cpzk_ladder_each": [_P] * 7 + [_I, _P],
}


def load(path: Path) -> ctypes.CDLL:
    """Load a library built by :func:`build` and declare the entry points it
    has (a build of an older ``csrc`` may lack the later kernels)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The kernel library of the package's sources: built (:func:`build`)
    and loaded once per process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build()
            _LIB = load(path)
        return _LIB


def block_threads(n: int, device: torch.device | str = "cuda") -> int:
    """Threads per block the kernels launch with for n lanes on ``device``
    (``cpzk_block_threads`` in ``csrc/point_ops.cu``)."""
    lib = library()
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


def words_of_limbs(lim: torch.Tensor) -> torch.Tensor:
    """``[..., 20]`` limbs in [0, 2^13) -> ``[..., 8]`` int32 words of the same
    value (below 2^256; the words read as unsigned 32-bit values)."""
    lim = lim.to(torch.int64)
    words = []
    for k in range(8):
        acc = torch.zeros(lim.shape[:-1], dtype=torch.int64, device=lim.device)
        for i in range(NLIMBS):
            shift = limbs.LIMB_BITS * i - 32 * k
            if -limbs.LIMB_BITS < shift < 32:
                acc = acc | (lim[..., i] << shift if shift >= 0 else lim[..., i] >> -shift)
        acc = acc & 0xFFFFFFFF
        words.append(acc - ((acc >> 31) << 32))
    return torch.stack(words, dim=-1).to(torch.int32)


def limbs_of_words(words: torch.Tensor) -> torch.Tensor:
    """``[..., 8]`` int32 words -> ``[..., 20]`` int32 limbs in [0, 2^13), the
    same value."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    out = []
    for i in range(NLIMBS):
        bit = limbs.LIMB_BITS * i
        wd, sh = bit >> 5, bit & 31
        v = w[..., wd] >> sh
        if sh > 32 - limbs.LIMB_BITS and wd + 1 < 8:
            v = v | (w[..., wd + 1] << (32 - sh))
        out.append((v & limbs.LIMB_MASK).to(torch.int32))
    return torch.stack(out, dim=-1)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def resolve_device(name: str, device) -> torch.device:
    """An entry point's device: ``None`` means ``cuda:0`` and raises without
    CUDA; anything else (``"cpu"`` for the plain versions) as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{name}: CUDA is not available (pass device='cpu' "
                               "to run the plain PyTorch versions on the CPU)")
        return torch.device("cuda", 0)
    return torch.device(device)


def on_card(name: str, device: torch.device) -> bool:
    """How a wrapper routes a tensor on ``device``: True to launch its
    kernel (CUDA), False for its plain version (CPU); any other device
    raises."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    return True


def point_add(p: Point, q: Point) -> Point:
    """p + q per lane; operands broadcast to a common ``[20, ...]`` shape."""
    device = p[0].device
    if not on_card("point_add", device):
        return point_add_plain(p, q)
    flat, shape = _lanes(list(p) + list(q), device)
    n = flat[0].shape[1]
    out = [torch.empty((NLIMBS, n), dtype=torch.int32, device=device) for _ in range(4)]
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_point_add(
            *(c.data_ptr() for c in flat), *(o.data_ptr() for o in out), n, stream)
    _check(rc, "point_add")
    count_launch(LAUNCHES, "point_add")
    return tuple(o.reshape(shape) for o in out)


def point_double_k(p: Point, k: int) -> Point:
    """k fused doublings of p (k >= 1); T of the input is not read."""
    if k < 1:
        raise ValueError("point_double_k needs k >= 1")
    device = p[0].device
    if not on_card("point_double_k", device):
        return point_double_k_plain(p, k)
    flat, shape = _lanes(list(p[:3]), device)
    n = flat[0].shape[1]
    out = [torch.empty((NLIMBS, n), dtype=torch.int32, device=device) for _ in range(4)]
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cpzk_point_double_k(
            *(c.data_ptr() for c in flat), *(o.data_ptr() for o in out), n, k, stream)
    _check(rc, "point_double_k")
    count_launch(LAUNCHES, "point_double_k")
    return tuple(o.reshape(shape) for o in out)
