"""The hand-written CUDA ristretto DECODE kernel, its wrapper, its plain
PyTorch version and its launch counter.

=====================  ======================================================
kernel                 replaces
=====================  ======================================================
``ristretto_decode``   ``cpzk_tpu/ops/curve.py::decode`` (RFC 9496 DECODE,
                       an XLA program in the JAX package)
=====================  ======================================================

Sources: ``csrc/decode_w32.cuh`` (``dec_ristretto`` for one lane,
``__host__ __device__``, on ``csrc/ristretto_w32.cuh``'s field functions)
and ``csrc/decode_ops.cu`` (the kernel and its C launch interface), built
into the package's kernel library by :func:`.point_kernels.library`.

Layout: the wrapper takes the kernel's own layout only, the wires as one
``[n, 32]`` uint8 tensor (lane j's encoding in row j), and returns the point
as ``[4, 8, n]`` int32 words (coordinate X, Y, Z, T, then word, then lane;
each the canonical value below p, read as unsigned 32-bit words) and
``[n]`` uint8 validity (1: a point; 0: not a canonical encoding, and the
identity).  :func:`words_to_limbs` turns the words into the ``[20, n]``
limbs of :mod:`.curve` and :mod:`.point_kernels`.

No serving path of either package decodes on the device (the rows' wires
go through the host core's batch decode), and none calls this one: it is
the port of ``curve.decode``, held against the plain version and the host
core on the card.

What bounds it on an H100: :func:`decode_work` counts the bytes and the
int32 operations (it is bound by operations), but a lane is one chain of
284 dependent products, and up to one warp a scheduler (16,384 lanes) that
chain is the kernel's time.  The design shortens it: one thread a lane,
the 262 products of SQRT_RATIO_M1's power in radix 2^25.5 (ten 64-bit
column sums of single multiply-adds, a short carry), 174 instructions a
squaring where words take 218.  ``PERF.md`` holds the measured times and
the designs that lost (a lane split over two or four threads among them).

Routing: :func:`ristretto_decode` runs on ``cuda:0`` unless the caller
passes a device (and raises without CUDA, as
:func:`.point_kernels.resolve_device` does); it runs the plain version for
a tensor on the CPU and launches its kernel for a CUDA tensor; any other
device raises, and a failed launch raises.  There is no fallback from a
CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from . import curve, limbs
from .point_kernels import (
    W32_MUL_OPS, W32_SQ_OPS, _check, count_launch, library, limbs_of_words, on_card,
    resolve_device, words_of_limbs,
)

Point = curve.Point

#: Kernel launches per wrapper since the last :func:`reset_launches`.  A
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {"ristretto_decode": 0}

#: int32 operations of one DECODE on 8 x 32-bit words
#: (``csrc/ristretto_w32.cuh``): SQRT_RATIO_M1 is 254 squarings (251 of them
#: in the a^((p-5)/8) chain) and 19 multiplies, and the rest of DECODE 3
#: squarings and 8 multiplies.  The canonical reductions, adds, selects and
#: byte loads are not counted, as for ENCODE (``prove_kernels.ENCODE_OPS``).
DECODE_OPS = 257 * W32_SQ_OPS + 27 * W32_MUL_OPS


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def decode_work(n: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one ``ristretto_decode`` over n lanes:
    32 bytes read, 4 x 32 bytes of words and one validity byte written a
    lane, :data:`DECODE_OPS` a lane."""
    return (32 + 4 * 32 + 1) * n, DECODE_OPS * n


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def words_to_limbs(words: torch.Tensor) -> Point:
    """``[4, 8, n]`` int32 words -> four ``[20, n]`` int32 limb tensors in
    [0, 2^13), the same values."""
    lim = limbs_of_words(words.movedim(1, -1))  # [4, n, 20]
    return tuple(lim[c].t().contiguous() for c in range(4))


def limbs_to_words(p: Point) -> torch.Tensor:
    """Four ``[20, n]`` limb tensors (any loose form) -> ``[4, 8, n]`` int32
    words of their canonical values."""
    lim = torch.stack([limbs.canonical(c).t() for c in p])  # [4, n, 20]
    return words_of_limbs(lim).movedim(-1, 1).contiguous()


# ---------------------------------------------------------------------------
# the plain version and the wrapper
# ---------------------------------------------------------------------------

def _check_wire(wire: torch.Tensor) -> int:
    if wire.dtype != torch.uint8 or wire.ndim != 2 or wire.shape[1] != 32:
        raise ValueError(f"ristretto_decode: wires must be [n, 32] uint8, "
                         f"got {tuple(wire.shape)} {wire.dtype}")
    if wire.shape[0] < 1:
        raise ValueError("ristretto_decode needs at least one wire")
    return wire.shape[0]


def ristretto_decode_plain(wire: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`.curve.decode` in the kernel's layout: ``[n, 32]`` uint8 ->
    (``[4, 8, n]`` int32 canonical words, ``[n]`` uint8 validity)."""
    _check_wire(wire)
    point, valid = curve.decode(wire.t().to(torch.int32))
    return limbs_to_words(point), valid.to(torch.uint8)


def ristretto_decode(wire: torch.Tensor, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """RFC 9496 DECODE of ``[n, 32]`` uint8 wires on ``device`` (``None``:
    ``cuda:0``, raising without CUDA; ``"cpu"``: the plain version) ->
    (``[4, 8, n]`` int32 canonical words, ``[n]`` uint8 validity)."""
    device = resolve_device("ristretto_decode", device)
    n = _check_wire(wire)
    wire = wire.to(device)
    if not on_card("ristretto_decode", wire.device):
        return ristretto_decode_plain(wire)
    wire = wire.contiguous()
    if wire.data_ptr() % 16:
        raise ValueError("ristretto_decode: the wires must start 16-byte aligned")
    words = torch.empty((4, 8, n), dtype=torch.int32, device=wire.device)
    valid = torch.empty((n,), dtype=torch.uint8, device=wire.device)
    lib = library()
    with torch.cuda.device(wire.device):
        stream = torch.cuda.current_stream(wire.device).cuda_stream
        rc = lib.cpzk_ristretto_decode(wire.data_ptr(), n, words.data_ptr(),
                                       valid.data_ptr(), stream)
    _check(rc, "ristretto_decode")
    count_launch(LAUNCHES, "ristretto_decode")
    return words, valid
