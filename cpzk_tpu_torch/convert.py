"""Carry ``cpzk_tpu`` (JAX) state into this package, and back.

Device state crosses as numpy arrays: a point is four ``[20, n]`` int32
limb arrays (same radix and layout in both packages), windows are
``[64, n]`` int32.  Protocol objects cross as their wire bytes through
this package's own decoders (``Proof.from_bytes``,
``Ristretto255.element_from_bytes``).  Nothing here imports the JAX package:
callers hand over ``np.asarray`` of its arrays, or its objects' bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.ristretto import Ristretto255
from .protocol.gadgets import Parameters, Proof, Statement

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def tensor(arr, device) -> torch.Tensor:
    """An int32 numpy array (limbs, windows, bytes) -> tensor on ``device``
    (required: ``"cuda"`` for the card, ``"cpu"`` for the plain versions)."""
    a = np.ascontiguousarray(np.asarray(arr), dtype=np.int32)
    return torch.from_numpy(a.copy()).to(device)


def point(coords, device) -> Point:
    """Four ``[20, ...]`` limb arrays -> a point of tensors on ``device``."""
    return tuple(tensor(c, device) for c in coords)


def comb_tables(arrays, device) -> tuple[torch.Tensor, ...]:
    """The four ``[64, 16, 20, 1]`` limb arrays of a comb table (``np.asarray``
    of each coordinate of the JAX ``_comb_tables_kernel``'s output) -> the
    port's plain table layout on ``device`` (:mod:`.ops.prove_kernels`;
    ``table_words`` gives the kernel's)."""
    coords = tuple(tensor(a, device) for a in arrays)
    if len(coords) != 4 or any(c.shape != (64, 16, 20, 1) for c in coords):
        raise ValueError("comb_tables: four [64, 16, 20, 1] limb arrays")
    return coords


def to_numpy(x) -> np.ndarray | tuple[np.ndarray, ...]:
    """A tensor, or a tuple of them (a point), -> numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return tuple(c.detach().cpu().numpy() for c in x)


def parameters(g_wire: bytes, h_wire: bytes) -> Parameters:
    """Generator encodings -> validated ``Parameters``."""
    return Parameters.with_generators(
        Ristretto255.element_from_bytes(bytes(g_wire)),
        Ristretto255.element_from_bytes(bytes(h_wire)))


def statement(y1_wire: bytes, y2_wire: bytes) -> Statement:
    """Statement encodings -> a validated ``Statement``."""
    return Statement(Ristretto255.element_from_bytes(bytes(y1_wire)),
                     Ristretto255.element_from_bytes(bytes(y2_wire)))


def proof(wire: bytes) -> Proof:
    return Proof.from_bytes(bytes(wire))
