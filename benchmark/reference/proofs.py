"""Statements, commitments and proof wires made from the seed, and the
verdicts they must get.

A population is n users, each with a witness x and one commitment nonce k
drawn from the seed: the statement (x G, x H) and the commitment (k G, k H)
are computed on the card by :mod:`.vecfield`.  A proof for a transcript
context is then s = k + c x with c the Fiat-Shamir challenge of
:mod:`.merlin` over the context, the generators, the statement and the
commitment; a tampered proof carries s + 1.  The 109-byte wire is the
protocol's: version 1, then r1, r2 and s, each behind a 4-byte big-endian
length.

Since the generators have prime order l, s G = r1 + c y1 and s H = r2 + c y2
hold exactly when s = k + c x mod l: the verdict of a row the benchmark made
is known from its scalars.  :func:`verify_wires` checks rows by the group
equations themselves, from nothing but their wires, with :mod:`.group`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import group, merlin

WIRE = 109
G_BYTES = group.encode(group.G)
H_BYTES = group.encode(group.H)
#: the verdict of a row whose proof fails its equations, as the protocol
#: names it (error type, message)
FAILED = ("InvalidParams", "Proof verification failed")


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for each use of the seed."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, *stream]))


def scalars(rng: np.random.Generator, n: int) -> list[int]:
    """n uniform non-zero scalars mod l (64 bytes each, reduced)."""
    raw = rng.bytes(64 * n)
    out = [int.from_bytes(raw[64 * i:64 * i + 64], "little") % group.L for i in range(n)]
    return [v or 1 for v in out]


def _bytes_rows(arr: np.ndarray) -> list[bytes]:
    raw = arr.tobytes()
    w = arr.shape[1]
    return [raw[w * i:w * (i + 1)] for i in range(arr.shape[0])]


@dataclass
class Population:
    x: list[int]
    k: list[int]
    #: (n, 32) uint8 wires of y1, y2, r1, r2 on the host and on ``device``
    wires: dict
    device_wires: dict
    device: object

    @property
    def n(self) -> int:
        return len(self.x)


def population(seed: int, n: int, device) -> Population:
    """n users from the seed, their points made on ``device``."""
    import torch

    from .vecfield import FixedBase

    rng = rng_for(seed, 0)
    x = scalars(rng, n)
    k = scalars(rng, n)
    fb = FixedBase([group.G, group.H], device)
    enc = fb.mul_encode(x + x + k + k, [0] * n + [1] * n + [0] * n + [1] * n)
    names = ("y1", "y2", "r1", "r2")
    dev = {name: enc[i * n:(i + 1) * n].contiguous() for i, name in enumerate(names)}
    host = {name: t.cpu().numpy() for name, t in dev.items()}
    del fb, enc
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return Population(x=x, k=k, wires=host, device_wires=dev, device=device)


def challenges(pop: Population, contexts: np.ndarray | None, start=None):
    """The challenge of each row for ``contexts`` ((n, len) uint8, or None
    for no context), on the population's device."""
    import torch

    dev = pop.device_wires
    start = start or merlin.protocol_start(pop.device)
    ctx = None if contexts is None else torch.from_numpy(np.array(contexts)).to(pop.device)
    wide = merlin.challenge_wide(start, ctx, G_BYTES, H_BYTES,
                                 dev["y1"], dev["y2"], dev["r1"], dev["r2"])
    return merlin.reduce_wide(wide)


def responses(pop: Population, c: list[int], tampered) -> list[int]:
    """s = k + c x mod l of each row (s + 1 where ``tampered``)."""
    return [(pop.k[i] + c[i] * pop.x[i] + (1 if tampered[i] else 0)) % group.L
            for i in range(pop.n)]


def wires(pop: Population, s: list[int]) -> np.ndarray:
    """(n, 109) uint8 proof wires of the rows with responses ``s``."""
    n = len(s)
    out = np.empty((n, WIRE), dtype=np.uint8)
    length = np.frombuffer((32).to_bytes(4, "big"), dtype=np.uint8)
    out[:, 0] = 1
    out[:, 1:5] = length
    out[:, 5:37] = pop.wires["r1"]
    out[:, 37:41] = length
    out[:, 41:73] = pop.wires["r2"]
    out[:, 73:77] = length
    out[:, 77:109] = np.frombuffer(
        b"".join(v.to_bytes(32, "little") for v in s), dtype=np.uint8).reshape(n, 32)
    return out


@dataclass
class Batch:
    """One batch of proofs over the whole population."""

    items: list[bytes]           # proof wires
    contexts: list[bytes]        # transcript contexts
    expected: list               # None or an (error type, message) a row


def make_batch(pop: Population, seed: int, index: int, context_bytes: int,
               tampered_share: float = 0.0, start=None, tampered_rows=()) -> Batch:
    """Batch ``index`` of the run: fresh contexts and responses for every
    user, ``tampered_share`` of them tampered, and the rows
    ``tampered_rows`` besides."""
    rng = rng_for(seed, 1, index)
    ctx = np.frombuffer(rng.bytes(context_bytes * pop.n), dtype=np.uint8).reshape(pop.n, context_bytes)
    tampered = rng.random(pop.n) < tampered_share
    tampered[list(tampered_rows)] = True
    c = challenges(pop, ctx, start=start)
    s = responses(pop, c, tampered)
    return Batch(
        items=_bytes_rows(wires(pop, s)),
        contexts=_bytes_rows(ctx),
        expected=[FAILED if t else None for t in tampered],
    )


def statement_items(pop: Population) -> tuple[list[bytes], list[bytes]]:
    return _bytes_rows(pop.wires["y1"]), _bytes_rows(pop.wires["y2"])


def parse_wire(wire: bytes):
    """(r1, r2, s) of a well-formed 109-byte wire, else None."""
    if len(wire) != WIRE or wire[0] != 1:
        return None
    if any(wire[o:o + 4] != b"\x00\x00\x00\x20" for o in (1, 37, 73)):
        return None
    s = int.from_bytes(wire[77:109], "little")
    if s >= group.L or s == 0:
        return None
    return wire[5:37], wire[41:73], s


def verify_wires(rows) -> list[bool]:
    """Each row (context, y1, y2, proof wire) by the group equations, the
    challenge derived here from the wires (numpy transcript)."""
    rows = list(rows)
    if not rows:
        return []
    parsed = [parse_wire(w) for _, _, _, w in rows]
    start = merlin.protocol_start("numpy")
    out = [False] * len(rows)
    for clen in {len(ctx) for ctx, _, _, _ in rows}:
        idx = [i for i, (ctx, _, _, _) in enumerate(rows)
               if len(ctx) == clen and parsed[i] is not None]
        if not idx:
            continue
        arr = lambda vals: np.frombuffer(b"".join(vals), dtype=np.uint8).reshape(len(idx), -1)
        wide = merlin.challenge_wide(
            start, arr([rows[i][0] for i in idx]), G_BYTES, H_BYTES,
            arr([rows[i][1] for i in idx]), arr([rows[i][2] for i in idx]),
            arr([parsed[i][0] for i in idx]), arr([parsed[i][1] for i in idx]))
        for i, c in zip(idx, merlin.reduce_wide(wide)):
            r1, r2, s = parsed[i]
            out[i] = group.verify_row(rows[i][1], rows[i][2], r1, r2, s, c)
    return out
