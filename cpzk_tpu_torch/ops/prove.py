"""Batch proof generation on the card (the reference's BASELINE config 3;
reference analog ``src/prover/mod.rs:115-131`` scaled to device batches).

Port of ``cpzk_tpu/ops/prove.py``.  Commitments (R1, R2) = (k·G, k·H) and
statements (Y1, Y2) = (x·G, x·H) are *fixed-base* scalar multiplications,
so the prover uses a comb method: for each generator, per-window tables
T_w[j] = j·16^w·P (64 windows x 16 entries, built once on the card by the
``comb_tables`` kernel), then each point is 64 table selects and adds per
lane, and no doublings.  The walk and the Ristretto encoding run in one
hand-written kernel (``commitments``, :mod:`.prove_kernels`); the host only
draws nonces, derives the Fiat-Shamir challenges (host core) and closes the
responses s = k + c·x mod l.

SECURITY (docs/security.md, SURVEY.md §7 hard part 5): batch proving places
secrets (k, x) in device HBM as public-layout digit arrays.  Device memory
cannot be meaningfully zeroized and XLA may checkpoint buffers — this path
trusts the whole accelerator host and is OPT-IN for bulk workloads
(test-corpus generation, load benches, migration tooling).  Interactive
single-user proving belongs on the host path (``protocol.Prover``).

(The same holds for the card: its memory is not zeroized, and nothing in
the daemon or the serving plane calls this path.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.ristretto import Ristretto255, Scalar
from ..core.rng import SecureRng
from ..core.scalars import L
from ..core.transcript import derive_challenges_batch
from ..protocol.gadgets import PROTOCOL_VERSION, Parameters, frame_fields
from . import curve, point_kernels, prove_kernels


def _windows_lsb(values: list[int]) -> np.ndarray:
    """[64, n] int32 4-bit windows, least significant window first (comb
    order)."""
    return np.ascontiguousarray(curve.scalars_to_windows(values)[::-1])


def _columns(b: torch.Tensor, n: int) -> list[bytes]:
    """[32, pad] byte values -> the first n columns as 32-byte strings."""
    rows = np.ascontiguousarray(b.cpu().numpy().astype(np.uint8)[:, :n].T)
    blob = rows.tobytes()
    return [blob[32 * i: 32 * i + 32] for i in range(n)]


class BatchProver:
    """Bulk proof generation on the card.

    >>> bp = BatchProver(Parameters.new())
    >>> statements, proofs = bp.prove(witnesses, contexts, rng)

    Returns per-proof ((y1_bytes, y2_bytes), proof_wire_bytes); the wire
    bytes parse under ``Proof.from_bytes`` and verify with the standard
    ``Verifier`` (``tests/test_torch_prove.py``).  ``device=None`` runs on
    ``cuda:0`` (raising without CUDA), ``device="cpu"`` on the kernels'
    plain PyTorch versions; ``mesh_devices`` shards over several devices
    (:mod:`cpzk_tpu_torch.parallel.mesh`).
    """

    def __init__(self, params: Parameters | None = None,
                 mesh_devices: int | None = None, device=None, devices=None):
        """``mesh_devices``: ``None`` pins one device; ``0`` shards the
        digit batch over every device of the pool, ``k > 1`` over its first
        k (pure data parallelism: proofs are independent).  The pool is
        ``devices`` when given (an explicit list that may repeat a device),
        else the local CUDA devices; ``device`` cannot be combined with a
        mesh."""
        if device is not None and mesh_devices is not None:
            raise ValueError(
                "BatchProver(device=...) pins one device; it cannot also "
                "shard over a mesh (mesh_devices must be None)")
        self.params = params or Parameters.new()
        self._sharded = None
        mesh = None
        if mesh_devices is not None:
            from ..parallel.mesh import make_sharded_prove, resolve_mesh_devices

            mesh = resolve_mesh_devices(mesh_devices, devices)
            if mesh is not None:
                device = mesh.first
                self._sharded = make_sharded_prove(mesh)
            elif devices is not None and len(devices):
                device = devices[0]
        self.mesh = mesh
        self.device = point_kernels.resolve_device("BatchProver", device)
        g = curve.points_to_device([self.params.generator_g.point], self.device)
        h = curve.points_to_device([self.params.generator_h.point], self.device)
        self._tg = prove_kernels.comb_tables(g)
        self._th = prove_kernels.comb_tables(h)
        if self._sharded is not None and self.device.type == "cuda":
            # the mesh's slice streams read the tables, in whichever thread
            # proves: finish them here, once
            torch.cuda.current_stream(self.device).synchronize()

    def _fixed_base_bytes(self, scalars: list[int]) -> tuple[list[bytes], list[bytes]]:
        """(P1, P2) wire bytes for (k·G, k·H) per scalar.

        Proofs are lane-independent, so batches past ``LANE_CHUNK`` run as
        ``LANE_CHUNK``-lane tiles and the byte columns concatenate, as in
        the reference; a mesh splits them over its devices.  The card's
        work (the digits' upload, the launches, the bytes' download)
        reports its interval as the verifier backend's does
        (:func:`.backend.device_work`)."""
        from . import backend

        chunk = backend.LANE_CHUNK
        n = len(scalars)
        pad = backend._pad_lanes(n, chunk)
        windows = _windows_lsb(scalars + [0] * (pad - n))
        with backend.device_work(self.device):
            if self._sharded is not None:
                b1, b2 = self._sharded(self._tg, self._th, torch.from_numpy(windows))
                return _columns(b1, n), _columns(b2, n)
            digits = torch.from_numpy(windows).to(self.device)
            if pad > chunk:
                parts = [prove_kernels.commitments(self._tg, self._th, digits[:, lo:hi])
                         for lo, hi in backend._chunk_bounds(pad, chunk)]
                b1 = torch.cat([p[0] for p in parts], dim=-1)
                b2 = torch.cat([p[1] for p in parts], dim=-1)
            else:
                b1, b2 = prove_kernels.commitments(self._tg, self._th, digits)
            b1, b2 = b1.cpu(), b2.cpu()
        return _columns(b1, n), _columns(b2, n)

    def statements(self, witnesses: list[Scalar]) -> list[tuple[bytes, bytes]]:
        """(y1, y2) wire bytes per witness (registration-side bulk helper)."""
        y1s, y2s = self._fixed_base_bytes([w.value for w in witnesses])
        return list(zip(y1s, y2s))

    def prove(
        self,
        witnesses: list[Scalar],
        contexts: list[bytes | None] | None = None,
        rng: SecureRng | None = None,
        statements: list[tuple[bytes, bytes]] | None = None,
    ) -> tuple[list[tuple[bytes, bytes]], list[bytes]]:
        """NIZK proofs for every witness -> (statements, proof wire bytes).

        ``statements`` skips the statement recomputation when the caller
        already holds the registered (y1, y2) bytes.
        """
        rng = rng or SecureRng()
        n = len(witnesses)
        contexts = contexts if contexts is not None else [None] * n
        if len(contexts) != n:
            raise ValueError("contexts length mismatch")
        if statements is not None and len(statements) != n:
            raise ValueError("statements length mismatch")

        xs = [w.value for w in witnesses]
        if statements is None:
            statements = self.statements(witnesses)

        # nonces on the host CSPRNG; commitments on the card
        ks = [Ristretto255.random_scalar(rng).value for _ in range(n)]
        r1s, r2s = self._fixed_base_bytes(ks)

        gb = Ristretto255.element_to_bytes(self.params.generator_g)
        hb = Ristretto255.element_to_bytes(self.params.generator_h)
        challenges = derive_challenges_batch(
            contexts,
            [gb] * n,
            [hb] * n,
            [st[0] for st in statements],
            [st[1] for st in statements],
            r1s,
            r2s,
        )

        proofs = []
        for i in range(n):
            s = (ks[i] + challenges[i].value * xs[i]) % L
            proofs.append(
                frame_fields(
                    PROTOCOL_VERSION, r1s[i], r2s[i], s.to_bytes(32, "little")
                )
            )
        return statements, proofs


__all__ = ["BatchProver"]
