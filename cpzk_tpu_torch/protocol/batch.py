"""Batch verification — re-designed from reference ``src/verifier/batch.rs``.

API parity: ``BatchVerifier`` accumulates up to ``max_size`` entries of
(params, statement, proof, context), validating statements on ``add``
(batch.rs:139-168); ``verify`` returns per-proof results, short-circuiting a
single-entry batch to individual verification (batch.rs:171-183) and falling
back to per-proof verification when the combined check fails
(batch.rs:314-318) — so the *accept set* is always per-proof ground truth.

Math fix (normative deviation from the reference): its combined equation
drops the random coefficient on the ``y^c`` term (batch.rs:297-299).  This
package implements the correct random-linear-combination check

    Σ αᵢ·(sᵢ·G − r1ᵢ − cᵢ·y1ᵢ)  +  β·Σ αᵢ·(sᵢ·H − r2ᵢ − cᵢ·y2ᵢ)  ==  O

with per-entry random αᵢ and one extra random weight β merging the two
equations (soundness: Schwartz-Zippel over ℓ; per-equation failure
probability ≤ 2/ℓ).  α and β come from the caller's host CSPRNG, never from
a device generator.

The heavy lifting is delegated to a pluggable ``VerifierBackend``: the GPU
backend in :mod:`cpzk_tpu_torch.ops.backend` (default; it raises without
CUDA) or ``CpuBackend``, the host core's row verifier, when the caller
passes it.  ``FailoverBackend`` wraps a primary and a fallback behind a
circuit breaker (the serving plane's card-to-host failover).

Deferred-parse proofs (:meth:`Proof.from_bytes_batch` with
``defer_point_validation=True``) settle their postponed commitment decodes
here: a backend that reports decode failures tri-state
(``supports_deferred_decode``, row status 2) does so in its per-row pass;
otherwise, and always for n == 1 or a backend that prefers the combined
check, they are screened first by one native deep parse, and the
undecodable rows never reach the backend.  Either way an undecodable wire
gets the eager parse's exact error.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

from ..errors import Error, InvalidGroupElement, InvalidParams, InvalidProofEncoding
from ..core import _native, edwards
from ..core.ristretto import BAD_POINT, Element, Ristretto255, Scalar
from ..core.rng import SecureRng
from ..core.scalars import L, sc_mul
from ..core.transcript import Transcript, derive_challenges_batch
from ..observability.tracing import get_tracer
from ..resilience.breaker import (
    ROUTE_PRIMARY,
    ROUTE_PROBE,
    BreakerState,
    CircuitBreaker,
)
from ..server import metrics
from .gadgets import Parameters, Proof, Statement
from .verifier import Verifier

MAX_BATCH_SIZE = 1000

log = logging.getLogger("cpzk_tpu_torch.protocol.batch")


class _NullStages:
    """Inert stage recorder: ``BatchVerifier.verify`` always runs under a
    stage scope, instrumented or not (the real recorder is
    :class:`cpzk_tpu_torch.observability.BatchStages`)."""

    def stage(self, name: str):
        del name
        return contextlib.nullcontext()


_NULL_STAGES = _NullStages()


@dataclass
class BatchEntry:
    params: Parameters
    statement: Statement
    proof: Proof
    transcript_context: bytes | None
    #: absolute ``time.monotonic()`` point after which nobody is waiting for
    #: this entry's result (the request deadline, threaded through the
    #: serving layer); ``None`` = wait forever.  The dynamic batcher sheds
    #: expired entries before device dispatch instead of verifying them.
    deadline: float | None = None
    #: trace id of the request that queued this entry; the batcher fans
    #: per-stage spans out to every member trace.
    trace_id: str | None = None
    #: ``time.monotonic()`` at enqueue, stamped by the batcher — the
    #: ``queue_wait`` span/histogram measures from here to dispatch.
    enqueued_at: float | None = None


@dataclass
class BatchRow:
    """Flattened, challenge-resolved entry handed to a backend."""

    g: Element
    h: Element
    y1: Element
    y2: Element
    r1: Element
    r2: Element
    s: Scalar
    c: Scalar
    alpha: Scalar


@dataclass
class PreparedBatch:
    """Host-phase output of :meth:`BatchVerifier.prepare_batch` — the
    challenge-resolved rows (or the n == 1 verifier, or the deferred-parse
    splice plan) ready for backend dispatch via
    :meth:`BatchVerifier.run_prepared`.  Built on one thread, consumable on
    another: nothing here touches the backend or the RNG."""

    n: int
    # n == 1 individual-verification path
    entry: BatchEntry | None = None
    verifier: Verifier | None = None
    transcript: Transcript | None = None
    # n >= 2 batch path
    rows: list[BatchRow] | None = None
    beta: Scalar | None = None
    same_generators: bool = True
    # deferred-parse splice path: undecodable wires mapped to their parse
    # errors; the survivors prepared as a sub-batch
    pre_errors: dict[int, Error] | None = None
    sub: "BatchVerifier | None" = None
    sub_prepared: "PreparedBatch | None" = field(default=None, repr=False)


class VerifierBackend:
    """Backend interface for the batch-verification compute plane.

    Thread-safety contract: callers may run ``verify_combined`` /
    ``verify_each`` for different batches concurrently from worker
    threads.  Implementations keep per-call state on the stack and guard
    any shared caches (see ``TorchBackend._gh``)."""

    #: Whether the combined RLC fast path is actually faster than per-proof
    #: checks on this backend. False for the scalar CPU oracle; True for
    #: vectorized backends where the combined check amortizes.
    prefers_combined: bool = True

    #: Whether ``verify_each`` reports a deferred-parse proof's commitment
    #: decode failure as row status 2.  When False, ``BatchVerifier``
    #: screens deferred proofs before involving the backend, so the backend
    #: never sees an undecodable wire.
    supports_deferred_decode: bool = False

    def verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        """Corrected-RLC combined check; True iff the whole batch passes."""
        raise NotImplementedError

    def verify_each(self, rows: list[BatchRow]) -> list[int]:
        """Per-proof ground-truth checks (the accept-set decider).  Per-row
        status: 1/True pass, 0/False fail, 2 commitment wire failed to
        decode (deferred-parse rows only)."""
        raise NotImplementedError


class CpuBackend(VerifierBackend):
    """Host-plane backend: per-row checks on the host core's threaded row
    verifier (the ground truth the GPU backend is held against), and a
    pure-Python combined check."""

    prefers_combined = False
    supports_deferred_decode = True  # native rows report status 2

    def verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        acc = edwards.IDENTITY
        sum_as = 0  # Σ αᵢ·sᵢ mod ℓ
        for row in rows:
            a = row.alpha.value
            ac = sc_mul(a, row.c.value)
            sum_as = (sum_as + a * row.s.value) % L
            # subtract αᵢ·r1ᵢ + (αᵢcᵢ)·y1ᵢ + β·(αᵢ·r2ᵢ + (αᵢcᵢ)·y2ᵢ)
            term = edwards.pt_add(
                edwards.pt_scalar_mul(row.r1.point, a),
                edwards.pt_scalar_mul(row.y1.point, ac),
            )
            term2 = edwards.pt_add(
                edwards.pt_scalar_mul(row.r2.point, sc_mul(a, beta.value)),
                edwards.pt_scalar_mul(row.y2.point, sc_mul(ac, beta.value)),
            )
            acc = edwards.pt_add(acc, edwards.pt_add(term, term2))
        # add (Σαs)·G + β(Σαs)·H — valid only when all rows share generators;
        # BatchVerifier only takes this path in that case
        g = rows[0].g.point
        h = rows[0].h.point
        lhs = edwards.pt_add(
            edwards.pt_scalar_mul(g, sum_as),
            edwards.pt_scalar_mul(h, sc_mul(sum_as, beta.value)),
        )
        return edwards.pt_eq(lhs, acc)

    def verify_each(self, rows: list[BatchRow]) -> list[int]:
        """Per-row statuses from the host core, one native call per
        generator pair (in the order the pairs first appear)."""
        eb = Ristretto255.element_to_bytes
        sb = Ristretto255.scalar_to_bytes
        groups: dict[tuple[bytes, bytes], list[int]] = {}
        for i, row in enumerate(rows):
            groups.setdefault((eb(row.g), eb(row.h)), []).append(i)
        out = [0] * len(rows)
        for (g, h), idx in groups.items():
            part = [rows[i] for i in idx]
            statuses = _native.verify_rows(
                g, h,
                b"".join(eb(r.y1) for r in part),
                b"".join(eb(r.y2) for r in part),
                b"".join(eb(r.r1) for r in part),
                b"".join(eb(r.r2) for r in part),
                b"".join(sb(r.s) for r in part),
                b"".join(sb(r.c) for r in part),
            )
            for i, status in zip(idx, statuses, strict=True):
                out[i] = status
        return out

    @staticmethod
    def verify_each_pure(rows: list[BatchRow]) -> list[int]:
        """Pure-Python twin of :meth:`verify_each` (the tests' oracle)."""
        out: list[int] = []
        for row in rows:
            try:
                r1p, r2p = row.r1.point, row.r2.point
            except InvalidGroupElement:
                out.append(2)  # deferred-parse wire that does not decode
                continue
            lhs1 = edwards.pt_scalar_mul(row.g.point, row.s.value)
            rhs1 = edwards.pt_add(r1p, edwards.pt_scalar_mul(row.y1.point, row.c.value))
            lhs2 = edwards.pt_scalar_mul(row.h.point, row.s.value)
            rhs2 = edwards.pt_add(r2p, edwards.pt_scalar_mul(row.y2.point, row.c.value))
            out.append(int(edwards.pt_eq(lhs1, rhs1) and edwards.pt_eq(lhs2, rhs2)))
        return out


class FailoverBackend(VerifierBackend):
    """Self-healing primary→fallback failover wrapper (the reference's
    ``FailoverBackend``, ``cpzk_tpu/protocol/batch.py``).

    Routes to ``primary`` until it raises, then degrades to ``fallback``
    — a failed combined check simply reports False so the dispatcher's
    per-proof path decides, keeping accept/reject semantics identical
    through a mid-batch backend loss.  Degradation heals: after
    ``recovery_after_s`` the breaker grants a single *probe* — one batch
    is verified on BOTH planes, the fallback result stays authoritative,
    and the primary is re-armed only when its answers match ground truth
    exactly (a device that comes back *wrong* never regains traffic).
    ``recovery_after_s=None`` keeps it degraded until :meth:`reset`.

    Observability: ``tpu.backend.failover`` counts CLOSED→OPEN trips,
    ``tpu.backend.state`` gauges the breaker (0 closed / 1 open / 2
    half-open), ``tpu.backend.degraded_seconds`` accumulates fallback-only
    wall time, and each transition logs WARNING exactly once and lands in
    the trace ring as a ``breaker_transition`` event.
    """

    def __init__(
        self,
        primary: VerifierBackend,
        fallback: VerifierBackend,
        recovery_after_s: float | None = 30.0,
        probe_batch_max: int = 64,
        clock=None,
    ):
        if probe_batch_max < 1:
            raise InvalidParams("probe_batch_max must be positive")
        self.primary = primary
        self.fallback = fallback
        self.probe_batch_max = probe_batch_max
        self.breaker = CircuitBreaker(
            recovery_after_s=recovery_after_s,
            clock=clock or time.monotonic,
            on_transition=self._on_transition,
        )

    @property
    def degraded(self) -> bool:
        """True while traffic is (at least partly) on the fallback."""
        return self.breaker.state is not BreakerState.CLOSED

    @property
    def state(self) -> BreakerState:
        """Breaker state, for status lines."""
        return self.breaker.state

    @property
    def prefers_combined(self) -> bool:  # type: ignore[override]
        backend = self.fallback if self.degraded else self.primary
        return backend.prefers_combined

    def reset(self) -> None:
        """Operator re-arm (bypasses the probe — trust the fix)."""
        self.breaker.reset()

    # -- transitions / observability --------------------------------------

    def _on_transition(self, old: BreakerState, new: BreakerState) -> None:
        if new is BreakerState.OPEN and old is BreakerState.CLOSED:
            log.warning(
                "primary verifier backend failed; degrading to fallback "
                "(probe retry in %ss)", self.breaker.recovery_after_s,
            )
        elif new is BreakerState.OPEN:
            log.warning(
                "primary verifier probe failed or disagreed with fallback "
                "ground truth; staying degraded (next probe in %ss)",
                self.breaker.recovery_after_s,
            )
        elif new is BreakerState.HALF_OPEN:
            log.info("probing primary verifier backend with one batch")
        else:  # -> CLOSED
            log.warning(
                "primary verifier backend recovered after %.1fs degraded; "
                "traffic back on primary", self.breaker.degraded_seconds,
            )
        if new is BreakerState.OPEN and old is BreakerState.CLOSED:
            metrics.counter("tpu.backend.failover").inc()
        metrics.gauge("tpu.backend.state").set(
            {"closed": 0, "open": 1, "half-open": 2}[new.value]
        )
        # the transition lands in the trace ring buffer, so degraded periods
        # share the /tracez timeline with the requests they hit
        get_tracer().record_event(
            "breaker_transition", old=old.value, new=new.value,
        )

    def _touch_degraded_gauge(self) -> None:
        metrics.gauge("tpu.backend.degraded_seconds").set(
            self.breaker.degraded_seconds
        )

    def _note_failure(self, exc: Exception) -> None:
        # pipelined dispatches call backends from multiple threads; the
        # breaker hands the CLOSED->OPEN transition to exactly one of them
        # (the device exception itself is worth one traceback, not one per
        # batch)
        if self.breaker.record_failure():
            log.warning("primary verifier backend raised", exc_info=exc)

    # -- verification routing ----------------------------------------------

    def verify_combined(self, rows: list[BatchRow], beta: Scalar) -> bool:
        self._touch_degraded_gauge()
        route = self.breaker.acquire()
        if route == ROUTE_PRIMARY:
            try:
                return self.primary.verify_combined(rows, beta)
            except Exception as exc:
                self._note_failure(exc)
        elif route == ROUTE_PROBE:
            # a combined check has no per-row ground truth to compare the
            # probe against; hand the token back so the dispatcher's
            # verify_each pass (or the next batch) runs the real probe
            self.breaker.release_probe()
        # a False combined check routes the dispatcher to verify_each,
        # which is the ground-truth path on the fallback backend
        if self.fallback.prefers_combined:
            return self.fallback.verify_combined(rows, beta)
        return False

    def verify_each(self, rows: list[BatchRow]) -> list[int]:
        self._touch_degraded_gauge()
        route = self.breaker.acquire()
        if route == ROUTE_PRIMARY:
            try:
                return self.primary.verify_each(rows)
            except Exception as exc:
                self._note_failure(exc)
            return self.fallback.verify_each(rows)
        if route == ROUTE_PROBE:
            return self._probe_each(rows)
        return self.fallback.verify_each(rows)

    def _probe_each(self, rows: list[BatchRow]) -> list[int]:
        """Half-open probe: the fallback verifies the whole batch (its
        result is returned — authoritative no matter what the primary
        says); the primary re-verifies the first ``probe_batch_max`` rows
        and must reproduce ground truth exactly to re-close the breaker."""
        truth = self.fallback.verify_each(rows)
        n = min(len(rows), self.probe_batch_max)
        if n == 0:
            self.breaker.release_probe()
            return truth
        try:
            probe = self.primary.verify_each(rows[:n])
            agreed = [int(v) for v in probe] == [int(v) for v in truth[:n]]
        except Exception as exc:
            log.warning("primary verifier probe raised: %s", exc)
            agreed = False
        if agreed:
            self.breaker.probe_succeeded()
        else:
            self.breaker.probe_failed()
        self._touch_degraded_gauge()
        return truth


_DEFAULT_BACKEND: VerifierBackend | None = None


def default_backend() -> VerifierBackend:
    """Process-wide default backend: the one set by
    :func:`set_default_backend`, else ``TorchBackend()`` on the card (made
    once; it raises without CUDA).  The host oracle is never a silent
    default."""
    global _DEFAULT_BACKEND
    if _DEFAULT_BACKEND is None:
        from ..ops.backend import TorchBackend  # ops imports this module

        _DEFAULT_BACKEND = TorchBackend()
    return _DEFAULT_BACKEND


def set_default_backend(backend: VerifierBackend | None) -> None:
    global _DEFAULT_BACKEND
    _DEFAULT_BACKEND = backend


class BatchVerifier:
    """Accumulate-and-verify batch API (reference ``BatchVerifier`` twin).

    ``max_size`` defaults to the reference's 1000-entry cap but is
    configurable up to device scale.  ``backend=None`` means
    :func:`default_backend`: ``TorchBackend()`` on the card, which raises
    without CUDA, unless another default was set; the host oracle runs
    only when passed (``backend=CpuBackend()``)."""

    def __init__(
        self,
        backend: VerifierBackend | None = None,
        max_size: int = MAX_BATCH_SIZE,
    ):
        if max_size < 1:
            raise InvalidParams("Batch capacity must be positive")
        self.entries: list[BatchEntry] = []
        self.max_size = max_size
        self.backend = backend if backend is not None else default_backend()

    @staticmethod
    def with_capacity(capacity: int, backend: VerifierBackend | None = None) -> "BatchVerifier":
        """Capacity is clamped to MAX_BATCH_SIZE (batch.rs:107-117); Python
        lists need no preallocation, so this is a naming-parity constructor
        (``cpzk_tpu/protocol/batch.py:461-467``)."""
        if capacity < 0:
            raise InvalidParams("Capacity cannot be negative")
        return BatchVerifier(backend)

    def __len__(self) -> int:
        return len(self.entries)

    def is_empty(self) -> bool:
        return not self.entries

    def remaining_capacity(self) -> int:
        return max(0, self.max_size - len(self.entries))

    def clear(self) -> None:
        """Empty the batch for reuse (reference BatchVerifier::clear)."""
        self.entries.clear()

    def add(self, params: Parameters, statement: Statement, proof: Proof) -> None:
        self.add_with_context(params, statement, proof, None)

    def add_with_context(
        self,
        params: Parameters,
        statement: Statement,
        proof: Proof,
        context: bytes | None,
    ) -> None:
        """Validates the statement on add (batch.rs:139-168)."""
        if len(self.entries) >= self.max_size:
            raise InvalidParams(f"Batch size limit exceeded (max {self.max_size})")
        statement.validate()
        self.entries.append(BatchEntry(params, statement, proof, context))

    # --- verification ---

    def prepare_rows(self, rng: SecureRng) -> list[BatchRow]:
        """Derive the backend-facing rows: per-entry Fiat-Shamir challenge
        plus a fresh random RLC weight alpha per row."""
        eb = Ristretto255.element_to_bytes
        challenges = derive_challenges_batch(
            [e.transcript_context for e in self.entries],
            [eb(e.params.generator_g) for e in self.entries],
            [eb(e.params.generator_h) for e in self.entries],
            [eb(e.statement.y1) for e in self.entries],
            [eb(e.statement.y2) for e in self.entries],
            [eb(e.proof.commitment.r1) for e in self.entries],
            [eb(e.proof.commitment.r2) for e in self.entries],
        )
        # RLC coefficients from one pooled CSPRNG draw
        alphas = Ristretto255.random_scalars(rng, len(self.entries))
        return [
            BatchRow(
                g=entry.params.generator_g,
                h=entry.params.generator_h,
                y1=entry.statement.y1,
                y2=entry.statement.y2,
                r1=entry.proof.commitment.r1,
                r2=entry.proof.commitment.r2,
                s=entry.proof.response.s,
                c=c,
                alpha=alpha,
            )
            for entry, c, alpha in zip(self.entries, challenges, alphas, strict=True)
        ]

    def verify(self, rng: SecureRng, stages=None) -> list[Error | None]:
        """Verify all entries; per-entry ``None`` (ok) or ``Error``.

        Mirrors batch.rs:171-183: an empty batch is an error; n == 1
        verifies individually; otherwise the combined check decides the
        fast path and failure falls back to per-proof results.  Composes
        :meth:`prepare_batch` (host phase) with :meth:`run_prepared`
        (device phase).

        ``stages`` is an optional stage recorder (duck-typed like
        :class:`cpzk_tpu_torch.observability.BatchStages`): host prep is
        timed under ``pad_and_pack``, the backend call(s) under
        ``device_dispatch``, and result assembly under ``unpack``."""
        st = stages if stages is not None else _NULL_STAGES
        return self.run_prepared(self.prepare_batch(rng, st), st)

    def prepare_batch(self, rng: SecureRng, stages=None) -> PreparedBatch:
        """Host phase: deferred-parse screening, Fiat-Shamir challenge
        derivation, RLC coefficient draws, and (n == 1) verifier/transcript
        construction — everything that does not touch the backend.  One
        ``pad_and_pack`` stage covers all of it."""
        if not self.entries:
            raise InvalidParams("Cannot verify empty batch")
        st = stages if stages is not None else _NULL_STAGES
        with st.stage("pad_and_pack"):
            return self._prepare(rng)

    def _prepare(self, rng: SecureRng) -> PreparedBatch:
        n = len(self.entries)
        backend = self.backend
        g0 = self.entries[0].params.generator_g
        h0 = self.entries[0].params.generator_h
        same_generators = all(
            e.params.generator_g == g0 and e.params.generator_h == h0
            for e in self.entries
        )
        if any(e.proof.deferred for e in self.entries) and (
            n == 1
            or not same_generators
            or not backend.supports_deferred_decode
            or backend.prefers_combined
        ):
            pre_errors = self._screen_deferred()
            if pre_errors:
                # keep undecodable wires away from the backend: prepare the
                # survivors as their own batch; run_prepared splices the
                # results around the errors
                sub = BatchVerifier(backend=backend, max_size=self.max_size)
                sub.entries = [e for i, e in enumerate(self.entries)
                               if i not in pre_errors]
                return PreparedBatch(
                    n=n, pre_errors=pre_errors, sub=sub,
                    sub_prepared=sub.prepare_batch(rng) if sub.entries else None,
                )
        if n == 1:
            entry = self.entries[0]
            transcript = Transcript()
            if entry.transcript_context is not None:
                transcript.append_context(entry.transcript_context)
            return PreparedBatch(
                n=1, entry=entry, verifier=Verifier(entry.params, entry.statement),
                transcript=transcript,
            )
        rows = self.prepare_rows(rng)
        beta = Ristretto255.random_scalar(rng)
        return PreparedBatch(
            n=n, rows=rows, beta=beta, same_generators=same_generators,
        )

    def run_prepared(
        self, prepared: PreparedBatch, stages=None
    ) -> list[Error | None]:
        """Device phase: backend dispatch (``device_dispatch`` stage) and
        result assembly (``unpack``) for a :meth:`prepare_batch` output."""
        st = stages if stages is not None else _NULL_STAGES
        if prepared.pre_errors is not None:
            # the sub-batch's device phase records into THIS batch's stage
            # recorder, so the splice path keeps the full decomposition
            sub_results = (
                prepared.sub.run_prepared(prepared.sub_prepared, st)
                if prepared.sub_prepared is not None else []
            )
            survivors = iter(sub_results)
            return [
                prepared.pre_errors[i] if i in prepared.pre_errors else next(survivors)
                for i in range(prepared.n)
            ]
        if prepared.n == 1:
            with st.stage("device_dispatch"):
                try:
                    prepared.verifier.verify_with_transcript(
                        prepared.entry.proof, prepared.transcript)
                    result: Error | None = None
                except Error as exc:
                    result = exc
            with st.stage("unpack"):
                return [result]

        backend = self.backend
        rows, beta = prepared.rows, prepared.beta
        with st.stage("device_dispatch"):
            if (
                prepared.same_generators
                and backend.prefers_combined
                and backend.verify_combined(rows, beta)
            ):
                statuses = None
            else:
                # Fallback: per-proof ground truth (batch.rs:314-318)
                statuses = backend.verify_each(rows)
        with st.stage("unpack"):
            if statuses is None:
                return [None] * len(rows)
            results: list[Error | None] = []
            for status in statuses:
                if status == 2:  # deferred commitment wire failed to decode
                    results.append(InvalidProofEncoding(BAD_POINT))
                elif status:
                    results.append(None)
                else:
                    results.append(InvalidParams("Proof verification failed"))
            return results

    def _screen_deferred(self) -> dict[int, Error]:
        """Settle deferred proofs' postponed point decodes with one native
        deep parse over just the deferred wires.  Survivors are promoted to
        fully validated (``deferred`` cleared, elements marked canonical);
        failures map to the eager parse's exact error."""
        idxs = [i for i, e in enumerate(self.entries) if e.proof.deferred]
        if not idxs:
            return {}
        flags = _native.parse_proofs(
            b"".join(self.entries[i].proof.to_bytes() for i in idxs))
        out: dict[int, Error] = {}
        for i, ok in zip(idxs, flags, strict=True):
            proof = self.entries[i].proof
            if ok:
                proof.deferred = False
                proof.commitment.r1._validated = True
                proof.commitment.r2._validated = True
            else:
                out[i] = InvalidProofEncoding(BAD_POINT)
        return out
