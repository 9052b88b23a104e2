"""Dedicated device-dispatch lane: one long-lived thread pair that owns
every backend call the serving path makes.

A port of ``cpzk_tpu/server/dispatch.py``.  The batcher hands each batch
to a persistent worker pair instead of paying an ``asyncio.to_thread``
handoff per batch:

- an **MPSC ingress queue** fed by the event loop (``submit``), drained
  FIFO by a persistent host-prep thread — the flight recorder's
  ``thread_hop`` is one condition-variable wakeup on a running thread;
- **double-buffering**: the prep thread runs batch N+1's host phase
  (:meth:`~cpzk_tpu_torch.protocol.batch.BatchVerifier.prepare_batch` —
  deferred screening, Fiat-Shamir challenges, RLC draws) while the device
  thread runs batch N's backend phase
  (:meth:`~cpzk_tpu_torch.protocol.batch.BatchVerifier.run_prepared`),
  through a bounded staging buffer; the staging dwell is recorded as the
  ``device_wait`` stage, and under overlap the dispatch gap clamps toward
  0 because the device thread never waits on host prep;
- results posted back to the submitting event loop via
  ``loop.call_soon_threadsafe`` on a per-batch future — the lane never
  touches asyncio state from its own threads.

Shutdown is drain-then-join: ``stop()`` refuses new work, the prep thread
finishes the ingress backlog, the device thread finishes the staged
backlog, and only then do the threads exit — every accepted future
resolves exactly once.  Backend exceptions are confined to the batch that
raised them: the exception is posted to that batch's future and the lane
threads keep serving (the failover breaker lives INSIDE the backend
wrapper).

``overlap=False`` (config ``tpu.pipeline_depth = 1``) collapses the pair
to a single thread that runs both phases back-to-back — strictly serial
dispatch, still without per-batch thread churn.

Instrumentation, off by default: ``CPZK_XPROF_DIR=<dir>`` captures each
batch's device phase with ``torch.profiler`` into a Chrome trace in that
directory (:func:`~cpzk_tpu_torch.observability.flightrec.start_profile`,
which refuses a second concurrent capture), and ``CPZK_BATCH_DEBUG=1``
prints one stderr line per batch with its device-phase seconds.
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..core.rng import SecureRng
from ..errors import Error
from ..observability import flightrec
from ..protocol.batch import BatchEntry, BatchVerifier, PreparedBatch

log = logging.getLogger("cpzk_tpu_torch.server.dispatch")


class LaneStopped(RuntimeError):
    """The lane is stopping (or never started) and refuses new work; the
    batcher falls back to its inline verify path."""


@dataclass
class _LaneWork:
    """One batch moving through the lane."""

    entries: list[BatchEntry]
    stages: object                      # BatchStages | None
    loop: asyncio.AbstractEventLoop
    future: asyncio.Future
    bv: BatchVerifier | None = field(default=None, repr=False)
    prepared: PreparedBatch | None = field(default=None, repr=False)


def _run_instrumented(
    bv: BatchVerifier, prepared: PreparedBatch, stages
) -> list[Error | None]:
    """Backend phase with the optional env-gated instrumentation: a
    ``torch.profiler`` capture around the device dispatch
    (CPZK_XPROF_DIR) and the stage-decomposition stderr line
    (CPZK_BATCH_DEBUG=1)."""
    xprof = os.environ.get("CPZK_XPROF_DIR")
    if xprof and flightrec.start_profile(xprof):
        # the per-stage record_function ranges emitted by ``stages`` nest
        # inside this capture, so its timeline carries the same
        # pad_and_pack/device_dispatch/unpack names as /tracez
        try:
            import torch

            with torch.profiler.record_function("cpzk_batch_verify"):
                return bv.run_prepared(prepared, stages)
        finally:
            flightrec.stop_profile()
    if os.environ.get("CPZK_BATCH_DEBUG") == "1":
        t0 = time.perf_counter()
        out = bv.run_prepared(prepared, stages)
        print(f"[batch-debug] n={len(bv.entries)} "
              f"device_phase={time.perf_counter() - t0:.3f}s",
              file=sys.stderr, flush=True)
        return out
    return bv.run_prepared(prepared, stages)


class DispatchLane:
    """Persistent dispatch thread(s) behind
    :class:`~cpzk_tpu_torch.server.batching.DynamicBatcher`.

    ``staging_slots`` bounds how many host-prepared batches may wait for
    the device thread (the double-buffer depth); the batcher's own
    ``pipeline_depth`` semaphore bounds total in-flight batches, so the
    lane's queues stay shallow in steady state.
    """

    def __init__(
        self,
        backend,
        rng: SecureRng | None = None,
        overlap: bool = True,
        staging_slots: int = 1,
        name: str = "cpzk-lane",
    ):
        self._backend = backend
        self._rng = rng or SecureRng()
        self._overlap = overlap
        self._slots = max(1, staging_slots)
        self._name = name
        self._cv = threading.Condition()
        self._ingress: deque[_LaneWork] = deque()
        self._staged: deque[_LaneWork] = deque()
        self._stopping = False
        self._prep_done = False
        self._started = False
        self._threads: list[threading.Thread] = []

    # -- lifecycle ----------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._started and not self._stopping

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        if self._overlap:
            self._threads = [
                threading.Thread(
                    target=self._prep_loop, name=f"{self._name}-prep",
                    daemon=True,
                ),
                threading.Thread(
                    target=self._device_loop, name=f"{self._name}-device",
                    daemon=True,
                ),
            ]
        else:
            self._threads = [
                threading.Thread(
                    target=self._serial_loop, name=f"{self._name}-serial",
                    daemon=True,
                ),
            ]
        for t in self._threads:
            t.start()

    async def stop(self) -> None:
        """Refuse new work, drain every accepted batch, join the threads.
        Every future handed out by :meth:`submit` is resolved before this
        returns — the leak-free shutdown contract."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            # join on a worker thread: the lane may still be verifying a
            # large in-flight batch and the event loop must keep serving
            await asyncio.to_thread(t.join)
        # defensive sweep: the drain loops resolve everything they pop,
        # so leftovers mean a lane thread died abnormally — never leak
        # the futures regardless
        with self._cv:
            leftovers = list(self._ingress) + list(self._staged)
            self._ingress.clear()
            self._staged.clear()
        for work in leftovers:  # pragma: no cover - requires thread death
            self._post(work, None, LaneStopped("dispatch lane exited"))

    # -- submission (event-loop side) ---------------------------------------

    def submit(self, entries: list[BatchEntry], stages) -> asyncio.Future:
        """Queue one prepared-entry batch; returns a future resolving to
        the per-entry results (or raising the dispatch exception).  Must
        be called from a running event loop; raises :class:`LaneStopped`
        once :meth:`stop` has begun."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        work = _LaneWork(
            entries=entries, stages=stages, loop=loop, future=fut,
        )
        with self._cv:
            if not self.running:
                raise LaneStopped("dispatch lane is not accepting work")
            self._ingress.append(work)
            self._cv.notify_all()
        return fut

    def depths(self) -> tuple[int, int]:
        """(ingress, staged) queue depths — introspection for tests and
        status surfaces."""
        with self._cv:
            return len(self._ingress), len(self._staged)

    # -- shared verify seam --------------------------------------------------

    @staticmethod
    def verify_once(
        backend, rng: SecureRng, entries: list[BatchEntry], stages=None
    ) -> list[Error | None]:
        """Both phases back-to-back on the calling thread — the SAME
        code path the lane threads run, exposed for the stopped-batcher
        inline verify (``DynamicBatcher.submit_many`` during shutdown),
        so every serving path shares one dispatch seam and the flight
        record's stage-sum-vs-wall invariant holds everywhere."""
        bv = BatchVerifier(backend=backend, max_size=max(len(entries), 1))
        bv.entries.extend(entries)  # already validated at RPC ingress
        if stages is None:
            return _run_instrumented(bv, bv.prepare_batch(rng), None)
        stages.mark_worker_start()
        try:
            prepared = bv.prepare_batch(rng, stages)
            return _run_instrumented(bv, prepared, stages)
        finally:
            stages.mark_worker_end()

    # -- lane threads --------------------------------------------------------

    def _prepare(self, work: _LaneWork) -> bool:
        """Host phase on the prep thread; False when the batch already
        resolved (prep raised and the exception was posted)."""
        if work.stages is not None:
            work.stages.mark_worker_start()
        try:
            bv = BatchVerifier(
                backend=self._backend, max_size=max(len(work.entries), 1),
            )
            bv.entries.extend(work.entries)
            work.bv = bv
            work.prepared = bv.prepare_batch(self._rng, work.stages)
        except Exception as exc:
            self._post(work, None, exc)
            return False
        if work.stages is not None:
            work.stages.mark_staged()
        return True

    def _execute(self, work: _LaneWork) -> None:
        """Backend phase; posts results or the dispatch exception."""
        if work.stages is not None:
            work.stages.mark_device_start()
        try:
            results = _run_instrumented(work.bv, work.prepared, work.stages)
        except Exception as exc:
            # confined to this batch: the failover/breaker wrapper inside
            # the backend already routed what it could; the lane thread
            # itself survives for the next batch
            self._post(work, None, exc)
            return
        finally:
            if work.stages is not None:
                work.stages.mark_worker_end()
        self._post(work, results, None)

    def _pop_ingress(self) -> _LaneWork | None:
        """Next ingress item, blocking; None = stopping and fully drained."""
        with self._cv:
            while not self._ingress and not self._stopping:
                self._cv.wait()
            if not self._ingress:
                self._prep_done = True
                self._cv.notify_all()
                return None
            return self._ingress.popleft()

    def _prep_loop(self) -> None:
        while True:
            work = self._pop_ingress()
            if work is None:
                return
            if not self._prepare(work):
                continue
            with self._cv:
                # bounded staging: at most `slots` prepared batches wait
                # for the device thread (double-buffer backpressure).  No
                # stopping escape hatch — stop() drains, never drops.
                while len(self._staged) >= self._slots:
                    self._cv.wait()
                self._staged.append(work)
                self._cv.notify_all()

    def _device_loop(self) -> None:
        while True:
            with self._cv:
                while not self._staged and not self._prep_done:
                    self._cv.wait()
                if not self._staged:
                    return
                work = self._staged.popleft()
                self._cv.notify_all()  # staging slot freed
            self._execute(work)

    def _serial_loop(self) -> None:
        """pipeline_depth=1: both phases on one persistent thread."""
        while True:
            work = self._pop_ingress()
            if work is None:
                return
            if self._prepare(work):
                self._execute(work)

    # -- result posting ------------------------------------------------------

    def _post(self, work: _LaneWork, results, exc) -> None:
        def _resolve() -> None:
            fut = work.future
            if fut.done():
                return  # RPC side gave up (cancelled); nothing to deliver
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(results)

        try:
            work.loop.call_soon_threadsafe(_resolve)
        except RuntimeError:  # pragma: no cover - loop closed under us
            log.error(
                "dispatch lane could not post a batch result: the "
                "submitting event loop is closed (%d entries dropped)",
                len(work.entries),
            )
