"""Dynamic batching: coalesce concurrent verification requests into
device-sized batches.

A port of ``cpzk_tpu/server/batching.py``.  Request handlers submit
(params, statement, proof, context) entries and await a future; a single
dispatcher task drains the queue every ``window_ms`` (or immediately at
``max_batch``) and hands each batch to the
:class:`~cpzk_tpu_torch.server.dispatch.DispatchLane` — a persistent
host-prep + device-dispatch thread pair (batch N+1's host prep overlaps
batch N's work on the card), which resolves the futures with per-entry
results.  Accept/reject semantics are exactly the BatchVerifier ground
truth, so batching is observationally identical to inline verification —
only latency (+window) and throughput change.

Deadline shedding: each entry may carry the absolute monotonic deadline of
the request that queued it; the dispatcher drops already-expired entries
*before* device dispatch, resolving their futures with
:class:`DeadlineExceeded` — a saturated queue stops burning device time on
answers nobody is waiting for.  ``shed_expired=False`` restores
verify-everything behavior.

Metrics (the reference's names): ``tpu.queue.depth`` (queued +
claimed-by-in-flight-dispatches), ``tpu.batch.fill_ratio``,
``tpu.batch.latency`` (histogram), ``tpu.batch.proofs`` /
``tpu.queue.shed`` / ``tpu.queue.expired`` / ``tpu.queue.abandoned``
(counters).

Tracing: entries carry the submitting request's trace id; each dispatch
records a per-entry ``queue_wait`` span (and histogram) plus batch-level
``pad_and_pack`` / ``device_dispatch`` / ``unpack`` stage spans via
:class:`~cpzk_tpu_torch.observability.BatchStages`, with
``tpu.batch.host_time`` / ``tpu.batch.device_time`` histograms, and one
:class:`~cpzk_tpu_torch.observability.flightrec.FlightRecord` — the
widened ``thread_hop``/``device_wait``/``marshal``/``execute`` split,
padded-lane occupancy, and the card's dispatch gap.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ..core.rng import SecureRng
from ..errors import Error
from ..observability.tracing import BatchStages, get_tracer
from ..protocol.batch import BatchEntry, VerifierBackend
from ..protocol.gadgets import Parameters, Proof, Statement
from . import metrics
from .dispatch import DispatchLane, LaneStopped

log = logging.getLogger("cpzk_tpu_torch.server.batching")


#: Max per-dispatch ``tpu.batch.queue_wait`` histogram observes; deeper
#: batches are stride-sampled (uniform, mean-unbiased — the admission
#: controller's overload signal reads the mean of this histogram).
_QUEUE_WAIT_SAMPLE = 128


class QueueFull(Exception):
    """Backpressure signal: the batcher queue is at capacity.  The RPC
    layer maps this to RESOURCE_EXHAUSTED (an unbounded queue grows
    without limit under sustained overload)."""


class DeadlineExceeded(Exception):
    """Deadline-shed signal: the entry's RPC deadline expired while it was
    queued, so it was dropped before device dispatch.  The RPC layer maps
    this to DEADLINE_EXCEEDED (usually moot — the client already gave up —
    but it keeps the status truthful for proxies and logs)."""


class _EntryGroup:
    """Shared result collector for one :meth:`DynamicBatcher.submit_group`
    chunk: ONE asyncio future for the whole chunk instead of one per
    entry.  Per-entry futures cost an ``ensure_future`` + ``call_soon``
    callback + context switch each in ``asyncio.wait`` — at stream depth
    that machinery alone was a measurable slice of every proof."""

    __slots__ = ("fut", "results", "remaining")

    def __init__(self, fut: asyncio.Future, n: int):
        self.fut = fut
        self.results: list = [None] * n
        self.remaining = n

    def note(self, index: int, value) -> None:
        if self.fut.done():
            return  # chunk abandoned (stream handler cancelled mid-wait)
        self.results[index] = value
        self.remaining -= 1
        if self.remaining == 0:
            self.fut.set_result(self.results)


class _GroupSlot:
    """Future-shaped view of one entry's slot in an :class:`_EntryGroup`
    — implements exactly the surface the dispatcher touches (``done`` /
    ``set_result`` / ``set_exception``), with exceptions SETTLED as
    values (the streaming per-entry-verdict contract)."""

    __slots__ = ("group", "index")

    def __init__(self, group: _EntryGroup, index: int):
        self.group = group
        self.index = index

    def done(self) -> bool:
        # the group future only completes when every slot resolved or the
        # submitter gave up — either way this slot needs no delivery
        return self.group.fut.done()

    def set_result(self, value) -> None:
        self.group.note(self.index, value)

    def set_exception(self, exc: BaseException) -> None:
        self.group.note(self.index, exc)


class DynamicBatcher:
    """Deadline-based request coalescing in front of a ``VerifierBackend``."""

    def __init__(
        self,
        backend: VerifierBackend | None,
        max_batch: int = 4096,
        window_ms: float = 5.0,
        max_queue: int | None = None,
        pipeline_depth: int = 2,
        shed_expired: bool = True,
        router=None,
    ):
        self.backend = backend
        # multi-device serving plane: a prebuilt LaneRouter replaces the
        # single dispatch lane — every settled batch is placed on one of N
        # per-device lanes (or the big-batch mesh lane).  None (the
        # [tpu] lanes = 1 default) keeps the single-lane path unchanged
        self.router = router
        self.max_batch = max_batch
        self.shed_expired = shed_expired
        # shed load once more than a few device batches are waiting; the
        # dispatcher drains max_batch per pass, so 4x is ~4 windows of grace
        self.max_queue = max_queue if max_queue is not None else 4 * max_batch
        self.window = window_ms / 1000.0
        # host-pipeline overlap: up to pipeline_depth batches in flight, so
        # batch k+1's host stage (challenge hashing — GIL-releasing native
        # work) overlaps batch k's device compute.  Depth 1 restores
        # strictly serial dispatch.
        self.pipeline_depth = max(1, pipeline_depth)
        # the persistent dispatch lane (created per start()): one host-prep
        # thread + one device thread replacing the per-batch to_thread hop;
        # depth 1 collapses it to a single strictly-serial lane thread
        self._lane: DispatchLane | None = None
        self._inflight: asyncio.Semaphore | None = None
        # entries claimed by in-flight dispatches but not yet resolved;
        # counted into both backpressure and the depth gauge so pipelining
        # can't hide a device's worth of queued work
        self._inflight_entries = 0
        self._dispatches: set[asyncio.Task] = set()
        self._queue: list[tuple[BatchEntry, asyncio.Future]] = []
        self._wakeup: asyncio.Event = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._stopping = False
        self._rng = SecureRng()
        # drain-rate EWMA (entries resolved per second): the admission
        # controller sizes cpzk-retry-after-ms pushback from it
        self._drained_at: float | None = None
        self._drain_rate = 0.0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is not None and not self._task.done():
            return  # already running (serve() starts the batcher it is given)
        if self.router is not None:
            self.router.start()
        else:
            self._lane = DispatchLane(
                self.backend,
                rng=self._rng,
                overlap=self.pipeline_depth > 1,
                staging_slots=max(1, self.pipeline_depth - 1),
            )
            self._lane.start()
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def stop(self) -> None:
        """Drain the queue and all in-flight dispatches, then stop —
        including the dispatch lane, which drains its accepted batches
        and resolves every pending future before its threads exit."""
        self._stopping = True
        self._wakeup.set()
        if self._task is not None:
            await self._task
            self._task = None
        if self._dispatches:
            await asyncio.gather(*tuple(self._dispatches), return_exceptions=True)
        if self._lane is not None:
            await self._lane.stop()
        if self.router is not None:
            await self.router.stop()

    # -- submission --------------------------------------------------------

    async def submit(
        self,
        params: Parameters,
        statement: Statement,
        proof: Proof,
        context: bytes | None,
        deadline: float | None = None,
        trace_id: str | None = None,
    ) -> Error | None:
        """Queue one proof; resolves to ``None`` (ok) or the ``Error``.
        ``deadline`` is an absolute ``time.monotonic()`` point (the RPC
        deadline); past it the entry is shed instead of verified and the
        await raises :class:`DeadlineExceeded`.  ``trace_id`` ties the
        entry's stage spans (queue_wait, pad_and_pack, device_dispatch,
        unpack) to the submitting RPC's trace."""
        entry = BatchEntry(
            params, statement, proof, context,
            deadline=deadline, trace_id=trace_id,
        )
        return (await self.submit_many([entry]))[0]

    async def submit_many(
        self, entries: list[BatchEntry], settled: bool = False
    ) -> list[Error | None]:
        """Queue a whole RPC's entries in one enqueue: one capacity check,
        one wakeup, and futures created without a coroutine per item —
        the per-item scheduling cost is the serving layer's, not the
        device's, so batch RPCs bypass it.  All-or-nothing on
        backpressure: either every entry is queued or ``QueueFull`` is
        raised before any is (no orphaned siblings to drain).  Entries may
        still be split across device batches at ``max_batch`` boundaries
        or coalesced with concurrent RPCs — per-entry results are awaited
        together and returned in order.

        ``settled=True`` (the streaming path) returns per-entry
        EXCEPTIONS as values instead of raising the first one: entries
        shed by the deadline policy come back as their
        :class:`DeadlineExceeded` while their batch siblings still carry
        real verdicts — the per-entry NOT-verdict contract a stream needs
        (an exception raised for one entry of a unary batch RPC aborts
        the whole RPC anyway, so the unary path keeps raising)."""
        if not entries:
            return []
        now = time.monotonic()
        for entry in entries:
            entry.enqueued_at = now
        if self._stopping or self._task is None or self._task.done():
            # shutdown window (stop() ran but the listener is still up) or
            # batcher never started: verify inline with identical semantics
            # through the SAME dispatch seam the lane threads run
            # (DispatchLane.verify_once), so the flight record still lands
            # with the full stage decomposition — thread_hop here is the
            # one-off to_thread handoff this fallback path actually pays
            stages = self._stages_for(entries)
            t0 = time.monotonic()
            stages.mark_submit()
            try:
                results = await asyncio.to_thread(
                    DispatchLane.verify_once,
                    self.backend, self._rng, entries, stages,
                )
            except Exception as exc:
                if not settled:
                    raise
                return [exc] * len(entries)  # type: ignore[list-item]
            stages.finalize(time.monotonic() - t0)
            return results
        # backpressure over the whole pipeline: queued entries PLUS entries
        # already claimed by in-flight dispatches — otherwise a deep
        # pipeline accepts up to pipeline_depth*max_batch extra work the
        # instant the queue drains, defeating the cap
        if len(self._queue) + self._inflight_entries + len(entries) > self.max_queue:
            metrics.counter("tpu.queue.shed").inc()
            raise QueueFull(
                f"verification queue at capacity ({self.max_queue} entries)"
            )
        loop = asyncio.get_running_loop()
        futs = [loop.create_future() for _ in entries]
        self._queue.extend(zip(entries, futs, strict=True))
        self._set_depth_gauge()
        self._wakeup.set()
        # Futures resolve to an Error VALUE for a per-entry verification
        # failure and to a raised exception only for dispatch blowups —
        # gather(return_exceptions=True) would conflate the two, and plain
        # gather would leave sibling exceptions unretrieved (log flood).
        # wait + explicit .exception() keeps the distinction and marks
        # every sibling's exception retrieved before the first propagates.
        try:
            await asyncio.wait(futs)
        except asyncio.CancelledError:
            # RPC cancelled while queued: cancel our futures so a later
            # dispatch failure doesn't set never-retrieved exceptions on
            # them (_dispatch skips done futures)
            for fut in futs:
                fut.cancel()
            raise
        first_exc: BaseException | None = None
        results: list[Error | None] = []
        for fut in futs:
            exc = fut.exception()
            if exc is not None:
                first_exc = first_exc or exc
                results.append(exc if settled else None)  # type: ignore[arg-type]
            else:
                results.append(fut.result())
        if first_exc is not None and not settled:
            raise first_exc
        return results

    async def submit_group(self, entries: list[BatchEntry]) -> list:
        """The streaming enqueue: one chunk, ONE future.  Same queueing,
        coalescing, shedding, and backpressure semantics as
        :meth:`submit_many` with ``settled=True`` (per-entry exceptions
        come back as values), but the n-futures-plus-``asyncio.wait``
        machinery is replaced by an :class:`_EntryGroup` the dispatcher
        fills in place — the difference is pure per-entry event-loop
        overhead, which is exactly what a deep stream amortizes away."""
        if not entries:
            return []
        now = time.monotonic()
        for entry in entries:
            entry.enqueued_at = now
        if self._stopping or self._task is None or self._task.done():
            stages = self._stages_for(entries)
            t0 = time.monotonic()
            stages.mark_submit()
            try:
                results = await asyncio.to_thread(
                    DispatchLane.verify_once,
                    self.backend, self._rng, entries, stages,
                )
            except Exception as exc:
                return [exc] * len(entries)
            stages.finalize(time.monotonic() - t0)
            return results
        if len(self._queue) + self._inflight_entries + len(entries) > self.max_queue:
            metrics.counter("tpu.queue.shed").inc()
            raise QueueFull(
                f"verification queue at capacity ({self.max_queue} entries)"
            )
        loop = asyncio.get_running_loop()
        group = _EntryGroup(loop.create_future(), len(entries))
        self._queue.extend(  # type: ignore[arg-type]  # future-shaped slots
            (entry, _GroupSlot(group, i)) for i, entry in enumerate(entries)
        )
        self._set_depth_gauge()
        self._wakeup.set()
        return await group.fut

    # -- dispatcher --------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._wakeup.wait()
            self._wakeup.clear()
            if not self._queue:
                if self._stopping:
                    return
                continue
            # deadline window: let concurrent requests pile in, but dispatch
            # immediately once a full device batch is queued (the wakeup
            # event interrupts the wait) or when draining for shutdown
            deadline = loop.time() + self.window
            while len(self._queue) < self.max_batch and not self._stopping:
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(self._wakeup.wait(), remaining)
                    self._wakeup.clear()
                except asyncio.TimeoutError:
                    break

            if self._inflight is None:
                self._inflight = asyncio.Semaphore(self.pipeline_depth)
            while self._queue:
                # shed entries whose RPC deadline already passed — nobody
                # is waiting, so device time on them is pure waste
                self._drop_expired()
                take = self._queue[: self.max_batch]
                if not take:
                    break
                del self._queue[: len(take)]
                self._inflight_entries += len(take)
                self._set_depth_gauge()
                # bounded pipeline: block only when pipeline_depth batches
                # are already in flight; otherwise batch k+1's host prep
                # overlaps batch k's device compute on another thread
                await self._inflight.acquire()
                task = asyncio.get_running_loop().create_task(
                    self._dispatch_release(take)
                )
                self._dispatches.add(task)
                task.add_done_callback(self._dispatches.discard)

            if self._stopping and not self._queue:
                return

    async def _dispatch_release(self, take) -> None:
        try:
            await self._dispatch(take)
        finally:
            assert self._inflight is not None
            self._inflight.release()
            # recompute after the drain: the gauge reflects queued +
            # in-flight work, so it cannot read 0 while a device batch is
            # still resolving
            self._inflight_entries -= len(take)
            self._set_depth_gauge()
            self._note_drain(len(take))

    # -- load signals (admission subsystem seam) ---------------------------

    def load_snapshot(self) -> tuple[int, int]:
        """(entries queued + claimed in flight, queue capacity) — the
        utilization signal the admission controller adapts on."""
        return len(self._queue) + self._inflight_entries, self.max_queue

    def drain_rate(self) -> float:
        """EWMA of entries resolved per second (0.0 until the first two
        dispatches have completed)."""
        return self._drain_rate

    def _note_drain(self, n: int) -> None:
        now = time.monotonic()
        if self._drained_at is not None:
            dt = now - self._drained_at
            if dt > 0:
                inst = n / dt
                self._drain_rate = (
                    inst if self._drain_rate == 0.0
                    else 0.8 * self._drain_rate + 0.2 * inst
                )
        self._drained_at = now

    def _set_depth_gauge(self) -> None:
        metrics.gauge("tpu.queue.depth").set(
            len(self._queue) + self._inflight_entries
        )

    def _split_expired(
        self, items: list[tuple[BatchEntry, asyncio.Future]]
    ) -> tuple[list[tuple[BatchEntry, asyncio.Future]], list[asyncio.Future]]:
        """(live, expired-futures) partition of ``items`` at now.  Entries
        whose future is already done (RPC cancelled while queued — e.g.
        the client's deadline fired first) are dropped on the floor here
        too: nobody can observe their result, so verifying them would be
        the same waste as verifying an expired entry.  They count into
        ``tpu.queue.abandoned`` rather than ``tpu.queue.expired`` so the
        two shed paths stay distinguishable on a dashboard."""
        if not self.shed_expired:
            return items, []
        now = time.monotonic()
        live, expired, abandoned = [], [], 0
        for entry, fut in items:
            if fut.done():
                abandoned += 1
            elif entry.deadline is not None and now >= entry.deadline:
                expired.append(fut)
            else:
                live.append((entry, fut))
        if abandoned:
            metrics.counter("tpu.queue.abandoned").inc(abandoned)
        return live, expired

    def _resolve_expired(self, futs: list[asyncio.Future]) -> None:
        if not futs:
            return
        metrics.counter("tpu.queue.expired").inc(len(futs))
        for fut in futs:
            fut.set_exception(
                DeadlineExceeded("RPC deadline expired before dispatch")
            )

    def _drop_expired(self) -> None:
        live, expired = self._split_expired(self._queue)
        if len(live) != len(self._queue):  # expired OR abandoned were cut
            self._queue[:] = live
            self._set_depth_gauge()
        self._resolve_expired(expired)

    def _backend_label(self) -> str:
        """Which compute plane this batch lands on, for the ``backend``
        label of ``tpu.batch.device_time`` ("fallback" while a failover
        wrapper is degraded)."""
        backend = self.backend
        if backend is None:
            return "cpu"
        if hasattr(backend, "degraded"):
            return "fallback" if backend.degraded else "primary"
        name = type(backend).__name__.removesuffix("Backend").lower()
        return name or "custom"

    def _stages_for(
        self, entries: list[BatchEntry], queue_wait_s: float = 0.0
    ) -> BatchStages:
        return BatchStages(
            get_tracer(),
            [e.trace_id for e in entries],
            batch_size=len(entries),
            backend_label=self._backend_label(),
            queue_wait_s=queue_wait_s,
        )

    def _note_queue_wait(self, entries: list[BatchEntry]) -> float:
        """queue_wait span + histogram, measured from enqueue to the
        moment the batch is committed to dispatch; returns the mean wait
        (the flight record's ``queue_wait_s``).

        Spans are grouped per trace: entries sharing a trace id (a batch
        RPC's items, a stream chunk) get ONE ``queue_wait`` span carrying
        their mean wait and entry count — per-entry spans on a shared
        trace are redundant for display and quadratic for memory on deep
        streams.  Entries with distinct traces keep their exact
        per-entry span.  Histogram observes are stride-sampled above
        ``_QUEUE_WAIT_SAMPLE`` entries per dispatch (uniform stride, so
        the mean the admission controller reads stays unbiased) — at
        device-quantum batch sizes, per-entry observes were a
        milliseconds-scale slice of every dispatch."""
        now = time.monotonic()
        tracer = get_tracer()
        hist = metrics.histogram("tpu.batch.queue_wait")
        total = 0.0
        seen = 0
        by_trace: dict[str, tuple[float, int, float]] = {}
        waits: list[float] = []
        for entry in entries:
            if entry.enqueued_at is None:
                continue
            wait = max(0.0, now - entry.enqueued_at)
            total += wait
            seen += 1
            waits.append(wait)
            tid = entry.trace_id
            if tid:
                acc = by_trace.get(tid)
                if acc is None:
                    by_trace[tid] = (wait, 1, entry.enqueued_at)
                else:
                    by_trace[tid] = (
                        acc[0] + wait, acc[1] + 1, min(acc[2], entry.enqueued_at)
                    )
        if len(waits) <= _QUEUE_WAIT_SAMPLE:
            for wait in waits:
                hist.observe(wait)
        else:
            stride = len(waits) / _QUEUE_WAIT_SAMPLE
            for k in range(_QUEUE_WAIT_SAMPLE):
                hist.observe(waits[int(k * stride)])
        for tid, (t_sum, count, first) in by_trace.items():
            if count == 1:
                tracer.add_span(tid, "queue_wait", first, t_sum)
            else:
                tracer.add_span(
                    tid, "queue_wait", first, t_sum / count, entries=count
                )
        return total / seen if seen else 0.0

    async def _dispatch(self, take: list[tuple[BatchEntry, asyncio.Future]]) -> None:
        # entries can also expire between the drain-loop slice and this
        # dispatch actually running (pipeline backpressure waits on the
        # in-flight semaphore in between) — shed them here too, right
        # before device work is committed
        take, expired = self._split_expired(take)
        self._resolve_expired(expired)
        if not take:
            return
        entries = [e for e, _ in take]
        futs = [f for _, f in take]
        metrics.gauge("tpu.batch.fill_ratio").set(len(entries) / self.max_batch)
        metrics.counter("tpu.batch.proofs").inc(len(entries))
        mean_wait = self._note_queue_wait(entries)
        stages = self._stages_for(entries, queue_wait_s=mean_wait)
        t0 = time.monotonic()  # same clock as the stage spans, so the
        stages.mark_submit()   # stage-sum-vs-wall invariant is exact
        try:
            results = await self._lane_verify(entries, stages)
        except Exception as exc:  # backend blew up past all failovers
            log.exception("batch dispatch failed")
            for fut in futs:
                if not fut.done():
                    fut.set_exception(exc)
            return
        wall = time.monotonic() - t0
        metrics.histogram("tpu.batch.latency").observe(wall)
        # flight record: the widened stage breakdown, padded-shape
        # occupancy, jit attribution, and dispatch gap for this batch
        stages.finalize(wall)
        for fut, res in zip(futs, results, strict=True):
            if not fut.done():
                fut.set_result(res)

    async def _lane_verify(
        self, entries: list[BatchEntry], stages: BatchStages | None
    ) -> list[Error | None]:
        """Route one committed batch through the lane router (multi-device
        plane) or the single dispatch lane; falls back to a worker thread
        running the identical seam when the lane is already draining (a
        dispatch committed in the same loop tick as stop())."""
        router = self.router
        if router is not None and router.running:
            try:
                return await router.submit(entries, stages)
            except LaneStopped:
                pass  # raced stop(); the fallback below still verifies
        lane = self._lane
        if lane is not None and lane.running:
            try:
                return await lane.submit(entries, stages)
            except LaneStopped:
                pass  # raced stop(); the fallback below still verifies
        return await asyncio.to_thread(
            DispatchLane.verify_once, self.backend, self._rng, entries, stages,
        )
