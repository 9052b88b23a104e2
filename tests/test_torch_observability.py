"""The port's observability layer: twins of the tracer, ``/tracez``
format, breaker-event, request-context and metrics-facade cases of
``tests/test_observability.py`` and of the ring, dispatch-gap, format and
percentile cases of ``tests/test_flightrec.py``, plus the
``record_function`` stage alignment and the device interval the backend
reports.  Metrics are read from the port's own registry.

Tolerance: exact, except the float sums the JAX tests compare with
``pytest.approx`` at its default."""

import json
import threading

import pytest
import torch

from cpzk_tpu_torch import Parameters, Prover, SecureRng, Transcript, Witness
from cpzk_tpu_torch.core.ristretto import Ristretto255
from cpzk_tpu_torch.observability import (
    BatchStages,
    RequestContext,
    format_flightrec,
    format_tracez,
    get_flight_recorder,
    get_tracer,
)
from cpzk_tpu_torch.observability import flightrec
from cpzk_tpu_torch.observability.context import ATTEMPT_KEY, TRACE_ID_KEY
from cpzk_tpu_torch.observability.flightrec import (
    RECORD_STAGES,
    SCHEMA,
    FlightRecord,
    FlightRecorder,
    stage_percentiles,
)
from cpzk_tpu_torch.ops.backend import TorchBackend
from cpzk_tpu_torch.protocol.batch import (
    BatchVerifier,
    CpuBackend,
    FailoverBackend,
    VerifierBackend,
)
from cpzk_tpu_torch.server import metrics


@pytest.fixture(autouse=True)
def _fresh_tracer_and_recorder():
    tracer = get_tracer()
    prev_slow = tracer.slow_request_s
    tracer.clear()
    get_flight_recorder().clear()
    yield
    tracer.clear()
    tracer.slow_request_s = prev_slow
    get_flight_recorder().clear()


def _make_proofs(n, rng, params):
    out = []
    for i in range(n):
        prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
        ctx = b"fr-%04d" % i
        t = Transcript()
        t.append_context(ctx)
        out.append((prover.statement, prover.prove_with_transcript(rng, t), ctx))
    return out


# --- tracer unit behavior ----------------------------------------------------


def test_tracer_ring_capacity_and_find():
    tracer = get_tracer()
    tracer.configure(capacity=4)
    try:
        for i in range(10):
            ctx = RequestContext()
            tracer.start(ctx, f"op{i}")
            tracer.finish(ctx.trace_id, "success")
        completed = tracer.completed()
        assert len(completed) == 4
        assert [t.name for t in completed] == ["op6", "op7", "op8", "op9"]
        assert tracer.find(completed[-1].trace_id) == [completed[-1]]
    finally:
        tracer.configure(capacity=256)


def test_tracer_span_on_unknown_trace_is_dropped():
    tracer = get_tracer()
    tracer.add_span("no-such-trace", "queue_wait", 0.0, 1.0)
    tracer.add_span(None, "queue_wait", 0.0, 1.0)
    assert tracer.completed() == []


def test_breaker_transition_lands_in_trace_ring():
    """CLOSED→OPEN breaker flips are on the same timeline as request
    traces, counted once in ``tpu.backend.failover``."""

    class Broken(VerifierBackend):
        prefers_combined = True

        def verify_combined(self, rows, beta):
            raise RuntimeError("injected device loss")

        def verify_each(self, rows):
            raise RuntimeError("injected device loss")

    rng = SecureRng()
    params = Parameters.new()
    prover = Prover(params, Witness(Ristretto255.random_scalar(rng)))
    proof = prover.prove_with_transcript(rng, Transcript())
    failovers = metrics.read("tpu.backend.failover")

    backend = FailoverBackend(Broken(), CpuBackend())
    bv = BatchVerifier(backend=backend)
    bv.add(params, prover.statement, proof)
    bv.add(params, prover.statement, proof)
    assert bv.verify(rng) == [None, None]
    assert backend.degraded

    events = [
        t for t in get_tracer().completed() if t.name == "breaker_transition"
    ]
    assert events
    attrs = events[-1].spans[0].attrs
    assert (attrs["old"], attrs["new"]) == ("closed", "open")
    assert events[-1].status == "event"
    assert metrics.read("tpu.backend.failover") - failovers == 1
    assert metrics.read("tpu.backend.state", kind="g") == 1.0
    backend.reset()
    assert metrics.read("tpu.backend.state", kind="g") == 0.0


def test_format_tracez_empty_and_limit():
    assert "no completed traces" in format_tracez({"traces": []})
    tracer = get_tracer()
    for i in range(5):
        ctx = RequestContext()
        tracer.start(ctx, f"op{i}")
        tracer.finish(ctx.trace_id, "success")
    payload = tracer.payload()
    assert payload["schema"] == "cpzk-tracez/1"
    out = format_tracez(payload, limit=2)
    assert "op4" in out and "op3" in out and "op2" not in out


# --- context plumbing --------------------------------------------------------


def test_request_context_metadata_roundtrip():
    ctx = RequestContext(attempt=3, parent_span="abcd")
    md = ctx.to_metadata()
    back = RequestContext.from_metadata(md, deadline=12.5)
    assert back.trace_id == ctx.trace_id
    assert back.attempt == 3
    assert back.parent_span == "abcd"
    assert back.deadline == 12.5


def test_request_context_tolerates_garbage_metadata():
    back = RequestContext.from_metadata(
        [(TRACE_ID_KEY, ""), (ATTEMPT_KEY, "not-a-number")]
    )
    assert back.trace_id  # freshly minted
    assert back.attempt == 1
    assert RequestContext.from_metadata(None).trace_id


# --- metrics facade ----------------------------------------------------------


def test_noop_metric_observe_accumulates():
    from cpzk_tpu_torch.server.metrics import _NoopMetric

    m = _NoopMetric()
    m.observe(0.5)
    m.observe(1.5)
    assert m._count.get() == 2.0
    assert m._sum.get() == 2.0


def test_noop_metric_labeled_children():
    from cpzk_tpu_torch.server.metrics import _NoopMetric

    fam = _NoopMetric(("rpc", "outcome"))
    fam.labels(rpc="X", outcome="success").inc()
    fam.labels(rpc="X", outcome="success").inc(2)
    fam.labels(rpc="Y", outcome="failure").inc()
    assert fam.labels(rpc="X", outcome="success")._value.get() == 3.0
    assert fam.labels(rpc="Y", outcome="failure")._value.get() == 1.0


def test_histogram_read_count_and_sum():
    h = metrics.histogram("obs.test.hist")
    h.observe(0.25)
    h.observe(0.75)
    count, total = metrics.read_histogram("obs.test.hist")
    assert count == 2.0
    assert total == pytest.approx(1.0)
    assert metrics.read("obs.test.hist", "h") == pytest.approx(1.0)
    assert metrics.read_histogram("obs.test.never.created") == (0.0, 0.0)


def test_registered_inventory_lists_kinds():
    metrics.counter("obs.test.reg.counter").inc()
    metrics.gauge("obs.test.reg.gauge").set(1)
    pairs = metrics.registered()
    assert ("c", "obs.test.reg.counter") in pairs
    assert ("g", "obs.test.reg.gauge") in pairs


# --- flight recorder ring ----------------------------------------------------


def test_ring_bounded_and_dump_stable(tmp_path):
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.record(FlightRecord(batch=i + 1, stages_s={"execute": 0.001}))
    records = rec.snapshot()
    assert len(records) == 4
    assert [r.batch for r in records] == [7, 8, 9, 10]
    assert [r.seq for r in records] == [7, 8, 9, 10]

    payload = json.loads(rec.to_json())
    assert payload["schema"] == SCHEMA == "cpzk-flightrec/1"
    assert len(payload["records"]) == 4
    for row in payload["records"]:
        assert set(row) >= {
            "seq", "batch", "lanes", "occupancy", "pad_waste", "backend",
            "stages_s", "wall_s", "dispatch_gap_s", "jit_hits", "jit_misses",
        }
    path = tmp_path / "flightrec.json"
    rec.dump(str(path))
    assert json.loads(path.read_text())["records"] == payload["records"]
    assert "n=10" in format_flightrec(payload)


def test_ring_thread_safe():
    rec = FlightRecorder(capacity=64)
    errors = []

    def writer(k):
        try:
            for i in range(200):
                rec.record(FlightRecord(batch=k * 1000 + i))
                rec.note_device_interval(float(i), float(i) + 0.5)
        except Exception as exc:  # pragma: no cover - the assertion target
            errors.append(exc)

    def reader():
        try:
            for _ in range(100):
                rec.snapshot()
                rec.to_json()
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=writer, args=(k,)) for k in range(4)]
    threads += [threading.Thread(target=reader) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
        assert not t.is_alive()
    assert not errors
    assert len(rec.snapshot()) == 64


def test_dispatch_gap_accounting():
    rec = FlightRecorder()
    assert rec.note_device_interval(10.0, 10.5) == 0.0  # first dispatch
    assert rec.note_device_interval(11.0, 11.2) == pytest.approx(0.5)
    # pipelined overlap: the device never went idle
    assert rec.note_device_interval(11.1, 11.4) == 0.0


def test_recorder_configure_capacity():
    rec = FlightRecorder(capacity=8)
    for i in range(8):
        rec.record(FlightRecord(batch=i))
    rec.configure(capacity=2)
    assert len(rec.snapshot()) == 2


def test_stage_percentiles_from_records():
    records = [
        FlightRecord(stages_s={"execute": 0.001 * (i + 1), "marshal": 0.0005})
        for i in range(10)
    ]
    out = stage_percentiles(records)
    assert out["execute"]["p50"] == pytest.approx(5.0)
    assert out["execute"]["p90"] == pytest.approx(9.0)
    assert out["execute"]["p99"] == pytest.approx(10.0)
    assert out["marshal"]["p50"] == pytest.approx(0.5)
    assert stage_percentiles([]) == {}


def test_format_flightrec_limit():
    records = [
        FlightRecord(seq=i, batch=i, stages_s={}, wall_s=0.001)
        for i in range(1, 6)
    ]
    payload = {"records": [r.to_dict() for r in records]}
    out = format_flightrec(payload, limit=2)
    assert "#5" in out and "#4" in out and "#3" not in out
    for name in RECORD_STAGES:
        assert f"{name}=" in out


def test_direct_batchverifier_unrecorded():
    """The direct BatchVerifier path (stages=None) on the GPU backend's
    plain versions never touches the recorder: its ``note_*`` calls find no
    sink."""
    rng = SecureRng()
    params = Parameters.new()
    proofs = _make_proofs(3, rng, params)
    bv = BatchVerifier(backend=TorchBackend(device="cpu"))
    for st, pr, ctx in proofs:
        bv.add_with_context(params, st, pr, ctx)
    assert bv.verify(rng) == [None] * 3
    assert get_flight_recorder().snapshot() == []


# --- the port's own: stage alignment and the card's interval ------------------


def test_stage_names_show_under_the_profiler():
    """Under ``torch.profiler`` each stage shows as ``cpzk.<stage>``."""
    from torch.profiler import ProfilerActivity, profile

    stages = BatchStages(None, [])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("pad_and_pack", "device_dispatch", "unpack"):
            with stages.stage(name):
                torch.ones(2).sum()
    names = {evt.key for evt in prof.key_averages()}
    assert {"cpzk.pad_and_pack", "cpzk.device_dispatch", "cpzk.unpack"} <= names


def test_backend_reports_lanes_marshal_and_device_interval():
    """Through the GPU backend's plain versions, the record carries the
    padded lanes, the marshal split and the device interval the backend
    reported; the stages tile the wall and land on the request's trace."""
    rng = SecureRng()
    params = Parameters.new()
    proofs = _make_proofs(2, rng, params)
    tracer = get_tracer()
    ctx = RequestContext()
    tracer.start(ctx, "VerifyProof")
    stages = BatchStages(tracer, [ctx.trace_id], batch_size=2,
                         backend_label="primary")
    bv = BatchVerifier(backend=TorchBackend(device="cpu"))
    for st, pr, c in proofs:
        bv.add_with_context(params, st, pr, c)
    stages.mark_submit()
    stages.mark_worker_start()
    assert bv.verify(rng, stages) == [None, None]
    stages.mark_worker_end()
    record = stages.finalize(0.0)
    tracer.finish(ctx.trace_id, "success")

    assert (record.lanes, record.occupancy) == (4, 0.75)  # 2 rows + correction
    assert 0.0 < record.device_interval_s <= record.stages_s["device_dispatch"]
    assert record.stages_s["marshal"] > 0.0
    assert record.stage_sum_s() == pytest.approx(record.wall_s, rel=0.10, abs=2.5e-3)
    spans = tracer.completed()[-1].span_names()
    assert {"pad_and_pack", "device_dispatch", "marshal", "execute", "unpack"} <= set(spans)
    assert "device_dispatch=" in format_tracez(tracer.payload())


def test_device_sink_takes_the_span_of_every_reported_interval():
    sink, token = flightrec.install_sink()
    try:
        flightrec.note_device(5.0, 5.5)
        flightrec.note_device(6.0, 6.25)
        flightrec.note_marshal(0.125)
        flightrec.note_lanes(3, 4)
    finally:
        flightrec.uninstall_sink(token)
    flightrec.note_device(7.0, 8.0)  # no sink: dropped
    assert (sink.device_start, sink.device_end, sink.device_interval_s) == (5.0, 6.25, 0.75)
    assert (sink.marshal_s, sink.rows, sink.lanes) == (0.125, 3, 4)


def test_profile_capture_writes_one_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    assert flightrec.start_profile(logdir)
    try:
        assert not flightrec.start_profile(logdir)  # one capture at a time
        assert flightrec.profile_active() == logdir
        torch.ones(4).sum()
    finally:
        assert flightrec.stop_profile() == logdir
    assert flightrec.stop_profile() is None
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1 and json.loads(files[0].read_text())
