"""The port's metrics live in a Prometheus registry of their own.

Both packages create metrics of the same names (``tpu.queue.shed``,
``tpu.batch.latency``, ``tpu.backend.failover``, ...).  The JAX package
creates them in prometheus_client's process-wide default registry; if the
port did the same, whichever package came second in a process would raise
"Duplicated timeseries in CollectorRegistry", and which test files share a
pytest-xdist worker would decide whether the suite passed.  These tests pin
that both orders work in one process, that the counts stay apart, that the
port's exposition holds only its own families, and that the port's facade
also counts without prometheus_client."""

import os
import subprocess
import sys
from pathlib import Path

import prometheus_client

from cpzk_tpu.server import metrics as jmetrics
from cpzk_tpu_torch.server import metrics as tmetrics

ROOT = Path(__file__).resolve().parent.parent

#: (kind, name, labelnames) created in both packages, as the serving
#: planes create them
SHARED = [
    ("counter", "tpu.queue.shed", ()),
    ("histogram", "tpu.batch.latency", ()),
    ("counter", "tpu.backend.failover", ()),
    ("gauge", "tpu.queue.depth", ()),
    ("histogram", "tpu.batch.device_time", ("backend",)),
    ("counter", "tpu.queue.expired", ()),
]


def create(facade, kind, name, labelnames):
    return getattr(facade, kind)(name, labelnames=labelnames)


def bump(metric, kind, labelnames, amount):
    if labelnames:
        metric = metric.labels(backend="primary")
    method = {"counter": "inc", "gauge": "set", "histogram": "observe"}[kind]
    getattr(metric, method)(amount)


def read(facade, kind, name, labelnames):
    labels = {"backend": "primary"} if labelnames else None
    return facade.read(name, kind[0], labels=labels)


def test_same_names_in_both_packages_in_one_process():
    """JAX package first, then the port (this process); neither raises,
    and an increment in one is never read by the other."""
    for kind, name, labelnames in SHARED:
        jm = create(jmetrics, kind, name, labelnames)
        tm = create(tmetrics, kind, name, labelnames)
        assert jm is not tm
        j0 = read(jmetrics, kind, name, labelnames)
        t0 = read(tmetrics, kind, name, labelnames)
        bump(tm, kind, labelnames, 3.0)
        assert read(jmetrics, kind, name, labelnames) == j0
        assert read(tmetrics, kind, name, labelnames) == (
            3.0 if kind == "gauge" else t0 + 3.0)
        bump(jm, kind, labelnames, 5.0)
        assert read(tmetrics, kind, name, labelnames) == (
            3.0 if kind == "gauge" else t0 + 3.0)
        assert read(jmetrics, kind, name, labelnames) == (
            5.0 if kind == "gauge" else j0 + 5.0)


_REVERSE_ORDER = """
import sys
sys.path.insert(0, {root!r})
from cpzk_tpu_torch.server import metrics as tmetrics
from cpzk_tpu.server import metrics as jmetrics
for kind, name, labels in {shared!r}:
    t = getattr(tmetrics, kind)(name, labelnames=labels)
    j = getattr(jmetrics, kind)(name, labelnames=labels)
    assert t is not j
tmetrics.counter("tpu.queue.shed").inc(2)
assert tmetrics.read("tpu.queue.shed") == 2.0
assert jmetrics.read("tpu.queue.shed") == 0.0
print("REVERSE-OK")
"""


def test_same_names_port_first_in_a_fresh_process():
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        [sys.executable, "-c",
         _REVERSE_ORDER.format(root=str(ROOT), shared=SHARED)],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "REVERSE-OK" in res.stdout


def test_port_never_touches_the_default_registry():
    tmetrics.counter("torch.registry.probe").inc()
    jmetrics.counter("jax.registry.probe").inc()
    default_names = set(prometheus_client.REGISTRY._names_to_collectors)
    port_names = set(tmetrics.PROM_REGISTRY._names_to_collectors)
    assert "torch_registry_probe_total" in port_names
    assert "torch_registry_probe_total" not in default_names
    assert "jax_registry_probe_total" in default_names
    assert "jax_registry_probe_total" not in port_names
    # every collector of the port's facade is in its own registry only
    for kind, name in tmetrics.registered():
        metric = tmetrics._REGISTRY[f"{kind}:{name}"]
        assert metric in tmetrics.PROM_REGISTRY._collector_to_names
        assert metric not in prometheus_client.REGISTRY._collector_to_names


def test_port_exposition_renders_only_port_families():
    tmetrics.counter("tpu.queue.shed").inc()
    jmetrics.counter("jax.only.family").inc()
    text = tmetrics.render_exposition()
    assert "tpu_queue_shed_total" in text
    assert "jax_only_family" not in text
    assert text.rstrip().endswith("# EOF")
    families = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}
    assert families == {tmetrics._sanitize(n) for _, n in tmetrics.registered()}
    scraped = prometheus_client.generate_latest(tmetrics.PROM_REGISTRY).decode()
    assert "tpu_queue_shed_total" in scraped
    assert "jax_only_family" not in scraped


_NOOP_SCRIPT = """
import importlib.abc, sys
sys.path.insert(0, {root!r})

class _BlockPrometheus(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path, target=None):
        if fullname.split(".")[0] == "prometheus_client":
            raise ImportError("prometheus_client blocked for no-op test")
        return None

sys.meta_path.insert(0, _BlockPrometheus())

from cpzk_tpu_torch.server import metrics

assert metrics.HAVE_PROMETHEUS is False and metrics.PROM_REGISTRY is None
c = metrics.counter("tpu.queue.shed")
c.inc()
c.inc(2)
assert metrics.read("tpu.queue.shed") == 3.0
h = metrics.histogram("tpu.batch.device_time", labelnames=("backend",))
h.labels(backend="primary").observe(0.25)
h.labels(backend="primary").observe(0.75)
assert metrics.read_histogram(
    "tpu.batch.device_time", labels={{"backend": "primary"}}) == (2.0, 1.0)
metrics.gauge("tpu.queue.depth").set(7)
assert metrics.read("tpu.queue.depth", "g") == 7.0
assert metrics.start_exporter("127.0.0.1", 0) is False

from cpzk_tpu_torch.observability import flightrec

rec = flightrec.get_flight_recorder()
rec.note_device_interval(1.0, 1.5)
rec.note_device_interval(2.0, 2.25)
assert metrics.read_histogram("tpu.dispatch.gap") == (2.0, 0.5)
text = metrics.render_exposition()
for _kind, name in metrics.registered():
    assert metrics._sanitize(name) in text, name
assert "tpu_queue_shed_total 3.0" in text
print("NOOP-OK")
"""


def test_port_facade_without_prometheus_client():
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run(
        [sys.executable, "-c", _NOOP_SCRIPT.format(root=str(ROOT))],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "NOOP-OK" in res.stdout
