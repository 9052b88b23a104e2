"""RPC and serving-plane metrics: counters, gauges, and duration histograms
with Prometheus export.

A copy of ``cpzk_tpu/server/metrics.py`` with one difference: every
``prometheus_client`` metric is created in :data:`PROM_REGISTRY`, a
``CollectorRegistry`` of this package's own, never in the library's
process-wide default registry.  The JAX package creates its metrics of the
same names (``tpu.queue.shed``, ``tpu.batch.latency``, ...) in the default
registry; with one registry each, both packages can live in one process
(a test worker, a bench) without a "Duplicated timeseries" error, and
neither reads the other's counts.

Metric names are the reference's, letter for letter (dots become
underscores in the Prometheus exposition), so one dashboard serves either
package.  Without ``prometheus_client`` the facade is backed by inert
stand-ins that still count, so :func:`read` / :func:`read_histogram`
return the same numbers against either backing.

- **labels**: ``counter(name, labelnames=("rpc", "outcome"))`` returns a
  labeled family; call ``.labels(rpc=..., outcome=...)`` for a child.
- **histogram reads**: ``read(name, "h")`` returns the observation sum
  and :func:`read_histogram` returns ``(count, sum)``.
- **buckets**: histogram buckets default to a schedule from sub-ms host
  stages to multi-second outliers, overridable per histogram or
  process-wide via :func:`set_default_buckets`.
- **introspection**: :func:`registered` lists (kind, name) pairs.
"""

from __future__ import annotations

try:
    from prometheus_client import CollectorRegistry as _PCollectorRegistry
    from prometheus_client import Counter as _PCounter
    from prometheus_client import Gauge as _PGauge
    from prometheus_client import Histogram as _PHistogram
    from prometheus_client import start_http_server as _start_http_server

    HAVE_PROMETHEUS = True
except ImportError:  # pragma: no cover
    HAVE_PROMETHEUS = False

_REGISTRY: dict[str, object] = {}

#: The port's own Prometheus registry: every metric of this facade lives
#: here, and the exposition endpoint serves only it.
PROM_REGISTRY = _PCollectorRegistry() if HAVE_PROMETHEUS else None

#: Histogram bucket upper bounds (seconds): 100 us resolution through the
#: host stages, ms resolution through device dispatch, a coarse tail for
#: outliers (the reference's schedule, kept so dashboards line up).
DEFAULT_LATENCY_BUCKETS: tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

_default_buckets: tuple[float, ...] = DEFAULT_LATENCY_BUCKETS


def set_default_buckets(buckets) -> None:
    """Process-wide default for histograms created AFTER this call (the
    ``observability.latency_buckets_ms`` config knob resolves here)."""
    global _default_buckets
    _default_buckets = tuple(sorted(float(b) for b in buckets))


def _sanitize(name: str) -> str:
    return name.replace(".", "_")


class _Cell:
    """Minimal value holder mirroring prometheus_client's ``_value`` API so
    :func:`read` works identically against either backing."""

    def __init__(self) -> None:
        self._v = 0.0

    def get(self) -> float:
        return self._v


class _NoopMetric:
    """Stand-in without prometheus_client: no exposition endpoint, but
    counts, gauge values, histogram observation count/sum, AND labeled
    children are all tracked, so :func:`read` / :func:`read_histogram`
    (status surfaces, chaos and observability tests) see identical numbers
    either way."""

    def __init__(self, labelnames: tuple[str, ...] = ()) -> None:
        self._labelnames = tuple(labelnames)
        self._children: dict[tuple, "_NoopMetric"] = {}
        self._value = _Cell()
        self._sum = _Cell()
        self._count = _Cell()

    def labels(self, *labelvalues, **labelkwargs) -> "_NoopMetric":
        if labelkwargs:
            key = tuple(str(labelkwargs[k]) for k in self._labelnames)
        else:
            key = tuple(str(v) for v in labelvalues)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _NoopMetric()
        return child

    def inc(self, amount: float = 1.0) -> None:
        self._value._v += amount

    def observe(self, value: float) -> None:
        # count/sum accumulate exactly like a real histogram child, so the
        # no-prometheus backing is observably equivalent
        self._count._v += 1.0
        self._sum._v += float(value)

    def set(self, value: float) -> None:
        self._value._v = float(value)


def counter(name: str, labelnames: tuple[str, ...] = ()):
    """A counter; with ``labelnames`` the result is a labeled family — use ``.labels(...)`` for children."""
    key = "c:" + name
    if key not in _REGISTRY:
        if HAVE_PROMETHEUS:
            _REGISTRY[key] = _PCounter(
                _sanitize(name), f"counter {name}", tuple(labelnames),
                registry=PROM_REGISTRY,
            )
        else:
            _REGISTRY[key] = _NoopMetric(tuple(labelnames))
    return _REGISTRY[key]


def histogram(
    name: str,
    labelnames: tuple[str, ...] = (),
    buckets: tuple[float, ...] | None = None,
):
    """A histogram.  ``buckets`` overrides
    the process default (see :func:`set_default_buckets`) at creation
    time; both are ignored on the no-prometheus backing, which tracks
    count/sum only."""
    key = "h:" + name
    if key not in _REGISTRY:
        if HAVE_PROMETHEUS:
            bounds = tuple(buckets if buckets is not None else _default_buckets)
            if not bounds or bounds[-1] != float("inf"):
                bounds = bounds + (float("inf"),)
            _REGISTRY[key] = _PHistogram(
                _sanitize(name),
                f"histogram {name}",
                tuple(labelnames),
                buckets=bounds,
                registry=PROM_REGISTRY,
            )
        else:
            _REGISTRY[key] = _NoopMetric(tuple(labelnames))
    return _REGISTRY[key]


def gauge(name: str, labelnames: tuple[str, ...] = ()):
    """Serving gauges (queue depth, batch fill ratio, breaker state, ...)."""
    key = "g:" + name
    if key not in _REGISTRY:
        if HAVE_PROMETHEUS:
            _REGISTRY[key] = _PGauge(
                _sanitize(name), f"gauge {name}", tuple(labelnames),
                registry=PROM_REGISTRY,
            )
        else:
            _REGISTRY[key] = _NoopMetric(tuple(labelnames))
    return _REGISTRY[key]


def _hist_count_sum(metric) -> tuple[float, float]:
    """(observation count, value sum) of a histogram child on either
    backing."""
    buckets = getattr(metric, "_buckets", None)
    if buckets is not None:  # prometheus_client backing
        return (
            float(sum(b.get() for b in buckets)),
            float(metric._sum.get()),
        )
    return float(metric._count.get()), float(metric._sum.get())


def _resolve(name: str, kind: str, labels: dict | None):
    metric = _REGISTRY.get(f"{kind}:{name}")
    if metric is not None and labels:
        try:
            metric = metric.labels(**labels)
        except Exception:  # unknown label set: treated as never-touched
            return None
    return metric


def read(name: str, kind: str = "c", labels: dict | None = None) -> float:
    """Current value of a counter (``kind="c"``), gauge (``"g"``), or
    histogram (``"h"`` — the observation SUM, so duration totals are
    assertable) — 0.0 when the metric was never touched.  ``labels``
    selects a child of a labeled family.  In-process observability seam
    for status surfaces and the test suites; Prometheus exposition remains
    the operator surface."""
    metric = _resolve(name, kind, labels)
    if metric is None:
        return 0.0
    if kind == "h":
        return _hist_count_sum(metric)[1]
    try:
        return float(metric._value.get())  # type: ignore[union-attr]
    except AttributeError:  # pragma: no cover - unexpected backing object
        return 0.0


def read_histogram(
    name: str, labels: dict | None = None
) -> tuple[float, float]:
    """(observation count, value sum) of a histogram — (0.0, 0.0) when
    never touched.  Identical on both backings."""
    metric = _resolve(name, "h", labels)
    if metric is None:
        return (0.0, 0.0)
    return _hist_count_sum(metric)


def registered() -> list[tuple[str, str]]:
    """Sorted (kind, name) pairs of every metric created so far — the
    seam the CI drift guard uses to cross-check the docs inventory."""
    out = []
    for key in _REGISTRY:
        kind, _, name = key.partition(":")
        out.append((kind, name))
    return sorted(out)


def start_exporter(host: str, port: int) -> bool:
    """Serve the Prometheus scrape endpoint for :data:`PROM_REGISTRY` (this
    package's metrics only).

    Returns False when prometheus_client is unavailable, so the caller can
    serve :func:`render_exposition` another way (and say so) rather than
    leave a configured metrics port with no listener.
    """
    if not HAVE_PROMETHEUS:
        return False
    _start_http_server(port, addr=host, registry=PROM_REGISTRY)
    return True


# -- text exposition ------------------------------------------------------------


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_sample(name: str, labels: dict, value: float) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
        )
        return f"{name}{{{body}}} {value}"
    return f"{name} {value}"


def _noop_samples(kind: str, name: str, child: "_NoopMetric",
                  labels: dict) -> list[str]:
    if kind == "c":
        return [_format_sample(name + "_total", labels, child._value.get())]
    if kind == "g":
        return [_format_sample(name, labels, child._value.get())]
    count, total = child._count.get(), child._sum.get()
    return [
        _format_sample(
            name + "_bucket", {**labels, "le": "+Inf"}, count
        ),
        _format_sample(name + "_count", labels, count),
        _format_sample(name + "_sum", labels, total),
    ]


def render_exposition() -> str:
    """Prometheus/OpenMetrics-style text exposition rendered from THIS
    facade's registry, on either backing.

    With ``prometheus_client`` present, each metric's own ``collect()``
    supplies the samples (full bucket vectors included); without it, the
    no-op backing renders the counts/gauges/histogram count+sum it
    already tracks — so the family set is identical either way.  Only
    this package's metrics appear, never the JAX package's."""
    lines: list[str] = []
    for key in sorted(_REGISTRY, key=lambda k: k.partition(":")[2]):
        kind, _, name = key.partition(":")
        metric = _REGISTRY[key]
        sname = _sanitize(name)
        kind_word = {"c": "counter", "g": "gauge", "h": "histogram"}[kind]
        lines.append(f"# HELP {sname} {kind_word} {name}")
        lines.append(f"# TYPE {sname} {kind_word}")
        if HAVE_PROMETHEUS:
            for family in metric.collect():  # type: ignore[attr-defined]
                for s in family.samples:
                    lines.append(
                        _format_sample(s.name, dict(s.labels), s.value)
                    )
        else:
            noop: _NoopMetric = metric  # type: ignore[assignment]
            if noop._labelnames:
                for key_values, child in sorted(noop._children.items()):
                    labels = dict(
                        zip(noop._labelnames, key_values, strict=True)
                    )
                    lines.extend(_noop_samples(kind, sname, child, labels))
            else:
                lines.extend(_noop_samples(kind, sname, noop, {}))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
