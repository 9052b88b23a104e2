"""PerfSnapshot: a stable JSON schema for benchmark results + the
noise-aware comparator behind a perf-regression gate.

A copy of ``cpzk_tpu/observability/perf.py``, so snapshots of either
package share one schema; the benchmark drivers that write them come with
the port's benchmark slice.  ``stage_percentiles`` lives in
:mod:`.flightrec` here and is re-exported.

An entry regresses only when it moved in the bad direction by more than
``threshold + relative spread of both runs`` — so a noisy bench widens its
own gate instead of flapping.

Schema (``cpzk-perf-snapshot/1``)::

    {"schema": "cpzk-perf-snapshot/1", "created_at": <unix>,
     "meta": {"platform": ..., ...},
     "entries": [{"name": "batch_e2e", "backend": "cpu", "n": 50,
                  "value": 1.94, "unit": "ms/batch", "spread": 0.11,
                  "stages_ms": {"execute": {"p50": ..., "p90": ...}}}]}

``unit`` decides the regression direction: ``proofs/s`` regresses when
it drops, ``ms/batch`` (and any other latency unit) when it rises.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

from .flightrec import PERCENTILES, stage_percentiles  # noqa: F401 (re-export)

SCHEMA = "cpzk-perf-snapshot/1"

#: Units where larger is better; every other unit (``ms``, ``bytes``, ...)
#: gates lower-is-better.
HIGHER_IS_BETTER = frozenset({"proofs/s", "users/s"})



@dataclass
class PerfEntry:
    """One measured configuration of one benchmark.

    ``lanes`` and ``wire`` are config-key components (the multi-chip
    serving plane's dispatch-lane count; the transport wire path,
    ``"python"`` = protobuf runtime, ``"native"`` = the C++ wire
    parser): entries measured at different values gate independently,
    and because absent keys never gate, the first snapshot carrying a
    new lane count or wire mode seeds its trajectory instead of failing
    CI.  Baselines written before a key existed load with its historical
    value (``lanes=1``, ``wire="python"``) — exactly the configuration
    they measured."""

    name: str
    backend: str
    n: int
    value: float
    unit: str
    spread: float = 0.0  # max-min over repeat runs, same unit as value
    lanes: int = 1
    wire: str = "python"
    stages_ms: dict[str, dict[str, float]] = field(default_factory=dict)

    def key(self) -> tuple[str, str, int, str, int, str]:
        return (self.name, self.backend, self.n, self.unit, self.lanes,
                self.wire)

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "backend": self.backend,
            "n": self.n,
            "value": self.value,
            "unit": self.unit,
            "spread": self.spread,
        }
        if self.lanes != 1:
            out["lanes"] = self.lanes
        if self.wire != "python":
            out["wire"] = self.wire
        if self.stages_ms:
            out["stages_ms"] = self.stages_ms
        return out

    @classmethod
    def from_dict(cls, data: dict) -> "PerfEntry":
        return cls(
            name=str(data["name"]),
            backend=str(data.get("backend", "cpu")),
            n=int(data.get("n", 0)),
            value=float(data["value"]),
            unit=str(data.get("unit", "ms/batch")),
            spread=max(0.0, float(data.get("spread", 0.0))),
            lanes=int(data.get("lanes", 1)),
            wire=str(data.get("wire", "python")),
            stages_ms=dict(data.get("stages_ms", {})),
        )


def build_snapshot(entries: list[PerfEntry], meta: dict | None = None) -> dict:
    return {
        "schema": SCHEMA,
        "created_at": time.time(),
        "meta": dict(meta or {}),
        "entries": [e.to_dict() for e in entries],
    }


def write_snapshot(
    path: str, entries: list[PerfEntry], meta: dict | None = None
) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(build_snapshot(entries, meta), f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_snapshot(path: str) -> list[PerfEntry]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if data.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: not a {SCHEMA} snapshot "
            f"(schema={data.get('schema')!r})"
        )
    return [PerfEntry.from_dict(e) for e in data.get("entries", [])]


# -- comparison ---------------------------------------------------------------


@dataclass
class Delta:
    """One compared entry: relative change, adjusted gate, verdict."""

    key: tuple[str, str, int, str, int, str]
    old: float
    new: float
    change: float      # relative move in the BAD direction (>0 = worse)
    limit: float       # threshold + noise allowance actually applied
    regressed: bool

    def describe(self) -> str:
        name, backend, n, unit, lanes, wire = self.key
        lane_tag = f"/lanes={lanes}" if lanes != 1 else ""
        wire_tag = f"/wire={wire}" if wire != "python" else ""
        arrow = "WORSE" if self.change > 0 else "better"
        return (
            f"{name}/{backend}/n={n}{lane_tag}{wire_tag}: "
            f"{self.old:g} -> {self.new:g} {unit} "
            f"({abs(self.change) * 100:.1f}% {arrow}, "
            f"gate {self.limit * 100:.1f}%)"
        )


def compare_entries(
    old: list[PerfEntry],
    new: list[PerfEntry],
    threshold: float = 0.35,
) -> dict:
    """Noise-aware snapshot comparison.

    For each key present in BOTH snapshots, the relative move in the bad
    direction (throughput down / latency up) is gated at ``threshold``
    plus the combined relative spread of the two runs (capped at 1x the
    threshold, so a pathologically noisy bench cannot disable its own
    gate entirely).  Keys present in only one snapshot are reported but
    never fail the gate — adding or retiring a bench config must not
    break CI."""
    old_by = {e.key(): e for e in old}
    new_by = {e.key(): e for e in new}
    deltas: list[Delta] = []
    for key in sorted(old_by.keys() & new_by.keys()):
        o, n_ = old_by[key], new_by[key]
        if o.value <= 0:
            continue
        raw = (n_.value - o.value) / o.value
        change = -raw if key[3] in HIGHER_IS_BETTER else raw
        noise = 0.0
        if o.value > 0:
            noise += o.spread / o.value
        if n_.value > 0:
            noise += n_.spread / n_.value
        limit = threshold + min(noise, threshold)
        deltas.append(
            Delta(
                key=key, old=o.value, new=n_.value,
                change=change, limit=limit, regressed=change > limit,
            )
        )
    regressions = [d for d in deltas if d.regressed]
    return {
        "compared": len(deltas),
        "regressions": regressions,
        "only_old": sorted(old_by.keys() - new_by.keys()),
        "only_new": sorted(new_by.keys() - old_by.keys()),
        "passed": not regressions,
        "deltas": deltas,
    }


def compare_files(old_path: str, new_path: str, threshold: float = 0.35) -> dict:
    return compare_entries(
        load_snapshot(old_path), load_snapshot(new_path), threshold
    )


def format_report(report: dict, threshold: float) -> str:
    lines = [
        f"perf gate: {report['compared']} configs compared "
        f"(base threshold {threshold * 100:.0f}%, noise-adjusted per entry)"
    ]
    for d in report["deltas"]:
        mark = "FAIL" if d.regressed else " ok "
        lines.append(f"  [{mark}] {d.describe()}")
    for key in report["only_old"]:
        lines.append(f"  [gone] {key} only in the baseline (not gated)")
    for key in report["only_new"]:
        lines.append(f"  [new ] {key} only in the new snapshot (not gated)")
    lines.append("PASS" if report["passed"] else "REGRESSION")
    return "\n".join(lines)
