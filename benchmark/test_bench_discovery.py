"""Cells, configurations, mixes and metrics are found by name from files;
a cell added in a copy from new files alone is found and reported; and
``BENCHMARK.json`` keeps to the shape its runs rely on."""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return harness.Bench(ROOT)


def test_every_cell_finds_its_files(bench):
    for w in bench.spec["workloads"]:
        config = bench.config(w["config"])
        traffic = bench.traffic(w["traffic"])
        assert callable(bench.driver(config["entry"]).run)
        assert traffic["kind"]
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics_of(w["name"], kind):
                assert callable(bench.reader(m["name"]))


def test_benchmark_json_shape(bench):
    spec = bench.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in spec["configs"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        reported = bench.metrics_of(w["name"], "end_to_end")
        assert {"setup_s"} < {m["name"] for m in reported}
        assert bench.metrics_of(w["name"], "per_layer")
    for m in spec["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in bench.metrics_of(w, "end_to_end")}


DUMMY_DRIVER = '''
from benchmark.harness import check


def run(config, traffic, seed, seconds, trace, chips, options):
    return {"correct": True, "attempted": traffic["requests"], "failed": 0,
            "device": {"memory_peak_bytes": 0},
            "record": {"setup_s": 1.5, "answer": config["answer"] * seed},
            "compared": {"wrong": check(0, "<=", 0)}}
'''


def test_a_cell_added_from_new_files_is_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    d = root / "benchmark"
    (d / "configs" / "dummy.json").write_text(json.dumps({"entry": "dummy", "answer": 2}))
    (d / "traffic" / "steady.json").write_text(json.dumps({"kind": "dummy", "requests": 7}))
    (d / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (d / "metrics" / "answer_s.dummy.py").write_text(
        "def read(run):\n    return run['record'].get('answer')\n")
    spec["configs"].append({"name": "dummy", "source": "https://example.org/dummy",
                            "file": "benchmark/configs/dummy.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy.steady", "config": "dummy", "traffic": "steady",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "answer_s.dummy", "unit": "s", "better": "lower",
                               "bound": 0.1, "source": "host_clock", "workloads": ["dummy.steady"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    w = bench.workload("dummy.steady")
    config = bench.config(w["config"])
    run = bench.driver(config["entry"]).run(config, bench.traffic(w["traffic"]), 21, 1.0, False, 1, {})
    run["device"] = {"platform": "gpu", **run["device"]}
    line = harness.result_line(bench, "dummy.steady", False, run)
    assert line["metrics"] == {"answer_s.dummy": {"value": 42, "unit": "s"},
                               "setup_s": {"value": 1.5, "unit": "s"}}
    assert line["attempted"] == 7 and list(line)[-1] == "compared"
