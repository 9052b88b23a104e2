"""Twins of ``tests/test_flightrec.py``'s perf-gate cases for the port:
``cpzk_tpu_torch/observability/perf.py`` (``compare_entries``, the
snapshot files) and the CLI ``python -m
cpzk_tpu_torch.observability.regress OLD NEW``, whose exit codes and JSON
report equal the reference's CLI on the same snapshot files.
"""

import json
import subprocess
import sys
from pathlib import Path

from cpzk_tpu.observability.regress import main as j_regress_main
from cpzk_tpu_torch.observability.perf import (
    PerfEntry,
    compare_entries,
    load_snapshot,
    write_snapshot,
)
from cpzk_tpu_torch.observability.regress import main as regress_main

ROOT = Path(__file__).resolve().parent.parent


def _entry(name="batch_e2e", backend="cpu", n=50, value=10.0, unit="ms/batch", spread=0.0):
    return PerfEntry(name=name, backend=backend, n=n, value=value, unit=unit, spread=spread)


def test_regress_identical_passes_and_degraded_flags():
    base = [_entry(value=10.0), _entry(name="other", value=5.0)]
    same = compare_entries(base, [_entry(value=10.0), _entry(name="other", value=5.0)])
    assert same["passed"] and same["compared"] == 2
    degraded = compare_entries(base, [_entry(value=20.0), _entry(name="other", value=5.0)])
    assert not degraded["passed"]
    assert [d.key[0] for d in degraded["regressions"]] == ["batch_e2e"]


def test_regress_direction_per_unit():
    assert compare_entries([_entry(unit="proofs/s", value=100.0)],
                           [_entry(unit="proofs/s", value=300.0)])["passed"]
    assert not compare_entries([_entry(unit="proofs/s", value=100.0)],
                               [_entry(unit="proofs/s", value=50.0)])["passed"]
    assert compare_entries([_entry(value=100.0)], [_entry(value=50.0)])["passed"]


def test_regress_noise_widens_but_never_disables_gate():
    new = [_entry(value=14.0)]
    assert not compare_entries([_entry(value=10.0, spread=0.0)], new, threshold=0.35)["passed"]
    assert compare_entries([_entry(value=10.0, spread=2.0)], new, threshold=0.35)["passed"]
    assert not compare_entries([_entry(value=10.0, spread=100.0)], [_entry(value=30.0)],
                               threshold=0.35)["passed"]


def test_regress_added_removed_configs_do_not_gate():
    report = compare_entries([_entry()], [_entry(name="brand-new")])
    assert report["passed"] and report["compared"] == 0
    assert report["only_old"] and report["only_new"]


def test_regress_cli_exit_codes(tmp_path, capsys):
    """Exit codes 0 / 1 / 2 as the reference's CLI gives them, the same
    JSON report, and the module runs as ``python -m``."""
    old = tmp_path / "old.json"
    write_snapshot(str(old), [_entry(value=10.0)])
    new_same = tmp_path / "same.json"
    write_snapshot(str(new_same), [_entry(value=10.0)])
    new_bad = tmp_path / "bad.json"
    write_snapshot(str(new_bad), [_entry(value=99.0)])
    junk = tmp_path / "junk.json"
    junk.write_text('{"schema": "something-else", "entries": []}')
    cases = [
        ([str(old), str(new_same)], 0),
        ([str(old), str(new_bad)], 1),
        ([str(old), str(new_bad), "--json"], 1),
        ([str(tmp_path / "missing.json"), str(old)], 2),
        ([str(old), str(new_same), "--threshold", "99"], 2),
        ([str(junk), str(old)], 2),
    ]
    for argv, rc in cases:
        assert regress_main(argv) == rc, argv
        port_out = capsys.readouterr().out
        assert j_regress_main(argv) == rc, argv
        assert port_out == capsys.readouterr().out, argv
    assert load_snapshot(str(old))[0].value == 10.0
    regress_main([str(old), str(new_bad), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["passed"] is False and doc["regressions"][0]["new"] == 99.0
    done = subprocess.run([sys.executable, "-m", "cpzk_tpu_torch.observability.regress",
                           str(old), str(new_bad)], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 1, done.stderr
