"""Fast fuzz smoke of the port: bounded runs of port-owned copies of the
reference's ``fuzz/`` targets (``tests/torch_fuzz/``), each driving
``cpzk_tpu_torch``, at ``tests/test_fuzz_smoke.py``'s run counts.

Uses the harness's built-in seeded mutation engine via
``common.run_bounded`` (deterministic; Atheris, when installed, is
deliberately bypassed because it ignores bounds).  The proof-log and
partition-map targets hold the audit pipeline's parse-and-fold layer and
the partition map's parse and routing totality, the WAL-replay target the
log's frame parse, boot replay and segmented delivery into the standby's
``SegmentApplier`` (duplicated, reordered, truncated, tampered and
cross-epoch segments), the lint target that the port's analyser never
raises on any source; the other four the proof codec, statement
validation, admission and the request-wire parser.
"""

import importlib.util
import os
import sys

import pytest

FUZZ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fuzz")


def _load(name: str):
    if FUZZ_DIR not in sys.path:
        sys.path.insert(0, FUZZ_DIR)  # targets do `from common import ...`
    spec = importlib.util.spec_from_file_location(
        f"torch_fuzz_{name}", os.path.join(FUZZ_DIR, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "target,runs",
    [
        ("fuzz_proof_deserialization", 120),
        ("fuzz_statement_validation", 400),
        ("fuzz_admission", 400),
        ("fuzz_audit_log", 400),
        ("fuzz_partition_map", 400),
        ("fuzz_wire_parse", 400),
        ("fuzz_wal_replay", 300),
        ("fuzz_lint", 150),
    ],
)
def test_fuzz_target_smoke(target, runs):
    common = _load("common")
    mod = _load(target)
    done = common.run_bounded(mod.one_input, mod._seeds(), runs=runs, seed=1234)
    assert done == runs  # raises on the first invariant violation
