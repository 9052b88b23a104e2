"""Nothing the harness or the reference loads is JAX or the package the
program was ported from; the reference loads nothing of the program."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cpzk_tpu"}

REFERENCE_ONLY = """
import sys
import benchmark.reference.group, benchmark.reference.merlin, benchmark.reference.proofs
import benchmark.reference.vecfield, benchmark.yardstick.roofline, benchmark.yardstick.stats
from benchmark.reference import proofs
pop = proofs.population(3, 2, "cpu")
proofs.make_batch(pop, 3, 0, 32)
print(sorted({m.split('.', 1)[0] for m in sys.modules}))
"""

WHOLE_RUN = """
import sys
from benchmark import harness, run
from benchmark.drivers import loadgen, population, wire
from cpzk_tpu_torch.ops.backend import TorchBackend
b = harness.Bench()
w = b.workload("bulk_verify.valid64k")
cfg = b.config(w["config"])
for m in b.spec["end_to_end"] + b.spec["per_layer"]:
    b.reader(m["name"])
b.driver("daemon")
res = b.driver(cfg["entry"]).run(cfg, b.traffic(w["traffic"]), 5, 0.0, False, 1,
    {"age": harness.process_age_s, "device": "cpu", "rows": 2,
     "backend": TorchBackend(device="cpu")})
assert res["correct"], res["compared"]
print(sorted({m.split('.', 1)[0] for m in sys.modules}))
"""


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    tops = _tops(REFERENCE_ONLY)
    assert not tops & (FORBIDDEN | {"cpzk_tpu_torch"})


def test_a_whole_run_loads_no_jax():
    tops = _tops(WHOLE_RUN)
    assert "cpzk_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_run_checks_the_same_names():
    from benchmark import harness

    assert set(harness.FORBIDDEN_MODULES) == FORBIDDEN
