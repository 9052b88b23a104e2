"""The explicit-state model checker on the port: the twin of
``tests/test_model_checker.py`` (``cpzk_tpu_torch.analysis.model``).

The reference's three legs run against the port's checker:

- the three protocol models run clean **to exhaustion**, fast enough for
  tier-1;
- **validation by mutation**: ``drop_write_fence`` (the live-split bug)
  and ``serve_fenced_challenges`` (the handover bug) each give a
  readable counterexample and a nonzero CLI exit;
- the **crash-point drift guard** on the port's own ``FaultPlan``
  registries (``cpzk_tpu_torch/resilience/faults.py``): every point is
  (a) scheduled by some port test (``tests/test_torch_*.py``) and (b)
  explored as a ``crash:<point>`` transition by its model.

Beside them, a parity leg: for each model, clean and under each of its
mutations, the port's checker and the reference's report the same
states, transitions, depth, transition labels and verdict.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from cpzk_tpu_torch.analysis.model import (
    MODELS,
    FailoverModel,
    HandoverModel,
    SplitModel,
    check,
    main,
    render_trace,
)
from cpzk_tpu_torch.resilience.faults import (
    ALL_CRASH_POINTS,
    FLEET_CRASH_POINTS,
    HANDOVER_CRASH_POINTS,
    REPLICATION_CRASH_POINTS,
    WAL_CRASH_POINTS,
)

TESTS_DIR = Path(__file__).resolve().parent

#: registry-name indirection the drift guard understands: a parametrize
#: over one of these names schedules every point in the tuple.
_REGISTRY_NAMES = {
    "WAL_CRASH_POINTS": WAL_CRASH_POINTS,
    "REPLICATION_CRASH_POINTS": REPLICATION_CRASH_POINTS,
    "FLEET_CRASH_POINTS": FLEET_CRASH_POINTS,
    "SPLIT_CRASH_POINTS": FLEET_CRASH_POINTS,  # fleet.split re-export
    "HANDOVER_CRASH_POINTS": HANDOVER_CRASH_POINTS,
    "ALL_CRASH_POINTS": ALL_CRASH_POINTS,
}


@pytest.fixture(scope="module")
def clean_results():
    return {name: check(cls()) for name, cls in MODELS.items()}


class TestCleanModels:
    def test_all_models_exhaustive_and_clean(self, clean_results):
        for name, result in clean_results.items():
            assert result.violation is None, (
                f"model {name} found a violation in the UNMUTATED "
                f"protocol:\n{render_trace(result)}"
            )
            assert result.complete, (
                f"model {name} hit the exploration bounds before "
                "exhausting its state space — the clean verdict would "
                "only cover a prefix of the reachable states"
            )

    def test_state_spaces_stay_ci_sized(self, clean_results):
        # the CI model-smoke leg budgets 60s for all three models plus
        # both mutations; keep each space small enough that a 100x
        # regression would still fit
        for name, result in clean_results.items():
            assert result.states < 50_000, (
                f"model {name} exploded to {result.states} states"
            )

    def test_models_nontrivial(self, clean_results):
        # a model that collapses to a handful of states is not checking
        # interleavings; each protocol has concurrency worth exploring
        for name, result in clean_results.items():
            assert result.states > 20, (
                f"model {name} explored only {result.states} states — "
                "the interleaving structure degenerated"
            )

    def test_clean_render_mentions_exhaustion(self, clean_results):
        text = render_trace(clean_results["split"])
        assert "no counterexample" in text
        assert "invariants hold" in text


class TestMutationValidation:
    """The checker must catch the two bugs the robustness PRs fixed —
    otherwise a clean verdict means nothing."""

    def test_split_drop_write_fence_reproduces_the_live_split_bug(self):
        result = check(SplitModel(mutation="drop_write_fence"))
        v = result.violation
        assert v is not None, (
            "dropping the write-time owner fence must lose an acked "
            "write to the split — the checker missed the live-split bug"
        )
        assert v.invariant in ("acked-on-owner", "no-acked-write-loss")
        labels = [label for label, _ in v.trace]
        # the canonical interleaving: ownership checked, handler parked
        # in the batcher await, the split cuts underneath it, the
        # unfenced mint acks onto the source's stale copy
        assert "split:cut" in labels
        assert "handler:mint_unfenced" in labels
        assert labels.index("split:cut") < labels.index(
            "handler:mint_unfenced"
        )

    def test_handover_serve_fenced_challenges_reproduces_the_handover_bug(self):
        result = check(HandoverModel(mutation="serve_fenced_challenges"))
        v = result.violation
        assert v is not None, (
            "a fenced primary minting challenges locally must strand a "
            "login — the checker missed the handover bug"
        )
        assert v.invariant == "no-stranded-login"
        labels = [label for label, _ in v.trace]
        assert "handover:fence" in labels
        assert "client:mint_on_fenced" in labels

    def test_counterexample_trace_is_readable(self):
        result = check(SplitModel(mutation="drop_write_fence"))
        text = render_trace(result)
        assert "counterexample" in text
        assert "mutation: drop_write_fence" in text
        assert "step 0: initial" in text
        assert "step 1:" in text
        assert "violated: " in text
        # every step after the initial shows only the state delta
        assert "-> " in text

    def test_counterexample_is_shortest(self):
        # BFS order: no strict prefix of the returned trace violates
        result = check(SplitModel(mutation="drop_write_fence"))
        model = result.model
        invs = model.invariants()
        for _, frozen in result.violation.trace[:-1]:
            state = dict(frozen)
            assert all(pred(state) for _, pred in invs)

    def test_unknown_mutation_is_rejected(self):
        with pytest.raises(ValueError, match="no mutation"):
            SplitModel(mutation="drop_the_other_thing")
        with pytest.raises(ValueError, match="no mutation"):
            FailoverModel(mutation="drop_write_fence")


class TestCli:
    def test_clean_run_exits_zero(self, capsys):
        assert main(["--quiet"]) == 0

    def test_violation_exits_nonzero(self, capsys):
        rc = main(["--model", "split", "--mutate", "drop_write_fence"])
        assert rc == 1
        out = capsys.readouterr().out
        assert "counterexample" in out

    def test_expect_violation_inverts(self, capsys):
        assert main([
            "--model", "split", "--mutate", "drop_write_fence",
            "--expect-violation",
        ]) == 0
        assert main([
            "--model", "handover", "--mutate", "serve_fenced_challenges",
            "--expect-violation",
        ]) == 0
        # a clean model under --expect-violation is a FAILURE: the
        # mutation-validation leg must never silently pass
        assert main(["--model", "failover", "--expect-violation"]) == 1

    def test_mutate_requires_single_model(self, capsys):
        assert main(["--mutate", "drop_write_fence"]) == 2

    def test_unknown_mutation_exits_usage(self, capsys):
        assert main(["--model", "split", "--mutate", "nope"]) == 2

    def test_list_inventories_models(self, capsys):
        assert main(["--list"]) == 0
        out = capsys.readouterr().out
        for name in MODELS:
            assert name in out
        assert "drop_write_fence" in out
        assert "serve_fenced_challenges" in out


# -- the crash-point drift guard ---------------------------------------------


def _scheduled_crash_points() -> set[str]:
    """Every crash point some test in tests/ schedules: literal
    ``crash_on("<point>")`` args, string literals inside
    ``pytest.mark.parametrize`` argvalue lists (including tuple-valued
    rows), and registry-name indirection (``parametrize("point",
    SPLIT_CRASH_POINTS)``)."""
    known = set(ALL_CRASH_POINTS)
    scheduled: set[str] = set()

    def strings_in(node: ast.AST):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                yield sub.value

    for path in sorted(TESTS_DIR.glob("test_torch_*.py")):
        tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None
            )
            if name == "crash_on" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    scheduled.add(arg.value)
            elif name == "parametrize" and len(node.args) >= 2:
                argvalues = node.args[1]
                if isinstance(argvalues, ast.Name):
                    scheduled.update(
                        _REGISTRY_NAMES.get(argvalues.id, ())
                    )
                elif isinstance(argvalues, ast.Attribute):
                    # ``REF.SPLIT_CRASH_POINTS``: the port's twins name a
                    # registry through the package they run on
                    scheduled.update(
                        _REGISTRY_NAMES.get(argvalues.attr, ())
                    )
                else:
                    scheduled.update(
                        v for v in strings_in(argvalues) if v in known
                    )
    return scheduled


class TestCrashPointDriftGuard:
    """A crash point that exists in a FaultPlan registry but is never
    exercised is a hole in the chaos matrix AND in the model — this
    guard fails with the point's name so the drift is obvious."""

    REGISTRIES = [
        ("REPLICATION_CRASH_POINTS", REPLICATION_CRASH_POINTS, "failover"),
        ("FLEET_CRASH_POINTS", FLEET_CRASH_POINTS, "split"),
        ("HANDOVER_CRASH_POINTS", HANDOVER_CRASH_POINTS, "handover"),
    ]

    def test_every_registry_point_is_scheduled_by_a_test(self):
        scheduled = _scheduled_crash_points()
        missing = [
            f"{reg_name}:{point}"
            for reg_name, registry, _ in self.REGISTRIES
            for point in registry
            if point not in scheduled
        ]
        assert not missing, (
            "crash points registered in cpzk_tpu_torch.resilience.faults but "
            f"never scheduled by any test in tests/: {missing} — add a "
            "crash_on()/parametrize leg exercising each, or remove the "
            "registry entry"
        )

    def test_every_registry_point_is_explored_by_its_model(
        self, clean_results
    ):
        missing = []
        for reg_name, registry, model_name in self.REGISTRIES:
            labels = clean_results[model_name].labels
            for point in registry:
                if f"crash:{point}" not in labels:
                    missing.append(f"{reg_name}:{point} (model {model_name})")
        assert not missing, (
            "crash points never explored as a crash:<point> transition "
            f"by their protocol model: {missing} — teach "
            "cpzk_tpu_torch/analysis/model.py the failure, or remove the "
            "registry entry"
        )

    def test_models_declare_their_registries_verbatim(self):
        # the model's crash_points attribute IS the registry object —
        # adding a point to the registry automatically widens what the
        # two checks above demand
        assert FailoverModel.crash_points == REPLICATION_CRASH_POINTS
        assert SplitModel.crash_points == FLEET_CRASH_POINTS
        assert HandoverModel.crash_points == HANDOVER_CRASH_POINTS

    def test_guard_actually_detects_drift(self):
        # sanity: the scanner sees the literal/indirect schedules that
        # exist today; an empty scan would make the guard vacuous
        scheduled = _scheduled_crash_points()
        assert "pre_handover_ack" in scheduled     # literal crash_on
        assert "pre_flip" in scheduled             # SPLIT_CRASH_POINTS name
        assert "mid_segment" in scheduled          # tuple-valued parametrize


# -- the port against the reference ------------------------------------------


def _runs():
    return [(name, None) for name in sorted(MODELS)] + [
        (name, mutation) for name in sorted(MODELS)
        for mutation in sorted(MODELS[name].mutations)]


class TestParityWithTheReference:
    @pytest.mark.parametrize("name,mutation", _runs())
    def test_same_exploration_and_verdict(self, name, mutation):
        from cpzk_tpu.analysis import model as reference

        port = check(MODELS[name](mutation=mutation))
        ref = reference.check(reference.MODELS[name](mutation=mutation))
        assert (port.states, port.transitions, port.depth, port.complete) == (
            ref.states, ref.transitions, ref.depth, ref.complete)
        assert port.labels == ref.labels
        if ref.violation is None:
            assert port.violation is None
        else:
            assert port.violation is not None
            assert port.violation.invariant == ref.violation.invariant
            assert [label for label, _ in port.violation.trace] == [
                label for label, _ in ref.violation.trace]
        assert MODELS[name].crash_points == reference.MODELS[name].crash_points

    def test_cli_runs_as_a_module(self):
        """``python -m cpzk_tpu_torch.analysis.model`` exits 0 clean, and
        a mutation exits 1 (0 under ``--expect-violation``)."""
        import subprocess
        import sys

        root = TESTS_DIR.parent

        def run(*argv):
            return subprocess.run(
                [sys.executable, "-m", "cpzk_tpu_torch.analysis.model", *argv],
                capture_output=True, text=True, cwd=root, timeout=120)

        clean = run()
        assert clean.returncode == 0, clean.stdout + clean.stderr
        assert clean.stdout.count("exhaustive, invariants hold") == len(MODELS)
        mutated = run("--model", "handover", "--mutate", "serve_fenced_challenges")
        assert mutated.returncode == 1 and "counterexample" in mutated.stdout
        assert run("--model", "handover", "--mutate", "serve_fenced_challenges",
                   "--expect-violation").returncode == 0
