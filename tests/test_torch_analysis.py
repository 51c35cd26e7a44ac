"""The port's static analysis (``repro_torch.analysis``,
``repro_torch.launch.lint``) against the JAX package's, on the CPU.

* The AST passes are a copy of the JAX package's: on every ``.py`` file
  of the repo the JAX lint walks (``src``, ``tests``, ``benchmarks``,
  ``examples``) and on ``chip_smoke.py`` both give the same kept and
  suppressed findings, and so do the inline fixtures of
  ``tests/test_analysis.py``.
* Each step pass fires on a hand-built bad :class:`StepLog` (or
  executor) and is quiet on the good one: an int8 ``all_reduce``, a
  host read, an fp64 tensor, a leaf rebound where it should be updated
  in place, a schedule that differs for one survivor set, a bf16 EF
  state.
* ``python -m repro_torch.launch.lint --json`` is byte-identical over
  two runs, and ``--assert-clean`` exits 1 on a planted violation.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis import lint_source as jax_lint_source
from repro_torch.analysis import (Report, Violation, donation_audit,
                                  hot_path_purity, lint_source,
                                  run_ast_passes,
                                  schedule_determinism_executor,
                                  wire_dtype_policy)
from repro_torch.analysis.core import iter_source_files
from repro_torch.analysis.step_passes import ef_state_policy
from repro_torch.core import SpareState
from repro_torch.launch.steplog import Collective, StepLog

from _step_cases import STEPS, findings

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """The steps here are tiny: on a loaded host torch's thread pool
    costs more than it gives (the pytest workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _findings(lint, path: str, src: str) -> tuple[list, list]:
    """``lint``'s (kept, suppressed) findings as plain dicts, so the two
    packages' ``Violation`` classes compare."""
    kept, quiet = lint(path, src)
    return [v.to_dict() for v in kept], [v.to_dict() for v in quiet]


def _repo_files():
    files = [ROOT / "chip_smoke.py"]
    for sub in ("src", "tests", "benchmarks", "examples"):
        files += (ROOT / sub).rglob("*.py")
    return sorted(files)


@pytest.mark.parametrize("path", _repo_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_ast_findings_equal_jax_on_every_file(path):
    rel, src = str(path.relative_to(ROOT)), path.read_text()
    assert _findings(lint_source, rel, src) == \
        _findings(jax_lint_source, rel, src)


#: the inline sources of tests/test_analysis.py's AST fixtures, and the
#: rules each must give
FIXTURES = {
    "wall-clock": ("import time\nt0 = time.time()\n", {"wall-clock"}),
    "datetime-now": ("from datetime import datetime\n"
                     "stamp = datetime.now()\n", {"wall-clock"}),
    "monotonic": ("import time\nt0 = time.perf_counter()\n"
                  "t1 = time.monotonic()\n", set()),
    "random-module": ("import random\nx = random.choice([1, 2])\n",
                      {"unseeded-random"}),
    "np-random": ("import numpy as np\nx = np.random.rand(3)\n",
                  {"unseeded-random"}),
    "generator": ("import numpy as np\nrng = np.random.default_rng(7)\n"
                  "x = rng.normal(size=3)\n", set()),
    "set-iteration": ("for x in {1, 2, 3}:\n    print(x)\n",
                      {"set-iteration"}),
    "builtin-hash": ('key = hash("name")\n', {"builtin-hash"}),
    "sorted-set": ("for x in sorted({1, 2, 3}):\n    print(x)\n", set()),
    "mutable-default": ("def f(xs=[]):\n    return xs\n",
                        {"mutable-default"}),
    "dataclass-default": ("from dataclasses import dataclass\n@dataclass\n"
                          "class C:\n    xs: list = []\n",
                          {"mutable-default"}),
    "default-factory": ("from dataclasses import dataclass, field\n"
                        "@dataclass\nclass C:\n"
                        "    xs: list = field(default_factory=list)\n",
                        set()),
    "thread-writes-self": (textwrap.dedent("""
        import threading
        class W:
            def start(self):
                self._t = threading.Thread(target=self._work)
            def _work(self):
                self.result = 1
        """), {"thread-shared-state"}),
    "nonlocal-rebind": (textwrap.dedent("""
        def run(pool):
            done = False
            def work():
                nonlocal done
                done = True
            pool.submit(work)
        """), {"thread-shared-state"}),
    "late-binding": (textwrap.dedent("""
        def run(pool):
            item = 1
            def work():
                return item
            pool.submit(work)
            item = 2
        """), {"thread-shared-state"}),
    "snapshot-at-submit": (textwrap.dedent("""
        def run(pool, items):
            snapshot = list(items)
            def work(data):
                return sum(data)
            pool.submit(work, snapshot)
        """), set()),
    "suppressed": ("import time\nt0 = time.time()  "
                   "# lint: ignore[wall-clock] -- provenance stamp\n", set()),
    "wrong-rule-suppressed": ("import time\nt0 = time.time()  "
                              "# lint: ignore[unseeded-random]\n",
                              {"wall-clock"}),
    "skip-file": ("# lint: skip-file\nimport time\nt0 = time.time()\n",
                  set()),
    "syntax-error": ("def f(:\n", {"parse-error"}),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_ast_fixtures_equal_jax(name):
    src, rules = FIXTURES[name]
    got = _findings(lint_source, "fixture.py", src)
    assert got == _findings(jax_lint_source, "fixture.py", src)
    assert {v["rule"] for v in got[0]} == rules


def test_port_walk_covers_package_smoke_script_and_port_tests(tmp_path):
    for rel in ("src/repro_torch/a.py", "src/repro_torch/sub/b.py",
                "src/repro/c.py", "chip_smoke.py", "tests/test_torch_x.py",
                "tests/test_other.py", "benchmarks/d.py"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text("import time\nt0 = time.time()\n")
    got = [str(p.relative_to(tmp_path)) for p in iter_source_files(tmp_path)]
    assert got == ["chip_smoke.py", "src/repro_torch/a.py",
                   "src/repro_torch/sub/b.py", "tests/test_torch_x.py"]
    report = run_ast_passes(tmp_path)
    assert report.summary["ast"]["files_scanned"] == 4
    assert [v.rule for v in report.violations] == ["wall-clock"] * 4


def test_port_files_pass_the_ast_passes():
    report = run_ast_passes(ROOT)
    assert report.violations == []
    assert report.summary["ast"]["files_scanned"] == len(
        iter_source_files(ROOT))


# ------------------------------------------------------------------ #
# step passes on hand-built logs                                     #
# ------------------------------------------------------------------ #
def _c(op="all_reduce", dtype="float32", numel=8, moved=64):
    return Collective(op=op, dtype=dtype, numel=numel, ranks=(0, 1),
                      moved=moved)


GOOD = StepLog(collectives=(_c(), _c("all_to_all_single", "int8", 8, 8),
                            _c("all_gather_into_tensor", "int8", 8, 8)),
               storage_before=(1, 2, 3), storage_after=(1, 2, 3),
               leaf_names=("params[0]", "mu[0]", "nu[0]"))

BAD = {
    "int8-all-reduce": (wire_dtype_policy, dict(
        collectives=(_c(dtype="int8", moved=16),)), "wire-dtype-policy"),
    "bool-reduce-scatter": (wire_dtype_policy, dict(
        collectives=(_c("reduce_scatter_tensor", "bool"),)),
        "wire-dtype-policy"),
    "host-read": (hot_path_purity, dict(
        host_reads=("aten._local_scalar_dense.default (cpu)",)),
        "hot-path-purity"),
    "host-sync": (hot_path_purity, dict(
        syncs=("step.py:1: called a synchronizing CUDA operation",)),
        "hot-path-purity"),
    "fp64": (hot_path_purity, dict(wide=("aten.mul.Tensor",)),
             "hot-path-purity"),
    "rng-draw": (hot_path_purity, dict(rng_draws=("aten.rand.default",)),
                 "hot-path-purity"),
    "rebound-leaf": (donation_audit, dict(storage_after=(1, 9, 3)),
                     "donation-audit"),
    "copy-alive": (donation_audit, dict(
        copies_alive=("aten.clone.default",)), "donation-audit"),
    "leaf-dropped": (donation_audit, dict(storage_after=(1, 2)),
                     "donation-audit"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_step_pass_fires_on_bad_log_and_is_quiet_on_good(case):
    import dataclasses

    check, change, rule = BAD[case]
    assert check(GOOD, "good") == []
    found = check(dataclasses.replace(GOOD, **change), "bad")
    assert found and {v.rule for v in found} == {rule}


def test_donation_audit_names_the_rebound_leaf():
    import dataclasses

    (v,) = donation_audit(dataclasses.replace(GOOD, storage_after=(1, 9, 3)),
                          "ex")
    assert "mu[0]" in v.message and "1 of 3" in v.message


@pytest.mark.parametrize("case", sorted(STEPS))
def test_recorded_step_trips_its_rule(case):
    """The recorder itself, not a hand-built log: a real step that reads
    the host, makes fp64, rebinds its leaf, keeps a copy, draws on the
    default generator or all-reduces int8 trips its rule; the good step
    none."""
    want = STEPS[case][1]
    assert findings(case, "cpu") == ({want} if want else set())


class _FakeExec:
    """A survivor sweep's view of an executor whose schedule may depend
    on WHICH group failed."""

    def __init__(self, poisoned=None):
        self.state = SpareState(4, 2)
        self.poisoned = poisoned

    def step_log(self, state=None, watch=True):
        dead = set(range(4)) - set(int(w) for w in state.survivors)
        extra = (_c(),) if self.poisoned in dead else ()
        return StepLog(collectives=(_c(),) * state.s_a + extra)


def test_schedule_determinism_fires_on_a_victim_dependent_schedule():
    clean, n = schedule_determinism_executor(_FakeExec(), "ex")
    assert clean == [] and n == 6
    dirty, n = schedule_determinism_executor(_FakeExec(poisoned=2), "ex")
    assert n == 6
    assert {v.rule for v in dirty} == {"collective-schedule-determinism"}
    # (2,) and (0, 2) both lose group 2
    assert [v.message.split(")")[0] for v in dirty] == [
        "survivor set (victims=[2], S_A=2", "survivor set (victims=[0, 2], "
        "S_A=2"]


def test_ef_state_policy_fires_on_bf16_residuals():
    class Fake:
        _ef_state = {"err1": (torch.zeros(4),), "err2": (torch.zeros(2),)}

    assert ef_state_policy(Fake(), "ex") == []
    Fake._ef_state = {"err1": (torch.zeros(4, dtype=torch.bfloat16),),
                      "err2": (torch.zeros(2),)}
    assert [v.rule for v in ef_state_policy(Fake(), "ex")] == \
        ["wire-dtype-policy"]


def test_report_json_roundtrip_and_target_counts():
    child = Report()
    child.extend([Violation("prog", 0, "donation-audit", "boom")])
    child.note("target:executor", survivor_sets=6, violations=1)
    parent = Report()
    parent.merge_json(child.to_json())
    parent.merge_json(child.to_json())
    assert len(parent.violations) == 2
    assert parent.summary["target:executor"] == {"survivor_sets": 12,
                                                 "violations": 2}


# ------------------------------------------------------------------ #
# the CLI                                                            #
# ------------------------------------------------------------------ #
def _lint(*argv, cwd=ROOT):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", *argv],
        capture_output=True, text=True, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def test_lint_json_is_byte_identical_and_assert_clean_fails_on_a_plant(
        tmp_path):
    a, b = _lint("--json", "--assert-clean"), _lint("--json")
    assert a.returncode == 0, a.stderr
    assert a.stdout == b.stdout
    assert json.loads(a.stdout)["clean"]
    planted = tmp_path / "src" / "repro_torch" / "mod.py"
    planted.parent.mkdir(parents=True)
    planted.write_text("import time\nt0 = time.time()\n")
    bad = _lint("--root", str(tmp_path), "--assert-clean",
                "--out", str(tmp_path / "report.json"))
    assert bad.returncode == 1
    assert "src/repro_torch/mod.py:2: [wall-clock]" in bad.stdout
    report = json.loads((tmp_path / "report.json").read_text())
    assert [v["rule"] for v in report["violations"]] == ["wall-clock"]
