"""The port's §3.1 certification end to end on the CPU:
``python -m repro_torch.launch.lint --steps --device cpu --assert-clean
--json``, whose child (``--certify-executors``) records the JAX lint's
whole target set at its sizes: the mesh executor in its three variants
on every rank of the fake (data 4, model 2) grid over every recoverable
survivor set, the elastic executor reshaped past ``[0, 1]`` with and
without int8 EF, the demoted set and the re-admission's restored table,
the trainer's step and the warmed engine's callables; beside it one
child a ported dry-run cell of the JAX lint's matrix (qwen2.5-3b
``train_4k``, musicgen-medium ``prefill_32k`` multi-pod). The report is
clean and counts what each target certified. Without ``--device cpu``
the step passes want the card, and raise where there is none.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

#: each target's ranks and survivor sets (the fake grids of the JAX
#: lint's sizes: N 4, r 2 has 6 recoverable sets, so 48 on 8 ranks; the
#: elastic grid of 8 rows keeps 4 after the reshape)
TARGETS = {
    "executor:shard_map": (8, 48),
    "executor:gspmd": (8, 48),
    "executor:shard_map+int8_ef": (8, 48),
    "executor:elastic-reshaped": (4, 24),
    "executor:elastic-reshaped+int8_ef": (4, 24),
    "executor:demoted": (8, 48),
}
PROGRAMS = ("trainer:spare", "serve:decode", "serve:prefill/8",
            "serve:write/8")


def _lint(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", *argv],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def test_certify_executors_on_the_cpu_is_clean():
    proc = _lint("--steps", "--device", "cpu", "--assert-clean", "--json")
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-4000:])
    report = json.loads(proc.stdout)
    assert report["clean"] and report["violations"] == []
    summary = report["summary"]
    assert summary["collective-schedule-determinism"] == {
        "survivor_sets_certified": 240}
    assert summary["cells"] == {"serve_programs_certified": 3}
    # the dry run's dense matrix cells: qwen2.5-3b train_4k at S_A 1 and
    # 2, musicgen-medium's prefill once; the other three noted
    cells = summary["dryrun-cells"]
    assert cells["programs_certified"] == 3
    assert sum(v == "not yet ported" for v in cells.values()) == 3
    assert "cell:musicgen-medium/prefill_32k/2x16x16" not in cells
    for s_a in (1, 2):
        counts = summary[f"target:cell:qwen2.5-3b/train_4k/16x16@S_A={s_a}"]
        assert counts["violations"] == counts["host_syncs"] == 0
        assert counts["leaves_in_place"] > 0 and counts["collectives"] > 0
    # musicgen: embeds, the untied head, 24 heads in padded blocks of 2
    counts = summary["target:cell:musicgen-medium/prefill_32k/2x16x16@S_A=1"]
    assert counts["violations"] == counts["host_syncs"] == 0
    assert counts["collectives"] > 0 and counts["programs"] == 1
    assert summary["target:executor:demoted"][
        "readmit_schedule_restored"] == 8
    for name, (ranks, sets) in TARGETS.items():
        counts = summary[f"target:{name}"]
        assert (counts["ranks"], counts["survivor_sets"]) == (ranks, sets)
        assert counts["violations"] == counts["host_syncs"] == 0
        assert counts["leaves_in_place"] > 0 and counts["collectives"] > 0
    for name in PROGRAMS:
        counts = summary[f"target:{name}"]
        assert counts["programs"] == 1 and counts["violations"] == 0
    # the decode and the write update both KV pools in place
    assert summary["target:serve:decode"]["leaves_in_place"] == 2
    assert summary["target:serve:write/8"]["leaves_in_place"] == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_steps_want_the_card_by_default():
    proc = _lint("--steps")
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr


@pytest.mark.parametrize("violations, assert_clean, rc", [
    (0, True, 0), (1, False, 0), (1, True, 1)])
def test_cell_follows_assert_clean(monkeypatch, capsys, violations,
                                   assert_clean, rc):
    """``--cell`` exits 1 on a violation under ``--assert-clean``, as the
    whole lint does, and prints its report."""
    from repro_torch.analysis import Report, Violation
    from repro_torch.launch import lint

    def passes(arch, shape, multi_pod):
        report = Report()
        report.extend([Violation(f"cell:{arch}/{shape}", 0, "wire-dtype",
                                 "fp64 on the wire")] * violations)
        return report

    monkeypatch.setattr(lint, "run_cell_passes", passes)
    argv = ["--cell", "qwen2.5-3b", "train_4k", "--json"]
    assert lint.main(argv + ["--assert-clean"] * assert_clean) == rc
    report = json.loads(capsys.readouterr().out)
    assert report["clean"] == (violations == 0)
    assert len(report["violations"]) == violations
