"""The port's elastic tier on a ``(data, model)`` grid of ranks against
the JAX package's, on the CPU.

* The executor: the port's ``ElasticMeshExecutor`` on 8 gloo ranks, a
  grid of N 4 data rows x model degree 2 (r 2), against JAX's on a
  ``(4, 2)`` mesh of emulated devices (``tests/_elastic_grid_jax.py``, in
  a subprocess), from the same numpy parameters at the TINY fp32 width
  of ``tests/_elastic_cases.py``: the cases of ``_elastic_cases.CASES``
  that move a reshape's state or its groups (``GRID_CASES``) under
  ``shard_map`` with the int8 EF sync, and a round trip and a
  rollback under ``gspmd`` (``tests/_elastic_grid_cases.py``). The 8
  ranks are spawned once for all of them.
* The campaign's cells on a grid: ``elastic_regime_cells(n=2, r=1,
  model_degree=2, steps=12)`` on four CPU ranks (the card's cell) and
  ``gray_regime_cells(model_degree=2, ...)`` on two, against JAX's
  ``run_elastic_cell`` and ``run_gray_cell`` on a ``(2, 2)`` and an
  ``(8, 2)`` mesh.
* The launcher: ``--mesh --elastic --model-degree 2`` on 2 x 2 ranks in
  both syncs against the JAX launcher's ``[train]`` lines.

Tolerances, those of ``tests/test_torch_elastic.py``: reports, cache
keys, policy logs and injector clocks are identical; against JAX,
losses within 1e-5 relative and params within 1e-5 absolute, EF
residuals by ``_near_residual``. What the port computes twice is
compared bit for bit, per model column: the state a reshape, a restore
or a rollback moves (a rank takes the state of its own column's rank
in the source row), the replicas of a row under ``shard_map``, each
``gspmd`` block against the column block of the whole leaf, and a
``gspmd`` disk checkpoint written after a reshape (by the rank at
logical row 0, model 0: grid rank 4) against a model degree 1
executor's save of the same state. Rows: every field but the wall time
and the losses.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _elastic_cases import N, reslice
from _elastic_grid_cases import (DEVICES, ELASTIC_CELLS, GRAY_CELLS,
                                 GRID_CASES, M, port_grid_rank)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.scenarios import campaign
from test_torch_elastic import (ARM_SKIP, COMMON, _near_jax, _numpy_params,
                                _same_bits, _same_report)
from test_torch_tp import _cli_lines

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
#: the launcher runs both packages take, on 2 rows x 2 ranks: at r 1
#: every failure is unmaskable (two reshapes DP 2 -> 1, two wipe-outs
#: with the full grid restored)
CLI_COMMON = ["--mesh", "--elastic", "--model-degree", str(M), "--steps",
              "6", "--n-groups", "2", "-r", "1", "--seq", "16",
              "--mtbf-steps", "2"]
CLI_RUNS = {"shard_map": ["--grad-compress", "int8_ef"],
            "gspmd": ["--sync", "gspmd"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's cases, cells and launcher runs in subprocesses while the
    port's 8 ranks run the cases, then the cells."""
    tmp = tmp_path_factory.mktemp("elastic_grid")
    params = tmp / "params.pkl"
    with open(params, "wb") as f:
        pickle.dump(_numpy_params(), f)
    flags = os.environ.get("XLA_FLAGS", "")
    script = str(ROOT / "tests" / "_elastic_grid_jax.py")
    procs = {part: subprocess.Popen(
        [sys.executable, script, part, *args, str(tmp / f"{part}.pkl")],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(ROOT / "src"),
                 XLA_FLAGS=f"{flags} --xla_force_host_platform_device_"
                           f"count={DEVICES[part]}".strip()),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for part, args in (("cases", [str(params)]), ("cells", []))}
    for name, argv in CLI_RUNS.items():
        # the JAX launcher fans the host out into n_groups x degree
        # devices itself
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", *CLI_COMMON, *argv],
            env=dict(os.environ, JAX_PLATFORMS="cpu",
                     PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        (tmp / "ckpt").mkdir()
        port, backend = spawn_ranks(port_grid_rank, N * M, device="cpu",
                                    args=(str(params), str(tmp / "ckpt")))
        elastic = campaign.run_elastic_cells(
            campaign.elastic_regime_cells(**ELASTIC_CELLS), device="cpu")
        gray = [campaign.run_gray_cell(c, device="cpu")
                for c in campaign.gray_regime_cells(**GRAY_CELLS)]
        logs = {part: p.communicate(timeout=900)[0]
                for part, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for part, p in procs.items():
        assert p.returncode == 0, logs[part][-4000:]
    theirs = {}
    for part in ("cases", "cells"):
        with open(tmp / f"{part}.pkl", "rb") as f:
            theirs[part] = pickle.load(f)
    return {"port": port, "backend": backend, "elastic": elastic,
            "gray": gray, "jax": {**theirs["cases"], "cells": theirs["cells"]},
            "jax_cli": {n: logs[n] for n in CLI_RUNS}}


def _rank(row: int, m: int) -> int:
    return row * M + m


def _replicas_equal(states: list) -> None:
    """``shard_map``: the model ranks of every row hold the same bits."""
    for row in range(N):
        first = states[_rank(row, 0)]
        for m in range(1, M):
            _same_bits(states[_rank(row, m)], first,
                       ("params", "mu", "nu", "err1", "err2"))


# ------------------------------------------------------------------ #
# the executor under shard_map + int8 EF                             #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", GRID_CASES)
def test_int8_case_matches_jax(case, runs):
    """Each case of ``tests/test_torch_elastic.py`` on the grid: its
    readings equal JAX's on a ``(4, 2)`` mesh, each rank's state near
    JAX's, the replicas of every row equal, and the state every move
    makes, per model column, as at model degree 1."""
    ours, theirs = runs["port"]["int8"][case], runs["jax"]["int8"][case]
    for k in COMMON:
        if k in theirs:
            assert ours[k] == theirs[k], k
    if theirs.get("report") is not None:
        _same_report(ours["report"], theirs["report"])
    rep = ours.get("report")
    if case == "round_trip":
        s0, s1, s2 = ours["s0"], ours["s1"], ours["s2"]
        assert ours["after_reshape"]["rows"] == [2, 3]
        for states in (s0, s1, s2):
            _replicas_equal(states)
        for m in range(M):
            for p in (2, 3):
                _same_bits(s1[_rank(p, m)], s0[_rank(p, m)],
                           ("params", "mu", "nu", "err1"))
            for p in range(N):
                _same_bits(s2[_rank(p, m)], s0[_rank(2, m)])
            for p in (0, 1):
                assert not any(e.any() for e in s2[_rank(p, m)]["err1"])
            for b in range(len(s0[0]["err2"])):
                shrunk = reslice([s0[_rank(p, m)]["err2"][b]
                                  for p in range(N)], range(N), [2, 3])
                for i, p in enumerate((2, 3)):
                    np.testing.assert_array_equal(
                        s1[_rank(p, m)]["err2"][b], shrunk[i])
                grown = reslice(shrunk, [2, 3], range(N))
                for p in range(N):
                    np.testing.assert_array_equal(
                        s2[_rank(p, m)]["err2"][b], grown[p])
        for s in ("s0", "s1", "s2"):
            for r, want in enumerate(theirs[s]):
                if want is not None:
                    _near_jax(ours[s][r], want)
    elif case == "fresh":
        # the reshaped run IS a fresh run on the first two rows' ranks
        el, fresh = ours["elastic"], ours["fresh"]
        assert el["report"]["losses"] == fresh[0]["report"]["losses"]
        for i, p in enumerate((2, 3)):
            for m in range(M):
                _same_bits(el["state"][_rank(p, m)],
                           fresh[_rank(i, m)]["state"],
                           ("params", "mu", "nu", "err1", "err2"))
        _same_report(el["report"], theirs["elastic"]["report"])
        for p in (2, 3):
            for m in range(M):
                _near_jax(el["state"][_rank(p, m)],
                          theirs["elastic"]["state"][_rank(p, m)])
    elif case == "burst":
        assert rep["wipeouts"] == 0 and rep["reshapes"] == 1
        assert ours["cache_keys"] == [[2, M, 1], [4, M, 1]]
        assert ours["outage_s"] == 60.0
    elif case == "cascade":
        assert rep["wipeouts"] == 0 and rep["reshapes"] == 2
        assert (ours["n"], ours["r"]) == (1, 1)
    elif case == "restart":
        assert ours["restarted"]["n"] == N
        _replicas_equal(ours["state"])
        for r in range(N * M):
            _same_bits(ours["state"][r], ours["state"][0])
    elif case == "rollback":
        # every rank holds the snapshot of its own column's rank in row
        # 2 (active when it was taken); rejoining rows start from zero
        snap, state = ours["at_snapshot"], ours["state"]
        assert ours["step"] == theirs["step"] == 3 and ours["n"] == N
        _replicas_equal(state)
        for m in range(M):
            for p in range(N):
                got = state[_rank(p, m)]
                _same_bits(got, snap[_rank(2, m)])
                assert got["opt_step"] == snap[_rank(2, m)]["opt_step"]
                if p < 2:
                    assert not any(e.any() for e in got["err1"])
                else:
                    _same_bits(got, snap[_rank(p, m)], ("err1",))
            for b in range(len(snap[0]["err2"])):
                grown = reslice([snap[_rank(p, m)]["err2"][b]
                                 for p in (2, 3)], [2, 3], range(N))
                for p in range(N):
                    np.testing.assert_array_equal(
                        state[_rank(p, m)]["err2"][b], grown[p])
        for r in range(N * M):
            _near_jax(state[r], theirs["state"][r])
    elif case == "health":
        _same_report(ours["after"]["report"], theirs["after"]["report"])
        assert ours["after"]["rows"] == [2, 3] and ours["n"] == 2


# ------------------------------------------------------------------ #
# the executor under gspmd                                           #
# ------------------------------------------------------------------ #
def _column_blocks(state: dict, m: int) -> None:
    """A ``gspmd`` rank's stored leaves are model column ``m``'s blocks
    of the whole leaves it gathers (the replicated leaves whole), the
    moments likewise, bit for bit."""
    for key, whole in (("params", "full"), ("mu", "full_mu"),
                       ("nu", "full_nu")):
        for blk, full in zip(state[key], state[whole]):
            if blk.shape != full.shape:
                c = full.shape[-1] // M
                full = full[..., m * c:(m + 1) * c]
            np.testing.assert_array_equal(blk.view(np.uint32),
                                          full.view(np.uint32), err_msg=key)


def _gspmd_checks(states: list, theirs: dict, rows=range(N)) -> None:
    """Every rank of ``rows``: its blocks are its column's; its row's
    ranks hold different blocks of one whole state; the whole params
    within 1e-5 of JAX's."""
    for r, st in enumerate(states):
        if r // M not in rows:
            continue
        _column_blocks(st, r % M)
        for a, b in zip(st["full"], theirs["full"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        assert st["opt_step"] == theirs["opt_step"]
    for row in rows:
        a, b = states[_rank(row, 0)], states[_rank(row, 1)]
        _same_bits({"params": a["full"]}, {"params": b["full"]},
                   ("params",))
        assert any(x.shape == y.shape and not np.array_equal(x, y)
                   for x, y in zip(a["params"], b["params"]))


def _blocks_equal(got: dict, want: dict) -> None:
    _same_bits(got, want, ("params", "mu", "nu"))


@pytest.mark.parametrize("case", ["round_trip", "rollback"])
def test_gspmd_case_matches_jax(case, runs):
    """Under ``gspmd``: the readings equal JAX's; the survivors' blocks
    unchanged by the reshape; after the restore every rank holds its
    own column's block of row 2 (the first survivor); after the rollback
    its column's snapshot of row 2."""
    ours, theirs = runs["port"]["gspmd"][case], runs["jax"]["gspmd"][case]
    for k in ("n", "r", "rows", "cache_keys"):
        assert ours[k] == theirs[k], k
    if case == "round_trip":
        assert ours["after_reshape"] == theirs["after_reshape"]
        assert ours["after_reshape"]["rows"] == [2, 3]
        _same_report(ours["degraded"], theirs["degraded"])
        s0, s1, mid, s2 = (ours[k] for k in ("s0", "s1", "s_mid", "s2"))
        for k in ("s0", "s1", "s2"):
            _gspmd_checks(ours[k], theirs[k])
        # the step at DP 2 ran on rows 2 and 3 alone
        _gspmd_checks(mid, theirs["s_mid"], rows=(2, 3))
        for p in (2, 3):
            for m in range(M):
                _blocks_equal(s1[_rank(p, m)], s0[_rank(p, m)])
        for p in range(N):
            for m in range(M):
                _blocks_equal(s2[_rank(p, m)], mid[_rank(2, m)])
    else:
        snap, state = ours["at_snapshot"], ours["state"]
        assert ours["step"] == theirs["step"] == 3
        _gspmd_checks(snap, theirs["at_snapshot"])
        _gspmd_checks(state, theirs["state"])
        for p in range(N):
            for m in range(M):
                _blocks_equal(state[_rank(p, m)], snap[_rank(2, m)])


def test_gspmd_checkpoint_after_a_reshape_is_the_model_degree_one_file(
        runs):
    save = runs["port"]["gspmd"]["round_trip"]["save"]
    assert save["writers"] == [_rank(2, 0)]
    for name, (ours, one) in save["files"].items():
        assert ours == one and len(ours) > 0, name


# ------------------------------------------------------------------ #
# the campaign's cells on a grid                                     #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arm", ["mask", "reshape", "restart"])
def test_elastic_cell_on_a_grid_matches_jax(arm, runs):
    """The card's cell at N 2, r 1 on a (2, 2) grid: group 0 alone is
    unmaskable at r 1, so the mask arm reshapes DP 2 -> 1 onto row 1;
    groups 0 and 1 leave no survivor, so the other arms restart."""
    i = ["mask", "reshape", "restart"].index(arm)
    ours, theirs = runs["elastic"][i], runs["jax"]["cells"]["elastic"][i]
    assert ours.keys() - {"run"} == theirs.keys()
    assert {k: v for k, v in ours.items() if k not in ARM_SKIP} == \
        {k: v for k, v in theirs.items() if k not in ARM_SKIP}
    assert len(ours["run"]["per_rank"]) == ELASTIC_CELLS["n"] * M
    assert np.isfinite(ours["run"]["losses"]).all()
    if arm == "mask":
        assert (ours["failures"], ours["wipeouts"], ours["reshapes"],
                ours["dp_final"]) == (1, 0, 1, 1)
        assert ours["outage_s"] == 60.0 and ours["ttt_s"] == 1084.0
        assert sorted({tuple(k[:2]) for k in ours["run"]["cache_keys"]}) \
            == [(1, M), (2, M)]
    else:
        assert (ours["failures"], ours["wipeouts"]) == (2, 1)
        assert ours["outage_s"] == 3600.0 and ours["ttt_s"] == 4944.0


@pytest.mark.parametrize("arm", ["tolerate", "demote"])
def test_gray_cell_on_a_grid_matches_jax(arm, runs):
    """Both gray arms on one data row of two model ranks carrying N 8,
    against JAX's on an (8, 2) mesh: every field but the wall time and
    the losses."""
    i = ["tolerate", "demote"].index(arm)
    ours, theirs = runs["gray"][i], runs["jax"]["cells"]["gray"][i]
    skip = ("elapsed_s", "loss_first", "loss_last")
    assert ours.keys() == theirs.keys()
    assert {k: v for k, v in ours.items() if k not in skip} == \
        {k: v for k, v in theirs.items() if k not in skip}
    if arm == "demote":
        assert (ours["demotes"], ours["readmits"], ours["recompiles"]) == \
            (1, 1, 0)
        assert ours["ttt_s"] == 1408.0 and ours["readmit_identical"]


# ------------------------------------------------------------------ #
# the launcher                                                       #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("sync", list(CLI_RUNS))
def test_train_cli_elastic_grid_matches_the_jax_launcher(sync, runs,
                                                         capsys):
    assert train_cli.main(["--device", "cpu", *CLI_COMMON,
                           *CLI_RUNS[sync]]) == 0
    out = capsys.readouterr().out
    ours, theirs = _cli_lines(out), _cli_lines(runs["jax_cli"][sync])
    assert ours == theirs and len(ours) >= 4, (ours, theirs)
    assert f"[train] {2 * M} ranks on cpu, a row of {M} per group" in out
    assert "[train] elastic: DP degree now 1 (full 2)" in out
    assert "wipeouts=2 reshapes=2" in out
