"""The port's elastic tier against the JAX package's, on the CPU.

* Host pieces in this process, over a grid: ``shrink_degree``, the EF
  residual remap (``err1`` follows its physical rank, ``err2`` re-sliced
  from the gathered chunks) against JAX's ``remap_ef_rows`` and its
  global ``err2`` array, and ``ttt_estimates``.
* The multi-rank tier: the port's ``ElasticMeshExecutor`` on 4 gloo
  ranks (spawned processes, ``repro_torch.launch.mesh.spawn_ranks``)
  and JAX's on 4 emulated devices (one subprocess,
  ``tests/_elastic_jax.py``), from the same numpy parameters at a tiny
  fp32 width (2 layers, d_model 64, head_dim 64), through the cases of
  JAX's ``tests/test_elastic.py`` (``tests/_elastic_cases.py``), the
  three ``elastic_regime_cells(n=4)`` arms and ``--mesh --elastic``.

Tolerances: reports, cache keys, policy logs and injector clocks are
identical. What the port computes twice from the same numpy inputs
(state moved by a reshape, a restore or a rollback; a reshaped run
against a fresh run at the smaller degree) is compared bit for bit.
Against JAX (another summation order): losses within 1e-5 relative and
params within 1e-5 absolute, as ``tests/test_torch_train.py``; each EF
residual array element by element (:func:`_near_residual`): at least
99% of its elements within 1e-3 of the int8 quantum of JAX's. The
quantum is the scale the residual's int8 codes were taken at, read off
the residuals themselves (a residual lies within half a scale of zero,
and the largest of a bucket's residuals lies close to that half). The
other elements are those where a code rounded the other way at a .5
boundary, or where the two runs' gradients drifted apart by more than
rounding (their params differ by up to 1e-5); on this grid they are at
most 0.05% of an array. A residual from another rank or another part of
the bucket agrees on about 0.2% (:func:`test_near_jax_sees_a_misplaced_chunk`).
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _elastic_cases import (ARCH, CASES, N, TINY, port_rank, reslice,
                            shared_ckpt_rank)
from repro.elastic import remap_ef_rows as jax_remap_ef_rows
from repro.elastic import shrink_degree as jax_shrink_degree
from repro.elastic import ttt_estimates as jax_ttt_estimates
from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.dist import tree_leaves
from repro_torch.elastic import reshard, shrink_degree, ttt_estimates
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import build_model
from repro_torch.scenarios import campaign

ROOT = Path(__file__).resolve().parents[1]
#: the row fields the arms compare: all but wall time, losses and the
#: port's own readings of the run
ARM_SKIP = ("elapsed_s", "loss_first", "loss_last", "run")


# ------------------------------------------------------------------ #
# host pieces                                                        #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("full,survivors", [
    (8, 7), (8, 6), (8, 4), (8, 3), (8, 1), (8, 0), (6, 5), (4, 3), (4, 2),
    (4, 1), (2, 1), (12, 9)])
def test_shrink_degree_matches_jax(full, survivors):
    assert shrink_degree(full, survivors) == \
        jax_shrink_degree(full, survivors)


#: (old rows, new rows): shrinks as ``reshape`` picks them and the
#: restores back to the full group
REMAPS = [((0, 1, 2, 3), (2, 3)), ((2, 3), (0, 1, 2, 3)),
          ((0, 1, 2, 3), (1, 3)), ((1, 3), (0, 1, 2, 3)),
          ((2, 3), (3,)), (tuple(range(8)), (2, 3, 4, 5)),
          ((2, 3, 4, 5), tuple(range(8)))]


@pytest.mark.parametrize("old,new", REMAPS,
                         ids=[f"{len(o)}to{len(n)}-{n[0]}" for o, n in
                              REMAPS])
def test_ef_remap_matches_jax(old, new, monkeypatch):
    """Every physical rank's residuals through the port's
    ``remap_ef_rows`` (its all-gather replaced by the gathered chunks)
    equal JAX's rows of ``err1`` and its unchanged global ``err2`` sliced
    at the new logical positions; a rank that rejoins starts at zero."""
    world = max(max(old), max(new)) + 1
    sizes = [8 * len(old) * len(new), 24 * len(old) * len(new)]
    rng = np.random.default_rng(len(old) * 10 + len(new))
    g1 = [rng.standard_normal(len(old) * s).astype(np.float32)
          for s in sizes]
    g2 = [rng.standard_normal(s).astype(np.float32) for s in sizes]
    want = jax_remap_ef_rows({"err1": g1, "err2": g2}, sizes, old, new)

    def local(p):
        """Physical rank ``p``'s own residuals before the reshape (a
        rank outside ``old`` holds stale ones of another size)."""
        if p in old:
            i = old.index(p)
            return {"err1": tuple(torch.from_numpy(
                        g.reshape(len(old), -1)[i].copy()) for g in g1),
                    "err2": tuple(torch.from_numpy(
                        g.reshape(len(old), -1)[i].copy()) for g in g2)}
        return {"err1": tuple(torch.full((s,), 7.0) for s in sizes),
                "err2": tuple(torch.full((s // (len(old) + 1),), 7.0)
                              for s in sizes)}

    gathered = [torch.cat([local(p)["err2"][b] if p in old
                           else torch.zeros(s // len(old))
                           for p in range(world)])
                for b, s in enumerate(sizes)]
    for p in range(world):
        calls = iter(gathered)
        monkeypatch.setattr(reshard, "collective",
                            lambda op, out, inp, group: out.copy_(next(calls)))
        monkeypatch.setattr(reshard.dist, "get_world_size", lambda g: world)
        got = reshard.remap_ef_rows(local(p), old, new, rank=p, group=None)
        for b, s in enumerate(sizes):
            if p in new:
                i = new.index(p)
                np.testing.assert_array_equal(
                    got["err1"][b].numpy(),
                    np.asarray(want["err1"][b]).reshape(len(new), -1)[i])
                np.testing.assert_array_equal(
                    got["err2"][b].numpy(),
                    np.asarray(want["err2"][b])[i * s // len(new):
                                                (i + 1) * s // len(new)])
                if p not in old:
                    assert not got["err1"][b].any()
            else:
                assert got["err2"][b].shape == (s // len(new),)
                assert not got["err2"][b].any()


@pytest.mark.parametrize("kw", [
    dict(dp_full=8, dp_new=4, remaining_steps=16, seconds_per_step=64.0,
         rollback_steps=8, t_restart=3600.0, t_reshape=60.0),
    dict(dp_full=8, dp_new=0, remaining_steps=16, seconds_per_step=64.0,
         t_restart=3600.0, t_reshape=60.0),
    dict(dp_full=8, dp_new=2, remaining_steps=1000, seconds_per_step=64.0,
         rollback_steps=0, t_restart=60.0, t_reshape=60.0),
    dict(dp_full=4, dp_new=2, remaining_steps=10, seconds_per_step=10.0,
         rollback_steps=10, t_restart=100.0, t_reshape=100.0)],
    ids=["reshape", "no-survivors", "restart", "tie"])
def test_ttt_estimates_match_jax(kw):
    assert ttt_estimates(**kw) == jax_ttt_estimates(**kw)


# ------------------------------------------------------------------ #
# the multi-rank tier: 4 gloo ranks against 4 emulated devices       #
# ------------------------------------------------------------------ #
def _numpy_params() -> dict:
    model = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(host(v) for v in t)
        return t.float().numpy()

    return host(model.init(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX side in two subprocesses (the cases, the campaign arms)
    while the port's ranks run the same cases, then the arms."""
    tmp = tmp_path_factory.mktemp("elastic")
    params = tmp / "params.pkl"
    with open(params, "wb") as f:
        pickle.dump(_numpy_params(), f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count="
                         f"{N}".strip())
    script = str(ROOT / "tests" / "_elastic_jax.py")
    procs = {part: subprocess.Popen(
        [sys.executable, script, part, *args, str(tmp / f"{part}.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for part, args in (("cases", [str(params)]),
                                      ("arms", []))}
    try:
        port, backend = spawn_ranks(port_rank, N, device="cpu",
                                    args=(str(params),))
        # the first two arms on one set of ranks, the third on its own
        cells = campaign.elastic_regime_cells(n=N)
        arms = campaign.run_elastic_cells(cells[:2], device="cpu") + \
            [campaign.run_elastic_cell(cells[2], device="cpu")]
        logs = {part: p.communicate(timeout=900)[0]
                for part, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    theirs = {}
    for part, p in procs.items():
        assert p.returncode == 0, logs[part][-4000:]
        with open(tmp / f"{part}.pkl", "rb") as f:
            theirs[part] = pickle.load(f)
    return {"port": port, "backend": backend, "arms": arms,
            "jax": {**theirs["cases"], "arms": theirs["arms"]}}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32)


def _same_bits(got: dict, want: dict, keys=("params", "mu", "nu")):
    for k in keys:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=k)


#: the share of an EF residual's elements that must agree with JAX's to
#: within ``EF_ROUNDING`` of the int8 quantum
EF_AGREE, EF_ROUNDING = 0.99, 1e-3


def _near_residual(a: np.ndarray, b: np.ndarray, what: str) -> None:
    """The port's EF residual ``a`` against JAX's ``b`` (see the module
    doc); all-zero residuals must both be zero."""
    assert a.shape == b.shape, what
    quantum = 2 * max(np.abs(a).max(), np.abs(b).max())
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    close = diff <= EF_ROUNDING * quantum
    assert close.mean() >= EF_AGREE, \
        f"{what}: {close.mean():.4f} of the elements agree"


def _near_jax(got: dict, want: dict) -> None:
    """One rank's state against JAX's: params within 1e-5, each EF
    residual by :func:`_near_residual`."""
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for k in ("err1", "err2"):
        assert len(got[k]) == len(want[k]), k
        for i, (a, b) in enumerate(zip(got[k], want[k])):
            _near_residual(a, b, f"{k}[{i}]")


def _same_report(got: dict, want: dict) -> None:
    assert {k: v for k, v in got.items() if k != "losses"} == \
        {k: v for k, v in want.items() if k != "losses"}
    assert len(got["losses"]) == len(want["losses"])
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
        assert np.isfinite(a)


COMMON = ("n", "r", "rows", "cache_keys", "policy_log", "outage_s")


@pytest.mark.parametrize("case", CASES)
def test_case_matches_jax(case, runs):
    """Each case as JAX's ``tests/test_elastic.py`` states it, on the
    port's ranks and against JAX's run of the same case."""
    ours, theirs = runs["port"][case], runs["jax"][case]
    for k in COMMON:
        if k in theirs:
            assert ours[k] == theirs[k], k
    if theirs.get("report") is not None:
        _same_report(ours["report"], theirs["report"])
    rep = ours.get("report")
    if case == "round_trip":
        # full -> survivors 2, 3 -> full: replicas untouched, err1
        # followed its rank, err2 re-sliced; rejoining ranks start at 0
        s0, s1, s2 = ours["s0"], ours["s1"], ours["s2"]
        assert ours["after_reshape"]["rows"] == [2, 3]
        assert ours["after_reshape"]["n"] == 2 and ours["n"] == N
        for p in (2, 3):
            _same_bits(s1[p], s0[p], ("params", "mu", "nu", "err1"))
        for p in range(N):
            _same_bits(s2[p], s0[2])
        for p in (0, 1):
            assert not any(e.any() for e in s2[p]["err1"])
        for b in range(len(s0[0]["err2"])):
            shrunk = reslice([s0[p]["err2"][b] for p in range(N)],
                             range(N), [2, 3])
            for i, p in enumerate((2, 3)):
                np.testing.assert_array_equal(s1[p]["err2"][b], shrunk[i])
            grown = reslice(shrunk, [2, 3], range(N))
            for p in range(N):
                np.testing.assert_array_equal(s2[p]["err2"][b], grown[p])
        for s in ("s0", "s1", "s2"):
            for p, want in enumerate(theirs[s]):
                if want is not None:
                    _near_jax(ours[s][p], want)
    elif case == "fresh":
        # the reshaped run IS a fresh run at DP 2 (ranks 2, 3 against a
        # two-rank MeshExecutor on ranks 0, 1), bit for bit
        el, fresh = ours["elastic"], ours["fresh"]
        assert el["report"]["losses"] == fresh[0]["report"]["losses"]
        for i, p in enumerate((2, 3)):
            _same_bits(el["state"][p], fresh[i]["state"],
                       ("params", "mu", "nu", "err1", "err2"))
        _same_report(el["report"], theirs["elastic"]["report"])
        for p in (2, 3):
            _near_jax(el["state"][p], theirs["elastic"]["state"][p])
    elif case == "burst":
        assert rep["wipeouts"] == 0 and rep["reshapes"] == 1
        assert rep["rollback_steps"] == 0 and ours["n"] == 2
        assert ours["cache_keys"] == [[2, 1, 1], [4, 1, 1]]
        assert rep["recompiles"] == 2 and ours["outage_s"] == 60.0
        ev = [e for e in rep["events"] if e[3]]
        assert [(e[4], e[5], e[2]) for e in ev] == [(4, 2, False)]
        pol = ours["policy_log"][-1]
        assert pol["action"] == "reshape"
        assert pol["reshape_ttt"] < pol["restart_ttt"]
    elif case == "cascade":
        assert rep["wipeouts"] == 0 and rep["reshapes"] == 2
        assert (ours["n"], ours["r"]) == (1, 1)
    elif case == "restart":
        assert ours["restarted"]["n"] == N
        assert all(ours["restarted"]["phys_alive"])
        assert set(map(tuple, ours["keys_before"])) <= \
            set(map(tuple, ours["cache_keys"]))
        for p in range(N):
            _same_bits(ours["state"][p], ours["state"][0])
    elif case == "rollback":
        # every rank holds the snapshot of a rank active when it was
        # taken (rank 2); ranks that rejoin start from zero err1
        snap, state = ours["at_snapshot"], ours["state"]
        assert ours["step"] == theirs["step"] == 3 and ours["n"] == N
        for p in range(N):
            _same_bits(state[p], snap[2])
            assert state[p]["opt_step"] == snap[2]["opt_step"]
        for p in (0, 1):
            assert not any(e.any() for e in state[p]["err1"])
        for p in (2, 3):
            _same_bits(state[p], snap[p], ("err1",))
        for b in range(len(snap[2]["err2"])):
            grown = reslice([snap[p]["err2"][b] for p in (2, 3)], [2, 3],
                            range(N))
            for p in range(N):
                np.testing.assert_array_equal(state[p]["err2"][b],
                                              grown[p])
        for p in range(N):
            _near_jax(state[p], theirs["state"][p])
    elif case == "adaptive":
        assert rep["reshapes"] == 1 and rep["wipeouts"] == 0
        assert ours["decisions"] == theirs["decisions"]
        assert ours["decisions"][-1]["action"] == "reshape"
        assert ours["policy_log"][-1]["action"] == "reshape"
    elif case == "mask":
        assert rep["failures"] == 1 and rep["reshapes"] == 0
        assert rep["wipeouts"] == 0 and ours["policy_log"] == []
        assert ours["n"] == N
    elif case == "health":
        after = ours["after"]
        _same_report(after["report"], theirs["after"]["report"])
        assert after["report"]["reshapes"] == 1
        assert [e[3:6] for e in after["report"]["events"]] == \
            [(True, 4, 2)]
        assert after["rows"] == [2, 3] and ours["n"] == 2
        assert rep["steps_done"] == 2 and rep["wipeouts"] == 0


@pytest.mark.parametrize("plant", ["survivors-swapped", "halves-swapped"])
def test_near_jax_sees_a_misplaced_chunk(plant, runs):
    """The residual comparison fails on a re-slice gone wrong: after the
    round trip's reshape, survivor 2's err2 held against survivor 3's in
    JAX's run, or with its two halves (the old chunks of ranks 0 and 1)
    swapped, fails in every bucket."""
    ours, theirs = runs["port"]["round_trip"]["s1"], \
        runs["jax"]["round_trip"]["s1"]
    want = theirs[3 if plant == "survivors-swapped" else 2]["err2"]
    for b, got in enumerate(ours[2]["err2"]):
        if plant == "halves-swapped":
            got = np.concatenate(np.split(got, 2)[::-1])
        with pytest.raises(AssertionError):
            _near_residual(got, want[b], f"err2[{b}]")


@pytest.mark.parametrize("arm", ["mask", "reshape", "restart"])
def test_elastic_arm_matches_jax(arm, runs):
    """``run_elastic_cells`` (mask, reshape) and ``run_elastic_cell``
    (restart) on 4 gloo ranks against JAX's on 4 devices:
    every row field equal but the wall time and the losses (each side
    draws its own parameters from the seed)."""
    i = ["mask", "reshape", "restart"].index(arm)
    ours, theirs = runs["arms"][i], runs["jax"]["arms"][i]
    assert ours.keys() - {"run"} == theirs.keys()
    assert {k: v for k, v in ours.items() if k not in ARM_SKIP} == \
        {k: v for k, v in theirs.items() if k not in ARM_SKIP}
    assert ours["run"]["backend"] == runs["backend"] == "gloo"
    assert len(ours["run"]["per_rank"]) == N
    assert ours["run"]["losses"][-1] == ours["loss_last"]
    assert np.isfinite(ours["run"]["losses"]).all()
    if arm == "reshape":
        rows = {r["arm"]: r for r in runs["arms"]}
        assert ours["wipeouts"] == 0 and ours["dp_final"] == 2
        assert ours["ttt_s"] < rows["restart"]["ttt_s"]


def test_train_cli_elastic_on_the_cpu(capsys):
    """``--mesh --elastic --device cpu``: 4 spawned gloo ranks through
    rack bursts that kill two groups at once."""
    assert train_cli.main([
        "--device", "cpu", "--steps", "8", "--n-groups", "4", "-r", "2",
        "--seq", "16", "--mesh", "--elastic", "--grad-compress", "int8_ef",
        "--failure-model", '{"kind": "correlated", "scope": "rack", '
        '"burst_prob": 1.0, "mtbf": 400.0}', "--topology",
        '{"n_groups": 4, "hosts_per_group": 2, "hosts_per_rack": 4}',
        "--seconds-per-step", "64"]) == 0
    out = capsys.readouterr().out
    assert "4 ranks on cpu, one per group; backend gloo" in out
    # a reshape, a burst at DP 2 that wipes the system out (the full
    # group restored, the rollback), and the same reshape again
    assert "[train] elastic: DP degree now 2 (full 4)" in out
    assert "wipeouts=1 reshapes=2" in out


def test_ranks_sharing_a_ckpt_dir_sweep_it_once(tmp_path):
    """Four ranks open one checkpoint directory that holds every crash
    leftover (a ``.tmp_step_*`` staging dir, a legacy ``step_*.tmp`` and
    a parked ``.old_step_*`` whose committed name is missing): every
    rank starts, the park is renamed back exactly once, the leftovers
    are gone, and every rank restores the parked checkpoint's bits.
    Renaming the park waits a second (``shared_ckpt_rank``), so ranks
    that each swept the directory would all find it and all but one
    fail."""
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    logs.mkdir()
    params = build_model(smoke_config(ARCH).scaled(**TINY),
                         device="cpu").init(0)

    def plus_one(t):
        if isinstance(t, dict):
            return {k: plus_one(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(plus_one(v) for v in t)
        return t + 1

    parked = plus_one(params)
    save_checkpoint(ckpt, 7, parked)
    (ckpt / "step_00000007").rename(ckpt / ".old_step_00000007")
    for name in (".tmp_step_00000008", "step_00000009.tmp"):
        (ckpt / name).mkdir()
    got, _ = spawn_ranks(shared_ckpt_rank, N, device="cpu",
                         args=(str(ckpt), str(logs)))
    renames = [line for f in sorted(logs.iterdir())
               for line in f.read_text().split()]
    assert renames == [".old_step_00000007"]
    assert (logs / "rank0.log").exists()
    assert got["names"] == ["step_00000007"]
    want = [t.float().numpy() for t in tree_leaves(parked)]
    for mine in got["ranks"]:
        assert mine["step"] == 7
        assert len(mine["params"]) == len(want)
        for a, b in zip(mine["params"], want):
            assert np.array_equal(_bits(a), _bits(b))
