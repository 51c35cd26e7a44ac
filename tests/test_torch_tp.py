"""Tensor parallelism of the port (the mesh executor at model degree 2)
against the JAX package's, on the CPU.

The port's ``MeshExecutor(model_degree=2)`` on 4 gloo ranks (spawned
processes, a (data 2, model 2) grid, ``FileStore`` rendezvous) and JAX's
``MeshExecutor(mesh=make_emulated_mesh(2, 2))`` on 4 emulated devices
(one subprocess, ``tests/_tp_jax.py``) run the cases of
``tests/_tp_cases.py`` from the same numpy parameters (smoke qwen2.5-3b
in fp32, N 4, r 2, seq 16), in three arms: ``shard_map`` with fp32
buckets, ``shard_map`` with the int8 EF sync, ``gspmd``.

Tolerances. Reports (counts, events, ``S_A``) and cache keys are equal.
The §3.1 survivor sweep on the ranks: every recoverable set's mesh
gradient against the host SPARe and vanilla-DP gradients within 5e-3
(the JAX sweep's tolerance), and within ``int8_sweep_tolerance(2)`` in
the int8 arm.
Gradients (``mesh_grads``, healthy and masked): each leaf within 1e-5 of
its largest |JAX| element (fp32 summation order: XLA's CPU products and
all-reduce against torch's); the int8 arm's within the §3.1 sweep's
oracle, ``int8_sweep_tolerance(2)`` of the tree's largest element (one
step of the quantised sync from zero residuals on either side). Losses
within 1e-5 relative and the whole parameters after three steps within
1e-5 absolute (as
``tests/test_torch_elastic.py``), except the int8 EF arm: its three
updates amplify single-code quantization flips through AdamW, so its
parameter updates are held to 5e-2 in L2 (as
``tests/test_torch_hybrid_train.py``). Each ``gspmd`` rank's stored
blocks are its device's shards in JAX's arrays, within the same 1e-5;
the two model ranks of a data slice hold bit-identical replicas under
``shard_map``. What the port computes twice is compared bit for bit: the
wire gauges of a masked and a healthy step at one ``S_A``, and the
``gspmd`` disk checkpoint against a model degree 1 executor's save of
the same state (byte for byte, the clocks fixed).

The launcher: ``--mesh --model-degree 2`` in both syncs prints the JAX
launcher's ``[train]`` lines for the same flags, but for the losses and
the wall time (each side draws its own parameters).
"""
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _tp_cases import ARCH, ARMS, KW, N
from repro_torch.configs import smoke_config
from repro_torch.exec import (MeshExecutor, int8_sweep_tolerance,
                              recoverable_failure_sets)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
#: the JAX package's §3.1 sweep tolerance (``tests/test_exec.py``)
SWEEP_TOL = 5e-3
EF_UPDATE_L2 = 5e-2
#: the launcher runs both packages take, and the lines of theirs that
#: must agree
CLI_RUNS = {
    "gspmd": ["--mesh", "--model-degree", "2", "--sync", "gspmd",
              "--n-groups", "2", "-r", "1", "--steps", "4", "--seq", "16",
              "--mtbf-steps", "2"],
    "int8_ef": ["--mesh", "--model-degree", "2", "--sync", "shard_map",
                "--grad-compress", "int8_ef", "--n-groups", "4", "-r", "2",
                "--steps", "4", "--seq", "16", "--mtbf-steps", "2"],
}


def _numpy_params() -> dict:
    model = build_model(smoke_config(ARCH).scaled(grad_accum=1),
                        device="cpu")

    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(host(v) for v in t)
        return t.float().numpy()

    return host(model.init(0))


def _jax_env() -> dict:
    flags = os.environ.get("XLA_FLAGS", "")
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=str(ROOT / "src"),
                XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count="
                          f"{N}".strip())


def _cli_lines(text: str) -> list[str]:
    """The ``[train]`` lines both launchers print, without what differs
    by design: the losses, the wall time, the device, the head dim."""
    out = []
    for line in text.splitlines():
        if not line.startswith("[train]") or " ranks on " in line:
            continue
        line = re.sub(r" in [0-9.]+s \([0-9.]+s/step\)( on \S+)?", "", line)
        line = re.sub(r"loss [0-9.]+ -> [0-9.]+", "loss", line)
        line = re.sub(r" head_dim=\d+", "", line)
        out.append(line)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's cases and its two launcher runs in subprocesses while the
    port's ranks run the same cases."""
    tmp = tmp_path_factory.mktemp("tp")
    params = tmp / "params.pkl"
    with open(params, "wb") as f:
        pickle.dump(_numpy_params(), f)
    procs = {"cases": subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_tp_jax.py"), "tp",
         str(params), str(tmp / "jax.pkl")], env=_jax_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    for name, argv in CLI_RUNS.items():
        # the JAX launcher fans the host out into n_groups x degree
        # devices itself
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", *argv],
            env=dict(os.environ, JAX_PLATFORMS="cpu",
                     PYTHONPATH=str(ROOT / "src")),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        (tmp / "ckpt").mkdir()
        port, backend = spawn_ranks(
            __import__("_tp_cases").port_tp_rank, N, device="cpu",
            args=(str(params), str(tmp / "ckpt")))
        logs = {name: p.communicate(timeout=900)[0]
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, logs[name][-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        jax_cases = pickle.load(f)
    return {"port": port, "backend": backend, "jax": jax_cases,
            "jax_cli": {n: logs[n] for n in CLI_RUNS}}


def _close_to_largest(got, want, tol: float = TOL) -> None:
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        err = np.abs(a.astype(np.float64) - b).max()
        assert err <= tol * max(np.abs(b).max(), 1e-30), (i, err)


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
@pytest.mark.parametrize("which", ["grads", "grads_masked"])
def test_mesh_grads_match_jax(runs, arm, which):
    """``mesh_grads`` at step 0, healthy and with group 0 masked: every
    rank's whole gradient against JAX's (the int8 arm's quantised sync
    included: both run one step of it from zero residuals)."""
    want = runs["jax"][arm][which]
    for rank in range(N):
        got = runs["port"][arm][rank][which]
        if "int8" not in arm:
            _close_to_largest(got, want)
            continue
        # one step's quantisation: the §3.1 sweep's oracle over the tree
        diff = max(np.abs(a.astype(np.float64) - b).max()
                   for a, b in zip(got, want))
        scale = max(np.abs(b).max() for b in want)
        assert diff <= int8_sweep_tolerance(2) * scale, diff / scale


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_survivor_set_sweep_on_the_ranks(runs, arm):
    """``survivor_set_sweep`` at data degree 2: each rank's gradient of
    every recoverable survivor set, through its rows of the masked
    schedule and the weighted all-reduce across the data ranks, against
    the host oracles."""
    want = [v for v, _ in recoverable_failure_sets(N, KW["redundancy"])]
    tol = int8_sweep_tolerance(2) if "int8" in arm else SWEEP_TOL
    for rank in range(N):
        sweep = runs["port"][arm][rank]["sweep"]
        assert [c[0] for c in sweep] == want
        assert [c[0] for c in sweep if len(c[0]) == 1] == \
            [(0,), (1,), (2,), (3,)]
        for victims, s_a, vs_host, vs_vanilla in sweep:
            assert s_a == 2 and vs_host <= tol and vs_vanilla <= tol, \
                (rank, victims, vs_host, vs_vanilla)


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_three_steps_through_a_masked_kill_match_jax(runs, arm):
    ours, theirs = runs["port"][arm], runs["jax"][arm]
    for rank in range(N):
        rep = ours[rank]["report"]
        assert {k: v for k, v in rep.items() if k != "losses"} == \
            {k: v for k, v in theirs["report"].items() if k != "losses"}
        for a, b in zip(rep["losses"], theirs["report"]["losses"]):
            assert abs(a - b) <= TOL * abs(b) and np.isfinite(a)
        assert ours[rank]["cache_keys"] == theirs["cache_keys"] == \
            [[2, 2, 1], [2, 2, 2]]
        assert ours[rank]["opt_step"] == theirs["opt_step"]
    rep = theirs["report"]
    assert rep["failures"] == 1 and rep["wipeouts"] == 0
    start = pickle.loads(pickle.dumps(_numpy_params()))
    from repro_torch.dist import tree_leaves
    start = tree_leaves(start)
    for rank in range(N):
        got = ours[rank]["params"]
        if "int8" in arm:
            for a, b, s in zip(got, theirs["params"], start):
                want = b.astype(np.float64) - s
                diff = np.linalg.norm(a.astype(np.float64) - b)
                assert diff <= EF_UPDATE_L2 * max(np.linalg.norm(want),
                                                  1e-30)
        else:
            for a, b in zip(got, theirs["params"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_each_rank_stores_its_block(runs, arm):
    """``gspmd``: each rank's stored leaves are its device's shards of
    JAX's arrays (columns on the model axis, the rest whole).
    ``shard_map``: every rank holds the whole replicas, and the two model
    ranks of a data slice the same bits."""
    ours, theirs = runs["port"][arm], runs["jax"][arm]
    for rank in range(N):
        got = ours[rank]["blocks"]
        want = theirs["blocks"][rank]
        if "int8" in arm:
            assert [a.shape for a in got] == [b.shape for b in want]
        else:
            for a, b in zip(got, want):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    if arm == "gspmd":
        sharded = [a.shape != b.shape for a, b in
                   zip(ours[0]["blocks"], ours[0]["params"])]
        assert any(sharded) and not all(sharded)
    else:
        for d in range(2):
            for a, b in zip(ours[2 * d]["blocks"], ours[2 * d + 1]["blocks"]):
                np.testing.assert_array_equal(a.view(np.uint32),
                                              b.view(np.uint32))


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_masked_and_healthy_wire_gauges_are_equal(runs, arm):
    """A masked step and a healthy one at the same ``S_A`` publish the
    same ``sync.*`` wire bytes and collectives (under ``gspmd`` the
    model group's gathers included), on every rank."""
    for rank in range(N):
        rec = runs["port"][arm][rank]
        g = rec["gauges"]
        assert g["masked"] == g["healthy"]
        assert g["healthy"][0] > 0 and g["healthy"][1] > 0
        # every step moves the same bytes, whatever its S_A
        assert rec["wire_total"] == g["healthy"][0] * rec["steps_total"]
    if arm == "gspmd":
        fp32 = runs["port"]["shard_map"][0]["gauges"]["healthy"]
        ours = runs["port"]["gspmd"][0]["gauges"]["healthy"]
        assert ours[0] > fp32[0] and ours[1] > fp32[1]


def test_gspmd_checkpoint_is_the_model_degree_one_file(runs):
    save = runs["port"]["gspmd"][0]["save"]
    for name, (ours, one) in save.items():
        assert ours == one, name
        assert len(ours) > 0


def test_int8_ef_is_refused_under_gspmd():
    from repro.exec import MeshExecutor as JaxMeshExecutor
    from repro.configs import smoke_config as jax_smoke

    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    with pytest.raises(ValueError, match="shard_map"):
        MeshExecutor(cfg, sync="gspmd", grad_compress="int8_ef",
                     device="cpu", **KW)
    with pytest.raises(ValueError, match="shard_map"):
        JaxMeshExecutor(jax_smoke(ARCH), sync="gspmd",
                        grad_compress="int8_ef", **KW)
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--mesh", "--sync", "gspmd",
                        "--grad-compress", "int8_ef"])


@pytest.mark.parametrize("name", list(CLI_RUNS))
def test_train_cli_model_degree_matches_the_jax_launcher(runs, name,
                                                         capsys):
    assert train_cli.main(["--device", "cpu", *CLI_RUNS[name]]) == 0
    out = capsys.readouterr().out
    ours, theirs = _cli_lines(out), _cli_lines(runs["jax_cli"][name])
    assert ours == theirs and len(ours) >= 3, (ours, theirs)
    world = 2 * int(CLI_RUNS[name][CLI_RUNS[name].index("--n-groups") + 1])
    assert f"[train] {world} ranks on cpu" in out


def test_elastic_tier_refuses_model_degree_two(capsys):
    """The elastic tier no longer refuses model degree 2: the executor
    takes it (on one rank it stops only where the mesh executor does,
    at ranks that do not tile the grid), and the launcher runs it on a
    grid of spawned ranks (``tests/test_torch_elastic_grid.py`` holds
    both against JAX)."""
    from repro_torch.elastic import ElasticMeshExecutor

    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    with pytest.raises(ValueError, match="do not tile a grid"):
        ElasticMeshExecutor(cfg, model_degree=2, device="cpu", **KW)
    assert train_cli.main(["--device", "cpu", "--mesh", "--elastic",
                           "--model-degree", "2", "--n-groups", "2", "-r",
                           "1", "--steps", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "mesh=2x2/shard_map" in out
    assert "[train] 4 ranks on cpu, a row of 2 per group" in out


@pytest.mark.parametrize("arm", [a[0] for a in ARMS])
def test_fake_group_step_logs_equal_the_gloo_ranks(runs, arm):
    """Each gloo rank's recorded collective schedule of a healthy and a
    masked step equals the one the lint's fake group records for the same
    rank, executor and state: the fake group, whose collectives move
    nothing, certifies the schedule the ranks really run."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import Rectlr, SpareState
    from repro_torch.launch.lint import fake_grid
    from repro_torch.launch.mesh import close_data_group
    from repro_torch.models import params_from_numpy

    _, sync, compress = next(a for a in ARMS if a[0] == arm)
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    masked = SpareState(N, KW["redundancy"])
    Rectlr().on_failures(masked, [0])
    params = _numpy_params()
    close_data_group()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny steps on a loaded host
    try:
        for rank in range(N):
            with fake_grid(rank, N) as group:
                ex = MeshExecutor(cfg, model_degree=2, sync=sync,
                                  grad_compress=compress, group=group,
                                  device="cpu", **KW)
                try:
                    ex.place_state(params_from_numpy(params, "cpu"))
                    got = [ex.step_log().schedule(),
                           ex.step_log(masked).schedule()]
                finally:
                    ex.close()
            want = runs["port"][arm][rank]["schedules"]
            assert got == want and len(got[0]) > 0, rank
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()
