"""The FSDP x TP program of the port (``build_model(cfg, mesh=groups)``
and ``make_train_step(model, grad_shardings=specs)``) against the JAX
package's, on the CPU.

The port runs the cases of ``tests/_tp_cases.py`` (``fsdp``) on 4 gloo
ranks (spawned processes, a (data 2, model 2) grid, ``FileStore``
rendezvous); JAX jits ``make_train_step(model, grad_shardings=...)``,
``make_prefill(model, return_cache=True)`` and the serve step with the
rule table's shardings on ``make_emulated_mesh(2, 2)`` in one subprocess
(``tests/_tp_jax.py fsdp``), from the same numpy parameters and batches:
smoke qwen2.5-3b in fp32, 2 KV heads and 1 (fewer KV heads than model
ranks: each rank holds half a KV head, gathers ``wk`` and ``wv`` over
the model group and takes the head its query heads read).

Tolerances: fp32 summation order (XLA's CPU products and collectives
against torch's; the port's vocabulary-parallel log-sum-exp sums its
two halves in another grouping), as ``tests/test_torch_tp.py``: losses
within 1e-5 relative, the whole parameters after three steps and each
rank's stored blocks (its device's shards of JAX's arrays) within 1e-5
absolute, the prefill's and the decode step's logits (each rank's
examples and vocabulary columns) within 1e-5 absolute. The dry run of
the same (2, 2) cell: its argument, output and aliased bytes equal the
JAX step's ``memory_analysis()`` (XLA's output count includes its output
tuple's 8-byte table, which the dry run counts the same way), and its
``model_flops_per_device`` JAX's. The dry run's trace on the fake group
records, rank by rank, the gloo ranks' collective schedule of the first
step.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _tp_cases import (ARCH, FSDP_ACCUM, FSDP_KV, FSDP_SHAPE, N,
                       fsdp_inputs)
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.launch.dryrun import model_flops_per_device, record_cell
from repro_torch.launch.mesh import close_data_group, spawn_ranks
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
GRID = {"data": 2, "model": 2}


def _cfg(kv: int):
    return smoke_config(ARCH).scaled(grad_accum=FSDP_ACCUM, n_kv_heads=kv)


def _numpy_params(kv: int) -> dict:
    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(host(v) for v in t)
        return t.float().numpy()

    return host(build_model(_cfg(kv), device="cpu").init(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's cases in a subprocess while the port's ranks run them."""
    tmp = tmp_path_factory.mktemp("fsdp")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({kv: fsdp_inputs(_numpy_params(kv)) for kv in FSDP_KV},
                    f)
    flags = os.environ.get("XLA_FLAGS", "")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_tp_jax.py"), "fsdp",
         str(inputs), str(tmp / "jax.pkl")],
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(ROOT / "src"),
                 XLA_FLAGS=f"{flags} --xla_force_host_platform_device_count="
                           f"{N}".strip()),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port, _ = spawn_ranks(__import__("_tp_cases").port_fsdp_rank, N,
                              device="cpu", args=(str(inputs),))
        log = proc.communicate(timeout=900)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, log[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        jax_cases = pickle.load(f)
    return {"port": port, "jax": jax_cases}


def _rank_block(want: np.ndarray, rank: int) -> np.ndarray:
    """Rank ``d * 2 + m``'s part of whole logits: its examples (data),
    its vocabulary columns (model)."""
    d, m = divmod(rank, 2)
    b, v = want.shape[0] // 2, want.shape[-1] // 2
    return want[d * b:(d + 1) * b, ..., m * v:(m + 1) * v]


@pytest.mark.parametrize("kv", FSDP_KV)
def test_losses_match_jax(runs, kv):
    want = runs["jax"][kv]["losses"]
    assert len(want) == 3 and len(set(want)) == 3
    for rank in range(N):
        got = runs["port"][kv][rank]["losses"]
        for a, b in zip(got, want):
            assert abs(a - b) <= TOL * abs(b) and np.isfinite(a), (rank, a, b)


@pytest.mark.parametrize("kv", FSDP_KV)
def test_params_and_blocks_match_jax(runs, kv):
    """After three steps: the whole parameters gathered from the ranks'
    blocks, and each rank's blocks against its device's shards."""
    theirs = runs["jax"][kv]
    start = _numpy_params(kv)
    from repro_torch.dist import tree_leaves
    moved = [np.abs(a - s).max() for a, s in zip(theirs["params"],
                                                 tree_leaves(start))]
    assert min(moved) > 0
    for rank in range(N):
        ours = runs["port"][kv][rank]
        for a, b in zip(ours["params"], theirs["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        blocks, want = ours["blocks"], theirs["blocks"][rank]
        assert [a.shape for a in blocks] == [b.shape for b in want]
        for a, b in zip(blocks, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    sharded = [a.shape != b.shape for a, b in
               zip(runs["port"][kv][0]["blocks"], theirs["params"])]
    assert any(sharded) and not all(sharded)


@pytest.mark.parametrize("kv", FSDP_KV)
@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_prefill_and_decode_match_jax(runs, kv, which):
    want = runs["jax"][kv][which]
    for rank in range(N):
        got = runs["port"][kv][rank][which]
        part = _rank_block(want, rank)
        assert got.shape == part.shape
        np.testing.assert_allclose(got, part, rtol=0, atol=TOL)


@pytest.mark.parametrize("kv", FSDP_KV)
def test_dryrun_bytes_match_jax_memory_analysis(runs, kv):
    cell, meta = record_cell(ARCH, "fsdp_cell", False, cfg=_cfg(kv),
                             axes=GRID, shape=ShapeSpec(**FSDP_SHAPE),
                             dtype=torch.float32)
    want = runs["jax"][kv]["memory"]
    assert {"arg_bytes": cell.arg_bytes, "out_bytes": cell.out_bytes,
            "alias_bytes": cell.alias_bytes} == want
    assert meta["donate"] == (0, 1) and meta["devices"] == N


def test_model_flops_per_device_matches_jax(runs):
    for kv in FSDP_KV:
        assert model_flops_per_device(_cfg(kv), ShapeSpec(**FSDP_SHAPE),
                                      N) == \
            runs["jax"][kv]["model_flops_per_device"]


@pytest.mark.parametrize("kv", FSDP_KV)
def test_fake_trace_schedule_equals_the_gloo_ranks(runs, kv):
    """Each rank's dry-run trace on the fake group (storage-free
    tensors) records the collectives its gloo rank issued in its first
    step, in order, on the same groups."""
    close_data_group()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for rank in range(N):
            cell, _ = record_cell(ARCH, "fsdp_cell", False, cfg=_cfg(kv),
                                  axes=GRID, shape=ShapeSpec(**FSDP_SHAPE),
                                  dtype=torch.float32, rank=rank)
            want = runs["port"][kv][rank]["schedule"]
            assert cell.log.schedule() == want and len(want) > 0, rank
    finally:
        torch.set_num_threads(threads)


def test_dryrun_list_matches_jax(runs, capsys):
    from repro_torch.launch import dryrun

    dryrun.main(["--list"])
    assert capsys.readouterr().out.splitlines() == runs["jax"]["cell_list"]
