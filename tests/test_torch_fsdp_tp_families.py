"""The dense families on the port's FSDP x TP program against the JAX
package's, on the CPU: glm4-9b (the untied ``lm_head``, SwiGLU),
starcoder2-7b (gelu's ``mlp2``), minitron-4b (relu2's), starcoder2 with
3 query heads on a model degree of 2 (1 KV head, and 3: GSPMD's padded
head blocks) and with one (model rank 1 holds none), and the
``embeds=`` frontends qwen2-vl-2b (QKV bias, tied head) and
musicgen-medium (untied head, gelu), at their smoke sizes.

The port runs the cases of ``tests/_tp_cases.py`` (``FAMILY_CASES``) on
one spawn of 4 gloo ranks (a (data 2, model 2) grid); JAX jits the same
train step, prefill and serve step with the rule table's shardings on
``make_emulated_mesh(2, 2)`` in one subprocess (``tests/_tp_jax.py
families``), from the same numpy parameters and batches.

Tolerances. The token configs run in fp32, at
``tests/test_torch_fsdp_tp.py``'s 1e-5: losses relative, the parameters
after three steps, each rank's blocks, and the prefill's and the decode
step's logits absolute. The frontends run in bf16 (the JAX model raises
on fp32 parameters with ``embeds``), at the frontends' parity
tolerances (``tests/test_torch_families.py`` and
``tests/test_torch_families_train.py``): logits within 0.1, losses
within 1e-3 relative, and each leaf's update over three steps, ``p -
p0``, within 0.3 of JAX's in the L2 norm (JAX's plain attention rounds
scores and probabilities to bf16 where the port keeps fp32). The key
bias ``bk`` is the exception: adding one bias to every key shifts a
query's scores by a constant, which the softmax cancels, so its exact
gradient is zero and both packages' are rounding noise, which AdamW
scales to about lr a step; its update is held to JAX's largest element
of the same leaf, within the same 0.3 (measured on qwen2-vl-2b: the L2
distance is 0.43 for ``bk``, 0.22 at most for every other leaf). Every case
also holds the dry run of its (2, 2) cell to the JAX step's
``memory_analysis()`` bytes and to the gloo ranks' collective schedule;
the padded cases hold the collectives the split adds, by kind, to those
of JAX's compiled step (``GSPMD_PADDED``).
"""
import collections
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _tp_cases import (FAMILY_CASES, FSDP_SHAPE, N, family_cfg,
                       family_inputs)
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.dist import tree_leaves
from repro_torch.launch.dryrun import model_flops_per_device, record_cell
from repro_torch.launch.mesh import close_data_group, spawn_ranks
from repro_torch.models import build_model
from repro_torch.models.attention import tp_heads

ROOT = Path(__file__).resolve().parents[1]
GRID = {"data": 2, "model": 2}
CASES = list(FAMILY_CASES)
TOL = 1e-5
LOGIT_TOL = {"float32": TOL, "bfloat16": 0.1}
LOSS_TOL = {"float32": TOL, "bfloat16": 1e-3}
UPDATE_TOL = 0.3


def _cfg(name: str):
    return family_cfg(smoke_config, name)


def _dtype(name: str) -> str:
    return FAMILY_CASES[name][2]


def _leaf_keys(name: str) -> list[str]:
    """Each parameter leaf's dict key, in leaf order."""
    def keys(t, key=None):
        if isinstance(t, dict):
            return [k2 for k in sorted(t) for k2 in keys(t[k], k)]
        if isinstance(t, (list, tuple)):
            return [k2 for v in t for k2 in keys(v, key)]
        return [key]

    return keys(_numpy_params(name))


def _numpy_params(name: str) -> dict:
    def host(t):
        if isinstance(t, dict):
            return {k: host(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(host(v) for v in t)
        return t.float().numpy()

    return host(build_model(_cfg(name), device="cpu").init(0))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's cases in a subprocess while the port's ranks run them."""
    tmp = tmp_path_factory.mktemp("families")
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({n: family_inputs(_numpy_params(n), _cfg(n).d_model,
                                      bool(_cfg(n).frontend))
                     for n in CASES}, f)
    flags = os.environ.get("XLA_FLAGS", "")
    proc = subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_tp_jax.py"), "families",
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


def test_the_cases_cover_each_new_part():
    """The untied head, both two-matrix MLPs, ``embeds=``, and the padded
    head split with a rank whose heads cut a KV group and a rank that
    holds no head."""
    cfgs = {n: _cfg(n) for n in CASES}
    assert {n for n, c in cfgs.items() if not c.tie_embeddings} >= {
        "glm4-9b", "starcoder2-7b", "minitron-4b", "musicgen-medium"}
    assert {c.mlp_kind for c in cfgs.values()} == {"swiglu", "gelu",
                                                   "relu2"}
    assert {n for n, c in cfgs.items() if c.frontend} == {
        "qwen2-vl-2b", "musicgen-medium"}
    for n in ("starcoder2-h3kv1", "starcoder2-h3kv3"):
        heads = [tp_heads(cfgs[n], m, 2) for m in range(2)]
        assert [(t.q0, t.n, t.split) for t in heads] == [
            (0, 2, "padded"), (2, 1, "padded")]
    assert tp_heads(cfgs["starcoder2-h3kv3"], 0, 2).kv == (0, 1)
    assert [(t.q0, t.n, t.kv) for t in (
        tp_heads(cfgs["starcoder2-h1kv1"], m, 2) for m in range(2))] == [
        (0, 1, (0,)), (1, 0, ())]


@pytest.mark.parametrize("name", CASES)
def test_losses_match_jax(runs, name):
    want = runs["jax"][name]["losses"]
    assert len(want) == 3 and len(set(want)) == 3
    tol = LOSS_TOL[_dtype(name)]
    for rank in range(N):
        got = runs["port"][name][rank]["losses"]
        for a, b in zip(got, want):
            assert abs(a - b) <= tol * abs(b) and np.isfinite(a), (rank, a, b)


@pytest.mark.parametrize("name", CASES)
def test_params_and_blocks_match_jax(runs, name):
    """After three steps: the whole parameters gathered from the ranks'
    blocks, and each rank's blocks against its device's shards (fp32);
    each leaf's update against JAX's in the L2 norm (bf16)."""
    theirs = runs["jax"][name]
    start = tree_leaves(_numpy_params(name))
    for rank in range(N):
        ours = runs["port"][name][rank]
        blocks, want = ours["blocks"], theirs["blocks"][rank]
        assert [a.shape for a in blocks] == [b.shape for b in want]
        if _dtype(name) == "float32":
            for a, b in zip(ours["params"] + blocks,
                            theirs["params"] + want):
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
            continue
        for key, a, b, p0 in zip(_leaf_keys(name), ours["params"],
                                 theirs["params"], start):
            dj = b - p0
            if key == "bk":
                # zero in exact arithmetic: noise, which AdamW scales to
                # about lr a step (see the module doc)
                assert np.abs(a - p0).max() <= \
                    (1 + UPDATE_TOL) * np.abs(dj).max(), rank
                continue
            assert np.linalg.norm((a - p0) - dj) <= \
                UPDATE_TOL * np.linalg.norm(dj), (rank, key)
    moved = [np.abs(a - s).max() for a, s in zip(theirs["params"], start)]
    assert max(moved) > 0


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_prefill_and_decode_match_jax(runs, name, which):
    want = runs["jax"][name][which]
    for rank in range(N):
        got = runs["port"][name][rank][which]
        part = _rank_block(want, rank)
        assert got.shape == part.shape
        np.testing.assert_allclose(got, part, rtol=0,
                                   atol=LOGIT_TOL[_dtype(name)])


@pytest.mark.parametrize("name", CASES)
def test_dryrun_bytes_match_jax_memory_analysis(runs, name):
    close_data_group()
    dtype = None if _dtype(name) == "bfloat16" else torch.float32
    cell, meta = record_cell(name, "fsdp_cell", False, cfg=_cfg(name),
                             axes=GRID, shape=ShapeSpec(**FSDP_SHAPE),
                             dtype=dtype)
    want = runs["jax"][name]["memory"]
    assert {"arg_bytes": cell.arg_bytes, "out_bytes": cell.out_bytes,
            "alias_bytes": cell.alias_bytes} == want
    assert meta["donate"] == (0, 1) and meta["devices"] == N
    assert model_flops_per_device(_cfg(name), ShapeSpec(**FSDP_SHAPE),
                                  N) == \
        runs["jax"][name]["model_flops_per_device"]


@pytest.mark.parametrize("name", CASES)
def test_fake_trace_schedule_equals_the_gloo_ranks(runs, name):
    """Each rank's dry-run trace on the fake group records the
    collectives its gloo rank ran in its first step, in order."""
    close_data_group()
    dtype = None if _dtype(name) == "bfloat16" else torch.float32
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for rank in range(N):
            cell, _ = record_cell(name, "fsdp_cell", False, cfg=_cfg(name),
                                  axes=GRID, shape=ShapeSpec(**FSDP_SHAPE),
                                  dtype=dtype, rank=rank)
            want = runs["port"][name][rank]["schedule"]
            assert cell.log.schedule() == want and len(want) > 0, rank
    finally:
        torch.set_num_threads(threads)


#: the port's collectives under the compiled program's names
_HLO_KIND = {"all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_reduce": "all-reduce",
             "all_to_all_single": "collective-permute"}


def _added(counts: dict, base: dict) -> dict:
    return {k: counts.get(k, 0) - base.get(k, 0)
            for k in set(counts) | set(base)
            if counts.get(k, 0) != base.get(k, 0)}


#: the collectives the padded head split adds to a layer's step in the
#: JAX package's compiled program (against starcoder2-7b's, whose heads
#: the model degree divides; each loop body once: the forward, and the
#: backward with the recomputed forward). With as many KV heads as query
#: heads (h3kv3), GSPMD's program is the port's; with fewer (h3kv1,
#: h1kv1) it reshards k and v otherwise (see ``models/attention.py``)
GSPMD_PADDED = {
    "starcoder2-h3kv3": {"all-gather": 7, "collective-permute": 5},
    "starcoder2-h3kv1": {"all-gather": 7, "all-to-all": 9,
                         "collective-permute": 9, "all-reduce": 2},
    "starcoder2-h1kv1": {"all-to-all": 12, "all-reduce": 13},
}


@pytest.mark.parametrize("name", list(GSPMD_PADDED))
def test_padded_attention_collectives_against_gspmds(runs, name):
    """The padded split's collectives by kind, a layer and microbatch:
    each rank of the port runs GSPMD's program for a model where every
    query head has its own KV head (its all-to-alls standing for the
    permutes): 7 all-gathers (q, k, v forward and recomputed, the
    output's gradient) and 5 all-to-alls (the output forward and
    recomputed; dq, dk, dv); and JAX's compiled step adds what
    ``GSPMD_PADDED`` says."""
    base = "starcoder2-7b"
    assert _added(runs["jax"][name]["collectives"],
                  runs["jax"][base]["collectives"]) == GSPMD_PADDED[name]
    cfg = _cfg(name)
    units = cfg.n_layers * cfg.grad_accum
    for rank in range(N):
        kinds = [collections.Counter(_HLO_KIND[c[0]] for c in
                                     runs["port"][n][rank]["schedule"])
                 for n in (name, base)]
        assert {k: v / units for k, v in _added(*kinds).items()} == \
            GSPMD_PADDED["starcoder2-h3kv3"], rank
