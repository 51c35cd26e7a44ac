"""The port's bucketed gradient syncs against the JAX package's, on the
CPU (gloo).

* ``bucket_layout`` equals JAX's field by field on the same parameter
  tree (the leaf order is ``jax.tree``'s: dict keys sorted), and the
  flatten/unflatten round trip is bit-transparent, with fp32 leaves as
  views into the buckets;
* ``BucketedAllReduce`` and ``CompressedBucketSync`` on a one-rank
  group (in this process) and a two-rank group (two processes) against
  the JAX syncs run as ``jax.vmap(sync, axis_name="data")`` over the
  stacked per-rank partials — JAX's collectives on one CPU device.
  Outputs and EF state identical, bit for bit, over 3 successive steps.
"""
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.dist import collectives as jcol
from repro.models import build_model as jax_build
from repro_torch.configs import smoke_config
from repro_torch.dist import collectives as tcol
from repro_torch.launch.mesh import init_data_group
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
# a tree whose dicts are not in sorted order, with a leaf larger than the
# cap, and bf16 beside fp32
SHAPES = {"w": {"k": (6, 5), "b": (7,)}, "emb": (40, 3), "layers": [(3, 11),
                                                                    (9,)]}
CAP, STEPS = 64, 3


def _tree(fn):
    return {"w": {"k": fn("w.k", SHAPES["w"]["k"]),
                  "b": fn("w.b", SHAPES["w"]["b"])},
            "emb": fn("emb", SHAPES["emb"]),
            "layers": [fn("l0", SHAPES["layers"][0]),
                       fn("l1", SHAPES["layers"][1])]}


def test_bucket_layout_matches_jax_field_by_field():
    cfg = smoke_config("qwen2.5-3b")
    params = build_model(cfg, device="cpu").init(0)
    # the same tree for JAX: its init's structure, leaf shapes and dtypes
    jparams = jax.eval_shape(jax_build(jax_smoke("qwen2.5-3b")).init,
                             jax.random.key(0))
    assert [tuple(a.shape) for a in jax.tree.leaves(jparams)] == \
        [tuple(t.shape) for t in tcol.tree_leaves(params)]
    for cap, pad in ((1 << 23, 1), (5000, 4), (1, 2)):
        want = jcol.bucket_layout(jparams, max_bucket_elems=cap, pad_to=pad)
        got = tcol.bucket_layout(params, max_bucket_elems=cap, pad_to=pad)
        for field in ("shapes", "dtypes", "bucket_of", "offsets",
                      "bucket_sizes", "pad_to", "n_buckets", "n_elems"):
            assert getattr(got, field) == getattr(want, field), field


def test_flatten_unflatten_round_trip_is_bit_transparent():
    rng = np.random.default_rng(0)
    tree = _tree(lambda name, shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(
            torch.bfloat16 if name == "w.b" else torch.float32))
    layout = tcol.bucket_layout(tree, max_bucket_elems=CAP, pad_to=4)
    bufs = tcol.flatten_grads(layout, tree)
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)
    jbufs = jcol.flatten_grads(jcol.bucket_layout(
        jtree, max_bucket_elems=CAP, pad_to=4), jtree)
    assert [b.shape[0] for b in bufs] == list(layout.bucket_sizes)
    for b, jb in zip(bufs, jbufs):
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    back = tcol.unflatten_grads(layout, bufs)
    for a, b in zip(tcol.tree_leaves(back), tcol.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # fp32 leaves are views: a write lands in the bucket ("emb" is leaf
    # 0 in the sorted order)
    back["emb"].fill_(2.0)
    assert layout.shapes[0] == SHAPES["emb"]
    assert float(bufs[layout.bucket_of[0]].max()) == 2.0


def test_weighted_all_reduce_matches_jax():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((3, 5, 4)).astype(np.float32)
    w = rng.random((3, 5)).astype(np.float32)
    want = jcol.weighted_all_reduce(jnp.asarray(v), jnp.asarray(w))
    got = tcol.weighted_all_reduce(torch.from_numpy(v), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ------------------------------------------------------------------ #
# the syncs, against jax.vmap over the stacked per-rank partials     #
# ------------------------------------------------------------------ #
def _partials(dp: int) -> list[list[dict]]:
    """``[step][rank]`` trees of numpy fp32 partial gradients."""
    rng = np.random.default_rng(dp)
    return [[_tree(lambda name, shape: (rng.standard_normal(shape)
                                        * 10.0 ** rng.integers(-3, 1))
                   .astype(np.float32)) for _ in range(dp)]
            for _ in range(STEPS)]


def _jax_reference(dp: int, compressed: bool) -> list[dict]:
    """Per step: the reduced leaves (rank 0's copy; every rank holds the
    same) and, compressed, every rank's EF state."""
    partials = _partials(dp)
    template = jax.tree.map(jnp.asarray, partials[0][0])
    layout = jcol.bucket_layout(template, max_bucket_elems=CAP, pad_to=dp)
    out = []
    if compressed:
        sync = jcol.CompressedBucketSync(layout, dp, "data", fused=False)
        state = {"err1": tuple(jnp.zeros((dp, s), jnp.float32)
                               for s in layout.bucket_sizes),
                 "err2": tuple(jnp.zeros((dp, s // dp), jnp.float32)
                               for s in layout.bucket_sizes)}
        run = jax.vmap(sync, axis_name="data")
    else:
        sync = jcol.BucketedAllReduce(layout, "data")
        run = jax.vmap(lambda g: sync(g), axis_name="data")
    for step in partials:
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *step)
        if compressed:
            reduced, state = run(stacked, state)
            ef = {k: [np.asarray(x) for x in v] for k, v in state.items()}
        else:
            reduced, ef = run(stacked), None
        out.append({"leaves": [np.asarray(x)[0]
                               for x in jax.tree.leaves(reduced)],
                    "ef": ef})
    return out


WORKER = r"""
import sys
import numpy as np
import torch
from repro_torch.dist import collectives as tcol
from repro_torch.launch.mesh import close_data_group, init_data_group

rank, dp, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4], sys.argv[5])
group = init_data_group("cpu", world_size=dp, rank=rank, store_path=store)
data = np.load(inp)
{port_run}
for compressed in (0, 1):
    np.savez(out % (rank, compressed),
             **port_run(rank, dp, bool(compressed), group, data))
close_data_group()
"""


def _tree_of(data, step: int, rank: int) -> dict:
    return _tree(lambda name, shape: torch.from_numpy(
        data[f"s{step}_r{rank}_{name}"].copy()))


def port_run(rank: int, dp: int, compressed: bool, group, data) -> dict:
    """This rank's side of the sync over the steps of ``data`` (the
    partials, keyed ``s{step}_r{rank}_{leaf}``): reduced leaves and EF
    state per step, as arrays keyed ``s{step}_...``."""
    layout = tcol.bucket_layout(_tree_of(data, 0, rank),
                                max_bucket_elems=CAP, pad_to=dp)
    if compressed:
        sync = tcol.CompressedBucketSync(layout, dp, group)
        state = sync.init_state("cpu")
    else:
        sync = tcol.BucketedAllReduce(layout, group)
    out = {}
    for s in range(STEPS):
        bufs = tcol.flatten_grads(layout, _tree_of(data, s, rank))
        if compressed:
            reduced, state = sync(bufs, state)
            for k, v in state.items():
                for b, t in enumerate(v):
                    out[f"s{s}_{k}_{b}"] = t.numpy().copy()
        else:
            reduced = sync(bufs)
        for i, leaf in enumerate(tcol.tree_leaves(reduced)):
            out[f"s{s}_leaf{i}"] = leaf.numpy().copy()
    return out


def _partials_npz(dp: int) -> dict:
    data = {}
    for s, step in enumerate(_partials(dp)):
        for r, tree in enumerate(step):
            _tree(lambda name, shape: data.setdefault(
                f"s{s}_r{r}_{name}", _leaf(tree, name)))
    return data


def _leaf(tree, name):
    return {"w.k": tree["w"]["k"], "w.b": tree["w"]["b"], "emb": tree["emb"],
            "l0": tree["layers"][0], "l1": tree["layers"][1]}[name]


def _compare(got_by_rank: list[dict], want: list[dict]) -> None:
    for rank, got in enumerate(got_by_rank):
        for s, ref in enumerate(want):
            for i, leaf in enumerate(ref["leaves"]):
                np.testing.assert_array_equal(
                    got[f"s{s}_leaf{i}"].view(np.uint32),
                    leaf.view(np.uint32), err_msg=f"step {s} leaf {i}")
            if ref["ef"] is None:
                continue
            for k, per_bucket in ref["ef"].items():
                for b, arr in enumerate(per_bucket):
                    np.testing.assert_array_equal(
                        got[f"s{s}_{k}_{b}"].view(np.uint32),
                        arr[rank].view(np.uint32),
                        err_msg=f"step {s} {k}[{b}] rank {rank}")


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["fp32_buckets", "int8_ef"])
def test_sync_on_one_rank_matches_jax_vmap(compressed, tmp_path):
    group = init_data_group("cpu", store_path=str(tmp_path / "store"))
    _compare([port_run(0, 1, compressed, group, _partials_npz(1))],
             _jax_reference(1, compressed))


def test_syncs_on_two_ranks_match_jax_vmap(tmp_path):
    """Two gloo ranks in two processes, both syncs, 3 steps each."""
    helpers = "\n".join(inspect.getsource(f) for f in (_tree, _tree_of,
                                                         port_run))
    code = WORKER.replace("{port_run}", f"CAP, STEPS = {CAP}, {STEPS}\n"
                          f"SHAPES = {SHAPES!r}\n{helpers}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    inp = tmp_path / "partials.npz"
    np.savez(inp, **_partials_npz(2))
    out = str(tmp_path / "rank%d_%d.npz")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), "2", str(tmp_path / "store"),
         str(inp), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), json.dumps(logs)
    for compressed in (0, 1):
        _compare([dict(np.load(out % (r, compressed))) for r in range(2)],
                 _jax_reference(2, bool(compressed)))
