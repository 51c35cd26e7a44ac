"""The port's sharding rule table (``repro_torch.dist.sharding``) and the
mesh executor's ``gspmd`` layout rule against the JAX package's, on the
CPU.

Every config under ``configs/``, at smoke and at published widths: the
JAX trees come from ``jax.eval_shape`` of its model's ``init`` and
``init_decode_state`` / ``init_paged_state``, the port's from its model
on ``meta`` (shapes, no storage). The specs must be equal leaf for leaf
(a JAX ``PartitionSpec``'s entries against the port's tuple), for both
production meshes, unfitted and fitted to ``{data: 2, model: 2}`` and
``{data: 16, model: 16}``. Exact equality: there is no tolerance. The
JAX functions that read a mesh read only its ``shape``, so a stand-in
with the axis sizes serves them; no device is needed.

The block helpers (``local_shard``, ``gather_shards``) are held against
numpy slicing of the whole leaf, over 4 gloo CPU ranks.
"""
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.dist import sharding as jax_sharding
from repro.exec import executor_param_specs as jax_executor_param_specs
from repro.models.model import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.dist import sharding
from repro_torch.exec import executor_param_specs
from repro_torch.launch.mesh import (PRODUCTION_AXES, dp_axes, dp_degree,
                                     spawn_ranks)
from repro_torch.models import build_model
from repro_torch.optim import adamw_init

WIDTHS = ("smoke", "published")
FITS = {"unfitted": None, "2x2": {"data": 2, "model": 2},
        "16x16": {"data": 16, "model": 16}}


def _configs(arch: str, width: str):
    if width == "smoke":
        return jax_smoke_config(arch), smoke_config(arch)
    return jax_get_config(arch), get_config(arch)


@lru_cache(maxsize=None)
def _trees(arch: str, width: str):
    """(JAX shapes, port meta tensors): params, dense decode caches and
    paged pools at batch 16, 128 positions, 64 pages of 16."""
    jcfg, cfg = _configs(arch, width)
    jm, tm = jax_build_model(jcfg), build_model(cfg, device="meta")
    jax_trees = (jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                 jax.eval_shape(lambda: jm.init_decode_state(16, 128)),
                 jax.eval_shape(lambda: jm.init_paged_state(16, 64, 16)))
    port_trees = (tm.init(0), tm.init_decode_state(16, 128),
                  tm.init_paged_state(16, 64, 16))
    return jax_trees, port_trees


def _jax_leaves(specs) -> list[tuple]:
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _mesh(multi_pod: bool, fit=None) -> SimpleNamespace:
    """The JAX functions' mesh, as far as they read it."""
    sizes = dict(PRODUCTION_AXES["multi_pod" if multi_pod
                                 else "single_pod"])
    sizes.update(fit or {})
    return SimpleNamespace(shape=sizes)


def test_production_axes_and_dp_helpers_match_jax():
    """The production meshes' axis sizes are ``make_production_mesh``'s
    shapes (the JAX module states them; building the mesh would need 512
    devices), and ``dp_axes`` / ``dp_degree`` are JAX's."""
    from repro.launch import mesh as jax_mesh

    assert PRODUCTION_AXES == {
        "single_pod": {"data": 16, "model": 16},
        "multi_pod": {"pod": 2, "data": 16, "model": 16}}
    for multi_pod in (False, True):
        sizes = _mesh(multi_pod).shape
        assert dp_axes(multi_pod) == jax_mesh.dp_axes(multi_pod)
        assert dp_degree(sizes, multi_pod) == \
            jax_mesh.dp_degree(_mesh(multi_pod), multi_pod)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax(arch, width):
    """``param_specs`` leaf for leaf, both production meshes, fitted and
    unfitted; and ``opt_specs`` mirrors them."""
    (jp, _, _), (tp, _, _) = _trees(arch, width)
    jcfg, cfg = _configs(arch, width)
    assert [tuple(t.shape) for t in
            sharding.spec_leaves(tp, tp)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    for multi_pod in (False, True):
        for name, fit in FITS.items():
            want = _jax_leaves(jax_sharding.param_specs(jp, jcfg, multi_pod,
                                                        axis_sizes=fit))
            got = sharding.param_specs(tp, cfg, multi_pod, axis_sizes=fit)
            assert sharding.spec_leaves(got, tp) == want, (multi_pod, name)
    p_spec = sharding.param_specs(tp, cfg, False)
    opt = sharding.opt_specs(adamw_init(tp), p_spec)
    assert opt.step == () and opt.mu is p_spec and opt.nu is p_spec


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_jax(arch, width):
    """``cache_specs`` of the dense decode caches and
    ``paged_cache_specs`` of the page pools, leaf for leaf."""
    (_, jc, jpool), (_, tc, tpool) = _trees(arch, width)
    jcfg, cfg = _configs(arch, width)
    for multi_pod in (False, True):
        for fit in (None, {"data": 2, "model": 2}):
            mesh = _mesh(multi_pod, fit)
            want = _jax_leaves(jax_sharding.cache_specs(jc, jcfg, mesh,
                                                        multi_pod))
            got = sharding.cache_specs(tc, cfg, mesh.shape, multi_pod)
            assert sharding.spec_leaves(got, tc) == want
            want = _jax_leaves(jax_sharding.paged_cache_specs(
                jpool, jcfg, mesh, multi_pod))
            got = sharding.paged_cache_specs(tpool, cfg, mesh.shape,
                                             multi_pod)
            assert sharding.spec_leaves(got, tpool) == want


@pytest.mark.parametrize("degree", [1, 2, 16])
@pytest.mark.parametrize("width", WIDTHS)
def test_executor_param_specs_match_jax(width, degree):
    """The ``gspmd`` layout's rule, every config: ``P(..., "model")``
    for a leaf of ndim >= 2 whose last dim the degree divides, else
    ``P()``."""
    for arch in sorted(ARCHS):
        (jp, _, _), (tp, _, _) = _trees(arch, width)
        want = _jax_leaves(jax_executor_param_specs(jp, degree))
        got = executor_param_specs(tp, degree)
        assert sharding.spec_leaves(got, tp) == want, arch


@pytest.mark.parametrize("batch", [1, 2, 8, 16, 24, 32, 64, 512])
def test_batch_spec_matches_jax(batch):
    for multi_pod in (False, True):
        for fit in (None, {"data": 2, "model": 2}):
            mesh = _mesh(multi_pod, fit)
            assert sharding.batch_spec(batch, mesh.shape, multi_pod) == \
                jax_sharding.batch_spec(batch, mesh, multi_pod)


def test_mesh_axis_sizes_of_a_grid():
    from repro_torch.launch.mesh import MeshGroups

    grid = MeshGroups(data_group=None, model_group=None, data_rank=1,
                      model_rank=0, data_degree=4, model_degree=2)
    assert sharding.mesh_axis_sizes(grid) == {"data": 4, "model": 2}
    assert sharding.mesh_axis_sizes({"data": 16, "model": 16}) == \
        jax_sharding.mesh_axis_sizes(_mesh(False))


# ------------------------------------------------------------------ #
# the block helpers on a (2, 2) grid of gloo ranks                   #
# ------------------------------------------------------------------ #
#: (shape, spec): a column-parallel matrix, a row-parallel one, an
#: expert stack and a stacked layer leaf, each cut on its axes
BLOCK_CASES = [((6, 8), ("data", "model")), ((8, 6), ("model", "data")),
               ((4, 3, 5), ("model", None, None)),
               ((3, 4, 6), (None, "data", "model")), ((5,), (None,))]


def _blocks_rank(rank: int, world: int, cases) -> dict | None:
    """Each case's block on this rank of a (2, 2) grid, and the whole
    leaf gathered back over the grid's groups."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as sh
    from repro_torch.launch.mesh import init_mesh_groups

    grid = init_mesh_groups(dist.group.WORLD, 2)
    coords = {"data": grid.data_rank, "model": grid.model_rank}
    sizes = {"data": grid.data_degree, "model": grid.model_degree}
    groups = {"data": grid.data_group, "model": grid.model_group}
    out = []
    for shape, spec in cases:
        whole = torch.arange(int(np.prod(shape)),
                             dtype=torch.float32).reshape(shape)
        block = sh.local_shard(whole, spec, coords, sizes)
        out.append((block.numpy().copy(), block.is_contiguous(),
                    sh.gather_shards(block, spec, groups).numpy().copy()))
    every = [None] * world
    dist.all_gather_object(every, {"coords": coords, "cases": out})
    return every if rank == 0 else None


def test_local_shard_and_gather_shards_on_a_grid():
    """Rank ``d * 2 + m`` holds, along each sharded dim, the block at its
    coordinate (numpy's slice of the whole leaf), contiguous; gathering
    the blocks over the data and model groups rebuilds the leaf exactly
    on every rank."""
    every, _ = spawn_ranks(_blocks_rank, 4, device="cpu",
                           args=(BLOCK_CASES,))
    for rank, rec in enumerate(every):
        assert rec["coords"] == {"data": rank // 2, "model": rank % 2}
        for (shape, spec), (block, contiguous, whole) in zip(
                BLOCK_CASES, rec["cases"]):
            want = np.arange(int(np.prod(shape)),
                             dtype=np.float32).reshape(shape)
            np.testing.assert_array_equal(whole, want)
            idx = tuple(
                slice(None) if e is None else
                slice(rec["coords"][e] * (n // 2),
                      (rec["coords"][e] + 1) * (n // 2))
                for e, n in zip(spec, shape))
            np.testing.assert_array_equal(block, want[idx])
            assert contiguous
