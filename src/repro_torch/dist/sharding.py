"""Name-based production sharding rules (FSDP x TP on the launch meshes),
the counterpart of ``repro.dist.sharding``.

One rule table maps every parameter leaf, identified by its dict key
and rank, to a spec over the production mesh axes of
:mod:`repro_torch.launch.mesh` (``(pod,) data, model``):

* **column-parallel** projections (``wq``/``wk``/``wv``, MLP up/gate,
  MLA down-projections): output features on ``model``, input features
  FSDP-sharded across the data axes;
* **row-parallel** projections (``wo``, MLP down): input features on
  ``model``, output features FSDP across data;
* **routed experts** (3-D ``w_gate``/``w_up``/``w_down``): expert axis on
  ``model``, the layout :func:`repro_torch.models.moe.moe_ffn` takes on
  a model group;
* **vectors** (norm scales, biases, ``a_log``...) and the tiny router:
  replicated.

Torch has no ``PartitionSpec``: a spec is a tuple with one entry a
dimension, each ``None`` (replicated), an axis name, or a tuple of axis
names (a dimension split over their product, the first axis outermost),
the entries of the JAX package's ``PartitionSpec`` for the same leaf.
A tree of specs has the structure of the tree it describes; since specs
are tuples themselves, flatten it against that tree
(:func:`spec_leaves`). Torch has no mesh either: where the JAX package
reads a mesh's shape, these functions take its axis sizes, ``{axis:
size}`` (:data:`repro_torch.launch.mesh.PRODUCTION_AXES`,
:func:`mesh_axis_sizes`).

:func:`local_shard` cuts one rank's block of a leaf and
:func:`gather_shards` rebuilds the whole leaf over the ranks' groups;
:func:`shard_tree` and :func:`gather_tree` do so for a whole tree. The
FSDP x TP step (``build_model(cfg, mesh=groups)`` and
``make_train_step(model, grad_shardings=specs)``) stores each rank's
blocks and runs on them, the program GSPMD derives from the table in
the JAX package's dry run; :func:`replicas` says how many ranks hold
each block (the gradient norm counts each block once).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import collective
from repro_torch.launch.mesh import dp_axes as _dp_axes
from repro_torch.launch.mesh import dp_degree as _dp_degree

__all__ = ["param_specs", "opt_specs", "batch_spec", "cache_specs",
           "paged_cache_specs", "mesh_axis_sizes", "spec_leaves",
           "local_shard", "gather_shards", "shard_tree", "gather_tree",
           "replicas", "map_with_specs"]

# output features live on the model axis; input features are FSDP
_COL_PARALLEL = {"wq", "wk", "wv", "w_in", "w_gate", "w_up",
                 "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b"}
# input features live on the model axis; output features are FSDP
_ROW_PARALLEL = {"wo", "w_down", "w_out"}
# small / irregular leaves that stay replicated everywhere
_REPLICATED = {"router", "conv_w", "conv_b", "dt_bias", "a_log",
               "kv_norm", "q_norm", "ln1", "ln2", "final_norm"}


def _rule(name: str | None, ndim: int, dp_axes: tuple[str, ...]):
    """Spec entries (len ``ndim``) for one *unstacked* parameter leaf."""
    dp = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]
    if ndim < 2 or name in _REPLICATED or name is None:
        return (None,) * ndim
    if name == "embed":          # token table: vocab FSDP, features TP
        return (dp, "model")
    if name == "lm_head":        # logits want vocab on model
        return (dp, "model")
    if name in _COL_PARALLEL:
        if ndim == 3:            # routed experts (E, d_in, d_out): EP
            return ("model", None, None)
        return (None,) * (ndim - 2) + (dp, "model")
    if name in _ROW_PARALLEL:
        if ndim == 3:
            return ("model", None, None)
        return (None,) * (ndim - 2) + ("model", dp)
    return (None,) * ndim        # unknown leaf: stay safe, replicate


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a grid: a dict of sizes as it is, or a
    :class:`repro_torch.launch.mesh.MeshGroups` as ``{"data": D,
    "model": M}`` — the ``axis_sizes`` argument :func:`param_specs`
    takes to fit one rule table to that grid."""
    if isinstance(mesh, dict):
        return {name: int(size) for name, size in mesh.items()}
    return mesh.axis_sizes()


def _fit(entries, shape, axis_sizes):
    """Drop spec entries a concrete mesh cannot honor: when every axis
    of an entry has a known size and the dimension does not divide their
    product, that dimension falls back to replicated. Entries naming any
    unknown axis pass through untouched, so ``axis_sizes=None`` is the
    identity."""
    if axis_sizes is None:
        return entries
    out = []
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = e if isinstance(e, tuple) else (e,)
        sizes = [axis_sizes.get(a) for a in axes]
        if all(s is not None for s in sizes) and \
                int(dim) % math.prod(int(s) for s in sizes):
            out.append(None)
        else:
            out.append(e)
    return tuple(out)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and named
    tuples, keeping its structure; ``path`` holds the dict keys (and
    sequence indices) from the root."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (i,))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def spec_leaves(specs, like) -> list[tuple]:
    """The specs of ``specs`` (a tree built over ``like``) in the JAX
    package's leaf order: dict keys sorted, sequences in order."""
    if isinstance(like, dict):
        return [s for k in sorted(like) for s in spec_leaves(specs[k],
                                                             like[k])]
    if isinstance(like, (list, tuple)):
        return [s for a, b in zip(specs, like) for s in spec_leaves(a, b)]
    return [specs]


def _leaf_name(path) -> str | None:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return None


def param_specs(params, cfg, multi_pod: bool, axis_sizes=None):
    """The spec tree of ``params`` (tensors, ``meta`` ones included, or
    anything with ``shape`` and ``ndim``: :meth:`Model.init`'s tree).
    Segment leaves carry the leading layer-stack axis, which always stays
    unsharded.

    ``axis_sizes`` (optional ``{axis: size}``, see
    :func:`mesh_axis_sizes`) fits the one rule table to a concrete grid:
    dimensions a shrunken axis no longer divides fall back to
    replicated. Fitting to the production shape is the identity."""
    dp = _dp_axes(multi_pod)

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if "segments" in path:
            return (None, *_fit(_rule(name, len(shape) - 1, dp),
                                shape[1:], axis_sizes))
        return tuple(_fit(_rule(name, len(shape), dp), shape, axis_sizes))

    return _map_with_path(spec, params)


def opt_specs(opt_state, p_spec):
    """AdamW state specs: moments mirror the parameter sharding, the step
    counter is replicated (``()``). ``opt_state`` is the
    :class:`repro_torch.optim.AdamWState` the specs describe."""
    return type(opt_state)(step=(), mu=p_spec, nu=p_spec)


def batch_spec(global_batch: int, axis_sizes: dict, multi_pod: bool):
    """Spec *entry* for the example axis: the DP axes when the batch
    divides the DP degree, else ``None`` (replicated small batches,
    e.g. B=1 long-context serving)."""
    dp = _dp_axes(multi_pod)
    if global_batch % _dp_degree(axis_sizes, multi_pod) != 0:
        return None
    return tuple(dp) if len(dp) > 1 else dp[0]


def cache_specs(caches, cfg, axis_sizes: dict, multi_pod: bool):
    """Decode-cache specs: batch axis (dim 1, after the layer stack) over
    the DP axes when divisible; everything else replicated."""
    dp = _dp_axes(multi_pod)
    degree = _dp_degree(axis_sizes, multi_pod)
    dp_entry = tuple(dp) if len(dp) > 1 else dp[0]

    def spec(_, leaf):
        if leaf.ndim >= 2 and leaf.shape[1] % degree == 0:
            return (None, dp_entry, *(None,) * (leaf.ndim - 2))
        return (None,) * leaf.ndim

    return _map_with_path(spec, caches)


def paged_cache_specs(pools, cfg, axis_sizes: dict, multi_pod: bool):
    """Paged-pool specs (:meth:`Model.init_paged_state` trees): dim 1
    after the layer stack is the page axis of attention pools and the
    slot axis of Mamba caches, the serving analogue of the decode batch,
    so :func:`cache_specs`'s rule applies."""
    return cache_specs(pools, cfg, axis_sizes, multi_pod)


def _block_index(entry, coords: dict, sizes: dict) -> tuple[int, int]:
    """``(index, count)`` of a rank's block along a dimension whose spec
    entry is ``entry``: the axes' coordinates in mixed radix, the first
    axis outermost."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    index, count = 0, 1
    for a in axes:
        index = index * int(sizes[a]) + int(coords[a])
        count *= int(sizes[a])
    return index, count


def local_shard(t: torch.Tensor, spec: tuple, coords: dict,
                sizes: dict) -> torch.Tensor:
    """This rank's block of the whole leaf ``t`` under ``spec``, as a new
    contiguous tensor: along every dimension the spec shards, the block
    at this rank's coordinates ``coords`` (``{axis: index}``) on axes of
    ``sizes`` (``{axis: size}``). Axes the spec does not name leave
    their dimension whole."""
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        index, count = _block_index(entry, coords, sizes)
        if t.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"split into {count} blocks")
        size = t.shape[dim] // count
        out = out.narrow(dim, index * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def gather_shards(block: torch.Tensor, spec: tuple, groups: dict
                  ) -> torch.Tensor:
    """The whole leaf from every rank's ``block`` under ``spec``:
    along each dimension the spec shards, one all-gather over that
    entry's group in ``groups`` (``{axis or tuple of axes: process
    group}``, the group's ranks in the axis's order). A collective: every
    rank of each group must call it with the same spec."""
    out = block
    for dim, entry in enumerate(spec):
        if entry is None or groups[entry] is None:
            continue
        group = groups[entry]
        n = dist.get_world_size(group)
        src = out.contiguous()
        buf = torch.empty(n * src.numel(), dtype=src.dtype,
                          device=src.device)
        collective(dist.all_gather_into_tensor, buf, src.reshape(-1),
                   group=group)
        out = torch.cat(buf.view(n, *src.shape).unbind(0), dim=dim)
    return out


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree (as
    :func:`param_specs` builds it), keeping ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(map_with_specs(fn, v, sp)
                          for v, sp in zip(tree, specs))
    return fn(tree, specs)


def shard_tree(tree, specs, coords: dict, sizes: dict):
    """This rank's blocks of every leaf of the whole ``tree``
    (:func:`local_shard` a leaf)."""
    return map_with_specs(
        lambda t, sp: local_shard(t, sp, coords, sizes), tree, specs)


def gather_tree(blocks, specs, mesh):
    """The whole tree from every rank's ``blocks`` (:func:`gather_shards`
    a leaf, over the data and model groups of ``mesh``, a
    :class:`repro_torch.launch.mesh.MeshGroups`). A collective over the
    grid."""
    data = tuple(mesh.axis_sizes())[:-1]
    groups = {"model": mesh.model_group,
              data[0] if len(data) == 1 else data: mesh.data_group}
    return map_with_specs(
        lambda t, sp: gather_shards(t, sp, groups), blocks, specs)


def replicas(spec: tuple, sizes: dict) -> int:
    """How many ranks of a grid of ``sizes`` hold the same block of a
    leaf under ``spec``: the product of the axes the spec names
    nowhere."""
    named = {a for e in spec if e is not None
             for a in (e if isinstance(e, tuple) else (e,))}
    return math.prod(int(n) for a, n in sizes.items() if a not in named)
