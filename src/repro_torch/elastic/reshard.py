"""Survivor-group geometry and state movement for elastic recovery (the
PyTorch counterpart of ``repro.elastic.reshard``).

Helpers under :class:`repro_torch.elastic.ElasticMeshExecutor`. The JAX
package holds every piece of state as one global array and moves it
between meshes with ``jax.device_put``; here each rank holds its own
piece, so the moves are collectives. A SPARe group is one data row of
the ``(data, model)`` grid of ranks (at model degree 1, one rank), and
the moves run per model column, over that column's full data group
(the ranks of the column, one a row): the "physical rank" of this
module is the rank's row. Every rank calls each of them, in the same
order, retired rows included (they stay in lockstep, idle):

* :func:`shrink_degree` — the DP degree a survivor set can continue at
  (a copy): it must divide the ORIGINAL degree, because the executor's
  bucket layout is padded to the construction-time degree, so any
  divisor still tiles every bucket;
* :func:`survivor_group` — the data group over the kept data rows, for
  one model column (the counterpart of ``survivor_submesh``, which keeps
  every column of a kept row);
* :func:`reshard_tree` — params and AdamW moments stay where they are:
  a survivor keeps its own, and a rank that rejoins receives them by a
  broadcast from a rank that was active, over its model column's data
  group (under ``gspmd`` each column holds its own block);
* :func:`remap_ef_rows` — the EF residuals. ``err1`` follows its
  physical rank (a rank that rejoins starts at zero: its untransmitted
  signal belonged to a retired trajectory). ``err2`` is the trap: the
  JAX package passes its global ``(B,)`` array through unchanged, so
  after a reshape logical rank ``i`` owns ``[i B/n, (i+1) B/n)`` of it,
  chunks that OLD logical ranks owned, by position. Here each rank
  holds only its own chunk, so the move is an all-gather of the old
  chunks over the column's full data group (every process is alive: a
  retired rank's memory is, as a dead device's is in the JAX emulation)
  and a re-slice by the new positions (:func:`reslice_err2`).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from repro_torch.dist.collectives import collective, tree_leaves
from repro_torch.launch.mesh import LOCKSTEP_TIMEOUT_S

__all__ = ["shrink_degree", "survivor_group", "reshard_tree",
           "remap_ef_rows", "reslice_err2"]


def shrink_degree(full_degree: int, n_survivors: int) -> int:
    """Largest divisor of ``full_degree`` that is <= ``n_survivors``
    (0 when no positive degree fits — nothing survived)."""
    best = 0
    for d in range(1, min(int(full_degree), int(n_survivors)) + 1):
        if full_degree % d == 0:
            best = d
    return best


def survivor_group(grid_group, rows, cache: dict, model_degree: int = 1,
                   column: int = 0):
    """The data group over the surviving data rows ``rows`` of the grid
    ``grid_group`` (rank ``d * model_degree + m`` at ``(d, m)``, as
    :func:`repro_torch.launch.mesh.init_mesh_groups` lays it out), for
    the model column ``column``: its ranks are ``(r, column)`` for each
    ``r`` in ``rows``. The counterpart of ``survivor_submesh``, which
    keeps every model column of a kept row. ``dist.new_group`` is
    collective over the whole world, so every rank makes the group of
    EVERY column, in column order, retired rows included, and keeps its
    own column's: every rank must call this with the same ``rows``, in
    the same order. At model degree 1 the rows are the grid's ranks, and
    all of them is ``grid_group`` itself. Groups are kept in ``cache`` by
    ``rows``, so a second reshape onto the same set makes no new group."""
    key = tuple(int(r) for r in rows)
    if not key:
        raise ValueError("a survivor group needs at least one rank")
    if key not in cache:
        ranks = dist.get_process_group_ranks(grid_group)
        m = int(model_degree)
        if m == 1 and key == tuple(range(len(ranks))):
            cache[key] = grid_group
        else:
            timeout = datetime.timedelta(seconds=LOCKSTEP_TIMEOUT_S)
            made = [dist.new_group([ranks[r * m + j] for r in key],
                                   timeout=timeout) for j in range(m)]
            cache[key] = made[column]
    return cache[key]


#: the most bytes a rank hands one collective of this module: gloo
#: stages a CUDA tensor through a pinned host buffer of its size, which
#: its caching allocator keeps, so moving a whole full-width leaf at once
#: would pin that leaf's size (GiBs: the embedding's AdamW moments, its
#: bucket's gathered err2) on every rank for the rest of the process
PIECE_BYTES = 64 << 20


def reshard_tree(tree, src: int, group) -> None:
    """Broadcast every tensor of ``tree`` from physical rank ``src`` of
    ``group``, in place (bit for bit: nothing is computed), in pieces of
    at most :data:`PIECE_BYTES`."""
    root = dist.get_process_group_ranks(group)[src]
    for t in tree_leaves(tree):
        flat = t.view(-1)
        step = max(PIECE_BYTES // t.element_size(), 1)
        for i in range(0, flat.numel(), step):
            collective(dist.broadcast, flat[i:i + step], src=root,
                       group=group)


def reslice_err2(chunks: torch.Tensor, old_rows, new_rows,
                 rank: int) -> torch.Tensor:
    """Physical rank ``rank``'s stage-2 residual chunk after a reshape.

    ``chunks`` is ``(world, B / len(old_rows))``: every physical rank's
    chunk as gathered (rows of ranks outside ``old_rows`` are ignored).
    The global ``(B,)`` array is the chunks of ``old_rows`` in their
    logical order; logical rank ``i`` of ``new_rows`` owns its ``i``-th
    slice of ``B / len(new_rows)``. A rank outside ``new_rows`` gets
    zeros of that size."""
    old = [int(r) for r in old_rows]
    new = [int(r) for r in new_rows]
    whole = chunks[old].reshape(-1)
    size = whole.numel() // len(new)
    if rank not in new:
        return whole.new_zeros(size)
    i = new.index(rank)
    return whole[i * size:(i + 1) * size].clone()


def remap_ef_rows(ef: dict, old_rows, new_rows, *, rank: int,
                  group) -> dict:
    """Physical rank ``rank``'s EF residuals after a reshape from
    ``old_rows`` to ``new_rows`` (physical ranks of the full ``group``,
    in logical order): ``err1`` kept, or zero where the rank rejoins;
    ``err2`` re-sliced (:func:`reslice_err2`) after an all-gather over
    ``group`` (in pieces of at most :data:`PIECE_BYTES` a rank). A
    collective: every rank of ``group`` calls it. Takes the live
    residuals on the card or a host snapshot."""
    old = [int(r) for r in old_rows]
    new = [int(r) for r in new_rows]
    world = dist.get_world_size(group)
    joins = rank in new and rank not in old
    err1 = tuple(torch.zeros_like(e) if joins else e for e in ef["err1"])
    err2 = []
    for e1, e2 in zip(ef["err1"], ef["err2"]):
        size = e1.numel() // len(old)
        mine = e2 if rank in old else e2.new_zeros(size)
        every = mine.new_empty((world, size))
        step = max(PIECE_BYTES // mine.element_size(), 1)
        for i in range(0, size, step):
            part = mine.new_empty((world, min(step, size - i)))
            collective(dist.all_gather_into_tensor, part.view(-1),
                       mine[i:i + step], group=group)
            every[:, i:i + step] = part
        err2.append(reslice_err2(every, old, new, rank))
    return {"err1": err1, "err2": tuple(err2)}
