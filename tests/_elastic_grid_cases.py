"""The cases of ``tests/test_torch_elastic_grid.py``, shared by its two
sides: the elastic tier on a ``(data 4, model 2)`` grid of ranks.

:func:`port_grid_rank` runs on one of the port's 8 gloo ranks
(``repro_torch.launch.mesh.spawn_ranks``) and imports no jax: each case
of ``tests/_elastic_cases.py`` that reaches the grid (``GRID_CASES``)
under ``shard_map`` with the int8 EF sync (:func:`_elastic_cases
.port_rank` at model degree 2), then, under ``gspmd``, a round trip (3
steps, ``reshape([0, 1])``, a step at DP 2, a disk checkpoint,
``restore_full_mesh``) and a rollback onto the full grid from a snapshot
taken degraded. ``tests/_elastic_grid_jax.py`` runs
the same on the JAX package over 8 emulated devices. Both start from
one set of numpy parameters (the TINY fp32 width of
``tests/_elastic_cases.py``).
"""
from __future__ import annotations

from _elastic_cases import CASES, KW, N, port_rank

#: the grid's model degree, and the gspmd cases' arguments
M = 2
#: the cases of ``_elastic_cases.CASES`` that move a reshape's state or
#: its groups: a masked failure never reaches the elastic tier, and the
#: adaptive scheme's decision reads no grid
GRID_CASES = tuple(c for c in CASES if c not in ("mask", "adaptive"))
GSPMD_KW = dict(KW, model_degree=M, sync="gspmd")
#: the checkpoint manager's fixed clock (``np.savez`` stamps zip entries)
FIXED_TIME = 1.7e9
#: the campaign's cells on a grid: the card's elastic cell (N 2, r 1;
#: ``elastic_regime_cells``) and the gray cells (``gray_regime_cells``)
ELASTIC_CELLS = dict(n=2, r=1, model_degree=M, steps=12)
GRAY_CELLS = dict(model_degree=M, steps=16, slow_step=1, heal_step=5)
#: the emulated devices each part of ``tests/_elastic_grid_jax.py``
#: needs: the cases a (4, 2) mesh, the gray cells an (8, 2) one
DEVICES = {"cases": 8, "cells": 16}


def port_grid_rank(rank: int, world: int, params_path: str,
                   ckpt_root: str) -> dict | None:
    """Every case on this rank of the 8; rank 0 returns them all
    (``int8``: the shard_map cases; ``gspmd``: the gspmd ones), each
    rank's state in grid-rank order."""
    int8 = port_rank(rank, world, params_path, model_degree=M,
                     cases=GRID_CASES)
    gspmd = _gspmd_cases(rank, world, params_path, ckpt_root)
    return {"int8": int8, "gspmd": gspmd} if rank == 0 else None


def _gspmd_cases(rank: int, world: int, params_path: str,
                 ckpt_root: str) -> dict | None:
    import pickle

    import torch.distributed as dist

    from _elastic_cases import ARCH, TINY, summary
    from repro_torch.configs import smoke_config
    from repro_torch.dist import tree_leaves
    from repro_torch.elastic import ElasticMeshExecutor
    from repro_torch.models import params_from_numpy

    with open(params_path, "rb") as f:
        numpy_params = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(**TINY)

    def executor():
        ex = ElasticMeshExecutor(cfg, device="cpu", **GSPMD_KW)
        ex.place_state(params_from_numpy(numpy_params, "cpu"))
        return ex

    def host(tree) -> list:
        return [t.detach().numpy().copy() for t in tree_leaves(tree)]

    def state(ex) -> dict:
        """The rank's blocks and the whole state (a collective over its
        row's model group)."""
        full, opt = ex.full_state()
        return {"params": host(ex.params), "mu": host(ex.opt_state.mu),
                "nu": host(ex.opt_state.nu),
                "opt_step": int(ex.opt_state.step),
                "full": host(full), "full_mu": host(opt.mu),
                "full_nu": host(opt.nu)}

    def every(obj) -> list:
        out = [None] * world
        dist.all_gather_object(out, obj)
        return out

    def common(ex, rep=None) -> dict:
        return {"report": None if rep is None else summary(rep),
                "n": int(ex.state.n), "r": int(ex.state.r),
                "rows": [int(p) for p in ex._logical_phys],
                "cache_keys": [list(k) for k in ex.cache_keys]}

    out: dict = {}
    ex = executor()
    ex.run(3)
    s0 = every(state(ex))
    ex.reshape([0, 1])
    s1, after = every(state(ex)), common(ex)
    rep = ex.run(1)
    s_mid = every(state(ex))
    save = _save_pair(ex, rank, cfg, ckpt_root)
    ex.restore_full_mesh()
    out["round_trip"] = {"s0": s0, "s1": s1, "s_mid": s_mid,
                         "s2": every(state(ex)), "after_reshape": after,
                         "degraded": summary(rep), "save": save,
                         **common(ex)}
    ex.close()

    ex = executor()
    ex.run(3)
    ex.reshape([0, 1])
    at_snapshot = every(state(ex))
    ex.run(2)
    ex._global_restart()
    step, _ = ex._rollback()
    out["rollback"] = {"at_snapshot": at_snapshot, "step": step,
                       "state": every(state(ex)), **common(ex)}
    ex.close()
    return out if rank == 0 else None


def _save_pair(ex, rank: int, cfg, ckpt_root: str) -> dict | None:
    """After the reshape: the ``gspmd`` executor's disk save (the run's
    own path: its logical rank 0, grid rank 4, writes, every rank in the
    gathers) and, on rank 0, a model degree 1 executor's save of the
    same state, the whole leaves and the update count of rank 4 (a
    retired rank's are stale): the two files' bytes, with the clocks
    fixed."""
    import time
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.dist import tree_leaves
    from repro_torch.dist.collectives import _flatten, _unflatten
    from repro_torch.exec import MeshExecutor
    from repro_torch.optim import AdamWState
    from repro_torch.train.trainer import TrainReport

    def manager(path):
        out = CheckpointManager(path, n_groups=N,
                                redundancy=KW["redundancy"], mtbf=300.0,
                                t_save=60.0, t_restart=3600.0,
                                clock=lambda: FIXED_TIME)
        out.interval = 0.0
        return out

    clock = time.time
    time.time = lambda: FIXED_TIME      # the zip entries' stamps
    try:
        root = Path(ckpt_root)
        ex.ckpt = manager(root / "gspmd")
        ex._save_disk(TrainReport())
        ex.ckpt.wait()
        writer = [None] * dist.get_world_size()
        params, opt = ex.full_state()
        mine = [[t.numpy().copy() for t in tree_leaves(tree)]
                for tree in (params, opt.mu, opt.nu)]
        dist.all_gather_object(writer, (ex._writes_disk, mine,
                                        int(opt.step)))
        one = dist.new_group([0])
        if rank != 0:
            return None
        lead = [i for i, (w, _, _) in enumerate(writer) if w]
        _, whole, opt_step = writer[lead[0]]
        skeleton = _flatten(ex._full)[1]

        def tree(part, like):
            return _unflatten(skeleton, [
                torch.from_numpy(a).to(t.dtype)
                for a, t in zip(whole[part], tree_leaves(like))])
        ref = MeshExecutor(cfg, group=one, device="cpu",
                           **{k: v for k, v in KW.items()
                              if k != "t_reshape"})
        ref.place_state(tree(0, ex._full), AdamWState(
            step=opt_step, mu=tree(1, ex._full),
            nu=tree(2, ex._full)))
        ref.step = ex.step
        ref.ckpt = manager(root / "one")
        ref._snapshot_now()
        ref._save_disk(TrainReport())
        ref.ckpt.wait()
        ref.close()
    finally:
        time.time = clock
    step = f"step_{ex.step:08d}"
    return {"writers": lead,
            "files": {name: [(root / d / step / name).read_bytes()
                             for d in ("gspmd", "one")]
                      for name in ("shard_0.npz", "manifest.json")}}
