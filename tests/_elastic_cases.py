"""The cases of ``tests/test_torch_elastic.py``, shared by its two sides.

Each case drives the elastic executor through one scenario of the JAX
package's ``tests/test_elastic.py`` at 4 data-parallel rows (the JAX
tests run 8) of ``model_degree`` ranks each: one rank a row here, two in
``tests/test_torch_elastic_grid.py``. :func:`port_rank` runs every case
on one rank of the port's gloo ranks (``repro_torch.launch.mesh
.spawn_ranks``) and imports no jax; ``tests/_elastic_jax.py`` runs the
same cases on the JAX package's ``ElasticMeshExecutor`` over as many
emulated devices. Both start from one set of numpy parameters and
record plain data: report summaries, cache keys, policy logs and, per
rank, the params, AdamW moments and EF residuals at the points a case
names.
"""
from __future__ import annotations

import numpy as np

ARCH = "qwen2.5-3b"
TINY = dict(head_dim=64, grad_accum=1)
N = 4
#: the executor's arguments on both sides (10 buckets of the tiny tree,
#: the same sizes padded to 4 or to 2)
KW = dict(n_groups=N, redundancy=2, model_degree=1, seq=16,
          per_type_batch=2, total_steps=24, t_reshape=60.0,
          bucket_mb=0.05)
SPS = 64.0
CASES = ("round_trip", "fresh", "burst", "cascade", "restart", "rollback",
         "adaptive", "mask", "health")


class SlowGroups:
    """A straggler detector's verdict as ``_health_reshape`` reads it:
    the per-group slowdown factors."""

    def __init__(self, factors):
        self.factors = np.asarray(factors, dtype=np.float64)


def summary(rep) -> dict:
    """A report as plain data (the two packages' reports share these
    fields)."""
    return {
        "steps_done": rep.steps_done, "failures": rep.failures,
        "wipeouts": rep.wipeouts, "reshapes": rep.reshapes,
        "reorders": rep.reorders, "patches": rep.patches,
        "recompiles": rep.recompiles, "rollback_steps": rep.rollback_steps,
        "losses": [float(x) for x in rep.losses],
        "events": [(e.step, [int(v) for v in e.victims], bool(e.wipeout),
                    bool(e.reshape), e.dp_before, e.dp_after,
                    e.rollback_depth, e.s_a_before, e.s_a_after)
                   for e in rep.events]}


def reslice(chunks: list, old_rows, new_rows) -> list:
    """The stage-2 residual chunks of ``new_rows`` (in logical order)
    from those of ``old_rows``: one global array, sliced anew (numpy,
    independent of the port's code)."""
    whole = np.concatenate([chunks[i] for i in range(len(old_rows))])
    size = whole.size // len(new_rows)
    return [whole[i * size:(i + 1) * size] for i in range(len(new_rows))]


# ------------------------------------------------------------------ #
# the port's side (torch only)                                       #
# ------------------------------------------------------------------ #
def port_rank(rank: int, world: int, params_path: str,
              model_degree: int = 1, cases=CASES) -> dict | None:
    """Every case on this rank of a grid of ``N`` data rows of
    ``model_degree`` ranks (rank ``d * model_degree + m`` at ``(d, m)``),
    the policy cases ``adaptive`` and ``mask`` only if ``cases`` names
    them; rank 0 returns them all, with each rank's state where a case
    records it, in grid-rank order."""
    import pickle

    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.des import get_scheme
    from repro_torch.dist import tree_leaves
    from repro_torch.elastic import ElasticMeshExecutor
    from repro_torch.exec import MeshExecutor
    from repro_torch.models import params_from_numpy
    from repro_torch.optim import adamw_init
    from repro_torch.train import ScriptedInjector
    from repro_torch.train.trainer import TrainReport

    with open(params_path, "rb") as f:
        numpy_params = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(**TINY)

    m_deg = model_degree

    def executor(cls=ElasticMeshExecutor, **kw):
        args = dict(KW, grad_compress="int8_ef", device="cpu",
                    model_degree=m_deg)
        if cls is MeshExecutor:
            args.pop("t_reshape")
        args.update(kw)
        ex = cls(cfg, **args)
        ex.params = params_from_numpy(numpy_params, "cpu")
        ex.opt_state = adamw_init(ex.params)
        return ex

    def state(ex) -> dict:
        host = lambda ts: [t.detach().numpy().copy() for t in ts]  # noqa
        return {"params": host(tree_leaves(ex.params)),
                "mu": host(tree_leaves(ex.opt_state.mu)),
                "nu": host(tree_leaves(ex.opt_state.nu)),
                "opt_step": int(ex.opt_state.step),
                "err1": host(ex._ef_state["err1"]),
                "err2": host(ex._ef_state["err2"])}

    def every(obj) -> list:
        out = [None] * world
        dist.all_gather_object(out, obj)
        return out

    def common(ex, rep=None, inj=None) -> dict:
        return {"report": None if rep is None else summary(rep),
                "n": int(ex.state.n), "r": int(ex.state.r),
                "rows": [int(p) for p in ex._logical_phys],
                "cache_keys": [list(k) for k in ex.cache_keys],
                "policy_log": list(ex.policy_log),
                "outage_s": None if inj is None else inj.outage_seconds}

    out: dict = {}

    # full -> survivor group -> full: state bit-transparent
    ex = executor()
    ex.run(3)
    s0 = every(state(ex))
    ex.reshape([0, 1])
    s1, after = every(state(ex)), common(ex)
    ex.restore_full_mesh()
    out["round_trip"] = {"s0": s0, "s1": s1, "s2": every(state(ex)),
                         "after_reshape": after, **common(ex)}
    ex.close()

    # a reshaped executor is a fresh executor at the smaller degree
    ex = executor()
    ex.reshape([0, 1])
    rep = ex.run(3)
    elastic = {"state": every(state(ex)), **common(ex, rep)}
    ex.close()
    # the fresh executor on the first two rows' ranks: new_group is
    # collective over the world, so the other ranks make the groups its
    # grid makes (every column, then every row) with it
    pair = dist.new_group(list(range(2 * m_deg)))
    fresh = None
    if rank < 2 * m_deg:
        ref = executor(MeshExecutor, n_groups=2, redundancy=1, group=pair)
        fresh = {"report": summary(ref.run(3)), "state": state(ref)}
        ref.close()
    elif m_deg > 1:
        for j in range(m_deg):
            dist.new_group([j, m_deg + j])
        for i in range(2):
            dist.new_group(list(range(i * m_deg, (i + 1) * m_deg)))
    out["fresh"] = {"elastic": elastic, "fresh": every(fresh)[:2 * m_deg]}

    # an unmaskable burst continues degraded, without a wipe-out
    ex = executor()
    inj = ScriptedInjector({4: [0, 1]}, seconds_per_step=SPS)
    out["burst"] = common(ex, ex.run(12, injector=inj, snapshot_every=10),
                          inj)
    ex.close()

    # a second burst on the survivor group shrinks again: 4 -> 2 -> 1
    ex = executor()
    inj = ScriptedInjector({4: [0, 1], 8: [2]}, seconds_per_step=SPS)
    out["cascade"] = common(ex, ex.run(12, injector=inj, snapshot_every=4),
                            inj)
    ex.close()

    # a global restart after a reshape: the full group, keys kept
    ex = executor()
    ex.run(4, snapshot_every=4)
    keys_before = [list(k) for k in ex.cache_keys]
    ex.reshape([0, 1])
    ex.run(2)
    ex._global_restart()
    restarted = {"phys_alive": ex._phys_alive.tolist(), **common(ex)}
    rep = ex.run(2)
    out["restart"] = {"keys_before": keys_before, "restarted": restarted,
                      "state": every(state(ex)), **common(ex, rep)}
    ex.close()

    # rollback onto the full group from a snapshot taken degraded
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

    if "adaptive" in cases:
        # the adaptive scheme is the live policy tier
        scheme = get_scheme("adaptive", r=2, initial="spare")
        ex = executor(scheme=scheme, grad_compress=None)
        inj = ScriptedInjector({4: [0, 1]}, seconds_per_step=SPS)
        rep = ex.run(8, injector=inj, snapshot_every=4)
        out["adaptive"] = {"decisions": list(scheme.unmaskable_decisions),
                           **common(ex, rep, inj)}
        ex.close()

    if "mask" in cases:
        # a maskable failure never reaches the elastic tier
        ex = executor(grad_compress=None)
        inj = ScriptedInjector({3: [0]}, seconds_per_step=SPS)
        out["mask"] = common(ex, ex.run(8, injector=inj), inj)
        ex.close()

    # the gray-failure tier's escape hatch: shrink away from two slow
    # groups, then keep training
    ex = executor()
    ex.run(2)
    rep = TrainReport()
    ex._health_reshape([0, 1], SlowGroups([3.0, 3.0, 1.0, 1.0]), None, rep)
    after = common(ex, rep)
    out["health"] = {"after": after, **common(ex, ex.run(2))}
    ex.close()
    return out if rank == 0 else None


def shared_ckpt_rank(rank: int, world: int, ckpt_dir: str,
                     log_dir: str) -> dict | None:
    """Open one ``MeshExecutor`` with ``ckpt_dir`` on this rank, every
    rank at once (a barrier first), and restore the directory's latest
    checkpoint into the params. Renaming a parked ``.old_step_*`` copy
    waits a second first and is logged under ``log_dir``, so that ranks
    which all sweep the directory meet on the same park. Rank 0 returns
    every rank's restored step and params and the directory's names."""
    import pathlib
    import time

    import torch
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.dist import tree_leaves
    from repro_torch.dist.collectives import collective
    from repro_torch.exec import MeshExecutor

    rename = pathlib.Path.rename

    def logged(self, target):
        if self.name.startswith(".old_step_"):
            time.sleep(1.0)
            with open(pathlib.Path(log_dir) / f"rank{rank}.log", "a") as f:
                f.write(f"{self.name}\n")
        return rename(self, target)

    pathlib.Path.rename = logged

    def barrier():
        collective(dist.all_reduce, torch.zeros(1))

    barrier()
    ex = MeshExecutor(smoke_config(ARCH).scaled(**TINY), n_groups=world,
                      redundancy=2, seq=16, per_type_batch=2,
                      ckpt_dir=ckpt_dir, device="cpu")
    step, params = ex.ckpt.restore_latest(ex.params)
    mine = {"step": step,
            "params": [t.float().numpy() for t in tree_leaves(params)]}
    ex.close()
    barrier()
    out = [None] * world
    dist.all_gather_object(out, mine)
    if rank != 0:
        return None
    return {"ranks": out,
            "names": sorted(p.name for p in pathlib.Path(ckpt_dir).iterdir())}
