#!/usr/bin/env python3
"""The collectives that heads a model degree does not divide add to the
FSDP x TP train step: GSPMD's, in the JAX package's compiled program,
beside the port's padded head split, by kind, on the CPU.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=16 \\
        PYTHONPATH=src python tools/gspmd_head_collectives.py [--model 16]

For each dense arch whose query heads the model degree does not divide,
its smoke config with the published head counts (head dim 16) is
compiled on ``make_emulated_mesh(1, M)`` (``M`` = ``--model``, the
emulated device count), and so is the same config with heads the degree
divides (``M`` of them, KV heads as many). JAX's column is what the
first program's text holds beyond the second's, each instruction once:
a loop body once, so one layer's forward and its backward with the
recomputed forward. The port's column is the same difference between
its fake-rank traces (``launch.dryrun.record_cell``, rank 0), divided by
the layers and microbatches. The port spells each of GSPMD's groups of
collective permutes as one all-to-all. Needs jax and torch, not the
card; ~40 s at 16.
"""
from __future__ import annotations

import argparse
import collections
import re


def jax_counts(arch: str, mesh, **heads) -> dict:
    """Collective instructions by kind in the compiled train step of
    ``arch``'s smoke config with ``heads`` on ``mesh``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import smoke_config
    from repro.dist.sharding import param_specs
    from repro.models.model import build_model
    from repro.optim import adamw_init
    from repro.train import make_train_step

    cfg = smoke_config(arch).scaled(grad_accum=1, **heads)
    model = build_model(cfg, mesh=mesh)
    p_spec = param_specs(jax.eval_shape(model.init, jax.random.key(0)),
                         cfg, False)

    def shard(spec):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), spec,
                            is_leaf=lambda x: isinstance(x, P))

    params = jax.jit(model.init, out_shardings=shard(p_spec))(
        jax.random.key(0))
    opt = adamw_init(params)
    o_shard = shard(type(opt)(step=P(), mu=p_spec, nu=p_spec))
    key = "embeds" if cfg.frontend else "tokens"
    x = (jnp.zeros((1, 2, 16, cfg.d_model), jnp.bfloat16) if cfg.frontend
         else jnp.zeros((1, 2, 16), jnp.int32))
    batch = {"labels": jnp.zeros((1, 2, 16), jnp.int32),
             "weights": jnp.full((1, 2), 0.5, jnp.float32), key: x}
    b_shard = {"labels": P(None, "data", None), "weights": P(None, "data"),
               key: P(None, "data", *([None] * (x.ndim - 2)))}
    with mesh:
        step = jax.jit(make_train_step(model, grad_shardings=shard(p_spec)),
                       in_shardings=(shard(p_spec), o_shard,
                                     shard(b_shard)))
        text = step.lower(params, opt, batch).compile().as_text()
    return dict(collections.Counter(re.findall(
        r"\s(all-gather|all-reduce|reduce-scatter|collective-permute|"
        r"all-to-all)(?:-start)?\(", text)))


def port_counts(arch: str, model: int, **heads) -> dict:
    """Collectives by kind a layer and microbatch in the port's trace of
    rank 0 of a (1, ``model``) grid, ``arch``'s smoke config with
    ``heads``."""
    from repro_torch.configs import ShapeSpec, smoke_config
    from repro_torch.launch.dryrun import record_cell

    cfg = smoke_config(arch).scaled(grad_accum=1, **heads)
    cell, _ = record_cell(arch, "heads", False, cfg=cfg,
                          axes={"data": 1, "model": model},
                          shape=ShapeSpec("heads", "train", 16, 2))
    return dict(collections.Counter(c[0] for c in cell.log.schedule()))


def added(counts: dict, base: dict, per: int = 1) -> dict:
    return {k: (counts.get(k, 0) - base.get(k, 0)) / per
            for k in sorted(set(counts) | set(base))
            if counts.get(k, 0) != base.get(k, 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", type=int, default=16)
    args = ap.parse_args(argv)
    import jax

    from repro.launch.mesh import make_emulated_mesh
    from repro_torch.configs import ARCHS, get_config, smoke_config
    from repro_torch.models.model import mesh_refusal

    m = args.model
    assert jax.device_count() == m, "set the emulated device count to M"
    mesh = make_emulated_mesh(1, m)
    even = {"n_heads": m, "n_kv_heads": m}
    for arch in ARCHS:
        full = get_config(arch)
        if mesh_refusal(full) is not None or full.n_heads % m == 0:
            continue
        heads = {"n_heads": full.n_heads, "n_kv_heads": full.n_kv_heads}
        gspmd = added(jax_counts(arch, mesh, **heads),
                      jax_counts(arch, mesh, **even))
        port = added(port_counts(arch, m, **heads),
                     port_counts(arch, m, **even),
                     smoke_config(arch).n_layers)
        print(f"{arch} H {full.n_heads} KV {full.n_kv_heads} at model {m}: "
              f"JAX {gspmd}; port {port}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
