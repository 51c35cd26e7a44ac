"""The JAX package's side of ``tests/test_torch_tp.py`` and
``tests/test_torch_ep.py``: the cases of ``tests/_tp_cases.py`` over 4
emulated CPU devices. A script of its own, because the device count is
fixed when jax is first imported:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_tp_jax.py tp PARAMS.pkl OUT.pkl
    ... python tests/_tp_jax.py ep INPUTS.pkl OUT.pkl
    ... python tests/_tp_jax.py fsdp INPUTS.pkl OUT.pkl

``tp``: the ``MeshExecutor`` on ``make_emulated_mesh(2, 2)`` for each arm
of ``ARMS`` from the numpy parameters in ``PARAMS.pkl``: the gradients,
the three steps' report and whole state, and each device's shards in
the grid's rank order. ``ep``: ``moe_ffn`` on a mesh and the model built
on one (``build_model(cfg, mesh=...)``), from ``INPUTS.pkl``.
``fsdp``: the FSDP x TP program of the dry run, for each case of
``FSDP_KV``: ``make_train_step(model, grad_shardings=...)``,
``make_prefill(model, return_cache=True)`` and the serve step, jitted
with the rule table's shardings on ``make_emulated_mesh(2, 2)`` (the
wiring of ``tests/test_exec.py``), from the numpy parameters and batches
in ``INPUTS.pkl``: the three steps' losses, the whole parameters and
each device's shards, the prefill's logits, one decode step's logits,
the step's ``memory_analysis()`` bytes and ``model_flops_per_device``;
and the dry run's ``cell_list``.
"""
from __future__ import annotations

import pickle
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _tp_cases import (ARCH, ARMS, EP_ARCHS, EP_CAPACITY,  # noqa: E402
                       EP_MESHES, FSDP_ACCUM, FSDP_KV, FSDP_SHAPE, KILL, KW,
                       N, STEPS, ep_inputs, model_tokens, summary)

from repro.configs import smoke_config  # noqa: E402
from repro.core import Rectlr, SpareState  # noqa: E402
from repro.exec import MeshExecutor  # noqa: E402
from repro.launch.mesh import make_emulated_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.optim import adamw_init  # noqa: E402
from repro.train.injection import ScriptedInjector  # noqa: E402


def _host(tree) -> list:
    return [np.asarray(jnp.asarray(x, jnp.float32))
            for x in jax.tree.leaves(tree)]


def tp(params_path: str) -> dict:
    with open(params_path, "rb") as f:
        numpy_params = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    mesh = make_emulated_mesh(2, 2)
    devices = list(mesh.devices.flat)          # rank d * 2 + m
    masked = SpareState(N, KW["redundancy"])
    Rectlr().on_failures(masked, [0])
    out = {}
    for name, sync, compress in ARMS:
        ex = MeshExecutor(cfg, mesh=mesh, sync=sync, grad_compress=compress,
                          **KW)
        ex.params = jax.device_put(jax.tree.map(jnp.asarray, numpy_params),
                                   ex._pshard)
        ex.opt_state = jax.device_put(adamw_init(ex.params), ex._oshard)
        rec = {"grads": _host(ex.mesh_grads(0)),
               "grads_masked": _host(ex.mesh_grads(0, state=masked))}
        rep = ex.run(STEPS, injector=ScriptedInjector(dict(KILL)))
        rec.update(report=summary(rep), params=_host(ex.params),
                   mu=_host(ex.opt_state.mu),
                   opt_step=int(ex.opt_state.step),
                   cache_keys=[list(k) for k in ex.cache_keys])
        rec["blocks"] = [
            [np.asarray(next(s.data for s in leaf.addressable_shards
                             if s.device == dev), np.float32)
             for leaf in jax.tree.leaves(ex.params)]
            for dev in devices]
        ex.close()
        out[name] = rec
    return out


def ep(inputs_path: str) -> dict:
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out: dict = {}
    for arch in EP_ARCHS:
        base = smoke_config(arch)
        x_np, cot_np = ep_inputs(base.d_model)
        p = jax.tree.map(jnp.asarray, inputs["moe"][arch])
        for cf in EP_CAPACITY:
            cfg = base.scaled(moe=replace(base.moe, capacity_factor=cf))
            for shape in EP_MESHES:
                mesh = make_emulated_mesh(*shape)
                fn = jax.jit(lambda x, p, cfg=cfg, mesh=mesh: jmoe.moe_ffn(
                    x, p, cfg, mesh=mesh))
                y, vjp = jax.vjp(fn, jnp.asarray(x_np), p)
                dx, dp = vjp(jnp.asarray(cot_np))
                out[(arch, cf, shape)] = {"y": np.asarray(y),
                                          "dx": np.asarray(dx),
                                          "grads": _host(dp)}
    cfg = smoke_config(EP_ARCHS[0])
    model = build_model(cfg, mesh=make_emulated_mesh(1, 2))
    tokens = jnp.asarray(model_tokens(cfg.vocab))

    def loss(params):
        logits = model.forward(params, tokens=tokens[:, :-1])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        picked = jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1)
        return -jnp.mean(picked)

    value, grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree.map(jnp.asarray, inputs["model"]))
    out["model"] = {"loss": float(value), "grads": _host(grads)}
    return out


def fsdp(inputs_path: str) -> dict:
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.shapes import ShapeSpec
    from repro.dist.sharding import cache_specs, param_specs
    from repro.launch import dryrun
    from repro.train import make_prefill, make_serve_step, make_train_step

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    mesh = make_emulated_mesh(2, 2)
    devices = list(mesh.devices.flat)          # rank d * 2 + m
    out: dict = {"cell_list": [f"{a} {s} {'2x16x16' if mp else '16x16'}"
                               for a, s, mp in dryrun.cell_list()]}
    for kv in FSDP_KV:
        cfg = smoke_config(ARCH).scaled(grad_accum=FSDP_ACCUM, n_kv_heads=kv)
        case = inputs[kv]
        model = build_model(cfg, mesh=mesh)
        params = jax.tree.map(jnp.asarray, case["params"])
        p_spec = param_specs(params, cfg, False)
        p_shard = jax.tree.map(lambda s: NamedSharding(mesh, s), p_spec)
        params = jax.device_put(params, p_shard)
        tok_shard = NamedSharding(mesh, P("data", None))
        rec: dict = {}
        with mesh:
            # prefill and one decode step, from the first parameters
            prompts = jnp.asarray(case["prompts"], jnp.int32)
            logits, state = jax.jit(
                make_prefill(model, return_cache=True),
                in_shardings=(p_shard, tok_shard))(params, prompts)
            rec["prefill"] = np.asarray(logits, np.float32)
            c_shard = jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                cache_specs(state, cfg, mesh, False))
            last = prompts.shape[1] - 1
            serve = jax.jit(make_serve_step(model),
                            in_shardings=(p_shard, c_shard, None, tok_shard),
                            out_shardings=(None, c_shard),
                            donate_argnums=(1,))
            dec, _ = serve(params, jax.device_put(state, c_shard),
                           jnp.int32(last), prompts[:, last:])
            rec["decode"] = np.asarray(dec, np.float32)
            # the train step
            opt = adamw_init(params)
            o_spec = type(opt)(step=P(), mu=p_spec, nu=p_spec)
            o_shard = jax.tree.map(
                lambda s: NamedSharding(mesh, s) if isinstance(s, P) else s,
                o_spec, is_leaf=lambda x: isinstance(x, P))
            opt = jax.device_put(opt, o_shard)
            b_shard = {"tokens": NamedSharding(mesh, P(None, "data", None)),
                       "labels": NamedSharding(mesh, P(None, "data", None)),
                       "weights": NamedSharding(mesh, P(None, "data"))}
            step = jax.jit(make_train_step(model, grad_shardings=p_shard),
                           in_shardings=(p_shard, o_shard, b_shard),
                           out_shardings=(p_shard, o_shard, None),
                           donate_argnums=(0, 1))
            batches = [{k: jnp.asarray(v[i]) for k, v in
                        case["batches"].items()}
                       for i in range(case["batches"]["weights"].shape[0])]
            ma = step.lower(params, opt, batches[0]).compile() \
                .memory_analysis()
            rec["memory"] = {"arg_bytes": int(ma.argument_size_in_bytes),
                             "out_bytes": int(ma.output_size_in_bytes),
                             "alias_bytes": int(ma.alias_size_in_bytes)}
            losses = []
            for b in batches:
                params, opt, metrics = step(params, opt, b)
                losses.append(float(metrics["loss"]))
        rec.update(losses=losses, params=_host(params), blocks=[
            [np.asarray(next(s.data for s in leaf.addressable_shards
                             if s.device == dev), np.float32)
             for leaf in jax.tree.leaves(params)] for dev in devices])
        rec["model_flops_per_device"] = dryrun.model_flops_per_device(
            cfg, ShapeSpec(**FSDP_SHAPE), N)
        out[kv] = rec
    return out


def main(part: str, inputs: str, out_path: str) -> None:
    assert jax.device_count() == N, jax.devices()
    out = {"tp": tp, "ep": ep, "fsdp": fsdp}[part](inputs)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
