"""The cases of ``tests/test_torch_tp.py`` and ``tests/test_torch_ep.py``,
shared by their two sides.

The port's side runs on 4 gloo ranks (``repro_torch.launch.mesh
.spawn_ranks``), a (data 2, model 2) grid, and imports no jax;
``tests/_tp_jax.py`` runs the same cases on the JAX package over 4
emulated CPU devices (``make_emulated_mesh(2, 2)`` and, for the expert
layer, ``(1, 2)``). Both start from one set of numpy parameters and
record plain data.

Tensor parallelism (``tp``): the mesh executor on smoke qwen2.5-3b
(fp32 parameters), N 4, r 2, seq 16, for each arm of :data:`ARMS`:
``mesh_grads`` at step 0, healthy and with group 0 masked;
``survivor_set_sweep`` over every recoverable survivor set against a
host ``SpareTrainer`` on the same parameters; three steps
through a masked kill of group 0 at poll 1 (the report, the whole
parameters and, per rank, the stored blocks).

Expert parallelism (``ep``): one MoE layer (fp32) of smoke
deepseek-v2-lite (a shared expert) and smoke jamba (none) at capacity
factors 1.25 and 0.5 (the second drops slots), forward and the
gradient of ``sum(y * cot)``; and the loss and gradient of smoke
deepseek-v2-lite's model (fp32) built on the model group.

The FSDP x TP program (``fsdp``, ``tests/test_torch_fsdp_tp.py``): smoke
qwen2.5-3b in fp32 built on the (data 2, model 2) grid, with 2 KV heads
and with 1 (fewer KV heads than model ranks), for each of
:data:`FSDP_KV`: a prefill and one decode step from the first
parameters, then three train steps (``make_train_step(model,
grad_shardings=...)``) on the §3.1 weight tables of a healthy, a masked
and a healthy step, the first recorded; the cell is :data:`FSDP_SHAPE`
with :data:`FSDP_ACCUM` microbatches a step. The dense families
(``tests/test_torch_fsdp_tp_families.py``) run the same for each case of
:data:`FAMILY_CASES`.
"""
from __future__ import annotations

import numpy as np

ARCH = "qwen2.5-3b"
N = 4
#: the executor's arguments on both sides (the grid is data 2 x model 2)
KW = dict(n_groups=N, redundancy=2, seq=16, per_type_batch=2,
          total_steps=24, bucket_mb=0.05)
#: (name, sync, grad_compress)
ARMS = (("shard_map", "shard_map", None),
        ("shard_map+int8_ef", "shard_map", "int8_ef"),
        ("gspmd", "gspmd", None))
KILL = {1: [0]}
STEPS = 3

EP_ARCHS = ("deepseek-v2-lite-16b", "jamba-v0.1-52b")
EP_CAPACITY = (1.25, 0.5)
#: (data, model) meshes of the expert layer
EP_MESHES = ((1, 2), (2, 2))
#: the layer's input: batch, sequence (every data slice of a (2, 2)
#: mesh takes half the batch)
EP_X = (4, 16)
MODEL_TOKENS = (2, 16)

#: the FSDP x TP cases: KV heads of smoke qwen2.5-3b (4 query heads)
FSDP_KV = (2, 1)
FSDP_ACCUM = 2
#: the cell (a ``ShapeSpec``'s fields): per step, FSDP_ACCUM microbatches
#: of 4 examples, 2 a data rank
FSDP_SHAPE = dict(name="fsdp_cell", kind="train", seq=16, global_batch=8)
FSDP_STEPS = 3
#: the prefill's prompts (batch, length); the decode step rewrites the
#: last position
FSDP_PROMPTS = (4, 16)

#: the dense families' FSDP x TP cases (``tests/test_torch_fsdp_tp_families
#: .py``): name -> (arch, overrides of its smoke config, parameter dtype).
#: The token configs run in fp32; the ``embeds=`` frontends in bf16, as
#: the JAX model runs them (it raises on fp32 parameters with embeds).
#: ``h3kv1`` and ``h3kv3``: 3 query heads on a model degree of 2;
#: ``h1kv1``: one head, so model rank 1 holds none.
FAMILY_CASES = {
    "glm4-9b": ("glm4-9b", {}, "float32"),
    "starcoder2-7b": ("starcoder2-7b", {}, "float32"),
    "minitron-4b": ("minitron-4b", {}, "float32"),
    "starcoder2-h3kv1": ("starcoder2-7b", {"n_heads": 3, "n_kv_heads": 1},
                         "float32"),
    "starcoder2-h3kv3": ("starcoder2-7b", {"n_heads": 3, "n_kv_heads": 3},
                         "float32"),
    "starcoder2-h1kv1": ("starcoder2-7b", {"n_heads": 1, "n_kv_heads": 1},
                         "float32"),
    "qwen2-vl-2b": ("qwen2-vl-2b", {}, "bfloat16"),
    "musicgen-medium": ("musicgen-medium", {}, "bfloat16"),
}


def family_cfg(smoke_config, name: str):
    """A family case's config, from either package's ``smoke_config``."""
    arch, overrides, _ = FAMILY_CASES[name]
    return smoke_config(arch).scaled(grad_accum=FSDP_ACCUM, **overrides)


def bf16_values(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to the nearest bf16 (ties to even), kept as
    float32: values both packages cast to bf16 exactly."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & \
        np.uint32(0xFFFF0000)
    return u.view(np.float32)


def family_inputs(params, d_model: int, frontend: bool) -> dict:
    """:func:`fsdp_inputs` for a family case; a frontend's batches and
    prompts carry bf16-valued ``embeds`` (float32 arrays) in place of
    the tokens."""
    out = fsdp_inputs(params)
    if frontend:
        rng = np.random.default_rng(9)
        b = out["batches"]
        tokens = b.pop("tokens")
        b["embeds"] = bf16_values(
            rng.standard_normal((*tokens.shape, d_model)))
        out["prompts"] = bf16_values(
            rng.standard_normal((*FSDP_PROMPTS, d_model)))
    return out


def fsdp_inputs(params) -> dict:
    """One case's numpy inputs on both sides: ``params`` (fp32 numpy
    tree), the steps' batches (tokens and labels int32 ``(steps, n_micro,
    b_micro, S)``, weights ``(steps, n_micro, b_micro)``: the weight
    tables of a healthy step, one with example 0 masked and its supplier
    example 1 doubled, and a healthy one) and the prompts."""
    rng = np.random.default_rng(5)
    b = FSDP_SHAPE["global_batch"] // FSDP_ACCUM
    seq = rng.integers(0, 512, size=(FSDP_STEPS, FSDP_ACCUM, b,
                                     FSDP_SHAPE["seq"] + 1)).astype(np.int32)
    weights = np.full((FSDP_STEPS, FSDP_ACCUM, b), 1.0 / (FSDP_ACCUM * b),
                      np.float32)
    weights[1, :, 0] = 0.0
    weights[1, :, 1] *= 2.0
    return {"params": params,
            "batches": {"tokens": seq[..., :-1].copy(),
                        "labels": seq[..., 1:].copy(), "weights": weights},
            "prompts": rng.integers(0, 512, size=FSDP_PROMPTS
                                    ).astype(np.int32)}


def summary(rep) -> dict:
    """A report as plain data (the two packages' reports share these
    fields)."""
    return {
        "steps_done": rep.steps_done, "failures": rep.failures,
        "wipeouts": rep.wipeouts, "reorders": rep.reorders,
        "patches": rep.patches, "recompiles": rep.recompiles,
        "rollback_steps": rep.rollback_steps,
        "losses": [float(x) for x in rep.losses],
        "events": [(e.step, [int(v) for v in e.victims], bool(e.wipeout),
                    e.s_a_before, e.s_a_after) for e in rep.events]}


def ep_inputs(d_model: int) -> tuple[np.ndarray, np.ndarray]:
    """The expert layer's input and output cotangent (numpy, seeded)."""
    rng = np.random.default_rng(7)
    shape = (*EP_X, d_model)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def model_tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(11).integers(
        0, vocab, size=(MODEL_TOKENS[0], MODEL_TOKENS[1] + 1))


# ------------------------------------------------------------------ #
# the port's side (torch only)                                       #
# ------------------------------------------------------------------ #
def _host(tree) -> list:
    from repro_torch.dist import tree_leaves
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def port_tp_rank(rank: int, world: int, params_path: str,
                 ckpt_root: str) -> dict | None:
    """Every tensor-parallel case on this rank; rank 0 returns them all,
    with each rank's blocks and readings."""
    import pickle
    import time

    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.core import Rectlr, SpareState
    from repro_torch.exec import MeshExecutor, survivor_set_sweep
    from repro_torch.models import params_from_numpy
    from repro_torch.obs import Telemetry
    from repro_torch.train import ScriptedInjector
    from repro_torch.train.trainer import SpareTrainer, TrainReport

    with open(params_path, "rb") as f:
        numpy_params = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    masked = SpareState(N, KW["redundancy"])
    Rectlr().on_failures(masked, [0])

    def every(obj) -> list:
        out = [None] * world
        dist.all_gather_object(out, obj)
        return out

    # the host reference of the survivor sweep: the same seed, batches
    # and parameters
    ref = SpareTrainer(cfg, device="cpu", **{k: v for k, v in KW.items()
                                             if k != "bucket_mb"})
    ref.params = params_from_numpy(numpy_params, "cpu")
    out: dict = {}
    for name, sync, compress in ARMS:
        tel = Telemetry(trace=False)
        ex = MeshExecutor(cfg, model_degree=2, sync=sync,
                          grad_compress=compress, device="cpu",
                          telemetry=tel, **KW)
        ex.place_state(params_from_numpy(numpy_params, "cpu"))
        rec = {"grads": _host(ex.mesh_grads(0)),
               "grads_masked": _host(ex.mesh_grads(0, state=masked)),
               # the collective schedules of a healthy and a masked step
               # over gloo (tests/test_torch_tp.py holds the fake
               # group's against them)
               "schedules": [ex.step_log().schedule(),
                             ex.step_log(masked).schedule()],
               # every recoverable survivor set through the ranks' row
               # split and weighted all-reduce, against the host oracles
               "sweep": [(c.victims, c.s_a, c.mesh_vs_host,
                          c.mesh_vs_vanilla)
                         for c in survivor_set_sweep(ex, ref)]}
        rep = ex.run(STEPS, injector=ScriptedInjector(dict(KILL)))
        full, opt = ex.full_state()
        rec.update(report=summary(rep), params=_host(full),
                   mu=_host(opt.mu), opt_step=int(opt.step),
                   blocks=_host(ex.params), cache_keys=[
                       list(k) for k in ex.cache_keys])
        # then one step each on the masked and the healthy schedule at
        # the masked S_A: the wire gauges must not move
        healthy = SpareState(N, KW["redundancy"])
        healthy.s_a = masked.s_a
        gauges = {}
        for label, st in (("masked", masked), ("healthy", healthy)):
            ex.state = st
            ex.run(1)
            snap = tel.snapshot()["gauges"]
            gauges[label] = (snap["sync.wire_bytes_per_step"],
                             snap["sync.collectives_per_step"])
        rec["gauges"] = gauges
        rec["wire_total"] = tel.snapshot()["counters"][
            "sync.wire_bytes_total"]
        rec["steps_total"] = ex.step
        if sync == "gspmd":
            rec["save"] = _save_pair(ex, rank, cfg, ckpt_root,
                                     TrainReport, time)
        ex.close()
        ranks = every(rec)
        out[name] = None if rank else ranks
    return out if rank == 0 else None


def _save_pair(ex, rank: int, cfg, ckpt_root: str, TrainReport,
               time) -> dict | None:
    """The ``gspmd`` executor's disk save (the run's own path, every rank
    in the gathers) and, on rank 0, a model degree 1 executor's save of
    the same state, rebuilt in numpy from every rank's blocks: the two
    files' bytes, with the clocks fixed."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.dist import tree_leaves
    from repro_torch.dist.collectives import _flatten, _unflatten
    from repro_torch.exec import MeshExecutor
    from repro_torch.optim import AdamWState

    fixed = 1.7e9
    time.time = lambda: fixed      # the zip entries' stamps
    root = Path(ckpt_root)
    manager = CheckpointManager(root / "gspmd", n_groups=N,
                                redundancy=KW["redundancy"], mtbf=300.0,
                                t_save=60.0, t_restart=3600.0,
                                clock=lambda: fixed)
    manager.interval = 0.0
    ex.ckpt = manager
    ex._save_disk(TrainReport())
    manager.wait()
    # the whole state from every rank's blocks, by numpy
    mine = [_host(ex.params), _host(ex.opt_state.mu),
            _host(ex.opt_state.nu)]
    blocks = [None] * dist.get_world_size(ex.grid_group)
    dist.all_gather_object(blocks, mine)
    one = dist.new_group([0])
    if rank != 0:
        return None
    flags = ex._flags
    whole = []
    for part in range(3):
        leaves = []
        for i, f in enumerate(flags):
            a = blocks[0][part][i]
            if f:       # the model ranks 0 and 1 of data slice 0
                a = np.concatenate([blocks[0][part][i], blocks[1][part][i]],
                                   axis=-1)
            leaves.append(a)
        whole.append(leaves)
    skeleton = _flatten(ex._full)[1]
    dtypes = [t.dtype for t in tree_leaves(ex.params)]

    def tree(part, like_dtypes):
        return _unflatten(skeleton, [torch.from_numpy(a).to(dt) for a, dt
                                     in zip(whole[part], like_dtypes)])
    mdt = [t.dtype for t in tree_leaves(ex.opt_state.mu)]
    ref = MeshExecutor(cfg, group=one, device="cpu", **KW)
    ref.place_state(tree(0, dtypes), AdamWState(
        step=ex.opt_state.step, mu=tree(1, mdt), nu=tree(2, mdt)))
    ref.step = ex.step
    ref.ckpt = CheckpointManager(root / "one", n_groups=N,
                                 redundancy=KW["redundancy"], mtbf=300.0,
                                 t_save=60.0, t_restart=3600.0,
                                 clock=lambda: fixed)
    ref.ckpt.interval = 0.0
    ref._snapshot_now()
    ref._save_disk(TrainReport())
    ref.ckpt.wait()
    ref.close()
    step = f"step_{ex.step:08d}"
    return {name: [(root / d / step / name).read_bytes()
                   for d in ("gspmd", "one")]
            for name in ("shard_0.npz", "manifest.json")}


def port_ep_rank(rank: int, world: int, params_path: str) -> dict | None:
    """Every expert-parallel case on this rank of a (2, 2) grid; rank 0
    returns each rank's records."""
    import pickle
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.dist import tree_leaves
    from repro_torch.launch.mesh import init_mesh_groups
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.models.moe import ep_shard, moe_ffn

    with open(params_path, "rb") as f:
        inputs = pickle.load(f)
    grid = init_mesh_groups(dist.group.WORLD, 2)
    d = grid.data_rank
    out: dict = {}
    for arch in EP_ARCHS:
        base = smoke_config(arch)
        x_np, cot_np = ep_inputs(base.d_model)
        for cf in EP_CAPACITY:
            cfg = base.scaled(moe=replace(base.moe, capacity_factor=cf))
            for mesh in EP_MESHES:
                for local in (False, True):
                    p = params_from_numpy(inputs["moe"][arch], "cpu")
                    leaves = tree_leaves(p)
                    for t in leaves:
                        t.requires_grad_()
                    rows = slice(None) if mesh[0] == 1 else \
                        slice(d * EP_X[0] // 2, (d + 1) * EP_X[0] // 2)
                    x = torch.from_numpy(x_np[rows].copy()).requires_grad_()
                    layer = ep_shard(p, cfg, grid.model_rank, 2) if local \
                        else p
                    y = moe_ffn(x, layer, cfg, group=grid.model_group)
                    (y * torch.from_numpy(cot_np[rows])).sum().backward()
                    grads = [t.grad for t in leaves]
                    if local:
                        # the rank's own blocks of the experts: the
                        # group's sum is whole (the router's gradient
                        # is summed by the body already)
                        for k in ("experts", "shared"):
                            for t in tree_leaves(p.get(k, {})):
                                dist.all_reduce(t.grad,
                                                group=grid.model_group)
                    if mesh[0] == 2:
                        # the layer's parameters serve both data slices
                        for g in grads:
                            dist.all_reduce(g, group=grid.data_group)
                    out[(arch, cf, mesh, local)] = {
                        "y": y.detach().numpy().copy(),
                        "dx": x.grad.numpy().copy(),
                        "grads": [g.numpy().copy() for g in grads]}
    # the model-level case: smoke deepseek-v2-lite on the model group
    cfg = smoke_config(EP_ARCHS[0])
    model = build_model(cfg, device="cpu", model_group=grid.model_group)
    params = params_from_numpy(inputs["model"], "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    tokens = torch.from_numpy(model_tokens(cfg.vocab))
    logits = model.forward(params, tokens=tokens[:, :-1]).float()
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    loss.backward()
    out["model"] = {"loss": float(loss.detach()),
                    "grads": [t.grad.numpy().copy() for t in leaves]}
    every = [None] * world
    dist.all_gather_object(every, out)
    return every if rank == 0 else None


def port_params(numpy_params, cfg, dtype: str):
    """A case's numpy parameters as the port's tensors on the CPU: fp32
    leaves, or (a bf16 case) each leaf in the dtype the model's init
    gives it (bf16 matrices, fp32 norms and biases)."""
    import torch

    from repro_torch.models import params_from_numpy
    from repro_torch.models.model import Model

    def cast(t, like):
        # keeps the dicts' order: the FSDP gathers follow it
        if isinstance(t, dict):
            return {k: cast(v, like[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(cast(a, b) for a, b in zip(t, like))
        return t.to(like.dtype)

    params = params_from_numpy(numpy_params, "cpu")
    if dtype == "float32":
        return params
    return cast(params, Model(cfg, torch.device("meta")).init(0))


def port_fsdp_case(cfg, case: dict, grid, dtype: str = "float32") -> dict:
    """One FSDP x TP case on this rank of ``grid`` (see the module doc):
    its prefill and decode logits, the first step's collective schedule,
    three steps' losses, its blocks and the whole parameters."""
    import torch

    from repro_torch.dist import tree_leaves
    from repro_torch.dist.sharding import gather_tree, shard_tree
    from repro_torch.launch.steplog import record_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import (make_prefill, make_serve_step,
                                   make_train_step)

    d, coords, sizes = grid.data_rank, grid.coords(), grid.axis_sizes()
    model = build_model(cfg, "cpu", mesh=grid)
    blocks = shard_tree(port_params(case["params"], cfg, dtype),
                        model.specs, coords, sizes)
    frontend = "embeds" in case["batches"]
    key = "embeds" if frontend else "tokens"

    def inputs(a):
        t = torch.from_numpy(a)
        return t.to(torch.bfloat16) if frontend else t

    rec: dict = {}
    prompts = inputs(case["prompts"])
    b = prompts.shape[0] // grid.data_degree
    mine = prompts[d * b:(d + 1) * b]
    logits, state = make_prefill(model, return_cache=True)(
        blocks, **{key: mine})
    last = prompts.shape[1] - 1
    dec, _ = make_serve_step(model)(blocks, state, last,
                                    **{key: mine[:, last:]})
    rec.update(prefill=logits.float().numpy().copy(),
               decode=dec.float().numpy().copy())
    opt = adamw_init(blocks)
    step = make_train_step(model, grad_shardings=model.specs)
    bl = FSDP_SHAPE["global_batch"] // FSDP_ACCUM // grid.data_degree
    losses = []
    for i in range(FSDP_STEPS):
        batch = {k: torch.from_numpy(v[i][:, d * bl:(d + 1) * bl].copy())
                 for k, v in case["batches"].items()}
        if frontend:
            batch["embeds"] = batch["embeds"].to(torch.bfloat16)
        if i == 0:
            state_leaves = (tree_leaves(blocks) + tree_leaves(opt.mu)
                            + tree_leaves(opt.nu))
            (blocks, opt, metrics), log = record_step(
                step, (blocks, opt, batch), donated=state_leaves,
                returned=lambda r: tree_leaves(r[0])
                + tree_leaves(r[1].mu) + tree_leaves(r[1].nu),
                watch=False)
            rec["schedule"] = log.schedule()
        else:
            blocks, opt, metrics = step(blocks, opt, batch)
        losses.append(float(metrics["loss"]))
    rec.update(losses=losses, blocks=_host(blocks),
               params=_host(gather_tree(blocks, model.specs, grid)))
    return rec


def port_fsdp_rank(rank: int, world: int, inputs_path: str) -> dict | None:
    """Every FSDP x TP case on this rank of the (2, 2) grid; rank 0
    returns each rank's records. ``INPUTS.pkl`` holds the qwen2.5-3b
    cases of :data:`FSDP_KV` (keyed by the KV heads) or those of
    :data:`FAMILY_CASES` (keyed by name)."""
    import pickle

    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import init_mesh_groups

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    grid = init_mesh_groups(dist.group.WORLD, 2)
    out: dict = {}
    for key, case in inputs.items():
        if key in FAMILY_CASES:
            rec = port_fsdp_case(family_cfg(smoke_config, key), case, grid,
                                 FAMILY_CASES[key][2])
        else:
            rec = port_fsdp_case(smoke_config(ARCH).scaled(
                grad_accum=FSDP_ACCUM, n_kv_heads=key), case, grid)
        every = [None] * world
        dist.all_gather_object(every, rec)
        out[key] = every
    return out if rank == 0 else None


def card_rank(rank: int, world: int, params_path: str, device: str) -> list:
    """The ``gspmd`` executor at model degree 2 on ``device`` (4 ranks):
    ``mesh_grads`` at step 0, then two steps' losses and this rank's
    blocks; and the expert-parallel layer (smoke deepseek-v2-lite, fp32)
    on the model group. Rank 0 returns every rank's record (for
    ``tests/test_torch_cuda.py``: the card's ranks against the CPU's)."""
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.configs import smoke_config
    from repro_torch.exec import MeshExecutor
    from repro_torch.launch.mesh import init_mesh_groups
    from repro_torch.models import params_from_numpy
    from repro_torch.models.moe import moe_ffn

    with open(params_path, "rb") as f:
        inputs = pickle.load(f)
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    ex = MeshExecutor(cfg, model_degree=2, sync="gspmd", device=device,
                      **KW)
    ex.place_state(params_from_numpy(inputs["params"], device))
    rec = {"grads": _host(ex.mesh_grads(0))}
    rep = ex.run(2)
    rec.update(losses=[float(x) for x in rep.losses],
               blocks=_host(ex.params))
    ex.close()
    grid = init_mesh_groups(dist.group.WORLD, 2)
    moe_cfg = smoke_config(EP_ARCHS[0])
    p = params_from_numpy(inputs["moe"], device)
    x = torch.from_numpy(ep_inputs(moe_cfg.d_model)[0]).to(device)
    rec["moe_y"] = moe_ffn(x, p, moe_cfg,
                           group=grid.model_group).cpu().numpy()
    every = [None] * world
    dist.all_gather_object(every, rec)
    return every if rank == 0 else None
