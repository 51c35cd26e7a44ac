"""The port's training path against the JAX package's, on the CPU, at a
tiny fp32 configuration (2 layers, d_model 64, head_dim 64): the same
parameters (``params_from_numpy``) and the same batches (the same
Philox counters) go through both.

Tolerances: 1e-5 (relative for losses and gradients, absolute for
params of magnitude ~0.1): fp32 in another summation order. Report
fields (failures, wipe-outs, reorders, patches, ``S_A``, rollback
depth) are identical. The int8-EF ``MeshExecutor`` holds the §3.1
``equivalence_error`` under ``int8_sweep_tolerance``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.core import Rectlr as JaxRectlr
from repro.core import SpareState as JaxSpareState
from repro.data import ShardedTokenPipeline as JaxPipeline
from repro.data import spare_batch as jax_spare_batch
from repro.exec import MeshExecutor as JaxMeshExecutor
from repro.models import build_model as jax_build
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_lr as jax_cosine_lr
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.step import weighted_loss as jax_weighted_loss
from repro.train.trainer import SpareTrainer as JaxTrainer
from repro_torch.configs import smoke_config
from repro_torch.dist import bucket_layout, tree_leaves, unflatten_grads
from repro_torch.exec import (MeshExecutor, int8_sweep_tolerance,
                              tree_max_rel_err)
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import init_data_group, require_nccl
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw_init, adamw_update, cosine_lr
from repro_torch.train import ScriptedInjector
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step, weighted_loss)
from repro_torch.train.trainer import SpareTrainer, TrainReport

ARCH = "qwen2.5-3b"
TINY = dict(head_dim=64, grad_accum=1)
REPORT = ("failures", "wipeouts", "reorders", "patches", "recompiles",
          "steps_done", "rollback_steps")
_JAX: dict = {}


def _jax_params():
    """One set of fp32 parameters (numpy leaves, the JAX package's tree),
    drawn by the port's init: both packages' trees have the same
    structure, so either can feed both."""
    if not _JAX:
        model = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
        _JAX["params"] = jax.tree.map(lambda t: t.float().numpy(),
                                      model.init(0))
    return _JAX["params"]


def _batch(n=4, r=2, step=0, fail=()):
    state = JaxSpareState(n, r)
    if fail:
        JaxRectlr().on_failures(state, list(fail))
    return jax_spare_batch(JaxPipeline(jax_smoke(ARCH).scaled(**TINY), 16,
                                       2, seed=0), state, step)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_weighted_loss_and_stacked_step_grads_match_jax():
    jm = jax_build(jax_smoke(ARCH).scaled(**TINY))
    tm = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tp = params_from_numpy(_jax_params(), "cpu")
    batch = _batch(fail=[1])              # S_A = 2: two microbatches
    assert batch["weights"].shape[0] == 2
    micro = {k: v[0] for k, v in batch.items()}
    want = jax.jit(partial(jax_weighted_loss, jm))(
        jp, {k: jnp.asarray(v) for k, v in micro.items()})
    got = weighted_loss(tm, tp, {k: torch.from_numpy(v)
                                 for k, v in micro.items()})
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))

    def total(p, b):
        return sum(jax_weighted_loss(jm, p, {k: v[j] for k, v in b.items()})
                   for j in range(b["weights"].shape[0]))
    jgrads = jax.jit(jax.grad(total))(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    layout = bucket_layout(accumulator_specs(tp))
    grads = unflatten_grads(layout, layout.zeros("cpu"))
    accumulate_grads(tm, tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, grads)
    jl = jax.tree.leaves(jgrads)
    tl = tree_leaves(grads)
    assert len(jl) == len(tl)
    assert max(_rel(t.numpy(), j) for t, j in zip(tl, jl)) <= 1e-5


def test_adamw_over_three_steps_matches_jax():
    rng = np.random.default_rng(0)
    params = _jax_params()
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_numpy(params, "cpu")
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    jupdate = jax.jit(jax_adamw_update)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        lr_j = jax_cosine_lr(jo.step + 1, 1e-2, 2, 10)
        lr_t = cosine_lr(to.step + 1, 1e-2, 2, 10)
        assert lr_t == float(lr_j)
        jp, jo, jn = jupdate(jax.tree.map(jnp.asarray, g), jo, jp, lr_j)
        tp, to, tn = adamw_update(params_from_numpy(g, "cpu"), to, tp, lr_t)
        assert abs(float(tn) - float(jn)) <= 1e-5 * float(jn)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)
    for t, j in zip(tree_leaves(to.nu), jax.tree.leaves(jo.nu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-12)


def test_train_step_matches_jax_over_three_steps():
    jm = jax_build(jax_smoke(ARCH).scaled(**TINY))
    tm = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tp = params_from_numpy(_jax_params(), "cpu")
    jstep, tstep = jax.jit(jax_make_train_step(jm)), make_train_step(tm)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    batch = _batch(fail=[1])
    for _ in range(3):
        jp, jo, jm_ = jstep(jp, jo, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        tp, to, tm_ = tstep(tp, to, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) \
            <= 1e-5 * float(jm_["loss"])
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=0)


def _same_report(got, want):
    for f in REPORT:
        assert getattr(got, f) == getattr(want, f), f
    assert [(e.victims, e.wipeout, e.reordered, e.patch_count, e.s_a_before,
             e.s_a_after, e.rollback_depth) for e in got.events] == \
        [(e.victims, e.wipeout, e.reordered, e.patch_count, e.s_a_before,
          e.s_a_after, e.rollback_depth) for e in want.events]
    assert len(got.losses) == len(want.losses)
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= 1e-5 * abs(b)


SCRIPT = {1: [0], 3: [1, 3]}          # masked (S_A 1 -> 2), then wipe-out


def test_spare_trainer_matches_jax_through_mask_and_wipeout():
    common = dict(n_groups=4, redundancy=2, seq=16, per_type_batch=2,
                  total_steps=50)
    jt = JaxTrainer(jax_smoke(ARCH).scaled(**TINY), **common)
    jt.params = jax.tree.map(jnp.asarray, _jax_params())
    jt.opt_state = jax_adamw_init(jt.params)
    tt = SpareTrainer(smoke_config(ARCH).scaled(**TINY), device="cpu",
                      **common)
    tt.params = params_from_numpy(_jax_params(), "cpu")
    tt.opt_state = adamw_init(tt.params)
    want = jt.run(5, injector=JaxScripted(SCRIPT))
    got = tt.run(5, injector=ScriptedInjector(SCRIPT))
    assert want.wipeouts == 1 and want.rollback_steps == 3
    _same_report(got, want)
    # the replayed step 0 recomputes the first step's loss bit for bit
    assert got.losses[3] == got.losses[0]
    assert tt.state.s_a == jt.state.s_a


def test_trainer_refuses_what_is_not_ported():
    cfg = smoke_config(ARCH).scaled(**TINY)
    # both syncs are ported (tests/test_torch_tp.py); what JAX's
    # executor refuses, this one refuses
    with pytest.raises(ValueError, match="shard_map"):
        MeshExecutor(cfg, n_groups=4, redundancy=2, device="cpu",
                     sync="gspmd", grad_compress="int8_ef")
    with pytest.raises(ValueError, match="sync must be one of"):
        MeshExecutor(cfg, n_groups=4, redundancy=2, device="cpu",
                     sync="pjit")
    # the elastic escape hatch of the gray-failure tier is the elastic
    # executor's: the base trainer never picks it, and refuses it
    tr = SpareTrainer(cfg, n_groups=4, redundancy=2, device="cpu")
    assert tr._degraded_dp_new([0]) == 0
    assert tr._unmaskable_action([0, 1], None) == "restart"
    hr = type("Health", (), {"factors": np.full(4, 3.0)})()
    with pytest.raises(NotImplementedError, match="ElasticMeshExecutor"):
        tr._health_reshape([0], hr, None, TrainReport())


def test_mesh_executor_int8_ef_matches_jax_on_one_rank(tmp_path):
    """The MeshExecutor on a one-rank gloo group against JAX's on a
    one-device ``(data, model)`` mesh, int8 EF: the same run through a
    mask and a wipe-out, and §3.1 within the int8 sweep tolerance. A
    group without NCCL is refused for CUDA tensors (gloo would route the
    sync through the host)."""
    group = init_data_group("cpu", store_path=str(tmp_path / "store"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL"):
            require_nccl(group)
    common = dict(n_groups=4, redundancy=2, seq=16, per_type_batch=1,
                  total_steps=50, grad_compress="int8_ef", bucket_mb=0.01)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    je = JaxMeshExecutor(jax_smoke(ARCH).scaled(**TINY), mesh=mesh,
                         **common)
    je.params = jax.device_put(jax.tree.map(jnp.asarray, _jax_params()),
                               je._pshard)
    je.opt_state = jax.device_put(jax_adamw_init(je.params), je._oshard)
    te = MeshExecutor(smoke_config(ARCH).scaled(**TINY), device="cpu",
                      **common)
    te.params = params_from_numpy(_jax_params(), "cpu")
    te.opt_state = adamw_init(te.params)
    assert te._layout.bucket_sizes == je._layout.bucket_sizes
    tol = int8_sweep_tolerance(1)
    err = tree_max_rel_err(te.mesh_grads(0), te.vanilla_reference_grads(0))
    assert err <= tol
    want = je.run(5, injector=JaxScripted(SCRIPT))
    got = te.run(5, injector=ScriptedInjector(SCRIPT))
    _same_report(got, want)
    # gradients that differ by summation order may round a value at a .5
    # boundary the other way: each residual within one quantization step
    # (twice the largest residual of its bucket) of JAX's
    for a, b in zip(tree_leaves(te._ef_state), jax.tree.leaves(
            je._ef_state)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2 * np.abs(b).max()


def test_remat_recomputes_each_block_once(monkeypatch):
    """The launch counts the card's gates derive (K1 4L + 1 and K2 2L per
    microbatch, counting the recompute) hold for the code: counted here
    through the plain versions the CPU runs."""
    calls = {"rmsnorm": 0, "flash": 0}
    rms, flash = ops.rmsnorm_ref, ops.flash_attention_ref

    def count_rms(*a, **k):
        calls["rmsnorm"] += 1
        return rms(*a, **k)

    def count_flash(*a, **k):
        calls["flash"] += 1
        return flash(*a, **k)

    monkeypatch.setattr(ops, "rmsnorm_ref", count_rms)
    monkeypatch.setattr(ops, "flash_attention_ref", count_flash)
    cfg = smoke_config(ARCH).scaled(**TINY)
    tm = build_model(cfg, device="cpu")
    step = make_train_step(tm)
    params = params_from_numpy(_jax_params(), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(fail=[1]).items()}
    step(params, adamw_init(params), batch)
    n_micro, L = 2, cfg.n_layers
    assert calls == {"rmsnorm": n_micro * (4 * L + 1),
                     "flash": n_micro * 2 * L}


def test_train_cli_runs_on_the_cpu_and_refuses_without_a_card(capsys):
    assert train_cli.main(["--device", "cpu", "--steps", "2", "--n-groups",
                           "4", "-r", "2", "--seq", "16", "--mesh",
                           "--grad-compress", "int8_ef"]) == 0
    out = capsys.readouterr().out
    assert "[train] done: 2 steps" in out and "mesh=4x1/shard_map+int8_ef" \
        in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--steps", "1"])
