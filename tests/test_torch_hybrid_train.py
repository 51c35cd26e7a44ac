"""Training the hybrid family (jamba-v0.1-52b) in the port against the
JAX package, on the CPU, at the smoke sizes (d 64, 8 experts top-2; 8
layers, and 16 where the stacked axis matters).

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same batches go through both packages,
in fp32. Tolerances:

* the gradient buckets' layout and the npz-v1 checkpoint's leaf names:
  equal to JAX's; one AdamW step over the hybrid tree within 1e-6
  relative (the same ops in the same order);
* the stacked step's loss within 1e-5 relative and each gradient leaf
  within 1e-5 of its largest element at 8 layers
  (``tests/test_torch_families_train.py``'s), 2e-5 at 16: fp32
  summation order through twice the depth (measured: up to 9.7e-6 at 8
  layers and 1.5e-5 at 16, spread evenly over the leaves);
* three int8-EF ``MeshExecutor`` steps: losses within 1e-5 relative; a
  leaf's update over the three steps, ``p - p0``, within 5e-2 of JAX's
  in the L2 norm. An element whose gradient quantizes one int8 step
  apart in the two packages (a value at a .5 boundary rounds the other
  way) is normalised by AdamW into an update of about +-lr of the other
  size or sign, and in the Mamba mixer's small leaves (``conv_w``, 640
  elements; ``dt_bias``, 16) one such element moves the L2 norm by a
  few %: measured at most 2.5e-2, where an update left out gives 1 and
  one of the wrong sign 2. Those elements' parameters then differ by
  ~lr, and the step-3 gradients with them, so the first stage's EF
  residuals agree per element within half a quantum (the same int8 code)
  for at least 95% of each bucket (measured 96.6% and up), not within
  1e-2 of a quantum for 98% as in the families' test (measured down to
  23% in some buckets); the second stage's residuals (the sum's
  re-quantisation, exact on one rank) within 1e-3 of the first stage's
  quantum (measured 2.9e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import _flatten_with_names as jax_names
from repro.configs import smoke_config as jax_smoke
from repro.core import Rectlr as JaxRectlr
from repro.core import SpareState as JaxSpareState
from repro.data import ShardedTokenPipeline as JaxPipeline
from repro.data import spare_batch as jax_spare_batch
from repro.dist.collectives import bucket_layout as jax_bucket_layout
from repro.exec import MeshExecutor as JaxMeshExecutor
from repro.models.model import Model as JaxModel
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.step import weighted_loss as jax_weighted_loss
from repro_torch.ckpt.checkpoint import _flatten_with_names
from repro_torch.configs import smoke_config
from repro_torch.dist import bucket_layout, tree_leaves, unflatten_grads
from repro_torch.exec import MeshExecutor
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import init_data_group
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.train import ScriptedInjector
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step)

ARCH = "jamba-v0.1-52b"
DEPTHS = [8, 16]
GRAD_TOL = {8: 1e-5, 16: 2e-5}
SCRIPT = {1: [0]}          # masked: S_A 1 -> 2
_JAX: dict = {}


def _cfgs(depth: int):
    return (jax_smoke(ARCH).scaled(n_layers=depth),
            smoke_config(ARCH).scaled(n_layers=depth))


def _jax_params(depth: int, dtype: str = "float32"):
    """The JAX model's init at ``depth`` as numpy leaves in ``dtype``
    (the fp32 leaves stay fp32)."""
    key = (depth, dtype)
    if key not in _JAX:
        params = JaxModel(cfg=_cfgs(depth)[0]).init(jax.random.key(0))
        if dtype == "float32":
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        _JAX[key] = jax.tree.map(np.asarray, params)
    return _JAX[key]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(depth: int):
    state = JaxSpareState(4, 2)
    JaxRectlr().on_failures(state, [1])
    return jax_spare_batch(JaxPipeline(_cfgs(depth)[0], 16, 2, seed=0),
                           state, 0)


@pytest.mark.parametrize("depth", DEPTHS)
def test_bucket_layout_and_checkpoint_names_follow_jax(depth):
    """The gradient buckets over the port's tree (in the JAX package's
    sorted-key order) equal JAX's layout of its own tree, and the npz-v1
    checkpoint names every leaf of a training state as JAX does."""
    jp = _jax_params(depth)
    tp = params_from_numpy(jp, "cpu")
    for pad_to, cap in ((1, 1 << 23), (4, 2048)):
        ours = bucket_layout(accumulator_specs(tp), max_bucket_elems=cap,
                             pad_to=pad_to)
        theirs = jax_bucket_layout(
            jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape,
                                                        jnp.float32), jp),
            max_bucket_elems=cap, pad_to=pad_to)
        for field in ("shapes", "dtypes", "bucket_of", "offsets",
                      "bucket_sizes"):
            assert getattr(ours, field) == getattr(theirs, field), field
    jstate = (jp, jax_adamw_init(jax.tree.map(jnp.asarray, jp)))
    tstate = (tp, adamw_init(tp))
    want = [n for n, _ in jax_names(jstate)]
    assert [n for n, _ in _flatten_with_names(tstate)] == want
    assert "0/segments/0/1/moe/experts/w_gate" in want
    assert "1/mu/segments/0/4/attn/wq" in want


def test_adamw_decays_the_stacked_router_and_experts_as_jax():
    """One AdamW step over the hybrid tree in fp32 against JAX's: the
    ``ndim > 1`` decay takes every stacked leaf (the fp32 router, the
    4-d experts, the stacked norms) and leaves ``final_norm`` alone."""
    jp = _jax_params(8)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2,
        jp)
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    jnew, _, jnorm = jax.jit(jax_adamw_update, static_argnames=(
        "weight_decay", "clip_norm"))(
        jax.tree.map(jnp.asarray, grads),
        jax_adamw_init(jax.tree.map(jnp.asarray, jp)),
        jax.tree.map(jnp.asarray, jp), 1e-2, **kw)
    tp = params_from_numpy(jp, "cpu")
    _, _, tnorm = adamw_update(params_from_numpy(grads, "cpu"),
                               adamw_init(tp), tp, 1e-2, **kw)
    assert abs(float(tnorm) - float(jnorm)) <= 1e-5 * float(jnorm)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("depth", DEPTHS)
def test_stacked_step_loss_and_grads_match_jax(depth):
    """Two microbatches (S_A = 2) of the weighted loss, forward and
    backward, against ``jax.value_and_grad`` in fp32: the gradients of
    the router, the experts, both mixers and the stacked norms."""
    jc, tc = _cfgs(depth)
    jm, tm = JaxModel(cfg=jc), build_model(tc, device="cpu")
    jp = jax.tree.map(jnp.asarray, _jax_params(depth))
    tp = params_from_numpy(_jax_params(depth), "cpu")
    batch = _batch(depth)
    assert batch["weights"].shape[0] == 2

    # one microbatch's program, compiled once and run on each: the sum
    # of their values and gradients is JAX's stacked step's
    micro = jax.jit(jax.value_and_grad(
        lambda p, b: jax_weighted_loss(jm, p, b)))
    outs = [micro(jp, {k: jnp.asarray(v[j]) for k, v in batch.items()})
            for j in range(batch["weights"].shape[0])]
    jloss = sum(o[0] for o in outs)
    jgrads = jax.tree.map(lambda *g: sum(g), *(o[1] for o in outs))
    layout = bucket_layout(accumulator_specs(tp))
    grads = unflatten_grads(layout, layout.zeros("cpu"))
    loss = accumulate_grads(tm, tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, grads)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        assert np.asarray(j).any()
        assert _rel(t.numpy(), j) <= GRAD_TOL[depth]


def test_mesh_executor_int8_ef_step_matches_jax_on_one_rank(tmp_path):
    """Three int8-EF steps of the MeshExecutor on a one-rank gloo group
    against JAX's on a one-device mesh, group 0 killed at poll 1 (masked:
    S_A 1 -> 2), fp32: the same report, every step's loss within 1e-5
    relative, each leaf's update ``p - p0`` within 5e-2 of JAX's in the
    L2 norm (see the module doc), the EF residuals as in the families'
    test."""
    init_data_group("cpu", store_path=str(tmp_path / "store"))
    jc, tc = _cfgs(8)
    common = dict(n_groups=4, redundancy=2, seq=16, per_type_batch=1,
                  total_steps=50, grad_compress="int8_ef", bucket_mb=0.01,
                  base_lr=0.1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    params = _jax_params(8)
    je = JaxMeshExecutor(jc, mesh=mesh, **common)
    je.params = jax.device_put(jax.tree.map(jnp.asarray, params),
                               je._pshard)
    je.opt_state = jax.device_put(jax_adamw_init(je.params), je._oshard)
    te = MeshExecutor(tc, device="cpu", **common)
    te.params = params_from_numpy(params, "cpu")
    te.opt_state = adamw_init(te.params)
    assert te._layout.bucket_sizes == je._layout.bucket_sizes
    want = je.run(3, injector=JaxScripted(SCRIPT))
    got = te.run(3, injector=ScriptedInjector(SCRIPT))
    assert (got.steps_done, got.failures, got.wipeouts) == \
        (want.steps_done, want.failures, want.wipeouts) == (3, 1, 0)
    assert [(e.victims, e.s_a_after) for e in got.events] == \
        [(e.victims, e.s_a_after) for e in want.events]
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    for t, j, q in zip(tree_leaves(te.params), jax.tree.leaves(je.params),
                       jax.tree.leaves(params)):
        q = np.asarray(q, np.float64)
        dt = t.double().numpy() - q
        dj = np.asarray(j, np.float64) - q
        assert np.linalg.norm(dt - dj) <= 5e-2 * np.linalg.norm(dj)
    # the first stage's residuals: per bucket at least 95% of the
    # elements within half the bucket's quantum of JAX's (the same int8
    # code; see the module doc)
    ef, jef = te._ef_state, je._ef_state
    for a, b in zip(ef["err1"], jef["err1"]):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 0.5 * 2 * np.abs(b).max()).mean() >= 0.95
    for a, b, e1 in zip(ef["err2"], jef["err2"], jef["err1"]):
        assert np.abs(a.double().numpy() - np.asarray(b, np.float64)).max() \
            <= 1e-3 * 2 * np.abs(np.asarray(e1)).max()


def test_remat_launch_counts_of_the_period(monkeypatch):
    """The card's launch gates per training microbatch, counting the
    remat recompute: K1 2(3 M + 2 A) + 1 (a Mamba block's ln1, gated
    norm and ln2; an attention block's ln1 and ln2; the final norm), K2
    2A and K4 2M, for M Mamba and A attention blocks; counted here
    through the plain versions the CPU runs."""
    calls = dict.fromkeys(("rmsnorm", "flash", "ssd"), 0)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(ops, "rmsnorm_ref", count("rmsnorm",
                                                  ops.rmsnorm_ref))
    monkeypatch.setattr(ops, "flash_attention_ref",
                        count("flash", ops.flash_attention_ref))
    monkeypatch.setattr(ops, "ssd_scan_ref", count("ssd", ops.ssd_scan_ref))
    cfg = smoke_config(ARCH).scaled(grad_accum=1)
    tm = build_model(cfg, device="cpu")
    params = params_from_numpy(_jax_params(8), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(8).items()}
    make_train_step(tm)(params, adamw_init(params), batch)
    n_micro, m, a = 2, 7, 1
    assert calls == {"rmsnorm": n_micro * (2 * (3 * m + 2 * a) + 1),
                     "flash": n_micro * 2 * a, "ssd": n_micro * 2 * m}


def test_train_cli_runs_jamba_through_the_int8_ef_mesh(capsys):
    assert train_cli.main(["--device", "cpu", "--arch", ARCH, "--steps",
                           "4", "--n-groups", "4", "-r", "2", "--seq", "16",
                           "--mtbf-steps", "2", "--mesh",
                           "--grad-compress", "int8_ef"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out
    assert "[train] done:" in out and "mesh=4x1/shard_map+int8_ef" in out
