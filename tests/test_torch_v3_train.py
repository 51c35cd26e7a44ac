"""deepseek-v3-671b's training settings in the port against the JAX
package, on the CPU, at deepseek-v3's smoke sizes (d 64, MLA with
kv_lora 32 and q_lora 32, one dense and two MoE blocks, 8 experts top-2,
1 shared) with its own ``grad_accum=8``, ``grad_accum_dtype="bfloat16"``
and ``moment_dtype="bfloat16"``.

The same parameters (the JAX model's init as fp32 leaves, carried over
by ``params_from_numpy``) and the same numpy batches go through both
packages. Every step here takes at least two microbatches, so the bf16
accumulator's add is a real rounding (with one it is ``0 + g``, exact).
Tolerances:

* the stacked step (8 microbatches): the loss within 1e-5 relative; the
  bf16 accumulator, and the bf16 moments after the update, within one
  bf16 ulp of each leaf's largest element (2**-7 of it): each
  microbatch's fp32 gradient differs from JAX's in its last bits, which
  moves a value across a bf16 rounding boundary now and then (99.9% of
  the elements are the same bits); the parameters' update within 1e-2 of
  JAX's in the L2 norm;
* ``adamw_update`` with bf16 moments on the same fp32 inputs, the
  gradient's norm below the clip (its scale exactly 1 in both): the
  moments bit for bit (the same fp32 ops in the same order, one rounding
  to bf16), the global norm within 1e-6 (its sum runs in another order),
  the parameters within 1e-6 of their update (XLA and PyTorch round the
  decayed leaves' update apart in a few elements' last bit);
* three int8-EF ``MeshExecutor`` steps on a one-rank gloo group, S_A 2
  from the first step: the losses within 1e-5 relative and each leaf's
  update within 5e-2 of JAX's in the L2 norm, as in
  ``tests/test_torch_deepseek_train.py``; the EF residuals after the
  first step: the first stage's within half a quantum for at least 99.9%
  of each bucket (it is 91.7% in one bucket by the third step: a bf16
  rounding that flips between the packages moves an int8 code, and
  AdamW at lr 0.1 carries the difference into the next gradients), the
  second stage's within 1e-3 of the first stage's quantum;
* the npz-v1 checkpoint of a state with bf16 moments: byte-identical to
  JAX's under a fixed clock, and each package restores the other's bit
  for bit;
* the accumulator itself: bit for bit the per-microbatch gradients
  rounded to bf16 and added in order, which an fp32 accumulator is not.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import smoke_config as jax_smoke
from repro.exec import MeshExecutor as JaxMeshExecutor
from repro.models.model import Model as JaxModel
from repro.optim import AdamWState as JaxAdamWState
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.step import weighted_loss as jax_weighted_loss
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import smoke_config
from repro_torch.dist import tree_leaves
from repro_torch.exec import MeshExecutor
from repro_torch.launch.mesh import init_data_group
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.train import ScriptedInjector
from repro_torch.train.step import make_train_step

ARCH = "deepseek-v3-671b"
SCRIPT = {0: [0]}          # masked at the first poll: S_A 2 every step
FIXED = 1_700_000_000.0
_CACHE: dict = {}


def _jax_params():
    """The JAX model's init as fp32 numpy leaves."""
    if "p" not in _CACHE:
        params = JaxModel(cfg=jax_smoke(ARCH)).init(jax.random.key(0))
        _CACHE["p"] = jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), params)
    return _CACHE["p"]


def _batch(n_micro: int, seed: int = 0) -> dict:
    """``n_micro`` microbatches of 2 examples of 16 tokens, weights
    summing to 1."""
    cfg = jax_smoke(ARCH)
    rng = np.random.default_rng(seed)
    shape = (n_micro, 2, 16)
    return {"tokens": rng.integers(0, cfg.vocab, shape).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, shape).astype(np.int32),
            "weights": np.full(shape[:2], 1.0 / (2 * n_micro), np.float32)}


def _ulps_of_max(got, want) -> float:
    """The largest ``|got - want|`` in bf16 ulps of ``max |want|``."""
    g, w = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.abs(g - w).max() / (2.0 ** -7 * max(np.abs(w).max(),
                                                        1e-30)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_v3_smoke_config_keeps_its_training_settings():
    """The smoke configuration both packages' launchers and these tests
    run carries deepseek-v3's own accumulator, moments and microbatch
    count."""
    cfg = smoke_config(ARCH)
    assert (cfg.grad_accum, cfg.grad_accum_dtype, cfg.moment_dtype) == \
        (8, "bfloat16", "bfloat16")
    jc = jax_smoke(ARCH)
    assert (jc.grad_accum, jc.grad_accum_dtype, jc.moment_dtype) == \
        (cfg.grad_accum, cfg.grad_accum_dtype, cfg.moment_dtype)


def test_stacked_step_matches_jax_with_bf16_accumulator_and_moments():
    """One step of ``make_train_step`` over v3's 8 microbatches against
    JAX's: the loss, the bf16 accumulator (against JAX's ``g_acc +
    g.astype(bfloat16)`` over the same microbatches), the bf16 moments
    and the parameters' update, as the module doc says."""
    cfg = smoke_config(ARCH)
    jm = JaxModel(cfg=jax_smoke(ARCH))
    jp = jax.tree.map(jnp.asarray, _jax_params())
    batch = _batch(cfg.grad_accum)
    micro = jax.jit(jax.value_and_grad(lambda p, b: jax_weighted_loss(jm, p,
                                                                      b)))
    jacc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.bfloat16), jp)
    for j in range(cfg.grad_accum):
        _, g = micro(jp, {k: jnp.asarray(v[j]) for k, v in batch.items()})
        jacc = jax.tree.map(lambda a, b: a + b.astype(jnp.bfloat16), jacc, g)
    jstep = jax.jit(jax_make_train_step(jm, base_lr=0.1, warmup=1,
                                        total_steps=50))
    jnew, jopt, jmet = jstep(jp, jax_adamw_init(jp, jnp.bfloat16),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    tp = params_from_numpy(_jax_params(), "cpu")
    step = make_train_step(build_model(cfg, device="cpu"), base_lr=0.1,
                           warmup=1, total_steps=50)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, bufs, tree = step.accumulate(tp, tb)
    assert bufs is None
    tacc = [t.clone() for t in tree_leaves(tree)]
    _, topt, tmet = step(tp, adamw_init(tp, cfg.moment_dtype), tb)

    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        1e-5 * abs(float(jmet["loss"]))
    for ours, theirs in ((tacc, jax.tree.leaves(jacc)),
                         (tree_leaves(topt.mu), jax.tree.leaves(jopt.mu)),
                         (tree_leaves(topt.nu), jax.tree.leaves(jopt.nu))):
        assert len(ours) == len(theirs)
        for t, j in zip(ours, theirs):
            assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
            assert np.asarray(j).any()
            assert _ulps_of_max(_f32(t), _f32(j)) <= 1.0
    for t, j, q in zip(tree_leaves(tp), jax.tree.leaves(jnew),
                       jax.tree.leaves(_jax_params())):
        q = np.asarray(q, np.float64)
        dt, dj = t.double().numpy() - q, np.asarray(j, np.float64) - q
        assert np.linalg.norm(dt - dj) <= 1e-2 * np.linalg.norm(dj)


def test_accumulator_is_the_in_order_bf16_sum_of_microbatch_gradients():
    """The step's accumulator over v3's 8 microbatches equals, bit for
    bit, each microbatch's gradient rounded to bf16 and added in order in
    bf16; the fp32 sum rounded once (what an fp32 accumulator gives)
    differs from it at these inputs, so an fp32 accumulator fails here."""
    cfg = smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    tp = params_from_numpy(_jax_params(), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg.grad_accum,
                                                       seed=1).items()}
    got = tree_leaves(make_train_step(model).accumulate(tp, batch)[2])
    f32_step = make_train_step(build_model(cfg.scaled(
        grad_accum_dtype="float32"), device="cpu"))
    chain = f32 = None
    for j in range(cfg.grad_accum):
        one = {k: v[j:j + 1] for k, v in batch.items()}
        g = [t.clone() for t in tree_leaves(f32_step.accumulate(tp,
                                                                one)[2])]
        if chain is None:
            chain, f32 = [x.bfloat16() for x in g], g
        else:
            chain = [a + x.bfloat16() for a, x in zip(chain, g)]
            f32 = [a + x for a, x in zip(f32, g)]
    assert all(t.dtype == torch.bfloat16 for t in got)
    for t, c in zip(got, chain):
        assert torch.equal(t.view(torch.int16), c.view(torch.int16))
    assert any(not torch.equal(c, a.bfloat16()) for c, a in zip(chain, f32))


def test_adamw_update_with_bf16_moments_matches_jax():
    """``adamw_update`` on bf16 moments (nonzero, from a step before)
    against JAX's: the moments bit for bit, the parameters within 1e-6 of
    their update, the step count and the global norm (below the clip)."""
    rng = np.random.default_rng(3)
    shapes = {"w": (3, 64, 48), "b": (48,), "n": (3, 64)}
    p = {k: rng.normal(0, 0.05, s).astype(np.float32)
         for k, s in shapes.items()}
    g = {k: rng.normal(0, 0.003, s).astype(np.float32)
         for k, s in shapes.items()}
    m = {k: (rng.normal(0, 0.01, s)).astype(jnp.bfloat16)
         for k, s in shapes.items()}
    v = {k: (rng.random(s) * 1e-3).astype(jnp.bfloat16)
         for k, s in shapes.items()}
    jnew, jst, jnorm = jax_adamw_update(
        jax.tree.map(jnp.asarray, g),
        JaxAdamWState(jnp.asarray(4, jnp.int32), jax.tree.map(jnp.asarray, m),
                      jax.tree.map(jnp.asarray, v)),
        jax.tree.map(jnp.asarray, p), 0.01)

    def t(tree, dtype=torch.float32):
        # copies: the update works in place
        return {k: torch.tensor(np.asarray(x, np.float32)).to(dtype)
                for k, x in tree.items()}
    tp = t(p)
    st = AdamWState(4, t(m, torch.bfloat16), t(v, torch.bfloat16))
    _, st, tnorm = adamw_update(t(g), st, tp, 0.01)
    assert st.step == int(jst.step) == 5
    assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm) < 1.0
    for k in shapes:
        for ours, theirs in ((st.mu[k], jst.mu[k]), (st.nu[k], jst.nu[k])):
            assert ours.dtype == torch.bfloat16
            assert np.array_equal(_f32(ours), _f32(theirs)), k
        upd = np.asarray(jnew[k], np.float64) - p[k]
        assert np.abs(tp[k].double().numpy() - np.asarray(jnew[k])).max() \
            <= 1e-6 * np.abs(upd).max()


def test_bf16_moments_checkpoint_follows_jax(tmp_path, monkeypatch):
    """A state with bf16 moments (v3's smoke params, moments from a step
    before) saves under the JAX names byte-identical to JAX's save with a
    fixed clock (bf16 as a ``uint16`` view, ``"bfloat16"`` in the
    manifest), and each package restores the other's bit for bit."""
    monkeypatch.setattr(time, "time", lambda: FIXED)   # zip entry stamps
    rng = np.random.default_rng(4)
    params = _jax_params()
    moments = [jax.tree.map(lambda a: rng.normal(0, 1e-3, a.shape).astype(
        jnp.bfloat16), params) for _ in range(2)]
    jstate = (jax.tree.map(jnp.asarray, params),
              JaxAdamWState(jnp.asarray(2, jnp.int32),
                            *(jax.tree.map(jnp.asarray, x) for x in moments)))
    tstate = (params_from_numpy(params, "cpu"),
              AdamWState(2, *(_bf16_tree(x) for x in moments)))
    a = jax_save(tmp_path / "jax", 2, jstate, clock=lambda: FIXED)
    b = save_checkpoint(tmp_path / "port", 2, tstate, clock=lambda: FIXED)
    for name in ("manifest.json", "shard_0.npz"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert "1/mu/segments/1/0/moe/shared/w_down" in \
        (b / "manifest.json").read_text()
    step, got = restore_checkpoint(tmp_path / "jax", tstate)
    assert step == 2 and got[1].step == 2
    for x, y in zip(tree_leaves(got[1].mu) + tree_leaves(got[1].nu),
                    tree_leaves(tstate[1].mu) + tree_leaves(tstate[1].nu)):
        assert x.dtype == torch.bfloat16
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))
    _, want = jax_restore(tmp_path / "port", jstate)
    for x, y in zip(jax.tree.leaves(want[1].mu), jax.tree.leaves(moments[0])):
        assert x.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(x).view(np.uint16),
                              np.asarray(y).view(np.uint16))


def _bf16_tree(tree):
    """A numpy tree of bf16 leaves as the port's tree of bf16 tensors."""
    t = params_from_numpy(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                       tree), "cpu")

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v) for v in x)
        return x.to(torch.bfloat16)
    return cast(t)


def test_mesh_executor_int8_ef_bf16_step_matches_jax_on_one_rank(tmp_path):
    """Three int8-EF steps of the MeshExecutor with v3's bf16 accumulator
    and bf16 moments on a one-rank gloo group against JAX's on a
    one-device mesh, group 0 killed at the first poll (S_A 2 every
    step), as one run of a step and one of two: the same reports, the
    losses, each leaf's update, the moments bf16 on both, and the EF
    residuals after the first step, as the module doc says."""
    init_data_group("cpu", store_path=str(tmp_path / "store"))
    jc, tc = jax_smoke(ARCH), smoke_config(ARCH)
    common = dict(n_groups=4, redundancy=2, seq=16, per_type_batch=1,
                  total_steps=50, grad_compress="int8_ef", bucket_mb=0.01,
                  base_lr=0.1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    params = _jax_params()
    je = JaxMeshExecutor(jc, mesh=mesh, **common)
    je.params = jax.device_put(jax.tree.map(jnp.asarray, params),
                               je._pshard)
    je.opt_state = jax.device_put(jax_adamw_init(je.params, jnp.bfloat16),
                                  je._oshard)
    te = MeshExecutor(tc, device="cpu", **common)
    te.params = params_from_numpy(params, "cpu")
    te.opt_state = adamw_init(te.params, tc.moment_dtype)
    assert te._layout.bucket_sizes == je._layout.bucket_sizes
    assert te._layout.dtypes == je._layout.dtypes
    assert set(te._layout.dtypes) == {"bfloat16"}
    jinj, tinj = JaxScripted(SCRIPT), ScriptedInjector(SCRIPT)
    want, got = je.run(1, injector=jinj), te.run(1, injector=tinj)
    ef, jef = te._ef_state, je._ef_state
    for a, b in zip(ef["err1"], jef["err1"]):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 0.5 * 2 * np.abs(b).max()).mean() >= 0.999
    for a, b, e1 in zip(ef["err2"], jef["err2"], jef["err1"]):
        assert np.abs(a.double().numpy() - np.asarray(b, np.float64)).max() \
            <= 1e-3 * 2 * np.abs(np.asarray(e1)).max()
    assert [(e.victims, e.s_a_after) for e in got.events] == \
        [(e.victims, e.s_a_after) for e in want.events] == [([0], 2)]
    want2, got2 = je.run(2, injector=jinj), te.run(2, injector=tinj)
    assert [(r.steps_done, r.failures, r.wipeouts) for r in (got, got2)] \
        == [(r.steps_done, r.failures, r.wipeouts) for r in (want, want2)] \
        == [(1, 1, 0), (2, 0, 0)]
    for a, b in zip(got.losses + got2.losses, want.losses + want2.losses):
        assert abs(a - b) <= 1e-5 * abs(b)
    for t, j, q in zip(tree_leaves(te.params), jax.tree.leaves(je.params),
                       jax.tree.leaves(params)):
        q = np.asarray(q, np.float64)
        dt = t.double().numpy() - q
        dj = np.asarray(j, np.float64) - q
        assert np.linalg.norm(dt - dj) <= 5e-2 * np.linalg.norm(dj)
    assert {t.dtype for t in tree_leaves(te.opt_state.mu)} == \
        {torch.bfloat16}
    assert {x.dtype for x in jax.tree.leaves(je.opt_state.mu)} == \
        {jnp.dtype(jnp.bfloat16)}
    assert set(te._step_fn.buckets) == {"tree"}


@pytest.mark.parametrize("sync", ["bucketed", "int8_ef"])
def test_sync_tree_rounds_the_synced_buckets_into_the_leaves(sync, tmp_path):
    """The syncs' ``sync_tree`` on a bf16 tree (one rank): the leaves end
    as the bf16 rounding of what the fp32 sync of the flattened tree
    gives, the residuals as that sync leaves them, and the padding of
    each bucket enters as zeros."""
    from repro_torch.dist import (BucketedAllReduce, CompressedBucketSync,
                                  bucket_layout, flatten_grads,
                                  unflatten_grads)

    init_data_group("cpu", store_path=str(tmp_path / "store"))
    gen = torch.Generator().manual_seed(5)
    tree = {"a": torch.randn((5, 7), generator=gen).bfloat16(),
            "b": [torch.randn((3,), generator=gen).bfloat16(),
                  torch.randn((2, 2, 3), generator=gen).bfloat16()]}
    layout = bucket_layout(tree, max_bucket_elems=16, pad_to=4)
    assert layout.n_buckets == 2 and layout.n_elems > sum(
        t.numel() for t in tree_leaves(tree))          # padded buckets
    bufs = flatten_grads(layout, tree)
    if sync == "bucketed":
        ref = unflatten_grads(layout, [b.clone() for b in bufs])
        BucketedAllReduce(layout)(bufs)
        want = unflatten_grads(layout, bufs)
        got = BucketedAllReduce(layout).sync_tree(tree)
        assert got is tree
        for t, r in zip(tree_leaves(tree), tree_leaves(ref)):
            assert torch.equal(t, r)     # one rank: the sum is the input
    else:
        s1, s2 = CompressedBucketSync(layout, 1), CompressedBucketSync(layout,
                                                                       1)
        e1 = s1.init_state("cpu")
        for err in e1["err1"]:
            err.normal_(0, 1e-3, generator=gen)
        e2 = {"err1": tuple(x.clone() for x in e1["err1"]),
              "err2": tuple(x.clone() for x in e1["err2"])}
        want, e1 = s1(bufs, e1)
        got, e2 = s2.sync_tree(tree, e2)
        for a, b in zip(e1["err1"] + e1["err2"], e2["err1"] + e2["err2"]):
            assert torch.equal(a, b)
    for t, w in zip(tree_leaves(tree), tree_leaves(want)):
        assert t.dtype == torch.bfloat16 and torch.equal(t, w)
