"""Training the ``moe`` family (deepseek-v2-lite-16b: MLA attention, a
dense block, then MoE blocks with a shared expert) in the port against
the JAX package, on the CPU, at the smoke sizes (d 64, kv_lora 32, 8
experts top-2, 1 shared, 3 layers).

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same batches go through both packages,
in fp32. Tolerances, those of ``tests/test_torch_hybrid_train.py`` (see
its module doc for why):

* the gradient buckets' layout and the npz-v1 checkpoint's leaf names:
  equal to JAX's;
* the stacked step's loss within 1e-5 relative and each gradient leaf
  within 1e-5 of its largest element (the MLA leaves, the shared
  expert, the router, the experts, the stacked norms);
* three int8-EF ``MeshExecutor`` steps: losses within 1e-5 relative; a
  leaf's update over the three steps within 5e-2 of JAX's in the L2
  norm; the first stage's EF residuals within half a quantum for at
  least 95% of each bucket, the second stage's within 1e-3 of the first
  stage's quantum;
* the train launcher's ``[train]`` lines: the JAX launcher's fields and
  counts (the losses differ: each package draws its own random init).

deepseek-v3-671b's training settings (a bf16 gradient accumulator and
bf16 moments) are held to JAX in ``tests/test_torch_v3_train.py``; here
its train launcher prints the JAX launcher's ``[train]`` fields.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.optim import adamw_init
from repro_torch.train import ScriptedInjector
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step)

ARCH = "deepseek-v2-lite-16b"
SCRIPT = {1: [0]}          # masked: S_A 1 -> 2
_JAX: dict = {}


def _jax_params():
    """The JAX model's init as fp32 numpy leaves."""
    if not _JAX:
        params = JaxModel(cfg=jax_smoke(ARCH)).init(jax.random.key(0))
        _JAX["p"] = jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), params)
    return _JAX["p"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch():
    state = JaxSpareState(4, 2)
    JaxRectlr().on_failures(state, [1])
    return jax_spare_batch(JaxPipeline(jax_smoke(ARCH), 16, 2, seed=0),
                           state, 0)


def test_bucket_layout_and_checkpoint_names_follow_jax():
    """The gradient buckets over the port's tree equal JAX's layout of
    its own, and the npz-v1 checkpoint names every leaf of a training
    state as JAX does (the MLA leaves among them)."""
    jp = _jax_params()
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
    want = [n for n, _ in jax_names(jstate)]
    assert [n for n, _ in _flatten_with_names((tp, adamw_init(tp)))] == want
    assert "0/segments/0/0/attn/wkv_a" in want
    assert "1/mu/segments/1/0/moe/shared/w_down" in want


def test_stacked_step_loss_and_grads_match_jax():
    """Two microbatches (S_A = 2) of the weighted loss, forward and
    backward, against ``jax.value_and_grad`` in fp32: every gradient,
    MLA's (``wkv_a``, ``kv_norm``, ``wk_b``, ``wv_b``, ``wq``, ``wo``)
    and the MoE layers' among them, within 1e-5 of its largest
    element."""
    jm, tm = JaxModel(cfg=jax_smoke(ARCH)), build_model(smoke_config(ARCH),
                                                        device="cpu")
    jp = jax.tree.map(jnp.asarray, _jax_params())
    tp = params_from_numpy(_jax_params(), "cpu")
    batch = _batch()
    assert batch["weights"].shape[0] == 2
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
        assert _rel(t.numpy(), j) <= 1e-5


def test_mesh_executor_int8_ef_step_matches_jax_on_one_rank(tmp_path):
    """Three int8-EF steps of the MeshExecutor on a one-rank gloo group
    against JAX's on a one-device mesh, group 0 killed at poll 1 (masked:
    S_A 1 -> 2), fp32: the same report, the losses, the updates and the
    EF residuals as the module doc says."""
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
    ef, jef = te._ef_state, je._ef_state
    for a, b in zip(ef["err1"], jef["err1"]):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert (np.abs(a - b) <= 0.5 * 2 * np.abs(b).max()).mean() >= 0.95
    for a, b, e1 in zip(ef["err2"], jef["err2"], jef["err1"]):
        assert np.abs(a.double().numpy() - np.asarray(b, np.float64)).max() \
            <= 1e-3 * 2 * np.abs(np.asarray(e1)).max()


def test_remat_launch_counts_of_mla_blocks(monkeypatch):
    """The card's launch gates per training microbatch, counting the
    remat recompute: K1 2(3L) + 1 (each block's ln1, MLA's kv_norm and
    ln2, twice; the final norm once), no K2 (MLA is plain products) and
    no K4; counted here through the plain versions the CPU runs."""
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
    params = params_from_numpy(_jax_params(), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    make_train_step(tm)(params, adamw_init(params), batch)
    n_micro, n_layers = 2, cfg.n_layers
    assert calls == {"rmsnorm": n_micro * (2 * 3 * n_layers + 1),
                     "flash": 0, "ssd": 0}


ARGS = ["--arch", ARCH, "--steps", "4", "--n-groups", "4", "-r", "2",
        "--seq", "16", "--mtbf-steps", "2"]


def _train_lines(out: str) -> dict:
    """The ``[train]`` lines' fields, but the losses, the seconds and the
    fields only one launcher prints (the mesh plane, the head dim, the
    device)."""
    lines = [ln for ln in out.splitlines() if ln.startswith("[train]")]
    text = "\n".join(ln.split("|")[-1] if " loss " in ln else ln
                     for ln in lines if "done:" not in ln)
    fields = dict(re.findall(r"(\w+)=(\S+)", text))
    for name in ("mesh", "head_dim"):
        fields.pop(name, None)
    done = next(ln for ln in lines if "done:" in ln)
    fields["steps_done"] = re.search(r"done: (\d+) steps", done).group(1)
    return fields


def test_train_cli_lines_match_the_jax_cli(capsys, monkeypatch):
    """The port's train launcher through the int8-EF mesh prints the JAX
    launcher's ``[train]`` fields and counts (arch, N, r, scheme, steps,
    params; steps done, failures, wipeouts, reorders, patches, S_A,
    recovery events, rollback steps); the losses are each package's own
    init's."""
    from repro.launch import train as jax_cli
    monkeypatch.setattr(sys, "argv", ["train", *ARGS])
    jax_cli.main()
    want = _train_lines(capsys.readouterr().out)
    assert train_cli.main(["--device", "cpu", *ARGS, "--mesh",
                           "--grad-compress", "int8_ef"]) == 0
    out = capsys.readouterr().out
    assert "mesh=4x1/shard_map+int8_ef" in out
    got = _train_lines(out)
    assert got == want and int(want["failures"]) > 0


def test_train_cli_refuses_deepseek_v3s_bf16_accumulator(capsys,
                                                         monkeypatch):
    """deepseek-v3-671b's train launcher, which refused its bf16
    gradient accumulator until the port took it, runs its training
    settings (a bf16 accumulator, bf16 moments) through the int8-EF mesh
    and prints the JAX launcher's ``[train]`` fields and counts."""
    from repro.launch import train as jax_cli
    args = ["--arch", "deepseek-v3-671b", *ARGS[2:]]
    monkeypatch.setattr(sys, "argv", ["train", *args])
    jax_cli.main()
    want = _train_lines(capsys.readouterr().out)
    assert train_cli.main(["--device", "cpu", *args, "--mesh",
                           "--grad-compress", "int8_ef"]) == 0
    got = _train_lines(capsys.readouterr().out)
    assert got == want and int(want["failures"]) > 0
