"""Training the two-matrix MLP configs and the ``embeds=`` frontends in
the port against the JAX package, on the CPU, at the smoke sizes.

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same batches (the same Philox counters:
tokens, or float32 ``embeds`` for qwen2-vl-2b and musicgen-medium) go
through both packages.

Tolerances. The token configs run in fp32, with
``tests/test_torch_train.py``'s: losses and gradients within 1e-5
relative. The JAX model cannot run ``embeds`` with fp32 weights (its
layer scan carries bf16 and the first block returns fp32), so the
frontends run in bf16, as their users run them: losses within 1e-3
relative and each gradient leaf within 4e-2 of its largest element,
about ten bf16 roundoffs (2^-8 each), since JAX's plain attention rounds
scores and probabilities to bf16 where the port keeps fp32. A leaf's
update over three steps, ``p - p0``, within 1e-2 of JAX's in the L2 norm
in fp32 and within 0.3 in bf16: AdamW's first steps move an element by
about +-lr, so an element whose gradient is near zero and of the other
sign in the other package moves the other way (measured on these
configs: at most 3.2e-3 in fp32 and 0.18 in bf16; an update left out
gives 1, one of the wrong sign 2).
"""
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
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.step import weighted_loss as jax_weighted_loss
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

ARCHS = ["starcoder2-7b", "minitron-4b", "qwen2-vl-2b", "musicgen-medium",
         "glm4-9b"]
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 4e-2}
UPDATE_TOL = {"float32": 1e-2, "bfloat16": 0.3}
SCRIPT = {1: [0]}          # masked: S_A 1 -> 2
_JAX: dict = {}


def _dtype(arch: str) -> str:
    return "bfloat16" if smoke_config(arch).frontend else "float32"


def _jax_params(arch: str):
    """The JAX model's init for ``arch`` as numpy leaves, in the dtype
    the arch is compared in."""
    if arch not in _JAX:
        params = jax_build(jax_smoke(arch)).init(jax.random.key(0))
        if _dtype(arch) == "float32":
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        _JAX[arch] = jax.tree.map(np.asarray, params)
    return _JAX[arch]


def _batch(arch: str, fail=(1,)):
    state = JaxSpareState(4, 2)
    JaxRectlr().on_failures(state, list(fail))
    return jax_spare_batch(JaxPipeline(jax_smoke(arch), 16, 2, seed=0),
                           state, 0)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_step_loss_and_grads_match_jax(arch):
    """Two microbatches (S_A = 2) of the weighted loss, forward and
    backward, against ``jax.value_and_grad``. A frontend batch carries
    float32 ``embeds`` and no ``tokens``; musicgen-medium's untied
    embedding table is then never read, and its gradient is JAX's zero:
    the accumulator slice no hook ever writes."""
    dtype = _dtype(arch)
    jm = jax_build(jax_smoke(arch))
    tm = build_model(smoke_config(arch), device="cpu")
    jp = jax.tree.map(jnp.asarray, _jax_params(arch))
    tp = params_from_numpy(_jax_params(arch), "cpu")
    batch = _batch(arch)
    frontend = smoke_config(arch).frontend is not None
    assert ("embeds" in batch, "tokens" in batch) == (frontend, not frontend)
    assert batch["weights"].shape[0] == 2

    def total(p, b):
        return sum(jax_weighted_loss(jm, p, {k: v[j] for k, v in b.items()})
                   for j in range(b["weights"].shape[0]))
    jloss, jgrads = jax.jit(jax.value_and_grad(total))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    layout = bucket_layout(accumulator_specs(tp))
    grads = unflatten_grads(layout, layout.zeros("cpu"))
    loss = accumulate_grads(tm, tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, grads)
    assert abs(float(loss) - float(jloss)) <= \
        LOSS_TOL[dtype] * abs(float(jloss))
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl)
    for t, j in zip(tl, jl):
        if not np.asarray(j).any():
            assert not t.any()
            continue
        assert _rel(t.numpy(), j) <= GRAD_TOL[dtype]
    if arch == "musicgen-medium":
        assert not np.asarray(jgrads["embed"]).any()
        assert not grads["embed"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_executor_int8_ef_step_matches_jax_on_one_rank(arch, tmp_path):
    """Three int8-EF steps of the MeshExecutor on a one-rank gloo group
    against JAX's on a one-device mesh, group 0 killed at poll 1 (masked:
    S_A 1 -> 2): the same report, every step's loss, each leaf's update
    ``p - p0`` and the EF residuals. ``base_lr`` 0.1 (lr 1e-3 to 3e-3 over
    the warmup's first steps) moves every weight by many of its ulps, bf16
    ones included, so an update that was not applied, or applied wrong,
    shows in ``p - p0``. musicgen-medium's embedding table gets no
    gradient in either package (zero first moments), and AdamW's decay of
    it (``ndim > 1``) gives the same table in both."""
    init_data_group("cpu", store_path=str(tmp_path / "store"))
    dtype = _dtype(arch)
    common = dict(n_groups=4, redundancy=2, seq=16, per_type_batch=1,
                  total_steps=50, grad_compress="int8_ef", bucket_mb=0.01,
                  base_lr=0.1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    je = JaxMeshExecutor(jax_smoke(arch), mesh=mesh, **common)
    je.params = jax.device_put(jax.tree.map(jnp.asarray, _jax_params(arch)),
                               je._pshard)
    je.opt_state = jax.device_put(jax_adamw_init(je.params), je._oshard)
    te = MeshExecutor(smoke_config(arch), device="cpu", **common)
    te.params = params_from_numpy(_jax_params(arch), "cpu")
    te.opt_state = adamw_init(te.params)
    assert te._layout.bucket_sizes == je._layout.bucket_sizes
    want = je.run(3, injector=JaxScripted(SCRIPT))
    got = te.run(3, injector=ScriptedInjector(SCRIPT))
    assert (got.steps_done, got.failures, got.wipeouts) == \
        (want.steps_done, want.failures, want.wipeouts) == (3, 1, 0)
    assert [(e.victims, e.s_a_after) for e in got.events] == \
        [(e.victims, e.s_a_after) for e in want.events]
    assert len(got.losses) == len(want.losses) == 3
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= LOSS_TOL[dtype] * abs(b)
    p0 = jax.tree.leaves(_jax_params(arch))
    for t, j, q in zip(tree_leaves(te.params), jax.tree.leaves(je.params),
                       p0):
        assert t.dtype == getattr(torch, str(np.asarray(j).dtype))
        q = np.asarray(q, np.float64)
        dt = t.double().numpy() - q
        dj = np.asarray(j, np.float64) - q
        if not dj.any():       # musicgen's embedding, in bf16
            assert not dt.any()
            continue
        assert np.linalg.norm(dt - dj) <= \
            UPDATE_TOL[dtype] * np.linalg.norm(dj)
    # the first stage's residuals: in fp32 at least 98% of the elements
    # within 1e-2 of the bucket's quantum of JAX's (gradients within 1e-5
    # of their largest element put a residual ~1.3e-3 of a quantum off,
    # and a value at a .5 boundary rounds the other way: one element of
    # a 64-element bucket in glm4-9b); in bf16, where the gradients
    # differ by several quanta, the largest residual (half the bucket's
    # quantum) within 10% of JAX's.
    # A bucket that never gets a gradient (musicgen-medium's embedding)
    # keeps zero residuals in both. The second stage (the sum's
    # re-quantisation, exact on one rank) within 1e-3 of the first
    # stage's quantum of JAX's
    ef, jef = te._ef_state, je._ef_state
    for a, b in zip(ef["err1"], jef["err1"]):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        quantum = 2 * np.abs(b).max()
        if not quantum:
            assert not a.any()
        elif dtype == "float32":
            assert (np.abs(a - b) <= 1e-2 * quantum).mean() >= 0.98
        else:
            assert abs(np.abs(a).max() / np.abs(b).max() - 1) <= 0.1
    for a, b, e1 in zip(ef["err2"], jef["err2"], jef["err1"]):
        assert np.abs(a.double().numpy() - np.asarray(b, np.float64)).max() \
            <= 1e-3 * 2 * np.abs(np.asarray(e1)).max()
    if arch == "musicgen-medium":
        assert not te.opt_state.mu["embed"].any()
        assert not np.asarray(je.opt_state.mu["embed"]).any()


@pytest.mark.parametrize("arch", ["starcoder2-7b", "musicgen-medium"])
def test_remat_launch_counts_hold_for_the_two_matrix_mlp(arch,
                                                         monkeypatch):
    """The card's launch gates (K1 4L + 1 and K2 2L per microbatch,
    counting the recompute) hold with a gelu MLP and with ``embeds``:
    counted here through the plain versions the CPU runs."""
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
    cfg = smoke_config(arch).scaled(grad_accum=1)
    tm = build_model(cfg, device="cpu")
    params = params_from_numpy(_jax_params(arch), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    make_train_step(tm)(params, adamw_init(params), batch)
    n_micro, L = 2, cfg.n_layers
    assert calls == {"rmsnorm": n_micro * (4 * L + 1),
                     "flash": n_micro * 2 * L}


def test_train_cli_runs_musicgen_through_the_int8_ef_mesh(capsys):
    assert train_cli.main(["--device", "cpu", "--arch", "musicgen-medium",
                           "--steps", "4", "--n-groups", "4", "-r", "2",
                           "--seq", "16", "--mtbf-steps", "2", "--mesh",
                           "--grad-compress", "int8_ef"]) == 0
    out = capsys.readouterr().out
    assert "arch=musicgen-medium" in out
    assert "[train] done:" in out and "mesh=4x1/shard_map+int8_ef" in out
