"""SSM (Mamba-2) training in the port against the JAX package, on the CPU.

The JAX package has no backward kernel for the SSD scan: it differentiates
its plain ``ssd_chunked``. The port's card path runs K4-bwd, whose spec is
``ssd_scan_bwd_ref``; here that spec is held to ``jax.vjp`` of
``ssd_chunked`` and to torch's autograd of the port's plain forward, and
the smoke mamba2 model trains as the JAX package trains it. The same
inputs (numpy from a seed) and parameters (``params_from_numpy``) go
through both packages.

Tolerances: the backward's gradients within 1e-5 of each tensor's
largest |ref| (fp32 in another summation order; the port sums ``cum`` in
fp64 where JAX sums it in fp32; measured ~1e-6); the training path's
losses and gradients within 1e-5 relative, params within 1e-5 absolute
(magnitude ~0.1), as the dense family's tests hold them; report fields
identical.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _groups import data_group  # noqa: F401 (a fixture)
from repro.configs import smoke_config as jax_smoke
from repro.core import Rectlr as JaxRectlr
from repro.core import SpareState as JaxSpareState
from repro.data import ShardedTokenPipeline as JaxPipeline
from repro.data import spare_batch as jax_spare_batch
from repro.exec import MeshExecutor as JaxMeshExecutor
from repro.models import build_model as jax_build
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.optim import adamw_init as jax_adamw_init
from repro.train.injection import ScriptedInjector as JaxScripted
from repro.train.step import make_train_step as jax_make_train_step
from repro.train.step import weighted_loss as jax_weighted_loss
from repro_torch.configs import smoke_config
from repro_torch.dist import bucket_layout, tree_leaves, unflatten_grads
from repro_torch.exec import MeshExecutor
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, params_from_numpy
from repro_torch.optim import adamw_init
from repro_torch.train import ScriptedInjector
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step, weighted_loss)

ARCH = "mamba2-1.3b"
TINY = dict(grad_accum=1)
SEQ = 96                      # three chunks of the smoke config's 32
TOL = 1e-5
GRADS = ("dx", "ddt", "da_log", "db", "dc")
REPORT = ("failures", "wipeouts", "reorders", "patches", "recompiles",
          "steps_done", "rollback_steps")
SCRIPT = {1: [0], 3: [1, 3]}          # masked (S_A 1 -> 2), then wipe-out
_JAX: dict = {}


def _rel(got, want) -> float:
    """Largest error over the largest |want|."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ------------------------------------------------------------------ #
# the backward's spec against jax.vjp and autograd                   #
# ------------------------------------------------------------------ #
#: B, H, G, S, P, N, chunk: three chunks of 24 (not a power of two), G < H
SHAPE = (2, 4, 2, 72, 8, 16, 24)


def _bwd_inputs(seed: int = 0):
    """x, dt (as softplus makes it), a_log = log(1..H) (as the init makes
    it), b, c, dy and d_final, numpy fp32, in the port's layouts."""
    bs, h, g, s, p, n, _ = SHAPE
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(rng.normal(-2.5, 0.5, (bs, h, s)), 0.0)
    return (rng.normal(size=(bs, h, s, p)).astype(np.float32),
            dt.astype(np.float32),
            np.log(np.arange(1, h + 1)).astype(np.float32),
            rng.normal(size=(bs, g, s, n)).astype(np.float32),
            rng.normal(size=(bs, g, s, n)).astype(np.float32),
            rng.normal(size=(bs, h, s, p)).astype(np.float32),
            rng.normal(size=(bs, h, p, n)).astype(np.float32))


def _port_bwd(x, dt, a_log, b, c, dy, d_final):
    t = [torch.from_numpy(v) for v in (x, dt, a_log, b, c, dy)]
    df = None if d_final is None else torch.from_numpy(d_final)
    return [g.numpy() for g in ssd_scan_bwd_ref(*t, df, SHAPE[-1])]


def _jax_bwd(x, dt, a_log, b, c, dy, d_final):
    """``jax.vjp`` of the JAX package's ``ssd_chunked``: B and C broadcast
    to the heads as ``mamba_forward`` does (their gradients summed back
    over each group's heads), d_final as the final state's cotangent."""
    bs, h, g, s, p, n, chunk = SHAPE
    rep = h // g

    def f(x_, dt_, a_, b_, c_):
        y, final = jax_ssd_chunked(
            x_.transpose(0, 2, 1, 3), dt_.transpose(0, 2, 1), a_,
            jnp.repeat(b_, rep, 1).transpose(0, 2, 1, 3),
            jnp.repeat(c_, rep, 1).transpose(0, 2, 1, 3), chunk)
        return y.transpose(0, 2, 1, 3), final

    _, vjp = jax.vjp(f, *(jnp.asarray(v) for v in (x, dt, a_log, b, c)))
    return [np.asarray(v) for v in vjp((jnp.asarray(dy),
                                         jnp.asarray(d_final)))]


def _autograd_bwd(x, dt, a_log, b, c, dy, d_final):
    leaves = [torch.from_numpy(v).requires_grad_()
              for v in (x, dt, a_log, b, c)]
    y, final = ssd_scan_ref(leaves[0], leaves[1], -torch.exp(leaves[2]),
                            leaves[3], leaves[4], SHAPE[-1])
    outs, grads = [y], [torch.from_numpy(dy)]
    if d_final is not None:
        outs.append(final)
        grads.append(torch.from_numpy(d_final))
    return [g.numpy() for g in torch.autograd.grad(outs, leaves, grads)]


def test_ssd_bwd_ref_matches_jax_vjp_and_autograd():
    """Every gradient of the spec within 1e-5 of the largest |ref|: against
    JAX's ``jax.vjp`` of ``ssd_chunked`` (three chunks, G < H, chunk 24, a
    non-zero d_final) and against torch's autograd of ``ssd_scan_ref``."""
    args = _bwd_inputs()
    got = _port_bwd(*args)
    for want in (_jax_bwd(*args), _autograd_bwd(*args)):
        errs = {k: _rel(a, b) for k, a, b in zip(GRADS, got, want)}
        assert max(errs.values()) <= TOL, errs


def _missed(full, part) -> float:
    """What a backward that drops a term would be off by, over the
    tolerance's scale: the largest |part| over 1e-5 of max|full|."""
    return float(np.abs(part).max() / (TOL * np.abs(full).max()))


@pytest.mark.parametrize("term", ["carry", "d_final", "dcum", "groups"])
def test_each_term_of_the_bwd_moves_a_gradient_past_the_gate(term,
                                                             monkeypatch):
    """On the gate's inputs, dropping any one term of the backward changes
    some gradient by more than 100x the tolerance, so a kernel that drops
    it cannot pass: the dS carried from chunk to chunk, d_final, the path
    from ``dcum`` to ddt and da_log, and the sum over each group's heads.
    Each dropped term's share is computed exactly: the gradients are
    linear in (dy, d_final), the decays' path is autograd's with ``cum``
    detached, and the group sum is the per-head partials' sum."""
    x, dt, a_log, b, c, dy, d_final = args = _bwd_inputs()
    full = _port_bwd(*args)
    q = SHAPE[-1]
    if term == "carry":
        # the chunk-0 gradients that come from later chunks' dy and from
        # d_final: all of it reaches chunk 0 through the carried dS
        later = dy.copy()
        later[:, :, :q] = 0
        part = _port_bwd(x, dt, a_log, b, c, later, d_final)
        worst = max(_missed(f, p[..., :q, :] if p.ndim == 4 else p[..., :q])
                    for f, p in zip(full, part) if p.ndim >= 3)
    elif term == "d_final":
        part = _port_bwd(x, dt, a_log, b, c, np.zeros_like(dy), d_final)
        worst = max(_missed(f, p) for f, p in zip(full, part))
    elif term == "dcum":
        # cum without its gradient: only the direct terms reach dt
        double = torch.Tensor.double
        monkeypatch.setattr(torch.Tensor, "double",
                            lambda t: double(t.detach()))
        leaves = [torch.from_numpy(v).requires_grad_()
                  for v in (x, dt, a_log)]
        y, fin = ssd_scan_ref(leaves[0], leaves[1], -torch.exp(leaves[2]),
                              torch.from_numpy(b), torch.from_numpy(c), q)
        ddt_direct = torch.autograd.grad(
            [y, fin], leaves[1], [torch.from_numpy(dy),
                                  torch.from_numpy(d_final)])[0].numpy()
        worst = min(_missed(full[1], full[1] - ddt_direct),
                    _missed(full[2], full[2]))
    else:
        # G = H inputs give each head's own db, dc; dropping the sum keeps
        # only the group's first head
        rep = SHAPE[1] // SHAPE[2]
        per_head = _port_bwd(x, dt, a_log, np.repeat(b, rep, 1),
                             np.repeat(c, rep, 1), dy, d_final)
        for f, p in zip(full[3:], per_head[3:]):
            np.testing.assert_allclose(
                p.reshape(*f.shape[:1], -1, rep, *f.shape[2:]).sum(2), f,
                atol=TOL * np.abs(f).max(), rtol=0)
        worst = max(_missed(f, f - p[:, ::rep])
                    for f, p in zip(full[3:], per_head[3:]))
    assert worst > 100, (term, worst)


def _rounding_tool():
    """``tools/ssd_bwd_rounding.py``, the bf16 route's float64 emulation."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / \
        "ssd_bwd_rounding.py"
    spec = importlib.util.spec_from_file_location("ssd_bwd_rounding", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [
    dict(B=1, H=4, G=2, S=96, P=16, N=32, Q=32),
    dict(B=2, H=16, G=1, S=64, P=8, N=16, Q=32),
    dict(B=1, H=4, G=2, S=144, P=32, N=32, Q=48),
], ids=["groups", "cli-smoke", "chunk-48"])
def test_bf16_route_roundings_stay_inside_the_gates(shape):
    """K4-bwd's bf16 route feeds seven fp32 operands to the tensor cores
    as bf16 parts (``KERNEL_PARTS``). The float64 emulation of the
    backward with exactly those roundings keeps every gradient within a
    tenth of its card gate of the unrounded backward (dx, db, dc: one
    bf16 ulp of the row's largest |ref|; ddt, da_log: 1e-5 of the largest
    |ref|), which leaves the gate to the fp32 summation order; and with
    S_prev in two parts instead of three, da_log at the narrow widths
    moves past a tenth of its gate, which is why it takes three. The
    emulation without roundings is the spec (``ssd_scan_bwd_ref``) on the
    same float64 inputs, but for ``cum``, which it rounds to fp32 as the
    kernel does."""
    tool = _rounding_tool()
    shape = dict(shape)
    q = shape.pop("Q")
    args = tool.inputs(**shape)
    ref = tool.emulate(*args, q)
    spec = ssd_scan_bwd_ref(*args, q)
    for name, a, b in zip(GRADS, ref, spec):
        assert _rel(a.numpy(), b.numpy()) <= TOL, name
    got = tool.units(tool.emulate(*args, q, tool.KERNEL_PARTS), ref)
    assert max(got.values()) <= 0.1, got
    if shape["N"] == 32 and q == 32:
        two = tool.units(tool.emulate(*args, q, dict(tool.KERNEL_PARTS,
                                                     S_prev=2)), ref)
        assert two["da_log"] > 0.1, two


def test_bwd_route_workspaces_and_heads_per_block():
    """The bf16 route's blocks walk 4 or 2 heads of a group while a block
    remains for every SM (the training microbatch: 2 chunks x 64 heads x
    8 examples, 1,024 (chunk, head) units, 4 heads a block), 1 otherwise and
    always in fp32; the workspaces hold one db and dc partial per block's
    heads; the bf16 route keeps the states as bf16 part tiles and adds r
    and dcum's parts per position."""
    from repro_torch.kernels.ssd_scan import (BWD_MIN_BLOCKS,
                                              bwd_heads_per_block,
                                              bwd_workspace)
    bf16, fp32 = torch.bfloat16, torch.float32
    assert bwd_heads_per_block(bf16, 8, 64, 1, 512, 256) == 4
    assert bwd_heads_per_block(bf16, 4, 64, 1, 512, 256) == 2
    assert bwd_heads_per_block(fp32, 16, 64, 1, 512, 256) == 1
    assert bwd_heads_per_block(bf16, 2, 8, 2, 256, 128) == 1
    # H / G = 2 heads a group: never 4
    assert bwd_heads_per_block(bf16, 64, 64, 32, 512, 256) == 2
    assert BWD_MIN_BLOCKS == 132
    b, h, s, q, p, n = 8, 64, 512, 256, 64, 128
    units = b * h * (s // q)
    assert bwd_workspace(fp32, b, h, s, q, p, n, 1) == (
        2 * units * p * n + 2 * b * h * s * n, units)
    # bf16: three bf16 part tiles of 64 x 128 per state and chunk
    assert bwd_workspace(bf16, b, h, s, q, p, n, 2) == (
        2 * units * 3 * 64 * 128 // 2 + 2 * b * (h // 2) * s * n + b * h * s,
        units + b * h * s)
    assert bwd_workspace(bf16, 2, 8, 96, 32, 8, 16, 1)[0] == \
        2 * 2 * 8 * 3 * (3 * 64 * 64 // 2) + 2 * 2 * 8 * 96 * 16 + 2 * 8 * 96


def test_a_cpu_call_with_a_gradient_is_autograd_of_the_plain_version():
    """On CPU tensors ``ops.ssd_scan`` records autograd of its plain
    version (no kernel, no launch): the gradients equal autograd of
    ``ssd_scan_ref`` bit for bit."""
    x, dt, a_log, b, c, dy, d_final = _bwd_inputs(1)
    leaves = [torch.from_numpy(v).requires_grad_()
              for v in (x, dt, a_log, b, c)]
    ops.reset_launches()
    y, fin = ops.ssd_scan(*leaves, chunk=SHAPE[-1])
    assert "SSDScan" not in type(y.grad_fn).__name__
    got = torch.autograd.grad([y, fin], leaves, [torch.from_numpy(dy),
                                                 torch.from_numpy(d_final)])
    want = _autograd_bwd(x, dt, a_log, b, c, dy, d_final)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert not any(ops.launches.values())


# ------------------------------------------------------------------ #
# the smoke mamba2 model's training against the JAX package          #
# ------------------------------------------------------------------ #
def _jax_params():
    """fp32 parameters drawn by the port's init, as numpy leaves in the
    JAX package's tree (both packages' trees share the structure)."""
    if not _JAX:
        model = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
        _JAX["params"] = jax.tree.map(lambda t: t.float().numpy(),
                                      model.init(0))
    return _JAX["params"]


def _batch(seq=SEQ, n=4, r=2, step=0, fail=()):
    state = JaxSpareState(n, r)
    if fail:
        JaxRectlr().on_failures(state, list(fail))
    return jax_spare_batch(JaxPipeline(jax_smoke(ARCH).scaled(**TINY), seq,
                                       1, seed=0), state, step)


def _models():
    jm = jax_build(jax_smoke(ARCH).scaled(**TINY))
    tm = build_model(smoke_config(ARCH).scaled(**TINY), device="cpu")
    return (jm, jax.tree.map(jnp.asarray, _jax_params()), tm,
            params_from_numpy(_jax_params(), "cpu"))


def test_mamba_weighted_loss_grads_reach_every_leaf_as_in_jax():
    """The stacked weighted loss's gradients through the accumulator, leaf
    for leaf against ``jax.grad`` (S_A 2, three chunks), and every Mamba
    leaf gets one."""
    jm, jp, tm, tp = _models()
    batch = _batch(fail=[1])              # S_A = 2: two microbatches
    assert batch["weights"].shape[0] == 2

    def total(p, b):
        return sum(jax_weighted_loss(jm, p, {k: v[j] for k, v in b.items()})
                   for j in range(b["weights"].shape[0]))
    jgrads = jax.jit(jax.grad(total))(jp, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    layout = bucket_layout(accumulator_specs(tp))
    grads = unflatten_grads(layout, layout.zeros("cpu"))
    accumulate_grads(tm, tp, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, grads)
    mamba = grads["segments"][0][0]["mamba"]
    assert sorted(mamba) == sorted(
        ["wz", "wx", "wb", "wc", "wdt", "conv_w", "conv_b", "dt_bias",
         "a_log", "d_skip", "gate_norm", "out_proj"])
    assert all(bool(g.abs().max() > 0) for g in mamba.values())
    jl, tl = jax.tree.leaves(jgrads), tree_leaves(grads)
    assert len(jl) == len(tl) == 15
    errs = [_rel(t.numpy(), j) for t, j in zip(tl, jl)]
    assert max(errs) <= TOL, errs
    micro = {k: v[0] for k, v in batch.items()}
    want = jax.jit(partial(jax_weighted_loss, jm))(
        jp, {k: jnp.asarray(v) for k, v in micro.items()})
    got = weighted_loss(tm, tp, {k: torch.from_numpy(v)
                                 for k, v in micro.items()})
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))


def test_mamba_train_step_matches_jax_over_three_steps():
    """Three ``make_train_step`` steps (accumulator, AdamW, which decays
    the stacked (n_rep, d) leaves as the JAX package does) from the same
    params: losses within 1e-5 relative, params within 1e-5."""
    jm, jp, tm, tp = _models()
    jstep, tstep = jax.jit(jax_make_train_step(jm)), make_train_step(tm)
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    batch = _batch(fail=[1])
    for _ in range(3):
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tp, to, tmet = tstep(tp, to, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) \
            <= TOL * float(jmet["loss"])
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=0)


def test_mamba_remat_launch_counts_per_microbatch(monkeypatch):
    """The counts the card's gates derive for mamba2 training hold for the
    code (counted through the plain versions the CPU runs): per
    microbatch, the scan 2L times (the forward and the remat recompute)
    and RMSNorm 4L + 1 (two norms a block, twice, and the final norm)."""
    calls = {"rmsnorm": 0, "ssd": 0}
    rms, ssd = ops.rmsnorm_ref, ops.ssd_scan_ref

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, "rmsnorm_ref", count("rmsnorm", rms))
    monkeypatch.setattr(ops, "ssd_scan_ref", count("ssd", ssd))
    _, _, tm, tp = _models()
    batch = {k: torch.from_numpy(v) for k, v in _batch(fail=[1]).items()}
    make_train_step(tm)(tp, adamw_init(tp), batch)
    n_micro, L = 2, tm.cfg.n_layers
    assert calls == {"rmsnorm": n_micro * (4 * L + 1), "ssd": n_micro * 2 * L}


def test_mamba_mesh_executor_int8_ef_matches_jax_on_one_rank(
        data_group):
    """The port's MeshExecutor (a ``SpareTrainer``) on a one-rank gloo
    group against JAX's on a one-device mesh, int8 EF, mamba2 at seq 64
    (two chunks): the same report through a mask and a wipe-out."""
    common = dict(n_groups=4, redundancy=2, seq=64, per_type_batch=1,
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
    want = je.run(5, injector=JaxScripted(SCRIPT))
    got = te.run(5, injector=ScriptedInjector(SCRIPT))
    assert want.wipeouts == 1 and want.rollback_steps == 3
    for f in REPORT:
        assert getattr(got, f) == getattr(want, f), f
    assert [(e.victims, e.wipeout, e.s_a_after, e.rollback_depth)
            for e in got.events] == [(e.victims, e.wipeout, e.s_a_after,
                                      e.rollback_depth) for e in want.events]
    for a, b in zip(got.losses, want.losses):
        assert abs(a - b) <= TOL * abs(b)
    assert got.losses[3] == got.losses[0]


def test_train_cli_trains_mamba_on_the_cpu(capsys):
    assert train_cli.main(["--arch", ARCH, "--device", "cpu", "--steps",
                           "4", "--n-groups", "6", "-r", "2",
                           "--mtbf-steps", "2", "--mesh", "--grad-compress",
                           "int8_ef"]) == 0
    out = capsys.readouterr().out
    assert "[train] done: 4 steps" in out and "+int8_ef" in out
