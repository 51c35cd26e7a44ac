"""The ``"dots"`` remat policy (``repro_torch.models.remat``) against the
port's ``"nothing"`` and ``"none"`` and against the JAX package's
``"dots"`` (``dots_with_no_batch_dims_saveable``), on the CPU, for one
smoke config of every family: dense GQA (qwen2.5-3b), SSM (mamba2-1.3b),
a two-matrix gelu MLP (starcoder2-7b), the hybrid with MoE
(jamba-v0.1-52b) and MLA with MoE (deepseek-v2-lite-16b).

The same fp32 parameters (the JAX model's init, carried over by
``params_from_numpy``) and tokens (seeded numpy) go through both
packages: the mean next-token cross-entropy of one batch, forward and
backward.

Tolerances. A policy decides what is kept and what is recomputed, and
changes no value: the port's gradients under ``"dots"`` are bit-identical
to its gradients under ``"nothing"`` and ``"none"``. Against JAX's
``"dots"`` gradients each leaf within 1e-5 of its largest element (fp32
summation order), as ``tests/test_torch_families_train.py`` holds fp32.
What the policy keeps is read through ``saved_tensors_hooks`` (every
tensor autograd saves but the parameters): fewer bytes under ``"nothing"``
than under ``"dots"``, fewer under ``"dots"`` than under ``"none"``;
under ``"dots"`` the projections' outputs are among them and no
attention score is. The activations run on one thread, as in
``tests/test_torch_families.py``: the CPU torch's first multi-threaded
fp32 ``tanh`` may come back less accurate in one thread's chunk.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import build_model as jax_build
from repro_torch.configs import smoke_config
from repro_torch.dist import tree_leaves
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import cross_entropy

ARCHS = ["qwen2.5-3b", "mamba2-1.3b", "starcoder2-7b", "jamba-v0.1-52b",
         "deepseek-v2-lite-16b"]
POLICIES = ("nothing", "dots", "none")
TOKENS = (2, 32)
TOL = 1e-5
_RUNS: dict = {}


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _tokens(vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(
        0, vocab, size=(TOKENS[0], TOKENS[1] + 1))


def _port(arch: str, policy: str, numpy_params) -> dict:
    """The port's loss gradient under ``policy`` and what autograd saved
    for the backward (every tensor but the parameters)."""
    cfg = smoke_config(arch).scaled(remat_policy=policy)
    model = build_model(cfg, device="cpu")
    params = params_from_numpy(numpy_params, "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    tokens = torch.from_numpy(_tokens(cfg.vocab))
    saved = []

    def pack(t):
        if not any(t is p for p in leaves):
            saved.append(t)
        return t

    with _one_thread():
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            logits = model.forward(params, tokens=tokens[:, :-1])
            loss = cross_entropy(logits, tokens[:, 1:])
        loss.backward()
    return {"grads": [t.grad for t in leaves],
            "saved_bytes": sum(t.numel() * t.element_size() for t in saved),
            "saved_shapes": [tuple(t.shape) for t in saved]}


def _jax(arch: str, numpy_params) -> list:
    """JAX's loss gradient under ``"dots"``."""
    cfg = jax_smoke(arch).scaled(remat_policy="dots")
    model = jax_build(cfg)
    tokens = jnp.asarray(_tokens(cfg.vocab))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    grads = jax.jit(jax.grad(lambda p: model.loss(p, batch)))(
        jax.tree.map(jnp.asarray, numpy_params))
    return [np.asarray(g) for g in jax.tree.leaves(grads)]


def _runs(arch: str) -> dict:
    if arch not in _RUNS:
        params = jax_build(jax_smoke(arch)).init(jax.random.key(0))
        numpy_params = jax.tree.map(
            lambda a: np.asarray(a.astype(jnp.float32)), params)
        _RUNS[arch] = {"port": {p: _port(arch, p, numpy_params)
                                for p in POLICIES},
                       "jax": _jax(arch, numpy_params)}
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_are_nothings_and_nones_bit_for_bit(arch):
    port = _runs(arch)["port"]
    dots = port["dots"]["grads"]
    assert all(g is not None for g in dots)
    for other in ("nothing", "none"):
        for a, b in zip(dots, port[other]["grads"]):
            assert torch.equal(a, b), other


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_match_jax(arch):
    run = _runs(arch)
    ours, theirs = run["port"]["dots"]["grads"], run["jax"]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a = a.double().numpy()
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= TOL * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_keeps_the_projections_and_no_score(arch):
    """``"nothing"`` keeps less than ``"dots"``, which keeps less than
    ``"none"``; ``"dots"`` keeps every block's input projection and
    no (B, H, Sq, Sk) score, which ``"none"`` keeps where the family
    attends."""
    port = _runs(arch)["port"]
    got = {p: port[p]["saved_bytes"] for p in POLICIES}
    assert got["nothing"] < got["dots"] < got["none"], got
    cfg = smoke_config(arch)
    rows = TOKENS[0] * TOKENS[1]
    if cfg.family == "ssm":
        proj = (rows, cfg.ssm.expand * cfg.d_model)         # wz, wx
    elif cfg.attn_kind == "mla":
        proj = (rows, cfg.kv_lora_rank + cfg.mla_d_rope)    # wkv_a
    else:
        proj = (rows, cfg.n_heads * cfg.resolved_head_dim)  # wq
    # (the head's input may share the shape)
    assert port["dots"]["saved_shapes"].count(proj) >= \
        port["nothing"]["saved_shapes"].count(proj) + cfg.n_layers

    def scores(shapes):
        return [s for s in shapes if len(s) == 4 and s[0] == TOKENS[0]
                and s[-1] == TOKENS[1] and s[1] == cfg.n_heads]
    assert not scores(port["dots"]["saved_shapes"])
    if cfg.family != "ssm":
        assert scores(port["none"]["saved_shapes"])
