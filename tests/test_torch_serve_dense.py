"""The serving builders' default spellings against the JAX package's, on
the CPU: ``make_prefill(model)`` (last-position logits of the training
forward) and ``make_serve_step(model)`` (the one-token step over dense
caches at a scalar position), for the dense GQA family and the SSM
family, and the dense ``gqa_decode`` alone.

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same numpy inputs go through both
packages, in fp32, within ``LOGIT_TOL`` (1e-4: summation order through
two layers and the tied head). Both sides decode over fp32 caches: the
JAX attention decode writes its new k and v with
``dynamic_update_slice``, which takes only the cache's own dtype, and
its Mamba decode promotes a bf16 conv window to fp32 in an fp32 run,
where the port keeps the cache's dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models.model import build_model as jax_build
from repro.train.step import make_prefill as jax_make_prefill
from repro.train.step import make_serve_step as jax_make_serve_step
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, cast_params, params_from_numpy
from repro_torch.train import make_prefill, make_serve_step

ARCHS = ["qwen2.5-3b", "mamba2-1.3b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
_JAX: dict = {}


def _both(arch: str):
    """(jax model, jax params, port model, port params), fp32."""
    if arch not in _JAX:
        model = jax_build(jax_smoke(arch))
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              model.init(jax.random.key(0)))
        _JAX[arch] = (model, params)
    jm, jp = _JAX[arch]
    tm = build_model(smoke_config(arch), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _leaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda t: isinstance(t, torch.Tensor))


def _jax_fill(big, small):
    """A dense cache leaf with its first ``S`` positions (axis 2, after
    the layer and batch axes) from the prefill's leaf; a leaf of the
    prefill's own shape (a Mamba cache) is taken whole."""
    small = small.astype(big.dtype)
    if big.shape == small.shape:
        return small
    return big.at[:, :, :small.shape[2]].set(small)


@pytest.mark.parametrize("pos", [0, 7])
def test_gqa_decode_matches_jax(pos):
    """Layer 0 of the smoke qwen model: a random fp32 cache, then one
    token at a scalar position (int for JAX, 0-d tensor for the port)."""
    jm, jp, tm, tp = _both("qwen2.5-3b")
    cfg_j, cfg_t = jm.cfg, tm.cfg
    pj = jax.tree.map(lambda a: a[0], jp["segments"][0][0]["attn"])
    pt = {k: v[0] for k, v in tp["segments"][0][0]["attn"].items()}
    rng = np.random.default_rng(pos)
    b, s_max = 2, 9
    shape = (b, s_max, cfg_t.n_kv_heads, cfg_t.resolved_head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((b, 1, cfg_t.d_model)).astype(np.float32)
    jy, jc = jattn.gqa_decode(jnp.asarray(x), pj, cfg_j,
                              jattn.KVCache(jnp.asarray(k0),
                                            jnp.asarray(v0)),
                              jnp.int32(pos))
    cache = tattn.KVCache(torch.from_numpy(k0.copy()),
                          torch.from_numpy(v0.copy()))
    ty, tc = tattn.gqa_decode(torch.from_numpy(x), pt, cfg_t, cache,
                              torch.tensor(pos))
    assert tc.k is cache.k and tc.v is cache.v       # written in place
    assert tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(_f32(ty), _f32(jy), **LOGIT_TOL)
    for a, t in zip(jc, tc):
        np.testing.assert_allclose(_f32(t), _f32(a), **LOGIT_TOL)
    # only position ``pos`` of the cache changed
    keep = np.arange(s_max) != pos
    np.testing.assert_array_equal(tc.k.numpy()[:, keep], k0[:, keep])


@pytest.mark.parametrize("arch", ARCHS)
def test_default_builders_match_jax(arch):
    """``make_prefill(model)`` on a batch of two prompts, then the
    cache-filling prefill's state copied into fp32 dense caches and four
    steps of ``make_serve_step(model)`` from there, greedy tokens fed
    back: logits at every step and the state at the end within 1e-4."""
    jm, jp, tm, tp = _both(arch)
    b, s, steps = 2, 8, 4
    tokens = np.random.default_rng(21).integers(0, tm.cfg.vocab, (b, s),
                                                dtype=np.int32)
    jl = jax_make_prefill(jm)(jp, tokens=jnp.asarray(tokens))
    tl = make_prefill(tm)(tp, torch.from_numpy(tokens).long())
    assert tl.shape == (b, tm.cfg.padded_vocab) and tl.shape == jl.shape
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)

    _, jpre = jax_make_prefill(jm, return_cache=True)(
        jp, tokens=jnp.asarray(tokens))
    _, tpre = make_prefill(tm, return_cache=True)(
        tp, torch.from_numpy(tokens).long())
    jstate = jax.tree.map(
        _jax_fill, jax.tree.map(lambda a: a.astype(jnp.float32),
                                jm.init_decode_state(b, s + steps)), jpre)
    tstate = cast_params(tm.init_decode_state(b, s + steps),
                         dtype=torch.float32)
    for big, small in zip(_leaves(tstate), _leaves(tpre)):
        (big if big.shape == small.shape
         else big[:, :, :small.shape[2]]).copy_(small)

    jstep, tstep = jax_make_serve_step(jm), make_serve_step(tm)
    tok = np.argmax(_f32(jl)[:, :tm.cfg.vocab], -1).astype(np.int32)
    for pos in range(s, s + steps):
        jl, jstate = jstep(jp, jstate, jnp.int32(pos),
                           tokens=jnp.asarray(tok[:, None]))
        # the port's pos as a Python int and as a 0-d tensor, in turns
        tpos = pos if pos % 2 else torch.tensor(pos)
        tl, tstate = tstep(tp, tstate, tpos,
                           torch.from_numpy(tok[:, None]).long())
        assert tl.shape == (b, tm.cfg.padded_vocab)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL)
        tok = np.argmax(_f32(jl)[:, :tm.cfg.vocab], -1).astype(np.int32)
    jflat, tflat = jax.tree_util.tree_leaves(jstate), _leaves(tstate)
    assert len(jflat) == len(tflat)
    for a, t in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape
        np.testing.assert_allclose(_f32(t), _f32(a), **LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_only_prefill_is_the_last_position_of_the_cached_one(arch):
    """The two prefill spellings run the same layers: the logits-only
    one equals the cached one's last position bit for bit (bf16)."""
    model = build_model(smoke_config(arch), device="cpu")
    params = model.init(3)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, model.cfg.vocab, (2, 8))).long()
    last = make_prefill(model)(params, tokens)
    full, _ = make_prefill(model, return_cache=True)(params, tokens)
    assert not last.requires_grad
    assert torch.equal(last, full[:, -1, :])
