"""The port's layers and GQA attention against the JAX package's, on the
same numpy inputs and weights (CPU; the kernels' plain versions).

Tolerances: fp32 1e-5 for single layers (summation order only); bf16
compares against the JAX result within a few bf16 ulps (rtol 2^-6,
atol 2e-2 on O(1) values): JAX's plain attention rounds scores and
probabilities to bf16 where the port's flash path keeps fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2 ** -6)}


def _pair(arr, dtype):
    jd, td = DTYPES[dtype]
    j = jnp.asarray(arr, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _attn_params(cfg, rng, dtype):
    d, dh = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.n_heads * dh), "wk": (d, cfg.n_kv_heads * dh),
              "wv": (d, cfg.n_kv_heads * dh), "wo": (cfg.n_heads * dh, d),
              "bq": (cfg.n_heads * dh,), "bk": (cfg.n_kv_heads * dh,),
              "bv": (cfg.n_kv_heads * dh,)}
    jp, tp = {}, {}
    for name, shape in shapes.items():
        scale = 0.1 if name.startswith("b") else shape[0] ** -0.5
        arr = rng.normal(size=shape) * scale
        # biases stay fp32, as the model keeps them
        dt = "float32" if name.startswith("b") else dtype
        jp[name], tp[name] = _pair(arr, dt)
    return jp, tp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.normal(size=(2, 11, 3, 16)), dtype)
    pos = rng.integers(0, 5000, size=(2, 11))
    want = jlayers.apply_rope(xj, jnp.asarray(pos, jnp.int32), 1e6)
    got = tlayers.apply_rope(xt, torch.from_numpy(pos), 1e6)
    assert got.dtype == DTYPES[dtype][1]
    # angles up to 5000 rad: fp32 sin/cos of the two libraries agree to
    # a few ulps of the angle (5000 * 2^-24 ~ 3e-4)
    tol = TOL[dtype] if dtype == "bfloat16" else dict(atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(3, 5, 32)), dtype)
    ws = [_pair(rng.normal(size=s) * s[0] ** -0.5, dtype)
          for s in ((32, 64), (32, 64), (64, 32))]
    want = jlayers.swiglu(xj, *(w[0] for w in ws))
    got = tlayers.swiglu(xt, *(w[1] for w in ws))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_forward_return_kv_matches(dtype):
    cfg = smoke_config("qwen2.5-3b")
    jcfg = jax_smoke("qwen2.5-3b")
    rng = np.random.default_rng(2)
    jp, tp = _attn_params(cfg, rng, dtype)
    xj, xt = _pair(rng.normal(size=(2, 24, cfg.d_model)), dtype)
    yj, cj = jattn.gqa_forward(xj, jp, jcfg, chunk=8, return_kv=True)
    yt, ct = tattn.gqa_forward(xt, tp, cfg, return_kv=True)
    np.testing.assert_allclose(_np(yt), _np(yj), **TOL[dtype])
    for a, b in ((ct.k, cj.k), (ct.v, cj.v)):
        assert tuple(a.shape) == b.shape == (2, 24, cfg.n_kv_heads,
                                             cfg.resolved_head_dim)
        np.testing.assert_allclose(_np(a), _np(b), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_paged_scrambled_table_matches(dtype):
    """Pages handed out in scrambled order, a dirty pool, and rows at
    different positions (one inactive row on the trash page): the port's
    in-place paged decode gives the JAX result and the same pools."""
    cfg = smoke_config("qwen2.5-3b")
    jcfg = jax_smoke("qwen2.5-3b")
    rng = np.random.default_rng(3)
    jp, tp = _attn_params(cfg, rng, dtype)
    n_pages, ps = 12, 4
    pool_shape = (n_pages, ps, cfg.n_kv_heads, cfg.resolved_head_dim)
    pk = rng.normal(size=pool_shape)
    pv = rng.normal(size=pool_shape)
    table = np.array([[7, 2, 11], [5, 9, 1], [0, 0, 0]], np.int32)
    pos = np.array([9, 4, 0], np.int32)
    xj, xt = _pair(rng.normal(size=(3, 1, cfg.d_model)), dtype)

    jpool = jattn.KVCache(jnp.asarray(pk, jnp.bfloat16),
                          jnp.asarray(pv, jnp.bfloat16))
    tpool = tattn.KVCache(*(torch.from_numpy(
        np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in jpool))
    yj, nj = jattn.gqa_decode_paged(xj, jp, jcfg, jpool,
                                    jnp.asarray(table), jnp.asarray(pos))
    yt, nt = tattn.gqa_decode_paged(xt, tp, cfg, tpool,
                                    torch.from_numpy(table).long(),
                                    torch.from_numpy(pos).long())
    assert nt.k is tpool.k and nt.v is tpool.v        # updated in place
    # rows 0 and 1 are live; row 2 reads the trash page and is garbage
    np.testing.assert_allclose(_np(yt)[:2], _np(yj)[:2], **TOL[dtype])
    live = [(7, 2), (9, 0)]      # (page, slot in page) each live row wrote
    for a, b in ((nt.k, nj.k), (nt.v, nj.v)):
        a, b = _np(a), _np(b)
        for page, slot in live:
            np.testing.assert_allclose(a[page, slot], b[page, slot],
                                       atol=2 ** -7 * np.abs(b).max())
        untouched = np.ones(n_pages, bool)
        untouched[[0, 2, 9]] = False
        np.testing.assert_array_equal(a[untouched], b[untouched])


def test_cross_entropy_matches():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, size=(2, 7))
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tlayers.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_paged_view_gathers_pages_in_table_order():
    pool = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
    table = torch.tensor([[3, 1], [0, 4]])
    got = tattn.paged_view(pool, table)
    want = jattn.paged_view(jnp.asarray(pool.numpy()),
                            jnp.asarray(table.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_linear_is_seeded_and_truncated():
    gen = torch.Generator().manual_seed(0)
    a = tlayers.init_linear(gen, (64, 32), device="cpu")
    gen = torch.Generator().manual_seed(0)
    b = tlayers.init_linear(gen, (64, 32), device="cpu")
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert a.float().abs().max() <= 3 * 64 ** -0.5 * (1 + 2 ** -7)
    # same fan-in scale as the JAX init
    j = jlayers.init_linear(jax.random.key(0), (64, 32))
    assert abs(float(a.float().std()) - float(jnp.std(
        j.astype(jnp.float32)))) < 0.02
