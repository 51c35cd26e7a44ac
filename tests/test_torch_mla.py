"""MLA attention (DeepSeek's multi-head latent attention, the absorbed
latent-space form) of the port against the JAX package's, on the CPU,
at the smoke sizes (d 64, 4 heads, kv_lora 32, d_nope 16, d_rope 8, d_v
16): deepseek-v2-lite's uncompressed queries (q_lora 0) and
deepseek-v3's compressed ones (q_lora 32, through ``q_norm``).

The same parameters (the JAX package's ``_init_attn`` draw, carried over
by ``params_from_numpy``) and the same inputs (numpy, from a seed) go
through ``mla_forward`` (with and without ``return_kv``, in one chunk
and in two), ``mla_decode`` and ``mla_decode_paged`` of both packages.
The JAX functions run compiled, as its model runs them (its forward maps
a compiled chunk, its model scans its layers): XLA folds the cast to
fp32 into the bf16 add of the two score products, so the compiled sum is
never rounded to bf16, and the port spells that. Tolerances:

* fp32: the output within 1e-5 of the largest |ref| (measured 2.3e-7);
  the cache rows within 1e-6 of the largest (measured 4.8e-7): the
  ``wkv_a`` product sums in another order in XLA's CPU dot than in
  torch's, so its fp32 rows differ in their last bits;
* bf16: the output within one bf16 ulp of each row's largest |ref|
  (measured: bit for bit), the cache rows bit for bit (each product
  rounds once to bf16);
* the paged decode equals the dense decode bit for bit on the same
  rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import attention as jattn
from repro.models.model import _init_attn as jax_init_attn
from repro_torch.configs import smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import params_from_numpy

ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
DTYPES = ["float32", "bfloat16"]


def _setup(arch: str, dtype: str):
    """(JAX cfg, port cfg, JAX params, port params) of one MLA layer in
    ``dtype`` (the fp32 norms stay fp32 in bf16)."""
    jc, tc = jax_smoke(arch), smoke_config(arch)
    jp = jax_init_attn(jax.random.key(0), jc)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jc, tc, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _pair(a: np.ndarray, dtype: str):
    """``a`` as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch,
                                                                 dtype)))


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _row_ulps(got, want) -> float:
    """The largest error of a row, in bf16 ulps of that row's largest
    |want| (2^-7 of it)."""
    g, w = _f64(got), _f64(want)
    err = np.abs(g - w).max(-1)
    return float((err / np.maximum(2.0 ** -7 * np.abs(w).max(-1),
                                   1e-30)).max())


def _close(got, want, dtype: str) -> None:
    """fp32 within 1e-5 of the largest |ref|; bf16 within one ulp a row."""
    assert tuple(got.shape) == tuple(want.shape)
    if dtype == "float32":
        g, w = _f64(got), _f64(want)
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    else:
        assert _row_ulps(got, want) <= 1.0


def _cache_close(got, want, dtype: str) -> None:
    """A cache leaf: bf16 bit for bit, fp32 within 1e-6 of the largest."""
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    g, w = _f64(got), _f64(want)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(g, w)
    else:
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_jax_leaves(arch):
    """The same leaf names, shapes and dtypes as the JAX MLA init: wq, or
    wq_a with its fp32 q_norm and wq_b."""
    from repro_torch.models.model import _init_attn
    jc, tc, jp, _ = _setup(arch, "bfloat16")
    tp = _init_attn(torch.Generator().manual_seed(0), tc, "cpu")
    assert sorted(tp) == sorted(jp)
    for k, a in jp.items():
        assert tuple(tp[k].shape) == a.shape, k
        assert str(tp[k].dtype).replace("torch.", "") == str(a.dtype), k
    assert ("wq_a" in tp) == bool(tc.q_lora_rank)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("chunk", [16, 8])
def test_mla_forward_matches_jax(arch, dtype, chunk):
    """The full-sequence forward over a batch of two of 16 positions, in
    one query chunk and in two, with and without the cache rows."""
    jc, tc, jp, tp = _setup(arch, dtype)
    x = np.random.default_rng(1).standard_normal(
        (2, 16, tc.d_model)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    fwd = jax.jit(lambda x: jattn.mla_forward(x, jp, jc, chunk=chunk,
                                              return_kv=True))
    jy, jcache = fwd(jx)
    ty, tcache = tattn.mla_forward(tx, tp, tc, chunk=chunk, return_kv=True)
    assert isinstance(tcache, tattn.MLACache)
    _close(ty, jy, dtype)
    for got, want in zip(tcache, jcache):
        _cache_close(got, want, dtype)
    np.testing.assert_array_equal(
        _f64(tattn.mla_forward(tx, tp, tc, chunk=chunk)), _f64(ty))


def test_mla_forward_refuses_a_ragged_chunk():
    """A sequence the chunk does not divide raises, as the JAX forward
    asserts."""
    _, tc, _, tp = _setup(ARCHS[0], "float32")
    with pytest.raises(ValueError, match="multiple of the query chunk"):
        tattn.mla_forward(torch.zeros(1, 12, tc.d_model), tp, tc, chunk=8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [0, 7])
def test_mla_decode_matches_jax(arch, dtype, pos):
    """One token at a scalar position against a random dense cache of
    the activation dtype (JAX's ``dynamic_update_slice`` takes only the
    cache's own): the output, and the cache written at ``pos`` only, in
    place."""
    jc, tc, jp, tp = _setup(arch, dtype)
    rng = np.random.default_rng(pos + 3)
    b, s_max = 2, 9
    c0 = rng.standard_normal((b, s_max, tc.kv_lora_rank)).astype(np.float32)
    r0 = rng.standard_normal((b, s_max, tc.mla_d_rope)).astype(np.float32)
    x = rng.standard_normal((b, 1, tc.d_model)).astype(np.float32)
    (jx, tx), (jc0, tc0), (jr0, tr0) = (_pair(a, dtype) for a in (x, c0, r0))
    dec = jax.jit(lambda x, c, p: jattn.mla_decode(x, jp, jc, c, p))
    jy, jcache = dec(jx, jattn.MLACache(jc0, jr0), jnp.int32(pos))
    cache = tattn.MLACache(tc0.clone(), tr0.clone())
    ty, tcache = tattn.mla_decode(tx, tp, tc, cache, torch.tensor(pos))
    assert tcache.c_kv is cache.c_kv and tcache.k_rope is cache.k_rope
    _close(ty, jy, dtype)
    for got, want in zip(tcache, jcache):
        _cache_close(got, want, dtype)
    keep = np.arange(s_max) != pos
    np.testing.assert_array_equal(_f64(tcache.c_kv)[:, keep],
                                  _f64(tc0)[:, keep])


def _pool_case(tc, dtype: str, seed: int):
    """A random pool of 12 pages of 4, a scrambled table for two live
    rows and an inactive one (all-zero table, pos 0: the trash page),
    per-row positions, one token a row."""
    rng = np.random.default_rng(seed)
    n_pages, ps = 12, 4
    c0 = rng.standard_normal((n_pages, ps, tc.kv_lora_rank)).astype(
        np.float32)
    r0 = rng.standard_normal((n_pages, ps, tc.mla_d_rope)).astype(np.float32)
    table = np.array([[7, 2, 10], [3, 11, 0], [0, 0, 0]], np.int64)
    pos = np.array([9, 5, 0], np.int64)
    x = rng.standard_normal((3, 1, tc.d_model)).astype(np.float32)
    return c0, r0, table, pos, x


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_paged_matches_jax(arch, dtype):
    """One token a row against a paged pool, per-row positions: the
    output and the pools after the write."""
    jc, tc, jp, tp = _setup(arch, dtype)
    c0, r0, table, pos, x = _pool_case(tc, dtype, 5)
    (jx, tx), (jc0, tc0), (jr0, tr0) = (_pair(a, dtype) for a in (x, c0, r0))
    dec = jax.jit(lambda x, c, t, p: jattn.mla_decode_paged(x, jp, jc, c, t,
                                                            p))
    jy, jpool = dec(jx, jattn.MLACache(jc0, jr0),
                    jnp.asarray(table, jnp.int32), jnp.asarray(pos, jnp.int32))
    ty, tpool = tattn.mla_decode_paged(
        tx, tp, tc, tattn.MLACache(tc0.clone(), tr0.clone()),
        torch.from_numpy(table), torch.from_numpy(pos))
    _close(ty[:2], jy[:2], dtype)          # row 2 reads the trash page
    for got, want in zip(tpool, jpool):
        _cache_close(got[1:], want[1:], dtype)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_mla_decode_paged_equals_the_dense_decode(arch, dtype):
    """Rows at one position: the paged decode over a scrambled table
    gives the dense decode's output and rows bit for bit, the dense
    caches being the pages each row's table gathers."""
    _, tc, _, tp = _setup(arch, dtype)
    c0, r0, table, _, x = _pool_case(tc, dtype, 6)
    table, pos = table[:2], np.array([6, 6], np.int64)
    _, tx = _pair(x[:2], dtype)
    pool = tattn.MLACache(*(_pair(a, dtype)[1] for a in (c0, r0)))
    dense = tattn.MLACache(*(tattn.paged_view(t, torch.from_numpy(table))
                             for t in pool))
    yp, pool = tattn.mla_decode_paged(tx, tp, tc, pool,
                                      torch.from_numpy(table),
                                      torch.from_numpy(pos))
    yd, dense = tattn.mla_decode(tx, tp, tc, dense, 6)
    assert torch.equal(yp, yd)
    for p, d in zip(pool, dense):
        assert torch.equal(tattn.paged_view(p, torch.from_numpy(table)), d)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_pool_layouts_match_jax(arch):
    jc, tc = jax_smoke(arch), smoke_config(arch)
    pairs = [(jattn.init_mla_cache(jc, 3, 10),
              tattn.init_mla_cache(tc, 3, 10, device="cpu")),
             (jattn.init_mla_pool(jc, 7, 4),
              tattn.init_mla_pool(tc, 7, 4, device="cpu"))]
    for want, got in pairs:
        assert got._fields == want._fields == ("c_kv", "k_rope")
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
            assert not g.any()
