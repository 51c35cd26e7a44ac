"""The ``moe`` family (DeepSeek: MLA attention, a leading dense block,
then MoE blocks with a shared expert) of the port against the JAX
package, on the CPU, at the smoke sizes (d 64, kv_lora 32, d_nope 16,
d_rope 8, d_v 16, 8 experts top-2, 1 shared, 3 layers:
``attn_dense`` then two ``attn_moe``): deepseek-v2-lite-16b (q_lora 0)
and deepseek-v3-671b (q_lora 32). The parameter tree, the forward,
prefill, dense and paged decode, serving and the write guard. Training
is in ``tests/test_torch_deepseek_train.py``, MLA alone in
``tests/test_torch_mla.py``.

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same inputs (numpy, from a seed) go
through both packages. Tolerances:

* fp32 logits within 1e-5 of the largest |ref| (measured up to 5.9e-6:
  summation order through three layers, the experts and the head),
  prefill, dense and paged decode included, and greedy tokens
  identical; the caches as the logits (fp32 rows: the later layers'
  carry the earlier layers' summation order; measured up to 1.5e-6)
  and within one bf16 ulp of each element (bf16 pools: an fp32 row within
  ~1e-7 of a rounding boundary lands on either side of it);
* bf16 logits: no fixed distance from JAX's. MLA, the norms and the
  dense MLP give JAX's bits, but the MoE layer sums a token's k expert
  terms in another order than JAX's dense oracle (one bf16 ulp, held in
  ``tests/test_torch_moe.py``), and a token's top-k turns on router gaps
  of a few 1e-3, so in either package a token takes other experts than
  in the fp32 run: JAX's own bf16 logits sit 0.06 to 0.17 RMS from its
  fp32 logits on batches of 8 to 24 prompts, the port's as far (0.85x
  to 1.75x of JAX's on one such batch, 1.03x and 1.07x pooled over
  three). So over one batch of 48 prompts of 32 tokens the port's bf16
  logits must sit no further from JAX's fp32 logits than 1.25x JAX's own
  bf16 logits do, as ``tests/test_torch_hybrid.py`` holds jamba.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models.model import Model as JaxModel
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import make_cache_writer as jax_cache_writer
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import RequestStream
from repro_torch.dist import tree_leaves
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, cast_params, params_from_numpy
from repro_torch.models.attention import MLACache
from repro_torch.models.model import segments_of
from repro_torch.serve import (ReplicaServer, ServeEngine, make_cache_writer,
                               pool_pages_for)
from repro_torch.train import ScriptedInjector

ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
TOL = 1e-5
_JAX: dict = {}


def _jax_params(arch: str, dtype: str):
    """The JAX model's init as numpy leaves in ``dtype`` (bf16: as drawn,
    the fp32 norms and router kept)."""
    key = (arch, dtype)
    if key not in _JAX:
        params = JaxModel(cfg=jax_smoke(arch)).init(jax.random.key(0))
        if dtype == "float32":
            params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        _JAX[key] = jax.tree.map(np.asarray, params)
    return _JAX[key]


def _both(arch: str, dtype: str, jax_model=JaxModel):
    jp = jax.tree.map(jnp.asarray, _jax_params(arch, dtype))
    return (jax_model(cfg=jax_smoke(arch)), jp,
            build_model(smoke_config(arch), device="cpu"),
            params_from_numpy(_jax_params(arch, dtype), "cpu"))


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, tol: float = TOL) -> None:
    g, w = _f64(got), _f64(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= tol * np.abs(w).max(), \
        (np.abs(g - w).max(), np.abs(w).max())


def _cache_close(got, want) -> None:
    """A cache leaf: fp32 within 1e-5 of the largest; bf16 within one
    ulp of each element (2^-7 of it) as well."""
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    g, w = _f64(got), _f64(want)
    atol = TOL * np.abs(w).max()
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, atol=atol, rtol=2.0 ** -7)
    else:
        assert np.abs(g - w).max() <= atol


# ------------------------------------------------------------------ #
# layout                                                             #
# ------------------------------------------------------------------ #
def test_build_model_takes_deepseek_at_published_width():
    """deepseek-v2-lite builds at published width on the CPU (27 layers:
    one dense block, then 26 MoE blocks), and on ``cuda`` only the
    missing card stops it."""
    cfg = get_config(ARCHS[0])
    model = build_model(cfg, device="cpu")
    assert model.cfg.name == ARCHS[0]
    assert segments_of(cfg) == [(("attn_dense",), 1), (("attn_moe",), 26)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg, device="cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_jax_tree_layout(arch):
    """Same leaf paths, shapes and dtypes as the JAX model's init: the
    MLA leaves with their fp32 norms, the shared expert, the fp32
    router."""
    jp = _jax_params(arch, "bfloat16")
    tp = build_model(smoke_config(arch), device="cpu").init(0)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
    dense, moe = tp["segments"][0][0], tp["segments"][1][0]
    assert list(dense) == ["ln1", "attn", "ln2", "mlp"]
    assert list(moe) == ["ln1", "attn", "ln2", "moe"]
    assert "shared" in moe["moe"] and moe["attn"]["kv_norm"].dtype == \
        torch.float32


def test_init_stacks_the_draws_in_order():
    """The stacked init draws block by block into the stacks: the same
    values as stacking the blocks drawn from the same generator."""
    from repro_torch.models.layers import init_linear
    from repro_torch.models.model import _init_block
    cfg = smoke_config(ARCHS[1])
    params = build_model(cfg, device="cpu").init(5)
    # the embedding and the head are drawn first, then the segments
    gen = torch.Generator().manual_seed(5)
    init_linear(gen, (cfg.padded_vocab, cfg.d_model), device="cpu")
    init_linear(gen, (cfg.d_model, cfg.padded_vocab), device="cpu")
    for (pattern, n_rep), seg in zip(segments_of(cfg), params["segments"]):
        blocks = [_init_block(gen, pattern[0], cfg, "cpu")
                  for _ in range(n_rep)]
        want = [torch.stack(ls) for ls in zip(*map(tree_leaves, blocks))]
        for got, w in zip(tree_leaves(seg[0]), want):
            assert torch.equal(got, w)


# ------------------------------------------------------------------ #
# forward, prefill, decode                                           #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    """fp32 logits within 1e-5 of the largest |ref|; bf16 logits no
    further from JAX's fp32 logits than 1.25x JAX's own bf16 logits."""
    jm, jp32, tm, tp32 = _both(arch, "float32")
    tokens = np.random.default_rng(12).integers(0, tm.cfg.vocab, (48, 32),
                                                dtype=np.int32)
    fwd = jax.jit(jm.forward)
    ref = _f64(fwd(jp32, tokens=jnp.asarray(tokens)))
    got = tm.forward(tp32, torch.from_numpy(tokens).long())
    _close(got, ref)

    _, jp, _, tp = _both(arch, "bfloat16")
    jbf = _f64(fwd(jp, tokens=jnp.asarray(tokens)))
    tbf = _f64(tm.forward(tp, torch.from_numpy(tokens).long()))
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))  # noqa: E731
    assert np.isfinite(tbf).all()
    assert rms(tbf - ref) <= 1.25 * rms(jbf - ref), \
        (rms(tbf - ref), rms(jbf - ref))


class _JaxF32Caches(JaxModel):
    """The JAX model with fp32 dense caches: its ``ServeEngine``'s write
    executable is compiled for the dense caches of
    ``init_decode_state`` (bf16 by default), and its dense decode's
    ``dynamic_update_slice`` takes only the cache's own dtype. Its MLA
    pools stay bf16, as the port's."""

    def init_decode_state(self, batch, s_max):
        return jax.tree.map(lambda t: t.astype(jnp.float32),
                            super().init_decode_state(batch, s_max))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax(arch):
    """Two prompts prefilled into the bf16 pools through a scrambled
    block table, then paged decode steps in fp32: logits within 1e-5 of
    the largest, every greedy token identical, the caches and pools as
    the module doc says."""
    jm, jp, tm, tp = _both(arch, "float32")
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 16, dtype=np.int32),
               rng.integers(0, cfg.vocab, 8, dtype=np.int32)]
    n_pages, ps, steps = 16, 4, 4
    table = np.array([[9, 2, 14, 5, 11, 0], [3, 12, 7, 0, 0, 0]], np.int32)
    jpools = jm.init_paged_state(2, n_pages, ps)
    tpools = tm.init_paged_state(2, n_pages, ps)
    assert all(isinstance(c, MLACache) for seg in tpools for c in seg)
    jwrite, twrite = jax_cache_writer(jm), make_cache_writer(tm)
    jprefill, jdecode = jax.jit(jm.prefill), jax.jit(jm.decode_step_paged)
    tok = np.zeros(2, np.int32)
    for row, prompt in enumerate(prompts):
        jl, jd = jprefill(jp, tokens=jnp.asarray(prompt[None]))
        tl, td = tm.prefill(tp, torch.from_numpy(prompt[None]).long())
        _close(tl, jl)
        for a, b in zip(jax.tree_util.tree_leaves(jd), tree_leaves(td)):
            _cache_close(b, a)
        pages = table[row, :-(-(len(prompt) + steps) // ps)]
        jpools = jwrite(jpools, jd, jnp.asarray(pages), jnp.int32(row))
        twrite(tpools, td, torch.from_numpy(pages).long(), row)
        tok[row] = int(np.argmax(np.asarray(jl[0, -1, :cfg.vocab])))
        assert int(tl[0, -1, :cfg.vocab].argmax()) == tok[row]
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(steps):
        jl, jpools = jdecode(jp, jpools, jnp.asarray(table),
                             jnp.asarray(pos),
                             tokens=jnp.asarray(tok[:, None]))
        tl, _ = tm.decode_step_paged(
            tp, tpools, torch.from_numpy(table).long(),
            torch.from_numpy(pos).long(),
            tokens=torch.from_numpy(tok[:, None]).long())
        _close(tl, jl)
        tok = np.argmax(np.asarray(jl[:, 0, :cfg.vocab]), -1).astype(np.int32)
        np.testing.assert_array_equal(
            tl[:, 0, :cfg.vocab].argmax(-1).numpy(), tok)
        pos += 1
    for a, b in zip(jax.tree_util.tree_leaves(jpools), tree_leaves(tpools)):
        _cache_close(b, a)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_dense_decode_steps_match_jax(arch):
    """A batch of two prompts prefilled, the caches copied into fp32
    dense caches of room for four more, then four ``decode_step``s at a
    scalar position, greedy tokens fed back: logits within 1e-5 of the
    largest at every step, and the caches at the end."""
    jm, jp, tm, tp = _both(arch, "float32", _JaxF32Caches)
    b, s, steps = 2, 8, 4
    tokens = np.random.default_rng(21).integers(0, tm.cfg.vocab, (b, s),
                                                dtype=np.int32)
    jl, jpre = jax.jit(jm.prefill)(jp, tokens=jnp.asarray(tokens))
    tl, tpre = tm.prefill(tp, torch.from_numpy(tokens).long())
    _close(tl, jl)
    jstate = jax.tree.map(lambda big, small: big.at[:, :, :s].set(small),
                          jm.init_decode_state(b, s + steps), jpre)
    tstate = cast_params(tm.init_decode_state(b, s + steps),
                         dtype=torch.float32)
    for big, small in zip(tree_leaves(tstate), tree_leaves(tpre)):
        big[:, :, :s].copy_(small)
    jstep = jax.jit(jm.decode_step)
    tok = np.argmax(_f64(jl)[:, -1, :tm.cfg.vocab], -1).astype(np.int32)
    for pos in range(s, s + steps):
        jl, jstate = jstep(jp, jstate, jnp.int32(pos),
                           tokens=jnp.asarray(tok[:, None]))
        tl, tstate = tm.decode_step(tp, tstate, pos,
                                    torch.from_numpy(tok[:, None]).long())
        _close(tl, jl)
        tok = np.argmax(_f64(jl)[:, 0, :tm.cfg.vocab], -1).astype(np.int32)
        np.testing.assert_array_equal(
            tl[:, 0, :tm.cfg.vocab].argmax(-1).numpy(), tok)
    for a, t in zip(jax.tree_util.tree_leaves(jstate), tree_leaves(tstate)):
        _cache_close(t, a)


# ------------------------------------------------------------------ #
# serving                                                            #
# ------------------------------------------------------------------ #
ENGINE = dict(n_slots=2, page_size=4, max_new=4, buckets=(8, 16),
              n_pages=pool_pages_for(2, 16 + 4, 4))


N_REQUESTS = 8


def _jax_tokens(arch: str) -> dict:
    """Per-request greedy tokens of the JAX ServeEngine (fp32 params,
    fp32 dense caches, bf16 pools) over ``N_REQUESTS`` requests, computed
    once an arch."""
    key = (arch, "tokens")
    if key not in _JAX:
        jm, jp, _, _ = _both(arch, "float32", _JaxF32Caches)
        eng = JaxServeEngine(jm, jp, **ENGINE)
        eng.warmup()
        for r in RequestStream(smoke_config(arch), buckets=(8, 16),
                               max_new=4, seed=7).requests(N_REQUESTS):
            eng.submit(r)
        _JAX[key] = {d.req_id: d.tokens for d in eng.run()}
    return _JAX[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_match_jax_engine(arch):
    """Continuous batching over more requests than slots through the MLA
    pools: per-request greedy tokens identical to the JAX ServeEngine's
    (fp32), no rebuild after warmup, every page freed."""
    _, _, tm, tp = _both(arch, "float32")
    teng = ServeEngine(tm, tp, **ENGINE)
    teng.warmup()
    frozen = teng.cache.misses
    for r in RequestStream(tm.cfg, buckets=(8, 16), max_new=4,
                           seed=7).requests(N_REQUESTS):
        teng.submit(r)
    got = {d.req_id: d.tokens for d in teng.run()}
    want = _jax_tokens(arch)
    assert teng.cache.misses == frozen == 5
    assert got.keys() == want.keys() and len(got) == N_REQUESTS
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")
    assert teng.alloc.free_pages == teng.alloc.n_pages - 1


def test_replica_kill_gives_the_jax_tokens():
    """A ReplicaServer of three replicas killed at steps 1 and 3 (the
    second kill wipes the rest out): nothing dropped or rebuilt, and
    every request's tokens those of the JAX ServeEngine."""
    arch = ARCHS[0]
    _, _, tm, tp = _both(arch, "float32")
    inj = ScriptedInjector({1: [0], 3: [1, 2]}, n_groups=3)
    srv = ReplicaServer(tm, tp, n_replicas=3, injector=inj,
                        engine_kwargs=ENGINE)
    srv.warmup()
    frozen = srv.recompiles
    for r in RequestStream(tm.cfg, buckets=(8, 16), max_new=4,
                           seed=7).requests(N_REQUESTS):
        srv.submit(r)
    got = {d.req_id: d.tokens for d in srv.run()}
    assert srv.recompiles == frozen
    assert [e.kind for e in srv.events] == ["kill", "kill", "wipeout"]
    assert sum(e.requeued for e in srv.events) > 0 and srv.dropped == 0
    want = _jax_tokens(arch)
    assert got.keys() == want.keys() and len(got) == N_REQUESTS
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_write_guard_refuses_a_prefill_of_another_length():
    """The per-bucket write reads the prompt length from the MLA latent:
    a dense state of 16 rows written through the bucket of 8 raises
    (before the repair it found no ``KVCache``, took the model for a pure
    SSM and wrote past the prompt silently)."""
    model = build_model(smoke_config(ARCHS[0]), device="cpu")
    params = model.init(0)
    eng = ServeEngine(model, params, **ENGINE)
    eng.warmup()
    _, dense = model.prefill(params, torch.zeros(1, 16).long())
    write = eng._write_exe(8)
    pages = torch.arange(1, 4)                  # 8 + 4 rows: 3 pages
    with pytest.raises(ValueError, match="length 16"):
        write(eng.pools, dense, pages, 0)
    _, dense = model.prefill(params, torch.zeros(1, 8).long())
    write(eng.pools, dense, pages, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_deepseek_on_the_cpu(arch, capsys):
    serve_cli.main(["--arch", arch, "--device", "cpu", "--requests", "6",
                    "--kill", "3:0"])
    out = capsys.readouterr().out
    assert '"completed_requests": 6' in out and '"kill"' in out
    assert f'"arch": "{arch}"' in out


def test_launch_config_widens_only_gqa_heads(monkeypatch):
    """No config is widened on any device: the launchers build the same
    configuration on a CUDA device as on the CPU, ``smoke_config(arch)``,
    for the MLA configs and for a GQA one (head dim 16, which K2 takes)."""
    from _launchers import launcher_configs

    for arch in (*ARCHS, "qwen2.5-3b"):
        want = [smoke_config(arch), smoke_config(arch).scaled(grad_accum=1)]
        assert launcher_configs(arch, "cuda", monkeypatch) == want
        assert launcher_configs(arch, "cpu", monkeypatch) == want
    assert smoke_config("qwen2.5-3b").resolved_head_dim == 16
