"""The serving slice of the port against the JAX package, on the CPU.

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same requests go through both packages:

* fused prefill logits and caches, then paged decode steps over a
  scrambled block table: fp32 within 1e-4 (summation order, through two
  layers and the tied head); bf16 within 0.1 on logits of magnitude ~1
  (a few bf16 ulps: JAX's plain attention rounds scores and probabilities
  to bf16 where the port's flash path keeps fp32);
* the ``ServeEngine``'s per-request greedy tokens: identical (fp32);
* a ``ReplicaServer`` under scripted replica kills: zero drops, no
  rebuild after warmup, tokens identical to the healthy run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.core import golomb as jgolomb
from repro.core.state import SpareState as JaxSpareState
from repro.data import RequestStream as JaxRequestStream
from repro.models.model import Model as JaxModel
from repro.models.model import build_model as jax_build
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import make_cache_writer as jax_cache_writer
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import golomb
from repro_torch.core.state import SpareState
from repro_torch.data import RequestStream
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serve import (ReplicaServer, ServeEngine, make_cache_writer,
                               pool_pages_for)
from repro_torch.train import ScriptedInjector

ARCH = "qwen2.5-3b"
_JAX: dict = {}


def _jax_model():
    if not _JAX:
        cfg = jax_smoke(ARCH)
        model = jax_build(cfg)
        _JAX.update(cfg=cfg, model=model,
                    params=model.init(jax.random.key(0)))
    return _JAX["cfg"], _JAX["model"], _JAX["params"]


def _both(dtype: str):
    """(jax model, jax params, port model, port params) in ``dtype``."""
    _, jm, jp = _jax_model()
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tm = build_model(smoke_config(ARCH), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=1e-1, rtol=0)}


# ------------------------------------------------------------------ #
# parameters                                                         #
# ------------------------------------------------------------------ #
def test_params_from_numpy_keeps_every_leaf_bit_exact():
    _, _, jp = _jax_model()
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl, jdef = jax.tree_util.tree_flatten(jp)
    tl = jax.tree_util.tree_leaves(tp)
    assert isinstance(tp["segments"], list)
    assert isinstance(tp["segments"][0], tuple)
    assert len(jl) == len(tl)
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda t: 0, tp,
                     is_leaf=lambda t: isinstance(t, torch.Tensor))) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda a: 0, jp))
    for a, t in zip(jl, tl):
        want = np.asarray(a)
        if want.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)


def test_init_matches_the_jax_tree_layout():
    """Same leaf paths, shapes and dtypes as the JAX model's init."""
    _, _, jp = _jax_model()
    tp = build_model(smoke_config(ARCH), device="cpu").init(0)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",    # MLA + MoE
                                  "deepseek-v3-671b"])
def test_other_families_are_not_ported_yet(arch):
    """Every family is ported now: the MLA and MoE configs that
    ``build_model`` refused build and run a prefill on the CPU (their
    parity with JAX is in ``tests/test_torch_deepseek.py``)."""
    model = build_model(smoke_config(arch), device="cpu")
    logits, _ = model.prefill(model.init(0), torch.zeros(1, 4).long())
    assert logits.shape == (1, 4, model.cfg.padded_vocab)


# ------------------------------------------------------------------ #
# prefill + paged decode                                             #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_paged_decode_match_jax(dtype):
    jm, jp, tm, tp = _both(dtype)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 16, dtype=np.int32),
               rng.integers(0, cfg.vocab, 8, dtype=np.int32)]
    n_pages, ps, steps = 16, 4, 4
    table = np.array([[9, 2, 14, 5, 11, 0], [3, 12, 7, 0, 0, 0]], np.int32)
    jpools = jm.init_paged_state(2, n_pages, ps)
    tpools = tm.init_paged_state(2, n_pages, ps)
    jwrite, twrite = jax_cache_writer(jm), make_cache_writer(tm)

    tok = np.zeros(2, np.int32)
    for row, prompt in enumerate(prompts):
        jl, jd = jm.prefill(jp, tokens=jnp.asarray(prompt[None]))
        tl, td = tm.prefill(tp, torch.from_numpy(prompt[None]).long())
        assert tuple(tl.shape) == jl.shape
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL[dtype])
        for a, b in zip(jax.tree_util.tree_leaves(jd),
                        jax.tree_util.tree_leaves(td)):
            assert tuple(b.shape) == a.shape
            np.testing.assert_allclose(_f32(b), _f32(a),
                                       **LOGIT_TOL[dtype])
        n_alloc = -(-(len(prompt) + steps) // ps)
        pages = table[row, :n_alloc]
        jpools = jwrite(jpools, jd, jnp.asarray(pages), jnp.int32(row))
        twrite(tpools, td, torch.from_numpy(pages).long(), row)
        tok[row] = int(np.argmax(np.asarray(jl[0, -1, :cfg.vocab])))

    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(steps):
        jl, jpools = jm.decode_step_paged(
            jp, jpools, jnp.asarray(table), jnp.asarray(pos),
            tokens=jnp.asarray(tok[:, None]))
        tl, _ = tm.decode_step_paged(
            tp, tpools, torch.from_numpy(table).long(),
            torch.from_numpy(pos).long(), torch.from_numpy(tok[:, None]).long())
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL[dtype])
        tok = np.argmax(np.asarray(jl[:, 0, :cfg.vocab]), -1).astype(np.int32)
        pos += 1
    for a, b in zip(jax.tree_util.tree_leaves(jpools),
                    jax.tree_util.tree_leaves(tpools)):
        np.testing.assert_allclose(_f32(b), _f32(a), atol=5e-2, rtol=0)


def test_forward_matches_jax():
    """The full forward over a batch of two (fp32)."""
    jm, jp, tm, tp = _both("float32")
    tokens = np.random.default_rng(12).integers(0, tm.cfg.vocab, (2, 12),
                                                dtype=np.int32)
    want = jm.forward(jp, tokens=jnp.asarray(tokens))
    got = tm.forward(tp, torch.from_numpy(tokens).long())
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **LOGIT_TOL["float32"])


def test_prefill_state_matches_init_decode_state_layout():
    model = build_model(smoke_config(ARCH), device="cpu")
    _, state = model.prefill(model.init(2), torch.zeros(3, 5).long())
    want = model.init_decode_state(3, 5)
    flat = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [tuple(a.shape) for a in flat(state)] == \
        [tuple(b.shape) for b in flat(want)]


def test_padded_vocab_is_masked():
    cfg = get_config(ARCH)
    assert cfg.padded_vocab == 152064 and cfg.vocab == 151936
    model = build_model(smoke_config(ARCH).scaled(vocab=500), device="cpu")
    logits = model.prefill(model.init(1), torch.zeros(1, 4).long())[0]
    assert logits.shape[-1] == 512
    assert torch.all(logits[..., 500:] == -2.0 ** 20)


# ------------------------------------------------------------------ #
# engine and replicas                                                #
# ------------------------------------------------------------------ #
ENGINE = dict(n_slots=2, page_size=4, max_new=4, buckets=(8, 16),
              n_pages=pool_pages_for(2, 16 + 4, 4))


def test_request_stream_is_the_jax_stream():
    cfg = smoke_config(ARCH)
    ours = RequestStream(cfg, buckets=(8, 16), max_new=4, seed=7)
    theirs = JaxRequestStream(jax_smoke(ARCH), buckets=(8, 16), max_new=4,
                              seed=7)
    for a, b in zip(ours.requests(12), theirs.requests(12)):
        assert a.req_id == b.req_id and a.max_new == b.max_new
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("n,r", [(6, 2), (9, 3), (16, 4)])
def test_spare_state_copies_match(n, r):
    np.testing.assert_array_equal(golomb.host_sets(n, r),
                                  jgolomb.host_sets(n, r))
    np.testing.assert_array_equal(golomb.type_sets(n, r),
                                  jgolomb.type_sets(n, r))
    ours, theirs = SpareState(n, r), JaxSpareState(n, r)
    for a, b in zip(ours.device_schedule(), theirs.device_schedule()):
        np.testing.assert_array_equal(a, b)


class _JaxF32Caches(JaxModel):
    """The JAX model with fp32 dense caches, so its ServeEngine's
    per-bucket write executable takes an fp32 prefill's caches (the
    pools stay bf16 in both packages)."""

    def init_decode_state(self, batch, s_max):
        return jax.tree.map(lambda t: t.astype(jnp.float32),
                            super().init_decode_state(batch, s_max))


def test_serve_engine_tokens_match_jax_engine():
    """Continuous batching over more requests than slots: per-request
    greedy tokens identical to the JAX ServeEngine (fp32)."""
    _, jp, tm, tp = _both("float32")
    jm = _JaxF32Caches(cfg=jax_smoke(ARCH))
    stream = RequestStream(tm.cfg, buckets=(8, 16), max_new=4, seed=7)
    jeng = JaxServeEngine(jm, jp, **ENGINE)
    teng = ServeEngine(tm, tp, **ENGINE)
    for eng in (jeng, teng):
        eng.warmup()
        for r in stream.requests(5):
            eng.submit(r)
    want = {d.req_id: d.tokens for d in jeng.run()}
    frozen = teng.cache.misses
    got = {d.req_id: d.tokens for d in teng.run()}
    assert teng.cache.misses == frozen == 5
    assert teng.cache.keys == [("decode",), ("prefill", 8), ("prefill", 16),
                               ("write", 8), ("write", 16)]
    assert got.keys() == want.keys() and len(got) == 5
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")
    assert teng.alloc.free_pages == teng.alloc.n_pages - 1


def _serve(model, params, n_replicas, schedule=None, n_requests=8):
    inj = (ScriptedInjector(schedule, n_groups=n_replicas)
           if schedule else None)
    srv = ReplicaServer(model, params, n_replicas=n_replicas, injector=inj,
                        engine_kwargs=ENGINE)
    srv.warmup()
    frozen = srv.recompiles
    stream = RequestStream(model.cfg, buckets=(8, 16), max_new=4, seed=7)
    for r in stream.requests(n_requests):
        srv.submit(r)
    done = srv.run()
    assert srv.recompiles == frozen, "replica masking caused a rebuild"
    return srv, {d.req_id: d.tokens for d in done}


@pytest.mark.parametrize("schedule,kinds", [
    ({2: [1]}, ["kill"]),                              # one replica dies
    ({1: [0], 3: [1, 2]}, ["kill", "kill", "wipeout"]),  # then the rest
])
def test_replica_kill_drops_nothing_and_reruns_bit_identically(schedule,
                                                               kinds):
    model = build_model(smoke_config(ARCH), device="cpu")
    params = model.init(0)
    _, want = _serve(model, params, 3)
    srv, got = _serve(model, params, 3, schedule)
    assert [e.kind for e in srv.events] == kinds
    assert sum(e.requeued for e in srv.events) > 0
    assert srv.dropped == 0
    assert got.keys() == want.keys() and len(got) == 8
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_serve_cli_runs_on_the_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "6",
                    "--kill", "2:0"])
    out = capsys.readouterr().out
    assert '"completed_requests": 6' in out and '"kill"' in out
    assert serve_cli.parse_kill("6:0,1;9:2") == {6: [0, 1], 9: [2]}
