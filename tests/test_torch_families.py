"""The two-matrix MLPs (gelu, relu2) and the ``embeds=`` frontends of the
port against the JAX package, on the CPU, at the smoke sizes of
starcoder2-7b (gelu), minitron-4b (relu2), qwen2-vl-2b (vlm frontend,
QKV bias, tied head), musicgen-medium (audio frontend, gelu, MHA) and
glm4-9b (SwiGLU, GQA group 16 at full width).

The same parameters (the JAX model's init, carried over leaf for leaf by
``params_from_numpy``) and the same inputs (numpy, from a seed) go
through both packages. Tolerances:

* the MLP activations: bf16 gelu and relu2 bit-identical to
  ``jax.nn.gelu`` and ``jnp.square(jax.nn.relu(.))``; fp32 gelu within
  1e-6 of the larger of |x| and |gelu(x)| (XLA's CPU ``tanh`` is an
  approximation of its own; where 1 + tanh cancels the output is small
  next to the input, and the gap is relative to the input);
* logits: fp32 within 1e-5 (summation order through two layers); bf16
  within 0.1 on logits of magnitude ~1 (``tests/test_torch_serve.py``'s:
  JAX's plain attention rounds scores and probabilities to bf16 where
  the port keeps fp32);
* prefill and paged decode in fp32: logits within 1e-4, as
  ``tests/test_torch_serve.py`` holds them, and greedy tokens identical;
* the embeds gate: ``forward(embeds=embed[tokens])`` equal to
  ``forward(tokens)`` bit for bit in bf16.
"""
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.dist.collectives import bucket_layout as jax_bucket_layout
from repro.models.layers import mlp2 as jax_mlp2
from repro.models.model import build_model as jax_build
from repro.serve import make_cache_writer as jax_cache_writer
from repro_torch.configs import smoke_config
from repro_torch.dist import bucket_layout, tree_leaves
from repro_torch.launch import serve as serve_cli
from repro_torch.data import RequestStream
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.layers import gelu, mlp2
from repro_torch.serve import ReplicaServer, make_cache_writer, \
    pool_pages_for
from repro_torch.train import ScriptedInjector
from repro_torch.train.step import accumulator_specs

ARCHS = ["starcoder2-7b", "minitron-4b", "qwen2-vl-2b", "musicgen-medium",
         "glm4-9b"]
FRONTENDS = ["qwen2-vl-2b", "musicgen-medium"]
LOGIT_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
             "bfloat16": dict(atol=1e-1, rtol=0)}
_JAX: dict = {}


def _jax_model(arch: str):
    if arch not in _JAX:
        cfg = jax_smoke(arch)
        model = jax_build(cfg)
        _JAX[arch] = (model, model.init(jax.random.key(0)))
    return _JAX[arch]


def _both(arch: str, dtype: str):
    """(jax model, jax params, port model, port params) in ``dtype``."""
    jm, jp = _jax_model(arch)
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tm = build_model(smoke_config(arch), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@contextmanager
def _one_thread():
    """Run torch's CPU kernels on the calling thread alone. Split over
    worker threads, the first fp32 ``torch.tanh`` of a fresh process can
    return one thread's chunk (16,384 elements) about 1,500 ulps off:
    that thread ran MKL's AVX2 tanh in its lowest accuracy mode (EP) in
    place of the AVX-512 one in the high accuracy mode torch asks for,
    bit for bit (``tools/mkl_tanh_race.py``). The fault is MKL's, not
    the spelling's, and these checks are about the spelling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _spread(n: int, seed: int) -> np.ndarray:
    """``n`` fp32 values over the range an MLP's pre-activations take,
    and then some: normal of scale 3, plus the tails out to +-12."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * 3.0
    x[: n // 16] = rng.uniform(-12.0, 12.0, n // 16)
    return x


# ------------------------------------------------------------------ #
# the MLP activations                                                #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind", ["gelu", "relu2"])
def test_bf16_activation_is_bit_identical_to_jax(kind):
    """Over 131,072 bf16 inputs, eager and under ``jax.jit``. Identity
    weights make ``mlp2``'s products exact (but for the sign of a zero,
    which the second product's sum drops in both packages), so its output
    is the activation's; bit for bit against JAX's ``mlp2`` with the same
    weights, and the gelu on its own bit for bit against
    ``jax.nn.gelu``."""
    x = jnp.asarray(_spread(1 << 17, 0)).astype(jnp.bfloat16)
    if kind == "gelu":
        act = jax.nn.gelu
    else:
        act = lambda h: jnp.square(jax.nn.relu(h))  # noqa: E731
    want = [act(x), jax.jit(act)(x)]
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16)
    bits = lambda t: t.view(torch.int16).numpy()  # noqa: E731
    eye = torch.eye(8, dtype=torch.bfloat16)
    with _one_thread():
        alone = gelu(xt)
        got = mlp2(xt.reshape(-1, 8), eye, eye, kind=kind).reshape(-1)
    if kind == "gelu":
        for w in want:
            np.testing.assert_array_equal(bits(alone),
                                          np.asarray(w).view(np.int16))
    for w in want:
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(w, np.float32))
    jeye = jnp.eye(8, dtype=jnp.bfloat16)
    for fn in (jax_mlp2, jax.jit(jax_mlp2, static_argnums=3)):
        np.testing.assert_array_equal(
            bits(got), np.asarray(fn(x.reshape(-1, 8), jeye, jeye,
                                     kind)).reshape(-1).view(np.int16))


def test_fp32_gelu_is_within_1e_6_of_jax():
    x = _spread(1 << 17, 1)
    want = np.asarray(jax.jit(jax.nn.gelu)(jnp.asarray(x)))
    with _one_thread():
        got = gelu(torch.from_numpy(x)).numpy()
    scale = np.maximum(np.abs(want), np.abs(x))
    assert (np.abs(got - want) <= 1e-6 * scale).all()


def test_unknown_mlp_kind_raises_as_in_jax():
    x = torch.zeros(2, 4)
    w = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="unknown mlp kind 'swish'"):
        mlp2(x, w, w, kind="swish")
    with pytest.raises(ValueError, match="unknown mlp kind 'swish'"):
        jax_mlp2(jnp.zeros((2, 4)), jnp.zeros((4, 4)), jnp.zeros((4, 4)),
                 "swish")


# ------------------------------------------------------------------ #
# parameters                                                         #
# ------------------------------------------------------------------ #
def test_build_model_takes_the_five_configs():
    """On the CPU every one builds; on ``cuda`` the family check passes
    and only the missing card stops it."""
    for arch in ARCHS:
        assert build_model(smoke_config(arch), device="cpu").cfg.name == \
            smoke_config(arch).name
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_model(smoke_config(arch), device="cuda")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_jax_tree_layout(arch):
    """Same leaf paths, shapes and dtypes as the JAX model's init: the
    two-matrix MLP's ``w_in`` and ``w_out``, the QKV biases of
    qwen2-vl-2b, the untied heads."""
    _, jp = _jax_model(arch)
    tp = build_model(smoke_config(arch), device="cpu").init(0)
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        tp, is_leaf=lambda t: isinstance(t, torch.Tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (_, a), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == a.shape
        assert str(t.dtype).replace("torch.", "") == str(a.dtype)
    mlp = tp["segments"][0][0]["mlp"]
    want = (["w_in", "w_out"] if smoke_config(arch).mlp_kind != "swiglu"
            else ["w_gate", "w_up", "w_down"])
    assert list(mlp) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_and_the_bucket_layout_keep_the_leaf_order(arch):
    """``params_from_numpy`` carries every leaf bit for bit, and the
    gradient buckets laid over the port's tree (in the JAX package's
    sorted-key order) equal the JAX package's layout of its own tree:
    leaf shapes, dtypes, bucket of each leaf, offsets, bucket sizes."""
    _, jp = _jax_model(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl, tl = jax.tree.leaves(jp), tree_leaves(tp)
    assert len(jl) == len(tl)
    for a, t in zip(jl, tl):
        want = np.asarray(a)
        got = t.numpy() if t.dtype != torch.bfloat16 else \
            t.view(torch.int16).numpy().view(want.dtype)
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
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


# ------------------------------------------------------------------ #
# forward, prefill, paged decode                                     #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, dtype):
    """A batch of two: token logits (fp32 and bf16); in bf16 a frontend
    config is fed float32 ``embeds`` (B, S, D) instead, as its batches
    carry them."""
    jm, jp, tm, tp = _both(arch, dtype)
    rng = np.random.default_rng(12)
    if dtype == "bfloat16" and arch in FRONTENDS:
        emb = (rng.standard_normal((2, 12, tm.cfg.d_model)) * 0.02).astype(
            np.float32)
        want = jm.forward(jp, embeds=jnp.asarray(emb))
        got = tm.forward(tp, embeds=torch.from_numpy(emb))
    else:
        tokens = rng.integers(0, tm.cfg.vocab, (2, 12), dtype=np.int32)
        want = jm.forward(jp, tokens=jnp.asarray(tokens))
        got = tm.forward(tp, torch.from_numpy(tokens).long())
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **LOGIT_TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_paged_decode_match_jax(arch):
    """Two prompts prefilled into pools through a scrambled block table,
    then paged decode steps in fp32: logits within 1e-4 and every greedy
    token identical to the JAX model's."""
    jm, jp, tm, tp = _both(arch, "float32")
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 16, dtype=np.int32),
               rng.integers(0, cfg.vocab, 8, dtype=np.int32)]
    n_pages, ps, steps = 16, 4, 4
    table = np.array([[9, 2, 14, 5, 11, 0], [3, 12, 7, 0, 0, 0]], np.int32)
    jpools = jm.init_paged_state(2, n_pages, ps)
    tpools = tm.init_paged_state(2, n_pages, ps)
    jwrite, twrite = jax_cache_writer(jm), make_cache_writer(tm)
    tol = dict(atol=1e-4, rtol=1e-4)
    tok = np.zeros(2, np.int32)
    for row, prompt in enumerate(prompts):
        jl, jd = jm.prefill(jp, tokens=jnp.asarray(prompt[None]))
        tl, td = tm.prefill(tp, torch.from_numpy(prompt[None]).long())
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
        pages = table[row, :-(-(len(prompt) + steps) // ps)]
        jpools = jwrite(jpools, jd, jnp.asarray(pages), jnp.int32(row))
        twrite(tpools, td, torch.from_numpy(pages).long(), row)
        tok[row] = int(np.argmax(np.asarray(jl[0, -1, :cfg.vocab])))
        assert int(tl[0, -1, :cfg.vocab].argmax()) == tok[row]
    pos = np.array([len(p) for p in prompts], np.int32)
    for _ in range(steps):
        jl, jpools = jm.decode_step_paged(
            jp, jpools, jnp.asarray(table), jnp.asarray(pos),
            tokens=jnp.asarray(tok[:, None]))
        tl, _ = tm.decode_step_paged(
            tp, tpools, torch.from_numpy(table).long(),
            torch.from_numpy(pos).long(),
            tokens=torch.from_numpy(tok[:, None]).long())
        np.testing.assert_allclose(_f32(tl), _f32(jl), **tol)
        tok = np.argmax(np.asarray(jl[:, 0, :cfg.vocab]), -1).astype(np.int32)
        np.testing.assert_array_equal(
            tl[:, 0, :cfg.vocab].argmax(-1).numpy(), tok)
        pos += 1


@pytest.mark.parametrize("arch", FRONTENDS)
def test_embeds_prefill_and_decode_match_jax(arch):
    """bf16 ``embeds`` through the cache-filling prefill and then the
    dense decode step (scalar position) and the paged one: logits within
    the bf16 tolerance of the JAX model's."""
    jm, jp, tm, tp = _both(arch, "bfloat16")
    d = tm.cfg.d_model
    rng = np.random.default_rng(5)
    emb = (rng.standard_normal((1, 10, d)) * 0.02).astype(np.float32)
    step = (rng.standard_normal((1, 1, d)) * 0.02).astype(np.float32)
    jl, jd = jm.prefill(jp, embeds=jnp.asarray(emb))
    tl, td = tm.prefill(tp, embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL["bfloat16"])
    jstate = jax.tree.map(lambda big, small: big.at[:, :, :10].set(small),
                          jm.init_decode_state(1, 12), jd)
    tstate = tm.init_decode_state(1, 12)
    for big, small in zip(tree_leaves(tstate), tree_leaves(td)):
        big[:, :, :10].copy_(small)
    jl, _ = jm.decode_step(jp, jstate, jnp.int32(10),
                           embeds=jnp.asarray(step))
    tl, _ = tm.decode_step(tp, tstate, 10, embeds=torch.from_numpy(step))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL["bfloat16"])

    table = np.array([[3, 1, 4]], np.int32)
    jpools = jax_cache_writer(jm)(jm.init_paged_state(1, 6, 4), jd,
                                  jnp.asarray(table[0]), jnp.int32(0))
    tpools = tm.init_paged_state(1, 6, 4)
    make_cache_writer(tm)(tpools, td, torch.from_numpy(table[0]).long(), 0)
    jl, _ = jm.decode_step_paged(jp, jpools, jnp.asarray(table),
                                 jnp.asarray([10], jnp.int32),
                                 embeds=jnp.asarray(step))
    tl, _ = tm.decode_step_paged(tp, tpools, torch.from_numpy(table).long(),
                                 torch.tensor([10]),
                                 embeds=torch.from_numpy(step))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL["bfloat16"])


@pytest.mark.parametrize("arch", FRONTENDS)
def test_fp32_params_with_embeds_raise_as_the_reference_does(arch):
    """The JAX model cannot run ``embeds`` with fp32 weights (its layer
    scan's carry is bf16, the first block returns fp32); the port says
    so instead of running what the reference cannot."""
    jm, jp, tm, tp = _both(arch, "float32")
    emb = np.zeros((1, 4, tm.cfg.d_model), np.float32)
    with pytest.raises(TypeError, match="carry"):
        jm.forward(jp, embeds=jnp.asarray(emb))
    e = torch.from_numpy(emb)
    for call in (lambda: tm.forward(tp, embeds=e),
                 lambda: tm.prefill(tp, embeds=e),
                 lambda: tm.decode_step(tp, tm.init_decode_state(1, 4), 0,
                                        embeds=e[:, :1])):
        with pytest.raises(ValueError, match="the JAX model raises here"):
            call()
    with pytest.raises(ValueError, match="pass tokens or embeds"):
        tm.forward(tp)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_embeds_of_the_token_rows_give_the_token_logits_bit_for_bit(arch):
    """In bf16 the embedding rows of the tokens, as float32 ``embeds``,
    give the token path's logits bit for bit: through the forward, the
    cache-filling prefill and a dense decode step."""
    _, _, tm, tp = _both(arch, "bfloat16")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, tm.cfg.vocab, (2, 9)))
    emb = tp["embed"][tokens].float()
    same = lambda a, b: torch.equal(a.view(torch.int16),  # noqa: E731
                                    b.view(torch.int16))
    with torch.no_grad():
        assert same(tm.forward(tp, embeds=emb), tm.forward(tp, tokens))
        (lt, st), (le, se) = tm.prefill(tp, tokens), tm.prefill(tp,
                                                                embeds=emb)
        assert same(lt, le)
        for a, b in zip(tree_leaves(st), tree_leaves(se)):
            assert same(a, b)
        state, state2 = tm.init_decode_state(2, 10), \
            tm.init_decode_state(2, 10)
        for big, big2, small in zip(tree_leaves(state), tree_leaves(state2),
                                    tree_leaves(st)):
            big[:, :, :9].copy_(small)
            big2[:, :, :9].copy_(small)
        nxt = lt[:, -1, :tm.cfg.vocab].argmax(-1)[:, None]
        a, _ = tm.decode_step(tp, state, 9, nxt)
        b, _ = tm.decode_step(tp, state2, 9,
                              embeds=tp["embed"][nxt].float())
        assert same(a, b)


# ------------------------------------------------------------------ #
# serving                                                            #
# ------------------------------------------------------------------ #
ENGINE = dict(n_slots=2, page_size=4, max_new=4, buckets=(8, 16),
              n_pages=pool_pages_for(2, 16 + 4, 4))


def _serve(model, params, schedule=None):
    inj = ScriptedInjector(schedule, n_groups=3) if schedule else None
    srv = ReplicaServer(model, params, n_replicas=3, injector=inj,
                        engine_kwargs=ENGINE)
    srv.warmup()
    frozen = srv.recompiles
    stream = RequestStream(model.cfg, buckets=(8, 16), max_new=4, seed=7)
    for r in stream.requests(8):
        srv.submit(r)
    done = srv.run()
    assert srv.recompiles == frozen, "replica masking caused a rebuild"
    return srv, {d.req_id: d.tokens for d in done}


@pytest.mark.parametrize("arch", ["minitron-4b", "qwen2-vl-2b"])
def test_replica_kill_drops_nothing_and_reruns_bit_identically(arch):
    """The serve engine feeds tokens, so a frontend config serves through
    its embedding table, as in the JAX package."""
    model = build_model(smoke_config(arch), device="cpu")
    params = model.init(0)
    _, want = _serve(model, params)
    srv, got = _serve(model, params, {2: [1]})
    assert [e.kind for e in srv.events] == ["kill"]
    assert srv.dropped == 0
    assert got.keys() == want.keys() and len(got) == 8
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_serve_cli_kills_a_starcoder2_replica(capsys):
    serve_cli.main(["--arch", "starcoder2-7b", "--device", "cpu",
                    "--requests", "6", "--kill", "3:0"])
    out = capsys.readouterr().out
    assert '"arch": "starcoder2-7b"' in out
    assert '"completed_requests": 6' in out and '"kill"' in out
