"""The SSM (Mamba-2) serving slice of the port against the JAX package, on
the CPU.

The same inputs (numpy, from a seed) and the same parameters (the JAX
model's init, carried over leaf for leaf by ``params_from_numpy``) go
through both packages. Tolerances:

* the K4 plain version against the Pallas kernel in interpret mode and
  the token-by-token ``ssd_scan_ref``: fp32 y and state within 1e-5 of
  the largest |ref| (summation order; measured ~1e-6); bf16 y within one
  bf16 ulp of the largest |ref| (fp32 math in another order, then one
  rounding to bf16);
* the Mamba mixer (prefill with its cache, then decode steps): fp32
  within 1e-4 (summation order through the projections, the scan and the
  gated norm); bf16 within 0.05 on outputs of magnitude ~1 (a few bf16
  ulps: the two frameworks round elementwise bf16 ops differently);
* the smoke mamba2 model's prefill logits, caches and paged decode
  logits: fp32 within 1e-4, bf16 within 0.1, as for the dense family;
* the ``ServeEngine``'s greedy tokens: identical (fp32); a
  ``ReplicaServer`` through scripted kills: zero drops, no rebuild, the
  tokens of the healthy run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.kernels.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ref import ssd_scan_ref as jax_ssd_ref
from repro.models import ssm as jssm
from repro.models.model import Model as JaxModel
from repro.models.model import build_model as jax_build
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import make_cache_writer as jax_cache_writer
from repro_torch.configs import smoke_config
from repro_torch.data import RequestStream
from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model, params_from_numpy, ssm
from repro_torch.models.model import segments_of
from repro_torch.serve import (ReplicaServer, ServeEngine, make_cache_writer,
                               pool_pages_for)
from repro_torch.train import ScriptedInjector

ARCH = "mamba2-1.3b"
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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close_to_largest(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


# ------------------------------------------------------------------ #
# K4: the plain version                                              #
# ------------------------------------------------------------------ #
def _scan_inputs(b, h, g, s, p, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, h, s)).astype(np.float32),
            np.log(np.arange(1, h + 1)).astype(np.float32),
            rng.normal(size=(b, g, s, n)).astype(np.float32),
            rng.normal(size=(b, g, s, n)).astype(np.float32))


@pytest.mark.parametrize("b,h,g,s,p,n,chunk", [
    (1, 2, 1, 128, 32, 64, 64),     # the shapes of tests/test_kernels.py
    (2, 4, 2, 256, 64, 128, 128),
    (1, 4, 4, 128, 32, 16, 32),
    (1, 2, 1, 159, 16, 32, 256),    # ragged: one chunk of 159
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_pallas_and_ref(b, h, g, s, p, n, chunk,
                                               dtype):
    x, dt, a_log, bb, cc = _scan_inputs(b, h, g, s, p, n)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jx, jb, jc = (jnp.asarray(v, jd) for v in (x, bb, cc))
    y_k, st_k = jax_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a_log), jb,
                             jc, chunk=chunk, interpret=True)
    rep = h // g
    y_r, st_r = jax_ssd_ref(jx, jnp.asarray(dt), -jnp.exp(a_log),
                            jnp.repeat(jb, rep, 1), jnp.repeat(jc, rep, 1))
    td = getattr(torch, dtype)
    y, st = ops.ssd_scan(_t(_f32(jx), td), _t(dt), _t(a_log),
                         _t(_f32(jb), td), _t(_f32(jc), td), chunk=chunk)
    assert y.dtype == td and st.dtype == torch.float32
    assert ops.launches["ssd_scan"] == 0          # the CPU runs no kernel
    y_tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for want_y, want_st in ((y_k, st_k), (y_r, st_r)):
        _close_to_largest(y, want_y, y_tol)
        _close_to_largest(st, want_st, 1e-5)


def test_ssd_scan_plain_is_chunk_invariant():
    """Chunks of 32, 128 and one of 256 give the same answer: the state
    handoff between chunks is right."""
    x, dt, a_log, bb, cc = (_t(v) for v in _scan_inputs(1, 2, 1, 256, 32,
                                                          64, seed=1))
    y0, s0 = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=256)
    for chunk in (32, 128):
        y, st = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=chunk)
        _close_to_largest(y, y0, 1e-5)
        _close_to_largest(st, s0, 1e-5)


def test_ssd_scan_takes_the_model_layout_through_strides():
    """The model's (B, S, H, P) / (B, S, G, N) tensors, transposed and
    cut from one wider activation (as ``mamba_forward`` passes them),
    give exactly the contiguous call's result."""
    x, dt, a_log, bb, cc = (_t(v) for v in _scan_inputs(2, 4, 2, 64, 16,
                                                          32, seed=2))
    want = ops.ssd_scan(x, dt, a_log, bb, cc, chunk=32)
    # one (B, S, H*P + 2*G*N) activation, as the conv output holds them
    act = torch.cat([x.transpose(1, 2).reshape(2, 64, -1),
                     bb.transpose(1, 2).reshape(2, 64, -1),
                     cc.transpose(1, 2).reshape(2, 64, -1)], dim=-1)
    xs = act[..., :64].reshape(2, 64, 4, 16).transpose(1, 2)
    bs = act[..., 64:128].reshape(2, 64, 2, 32).transpose(1, 2)
    cs = act[..., 128:].reshape(2, 64, 2, 32).transpose(1, 2)
    dts = dt.transpose(1, 2).contiguous().transpose(1, 2)
    assert not xs.is_contiguous() and not dts.is_contiguous()
    got = ops.ssd_scan(xs, dts, a_log, bs, cs, chunk=32)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ssd_scan_rejects_bad_shapes_and_chunks():
    x, dt, a_log, bb, cc = (_t(v) for v in _scan_inputs(1, 4, 2, 96, 16,
                                                          16))
    with pytest.raises(ValueError, match="chunk"):
        ops.ssd_scan(x, dt, a_log, bb, cc, chunk=64)     # 96 % 64
    with pytest.raises(ValueError, match="H % G"):
        ops.ssd_scan(x, dt, a_log, bb[:, :1].expand(1, 3, 96, 16),
                     cc[:, :1].expand(1, 3, 96, 16), chunk=32)
    with pytest.raises(ValueError, match="dt"):
        ops.ssd_scan(x, dt[..., :64], a_log, bb, cc, chunk=32)
    y, _ = ssd_scan_ref(x, dt, -torch.exp(a_log), bb, cc, 32)
    assert tuple(y.shape) == (1, 4, 96, 16)


# ------------------------------------------------------------------ #
# the Mamba mixer                                                    #
# ------------------------------------------------------------------ #
MIXER_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=5e-2, rtol=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_and_decode_match_jax(dtype):
    """A prefill of 64 tokens (two chunks of 32, so the carried state is
    exercised) with its cache, then three decode steps from it."""
    _, _, jp = _jax_model()
    cfg_j = jax_smoke(ARCH)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    blk_j = jax.tree.map(lambda a: a[0].astype(jd) if a.dtype == jnp.bfloat16
                         else a[0], jp["segments"][0][0]["mamba"])
    blk_t = params_from_numpy(jax.tree.map(np.asarray, blk_j), "cpu")
    cfg_t = smoke_config(ARCH)
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 64, cfg_t.d_model)), jd)
    xt = _t(_f32(x), getattr(torch, dtype))

    jo, jc = jssm.mamba_forward(x, blk_j, cfg_j, return_cache=True)
    to, tc = ssm.mamba_forward(xt, blk_t, cfg_t, return_cache=True)
    assert to.dtype == xt.dtype and tc.conv.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(to), _f32(jo), **MIXER_TOL[dtype])
    for a, b in zip(jc, tc):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(_f32(b), _f32(a), **MIXER_TOL[dtype])
    for _ in range(3):
        step = jnp.asarray(rng.normal(size=(2, 1, cfg_t.d_model)), jd)
        jo, jc = jssm.mamba_decode(step, blk_j, cfg_j, jc)
        to, tc = ssm.mamba_decode(_t(_f32(step), getattr(torch, dtype)),
                                  blk_t, cfg_t, tc)
        assert str(tc.conv.dtype).replace("torch.", "") == str(jc.conv.dtype)
        np.testing.assert_allclose(_f32(to), _f32(jo), **MIXER_TOL[dtype])
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(_f32(b), _f32(a), **MIXER_TOL[dtype])


def test_softplus_is_jax_softplus():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port spells it so
    (torch's ``F.softplus`` is the identity above 20). The two agree
    within 2e-7 relative (the frameworks' ``exp``/``log1p`` differ in the
    last bit); below about -87 JAX flushes the subnormal result to 0."""
    x = np.concatenate([np.linspace(-30, 30, 601),
                        [-100.0, 19.9, 20.0, 20.1, 88.0]]).astype(np.float32)
    got = ssm._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=2e-7, atol=1e-37)


# ------------------------------------------------------------------ #
# the model                                                          #
# ------------------------------------------------------------------ #
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
             "bfloat16": dict(atol=1e-1, rtol=0)}


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
    # the deterministic leaves equal the JAX init's (a_log = log(1..H)
    # within the two frameworks' last-bit difference in ``log``)
    for name in ("a_log", "d_skip", "dt_bias", "conv_b", "gate_norm"):
        np.testing.assert_allclose(
            tp["segments"][0][0]["mamba"][name].numpy(),
            np.asarray(jp["segments"][0][0]["mamba"][name]),
            rtol=2e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_paged_decode_match_jax(dtype):
    """Two prompts (a full chunk of 32 plus 8, and 16) prefilled, written
    into slots 1 and 0 of the paged state, then four decode steps."""
    jm, jp, tm, tp = _both(dtype)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, 64, dtype=np.int32),
               rng.integers(0, cfg.vocab, 16, dtype=np.int32)]
    n_pages, ps, steps = 40, 4, 4
    slots = [1, 0]
    table = np.zeros((2, 17), np.int32)
    jpools = jm.init_paged_state(2, n_pages, ps)
    tpools = tm.init_paged_state(2, n_pages, ps)
    jwrite, twrite = jax_cache_writer(jm), make_cache_writer(tm)

    tok = np.zeros(2, np.int32)
    for prompt, slot in zip(prompts, slots):
        jl, jd = jm.prefill(jp, tokens=jnp.asarray(prompt[None]))
        tl, td = tm.prefill(tp, torch.from_numpy(prompt[None]).long())
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL[dtype])
        for a, b in zip(jax.tree_util.tree_leaves(jd),
                        jax.tree_util.tree_leaves(td)):
            assert tuple(b.shape) == a.shape
            np.testing.assert_allclose(_f32(b), _f32(a), **LOGIT_TOL[dtype])
        pages = np.array([1], np.int32)
        jpools = jwrite(jpools, jd, jnp.asarray(pages), jnp.int32(slot))
        twrite(tpools, td, torch.from_numpy(pages).long(), slot)
        tok[slot] = int(np.argmax(np.asarray(jl[0, -1, :cfg.vocab])))

    pos = np.array([16, 64], np.int32)
    for _ in range(steps):
        jl, jpools = jm.decode_step_paged(
            jp, jpools, jnp.asarray(table), jnp.asarray(pos),
            tokens=jnp.asarray(tok[:, None]))
        tl, _ = tm.decode_step_paged(
            tp, tpools, torch.from_numpy(table).long(),
            torch.from_numpy(pos).long(),
            torch.from_numpy(tok[:, None]).long())
        np.testing.assert_allclose(_f32(tl), _f32(jl), **LOGIT_TOL[dtype])
        tok = np.argmax(np.asarray(jl[:, 0, :cfg.vocab]), -1).astype(np.int32)
        pos += 1
    for a, b in zip(jax.tree_util.tree_leaves(jpools),
                    jax.tree_util.tree_leaves(tpools)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(_f32(b), _f32(a), **LOGIT_TOL[dtype])


def test_state_layouts_and_the_families_the_port_has():
    model = build_model(smoke_config(ARCH), device="cpu")
    assert segments_of(model.cfg) == [(("mamba",), 2)]
    _, state = model.prefill(model.init(2), torch.zeros(3, 32).long())
    flat = lambda t: jax.tree_util.tree_leaves(  # noqa: E731
        t, is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = model.init_decode_state(3, 32)
    assert [(tuple(a.shape), a.dtype) for a in flat(state)] == \
        [(tuple(b.shape), b.dtype) for b in flat(want)]
    conv, st = model.init_paged_state(5, 9, 4)[0][0]
    s = model.cfg.ssm
    assert tuple(conv.shape) == (2, 5, s.conv_width - 1, 2 * 64 + 2 * 16)
    assert conv.dtype == torch.float32      # holds bf16 tails exactly
    assert tuple(st.shape) == (2, 5, 16, s.head_dim, s.d_state)


# ------------------------------------------------------------------ #
# engine and replicas                                                #
# ------------------------------------------------------------------ #
ENGINE = dict(n_slots=2, page_size=4, max_new=4, buckets=(8, 16),
              n_pages=pool_pages_for(2, 16 + 4, 4))


class _JaxF32Pools(JaxModel):
    """The JAX model with an fp32 conv pool: its fp32 decode promotes the
    conv window to fp32 (a bf16 tail concatenated with fp32 rows), so its
    ServeEngine's decode executable, compiled for bf16 pools, would be
    called with fp32 ones at the second step. The port's paged conv
    window is fp32 for the same reason."""

    def init_paged_state(self, n_slots, n_pages, page_size):
        st = super().init_paged_state(n_slots, n_pages, page_size)
        return [tuple(c._replace(conv=c.conv.astype(jnp.float32))
                      for c in seg) for seg in st]


def test_serve_engine_tokens_match_jax_engine():
    """Continuous batching over more requests than slots: per-request
    greedy tokens identical to the JAX ServeEngine (fp32)."""
    _, jp, tm, tp = _both("float32")
    jm = _JaxF32Pools(cfg=jax_smoke(ARCH))
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
    assert got.keys() == want.keys() and len(got) == 5
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")


def _serve(model, params, schedule=None):
    inj = ScriptedInjector(schedule, n_groups=3) if schedule else None
    srv = ReplicaServer(model, params, n_replicas=3, injector=inj,
                        engine_kwargs=ENGINE)
    srv.warmup()
    frozen = srv.recompiles
    for r in RequestStream(model.cfg, buckets=(8, 16), max_new=4,
                           seed=7).requests(8):
        srv.submit(r)
    done = srv.run()
    assert srv.recompiles == frozen, "replica masking caused a rebuild"
    return srv, {d.req_id: d.tokens for d in done}


def test_replica_kill_drops_nothing_and_reruns_bit_identically():
    model = build_model(smoke_config(ARCH), device="cpu")
    params = model.init(0)
    _, want = _serve(model, params)
    srv, got = _serve(model, params, {1: [0], 3: [1, 2]})
    assert [e.kind for e in srv.events] == ["kill", "kill", "wipeout"]
    assert sum(e.requeued for e in srv.events) > 0
    assert srv.dropped == 0
    assert got.keys() == want.keys() and len(got) == 8
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_serve_cli_runs_mamba_on_the_cpu(capsys):
    serve_cli.main(["--arch", ARCH, "--device", "cpu", "--requests", "6",
                    "--kill", "3:0"])
    out = capsys.readouterr().out
    assert '"completed_requests": 6' in out and '"kill"' in out
    assert '"arch": "mamba2-1.3b"' in out
