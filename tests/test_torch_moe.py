"""The MoE FFN of the port (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU.

The same inputs (numpy, from a seed) and the same parameters (the JAX
package's ``_init_moe`` draw, carried over by ``params_from_numpy``) go
through both packages. Tolerances:

* ``route_topk``: the expert indices equal, the gate weights within 1e-6
  (fp32 router products summed in another order);
* ``expert_ffn_local`` in fp32, at an ample capacity and at one that
  drops slots: within 1e-6 of the largest |ref|, and the same slots
  dropped (the port's kept slots, run through JAX's function at an ample
  capacity, give JAX's output at the tight one);
* ``moe_ffn`` against JAX's ``moe_ffn_reference`` (what JAX's
  ``moe_ffn`` runs without a ``model`` mesh axis), with and without a
  shared expert: fp32 within 1e-5 of the largest |ref|; bf16 within
  2^-7 of the largest |ref|, one bf16 ulp of it: both packages round the
  same ops to bf16 (the expert products, silu, the gate weights, the
  combine) but sum the products in another order, so an element can
  land one ulp of its own magnitude away (measured: up to one ulp of
  the largest, 0.25 at 53.75);
* the gradients of ``moe_ffn`` (x, router, experts, shared expert)
  against ``jax.grad`` of the reference in fp32: within 1e-5 of each
  leaf's largest element.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro.models.model import _init_moe as jax_init_moe
from repro_torch.configs import smoke_config
from repro_torch.models import params_from_numpy
from repro_torch.models.moe import (_dispatch, expert_ffn_local, moe_ffn,
                                    moe_ffn_reference, route_topk)

JAMBA = "jamba-v0.1-52b"


def _cfgs(shared: bool):
    """The jamba smoke config (8 experts top-2, d 64, d_expert 32), with
    one shared expert (as deepseek's) when ``shared``."""
    jc, tc = jax_smoke(JAMBA), smoke_config(JAMBA)
    if shared:
        jc = jc.scaled(moe=replace(jc.moe, n_shared=1))
        tc = tc.scaled(moe=replace(tc.moe, n_shared=1))
    return jc, tc


def _params(jc, dtype: str, seed: int = 0):
    """(JAX params, port params) of one MoE layer in ``dtype`` (the fp32
    router stays fp32)."""
    jp = jax_init_moe(jax.random.key(seed), jc)
    jp = jax.tree.map(lambda a: a if a.dtype == jnp.float32
                      else a.astype(dtype), jp)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close_to_largest(got, want, tol: float):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (40, 16, 2), (33, 64, 6)])
def test_route_topk_matches_jax(t, e, k):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, 48)).astype(np.float32)
    w = (rng.standard_normal((48, e)) / np.sqrt(48)).astype(np.float32)
    jidx, jw = jmoe.route_topk(jnp.asarray(x), jnp.asarray(w), k)
    tidx, tw = route_topk(torch.from_numpy(x), torch.from_numpy(w), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("e_first,e_local,capacity", [
    (0, 8, 64),        # ample: nothing dropped
    (0, 8, 5),         # tight: slots past 5 of an expert dropped
    (4, 4, 6),         # the second of two expert ranks, tight
])
def test_expert_ffn_local_matches_jax(e_first, e_local, capacity):
    jc, _ = _cfgs(False)
    jp, tp = _params(jc, "float32")
    x = _x((48, jc.d_model))
    jidx, jw = jmoe.route_topk(jnp.asarray(x), jp["router"], jc.moe.top_k)
    idx, w = torch.from_numpy(np.array(jidx)).long(), \
        torch.from_numpy(np.array(jw))
    local = lambda ex: {n: a[e_first:e_first + e_local]  # noqa: E731
                        for n, a in ex.items()}
    want = jmoe.expert_ffn_local(jnp.asarray(x), jidx, jw,
                                 local(jp["experts"]), e_first, e_local,
                                 capacity)
    got = expert_ffn_local(torch.from_numpy(x), idx, w,
                           local(tp["experts"]), e_first, e_local, capacity)
    _close_to_largest(got.numpy(), want, 1e-6)

    _, keep = _dispatch(idx, e_first, e_local, capacity)
    routed_here = ((idx >= e_first) & (idx < e_first + e_local)).reshape(-1)
    dropped = int((routed_here & ~keep).sum())
    assert (dropped == 0) == (capacity == 64)
    # the same slots dropped: JAX at an ample capacity, fed only the
    # slots the port kept (the others weighted 0), gives JAX's output at
    # the tight capacity
    kept_w = jnp.asarray(np.where(keep.reshape(w.shape).numpy(),
                                  np.asarray(jw), 0.0))
    ample = jmoe.expert_ffn_local(jnp.asarray(x), jidx, kept_w,
                                  local(jp["experts"]), e_first, e_local,
                                  x.shape[0] * jc.moe.top_k)
    _close_to_largest(ample, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_matches_the_jax_reference(dtype, shared):
    """The grouped dispatch and the port's own dense oracle, each against
    JAX's ``moe_ffn_reference``, over several seeds; one batch is small
    enough (3 tokens: at most 6 of 8 experts) that some experts get no
    rows."""
    tol = {"float32": 1e-5, "bfloat16": 2.0 ** -7}[dtype]
    jc, tc = _cfgs(shared)
    for seed, shape in ((0, (2, 24)), (1, (1, 3)), (2, (4, 16))):
        jp, tp = _params(jc, dtype, seed)
        x = _x((*shape, jc.d_model), seed + 10)
        jx = jnp.asarray(x).astype(dtype)
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        want = np.asarray(jmoe.moe_ffn_reference(jx, jp, jc), np.float32)
        assert np.asarray(jmoe.moe_ffn(jx, jp, jc)).dtype == jx.dtype
        for fn in (moe_ffn, moe_ffn_reference):
            got = fn(tx, tp, tc)
            assert got.dtype == tx.dtype
            _close_to_largest(got.float().numpy(), want, tol)


@pytest.mark.parametrize("shared", [False, True])
def test_moe_ffn_gradients_match_jax(shared):
    """d/d(x, params) of <moe_ffn(x), cot> against ``jax.grad`` of the
    JAX reference, fp32: the gate weights' gradient reaches the router
    through the softmax of the top-k values."""
    jc, tc = _cfgs(shared)
    jp, tp = _params(jc, "float32", 3)
    x = _x((2, 20, jc.d_model), 4)
    cot = _x((2, 20, jc.d_model), 5)

    def loss(xx, pp):
        return jnp.sum(jmoe.moe_ffn_reference(xx, pp, jc) * cot)
    jgx, jgp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)

    tx = torch.from_numpy(x).requires_grad_()
    leaves = jax.tree_util.tree_flatten_with_path(jgp)[0]
    tp = jax.tree.map(lambda t: t.requires_grad_(), tp)
    (moe_ffn(tx, tp, tc) * torch.from_numpy(cot)).sum().backward()
    _close_to_largest(tx.grad.numpy(), jgx, 1e-5)
    for path, g in leaves:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.grad is not None, path
        _close_to_largest(t.grad.numpy(), g, 1e-5)
    assert {p[0].key for p, _ in leaves} == (
        {"router", "experts", "shared"} if shared else {"router", "experts"})


def test_moe_ffn_refuses_expert_parallelism(monkeypatch):
    """The expert-parallel body refuses a model group whose size does not
    divide the experts, as JAX's assert does (the group's size faked at
    3, before any collective); without a group the grouped dispatch
    runs."""
    from repro_torch.models import moe as moe_mod

    _, tc = _cfgs(False)
    _, tp = _params(_cfgs(False)[0], "float32")
    x = torch.zeros(1, 2, tc.d_model)
    assert moe_ffn(x, tp, tc).shape == x.shape
    monkeypatch.setattr(moe_mod.dist, "get_world_size", lambda g: 3)
    monkeypatch.setattr(moe_mod.dist, "get_rank", lambda g: 0)
    with pytest.raises(ValueError, match="not divisible by EP degree 3"):
        moe_ffn(x, tp, tc, group=object())
