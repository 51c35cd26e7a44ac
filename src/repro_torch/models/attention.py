"""Attention: GQA and DeepSeek MLA, the full-sequence prefill and
one-token decode against a dense or a paged cache — the PyTorch
counterparts of ``repro.models.attention``.

GQA prefill attention goes through :func:`repro_torch.kernels.ops.
flash_attention` (the K2 kernel on a CUDA tensor, its plain version on a
CPU one), where the JAX model calls its plain ``attend_chunked``: both
compute causal GQA attention with an fp32 softmax. Both GQA decodes stay
plain PyTorch: the JAX package has no kernel for them.

MLA (multi-head latent attention) is the JAX package's *absorbed*
latent-space form, spelled op for op as its plain einsums spell it: the
keys are never expanded to (H, dh). The JAX package has no kernel for
it, so neither does the port; only its RMSNorms (``kv_norm``, and
``q_norm`` where queries are compressed) go through K1.

On a model group of ``M`` ranks (the FSDP x TP step, ``build_model(cfg,
mesh=...)``), :func:`gqa_forward_tp` and :func:`gqa_decode_tp` run GQA
on a rank's ``n_heads / M`` query heads (:func:`tp_heads`): with its own
KV columns where ``M`` divides ``n_kv_heads``; otherwise each rank holds
a part of a KV head, so ``wk`` and ``wv`` are gathered over the group
and the rank takes the one KV head its query heads read. The decode
cache holds every KV head on every model rank (``cache_specs``
replicates it over ``model``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import torch

from repro_torch.dist.collectives import all_gather_dim, gather
from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import apply_rope, rmsnorm
from .remat import dot

__all__ = ["gqa_forward", "KVCache", "init_gqa_cache", "init_gqa_pool",
           "paged_view", "gqa_decode", "gqa_decode_paged", "MLACache",
           "init_mla_cache", "init_mla_pool", "mla_forward", "mla_decode",
           "mla_decode_paged", "tp_heads", "gqa_forward_tp",
           "gqa_decode_tp"]

_NEG_INF = -2.0 ** 20  # large-but-finite: keeps bf16/softmax NaN-free


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, KV*n_rep, dh) by head repetition."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, S_max, KV, dh) or a pool (n_pages, PS, KV, dh)
    v: torch.Tensor


def init_gqa_cache(cfg: ModelConfig, batch: int, s_max: int, *,
                   device: torch.device | str,
                   dtype=torch.bfloat16) -> KVCache:
    shape = (batch, s_max, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _qkv(x: torch.Tensor, p: dict, cfg: ModelConfig):
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = dot(x, p["wq"])
    k = dot(x, p["wk"])
    v = dot(x, p["wv"])
    if cfg.qkv_bias:
        # the bias is cast to the activation dtype before the add
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    return (q.reshape(b, s, cfg.n_heads, dh),
            k.reshape(b, s, cfg.n_kv_heads, dh),
            v.reshape(b, s, cfg.n_kv_heads, dh))


def gqa_forward(x: torch.Tensor, p: dict, cfg: ModelConfig,
                positions: torch.Tensor | None = None,
                return_kv: bool = False):
    """Full-sequence causal GQA. x: (B, S, D) -> (B, S, D).

    ``return_kv`` also returns the decode-cache contents, the post-rope,
    pre-repeat ``KVCache(k, v)`` of shape (B, S, KV, dh): the fused
    cache-filling prefill. The flash kernel reads the (B, S, H, dh)
    projections through strides, so nothing is transposed or repeated.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = _qkv(x, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    y = dot(out.transpose(1, 2).reshape(b, s, -1), p["wo"])
    if return_kv:
        return y, KVCache(k, v)
    return y


def tp_heads(cfg: ModelConfig, model_rank: int,
             model_degree: int) -> tuple[int, int, int, bool]:
    """A model rank's heads: ``(query heads, its first KV head, its KV
    heads, whether wk and wv are gathered)``. Query heads ``[m * H / M,
    (m + 1) * H / M)``; where ``M`` divides the KV heads, the rank's own
    ``KV / M`` of them; where ``KV`` divides ``M``, the one KV head its
    query heads read."""
    h, kv, m = cfg.n_heads, cfg.n_kv_heads, model_degree
    if h % m or (kv % m and m % kv):
        raise NotImplementedError(
            f"{cfg.name}: {h} query and {kv} KV heads on a model group of "
            f"{m} (ROADMAP.md §1: the dense families whose heads do not "
            f"divide the model degree)")
    hl = h // m
    if kv % m == 0:
        return hl, model_rank * (kv // m), kv // m, False
    return hl, model_rank * hl // (h // kv), 1, True


def _tp_local(p: dict, cfg: ModelConfig, group, model_rank: int,
              model_degree: int, prefix: str) -> tuple[dict, ModelConfig]:
    """The rank's attention leaves and its config of local heads: the
    query and output blocks, the KV columns (gathered and cut to one
    head where the rank holds a part of one), the biases' slices."""
    hl, kv0, kvl, gathered = tp_heads(cfg, model_rank, model_degree)
    dh = cfg.resolved_head_dim
    wk, wv = p["wk"], p["wv"]
    if gathered:
        wk = gather(wk, -1, group, f"{prefix}.wk")[:, kv0 * dh:
                                                   (kv0 + 1) * dh]
        wv = gather(wv, -1, group, f"{prefix}.wv")[:, kv0 * dh:
                                                   (kv0 + 1) * dh]
    local = {"wq": p["wq"], "wk": wk, "wv": wv, "wo": p["wo"]}
    if cfg.qkv_bias:
        q0 = model_rank * hl * dh
        local["bq"] = p["bq"][q0:q0 + hl * dh]
        local["bk"] = p["bk"][kv0 * dh:(kv0 + kvl) * dh]
        local["bv"] = p["bv"][kv0 * dh:(kv0 + kvl) * dh]
    return local, replace(cfg, n_heads=hl, n_kv_heads=kvl, head_dim=dh)


def _all_heads(t: torch.Tensor, cfg: ModelConfig, group,
               model_degree: int, source: str) -> torch.Tensor:
    """Every KV head of ``t`` ((B, S, kv_local, dh) on each model rank)
    on every rank: gathered along the head axis, one copy each of a
    head that several ranks hold."""
    full = all_gather_dim(t, 2, group, source)
    step = max(1, model_degree // cfg.n_kv_heads)
    return full[:, :, ::step] if step > 1 else full


def gqa_forward_tp(h: torch.Tensor, p: dict, cfg: ModelConfig,
                   positions: torch.Tensor, group, model_rank: int,
                   model_degree: int, return_kv: bool = False,
                   prefix: str = "attn"):
    """:func:`gqa_forward` on this model rank's heads: ``h`` (B, S, D)
    whole (after Megatron's f), ``p`` the rank's blocks (``wq`` and
    ``wk``/``wv`` columns, ``wo`` rows) and the whole biases. Returns
    the partial output (B, S, D), to be summed over ``group`` (g); with
    ``return_kv`` also the cache contents of every KV head."""
    local, lcfg = _tp_local(p, cfg, group, model_rank, model_degree,
                            prefix)
    out = gqa_forward(h, local, lcfg, positions, return_kv=return_kv)
    if not return_kv:
        return out
    y, kv = out
    return y, KVCache(*(_all_heads(t, cfg, group, model_degree,
                                   f"{prefix}.kv") for t in kv))


def gqa_decode_tp(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  cache: KVCache, pos, group, model_rank: int,
                  model_degree: int, prefix: str = "attn"):
    """:func:`gqa_decode` on this model rank's heads over a cache of
    every KV head: the new k and v of every head (gathered over
    ``group``) written at ``pos``, the rank's query heads against the KV
    heads they read. Returns ``(partial y (B, 1, D), cache)``."""
    b = x.shape[0]
    local, lcfg = _tp_local(p, cfg, group, model_rank, model_degree,
                            prefix)
    _, kv0, kvl, _ = tp_heads(cfg, model_rank, model_degree)
    q, k_new, v_new = _qkv(x, local, lcfg)
    at = torch.as_tensor(pos, dtype=torch.long, device=x.device).reshape(1)
    posb = at[None].expand(b, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    k_new, v_new = (_all_heads(t, cfg, group, model_degree, f"{prefix}.kv")
                    for t in (k_new, v_new))
    cache.k.index_copy_(1, at, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, at, v_new.to(cache.v.dtype))
    valid = torch.arange(cache.k.shape[1], device=x.device) <= at
    return _attend_one(q, cache.k[:, :, kv0:kv0 + kvl],
                       cache.v[:, :, kv0:kv0 + kvl], valid, local,
                       lcfg), cache


def _attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor, p: dict,
                cfg: ModelConfig) -> torch.Tensor:
    """One query token per row against its cache: q (B, 1, H, dh); k, v
    (B, S, KV, dh); ``valid`` broadcasts to the (B, H, 1, S) scores.
    Returns the projected output (B, 1, D)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kh = _repeat_kv(k, n_rep).to(q.dtype)
    vh = _repeat_kv(v, n_rep).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kh) * \
        cfg.resolved_head_dim ** -0.5
    # fp32 before the mask and the softmax: masked scores underflow to 0.0
    scores = torch.where(valid, scores.to(torch.float32), _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return torch.matmul(out.reshape(q.shape[0], 1, -1), p["wo"])


def gqa_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, cache: KVCache,
               pos: int | torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against a dense cache, every row at one position.

    x: (B, 1, D); cache leaves: (B, S_max, KV, dh), as
    :func:`init_gqa_cache` makes them; pos: a Python int or a 0-d integer
    tensor, the position every row generates. The new k and v are
    written into the cache at ``pos`` in place (the JAX package returns
    an updated copy instead), and the query attends to keys ``<= pos``.
    Returns ``(y (B, 1, D), cache)``.
    """
    b = x.shape[0]
    q, k_new, v_new = _qkv(x, p, cfg)
    at = torch.as_tensor(pos, dtype=torch.long, device=x.device).reshape(1)
    posb = at[None].expand(b, 1)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    cache.k.index_copy_(1, at, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, at, v_new.to(cache.v.dtype))
    valid = torch.arange(cache.k.shape[1], device=x.device) <= at
    return _attend_one(q, cache.k, cache.v, valid, p, cfg), cache


def init_gqa_pool(cfg: ModelConfig, n_pages: int, page_size: int, *,
                  device: torch.device | str,
                  dtype=torch.bfloat16) -> KVCache:
    """Physical page pool for paged decode: (n_pages, PS, KV, dh) leaves.

    Page 0 is the *trash page*: inactive decode slots carry an all-zero
    block table and pos 0, so their per-step write lands there and their
    gather reads it — fully masked. The allocator never hands it out.
    """
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def paged_view(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Gather each row's logical cache from the physical pool.

    pool: (n_pages, PS, *tail); table: (B, M) page ids. Returns
    (B, M*PS, *tail). Rows past ``pos`` hold stale or trash data; the
    decode mask scores them at -2^20 and the fp32 softmax underflows them
    to exactly 0.0.
    """
    b, m = table.shape
    g = pool.index_select(0, table.reshape(-1))
    return g.reshape(b, m * pool.shape[1], *pool.shape[2:])


def _paged_write(pool: torch.Tensor, new: torch.Tensor, table: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Write one new token row per sequence into its current page, in
    place (the JAX package returns an updated copy instead).

    new: (B, *tail), token ``pos[b]`` of row b. Live sequences own
    distinct pages, so the writes collide only on the trash page, where
    any winner is fine: it is never read unmasked.
    """
    ps = pool.shape[1]
    page = torch.gather(table, 1, (pos // ps)[:, None])[:, 0]
    pool[page, pos % ps] = new.to(pool.dtype)
    return pool


def gqa_decode_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     pool: KVCache, table: torch.Tensor,
                     pos: torch.Tensor) -> tuple[torch.Tensor, KVCache]:
    """One-token decode against a paged KV pool, per-row positions.

    x: (B, 1, D); pool leaves: (n_pages, PS, KV, dh), updated in place;
    table: (B, M) page ids; pos: (B,) — row b generates token ``pos[b]``.
    A row's result depends only on its own table row and position, never
    on its slot or the other rows: what makes a requeued request re-run
    bit-identically.
    """
    q, k_new, v_new = _qkv(x, p, cfg)
    posb = pos[:, None]
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    k_pool = _paged_write(pool.k, k_new[:, 0], table, pos)
    v_pool = _paged_write(pool.v, v_new[:, 0], table, pos)

    valid = (torch.arange(table.shape[1] * pool.k.shape[1],
                          device=x.device)[None] <= pos[:, None])
    y = _attend_one(q, paged_view(k_pool, table), paged_view(v_pool, table),
                    valid[:, None, None, :], p, cfg)
    return y, KVCache(k_pool, v_pool)


# ------------------------------------------------------------------ #
# MLA (DeepSeek multi-head latent attention)                          #
# ------------------------------------------------------------------ #
class MLACache(NamedTuple):
    """The compressed cache: the latent c_kv and the one rope key that
    every head shares, kv_lora + d_rope values a token (576 at
    deepseek's widths) instead of heads x dh."""
    c_kv: torch.Tensor    # (B, S_max, kv_lora) or a pool (n_pages, PS, kv_lora)
    k_rope: torch.Tensor  # (B, S_max, d_rope) or a pool (n_pages, PS, d_rope)


def init_mla_cache(cfg: ModelConfig, batch: int, s_max: int, *,
                   device: torch.device | str,
                   dtype=torch.bfloat16) -> MLACache:
    return MLACache(
        torch.zeros((batch, s_max, cfg.kv_lora_rank), dtype=dtype,
                    device=device),
        torch.zeros((batch, s_max, cfg.mla_d_rope), dtype=dtype,
                    device=device))


def init_mla_pool(cfg: ModelConfig, n_pages: int, page_size: int, *,
                  device: torch.device | str,
                  dtype=torch.bfloat16) -> MLACache:
    """Physical page pool for paged MLA decode, the compressed rows of
    :class:`MLACache` by page; page 0 is the trash page, as in
    :func:`init_gqa_pool`."""
    return init_mla_cache(cfg, n_pages, page_size, device=device,
                          dtype=dtype)


def _mla_q(x: torch.Tensor, p: dict, cfg: ModelConfig,
           positions: torch.Tensor):
    """The queries' no-rope and rope halves, (B, S, H, d_nope) and (B,
    S, H, d_rope): through ``wq``, or compressed through ``wq_a``, its
    RMSNorm ``q_norm`` and ``wq_b`` when ``q_lora_rank`` is set."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.mla_d_nope, cfg.mla_d_rope
    if cfg.q_lora_rank:
        cq = rmsnorm(dot(x, p["wq_a"]), p["q_norm"], cfg.norm_eps)
        q = dot(cq, p["wq_b"])
    else:
        q = dot(x, p["wq"])
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _mla_kv(x: torch.Tensor, p: dict, cfg: ModelConfig,
            positions: torch.Tensor):
    """The cache's contents: one product by ``wkv_a`` split into the
    latent, normed by ``kv_norm``, and the shared rope key, rotated."""
    r = cfg.kv_lora_rank
    ckv = dot(x, p["wkv_a"])                 # (B, S, r + d_rope)
    # the latent is a strided slice of the product; K1 on the card takes
    # contiguous rows only
    c_kv = rmsnorm(ckv[..., :r].contiguous(), p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., None, r:], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_attend(q_nope, q_rope, c_kv, k_rope, p: dict, cfg: ModelConfig,
                mask: torch.Tensor | None) -> torch.Tensor:
    """Latent-space attention: q_nope is absorbed through ``wk_b``, so
    the key of every head is the latent c_kv (plus the shared rope key)
    and the value is c_kv too, expanded through ``wv_b`` after the
    softmax. The roundings follow the JAX package's compiled program
    (its forward maps a compiled chunk; its model scans its layers): each
    score product rounded to the activation dtype, their sum and the
    scale (d_nope + d_rope)^-0.5 in fp32 (XLA folds the cast to fp32
    into the activation-dtype add, so the sum is never rounded), the
    mask at -2^20, an fp32 softmax cast back.
    ``mask`` broadcasts to the (B, H, Sq, Sk) scores. A cache in another
    dtype than the queries (a bf16 pool in an fp32 run) is read in the
    queries' dtype, as JAX's promotion reads it. Returns (B, Sq, H*d_v).
    """
    b, s_q = q_nope.shape[:2]
    h, dn, dv = cfg.n_heads, cfg.mla_d_nope, cfg.mla_d_v
    r = cfg.kv_lora_rank
    c_kv = c_kv.to(q_nope.dtype)
    k_rope = k_rope.to(q_rope.dtype)
    wk = p["wk_b"].reshape(r, h, dn)
    wv = p["wv_b"].reshape(r, h, dv)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, wk)
    scores = torch.einsum("bqhl,bkl->bhqk", q_lat, c_kv).to(torch.float32)
    scores = scores + torch.einsum("bqhd,bkd->bhqk", q_rope,
                                   k_rope).to(torch.float32)
    scores = scores * (dn + cfg.mla_d_rope) ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_nope.dtype)
    o_lat = torch.einsum("bhqk,bkl->bqhl", probs, c_kv)
    out = torch.einsum("bqhl,lhd->bqhd", o_lat, wv)
    return out.reshape(b, s_q, h * dv)


def mla_forward(x: torch.Tensor, p: dict, cfg: ModelConfig,
                positions: torch.Tensor | None = None, chunk: int = 512,
                return_kv: bool = False):
    """Full-sequence causal MLA. x: (B, S, D) -> (B, S, D).

    Query-chunked as the JAX package chunks it: ``min(chunk, S)`` queries
    at a time against every key, so the fp32 scores are (B, H, chunk, S);
    S must be a multiple of the chunk. ``return_kv`` also returns
    ``MLACache(c_kv, k_rope)`` of shape (B, S, ...): the compressed rows
    :func:`mla_decode` would have cached token by token.
    """
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q_nope, q_rope = _mla_q(x, p, cfg, positions)
    c_kv, k_rope = _mla_kv(x, p, cfg, positions)
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"mla_forward: seq {s} is not a multiple of the "
                         f"query chunk {chunk}")
    kpos = torch.arange(s, device=x.device)
    outs = []
    for lo in range(0, s, chunk):
        qpos = lo + torch.arange(chunk, device=x.device)
        mask = (qpos[:, None] >= kpos[None, :])[None, None]
        outs.append(_mla_attend(q_nope[:, lo:lo + chunk],
                                q_rope[:, lo:lo + chunk], c_kv, k_rope, p,
                                cfg, mask))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    y = dot(out, p["wo"])
    if return_kv:
        return y, MLACache(c_kv, k_rope)
    return y


def mla_decode(x: torch.Tensor, p: dict, cfg: ModelConfig, cache: MLACache,
               pos: int | torch.Tensor) -> tuple[torch.Tensor, MLACache]:
    """One-token MLA decode against a dense compressed cache, every row
    at one position.

    x: (B, 1, D); cache leaves (B, S_max, ...), as :func:`init_mla_cache`
    makes them; pos a Python int or a 0-d integer tensor. The new rows
    are written into the cache at ``pos`` in place (the JAX package
    returns an updated copy instead), and the query attends to keys
    ``<= pos``. Returns ``(y (B, 1, D), cache)``.
    """
    b = x.shape[0]
    at = torch.as_tensor(pos, dtype=torch.long, device=x.device).reshape(1)
    posb = at[None].expand(b, 1)
    q_nope, q_rope = _mla_q(x, p, cfg, posb)
    c_new, kr_new = _mla_kv(x, p, cfg, posb)
    cache.c_kv.index_copy_(1, at, c_new.to(cache.c_kv.dtype))
    cache.k_rope.index_copy_(1, at, kr_new.to(cache.k_rope.dtype))
    kpos = torch.arange(cache.c_kv.shape[1], device=x.device)
    mask = (at[:, None] >= kpos[None, :])[None, None]
    out = _mla_attend(q_nope, q_rope, cache.c_kv, cache.k_rope, p, cfg, mask)
    return torch.matmul(out, p["wo"]), cache


def mla_decode_paged(x: torch.Tensor, p: dict, cfg: ModelConfig,
                     pool: MLACache, table: torch.Tensor,
                     pos: torch.Tensor) -> tuple[torch.Tensor, MLACache]:
    """One-token MLA decode against a paged compressed-latent pool, per-row
    positions: the contract of :func:`gqa_decode_paged` (table (B, M)
    page ids, pos (B,), page 0 the trash page, the pools updated in
    place)."""
    posb = pos[:, None]
    q_nope, q_rope = _mla_q(x, p, cfg, posb)
    c_new, kr_new = _mla_kv(x, p, cfg, posb)
    c_pool = _paged_write(pool.c_kv, c_new[:, 0], table, pos)
    r_pool = _paged_write(pool.k_rope, kr_new[:, 0], table, pos)
    c_kv = paged_view(c_pool, table)                  # (B, M*PS, kv_lora)
    kpos = torch.arange(c_kv.shape[1], device=x.device)
    mask = (posb[:, :, None] >= kpos[None, None, :])[:, None]
    out = _mla_attend(q_nope, q_rope, c_kv, paged_view(r_pool, table), p,
                      cfg, mask)
    return torch.matmul(out, p["wo"]), MLACache(c_pool, r_pool)
