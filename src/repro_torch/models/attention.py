"""GQA attention: the full-sequence prefill through the flash kernel, and
one-token decode against a dense or a paged cache — the PyTorch
counterparts of the GQA half of ``repro.models.attention``.

Prefill attention goes through :func:`repro_torch.kernels.ops.
flash_attention` (the K2 kernel on a CUDA tensor, its plain version on a
CPU one), where the JAX model calls its plain ``attend_chunked``: both
compute causal GQA attention with an fp32 softmax. Both decodes stay
plain PyTorch: the JAX package has no kernel for them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import apply_rope

__all__ = ["gqa_forward", "KVCache", "init_gqa_cache", "init_gqa_pool",
           "paged_view", "gqa_decode", "gqa_decode_paged"]

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
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
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
    y = torch.matmul(out.transpose(1, 2).reshape(b, s, -1), p["wo"])
    if return_kv:
        return y, KVCache(k, v)
    return y


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
