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
on a rank's part of the heads (:func:`tp_heads`). Where ``M`` divides
the query heads and the KV heads divide ``M`` or are divided by it, a
rank runs ``n_heads / M`` query heads: with its own KV columns where
``M`` divides ``n_kv_heads`` (``kv_own``); otherwise each rank holds a
part of a KV head, so ``wk`` and ``wv`` are gathered over the group and
the rank takes the one KV head its query heads read (``kv_part``).

Elsewhere (``padded``: starcoder2-7b's 36 heads, minitron-4b's 24,
qwen2-vl-2b's 12 and musicgen-medium's 24 at a model degree of 16) the
rule table splits ``wq``, ``wk`` and ``wv`` into even column blocks,
which cut heads (2.25 a rank for starcoder2 at 16), and the JAX model's
``head_constrain`` pins q, k and v to ``P(dp, None, "model", None)``,
which GSPMD honours for a head count ``M`` does not divide by padding
the head axis to ``ceil(H / M) * M``. The port runs ``ceil(H / M)``
heads a rank with the padding left out (a padding head is zeros in
JAX's program and adds nothing), so the last ranks' blocks are cut at
``H`` and a rank past it (ranks 12 to 15 of starcoder2 at 16) holds
none. Each rank computes its column blocks of q, k and v, all-gathers
each whole over the model group and keeps the columns of its heads and
of the KV heads they read (:func:`~repro_torch.dist.collectives.
gather_cols`); the output, in head blocks, goes to ``wo``'s row blocks
by one all-to-all (:func:`~repro_torch.dist.collectives.reshard_cols`),
then the row-parallel product and the all-reduce over the model group
(g). Backward, each is the other's transpose: the output's gradient is
all-gathered and cut to the rank's heads, and dq, dk and dv go back to
their column blocks by one all-to-all each (summed where several ranks
read one KV head). A rank with no head launches no kernel; its empty
output is cut from q, k and v, so that its backward runs the
collectives the others run. Where a rank's query heads cut a KV group
unevenly (minitron at 16: 2 heads a rank, groups of 3), the kernel reads
one KV head per query head.

That is GSPMD's program where every query head has its own KV head, as
the compiled HLO of JAX's jitted step shows: on a (2, 2) mesh with 3
heads, 7 all-gathers and 5 collective permutes a layer (its backward
and recomputed forward included) where the port runs 7 all-gathers
and 5 all-to-alls (``tests/test_torch_fsdp_tp_families.py``); at 16,
musicgen-medium's 24 heads, 7 all-gathers and 29 permutes
(``tools/gspmd_head_collectives.py``). Where KV heads are fewer, GSPMD
reshards the repeated k and v otherwise: starcoder2-7b, minitron-4b and
qwen2-vl-2b at 16 add 13 all-gathers, 9 all-to-alls, 28 to 32 permutes
and an all-reduce a layer. The port keeps the program above there too,
which computes the same values; the collectives, and the dry run's
collective bytes of those cells, are the port's own.

The decode cache holds every KV head on every model rank
(``cache_specs`` replicates it over ``model``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import torch

from repro_torch.dist.collectives import (all_gather_dim, gather,
                                          gather_cols, reshard_cols)
from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import apply_rope, rmsnorm
from .remat import dot

__all__ = ["gqa_forward", "KVCache", "init_gqa_cache", "init_gqa_pool",
           "paged_view", "gqa_decode", "gqa_decode_paged", "MLACache",
           "init_mla_cache", "init_mla_pool", "mla_forward", "mla_decode",
           "mla_decode_paged", "TPHeads", "tp_heads", "check_tp_heads",
           "gqa_forward_tp", "gqa_decode_tp"]

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


class TPHeads(NamedTuple):
    """A model rank's part of the heads (:func:`tp_heads`)."""

    q0: int               # its first query head
    n: int                # its query heads; 0 on a rank of padding only
    kv: tuple[int, ...]   # the KV heads they read, in the kernel's order
    split: str            # "kv_own", "kv_part" or "padded" (module doc)


def _local_kv(q0: int, n: int, group: int) -> tuple[int, ...]:
    """The KV heads that query heads ``[q0, q0 + n)`` read (head ``h``
    reads KV head ``h // group``), in the order the flash kernel takes
    them: local query head ``i`` reads local KV head ``i // (n / len)``.
    Where the query heads cut a group unevenly, one KV head per query
    head (repeated)."""
    ids = [(q0 + i) // group for i in range(n)]
    uniq = sorted(set(ids))
    if n and n % len(uniq) == 0 and all(
            uniq[i // (n // len(uniq))] == ids[i] for i in range(n)):
        return tuple(uniq)
    return tuple(ids)


def tp_heads(cfg: ModelConfig, model_rank: int,
             model_degree: int) -> TPHeads:
    """A model rank's heads. Where ``M`` divides the query heads and the
    KV heads divide, or are divided by, ``M``: query heads ``[m * H / M,
    (m + 1) * H / M)``, with the rank's own ``KV / M`` KV columns
    (``kv_own``) or the one KV head its query heads read (``kv_part``).
    Otherwise GSPMD's padded head blocks (``padded``): ``ceil(H / M)``
    heads a rank, the last ranks' blocks cut at ``H`` (a rank past it
    holds none)."""
    h, kv, m = cfg.n_heads, cfg.n_kv_heads, model_degree
    group = h // kv
    if h % m == 0 and (kv % m == 0 or m % kv == 0):
        n = h // m
        q0 = model_rank * n
        return TPHeads(q0, n, _local_kv(q0, n, group),
                       "kv_own" if kv % m == 0 else "kv_part")
    per = -(-h // m)
    q0 = min(model_rank * per, h)
    n = min(per, h - q0)
    return TPHeads(q0, n, _local_kv(q0, n, group), "padded")


def check_tp_heads(cfg: ModelConfig, model_degree: int) -> None:
    """Raise unless the rule table splits the attention's columns over a
    model group of ``model_degree`` (the padded head blocks reshard the
    rank's column blocks; a projection the table leaves whole would need
    a gradient summed over the model group as well)."""
    dh = cfg.resolved_head_dim
    for name, n in (("wq/wo", cfg.n_heads), ("wk/wv", cfg.n_kv_heads)):
        if (n * dh) % model_degree:
            raise NotImplementedError(
                f"{cfg.name}: {name} ({n} heads of {dh}) do not split into "
                f"{model_degree} column blocks")


def _tp_local(p: dict, cfg: ModelConfig, group, model_rank: int,
              model_degree: int, prefix: str) -> tuple[dict, ModelConfig]:
    """The rank's attention leaves and its config of local heads, for
    the ``kv_own`` and ``kv_part`` splits: the query and output blocks,
    the KV columns (gathered and cut to one head where the rank holds a
    part of one), the biases' slices."""
    t = tp_heads(cfg, model_rank, model_degree)
    dh = cfg.resolved_head_dim
    kv0, kvl = t.kv[0], len(t.kv)
    wk, wv = p["wk"], p["wv"]
    if t.split == "kv_part":
        wk = gather(wk, -1, group, f"{prefix}.wk")[:, kv0 * dh:
                                                   (kv0 + 1) * dh]
        wv = gather(wv, -1, group, f"{prefix}.wv")[:, kv0 * dh:
                                                   (kv0 + 1) * dh]
    local = {"wq": p["wq"], "wk": wk, "wv": wv, "wo": p["wo"]}
    if cfg.qkv_bias:
        q0 = t.q0 * dh
        local["bq"] = p["bq"][q0:q0 + t.n * dh]
        local["bk"] = p["bk"][kv0 * dh:(kv0 + kvl) * dh]
        local["bv"] = p["bv"][kv0 * dh:(kv0 + kvl) * dh]
    return local, replace(cfg, n_heads=t.n, n_kv_heads=kvl, head_dim=dh)


def _all_heads(t: torch.Tensor, cfg: ModelConfig, group,
               model_degree: int, source: str) -> torch.Tensor:
    """Every KV head of ``t`` ((B, S, kv_local, dh) on each model rank)
    on every rank: gathered along the head axis, one copy each of a
    head that several ranks hold."""
    full = all_gather_dim(t, 2, group, source)
    step = max(1, model_degree // cfg.n_kv_heads)
    return full[:, :, ::step] if step > 1 else full


def _column_blocks(n_cols: int, model_degree: int) -> list[tuple[int, int]]:
    """The rule table's column blocks of ``n_cols`` columns."""
    c = n_cols // model_degree
    return [(r * c, (r + 1) * c) for r in range(model_degree)]


def _head_blocks(cfg: ModelConfig, model_degree: int
                 ) -> list[tuple[int, int]]:
    """Each rank's columns of the attention output under the padded
    head blocks (its real heads only)."""
    dh = cfg.resolved_head_dim
    out = []
    for r in range(model_degree):
        t = tp_heads(cfg, r, model_degree)
        out.append((t.q0 * dh, (t.q0 + t.n) * dh))
    return out


def _kv_keep(cfg: ModelConfig, model_degree: int,
             whole: bool) -> list[tuple[int, int]]:
    """Each rank's columns of k and v under the padded head blocks: the
    KV heads its query heads read (none on a rank past ``H``), or every
    KV head (``whole``: what the decode cache holds)."""
    dh = cfg.resolved_head_dim
    if whole:
        return [(0, cfg.n_kv_heads * dh)] * model_degree
    out = []
    for r in range(model_degree):
        kv = tp_heads(cfg, r, model_degree).kv
        out.append((kv[0] * dh, (kv[-1] + 1) * dh) if kv else (0, 0))
    return out


def _padded_qkv(x: torch.Tensor, p: dict, cfg: ModelConfig, group,
                model_rank: int, model_degree: int, prefix: str,
                whole_kv: bool):
    """The padded split's projections: each rank's column blocks of q, k
    and v (and the biases' slices), gathered whole over ``group`` and
    cut to the rank's heads (GSPMD's all-gathers; the gradient goes back
    to the blocks by one all-to-all, GSPMD's permutes). Returns ``(q of
    the rank's heads (B, S, n, dh), k, v of the KV heads it keeps (B, S,
    kv, dh; :func:`_kv_keep`), the first of those)``."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    kv_keep = _kv_keep(cfg, model_degree, whole_kv)
    outs = []
    for name, n, keep in (("q", cfg.n_heads, _head_blocks(cfg, model_degree)),
                          ("k", cfg.n_kv_heads, kv_keep),
                          ("v", cfg.n_kv_heads, kv_keep)):
        blocks = _column_blocks(n * dh, model_degree)
        y = dot(x, p[f"w{name}"])
        if cfg.qkv_bias:
            lo, hi = blocks[model_rank]
            y = y + p[f"b{name}"][lo:hi].to(y.dtype)
        y = gather_cols(y, blocks, keep, group, f"{prefix}.{name}")
        outs.append(y.reshape(b, s, -1, dh))
    return (*outs, kv_keep[model_rank][0] // dh)


def _take_kv(k: torch.Tensor, ids: tuple[int, ...]) -> torch.Tensor:
    """KV heads ``ids`` of k (B, S, KV, dh), a view where they run in
    order."""
    lo = ids[0]
    if list(ids) == list(range(lo, lo + len(ids))):
        return k[:, :, lo:lo + len(ids)]
    return k[:, :, list(ids)]


def _padded_out(out: torch.Tensor, p: dict, cfg: ModelConfig, group,
                model_degree: int, prefix: str) -> torch.Tensor:
    """The attention output of the rank's heads (B, S, n * dh) moved to
    ``wo``'s row block (one all-to-all: GSPMD's collective permutes of
    the columns that cross blocks; the gradient comes back gathered
    whole, GSPMD's all-gather) and projected: the partial sum, to be
    summed over ``group`` (g)."""
    cols = cfg.n_heads * cfg.resolved_head_dim
    out = reshard_cols(out, _head_blocks(cfg, model_degree),
                       _column_blocks(cols, model_degree), group,
                       f"{prefix}.out")
    return dot(out, p["wo"])


def gqa_forward_tp(h: torch.Tensor, p: dict, cfg: ModelConfig,
                   positions: torch.Tensor, group, model_rank: int,
                   model_degree: int, return_kv: bool = False,
                   prefix: str = "attn"):
    """:func:`gqa_forward` on this model rank's heads: ``h`` (B, S, D)
    whole (after Megatron's f), ``p`` the rank's blocks (``wq`` and
    ``wk``/``wv`` columns, ``wo`` rows) and the whole biases. Returns
    the partial output (B, S, D), to be summed over ``group`` (g); with
    ``return_kv`` also the cache contents of every KV head."""
    t = tp_heads(cfg, model_rank, model_degree)
    if t.split != "padded":
        local, lcfg = _tp_local(p, cfg, group, model_rank, model_degree,
                                prefix)
        out = gqa_forward(h, local, lcfg, positions, return_kv=return_kv)
        if not return_kv:
            return out
        y, kv = out
        return y, KVCache(*(_all_heads(x, cfg, group, model_degree,
                                       f"{prefix}.kv") for x in kv))
    b, s, _ = h.shape
    q, k, v, k0 = _padded_qkv(h, p, cfg, group, model_rank, model_degree,
                              prefix, whole_kv=return_kv)
    k = apply_rope(k, positions, cfg.rope_theta)
    if t.n:
        q = apply_rope(q, positions, cfg.rope_theta)
        ids = tuple(i - k0 for i in t.kv)
        out = ops.flash_attention(
            q.transpose(1, 2), _take_kv(k, ids).transpose(1, 2),
            _take_kv(v, ids).transpose(1, 2), causal=True)
        out = out.transpose(1, 2).reshape(b, s, -1)
    else:
        # padding only: no kernel. The empty block is cut from q, k and
        # v, so that the backward reaches their all-to-alls and the
        # output's all-gather on this rank too, as on the others
        out = torch.cat([x.flatten(2)[..., :0] for x in (q, k, v)], -1)
    y = _padded_out(out, p, cfg, group, model_degree, prefix)
    return (y, KVCache(k, v)) if return_kv else y


def _decode_at(x: torch.Tensor, pos) -> tuple[torch.Tensor, torch.Tensor]:
    """The decode's position as a (1,) index and as (B, 1) positions."""
    at = torch.as_tensor(pos, dtype=torch.long, device=x.device).reshape(1)
    return at, at[None].expand(x.shape[0], 1)


def _cache_attend(q: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, cache: KVCache, at: torch.Tensor,
                  t: TPHeads, cfg: ModelConfig) -> torch.Tensor:
    """The new k and v of every KV head written into ``cache`` at
    ``at``; the rank's query heads ``q`` against the KV heads ``t.kv``
    they read, before the output projection: (B, 1, n * dh)."""
    cache.k.index_copy_(1, at, k_new.to(cache.k.dtype))
    cache.v.index_copy_(1, at, v_new.to(cache.v.dtype))
    if not t.n:         # padding only: nothing to attend
        return q.new_zeros((q.shape[0], 1, 0))
    valid = torch.arange(cache.k.shape[1], device=q.device) <= at
    return _attend_heads(q, _take_kv(cache.k, t.kv), _take_kv(cache.v, t.kv),
                         valid, replace(cfg, n_heads=t.n,
                                        n_kv_heads=len(t.kv),
                                        head_dim=cfg.resolved_head_dim))


def gqa_decode_tp(x: torch.Tensor, p: dict, cfg: ModelConfig,
                  cache: KVCache, pos, group, model_rank: int,
                  model_degree: int, prefix: str = "attn"):
    """:func:`gqa_decode` on this model rank's heads over a cache of
    every KV head: the new k and v of every head (gathered over
    ``group``) written at ``pos``, the rank's query heads against the KV
    heads they read. Returns ``(partial y (B, 1, D), cache)``."""
    t = tp_heads(cfg, model_rank, model_degree)
    if t.split == "padded":
        return _padded_decode(x, p, cfg, cache, pos, group, model_rank,
                              model_degree, prefix)
    at, posb = _decode_at(x, pos)
    local, lcfg = _tp_local(p, cfg, group, model_rank, model_degree,
                            prefix)
    q, k_new, v_new = _qkv(x, local, lcfg)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new, v_new = (_all_heads(y, cfg, group, model_degree, f"{prefix}.kv")
                    for y in (apply_rope(k_new, posb, cfg.rope_theta),
                              v_new))
    out = _cache_attend(q, k_new, v_new, cache, at, t, cfg)
    return torch.matmul(out, p["wo"]), cache


def _padded_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                   cache: KVCache, pos, group, model_rank: int,
                   model_degree: int, prefix: str):
    """:func:`gqa_decode_tp` under the padded head blocks."""
    t = tp_heads(cfg, model_rank, model_degree)
    at, posb = _decode_at(x, pos)
    q, k_new, v_new, _ = _padded_qkv(x, p, cfg, group, model_rank,
                                     model_degree, prefix, whole_kv=True)
    out = _cache_attend(apply_rope(q, posb, cfg.rope_theta),
                        apply_rope(k_new, posb, cfg.rope_theta), v_new,
                        cache, at, t, cfg)
    return _padded_out(out, p, cfg, group, model_degree, prefix), cache


def _attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                valid: torch.Tensor, p: dict,
                cfg: ModelConfig) -> torch.Tensor:
    """One query token per row against its cache: q (B, 1, H, dh); k, v
    (B, S, KV, dh); ``valid`` broadcasts to the (B, H, 1, S) scores.
    Returns the projected output (B, 1, D)."""
    return torch.matmul(_attend_heads(q, k, v, valid, cfg), p["wo"])


def _attend_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """:func:`_attend_one` before the output projection: (B, 1, H * dh)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kh = _repeat_kv(k, n_rep).to(q.dtype)
    vh = _repeat_kv(v, n_rep).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kh) * \
        cfg.resolved_head_dim ** -0.5
    # fp32 before the mask and the softmax: masked scores underflow to 0.0
    scores = torch.where(valid, scores.to(torch.float32), _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return out.reshape(q.shape[0], 1, -1)


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
