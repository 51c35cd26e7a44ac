"""Model builder: config -> init / forward / prefill / dense and paged
decode, in PyTorch, for the dense GQA family (SwiGLU or a two-matrix
gelu / relu2 MLP, token or ``embeds=`` inputs), the SSM (Mamba-2)
family, the hybrid family (Jamba: a period of Mamba and GQA blocks,
each with a dense or MoE MLP) and the ``moe`` family (DeepSeek: MLA
attention, leading dense blocks, then MoE blocks with shared experts)
(the counterpart of ``repro.models.model``).

Parameters are kept as the JAX package keeps them: a dict tree with the
same leaf names, where ``params["segments"]`` is a list of
``(pattern, n_rep)`` segments, each a tuple of per-kind block dicts
whose leaves carry a leading ``n_rep`` axis. Where the JAX model scans
over that axis, the layer loop here takes each stacked leaf's layers
with one ``torch.unbind`` per forward (:func:`unbind_layers`): indexing
``leaf[i]`` once per layer would make every layer's backward allocate a
zero tensor the size of the whole stack. A segment may also be given
already unbound, as a list of per-layer block tuples (the train step
does that, to make each layer's weights leaves of their own). Caches and
page pools follow the same per-segment stacked layout: attention layers
hold ``KVCache`` page pools (``MLACache`` ones for MLA), Mamba layers
slot-dense ``MambaCache`` leaves (the slot is the page).

The training forward (:meth:`Model.forward`) recomputes each block in
the backward (``torch.utils.checkpoint``, as the JAX model's
``jax.checkpoint`` per scanned block) when the config asks for remat
and autograd is recording: all of it under the policy ``"nothing"``,
all but its products with no batch dimension under ``"dots"``
(:mod:`repro_torch.models.remat`).

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for the card without one raises (:func:`resolve_device`). A model on
``meta`` draws storage-free parameters: their shapes and dtypes, what
``jax.eval_shape`` of the JAX model's init gives.

``build_model(cfg, model_group=g)`` runs the MoE layers expert-parallel
over the model group ``g`` (:func:`repro_torch.models.moe.moe_ffn`); the
trainer and the mesh executor build their model so, or without a group.

``build_model(cfg, device, mesh=groups)`` is the counterpart of the JAX
package's ``build_model(cfg, mesh=...)`` with the rule table's
shardings: the FSDP x TP program GSPMD derives, spelled out (every dense
GQA config; MoE, MLA, SSM/hybrid and deepseek-v3 raise
``NotImplementedError`` naming their ``ROADMAP.md`` item). ``groups`` is
a :class:`repro_torch.launch.mesh.MeshGroups`; :attr:`Model.specs` is
the rule table's spec tree, and the parameters the model takes are the
rank's blocks of it (``dist.sharding.shard_tree``). Per block, inside
its remat: each weight is gathered over the data group along its FSDP
dimension just before use (its gradient reduce-scattered back to the
block: ``_pin_layer_grads``' counterpart); column-parallel products take
the rank's output columns after Megatron's f, row-parallel ones its
input rows, their partial sums all-reduced over the model group (g):
SwiGLU, or the two-matrix MLP (``w_in``'s columns, the activation on
them, ``w_out``'s rows); attention runs on the rank's query heads, or
GSPMD's padded head blocks where the model degree does not divide them
(:func:`repro_torch.models.attention.gqa_forward_tp`). The batch stays
on the data axes throughout (``_constrain``'s counterpart): the
embedding lookup gathers the rank's feature columns of its own tokens
over the model group (:func:`repro_torch.models.layers.embed_lookup_tp`);
a frontend's ``embeds`` are the rank's examples already, and the table
is not read. The logits are the rank's vocabulary columns
(``_constrain(logits, None, "model")``), the padded ones masked on the
rank that holds them, and :meth:`Model.token_ce` is vocabulary-parallel.
The tied table serves both: its feature blocks for the lookup, its
vocabulary rows, gathered whole and cut, for the head; an untied
``lm_head`` (``(dp, "model")``) is the rank's vocabulary columns once
gathered over the data group.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.collectives import (copy_to_model, gather,
                                          reduce_from_model)
from repro_torch.dist.sharding import param_specs

from . import attention as attn
from . import moe as moe_mod
from . import remat as remat_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (ACT_DTYPE, embed_lookup, embed_lookup_tp, init_linear,
                     mlp2, rmsnorm, swiglu, vocab_parallel_ce)

__all__ = ["Model", "build_model", "segments_of", "params_from_numpy",
           "cast_params", "resolve_device", "unbind_layers",
           "REMAT_POLICIES", "mesh_refusal"]

#: the remat policies of ``ModelConfig.remat_policy`` (the JAX model's)
REMAT_POLICIES = ("nothing", "dots", "none")

#: MLA's query chunk in a full-sequence forward, the JAX model's default
#: ``attn_chunk`` (GQA's flash kernel takes the whole sequence)
ATTN_CHUNK = 1024


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The torch device for ``device``; raises if it names CUDA and no
    CUDA device is present (nothing quietly runs on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def segments_of(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """Compress cfg.block_kinds() into segments: the hybrid family's
    period as one pattern repeated ``n_layers / period`` times, else
    maximal runs of one kind."""
    kinds = cfg.block_kinds()
    if cfg.family == "hybrid":
        p = cfg.hybrid_period
        assert cfg.n_layers % p == 0, \
            "hybrid depth must be divisible by period"
        pattern = tuple(kinds[:p])
        assert kinds == list(pattern) * (cfg.n_layers // p)
        return [(pattern, cfg.n_layers // p)]
    segs: list[tuple[tuple[str, ...], int]] = []
    i = 0
    while i < len(kinds):
        j = i
        while j < len(kinds) and kinds[j] == kinds[i]:
            j += 1
        segs.append(((kinds[i],), j - i))
        i = j
    return segs


def _index(tree, i: int):
    """The ``i``-th layer of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_index(v, i) for v in tree)) \
            if hasattr(tree, "_fields") else tuple(_index(v, i) for v in tree)
    return tree[i]


def unbind_layers(seg, n_rep: int) -> list:
    """The per-layer trees of a stacked segment, with one ``torch.unbind``
    per leaf (views, no copies); a segment given as a list is already
    per layer and is returned as it is."""
    if isinstance(seg, list):
        return seg
    if isinstance(seg, dict):
        parts = {k: unbind_layers(v, n_rep) for k, v in seg.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n_rep)]
    if isinstance(seg, tuple):
        parts = [unbind_layers(v, n_rep) for v in seg]
        return [tuple(p[i] for p in parts) for i in range(n_rep)]
    return list(torch.unbind(seg, 0))


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists, tuples and named
    tuples (caches), keeping its structure and order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_params(tree, device: torch.device | str | None = None,
                dtype=None):
    """Every tensor of ``tree`` moved to ``device`` and, if floating,
    cast to ``dtype`` (either left as it is when None)."""
    def cast(t):
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t if device is None else t.to(device)
    return _tree_map(cast, tree)


def params_from_numpy(tree, device: torch.device | str, dtype=None):
    """The JAX package's parameter tree, as numpy arrays, as the port's
    tensors on ``device``, leaf for leaf (dicts, lists and tuples keep
    their structure and order).

    bf16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    rejects) go through a ``uint16`` view. ``dtype`` casts every
    floating leaf.
    """
    def leaf(a):
        arr = np.array(a, copy=True)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
        return torch.from_numpy(arr)
    return cast_params(_tree_map(leaf, tree), device, dtype)


# ------------------------------------------------------------------ #
# block init                                                          #
# ------------------------------------------------------------------ #
def _init_attn(gen, cfg: ModelConfig, device) -> dict:
    if cfg.attn_kind == "mla":
        return _init_mla(gen, cfg, device)
    d, dh = cfg.d_model, cfg.resolved_head_dim
    lin = lambda shape: init_linear(gen, shape, device=device)  # noqa: E731
    p = {
        "wq": lin((d, cfg.n_heads * dh)),
        "wk": lin((d, cfg.n_kv_heads * dh)),
        "wv": lin((d, cfg.n_kv_heads * dh)),
        "wo": lin((cfg.n_heads * dh, d)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                        ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((n * dh,), dtype=torch.float32,
                                  device=device)
    return p


def _init_mla(gen, cfg: ModelConfig, device) -> dict:
    """MLA's leaves as the JAX package names and shapes them: the latent
    and shared rope key's ``wkv_a``, its fp32 ``kv_norm``, the absorbed
    ``wk_b`` and ``wv_b``, ``wo``, and the queries' ``wq`` or, when they
    are compressed, ``wq_a``, fp32 ``q_norm`` and ``wq_b``."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.mla_d_nope, cfg.mla_d_rope, cfg.mla_d_v
    r = cfg.kv_lora_rank
    lin = lambda shape: init_linear(gen, shape, device=device)  # noqa: E731
    ones = lambda n: torch.ones((n,), dtype=torch.float32,  # noqa: E731
                                device=device)
    p = {"wkv_a": lin((d, r + dr)), "kv_norm": ones(r),
         "wk_b": lin((r, h * dn)), "wv_b": lin((r, h * dv)),
         "wo": lin((h * dv, d))}
    if cfg.q_lora_rank:
        p["wq_a"] = lin((d, cfg.q_lora_rank))
        p["q_norm"] = ones(cfg.q_lora_rank)
        p["wq_b"] = lin((cfg.q_lora_rank, h * (dn + dr)))
    else:
        p["wq"] = lin((d, h * (dn + dr)))
    return p


def _init_mamba(gen, cfg: ModelConfig, device) -> dict:
    s = cfg.ssm
    assert s is not None
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    lin = lambda shape, **kw: init_linear(  # noqa: E731
        gen, shape, device=device, **kw)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": lin((d, d_in)),
        "wx": lin((d, d_in)),
        "wb": lin((d, s.n_groups * s.d_state)),
        "wc": lin((d, s.n_groups * s.d_state)),
        "wdt": lin((d, nh)),
        "conv_w": lin((conv_dim, s.conv_width), scale=s.conv_width ** -0.5),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "a_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "d_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.full((nh,), -4.6, **f32),  # softplus^-1(0.01)
        "gate_norm": torch.ones((d_in,), **f32),
        "out_proj": lin((d_in, d)),
    }


def _init_moe(gen, cfg: ModelConfig, device) -> dict:
    m = cfg.moe
    assert m is not None
    d, fe = cfg.d_model, m.d_expert
    lin = lambda shape, **kw: init_linear(  # noqa: E731
        gen, shape, device=device, **kw)
    p = {
        "router": lin((d, m.n_experts), dtype=torch.float32),
        "experts": {
            "w_gate": lin((m.n_experts, d, fe)),
            "w_up": lin((m.n_experts, d, fe)),
            "w_down": lin((m.n_experts, fe, d)),
        },
    }
    if m.n_shared:
        fs = m.n_shared * fe
        p["shared"] = {"w_gate": lin((d, fs)), "w_up": lin((d, fs)),
                       "w_down": lin((fs, d))}
    return p


def _init_block(gen, kind: str, cfg: ModelConfig, device) -> dict:
    """One block of ``kind`` (``mixer[_mlp]``: ``attn`` or ``mamba``,
    then ``dense``, ``moe`` or nothing), its leaves drawn in the order
    ln1, mixer, ln2, MLP."""
    d, f = cfg.d_model, cfg.d_ff
    mixer, _, mlp = kind.partition("_")
    ones = lambda: torch.ones((d,), dtype=torch.float32,  # noqa: E731
                              device=device)
    block = {"ln1": ones()}
    if mixer == "attn":
        block["attn"] = _init_attn(gen, cfg, device)
    else:
        block["mamba"] = _init_mamba(gen, cfg, device)
    if not mlp:
        return block
    block["ln2"] = ones()
    if mlp == "moe":
        block["moe"] = _init_moe(gen, cfg, device)
        return block
    lin = lambda shape: init_linear(gen, shape, device=device)  # noqa: E731
    if cfg.mlp_kind != "swiglu":
        block["mlp"] = {"w_in": lin((d, f)), "w_out": lin((f, d))}
    else:
        block["mlp"] = {"w_gate": lin((d, f)), "w_up": lin((d, f)),
                        "w_down": lin((f, d))}
    return block


def _init_stacked(draw, n_rep: int):
    """``n_rep`` draws of ``draw()`` (a block's tree), stacked leaf by
    leaf along a new leading axis. Each draw is copied into its layer of
    a stack allocated after the first, so the stacks and one block are
    alive at once, never every block twice (which stacking a list of
    blocks would need); the values are those of ``torch.stack`` over the
    same draws in the same order."""
    first = draw()
    stacked = _tree_map(
        lambda t: t.new_empty((n_rep, *t.shape)), first)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)
    put(stacked, first, 0)
    del first
    for i in range(1, n_rep):
        put(stacked, draw(), i)
    return stacked


@dataclass
class Model:
    """The dense GQA, SSM, hybrid and MoE (MLA) families' functions on
    ``device``.

    Attention caches and pools are bf16 (as in the JAX package) whatever
    the parameters' dtype; a Mamba cache holds its conv tail in bf16 and
    its SSD state in fp32, as the JAX package's does. The paged Mamba
    pools keep the conv window in fp32: it holds a prefill's bf16 tail
    exactly, and the rows a decode step appends as that step computes
    them (bf16 values in a bf16 run; fp32 in an fp32 run, where the JAX
    decode's concatenation promotes the window to fp32). Decode updates
    the pools in place.
    """

    cfg: ModelConfig
    device: torch.device
    model_group: object = None
    mesh: object = None       # MeshGroups: the FSDP x TP program
    #: a frontend's ``embeds`` read in fp32 with fp32 parameters, which
    #: the JAX model cannot run (:meth:`_inputs`): a yardstick of how far
    #: a bf16 step sits from fp32, not a configuration to train
    fp32_embeds: bool = False

    # ---------------- the FSDP x TP program ---------------- #
    @functools.cached_property
    def specs(self) -> dict:
        """The rule table's spec tree over the mesh's grid (fitted to its
        axis sizes)."""
        meta = Model(self.cfg, torch.device("meta")).init(0)
        return param_specs(meta, self.cfg, self.mesh.multi_pod,
                           self.mesh.axis_sizes())

    def _fsdp(self, tree, specs, where: str):
        """Every leaf of ``tree`` (the rank's blocks) gathered over the
        data group along its FSDP dimension; the model blocks stay. The
        gathers name their leaf (``where`` and its path)."""
        if isinstance(tree, dict):
            return {k: self._fsdp(v, specs[k], f"{where}.{k}")
                    for k, v in tree.items()}
        for dim, e in enumerate(specs):
            if e is not None and e != "model":
                tree = gather(tree, dim, self.mesh.data_group, where)
        return tree

    def _vocab_block(self) -> tuple[int, int]:
        """``(first column, columns)`` of this rank's logits."""
        n = self.cfg.padded_vocab // self.mesh.model_degree
        return self.mesh.model_rank * n, n

    def token_ce(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        """Per-token cross-entropy of this model's logits, fp32:
        vocabulary-parallel over the model group on a mesh."""
        if self.mesh is None:
            return vocab_parallel_ce(logits, labels, 0, None)
        return vocab_parallel_ce(logits, labels, self._vocab_block()[0],
                                 self.mesh.model_group)

    def _layer_specs(self):
        """Each block's spec tree, in :meth:`_layers`' order (the stacked
        layer axis dropped)."""
        def unstack(sp):
            if isinstance(sp, dict):
                return {k: unstack(v) for k, v in sp.items()}
            return sp[1:]
        for (pattern, n_rep), seg in zip(segments_of(self.cfg),
                                         self.specs["segments"]):
            per = [unstack(sp) for sp in seg]
            for _ in range(n_rep):
                yield from per

    def _inputs_tp(self, params: dict, tokens, embeds) -> torch.Tensor:
        """The first block's input on the mesh: the lookup of the rank's
        ``tokens``, or its examples' ``embeds`` (:meth:`_inputs`' rule:
        cast to the activation dtype, bf16 parameters only), the
        embedding table then untouched."""
        if embeds is not None or tokens is None:
            return self._inputs(params, tokens, embeds)
        table = self._fsdp(params["embed"], self.specs["embed"], "embed")
        return embed_lookup_tp(table, tokens, self.mesh.model_group)

    def _head_tp(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The rank's vocabulary columns of the logits: the tied table's
        rows of this rank, from the table gathered whole; or the untied
        ``lm_head``'s columns of this rank, which the data gather alone
        makes whole (its spec is ``(dp, "model")``)."""
        g = self.mesh
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        x = copy_to_model(x, g.model_group, "head f")
        start, n = self._vocab_block()
        if self.cfg.tie_embeddings:
            table = self._fsdp(params["embed"], self.specs["embed"], "head")
            table = gather(table, 1, g.model_group, "head")
            logits = torch.matmul(x, table[start:start + n].clone().T)
        else:
            logits = torch.matmul(x, self._fsdp(
                params["lm_head"], self.specs["lm_head"], "head"))
        pad = self.cfg.vocab - start
        if pad < n:
            logits[..., max(pad, 0):] = -2.0 ** 20
        return logits

    def _block_tp(self, x, bp, specs, positions, where: str,
                  cache=None, pos=None, return_kv: bool = False):
        """One dense GQA block on this rank's blocks (see the module
        doc): returns ``x`` after it (and the cache contents with
        ``return_kv``; a decode with ``cache`` writes it in place)."""
        g, cfg = self.mesh, self.cfg
        mg, m, M = g.model_group, g.model_rank, g.model_degree
        full = self._fsdp(bp, specs, where)
        h = copy_to_model(rmsnorm(x, full["ln1"], cfg.norm_eps), mg,
                          f"{where} attn f")
        kv = None
        if cache is not None:
            y, _ = attn.gqa_decode_tp(h, full["attn"], cfg, cache, pos, mg,
                                      m, M, f"{where} attn")
        else:
            y = attn.gqa_forward_tp(h, full["attn"], cfg, positions, mg, m,
                                    M, return_kv, f"{where} attn")
            if return_kv:
                y, kv = y
        x = x + reduce_from_model(y, mg, f"{where} attn g")
        h = copy_to_model(rmsnorm(x, full["ln2"], cfg.norm_eps), mg,
                          f"{where} mlp f")
        mp = full["mlp"]
        if cfg.mlp_kind != "swiglu":
            # w_in's columns and w_out's rows of this rank: the
            # activation acts on the rank's columns alone
            y = mlp2(h, mp["w_in"], mp["w_out"], kind=cfg.mlp_kind)
        else:
            y = swiglu(h, mp["w_gate"], mp["w_up"], mp["w_down"])
        x = x + reduce_from_model(y, mg, f"{where} mlp g")
        return (x, kv) if return_kv else x

    def _tp_blocks(self, params: dict):
        """``(segment, layer, position, where, block params, block
        specs)`` for every block."""
        for (si, i, pi, _, bp), specs in zip(self._layers(params),
                                             self._layer_specs()):
            yield si, i, pi, f"layer {si}.{i}", bp, specs

    def _mask_pad(self, logits: torch.Tensor) -> torch.Tensor:
        """Padded vocab columns to -2^20 (padding exists only so the
        table shards evenly; it must never win a softmax)."""
        cfg = self.cfg
        if cfg.padded_vocab != cfg.vocab:
            logits[..., cfg.vocab:] = -2.0 ** 20
        return logits

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return self._mask_pad(torch.matmul(x, head))

    def _layers(self, params: dict):
        """Every block in order as ``(segment, layer, position in the
        pattern, block kind, block params)`` — the loop that replaces the
        JAX model's scan over the stacked layer axis."""
        for si, ((pattern, n_rep), seg) in enumerate(
                zip(segments_of(self.cfg), params["segments"])):
            for i, layer in enumerate(unbind_layers(seg, n_rep)):
                for pi, (kind, bp) in enumerate(zip(pattern, layer)):
                    yield si, i, pi, kind, bp

    # ---------------- init ---------------- #
    def init(self, gen: torch.Generator | int) -> dict:
        """Random parameters drawn from ``gen`` (a generator on
        ``self.device``, or an int seed for one)."""
        cfg = self.cfg
        if self.device.type == "meta":
            gen = None      # shapes only: nothing is drawn
        elif isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        params: dict = {
            "embed": init_linear(gen, (cfg.padded_vocab, cfg.d_model),
                                 device=self.device, scale=0.02),
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_linear(
                gen, (cfg.d_model, cfg.padded_vocab), device=self.device)
        segs = []
        for pattern, n_rep in segments_of(cfg):
            per_kind = tuple(
                _init_stacked(lambda kind=kind: _init_block(
                    gen, kind, cfg, self.device), n_rep)
                for kind in pattern)
            segs.append(per_kind)
        params["segments"] = segs
        return params

    # ---------------- blocks ---------------- #
    def _mlp_part(self, x, p, kind):
        """The block's MLP half on the mixer's output ``x``: nothing for
        a kind without one (``mamba``), else ln2 and the dense MLP or the
        MoE FFN, added to ``x``."""
        mlp = kind.partition("_")[2]
        if not mlp:
            return x
        h = rmsnorm(x, p["ln2"], self.cfg.norm_eps)
        if mlp == "moe":
            return x + moe_mod.moe_ffn(h, p["moe"], self.cfg,
                                       group=self.model_group)
        m = p["mlp"]
        if self.cfg.mlp_kind != "swiglu":
            return x + mlp2(h, m["w_in"], m["w_out"], kind=self.cfg.mlp_kind)
        return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])

    def _inputs(self, params: dict, tokens, embeds) -> torch.Tensor:
        """The first block's input: the token embeddings of ``tokens``
        (B, S), or the frontend's ``embeds`` (B, S, D) cast to the
        activation dtype, as the JAX model casts them. With fp32 weights
        the JAX model cannot run ``embeds`` (its layer scan carries bf16
        and the first block returns fp32), so neither does this one."""
        if embeds is None:
            if tokens is None:
                raise ValueError("pass tokens or embeds")
            return embed_lookup(params["embed"], tokens)
        if self.fp32_embeds:
            return embeds.float()
        if params["embed"].dtype != ACT_DTYPE:
            raise ValueError(
                f"embeds with {params['embed'].dtype} params: the JAX "
                f"model raises here (embeds cast to bf16 make its layer "
                f"scan's carry bf16 while the first block returns "
                f"{params['embed'].dtype}); run embeds with bf16 params")
        return embeds.to(ACT_DTYPE)

    def _attn_forward(self, h, p, positions, return_kv: bool = False):
        """The attention mixer's full-sequence forward: MLA or GQA."""
        if self.cfg.attn_kind == "mla":
            return attn.mla_forward(h, p, self.cfg, positions,
                                    chunk=ATTN_CHUNK, return_kv=return_kv)
        return attn.gqa_forward(h, p, self.cfg, positions,
                                return_kv=return_kv)

    def _block(self, x, bp, kind, positions):
        h = rmsnorm(x, bp["ln1"], self.cfg.norm_eps)
        if kind.partition("_")[0] == "mamba":
            x = x + ssm_mod.mamba_forward(h, bp["mamba"], self.cfg)
        else:
            x = x + self._attn_forward(h, bp["attn"], positions)
        return self._mlp_part(x, bp, kind)

    # ---------------- forward ---------------- #
    def forward(self, params: dict, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Training forward. tokens (B, S) or embeds (B, S, D) -> logits
        (B, S, V).

        With ``cfg.remat`` and autograd recording, each block is
        recomputed in the backward: under policy ``"nothing"`` all of it,
        under ``"dots"`` all but the outputs of its products with no batch
        dimension, which it keeps (:mod:`repro_torch.models.remat`, JAX's
        ``dots_with_no_batch_dims_saveable``); ``"none"`` keeps every
        activation. The padded vocab columns are masked in place, which
        autograd allows: the head's product does not save its output."""
        cfg = self.cfg
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat policy {cfg.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")
        remat = (cfg.remat and cfg.remat_policy != "none"
                 and torch.is_grad_enabled())
        dots = remat and cfg.remat_policy == "dots"
        if self.mesh is not None:
            return self._forward_tp(params, tokens, embeds, remat, dots)
        x = self._inputs(params, tokens, embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for _, _, _, kind, bp in self._layers(params):
            if dots:
                kept: list = []
                x = checkpoint(self._block, x, bp, kind, positions,
                               use_reentrant=False,
                               context_fn=functools.partial(
                                   remat_mod.dots_contexts, kept))
                x = remat_mod.hold(x, kept)
            elif remat:
                x = checkpoint(self._block, x, bp, kind, positions,
                               use_reentrant=False)
            else:
                x = self._block(x, bp, kind, positions)
        return self._head(params, x)

    def _forward_tp(self, params: dict, tokens, embeds, remat: bool,
                    dots: bool):
        """:meth:`forward` on the mesh: the rank's logits (b, S, V / M)
        of its own examples."""
        x = self._inputs_tp(params, tokens, embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for *_, where, bp, specs in self._tp_blocks(params):
            fn = functools.partial(self._block_tp, specs=specs,
                                   positions=positions, where=where)
            if dots:
                kept: list = []
                x = checkpoint(fn, x, bp, use_reentrant=False,
                               context_fn=functools.partial(
                                   remat_mod.dots_contexts, kept))
                x = remat_mod.hold(x, kept)
            elif remat:
                x = checkpoint(fn, x, bp, use_reentrant=False)
            else:
                x = fn(x, bp)
        return self._head_tp(params, x)

    # ---------------- prefill ---------------- #
    def prefill(self, params: dict, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None):
        """Fused cache-filling prefill of tokens (B, S) or embeds (B, S,
        D): one forward returning ``(logits (B, S, V), state)``, where
        ``state`` matches :meth:`init_decode_state` (batch=B, s_max=S)
        leaf for leaf — the post-rope k/v, and the conv tails and final
        SSD states, are byproducts of the forward. Feed exact-length prompts: the SSD
        recurrence runs through every input token."""
        cfg = self.cfg
        caches: list[list[list]] = [
            [[] for _ in pattern] for pattern, _ in segments_of(cfg)]
        if self.mesh is not None:
            x = self._inputs_tp(params, tokens, embeds)
            b, s = x.shape[:2]
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
            for si, _, pi, where, bp, specs in self._tp_blocks(params):
                x, kv = self._block_tp(x, bp, specs, positions, where,
                                       return_kv=True)
                caches[si][pi].append(kv)
            return self._head_tp(params, x), self._stack_caches(caches)
        x = self._inputs(params, tokens, embeds)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for si, _, pi, kind, bp in self._layers(params):
            h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
            if kind.partition("_")[0] == "mamba":
                y, cache = ssm_mod.mamba_forward(h, bp["mamba"], cfg,
                                                 return_cache=True)
            else:
                y, cache = self._attn_forward(h, bp["attn"], positions,
                                              return_kv=True)
            x = self._mlp_part(x + y, bp, kind)
            caches[si][pi].append(cache)
        return self._head(params, x), self._stack_caches(caches)

    @staticmethod
    def _stack_caches(caches: list) -> list:
        """Per-layer caches stacked per segment, leaf by leaf."""
        return [tuple(type(per[0])(*(torch.stack(leaves)
                                     for leaves in zip(*per)))
                      for per in seg)
                for seg in caches]

    # ---------------- decode state ---------------- #
    def _stacked(self, make) -> list:
        """``make(kind)``'s cache for each block kind, stacked per
        segment (leading axis n_rep)."""
        out = []
        for pattern, n_rep in segments_of(self.cfg):
            per = []
            for kind in pattern:
                c = make(kind)
                per.append(type(c)(*(t.expand(n_rep, *t.shape).clone()
                                     for t in c)))
            out.append(tuple(per))
        return out

    def init_decode_state(self, batch: int, s_max: int) -> list:
        """Per-segment stacked dense caches (leading axis n_rep). On a
        mesh ``batch`` is the global batch and the caches are this
        rank's block (``cache_specs``): its examples where the batch
        divides the data degree, every KV head."""
        if self.mesh is not None and batch % self.mesh.data_degree == 0:
            batch //= self.mesh.data_degree

        def make(kind):
            if kind.partition("_")[0] == "mamba":
                return ssm_mod.init_mamba_cache(self.cfg, batch,
                                                device=self.device)
            init = (attn.init_mla_cache if self.cfg.attn_kind == "mla"
                    else attn.init_gqa_cache)
            return init(self.cfg, batch, s_max, device=self.device)
        return self._stacked(make)

    def init_paged_state(self, n_slots: int, n_pages: int,
                         page_size: int) -> list:
        """Paged decode state: per-layer physical page pools
        ``(n_rep, n_pages, PS, KV, dh)`` (MLA: ``(n_rep, n_pages, PS,
        kv_lora)`` and ``(..., d_rope)``), shared by all decode slots and
        addressed through one ``(n_slots, max_pages)`` block table
        (managed host-side by :mod:`repro_torch.serve.kvcache`); page 0
        is the trash page. Mamba caches stay slot-dense ``(n_rep,
        n_slots, ...)`` because the SSD state is O(1) per sequence (the
        slot is the page), with the conv window in fp32 (see
        :class:`Model`)."""
        def make(kind):
            if kind.partition("_")[0] == "mamba":
                c = ssm_mod.init_mamba_cache(self.cfg, n_slots,
                                             device=self.device)
                return c._replace(conv=c.conv.float())
            init = (attn.init_mla_pool if self.cfg.attn_kind == "mla"
                    else attn.init_gqa_pool)
            return init(self.cfg, n_pages, page_size, device=self.device)
        return self._stacked(make)

    def _decode(self, params: dict, state: list, tokens, embeds, attend):
        """One token (tokens (B, 1) or embeds (B, 1, D)) through every
        block; ``attend(h, p, cache)`` is the attention decode. The caches
        in ``state`` are updated in place: each layer's view of its Mamba
        cache takes the new conv window and SSD state."""
        cfg = self.cfg
        x = self._inputs(params, tokens, embeds)
        for si, i, pi, kind, bp in self._layers(params):
            cache = _index(state[si][pi], i)
            h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
            if kind.partition("_")[0] == "mamba":
                y, new = ssm_mod.mamba_decode(h, bp["mamba"], cfg, cache)
                cache.conv.copy_(new.conv)
                cache.state.copy_(new.state)
            else:
                y, _ = attend(h, bp["attn"], cache)
            x = self._mlp_part(x + y, bp, kind)
        return self._head(params, x), state

    def decode_step(self, params: dict, state: list, pos,
                    tokens: torch.Tensor | None = None,
                    embeds: torch.Tensor | None = None):
        """One-token step over dense caches, every row at one position.

        tokens (B, 1) or embeds (B, 1, D); ``state`` as
        :meth:`init_decode_state` makes it (or a prefill fills it); pos a
        Python int or a 0-d integer tensor: every row generates token
        ``pos``. The caches in ``state`` are updated in place (the JAX
        package returns a new state); returns ``(logits (B, 1, V),
        state)``. A Mamba cache's conv window keeps its dtype: in an fp32
        run with bf16 caches the rows a step appends are rounded to bf16,
        where the JAX decode promotes the window to fp32.
        """
        if self.mesh is not None:
            x = self._inputs_tp(params, tokens, embeds)
            for si, i, pi, where, bp, specs in self._tp_blocks(params):
                x = self._block_tp(x, bp, specs, None, where,
                                   cache=_index(state[si][pi], i), pos=pos)
            return self._head_tp(params, x), state
        dec = (attn.mla_decode if self.cfg.attn_kind == "mla"
               else attn.gqa_decode)
        return self._decode(params, state, tokens, embeds,
                            lambda h, p, c: dec(h, p, self.cfg, c, pos))

    def decode_step_paged(self, params: dict, state: list,
                          table: torch.Tensor, pos: torch.Tensor,
                          tokens: torch.Tensor | None = None,
                          embeds: torch.Tensor | None = None):
        """One-token step over paged pools, per-row positions.

        tokens (B, 1) or embeds (B, 1, D); table (B, max_pages) page
        ids; pos (B,) — row b generates token ``pos[b]``. B is the fixed
        decode-slot count: admission and eviction change only table/pos
        *data*. The pools in ``state`` are updated in place; returns
        ``(logits (B, 1, V), state)``. Mamba layers ignore table and pos:
        every slot's row advances its own conv window and SSD state (an
        inactive slot's row spins harmlessly; admission overwrites
        both).
        """
        if self.mesh is not None:
            raise NotImplementedError("paged decode on a mesh: the dry "
                                      "run's decode cells run the dense "
                                      "step (ROADMAP.md §1)")
        dec = (attn.mla_decode_paged if self.cfg.attn_kind == "mla"
               else attn.gqa_decode_paged)
        return self._decode(params, state, tokens, embeds,
                            lambda h, p, c: dec(h, p, self.cfg, c, table,
                                                pos))


def mesh_refusal(cfg: ModelConfig) -> str | None:
    """Why the FSDP x TP program does not run ``cfg`` yet (its
    ``ROADMAP.md`` §1 item, 1.3 to 1.6), or None: it runs every dense
    GQA config."""
    if cfg.name == "deepseek-v3-671b":
        return "deepseek-v3 (ROADMAP.md §1 item 1.6)"
    if cfg.family in ("ssm", "hybrid"):
        return ("SSM and hybrid: w_in's sections cut across model blocks "
                "(ROADMAP.md §1 item 1.5)")
    if cfg.attn_kind == "mla":
        return "MLA (ROADMAP.md §1 item 1.4)"
    if cfg.family == "moe":
        return ("MoE on the FSDP x TP step, whose expert-parallel body "
                "exists (ROADMAP.md §1 item 1.3)")
    return None


def build_model(cfg: ModelConfig, device: torch.device | str = "cuda",
                model_group=None, mesh=None,
                fp32_embeds: bool = False) -> Model:
    """The port's model for ``cfg`` on ``device`` (default: the card):
    every family of the JAX package (dense, ssm, hybrid, moe) with GQA
    or MLA attention. ``model_group`` (a ``torch.distributed`` group)
    runs the MoE layers expert-parallel over its ranks; ``mesh`` (a
    :class:`repro_torch.launch.mesh.MeshGroups`) builds the FSDP x TP
    program (see the module doc), and raises ``NotImplementedError``
    for a config it does not run yet. ``fp32_embeds`` reads a
    frontend's ``embeds`` in fp32 (:attr:`Model.fp32_embeds`)."""
    if cfg.family not in ("dense", "ssm", "hybrid", "moe"):
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.attn_kind not in ("gqa", "mla"):
        raise ValueError(f"unknown attention kind {cfg.attn_kind!r}")
    if mesh is not None:
        why = mesh_refusal(cfg)
        if why is not None:
            raise NotImplementedError(f"{cfg.name} on the FSDP x TP "
                                      f"program: {why}")
        attn.check_tp_heads(cfg, mesh.model_degree)
    return Model(cfg=cfg, device=resolve_device(device),
                 model_group=model_group, mesh=mesh, fp32_embeds=fp32_embeds)
