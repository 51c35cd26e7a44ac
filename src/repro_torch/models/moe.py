"""Mixture-of-Experts FFN (DeepSeek / Jamba style), the counterpart of
``repro.models.moe``.

Two spellings, as in the JAX package:

* Without a model group (``group=None``: how the trainer, the mesh
  executor and the server build their model, as the JAX package's build
  theirs without a mesh) :func:`moe_ffn` computes the function of the
  JAX ``moe_ffn`` without a ``model`` mesh axis, its dense oracle
  (:func:`moe_ffn_reference`): every routed slot, none dropped. It is
  spelled as a dropless grouped dispatch: the ``T * k`` routed slots are
  sorted by expert, each expert runs one SwiGLU over its rows, and each
  token's ``k`` terms are combined in fp32, in expert order, with the
  gate weights rounded to the activation dtype first (as the oracle's
  ``combine.astype(x.dtype)``). It reads the per-expert row counts back
  to the host once per MoE layer (the split sizes), a synchronisation of
  the stream.
* On a model group of ``ep`` ranks (any size, 1 included) it runs the
  JAX package's expert-parallel ``shard_map`` body: every rank routes
  the tokens it holds (replicated over the group), runs its ``E / ep``
  experts through the static-capacity dispatch of
  :func:`expert_ffn_local` (slots past the capacity are dropped), adds
  its slice of the shared experts' hidden dim, and one all-reduce over
  the group sums the ranks' partial outputs. The backward runs through
  two autograd functions, the transpose of that ``shard_map``: the
  replicated inputs' gradients are summed over the group, the sharded
  ones stay the rank's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .config import ModelConfig
from .layers import swiglu
from .remat import dot

__all__ = ["route_topk", "moe_ffn_reference", "moe_ffn",
           "expert_ffn_local", "ep_capacity", "ep_shard"]


def route_topk(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Router: top-k softmax gating with renormalised weights.

    x_flat (T, D); router_w (D, E). Returns (idx (T, k) int64, w (T, k)
    fp32), the k slots in descending gate order (``jax.lax.top_k``'s).
    Router math in fp32 (routing decisions are precision-sensitive)."""
    gates = dot(x_flat.float(), router_w.float())
    top_vals, top_idx = torch.topk(gates, top_k, dim=-1, sorted=True)
    return top_idx, torch.softmax(top_vals, dim=-1)


def _dispatch(top_idx: torch.Tensor, e_first: int, e_local: int,
              capacity: int):
    """The static-capacity dispatch of :func:`expert_ffn_local`: for each
    flattened (token, slot) pair, its row in the ``(e_local * capacity +
    1, D)`` buffer and whether it is kept. A slot routed to a local
    expert takes the running count of that expert's earlier slots as its
    position; past ``capacity`` it is dropped to the overflow row."""
    local = (top_idx >= e_first) & (top_idx < e_first + e_local)
    flat_eid = torch.where(local, top_idx - e_first, 0).reshape(-1)
    flat_local = local.reshape(-1)
    onehot = F.one_hot(flat_eid, e_local) * flat_local[:, None]
    pos = torch.cumsum(onehot, dim=0) - onehot              # exclusive
    slot_pos = torch.sum(pos * onehot, dim=1)
    keep = flat_local & (slot_pos < capacity)
    dump = e_local * capacity                               # overflow row
    dest = torch.where(keep, flat_eid * capacity + slot_pos, dump)
    return dest, keep


def expert_ffn_local(x_flat: torch.Tensor, top_idx: torch.Tensor,
                     top_w: torch.Tensor, experts: dict, e_first: int,
                     e_local: int, capacity: int) -> torch.Tensor:
    """Dispatch a token block to ``e_local`` local experts and combine.

    Static-shape scatter dispatch (:func:`_dispatch`); overflow slots are
    dropped, as in Switch / GShard. x_flat (T, D); experts' leaves
    (E_local, D, F). Returns the *partial* combine (T, D): the
    contributions of the local experts only (summed over the expert
    ranks upstream)."""
    t, d = x_flat.shape
    k = top_idx.shape[1]
    token_of = torch.arange(t, device=x_flat.device).repeat_interleave(k)
    dest, keep = _dispatch(top_idx, e_first, e_local, capacity)
    dump = e_local * capacity
    buf = x_flat.new_zeros((dump + 1, d)).index_put((dest,),
                                                     x_flat[token_of])
    h = buf[:-1].reshape(e_local, capacity, d)
    # the (E, C, D) products carry the experts' axis as a batch dim
    y = swiglu(h, experts["w_gate"], experts["w_up"], experts["w_down"],
               keep=(False, False, False))
    y_flat = y.reshape(dump, d)
    gathered = torch.where(keep[:, None],
                           y_flat[torch.clamp(dest, max=dump - 1)], 0.0)
    w = top_w.reshape(-1)[:, None].to(x_flat.dtype)
    return x_flat.new_zeros((t, d)).index_add(0, token_of, gathered * w)


def moe_ffn_reference(x: torch.Tensor, p: dict,
                      cfg: ModelConfig) -> torch.Tensor:
    """Dense-dispatch oracle: every expert computed for every token,
    masked combine. O(T * E * d * f): for tests only."""
    moe = cfg.moe
    assert moe is not None
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    top_idx, top_w = route_topk(x_flat, p["router"], moe.top_k)
    ex = p["experts"]
    g = torch.einsum("td,edf->etf", x_flat, ex["w_gate"])
    u = torch.einsum("td,edf->etf", x_flat, ex["w_up"])
    y_all = torch.einsum("etf,efd->etd", F.silu(g) * u, ex["w_down"])
    combine = torch.zeros((x_flat.shape[0], moe.n_experts),
                          dtype=torch.float32, device=x.device)
    combine = combine.scatter_add(1, top_idx, top_w)
    y = torch.einsum("te,etd->td", combine.to(x.dtype), y_all)
    return (y + _shared_ffn(x_flat, p)).reshape(b, s, d)


def _shared_ffn(x_flat: torch.Tensor, p: dict) -> torch.Tensor:
    if "shared" not in p:
        return torch.zeros_like(x_flat)
    sh = p["shared"]
    return swiglu(x_flat, sh["w_gate"], sh["w_up"], sh["w_down"])


def _grouped_experts(x_flat: torch.Tensor, top_idx: torch.Tensor,
                     top_w: torch.Tensor, experts: dict) -> torch.Tensor:
    """Every routed slot through its expert, no capacity: the slots
    sorted by expert (stable, so by token within an expert), one SwiGLU
    per expert that has rows, and each token's ``k`` terms summed in
    fp32 in expert order, the weights rounded to ``x_flat``'s dtype
    first."""
    t, k = top_idx.shape
    n_experts = experts["w_gate"].shape[0]
    flat = top_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    # the split sizes: the one read back to the host per MoE layer
    counts = torch.bincount(flat, minlength=n_experts).tolist()
    rows = torch.split(x_flat[order // k], counts)
    # one unbind per leaf: indexing the stack per expert would make each
    # expert's backward allocate a zero gradient the size of all of them
    per_expert = zip(*(torch.unbind(experts[name])
                       for name in ("w_gate", "w_up", "w_down")))
    # the gate and up products are JAX's "td,edf->etf" (no batch dim),
    # the down product its "etf,efd->etd" (the experts' axis a batch dim)
    y_sorted = torch.cat([swiglu(r, *w, keep=(True, True, False))
                          for r, w in zip(rows, per_expert) if r.shape[0]])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.numel(), device=order.device)
    by_expert = torch.argsort(top_idx, dim=1)                # (T, k)
    slot = (torch.arange(t, device=top_idx.device)[:, None] * k
            + by_expert)
    y = y_sorted[inverse[slot]]                              # (T, k, D)
    w = top_w.gather(1, by_expert).to(x_flat.dtype).float()
    acc = w[:, 0, None] * y[:, 0].float()
    for j in range(1, k):
        acc = acc + w[:, j, None] * y[:, j].float()
    return acc.to(x_flat.dtype)


def ep_capacity(cfg: ModelConfig, tokens: int) -> int:
    """The expert-parallel body's static capacity per expert for a block
    of ``tokens`` local tokens: ``max(8, int(cf * t * k / E))``, the JAX
    package's."""
    moe = cfg.moe
    return max(8, int(moe.capacity_factor * tokens * moe.top_k
                      / moe.n_experts))


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    # lazy: the collectives module reaches the kernels, which import the
    # models' layers
    from repro_torch.dist.collectives import collective
    out = t.contiguous().clone()
    collective(dist.all_reduce, out, group=group)
    return out


class _Replicated(torch.autograd.Function):
    """Identity forward; the gradient summed over the group backward: a
    tensor every rank of the group holds whole, used by each rank's part
    of the computation."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Summed(torch.autograd.Function):
    """Sum over the group forward (the ranks' partial outputs); identity
    backward: every rank receives the whole output's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def ep_shard(p: dict, cfg: ModelConfig, rank: int, size: int) -> dict:
    """A MoE layer's parameters ``p`` as rank ``rank`` of a model group
    of ``size`` holds them (views, no copies): its ``E / size`` routed
    experts, its slice of the shared experts' hidden dim (columns of
    ``w_gate`` and ``w_up``, rows of ``w_down``), the router whole. On
    stacked leaves (a leading layer axis) the same cuts, one axis in."""
    e_local = cfg.moe.n_experts // size
    out = {"router": p["router"], "experts": {
        k: v.narrow(v.dim() - 3, rank * e_local, e_local)
        for k, v in p["experts"].items()}}
    if "shared" in p:
        sh = p["shared"]
        hid = sh["w_down"].shape[-2] // size
        out["shared"] = {
            "w_gate": sh["w_gate"].narrow(-1, rank * hid, hid),
            "w_up": sh["w_up"].narrow(-1, rank * hid, hid),
            "w_down": sh["w_down"].narrow(-2, rank * hid, hid)}
    return out


def _local_params(p: dict, cfg: ModelConfig, group) -> dict:
    """This rank's part of a MoE layer's ``p`` for the expert-parallel
    body. ``p`` holds every routed expert and the whole shared experts
    (then they are cut here, as the JAX ``shard_map``'s in-specs cut
    them, and each rank's gradient of the whole leaf is summed over the
    group, so every rank gets the whole gradient), or this rank's part
    already (:func:`ep_shard`; its gradient is the rank's own)."""
    moe = cfg.moe
    ep = dist.get_world_size(group)
    e_local = moe.n_experts // ep
    held = p["experts"]["w_gate"].shape[0]
    if held not in (moe.n_experts, e_local):
        raise ValueError(f"{held} routed experts on a rank of {ep}: give "
                         f"all {moe.n_experts} or this rank's {e_local}")
    if ep == 1 or held == e_local:
        return p
    whole = {"router": p["router"], "experts": {
        k: _Replicated.apply(v, group) for k, v in p["experts"].items()}}
    if "shared" in p:
        whole["shared"] = {k: _Replicated.apply(v, group)
                           for k, v in p["shared"].items()}
    return ep_shard(whole, cfg, dist.get_rank(group), ep)


def _ep_body(x: torch.Tensor, p: dict, cfg: ModelConfig,
             group) -> torch.Tensor:
    """The JAX package's expert-parallel ``shard_map`` body on this
    rank's model ``group``, ``p`` as :func:`_local_params` takes it."""
    moe = cfg.moe
    ep = dist.get_world_size(group)
    if moe.n_experts % ep:
        raise ValueError(f"{moe.n_experts} experts not divisible by EP "
                         f"degree {ep}")
    e_local = moe.n_experts // ep
    b, s, d = x.shape
    local = _local_params(p, cfg, group)
    x_flat = _Replicated.apply(x, group).reshape(-1, d)
    top_idx, top_w = route_topk(
        x_flat, _Replicated.apply(p["router"], group), moe.top_k)
    y = expert_ffn_local(x_flat, top_idx, top_w, local["experts"],
                         dist.get_rank(group) * e_local, e_local,
                         ep_capacity(cfg, x_flat.shape[0]))
    if "shared" in local:
        # the shared experts' partial product: this rank's slice of
        # their hidden dim, summed with the routed part by the one
        # all-reduce
        y = y + _shared_ffn(x_flat, local)
    return _Summed.apply(y, group).reshape(b, s, d)


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig,
            group=None) -> torch.Tensor:
    """The MoE FFN. x (B, S, D) -> (B, S, D).

    Without ``group``: the function the JAX ``moe_ffn`` computes without
    a ``model`` mesh axis (its dense oracle: no capacity, no drops), as a
    grouped dispatch that runs each expert on its own rows only. With a
    model ``group``: the expert-parallel body (:func:`_ep_body`; the
    module doc), what the JAX ``moe_ffn`` runs on a mesh: ``x`` is this
    rank's data slice, replicated over the group, and the capacity is
    :func:`ep_capacity` of its token count."""
    moe = cfg.moe
    assert moe is not None
    if group is not None:
        return _ep_body(x, p, cfg, group)
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    top_idx, top_w = route_topk(x_flat, p["router"], moe.top_k)
    y = _grouped_experts(x_flat, top_idx, top_w, p["experts"])
    return (y + _shared_ffn(x_flat, p)).reshape(b, s, d)
