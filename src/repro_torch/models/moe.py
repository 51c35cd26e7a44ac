"""Mixture-of-Experts FFN (DeepSeek / Jamba style), the counterpart of
``repro.models.moe``.

The JAX package's production path shards the routed experts over the
``model`` mesh axis and dispatches each rank's tokens through a
static-capacity scatter (:func:`expert_ffn_local`). Without a mesh that
carries the ``model`` axis, which is how its trainer and server build
their model, its ``moe_ffn`` falls back to the dense oracle
(:func:`moe_ffn_reference`): every routed slot is computed, none is
dropped. The port runs at model degree 1, so :func:`moe_ffn` computes
that same function, spelled as a dropless grouped dispatch: the ``T * k``
routed slots are sorted by expert, each expert runs one SwiGLU over its
rows, and each token's ``k`` terms are combined in fp32, in expert
order, with the gate weights rounded to the activation dtype first (as
the oracle's ``combine.astype(x.dtype)``).

The grouped dispatch reads the per-expert row counts back to the host
once per MoE layer (the split sizes), a synchronisation of the stream.
:func:`expert_ffn_local` is kept for expert parallelism, which comes
with tensor parallelism (``ROADMAP.md`` §1 item 5).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import swiglu

__all__ = ["route_topk", "moe_ffn_reference", "moe_ffn",
           "expert_ffn_local"]


def route_topk(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Router: top-k softmax gating with renormalised weights.

    x_flat (T, D); router_w (D, E). Returns (idx (T, k) int64, w (T, k)
    fp32), the k slots in descending gate order (``jax.lax.top_k``'s).
    Router math in fp32 (routing decisions are precision-sensitive)."""
    gates = torch.matmul(x_flat.float(), router_w.float())
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
    y = swiglu(h, experts["w_gate"], experts["w_up"], experts["w_down"])
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
    y_sorted = torch.cat([swiglu(r, *w) for r, w in zip(rows, per_expert)
                          if r.shape[0]])
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


def moe_ffn(x: torch.Tensor, p: dict, cfg: ModelConfig,
            model_degree: int = 1) -> torch.Tensor:
    """The MoE FFN of the main path. x (B, S, D) -> (B, S, D).

    The function the JAX ``moe_ffn`` computes without a ``model`` mesh
    axis (its dense oracle: no capacity, no drops), as a grouped
    dispatch that runs each expert on its own rows only. Expert
    parallelism (``model_degree`` > 1) is not ported."""
    if model_degree != 1:
        raise NotImplementedError(
            f"moe_ffn at model_degree={model_degree}: expert parallelism "
            f"comes with tensor parallelism (ROADMAP.md §1 item 5)")
    moe = cfg.moe
    assert moe is not None
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    top_idx, top_w = route_topk(x_flat, p["router"], moe.top_k)
    y = _grouped_experts(x_flat, top_idx, top_w, p["experts"])
    return (y + _shared_ffn(x_flat, p)).reshape(b, s, d)
