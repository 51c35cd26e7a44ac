"""Shared neural building blocks (bf16 activations, fp32 math where it
matters) — the PyTorch counterparts of ``repro.models.layers``.

The FSDP x TP step's two vocabulary pieces live here too:
:func:`embed_lookup_tp`, the lookup in a table whose features are split
over the model group, and :func:`vocab_parallel_ce`, the cross-entropy
of logits whose vocabulary is split over it (no rank ever holds a
whole-vocabulary row)."""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.dist.collectives import collective, gather_split
from repro_torch.kernels import ops
from repro_torch.models.remat import dot

__all__ = [
    "rmsnorm", "swiglu", "mlp2", "gelu", "rope_freqs", "apply_rope",
    "embed_lookup", "cross_entropy", "init_linear", "ACT_DTYPE",
    "embed_lookup_tp", "vocab_parallel_ce",
]

ACT_DTYPE = torch.bfloat16


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the activation dtype (the K1 kernel
    on a CUDA tensor, its plain version on a CPU one)."""
    return ops.rmsnorm(x, w, eps=eps)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, keep=(True, True, True)) -> torch.Tensor:
    """SwiGLU MLP: silu(x W_g) * (x W_u) W_d, in the compute dtype.
    ``keep``: which of the three products the ``"dots"`` remat policy
    keeps (:func:`repro_torch.models.remat.dot`)."""
    g = dot(x, w_gate, keep[0])
    u = dot(x, w_up, keep[1])
    return dot(F.silu(g) * u, w_down, keep[2])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU, spelled as ``jax.nn.gelu`` (``approximate=True``)
    spells it, op by op in ``x``'s dtype with ``sqrt(2/pi)`` and 0.044715
    rounded to that dtype first. ``F.gelu(x, approximate="tanh")``
    rounds elsewhere: on 65,536 bf16 inputs it differs from JAX's in
    28,014 elements, this spelling in none (``tools/gelu_parity.py``).
    In fp32 XLA's CPU ``tanh`` is an approximation of its own, so fp32
    agrees within a tolerance only."""
    c, k = _gelu_constants(x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


@functools.cache
def _gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    """``sqrt(2/pi)`` and 0.044715 rounded to ``dtype``, as Python floats:
    a scalar operand costs no host-to-device copy, and multiplied into a
    tensor of ``dtype`` it gives the bits the rounded constant gives."""
    return tuple(torch.tensor(v, dtype=dtype).item()
                 for v in (math.sqrt(2.0 / math.pi), 0.044715))


def mlp2(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
         kind: str = "gelu") -> torch.Tensor:
    """Two-matrix MLP (starcoder2: gelu; nemotron/minitron: squared
    relu), in the compute dtype."""
    h = dot(x, w_in)
    if kind == "gelu":
        h = gelu(h)
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return dot(h, w_out)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str) -> torch.Tensor:
    """Inverse frequencies for rotary embedding, shape (head_dim/2,)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate pairs (x0, x1) by position-dependent angles, split-half
    (HF/Llama convention). x: (..., seq, heads, head_dim); positions:
    (..., seq) integers. Angles in fp32 from the integer positions."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding by row gather."""
    return F.embedding(tokens, table)


def embed_lookup_tp(table: torch.Tensor, tokens: torch.Tensor, group,
                    source: str = "embed") -> torch.Tensor:
    """Token embedding from a table whose rows are whole and whose
    features are this rank's block of ``group`` (the rule table's
    ``(dp, "model")`` embedding, gathered over the data axes): the
    rank's columns of each row, gathered whole over ``group``. Every
    rank then holds the whole activation, and its gradient whole, so the
    gradient goes back as the rank's columns (:func:`gather_split`)."""
    return gather_split(F.embedding(tokens, table), -1, group, source)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token cross-entropy of fp32 logits ``(..., V / M)`` holding
    vocabulary columns ``[start, start + V / M)``: the max and the sum
    of exponentials over the group, and the label's logit from the rank
    that holds it (three all-reduces over ``group``). The backward is
    local: ``softmax - onehot`` on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, start, group):
        local = logits.shape[-1]
        mx = logits.max(dim=-1).values
        collective(dist.all_reduce, mx, group=group,
                   reduce_op=dist.ReduceOp.MAX,
                   source="ce max")
        probs = torch.exp(logits - mx[..., None])
        total = probs.sum(dim=-1)
        collective(dist.all_reduce, total, group=group, source="ce sum")
        inside = (labels >= start) & (labels < start + local)
        idx = (labels - start).clamp(0, local - 1).long()
        picked = torch.gather(logits, -1, idx[..., None])[..., 0]
        picked = torch.where(inside, picked, torch.zeros_like(picked))
        collective(dist.all_reduce, picked, group=group, source="ce label")
        ce = torch.log(total) + mx - picked
        probs.div_(total[..., None])
        ctx.save_for_backward(probs, idx, inside)
        return ce

    @staticmethod
    def backward(ctx, dce):
        probs, idx, inside = ctx.saved_tensors
        grad = probs.mul_(dce[..., None])
        grad.scatter_add_(-1, idx[..., None],
                          torch.where(inside, -dce, torch.zeros_like(dce)
                                      )[..., None])
        return grad, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      start: int, group) -> torch.Tensor:
    """Per-token cross-entropy ``logsumexp(logits) - logits[label]`` in
    fp32, of ``logits`` ``(..., V / M)`` that hold vocabulary columns
    ``[start, start + V / M)`` of ``group``'s whole row, ``labels``
    ``(...)`` whole token ids. Every rank of ``group`` gets the same
    values; the log-sum-exp is the JAX package's ``max + log(sum(exp(x -
    max)))``. Without a group, :func:`cross_entropy`'s per-token terms."""
    logits = logits.to(torch.float32)
    if group is None or dist.get_world_size(group) == 1:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return lse - picked
    return _VocabParallelCE.apply(logits, labels, start, group)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, fp32 reduction. logits (..., V),
    labels (...)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - picked)


def init_linear(gen: torch.Generator, shape: tuple[int, ...], *,
                device: torch.device | str, dtype=ACT_DTYPE,
                scale: float | None = None) -> torch.Tensor:
    """Truncated-normal (+-3 sigma) fan-in init, drawn in fp32 from
    ``gen`` on ``device``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else fan_in ** -0.5
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)
