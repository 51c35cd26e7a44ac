"""AdamW + cosine schedule + global-norm clipping (the PyTorch counterpart
of ``repro.optim.adamw``).

The same numbers as the JAX package: the global norm is taken over the
gradients before the moments, clipping scales the gradient, the update
is ``(m / b1c) / (sqrt(v / b2c) + eps)`` with fp32 math, weight decay
applies only to leaves with ``ndim > 1`` (the *stacked* leaf's ndim, as
the JAX package decides it: per-layer norms and biases, stacked to
``(n_rep, d)``, are decayed; ``final_norm`` is not), and parameters are
cast back to their dtype.

Unlike the JAX package, which returns new trees, the update is made in
place, one leaf at a time and a large leaf one flat chunk at a time (the
update is elementwise, so chunking changes no number): the fp32
temporaries are one chunk of ``CHUNK`` elements at most, where a stacked
qwen2.5-3b MLP weight alone holds 811M. The gradients are consumed:
their storage is reused as scratch. Moments are fp32 unless
``moment_dtype`` says otherwise (update math stays fp32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]

CHUNK = 1 << 26   # elements per in-place update (256 MiB of fp32 scratch)


@dataclass
class AdamWState:
    step: int             # completed updates
    mu: Any               # tree like params, moment_dtype
    nu: Any


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def adamw_init(params: Any, moment_dtype="float32") -> AdamWState:
    dt = getattr(torch, str(moment_dtype))
    return AdamWState(
        step=0, mu=_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                              device=p.device), params),
        nu=_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                      device=p.device), params))


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_lr(step: int, base_lr: float = 3e-4, warmup: int = 100,
              total: int = 10_000, min_frac: float = 0.1) -> float:
    """Linear warmup -> cosine decay to ``min_frac * base_lr``, in fp32
    as the JAX package computes it; returned as a Python float holding
    that fp32 value."""
    s = _f32(step)
    if step < warmup:
        lr = base_lr * (s / max(warmup, 1))
    else:
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        lr = base_lr * cos
    return float(lr.to(torch.float32))


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, with no
    temporary larger than a scalar per leaf for fp32 gradients and one
    fp32 chunk of ``CHUNK`` elements for narrower ones."""
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    for g in grads:
        flat = g.reshape(-1)
        if flat.dtype == torch.float32:
            total += torch.dot(flat, flat)
            continue
        for part in flat.split(CHUNK):
            part = part.float()
            total += torch.dot(part, part)
    return torch.sqrt(total)


def _chunks(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    if not t.is_contiguous():
        raise ValueError("adamw_update works in place on contiguous "
                         "tensors only")
    return t.view(-1).split(CHUNK)


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, lr: float, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 gnorm: torch.Tensor | None = None
                 ) -> tuple[Any, AdamWState, torch.Tensor]:
    """One AdamW step, in place on ``params`` and ``state``'s moments;
    ``grads`` (same tree) is consumed. Returns ``(params, state,
    pre-clip grad norm)``, the norm as a 0-d device tensor (no host
    sync). ``gnorm`` gives the global norm where ``grads`` is a block of
    the gradient (a tensor-parallel rank's columns): the norm of the
    whole gradient, :func:`global_norm` of its leaves."""
    flat_g, flat_p = _leaves(grads), _leaves(params)
    flat_m, flat_v = _leaves(state.mu), _leaves(state.nu)
    if gnorm is None:
        gnorm = global_norm(flat_g)
    scale = torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)
    step = state.step + 1
    # device tensors, not Python numbers, as divisors: PyTorch's CUDA
    # division by a host scalar multiplies by its reciprocal instead (made
    # on the device: a copy from the host would wait for the stream)
    dev = flat_p[0].device
    b1c, b2c = (torch.full((), float(1 - _f32(b) ** _f32(step)),
                           dtype=torch.float32, device=dev)
                for b in (b1, b2))
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        decay = p.dim() > 1 and weight_decay
        for gs, ms, vs, ps in zip(*(_chunks(t) for t in (g, m, v, p))):
            _update_chunk(gs, ms, vs, ps, scale, lr, b1, b2, b1c, b2c, eps,
                          weight_decay if decay else 0.0)
    state.step = step
    return params, state, gnorm


def _update_chunk(g, m, v, p, scale, lr, b1, b2, b1c, b2c, eps, wd):
    """The JAX package's ``upd`` on one chunk, op for op in fp32, with
    ``g``'s storage (fp32) or one temporary as scratch."""
    if g.dtype == torch.float32:
        g.mul_(scale)
    else:
        g = g.float().mul_(scale)
    mf = m if m.dtype == torch.float32 else m.float()
    vf = v if v.dtype == torch.float32 else v.float()
    t = torch.mul(g, 1 - b1)
    mf.mul_(b1).add_(t)                      # b1 m + (1 - b1) g
    torch.mul(g, g, out=t).mul_(1 - b2)
    vf.mul_(b2).add_(t)                      # b2 v + (1 - b2) g^2
    torch.div(vf, b2c, out=t).sqrt_().add_(eps)
    torch.div(mf, b1c, out=g).div_(t)        # update, into g's storage
    if wd:
        t.copy_(p)
        g.add_(t.mul_(wd))
    g.mul_(lr)
    t.copy_(p)
    p.copy_(t.sub_(g))
    if mf is not m:
        m.copy_(mf)
        v.copy_(vf)
