"""The ``"dots"`` remat policy: a recomputed block keeps the outputs of
its products with no batch dimension and recomputes everything else in
the backward (the counterpart of JAX's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).

The products are marked where the model spells them: :func:`dot` is
``x @ w`` for a weight ``w`` that shares no dimension with ``x`` but the
contracted one (a projection, the router, an expert's gate and up
products as JAX's ``td,edf->etf`` spells them), so it has no batch
dimension in ``dot_general``'s sense. Products that carry one (the
attention scores' ``bhqk`` einsums, MLA's latent products over ``h``, a
product over the experts' axis ``e``) are spelled plainly and
recomputed, as the elementwise ops and the kernels K1, K2 and K4 are.
Nothing is inferred from the aten op names alone: ``torch.matmul`` of a
3-D activation by a 2-D weight reaches ``aten.mm``, and a batched
``torch.einsum`` reaches ``aten.bmm`` too; the mark decides, and within
a marked product only its product op (not its views) is kept.

:func:`dots_contexts` gives ``torch.utils.checkpoint.checkpoint`` its
``context_fn`` (``use_reentrant=False``): in the forward a dispatch mode
keeps each marked product's output, in the recompute another hands them
back in the same order instead of computing them. Every other op runs
again, so each allocation is made anew: the kernels write their outputs
through ``ctypes`` into tensors from ``torch.empty``, which a cached
allocation would hand back stale. :func:`hold` then puts the kept
outputs into the autograd graph beside the block's output, so that
``torch.autograd.graph.saved_tensors_hooks`` sees what the policy keeps.
"""
from __future__ import annotations

import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["dot", "dots_contexts", "hold"]

_MARK = threading.local()

_aten = torch.ops.aten
#: the aten ops a marked product reaches
_PRODUCTS = frozenset({_aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm})


def _marked(func) -> bool:
    return getattr(_MARK, "depth", 0) > 0 and \
        func.overloadpacket in _PRODUCTS


def dot(x: torch.Tensor, w: torch.Tensor, keep: bool = True) -> torch.Tensor:
    """``x @ w``, a product with no batch dimension: under the ``"dots"``
    policy its output is kept for the backward (``keep=False`` spells a
    product the policy recomputes, as JAX's recomputes a product over a
    batch dimension)."""
    if not keep:
        return torch.matmul(x, w)
    _MARK.depth = getattr(_MARK, "depth", 0) + 1
    try:
        return torch.matmul(x, w)
    finally:
        _MARK.depth -= 1


class _Keep(TorchDispatchMode):
    """The forward: every op runs; each marked product's output is kept."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _marked(func):
            self.kept.append(out.detach())
        return out


class _Replay(TorchDispatchMode):
    """The recompute: each marked product hands back its kept output, in
    the forward's order; every other op runs again."""

    def __init__(self, kept: list):
        super().__init__()
        self.kept = kept
        self.next = 0

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _marked(func):
            out = self.kept[self.next]
            self.next += 1
            return out.detach()
        return func(*args, **(kwargs or {}))


def dots_contexts(kept: list):
    """``checkpoint``'s ``context_fn`` for the ``"dots"`` policy, keeping
    the marked products' outputs in ``kept``."""
    return _Keep(kept), _Replay(kept)


class _Held(torch.autograd.Function):
    """Identity on ``x``; saves the kept products for the backward."""

    @staticmethod
    def forward(ctx, x, *kept):
        ctx.save_for_backward(*kept)
        ctx.n = len(kept)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * ctx.n


def hold(x: torch.Tensor, kept: list) -> torch.Tensor:
    """``x`` with the products ``kept`` for its block saved beside it in
    the autograd graph (the gradient passes through unchanged)."""
    return _Held.apply(x, *kept) if kept else x

