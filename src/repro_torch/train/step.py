"""Device-side step functions, serving half (the counterpart of the
``make_prefill`` / ``make_serve_step`` half of ``repro.train.step``).

The train half (``weighted_loss``, ``make_train_step``) waits for a
later slice of the port.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Model

__all__ = ["make_serve_step", "make_prefill"]


def make_serve_step(model: Model, *, paged: bool = True):
    """One-token paged decode step; greedy sampling is left to the caller.

    ``(params, state, table, pos, tokens) -> (next_token_logits (B, V),
    state)`` with ``table (B, max_pages)`` page ids and ``pos (B,)``
    per-row positions over :meth:`Model.init_paged_state` pools (updated
    in place) — the continuous-batching spelling, where admission and
    eviction are pure data. The dense-cache spelling (``paged=False``)
    is not ported.
    """
    if not paged:
        raise NotImplementedError("only the paged decode step is ported")

    @torch.no_grad()
    def serve_step_paged(params, state, table, pos, tokens):
        logits, state = model.decode_step_paged(params, state, table, pos,
                                                tokens=tokens)
        return logits[:, -1, :], state

    return serve_step_paged


def make_prefill(model: Model, *, return_cache: bool = True):
    """The fused cache-filling prefill: ``(params, tokens) ->
    (all_logits (B, S, V), state)`` where ``state`` matches
    :meth:`Model.init_decode_state` leaf for leaf, so decode continues
    from position S without re-running the prompt. The logits-only
    spelling (``return_cache=False``) is not ported.
    """
    if not return_cache:
        raise NotImplementedError("only the cache-filling prefill is ported")

    @torch.no_grad()
    def prefill_cached(params, tokens):
        return model.prefill(params, tokens)

    return prefill_cached
