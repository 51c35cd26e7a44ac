"""Deterministic serving workload (the serving half of
``repro.data.pipeline``, copied).

Every request is derived from ``(seed, req_id)`` through counter-based
Philox — the same counters as the JAX package, so both packages draw
identical request streams, and any replica (or a requeue after a
replica death) can re-materialize request ``i`` without coordination.
The training half (``ShardedTokenPipeline``, ``spare_batch``) waits for
the training slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["ServeRequest", "RequestStream"]


@dataclass
class ServeRequest:
    """One decode request for the serving tier.

    ``tokens`` is the exact-length prompt (no padding — the SSM prefill
    runs through every token); ``max_new`` counts generated tokens
    including the one the prefill itself produces.
    """

    req_id: int
    tokens: np.ndarray                    # (L,) int32
    max_new: int
    generated: list = field(default_factory=list, repr=False)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


class RequestStream:
    """Reproducible serving workload: req_id -> ServeRequest.

    Counter-based Philox keyed per *request* — any replica (or a requeue after a replica
    death) can re-materialize request ``i`` without coordination, which
    is what makes the zero-dropped-requests assertion exact: a requeued
    request is bit-identical to its first admission, and greedy decode
    then reproduces the same output tokens on any survivor.

    Prompt lengths are drawn from a small fixed ``buckets`` set — the
    engine compiles one prefill executable per bucket (exact lengths, no
    padding: see :meth:`repro_torch.models.model.Model.prefill`).
    """

    def __init__(self, cfg: ModelConfig, buckets: tuple[int, ...] = (8, 16),
                 max_new: int = 8, seed: int = 0):
        if not buckets:
            raise ValueError("need at least one prompt-length bucket")
        self.cfg = cfg
        self.buckets = tuple(sorted(buckets))
        self.max_new = max_new
        self.seed = seed

    def request(self, req_id: int) -> ServeRequest:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[req_id, 0, 0, 0]))
        length = self.buckets[int(rng.integers(len(self.buckets)))]
        toks = rng.integers(0, self.cfg.vocab, (length,), dtype=np.int32)
        return ServeRequest(req_id=req_id, tokens=toks, max_new=self.max_new)

    def requests(self, n: int, start: int = 0) -> list[ServeRequest]:
        return [self.request(i) for i in range(start, start + n)]
