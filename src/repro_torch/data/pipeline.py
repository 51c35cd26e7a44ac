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

from repro_torch.core.state import SpareState
from repro_torch.models.config import ModelConfig

__all__ = ["ShardedTokenPipeline", "spare_batch", "spare_batch_rows",
           "ServeRequest", "RequestStream"]


class ShardedTokenPipeline:
    """Reproducible token stream: (type, step) -> (per_type_batch, seq+1)."""

    def __init__(self, cfg: ModelConfig, seq: int, per_type_batch: int,
                 seed: int = 0):
        self.cfg = cfg
        self.seq = seq
        self.per_type_batch = per_type_batch
        self.seed = seed

    def shard(self, shard_type: int, step: int) -> np.ndarray:
        """Tokens (per_type_batch, seq+1) for one shard type at one step."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[shard_type, step, 0, 0]))
        return rng.integers(0, self.cfg.vocab,
                            (self.per_type_batch, self.seq + 1),
                            dtype=np.int32)

    def embeds(self, shard_type: int, step: int) -> np.ndarray:
        """Frontend-stub embeddings (audio frames / vision patches)."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed + 1, counter=[shard_type, step, 0, 0]))
        return rng.standard_normal(
            (self.per_type_batch, self.seq, self.cfg.d_model)
        ).astype(np.float32) * 0.02


def spare_batch_rows(pipeline: ShardedTokenPipeline,
                     schedule: tuple[np.ndarray, np.ndarray], s_a: int,
                     step: int, lo: int, hi: int) -> dict[str, np.ndarray]:
    """Example rows ``[lo, hi)`` of the stacked batch — the per-host cut.

    ``schedule`` is ``state.device_schedule()``'s ``(stack_types,
    weights)`` pair, passed as plain arrays so a prefetch thread can
    build rows without touching mutable trainer state. Only the shard
    types owned by groups ``lo // per_type_batch .. (hi - 1) //
    per_type_batch`` are materialized — a host feeding its addressable
    shards via ``jax.make_array_from_callback`` never pays for the
    global batch. Row content is identical to the same rows of
    :func:`spare_batch` (the counter-based pipeline makes every slice a
    pure function of ``(type, step)``).
    """
    stack_types, wts = schedule
    ptb = pipeline.per_type_batch
    use_embeds = pipeline.cfg.frontend is not None
    rows = hi - lo

    toks = np.zeros((s_a, rows, pipeline.seq + 1), np.int32)
    embeds = (np.zeros((s_a, rows, pipeline.seq, pipeline.cfg.d_model),
                       np.float32) if use_embeds else None)
    weights = np.zeros((s_a, rows), np.float64)
    for w in range(lo // ptb, (hi + ptb - 1) // ptb):
        glo = w * ptb                      # group w's global row range
        dlo, dhi = max(glo, lo), min(glo + ptb, hi)
        src = slice(dlo - glo, dhi - glo)  # within the group's shard
        dst = slice(dlo - lo, dhi - lo)    # within this cut
        for j in range(s_a):
            t = int(stack_types[w, j])
            toks[j, dst] = pipeline.shard(t, step)[src]
            if use_embeds:
                embeds[j, dst] = pipeline.embeds(t, step)[src]
            # per-example weight: supplier weight (1/N or 0) divided by the
            # per-type batch so sum_jb pw * CE_b == (1/N) sum_i mean_i(CE)
            # == vanilla DP's batch-mean loss
            weights[j, dst] = wts[w, j] / ptb
    batch = {
        "labels": toks[:, :, 1:],
        "weights": weights.astype(np.float32),
    }
    if use_embeds:
        batch["embeds"] = embeds
    else:
        batch["tokens"] = toks[:, :, :-1]
    return batch


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


def spare_batch(pipeline: ShardedTokenPipeline, state: SpareState,
                step: int) -> dict[str, np.ndarray]:
    """Global stacked batch for the current SPARe schedule.

    Returns dict with:
      tokens/embeds: (S_A, N*per_type_batch, seq[(+1 tokens)])
      labels:        (S_A, N*per_type_batch, seq)
      weights:       (S_A, N*per_type_batch)  — per-example supplier weight,
                     scaled so a plain sum of weighted per-example mean-CE
                     gradients equals vanilla DP's batch-mean gradient.
    """
    return spare_batch_rows(pipeline, state.device_schedule(), state.s_a,
                            step, 0, state.n * pipeline.per_type_batch)
