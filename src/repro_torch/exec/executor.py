"""MeshExecutor — SPARe's Alg. 1 on data-parallel ranks (the PyTorch
counterpart of ``repro.exec.executor``, in its ``shard_map`` spelling).

:class:`MeshExecutor` is :class:`repro_torch.train.trainer.SpareTrainer`
with the step run by every rank of a ``torch.distributed`` group, one
SPARe data slice per rank:

* each rank feeds only its own example rows of the stacked batch
  (:func:`repro_torch.data.spare_batch_rows`), computes its local
  supplier-weighted partial gradient, and the partials are summed ONCE
  per step by the bucketed sync: :class:`~repro_torch.dist.collectives
  .BucketedAllReduce` (fp32 buckets) or, with ``grad_compress=
  "int8_ef"``, :class:`~repro_torch.dist.collectives.
  CompressedBucketSync` (int8 payloads and fp32 scales over the wire,
  EF residuals as this rank's state);
* parameters are replicas (pure data parallelism), so the program has no
  tensor-parallel collectives;
* failure masking is pure weight-table data: after ``scheme.recover``
  re-plans the schedule, the next step feeds the new weights through the
  batch — no new collectives, nothing rebuilt;
* the EF residuals are snapshotted and rolled back with the params (the
  memory tier only: a disk checkpoint holds params and optimizer state,
  as the JAX package's does);
* with ``ckpt_dir=`` and ``detector=`` (passed on to the trainer) the
  disk checkpoint and the gray-failure tier run as in
  :class:`~repro_torch.train.trainer.SpareTrainer`; a demotion or
  re-admission is a weight-table edit, and :meth:`prewarm_depths`
  registers the stack depths it may reach ahead of the run, so it
  counts no run-attributed recompile.

Input feeding is double-buffered, as in the JAX package: while step
``t`` runs, a one-worker thread builds step ``t+1``'s host rows
(:func:`repro_torch.data.spare_batch_rows`, pure numpy); the copy to the
device stays on the calling thread. A prefetched slab feeds a step only
if its key (schedule version, step, ``S_A`` and the schedule arrays)
matches that step's, so after a recovery or a rollback the stale slab is
dropped and the rows are built synchronously. Telemetry: a ``feed`` span
around each batch build and the ``feed.prefetch_hits`` /
``feed.prefetch_misses`` counters; after every step the ``sync.*`` wire
metrics of the gradient sync (:meth:`MeshExecutor._observe_sync`).

On one card this is the program every rank of a 100k-GPU run executes,
on a one-rank group. The JAX package's ``sync="gspmd"`` with
tensor-parallel ``model_degree`` (``dist/sharding.py``) and its HLO
wire audit (``compiled_step_text``) have no counterpart here
(ROADMAP.md §1).
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.data import spare_batch_rows
from repro_torch.dist.collectives import (BucketedAllReduce,
                                          CompressedBucketSync,
                                          bucket_layout, unflatten_grads)
from repro_torch.launch.mesh import init_data_group, require_nccl
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import maybe_span
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step)
from repro_torch.ckpt.checkpoint import copy_into, host_copy
from repro_torch.train.trainer import SpareTrainer, TrainReport

__all__ = ["MeshExecutor"]

_COMPRESS = (None, "int8_ef")


class MeshExecutor(SpareTrainer):
    """Drop-in :class:`SpareTrainer` whose step runs on the ranks of a
    data-parallel group.

    Extra parameters on top of the trainer's:

    group: the ``torch.distributed`` group whose ranks are the data
        slices; by default the default group, initialised with one rank
        on ``device`` if it is not up (:func:`repro_torch.launch.mesh
        .init_data_group`).
    model_degree: ``1`` only: parameters are replicas on every rank
        (tensor parallelism, the JAX package's ``dist/sharding.py``, is
        not ported).
    sync: ``"shard_map"`` only (the explicit bucketed sync); the JAX
        package's ``"gspmd"`` is not ported.
    grad_compress: ``None`` (fp32 buckets on the wire) or ``"int8_ef"``.
    bucket_mb: flat-bucket size cap in MiB of fp32 — the sync issues
        O(total_params / bucket) collectives per step, never one per leaf.
    """

    def __init__(self, cfg: ModelConfig, *, n_groups: int, redundancy: int,
                 group=None, model_degree: int = 1, sync: str = "shard_map",
                 grad_compress: str | None = None, bucket_mb: float = 32.0,
                 base_lr: float = 3e-4, total_steps: int = 1000,
                 device: torch.device | str = "cuda", **kwargs: Any):
        if model_degree != 1:
            raise NotImplementedError(
                f"model_degree={model_degree}: tensor parallelism "
                f"(dist/sharding.py) is not ported (ROADMAP.md §1)")
        if sync != "shard_map":
            raise NotImplementedError(
                f"sync={sync!r}: only the shard_map spelling is ported "
                f"(ROADMAP.md)")
        if grad_compress not in _COMPRESS:
            raise ValueError(f"grad_compress must be one of {_COMPRESS}, "
                             f"got {grad_compress!r}")
        super().__init__(cfg, n_groups=n_groups, redundancy=redundancy,
                         base_lr=base_lr, total_steps=total_steps,
                         device=device, **kwargs)
        self.group = group if group is not None \
            else init_data_group(self.device)
        if self.device.type == "cuda":
            require_nccl(self.group)
        self.sync = sync
        self.grad_compress = grad_compress
        self.model_degree = model_degree
        self.data_degree = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        examples = n_groups * self.pipeline.per_type_batch
        if examples % self.data_degree != 0:
            raise ValueError(
                f"{examples} stacked examples do not divide the data axis "
                f"({self.data_degree}); pick per_type_batch so that "
                f"N*per_type_batch % data == 0")
        # the bucketed flat sync: O(n_buckets) collectives per step, the
        # buckets padded to the data degree; they are the accumulator
        self._layout = bucket_layout(
            accumulator_specs(self.params),
            max_bucket_elems=max(int(bucket_mb * (1 << 20) // 4),
                                 self.data_degree),
            pad_to=self.data_degree)
        self._ef_state = None
        self._ef_snapshot = None
        if grad_compress == "int8_ef":
            self._grad_sync = CompressedBucketSync(
                self._layout, self.data_degree, self.group)
            self._ef_state = self._grad_sync.init_state(self.device)
        else:
            self._grad_sync = BucketedAllReduce(self._layout, self.group)
        if self.telemetry is not None and self.telemetry.deep:
            self._grad_sync.tel = self.telemetry
        self._step_fn = make_train_step(
            self.model, base_lr=self._base_lr, total_steps=self.total_steps,
            group=self.group, grad_sync=self._grad_sync)
        # the one-slot double buffer: the feeding thread makes the next
        # step's host rows while the dispatched step runs
        self._feed_pool = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="feed")
        self._prefetch: tuple[tuple, Future] | None = None

    # ------------------------------------------------------------- #
    # the step cache (what the JAX package compiles per key)        #
    # ------------------------------------------------------------- #
    def _cache_key(self, s_a: int) -> tuple[int, int, int]:
        """Step-cache key ``(data_degree, model_degree, s_a)``, the JAX
        package's executable-cache key."""
        return (self.data_degree, self.model_degree, s_a)

    @property
    def compiled_depths(self) -> list[int]:
        """``S_A`` depths with a registered step for the current data
        and model degrees: a failure re-weight at constant ``S_A`` must
        not grow this."""
        shape = (self.data_degree, self.model_degree)
        return sorted(s_a for (d, m, s_a) in self._jitted
                      if (d, m) == shape)

    @property
    def cache_keys(self) -> list[tuple[int, int, int]]:
        """Every step-cache key, ``(data, model, s_a)``."""
        return sorted(self._jitted)

    # ------------------------------------------------------------- #
    # per-rank input feeding                                        #
    # ------------------------------------------------------------- #
    def _rows(self) -> tuple[int, int]:
        """Example rows ``[lo, hi)`` of the stacked batch this rank
        feeds."""
        per = self.state.n * self.pipeline.per_type_batch // self.data_degree
        return self.rank * per, (self.rank + 1) * per

    def _batch_key(self, state, step: int):
        """Prefetch identity: the batch is a pure function of the step
        and the schedule, whose arrays are snapshotted here so the
        feeding thread never reads mutable trainer state."""
        stack_types, wts = state.device_schedule()
        key = (self._schedule_version, step, state.s_a,
               stack_types.tobytes(), wts.tobytes())
        return key, (stack_types, wts)

    def _device_batch(self, step: int | None = None, state=None) -> dict:
        state = self.state if state is None else state
        step = self.step if step is None else step
        key, schedule = self._batch_key(state, step)
        tel = self.telemetry
        hit = False
        with maybe_span(tel, "feed"):
            rows = None
            if self._prefetch is not None:
                pkey, fut = self._prefetch
                self._prefetch = None
                if pkey == key:
                    rows = fut.result()
                    hit = True
                # else: a recovery re-planned the schedule, a rollback
                # moved the step, or the caller asked for another batch:
                # the prefetched rows are stale; build synchronously
            if rows is None:
                lo, hi = self._rows()
                rows = spare_batch_rows(self.pipeline, schedule, state.s_a,
                                        step, lo, hi)
            out = self._to_device(rows)
        if tel is not None:
            tel.counter("feed.prefetch_hits" if hit
                        else "feed.prefetch_misses").inc()
        return out

    def _prefetch_next(self) -> None:
        """Double buffer: queue the next step's rows on the feeding
        thread while the current step runs."""
        key, schedule = self._batch_key(self.state, self.step + 1)
        lo, hi = self._rows()
        self._prefetch = (key, self._feed_pool.submit(
            spare_batch_rows, self.pipeline, schedule, self.state.s_a,
            self.step + 1, lo, hi))

    def _dispatch(self, report: TrainReport):
        batch = self._device_batch()
        fn = self._compiled(self.state.s_a, report)
        if self.grad_compress:
            params, opt_state, metrics, self._ef_state = fn(
                self.params, self.opt_state, batch, self._ef_state)
            out = (params, opt_state, metrics)
        else:
            out = fn(self.params, self.opt_state, batch)
        # the step is queued (on a card it runs asynchronously): build
        # the next step's rows meanwhile
        self._prefetch_next()
        if self.telemetry is not None:
            self._observe_sync(self.telemetry)
        return out

    def _observe_sync(self, tel) -> None:
        """Publish the step's gradient-sync wire accounting: the gauges
        ``sync.wire_bytes_per_step`` and ``sync.collectives_per_step``
        and the counter ``sync.wire_bytes_total``. The numbers are this
        rank's for one step, counted by the sync where it calls each
        collective (:mod:`repro_torch.dist.collectives`): bytes moved
        per rank with the ring multipliers, not the HLO audit's
        reading of a compiled program. Deep mode adds the int8 EF
        residual norms ``sync.ef_residual_norm.{err1,err2}`` of this
        rank's residuals (one rank's are the whole state on one card),
        which synchronise the device."""
        sync = self._grad_sync
        tel.gauge("sync.wire_bytes_per_step").set(sync.wire_bytes)
        tel.gauge("sync.collectives_per_step").set(sync.wire_collectives)
        tel.counter("sync.wire_bytes_total").inc(sync.wire_bytes)
        if tel.deep and self._ef_state is not None:
            for fam in ("err1", "err2"):
                sq = sum(float(torch.dot(b, b)) for b in self._ef_state[fam])
                tel.gauge(f"sync.ef_residual_norm.{fam}").set(sq ** 0.5)

    def run(self, *args, **kwargs):
        try:
            return super().run(*args, **kwargs)
        finally:
            # the last step's prefetch built rows for a step that will
            # not run: do not keep them
            self._prefetch = None

    def close(self) -> None:
        """Release the feeding thread and any prefetched rows. The
        process group stays up (a next executor reuses it); this
        executor must not run further steps."""
        self._prefetch = None
        self._feed_pool.shutdown(wait=True, cancel_futures=True)

    # ------------------------------------------------------------- #
    # snapshot / rollback (EF residuals ride along)                 #
    # ------------------------------------------------------------- #
    def _snapshot_now(self) -> None:
        super()._snapshot_now()
        if self._ef_state is not None:
            self._ef_snapshot = host_copy(self._ef_state, self._ef_snapshot)

    def _rollback(self):
        """Wipe-out restore, in place: the EF residuals roll back to the
        same step as params (the untransmitted signal belongs to the
        discarded trajectory)."""
        out = super()._rollback()
        if self._ef_snapshot is not None:
            copy_into(self._ef_state, self._ef_snapshot)
        return out

    def prewarm_depths(self, depths) -> None:
        """Register the step for each stack depth in ``depths`` ahead of
        need, as the JAX executor compiles them: a SPARe demotion often
        forces ``S_A`` one deeper, and a warmed depth makes the demote a
        pure weight-table edit that counts no run-attributed recompile.
        Eager PyTorch builds nothing, so this only records the depths;
        each new one counts toward ``total_recompiles`` only."""
        for s_a in sorted(set(int(d) for d in depths)):
            if not 1 <= s_a <= self.state.r:
                raise ValueError(f"stack depth {s_a} outside "
                                 f"[1, r={self.state.r}]")
            self._compiled(s_a)

    # ------------------------------------------------------------- #
    # gradient oracle (data-parallel spelling)                      #
    # ------------------------------------------------------------- #
    def mesh_grads(self, step: int | None = None, state=None):
        """Total-batch gradient of the given (default: current) schedule
        computed BY THE RANKS: each its rows' partial, then the sync
        (with zero EF residuals under ``grad_compress``). Must match
        :meth:`SpareTrainer.spare_grads` up to all-reduce summation
        order, plus one step's bounded quantization error when
        compressed (``exec/equivalence.py::int8_sweep_tolerance``).
        Returns fp32 views into fresh buckets."""
        bufs = self._layout.zeros(self.device)
        grads = unflatten_grads(self._layout, bufs)
        accumulate_grads(self.model, self.params,
                         self._device_batch(step, state), grads)
        if self.grad_compress:
            return self._grad_sync.sync_once(bufs)
        return self._grad_sync(bufs)
