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
  counts no recompile.

On one card this is the program every rank of a 100k-GPU run executes,
on a one-rank group. The JAX package's ``sync="gspmd"``, the prefetch
thread and the HLO wire audit (``compiled_step_text``,
``_observe_sync``) have no counterpart here (ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch.data import spare_batch_rows
from repro_torch.dist.collectives import (BucketedAllReduce,
                                          CompressedBucketSync,
                                          bucket_layout, unflatten_grads)
from repro_torch.launch.mesh import init_data_group, require_nccl
from repro_torch.models.config import ModelConfig
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
    sync: ``"shard_map"`` only (the explicit bucketed sync); the JAX
        package's ``"gspmd"`` is not ported.
    grad_compress: ``None`` (fp32 buckets on the wire) or ``"int8_ef"``.
    bucket_mb: flat-bucket size cap in MiB of fp32 — the sync issues
        O(total_params / bucket) collectives per step, never one per leaf.
    """

    def __init__(self, cfg: ModelConfig, *, n_groups: int, redundancy: int,
                 group=None, sync: str = "shard_map",
                 grad_compress: str | None = None, bucket_mb: float = 32.0,
                 base_lr: float = 3e-4, total_steps: int = 1000,
                 device: torch.device | str = "cuda", **kwargs: Any):
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
        self._step_fn = make_train_step(
            self.model, base_lr=self._base_lr, total_steps=self.total_steps,
            group=self.group, grad_sync=self._grad_sync)

    # ------------------------------------------------------------- #
    # per-rank input feeding                                        #
    # ------------------------------------------------------------- #
    def _rows(self) -> tuple[int, int]:
        """Example rows ``[lo, hi)`` of the stacked batch this rank
        feeds."""
        per = self.state.n * self.pipeline.per_type_batch // self.data_degree
        return self.rank * per, (self.rank + 1) * per

    def _device_batch(self, step: int | None = None, state=None) -> dict:
        state = self.state if state is None else state
        step = self.step if step is None else step
        lo, hi = self._rows()
        rows = spare_batch_rows(self.pipeline, state.device_schedule(),
                                state.s_a, step, lo, hi)
        return self._to_device(rows)

    def _dispatch(self, report: TrainReport):
        batch = self._device_batch()
        fn = self._compiled(self.state.s_a, report)
        if self.grad_compress:
            params, opt_state, metrics, self._ef_state = fn(
                self.params, self.opt_state, batch, self._ef_state)
            return params, opt_state, metrics
        return fn(self.params, self.opt_state, batch)

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
        Eager PyTorch builds nothing, so this only records the depths."""
        for s_a in sorted(set(int(d) for d in depths)):
            if not 1 <= s_a <= self.state.r:
                raise ValueError(f"stack depth {s_a} outside "
                                 f"[1, r={self.state.r}]")
            self._jitted.setdefault(s_a, self._step_fn)

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
