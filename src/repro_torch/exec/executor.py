"""MeshExecutor — SPARe's Alg. 1 on a ``(data, model)`` grid of ranks
(the PyTorch counterpart of ``repro.exec.executor``).

:class:`MeshExecutor` is :class:`repro_torch.train.trainer.SpareTrainer`
with the step run by every rank of a ``torch.distributed`` group. The
group is the whole grid: at model degree ``M`` its ``world`` ranks are
``world // M`` data slices of ``M`` model ranks each, rank ``d * M + m``
at grid point ``(d, m)`` (:func:`repro_torch.launch.mesh
.init_mesh_groups`), as the JAX package's ``(data, model)`` mesh. Two
sync spellings, the JAX package's:

* ``sync="shard_map"`` (default): every rank holds replicas of all
  parameters. Each data slice feeds only its own example rows of the
  stacked batch (:func:`repro_torch.data.spare_batch_rows`), so the
  model ranks of one slice compute the same gradient; the
  supplier-weighted partials are summed ONCE per step over the data
  group (the ranks of one model column) by the bucketed sync:
  :class:`~repro_torch.dist.collectives.BucketedAllReduce` (fp32
  buckets) or, with ``grad_compress="int8_ef"``,
  :class:`~repro_torch.dist.collectives.CompressedBucketSync` (int8
  payloads and fp32 scales over the wire, EF residuals as the state of
  the rank's place in its data group). The buckets are padded to the
  data degree.
* ``sync="gspmd"``: each rank stores only its column block of every
  leaf :func:`executor_param_specs` puts on ``model`` (JAX's rule: a
  leaf of ``ndim >= 2`` whose last dim the degree divides), and its
  AdamW moments mirror it; the other leaves are stored whole. A step
  gathers the whole tree over the model group in bucketed all-gathers
  (:class:`~repro_torch.dist.collectives.BucketedAllGather`, O(n_buckets)
  collectives), runs forward and backward on the slice's rows,
  all-reduces the gradient over the data group in fp32 buckets, and
  each rank runs AdamW on its own columns, clipped by the whole
  gradient's norm. This gather-on-use program is one of those GSPMD may
  derive from the JAX package's shardings and computes the same
  function; Megatron-style column- and row-parallel products, which
  keep activations sharded, are a later lever (``ROADMAP.md``).
  ``grad_compress="int8_ef"`` is refused, as in the JAX package.

Failure masking is pure weight-table data in both: after
``scheme.recover`` re-plans the schedule, the next step feeds the new
weights through the batch — no new collectives, nothing rebuilt. Each
rank snapshots and rolls back its own state (under ``gspmd`` its
blocks; the EF residuals ride along with the memory tier). With
``ckpt_dir=`` the disk checkpoint holds the whole leaves, gathered
before the grid's rank 0 writes them, so the file is the one a model
degree 1 run writes of the same state (the JAX package saves global
arrays); the directory is shared: rank 0 sweeps its crash leftovers
while the others wait, then they open it without sweeping. With
``detector=`` the gray-failure tier runs as in the trainer; a demotion
or re-admission is a weight-table edit, and :meth:`prewarm_depths`
registers the stack depths it may reach ahead of the run.

Input feeding is double-buffered, as in the JAX package: while step
``t`` runs, a one-worker thread builds step ``t+1``'s host rows
(:func:`repro_torch.data.spare_batch_rows`, pure numpy); the copy to the
device stays on the calling thread. A prefetched slab feeds a step only
if its key (schedule version, step, ``S_A`` and the schedule arrays)
matches that step's, so after a recovery or a rollback the stale slab is
dropped and the rows are built synchronously. Telemetry: a ``feed`` span
around each batch build and the ``feed.prefetch_hits`` /
``feed.prefetch_misses`` counters; after every step the ``sync.*`` wire
metrics of the gradient sync and, under ``gspmd``, of the gathers
(:meth:`MeshExecutor._observe_sync`).

On one card this is the program every rank of a 100k-GPU run executes,
on a one-rank group; several ranks run it under
:func:`repro_torch.launch.mesh.spawn_ranks` (ranks that share a card do
so over gloo). Every piece of the step plumbing that depends on the
data group is bound in :meth:`MeshExecutor._bind_group`, which the
elastic tier (:class:`repro_torch.elastic.ElasticMeshExecutor`) calls
again on a survivor group of data rows. The JAX package's HLO
wire audit reads ``compiled_step_text`` and ``donated_leaves``; here
:meth:`~repro_torch.train.trainer.SpareTrainer.step_log` records one
step of a schedule (its collectives, host reads and the storage of
:meth:`~repro_torch.train.trainer.SpareTrainer.state_leaves`) for the
step passes of :mod:`repro_torch.analysis`.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.data import spare_batch_rows
from repro_torch.dist.collectives import (BucketedAllGather,
                                          BucketedAllReduce,
                                          CompressedBucketSync,
                                          bucket_layout, bucket_views,
                                          collective, tree_leaves)
from repro_torch.launch.mesh import (init_data_group, init_mesh_groups,
                                     require_nccl, shares_card)
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import maybe_span
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step)
from repro_torch.ckpt.checkpoint import copy_into, host_copy
from repro_torch.train.trainer import SpareTrainer, TrainReport

__all__ = ["MeshExecutor", "executor_param_specs"]

_SYNCS = ("shard_map", "gspmd")
_COMPRESS = (None, "int8_ef")


def _tree_map(fn, *trees):
    """``fn`` over the leaves of same-structured trees of dicts, lists
    and tuples, keeping the first's structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def executor_param_specs(params, model_degree: int):
    """Model-axis specs of the ``gspmd`` layout (the JAX package's rule):
    every leaf of ``ndim >= 2`` whose last dim divides the degree is
    column-sharded on ``model``, ``(None, ..., "model")``; everything
    else (norm scales, biases, ragged leaves) is replicated, ``()``. All
    leaves are replicated across ``data``. Specs are tuples, as in
    :mod:`repro_torch.dist.sharding`; the tree has ``params``'
    structure."""
    def spec(leaf):
        if leaf.ndim >= 2 and leaf.shape[-1] % model_degree == 0:
            return (None,) * (leaf.ndim - 1) + ("model",)
        return ()

    return _tree_map(spec, params)


class MeshExecutor(SpareTrainer):
    """Drop-in :class:`SpareTrainer` whose step runs on the ranks of a
    ``(data, model)`` grid.

    Extra parameters on top of the trainer's:

    group: the ``torch.distributed`` group of the whole grid (``world``
        ranks, ``world // model_degree`` data slices); by default the
        default group, initialised with one rank on ``device`` if it is
        not up (:func:`repro_torch.launch.mesh.init_data_group`). On
        ``cuda`` its CUDA tensors go over NCCL, or over gloo where its
        ranks share a card.
    model_degree: the model axis' size ``M``: under ``gspmd`` the
        tensor-parallel degree; under ``shard_map`` the model ranks of a
        data slice are replicas.
    sync: ``"shard_map"`` (explicit bucketed sync over the data group,
        replicated parameters) or ``"gspmd"`` (parameters and moments
        column-sharded on the model group) — see the module doc.
    grad_compress: ``None`` (fp32 buckets on the wire) or ``"int8_ef"``
        (``shard_map`` only).
    bucket_mb: flat-bucket size cap in MiB of fp32 — the sync (and the
        gathers) issue O(total_params / bucket) collectives per step,
        never one per leaf.
    """

    def __init__(self, cfg: ModelConfig, *, n_groups: int, redundancy: int,
                 group=None, model_degree: int = 1, sync: str = "shard_map",
                 grad_compress: str | None = None, bucket_mb: float = 32.0,
                 base_lr: float = 3e-4, total_steps: int = 1000,
                 device: torch.device | str = "cuda", **kwargs: Any):
        if sync not in _SYNCS:
            raise ValueError(f"sync must be one of {_SYNCS}, got {sync!r}")
        if grad_compress not in _COMPRESS:
            raise ValueError(f"grad_compress must be one of {_COMPRESS}, "
                             f"got {grad_compress!r}")
        if grad_compress and sync != "shard_map":
            raise ValueError(
                "grad_compress needs the manual collective program: use "
                "sync='shard_map' (gspmd derives its own fp32 all-reduce)")
        world = dist.get_world_size(group) if group is not None else (
            dist.get_world_size() if dist.is_initialized() else 1)
        if model_degree < 1 or world % model_degree:
            raise ValueError(f"{world} ranks do not tile a grid of model "
                             f"degree {model_degree}")
        # the checkpoint directory opens once the rank is known
        ckpt_dir = kwargs.pop("ckpt_dir", None)
        super().__init__(cfg, n_groups=n_groups, redundancy=redundancy,
                         base_lr=base_lr, total_steps=total_steps,
                         device=device, **kwargs)
        if group is None:
            group = dist.group.WORLD if dist.is_initialized() \
                else init_data_group(self.device)
        # gloo carries CUDA tensors only where the ranks share a card
        # (NCCL refuses two ranks on one device)
        if self.device.type == "cuda" and not shares_card(group):
            require_nccl(group)
        self.sync = sync
        self.grad_compress = grad_compress
        self.model_degree = int(model_degree)
        self.grid_group = group
        grid = init_mesh_groups(group, self.model_degree)
        self.model_group = grid.model_group
        self.model_rank = grid.model_rank
        self._phys_rank = dist.get_rank(grid.data_group)
        examples = n_groups * self.pipeline.per_type_batch
        if examples % grid.data_degree != 0:
            raise ValueError(
                f"{examples} stacked examples do not divide the data axis "
                f"({grid.data_degree}); pick per_type_batch so that "
                f"N*per_type_batch % data == 0")
        # the bucketed flat sync: O(n_buckets) collectives per step, the
        # buckets padded to the data degree; in fp32 they are the
        # accumulator (a narrower accumulator is synced through them).
        # The layout is built ONCE, over the accumulator's dtype (as the
        # JAX package's) and the whole leaves, padded to the
        # construction-time degree, and kept across elastic reshapes:
        # any smaller degree that divides it still tiles every bucket
        max_elems = int(bucket_mb * (1 << 20) // 4)
        self._layout = bucket_layout(
            accumulator_specs(self.params,
                              getattr(torch, cfg.grad_accum_dtype)),
            max_bucket_elems=max(max_elems, grid.data_degree),
            pad_to=grid.data_degree)
        self._ef_state = None
        self._ef_snapshot = None
        self._prefetch: tuple[tuple, Future] | None = None
        self._gather = None
        if sync == "gspmd" and self.model_degree > 1:
            # (at model degree 1 a rank's block is the whole leaf: the
            # state stays as the trainer drew it and nothing is gathered)
            self._shard_state(max_elems)
        self._bind_group(grid.data_group, range(grid.data_degree))
        if ckpt_dir is not None:
            self._open_shared_ckpt(ckpt_dir, dist.get_world_size(group))
        if grad_compress == "int8_ef":
            self._ef_state = self._grad_sync.init_state(self.device)
        # the one-slot double buffer: the feeding thread makes the next
        # step's host rows while the dispatched step runs
        self._feed_pool = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="feed")

    # ------------------------------------------------------------- #
    # the gspmd layout: column blocks on the model group            #
    # ------------------------------------------------------------- #
    def _shard_state(self, max_elems: int) -> None:
        """Keep this rank's column blocks of the sharded leaves (the
        whole tree the trainer drew stays, as the gather's target: it is
        the gathered tree of step 0), and moments like the blocks."""
        self._specs = executor_param_specs(self.params, self.model_degree)
        # which leaves, in the JAX package's order, are sharded
        self._flags = tree_leaves(_tree_map(lambda _, s: bool(s),
                                            self.params, self._specs))
        self._full = self.params
        self._gather = BucketedAllGather(self.model_group,
                                         max_bucket_elems=max_elems)
        self.params = self._blocks(self._full)
        self.opt_state = adamw_init(self.params,
                                    moment_dtype=self.cfg.moment_dtype)

    def _blocks(self, tree):
        """This rank's blocks of a whole tree shaped like the params (the
        params, a moment, the synced gradient): the columns ``[m * c, (m
        + 1) * c)`` of each sharded leaf, as new contiguous tensors; a
        replicated leaf as it is."""
        def cut(t, spec):
            if not spec:
                return t
            c = t.shape[-1] // self.model_degree
            return t[..., self.model_rank * c:
                     (self.model_rank + 1) * c].contiguous()
        return _tree_map(cut, tree, self._specs)

    def _gather_into(self, blocks, fulls) -> None:
        """Fill the sharded leaves of the whole tree ``fulls`` from every
        model rank's ``blocks``: one bucketed all-gather pass."""
        self._gather([t for t, f in zip(tree_leaves(blocks), self._flags)
                      if f],
                     [t for t, f in zip(tree_leaves(fulls), self._flags)
                      if f])

    def _gather_params(self, params):
        """The whole parameter tree the step's forward and backward run
        on: the sharded leaves gathered into the whole-tree buffers, the
        replicated leaves the stored tensors themselves."""
        self._gather_into(params, self._full)
        return _tree_map(lambda blk, full, spec: full if spec else blk,
                         params, self._full, self._specs)

    def full_state(self) -> tuple[Any, AdamWState]:
        """``(params, opt_state)`` with whole leaves, as new tensors on
        every rank: under ``gspmd`` gathered over the model group (a
        collective over it), else copies of the replicas. What the disk
        checkpoint saves."""
        if self._gather is None:
            copy = lambda t: t.clone()  # noqa: E731
            return (_tree_map(copy, self.params), AdamWState(
                step=self.opt_state.step,
                mu=_tree_map(copy, self.opt_state.mu),
                nu=_tree_map(copy, self.opt_state.nu)))

        def whole(tree):
            out = _tree_map(
                lambda blk, full, spec: torch.empty_like(full) if spec
                else blk.clone(), tree, self._full, self._specs)
            self._gather_into(tree, out)
            return out
        return (whole(self.params), AdamWState(
            step=self.opt_state.step, mu=whole(self.opt_state.mu),
            nu=whole(self.opt_state.nu)))

    def place_state(self, params, opt_state: AdamWState | None = None
                    ) -> None:
        """Take the whole trees ``params`` and ``opt_state`` (fresh zero
        moments when None) as this executor's state: under ``gspmd`` this
        rank keeps its blocks (and the whole params become the gather's
        buffers), else the trees themselves."""
        if opt_state is None:
            opt_state = adamw_init(params, moment_dtype=self.cfg.moment_dtype)
        if self._gather is None:
            self.params, self.opt_state = params, opt_state
            return
        self._full = params
        self.params = self._blocks(params)
        self.opt_state = AdamWState(step=opt_state.step,
                                    mu=self._blocks(opt_state.mu),
                                    nu=self._blocks(opt_state.nu))

    def _open_shared_ckpt(self, ckpt_dir, world: int) -> None:
        """Open the disk tier on a directory every rank shares. Only
        the grid's rank 0 (logical rank 0 before any reshape: the rank
        that writes) sweeps its crash leftovers; the other ranks wait for
        it at a barrier over the grid and then open the directory without
        sweeping, so a parked ``.old_step_*`` copy is renamed back once.
        The elastic tier keeps these managers across reshapes."""
        lead = self._writes_disk
        if lead:
            self.ckpt = self._checkpoint_manager(ckpt_dir)
        if world > 1:
            done = torch.zeros(1, device=self.device)
            collective(dist.all_reduce, done, group=self.grid_group)
            done.item()     # on NCCL the host waits for the collective too
        if not lead:
            self.ckpt = self._checkpoint_manager(ckpt_dir, sweep=False)

    def _bind_group(self, group, rows) -> None:
        """(Re)bind every piece of the step plumbing that depends on the
        data-parallel group: its degree, this rank's logical rank (its
        place in ``rows``, the group's physical ranks in logical order;
        ``None`` outside the group), the gradient sync at that degree
        over ``group`` and the step (its reported loss is all-reduced
        over ``group``). Called at construction and by the elastic tier
        (:class:`repro_torch.elastic.ElasticMeshExecutor`) after it
        swaps the group for a survivor group. The bucket layout stays
        the construction-time one and the step cache keeps its keys
        ``(data, model, s_a)``, so steps of other degrees stay
        registered."""
        rows = [int(r) for r in rows]
        self.group = group
        self.data_degree = len(rows)
        self.rank = rows.index(self._phys_rank) \
            if self._phys_rank in rows else None
        if self.grad_compress == "int8_ef":
            self._grad_sync = CompressedBucketSync(
                self._layout, self.data_degree, group)
        else:
            self._grad_sync = BucketedAllReduce(self._layout, group)
        if self.telemetry is not None and self.telemetry.deep:
            self._grad_sync.tel = self.telemetry
            if self._gather is not None:
                self._gather.tel = self.telemetry
        gspmd = self._gather is not None
        previous = self._step_fn
        self._step_fn = make_train_step(
            self.model, base_lr=self._base_lr, total_steps=self.total_steps,
            group=group, grad_sync=self._grad_sync,
            gather=self._gather_params if gspmd else None,
            own=self._blocks if gspmd else None)
        # the accumulator is the layout's buckets, whatever the group:
        # the new step takes the one the previous step allocated
        self._step_fn.buckets.update(previous.buckets)
        self._prefetch = None

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
        key, _ = self._batch_key(state, step)
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
            out = (self._step_batch(state, step) if rows is None
                   else self._to_device(rows))
        if tel is not None:
            tel.counter("feed.prefetch_hits" if hit
                        else "feed.prefetch_misses").inc()
        return out

    def _step_batch(self, state, step: int | None = None) -> dict:
        """This rank's rows of ``step`` (default: the current one) under
        ``state``, built synchronously: the prefetched slab is neither
        read nor dropped (what :meth:`step_log` feeds, and a prefetch
        miss)."""
        step = self.step if step is None else step
        _, schedule = self._batch_key(state, step)
        lo, hi = self._rows()
        return self._to_device(spare_batch_rows(
            self.pipeline, schedule, state.s_a, step, lo, hi))

    def _step_state(self) -> tuple:
        state = (self.params, self.opt_state)
        return state + ((self._ef_state,) if self.grad_compress else ())

    def _state_leaf_names(self) -> list[str]:
        names = super()._state_leaf_names()
        if self.grad_compress:
            names += [f"{fam}[{b}]" for fam in ("err1", "err2")
                      for b in range(self._layout.n_buckets)]
        return names

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
        """Publish the step's wire accounting: the gauges
        ``sync.wire_bytes_per_step`` and ``sync.collectives_per_step``
        and the counter ``sync.wire_bytes_total``. The numbers are this
        rank's for one step, counted where each collective is called
        (:mod:`repro_torch.dist.collectives`): the gradient sync's and,
        under ``gspmd``, the model group's gathers; bytes moved per rank
        with the ring multipliers, not the HLO audit's reading of a
        compiled program. Deep mode adds the int8 EF residual norms
        ``sync.ef_residual_norm.{err1,err2}`` of this rank's residuals
        (one rank's are the whole state on one card), which synchronise
        the device."""
        parts = [self._grad_sync] + ([self._gather] if self._gather
                                     is not None else [])
        nbytes = sum(p.wire_bytes for p in parts)
        tel.gauge("sync.wire_bytes_per_step").set(nbytes)
        tel.gauge("sync.collectives_per_step").set(
            sum(p.wire_collectives for p in parts))
        tel.counter("sync.wire_bytes_total").inc(nbytes)
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

    @property
    def _writes_disk(self) -> bool:
        """The disk checkpoints are written by the grid's rank 0 alone
        (logical data rank 0, model rank 0)."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def _lead_rank(self) -> int:
        """The global rank that writes the disk checkpoints."""
        return dist.get_global_rank(self.grid_group, 0)

    def _save_disk(self, report: TrainReport) -> None:
        """The disk tier at a snapshot boundary. Under ``gspmd`` the file
        holds the whole leaves: the grid's rank 0 decides whether a save
        is due and tells every rank (one broadcast over the grid, made
        only with a checkpoint directory), then every rank takes part in
        the gathers and rank 0 writes what they rebuilt."""
        if self._gather is None:
            return super()._save_disk(report)
        if self.ckpt is None:
            return
        due = torch.tensor([int(self._writes_disk and self.ckpt.due())],
                           device=self.device)
        collective(dist.broadcast, due, group=self.grid_group,
                   src=self._lead_rank)
        if not int(due.item()):
            return
        params, opt_state = self.full_state()
        if self._writes_disk:
            self.ckpt.maybe_save(self.step, (params, opt_state), force=True)
            report.ckpt_saves = self.ckpt.saves

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
        The partials sum in fp32 buckets; returns the synced tree (views
        into them, or leaves in the accumulator's narrower dtype), the
        whole gradient on every rank (under ``gspmd`` taken on the
        gathered whole params)."""
        bufs = self._layout.zeros(self.device)
        grads = bucket_views(self._layout, bufs)
        params = self.params if self._gather is None \
            else self._gather_params(self.params)
        accumulate_grads(self.model, params,
                         self._device_batch(step, state), grads)
        if self.grad_compress:
            return self._grad_sync.sync_once(bufs)
        return self._grad_sync(bufs)
