"""ElasticMeshExecutor — degraded-continue between masking and restart
(the PyTorch counterpart of ``repro.elastic.executor``).

The recovery ladder has three rungs: SPARe masking (a weight-table edit),
this one, and the wipe-out restart (``t_restart`` plus the rollback's
rework). When RECTLR reports an UNMASKABLE failure set, the executor
shrinks the data-parallel degree onto the surviving ranks and keeps
training instead of restarting the world. In the order a reshape applies
them:

1. **decide** — :meth:`ElasticMeshExecutor._unmaskable_action` weighs
   the closed-form TTT comparison (:mod:`repro_torch.elastic.policy`)
   per event, through the scheme's own ``decide_unmaskable`` where it
   has one (the adaptive scheme: the live policy tier);
2. **shrink** — :meth:`ElasticMeshExecutor.reshape` picks the largest
   divisor of the original degree that fits the survivors
   (:func:`~repro_torch.elastic.reshard.shrink_degree`), makes the
   survivor group (:func:`~repro_torch.elastic.reshard.survivor_group`,
   one ``new_group`` per survivor set, kept), re-binds every
   group-dependent piece of the step plumbing
   (:meth:`~repro_torch.exec.executor.MeshExecutor._bind_group`) and
   starts a fresh :class:`~repro_torch.core.state.SpareState` at the
   new degree;
3. **move** — params and AdamW moments stay where they are; ``err1``
   follows its physical row, ``err2`` is re-sliced by the new logical
   positions
   (:func:`~repro_torch.elastic.reshard.remap_ef_rows`);
4. **account** — a ``reshape`` outcome in the
   :class:`~repro_torch.train.trainer.RecoveryEvent`, the injector's
   outage clock (``notify_outage(t_reshape, kind="reshape")``: the
   arrival model keeps running) and the ``launch.obs`` attribution.

The JAX package runs every data slice in one process on an emulated
mesh; here each SPARe group is one data row of a ``(data, model)`` grid
of ranks of a ``torch.distributed`` group (:func:`repro_torch.launch.mesh
.spawn_ranks`; rank ``d * M + m`` at ``(d, m)``), so ``data_degree ==
n_groups`` means one row a group: ``M`` ranks, one at model degree 1.
A reshape keeps every model column of a surviving row, as the JAX
package's survivor submesh does: each column gets its own survivor data
group (:func:`~repro_torch.elastic.reshard.survivor_group` makes every
column's, in order, on every rank), and each row's model group stays as
it is. The state moves per column, over that column's full data group:
under ``gspmd`` each column holds its own block of the params and
moments, under ``shard_map`` the columns' copies are replicas. A row
outside the survivor groups is *retired*, all ``M`` of its ranks, and
stays in lockstep, idle: it polls the same injector, makes the same
recoveries and schedule edits, joins every ``new_group`` and every
collective over its column's full data group, and runs no step and no
sync. Every rank must reach each such collective in the same order, or
the run hangs; the group's timeout (:data:`repro_torch.launch.mesh
.LOCKSTEP_TIMEOUT_S` under ``spawn_ranks``) turns a hang into an error.
:meth:`ElasticMeshExecutor.run` ends with one collective over the grid
that gives every rank the same report: the one of the rank at (logical
row 0, model 0), with each step's loss taken from a rank that ran it.

A rollback after a global restart is the second trap: a retired rank's
memory snapshot is stale (it took no step), so after the rollback the
params and moments of a rank that was active when the snapshot was
taken are broadcast to all (per model column); the snapshot's EF
residuals are remapped as a reshape remaps live ones.

The step cache is keyed on ``(data_degree, model_degree, S_A)``, so a
reshape registers one new key per (degree, depth) visited and a later
global restart (:meth:`ElasticMeshExecutor._global_restart`) returns to
the full group with its keys still registered; a degree revisited on
another survivor set drops that degree's keys first.

Physical vs logical ids: injectors are built against the FULL cluster and
keep delivering victims in that space. The executor polls them with a
physical survivor view and translates each event through the live
``physical row -> logical group`` map; events that land on retired
(healthy but unused) rows dissolve to no-ops.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.state import SpareState
from repro_torch.elastic.policy import ttt_estimates
from repro_torch.elastic.reshard import (remap_ef_rows, reshard_tree,
                                         shrink_degree, survivor_group)
from repro_torch.exec.executor import MeshExecutor
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import maybe_span
from repro_torch.train.trainer import RecoveryEvent, TrainReport

__all__ = ["ElasticMeshExecutor"]


class _PhysicalView:
    """Just enough of the :class:`SpareState` survivor surface for the
    injector protocols (``poll(state)`` reads ``alive``; plain callables
    read ``survivors``), in PHYSICAL group space — the full cluster the
    injector was built against, whatever survivor group training runs
    on."""

    __slots__ = ("alive",)

    def __init__(self, alive: np.ndarray):
        self.alive = alive

    @property
    def n(self) -> int:
        return int(self.alive.size)

    @property
    def survivors(self) -> np.ndarray:
        return np.flatnonzero(self.alive)

    @property
    def failure_count(self) -> int:
        return int(self.alive.size - self.alive.sum())


class ElasticMeshExecutor(MeshExecutor):
    """:class:`MeshExecutor` with the elastic recovery tier, one data row
    of the grid per SPARe group.

    Extra parameter:

    t_reshape: modeled outage seconds one online resharding costs (drain,
        re-bind and state movement on a real cluster) — what the TTT
        policy weighs against ``t_restart`` and what the injector clock
        is charged per reshape.
    """

    def __init__(self, cfg: ModelConfig, *, n_groups: int, redundancy: int,
                 t_reshape: float = 60.0, **kwargs: Any):
        super().__init__(cfg, n_groups=n_groups, redundancy=redundancy,
                         **kwargs)
        if self.data_degree != n_groups:
            raise ValueError(
                "elastic reshaping maps one SPARe group per data row: need "
                f"data_degree == n_groups, got data={self.data_degree} vs "
                f"N={n_groups}")
        self.t_reshape = float(t_reshape)
        # this rank's model column's data group over every row
        self._full_group = self.group
        self._full_n = int(n_groups)
        self._full_r = int(redundancy)
        # physical data row backing each logical group (logical -> phys)
        self._logical_phys = np.arange(n_groups, dtype=np.int64)
        # inverse: physical row -> logical group, -1 = retired or dead
        self._group_map = np.arange(n_groups, dtype=np.int64)
        self._phys_alive = np.ones(n_groups, dtype=bool)
        # this column's survivor groups by their physical rows (new_group
        # is costly and must be called by every rank: make each set's once)
        self._groups: dict[tuple, Any] = {
            tuple(range(n_groups)): self.group}
        # a degree's registered steps belong to one survivor set: a
        # second reshape to the same degree on another set evicts them
        self._shape_rows = {(self.data_degree, self.model_degree):
                            tuple(range(n_groups))}
        # the ranks active when the snapshot was taken (whose params are
        # the snapshot's), and the ranks its EF residuals are laid out
        # for (a rollback onto another group remaps them)
        self._snapshot_rows = self._logical_phys.copy()
        self._ef_snapshot_rows = self._logical_phys.copy()
        self._idle_at: list[int] = []
        self.reshape_count = 0
        self.policy_log: list[dict] = []

    # ------------------------------------------------------------- #
    # group swapping                                                #
    # ------------------------------------------------------------- #
    def _evict_stale_executables(self, rows: tuple) -> None:
        shape = (len(rows), self.model_degree)
        if self._shape_rows.get(shape, rows) != rows:
            for key in [k for k in sorted(self._jitted)
                        if (k[0], k[1]) == shape]:
                self._jitted.discard(key)
        self._shape_rows[shape] = rows

    def _fit_redundancy(self, n_new: int) -> int:
        """Largest r <= the original redundancy a cyclic Golomb stacking
        at degree ``n_new`` supports (r(r-1) distinct non-zero residues
        must fit mod N); tiny groups drop to r=1 (no redundancy)."""
        for r in range(min(self._full_r, n_new), 1, -1):
            if r * (r - 1) <= n_new - 1:
                return r
        return 1

    def _broadcast_state(self, src: int) -> None:
        """Params, AdamW moments and the update count from physical row
        ``src`` to every row, in place, over this rank's model column's
        full data group: under ``gspmd`` each column holds its own block
        of the params and moments, so each rank takes the state of the
        source row's rank in its own column."""
        step = torch.tensor([self.opt_state.step], dtype=torch.int64)
        reshard_tree((self.params, self.opt_state.mu, self.opt_state.nu,
                      [step]), src, self._full_group)
        self.opt_state.step = int(step)

    def _swap_group(self, n_new: int, rows) -> None:
        """Re-bind onto the group of physical ranks ``rows`` (``n_new``
        of them, in logical order) and move the training state across.
        A collective over the full group. With telemetry, each part is a
        span: ``reshape/<part>`` or, back to the full group,
        ``restore/<part>``, for the parts ``group``, ``broadcast`` and
        ``ef_move``."""
        old_rows = [int(r) for r in self._logical_phys]
        rows = tuple(int(r) for r in rows)
        tel = self.telemetry
        what = "restore" if n_new == self._full_n else "reshape"
        self.state = SpareState(n_new, self._fit_redundancy(n_new))
        with maybe_span(tel, f"{what}/group"):
            group = survivor_group(self.grid_group, rows, self._groups,
                                   self.model_degree, self.model_rank)
            self._evict_stale_executables(rows)
            self._bind_group(group, rows)
        if any(r not in old_rows for r in rows):
            # ranks rejoin with stale replicas: take an active rank's
            with maybe_span(tel, f"{what}/broadcast"):
                self._broadcast_state(old_rows[0])
        if self._ef_state is not None:
            with maybe_span(tel, f"{what}/ef_move"):
                self._ef_state = remap_ef_rows(
                    self._ef_state, old_rows, rows, rank=self._phys_rank,
                    group=self._full_group)
        self._logical_phys = np.asarray(rows, dtype=np.int64)
        self._group_map = np.full(self._full_n, -1, dtype=np.int64)
        self._group_map[self._logical_phys] = np.arange(n_new)

    def reshape(self, victims) -> dict:
        """Shrink past ``victims`` (logical group ids of the CURRENT
        state) onto a survivor group and return the move summary. Every
        rank calls it with the same victims. Usable directly (tests) —
        the trainer loop reaches it through :meth:`_apply_reshape`."""
        victims = sorted({int(v) for v in victims})
        for v in victims:
            if 0 <= v < self.state.n:
                self._phys_alive[int(self._logical_phys[v])] = False
        surv = [w for w in range(self.state.n)
                if self.state.alive[w] and w not in victims]
        n_new = shrink_degree(self._full_n, len(surv))
        if n_new < 1:
            raise ValueError(
                f"no survivor group can continue past {victims}")
        rows = sorted(int(self._logical_phys[w]) for w in surv)[:n_new]
        dp_before = self.state.n
        self._swap_group(n_new, rows)
        self.reshape_count += 1
        return {"dp_before": dp_before, "dp": n_new, "rows": rows}

    def restore_full_mesh(self) -> None:
        """Back to the full group at full DP — the global-restart path
        (every group comes back); rejoining ranks receive the params and
        moments of an active rank."""
        self._swap_group(self._full_n, range(self._full_n))
        self._phys_alive[:] = True

    # ------------------------------------------------------------- #
    # trainer hooks                                                 #
    # ------------------------------------------------------------- #
    def _poll_events(self, injector) -> list[list[int]]:
        # injectors live in physical space: poll them with the physical
        # survivor view, not the (possibly shrunken) logical state
        if injector is None:
            return []
        view = _PhysicalView(self._phys_alive)
        poll = getattr(injector, "poll", None)
        if poll is not None:
            return [ev.victims for ev in poll(view)]
        failed = injector(view)
        return [list(failed)] if failed else []

    def _event_victims(self, victims: list[int]) -> list[int]:
        out = []
        for p in victims:
            p = int(p)
            if not 0 <= p < self._full_n:
                continue
            self._phys_alive[p] = False
            logical = int(self._group_map[p])
            if logical >= 0:
                out.append(logical)
        return out

    def _unmaskable_action(self, victims: list[int], injector) -> str:
        surv = [w for w in range(self.state.n)
                if self.state.alive[w] and w not in victims]
        n_new = shrink_degree(self._full_n, len(surv))
        if n_new < 1:
            return "restart"
        kw = dict(
            dp_full=self._full_n, dp_new=n_new,
            remaining_steps=max(self.total_steps - self.step, 1),
            seconds_per_step=float(getattr(injector, "seconds_per_step",
                                           0.0) or 0.0),
            rollback_steps=max(self.step - self._snapshot_step(), 0),
            t_restart=self._t_restart, t_reshape=self.t_reshape)
        decide = getattr(self.scheme, "decide_unmaskable", None)
        if decide is not None:
            action = decide(**kw)
            self.policy_log.append(dict(kw, action=action))
            return action
        est = ttt_estimates(**kw)
        self.policy_log.append(est)
        return est["action"]

    def _apply_reshape(self, event: RecoveryEvent, victims: list[int],
                       injector, report: TrainReport) -> None:
        info = self.reshape(victims)
        event.reshape = True
        event.dp_before = info["dp_before"]
        event.dp_after = info["dp"]
        event.s_a_after = self.state.s_a
        event.reshape_seconds = self.t_reshape
        notify = getattr(injector, "notify_outage", None)
        if notify is not None:
            # resharding outage elapses, but the arrival model keeps
            # running — surviving hardware stays powered throughout
            notify(self.t_reshape, kind="reshape")

    def _degraded_dp_new(self, victims: list[int]) -> int:
        """DP degree a health-driven reshape excluding the straggler set
        would continue at — the elastic option the degraded-TTT policy
        weighs against demotion."""
        surv = [w for w in range(self.state.n)
                if self.state.alive[w] and w not in victims]
        return shrink_degree(self._full_n, len(surv))

    def _global_restart(self) -> None:
        if self.state.n != self._full_n:
            self.restore_full_mesh()
        else:
            self.state.reset()
        self._phys_alive[:] = True
        # same demotion/detector reset as the base restart path (the
        # outage swaps degraded hardware)
        self._demoted.clear()
        self._demote_snapshot = None
        self._schedule_version += 1
        if self.detector is not None:
            self.detector.reset()

    # ------------------------------------------------------------- #
    # the step: retired ranks idle in lockstep                      #
    # ------------------------------------------------------------- #
    def _dispatch(self, report: TrainReport):
        if self.rank is not None:
            return super()._dispatch(report)
        # a retired rank registers the key (so every rank counts the same
        # recompiles) and runs nothing; its loss comes from an active
        # rank when the run ends
        self._compiled(self.state.s_a, report)
        self._idle_at.append(len(report.losses))
        return self.params, self.opt_state, {"loss": float("nan")}

    def run(self, *args, **kwargs) -> TrainReport:
        """:meth:`MeshExecutor.run` on every rank in lockstep; returns the
        same report on every rank (a collective over the full group)."""
        self._idle_at = []
        return self._one_report(super().run(*args, **kwargs))

    @property
    def _lead_rank(self) -> int:
        """The global rank at grid point ``(logical row 0, model 0)``:
        the rank that writes the disk checkpoints."""
        return dist.get_global_rank(
            self.grid_group, int(self._logical_phys[0]) * self.model_degree)

    def _one_report(self, report: TrainReport) -> TrainReport:
        """The current logical rank 0's report, each loss from a rank
        that ran that step, on every rank of the grid."""
        every = [None] * dist.get_world_size(self.grid_group)
        dist.all_gather_object(every, (report, self._idle_at),
                               group=self.grid_group)
        out = every[int(self._logical_phys[0]) * self.model_degree][0]
        for i in range(len(out.losses)):
            rep, _ = next(e for e in every if i not in e[1])
            out.losses[i] = rep.losses[i]
        return out

    # ------------------------------------------------------------- #
    # snapshot / rollback                                           #
    # ------------------------------------------------------------- #
    def _snapshot_now(self) -> None:
        if list(self._ef_snapshot_rows) != list(self._logical_phys):
            # laid out for another group, so not overwritten in place:
            # free it before its successor is allocated
            self._ef_snapshot = None
        super()._snapshot_now()
        self._snapshot_rows = self._logical_phys.copy()
        self._ef_snapshot_rows = self._logical_phys.copy()

    def _rollback(self):
        snap_rows = [int(r) for r in self._snapshot_rows]
        rows = [int(r) for r in self._logical_phys]
        tel = self.telemetry
        if self._ef_snapshot is not None and \
                list(self._ef_snapshot_rows) != rows:
            # the snapshot was taken on another group: remap its
            # residuals for the group the rollback restores onto
            with maybe_span(tel, "rollback/ef_move"):
                self._ef_snapshot = remap_ef_rows(
                    self._ef_snapshot, self._ef_snapshot_rows, rows,
                    rank=self._phys_rank, group=self._full_group)
            self._ef_snapshot_rows = self._logical_phys.copy()
        out = super()._rollback()
        if any(r not in snap_rows for r in rows):
            # a rank retired at the snapshot holds a stale copy: take
            # the params and moments of a rank that was active then
            with maybe_span(tel, "rollback/broadcast"):
                self._broadcast_state(snap_rows[0])
        return out
