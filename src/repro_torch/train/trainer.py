"""SpareTrainer — the paper's Alg. 1 as an executable training loop (the
PyTorch counterpart of ``repro.train.trainer``).

Glues every substrate together:

  data pipeline  ->  SPARe schedule (stacks, weights)   [host, RECTLR]
       |                      |
       v                      v
  train_step(params, opt, stacked_batch)                 [device]
       |
  checkpoint manager (Eq.-1 interval, host snapshot + disk)

Failure handling per Alg. 1, delegated to a pluggable
:class:`repro_torch.des.FaultToleranceScheme` (``trainer.scheme.recover(
state, failed)`` is the protocol decision point the DES shares):

  * injected node failures are detected "at the all-reduce": the trainer
    consults the injector before dispatching a step and, on failure,
    asks the scheme for a recovery decision (RECTLR for SPARe); patch
    compute is the next step, dispatched with the updated schedule;
  * injectors may be plain callables (``injector(state) -> [groups]``,
    e.g. :class:`PoissonInjector`) or expose ``poll(state) ->
    [StepEvent]`` (:class:`repro_torch.train.injection.ScriptedInjector`):
    each event's victim batch reaches ``scheme.recover`` in ONE call, and
    every outcome is recorded in ``TrainReport.events``;
  * wipe-out -> global restart: ``state.reset()``, and params and
    optimizer state roll back to the last in-memory snapshot (copied back
    into the live tensors in place) — the trainer's own, or with
    ``ckpt_dir`` the :class:`~repro_torch.ckpt.CheckpointManager`'s
    memory tier, which also writes the snapshot to disk in the
    background whenever the Eq.-1 interval is due;
  * gray failures: an optional straggler ``detector``
    (:class:`repro_torch.health.StragglerDetector`) reads the injector's
    per-group step timings after every step; a flagged straggler is
    demoted (masked out of the weighted sync, a weight-table edit) when
    the degraded-TTT policy says so, and re-admitted bit for bit when it
    heals;
  * ``report.recompiles`` counts the new stack depths ``S_A`` the run
    meets — what costs the JAX package a compile. Eager PyTorch compiles
    nothing, so here it is the same count, kept for the same reports.

The elastic tier (degraded-continue on a survivor group between masking
and restart) lives in :class:`repro_torch.elastic.ElasticMeshExecutor`,
which overrides the recovery-tier hooks below; here
:meth:`SpareTrainer._unmaskable_action` always restarts and
:meth:`SpareTrainer._apply_reshape` raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import copy_into, host_copy
from repro_torch.core import Rectlr, SpareState
from repro_torch.data import ShardedTokenPipeline, spare_batch
from repro_torch.des import DESParams, FaultToleranceScheme, get_scheme
from repro_torch.dist.collectives import (bucket_layout, tree_leaves,
                                          unflatten_grads)
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Telemetry, maybe_span
from repro_torch.optim import adamw_init
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step)

__all__ = ["SpareTrainer", "PoissonInjector", "TrainReport",
           "RecoveryEvent"]


class PoissonInjector:
    """Host-side failure injector: exponential arrivals in *step* time.

    ``mean_steps_between_failures`` is the *system* mean when ``n_groups``
    is 0 (the default), or the *per-group* mean when ``n_groups`` is
    given — the aggregate arrival rate then scales with cluster size
    (``mean / n_groups`` steps between system failures), matching the
    DES's rate-∝-active-GPUs failure model.
    """

    def __init__(self, mean_steps_between_failures: float, seed: int = 0,
                 n_groups: int = 0):
        self.rng = np.random.default_rng(seed)
        self.mean = (mean_steps_between_failures / n_groups if n_groups > 0
                     else mean_steps_between_failures)
        self.next_at = self.rng.exponential(self.mean)
        self.clock = 0.0

    def __call__(self, state: SpareState) -> list[int]:
        self.clock += 1.0
        failed = []
        while self.clock >= self.next_at:
            survivors = state.survivors
            if survivors.size:
                failed.append(int(self.rng.choice(survivors)))
            self.next_at += self.rng.exponential(self.mean)
        return failed


@dataclass
class RecoveryEvent:
    """Outcome of one failure event's ``scheme.recover`` call (the JAX
    package's fields, the elastic and gray-failure ones included, so
    reports compare field for field)."""

    step: int                        # trainer step at detection
    victims: list[int]               # simultaneous-kill set (>=1 group)
    wipeout: bool
    reordered: bool
    patch_count: int
    s_a_before: int
    s_a_after: int
    moves: int = 0
    rollback_depth: int = 0          # steps rolled back (wipe-out only)
    grad_check_err: float | None = None   # §3.1 relative error, if verified
    reshape: bool = False
    dp_before: int = 0
    dp_after: int = 0
    demote: bool = False
    readmit: bool = False
    slow_factor: float = 0.0
    wall_seconds: float = 0.0        # host wall-clock handling the event
    step_seconds: float = 0.0        # step-clock cost: controller time for
    #                                  a mask, rollback_depth x sec/step
    #                                  for a wipe-out
    restart_seconds: float = 0.0     # modeled outage (t_restart, wipe-outs)
    reshape_seconds: float = 0.0

    @property
    def multi_group(self) -> bool:
        return len(self.victims) > 1


@dataclass
class TrainReport:
    steps_done: int = 0
    losses: list = field(default_factory=list)
    failures: int = 0
    wipeouts: int = 0
    reshapes: int = 0
    demotes: int = 0
    readmits: int = 0
    reorders: int = 0
    patches: int = 0
    recompiles: int = 0
    ckpt_saves: int = 0
    controller_seconds: float = 0.0
    events: list = field(default_factory=list)   # list[RecoveryEvent]

    @property
    def multi_group_events(self) -> int:
        return sum(1 for e in self.events if e.multi_group)

    @property
    def rollback_steps(self) -> int:
        return sum(e.rollback_depth for e in self.events)

    @property
    def max_grad_check_err(self) -> float:
        errs = [e.grad_check_err for e in self.events
                if e.grad_check_err is not None]
        return max(errs) if errs else 0.0


def _state_leaves(state: tuple) -> list[torch.Tensor]:
    """The tensors of a step's state ``(params, AdamWState[, EF
    residuals])``, the moments' step count left out."""
    params, opt, *rest = state
    return tree_leaves((params, opt.mu, opt.nu, *rest))


class SpareTrainer:
    def __init__(self, cfg: ModelConfig, *, n_groups: int, redundancy: int,
                 seq: int = 128, per_type_batch: int = 2, seed: int = 0,
                 ckpt_dir: str | None = None, mtbf: float = 300.0,
                 t_save: float = 60.0, t_restart: float = 3600.0,
                 base_lr: float = 3e-4, total_steps: int = 1000,
                 scheme: FaultToleranceScheme | None = None,
                 telemetry: Telemetry | None = None,
                 detector=None, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.telemetry = telemetry
        self.state = SpareState(n_groups, redundancy)
        # recovery policy: any registered FaultToleranceScheme; defaults to
        # SPARe (Alg. 1/2). `ctl` aliases the scheme's own controller
        self.scheme = scheme if scheme is not None \
            else get_scheme("spare", r=redundancy)
        self.scheme.prepare(DESParams(n=n_groups, mtbf=mtbf, t_save=t_save,
                                      t_restart=t_restart))
        self._t_restart = float(t_restart)   # modeled outage per wipe-out
        self.ctl = getattr(self.scheme, "ctl", None) or Rectlr()
        self.model = build_model(cfg, device=device)
        self.device = self.model.device
        self.pipeline = ShardedTokenPipeline(cfg, seq, per_type_batch,
                                             seed=seed)
        self.params = self.model.init(seed)
        self.opt_state = adamw_init(self.params,
                                    moment_dtype=cfg.moment_dtype)
        self._base_lr = float(base_lr)
        self.total_steps = int(total_steps)
        self._step_fn = make_train_step(self.model, base_lr=base_lr,
                                        total_steps=total_steps)
        self._jitted: set = set()               # step-cache keys seen
        self.total_recompiles = 0   # step registrations, run-driven or not
        self._ckpt_args = dict(n_groups=n_groups, redundancy=redundancy,
                               mtbf=mtbf, t_save=t_save,
                               t_restart=t_restart)
        self.ckpt = None
        if ckpt_dir is not None:
            self.ckpt = self._checkpoint_manager(ckpt_dir)
        # in-memory snapshot without a checkpoint directory: a wipe-out
        # must still roll params/step back
        self._snapshot: tuple[int, Any] | None = None
        self.step = 0
        # gray-failure tier: an optional StragglerDetector fed each step
        # from the injector's per-group timings; flagged stragglers may
        # be demoted (masked out of the weighted sync) and are
        # re-admitted bit for bit when they heal
        self.detector = detector
        self.health_log: list[dict] = []
        self._demoted: set[int] = set()
        # (stacks, alive, s_a, supplier) taken just before the demoting
        # recover(), with the schedule version; restoring it on re-admit
        # reproduces the pre-demotion weight table bit for bit as long
        # as no other recovery touched the schedule in between
        self._demote_snapshot: tuple | None = None
        self._schedule_version = 0

    # ---------------------------------------------------------------- #
    def _checkpoint_manager(self, ckpt_dir, *,
                            sweep: bool = True) -> CheckpointManager:
        """The disk tier's manager for ``ckpt_dir``, at this trainer's
        Eq.-1 interval; ``sweep`` as :class:`CheckpointManager` takes
        it."""
        return CheckpointManager(ckpt_dir, sweep=sweep, **self._ckpt_args)

    def _cache_key(self, s_a: int) -> Any:
        """Step-cache key: the stack depth (the mesh executor adds its
        data and model degrees)."""
        return s_a

    def _compiled(self, s_a: int, report: TrainReport | None = None):
        """The step for stack depth ``s_a``, registering its cache key. A
        new key counts toward ``total_recompiles`` and, inside a run,
        that run's ``report.recompiles`` (what costs the JAX package a
        compile; eager PyTorch builds nothing, so the step is the one
        bound now, whatever the key)."""
        key = self._cache_key(s_a)
        if key not in self._jitted:
            self._jitted.add(key)
            self.total_recompiles += 1
            if report is not None:
                report.recompiles += 1
            if self.telemetry is not None:
                self.telemetry.counter("train.recompiles").inc()
        return self._step_fn

    def _to_device(self, batch_np: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_np.items()}

    def _dispatch(self, report: TrainReport):
        batch = self._step_batch(self.state)
        fn = self._compiled(self.state.s_a, report)
        return fn(self.params, self.opt_state, batch)

    # ---------------------------------------------------------------- #
    # the step's record (the JAX package's compiled-step inspection)   #
    # ---------------------------------------------------------------- #
    def _step_state(self) -> tuple:
        """What the step takes besides the batch and updates in place."""
        return (self.params, self.opt_state)

    def _step_batch(self, state: SpareState, step: int | None = None
                    ) -> dict:
        """The batch of ``step`` (default: the current one) under
        ``state``, built without touching any of the trainer's state."""
        step = self.step if step is None else step
        return self._to_device(spare_batch(self.pipeline, state, step))

    def state_leaves(self) -> list[torch.Tensor]:
        """The leaves the step updates in place, in the order its log
        reads them: the params, the AdamW moments (and, in the mesh
        executor, the EF residuals). The JAX package's
        ``donated_leaves`` counts these."""
        return _state_leaves(self._step_state())

    def step_log(self, state: SpareState | None = None, *,
                 watch: bool = True):
        """Run one step of the given (default: current) schedule on
        copies of the state under :func:`repro_torch.launch.steplog
        .record_step` and return its :class:`~repro_torch.launch.steplog
        .StepLog`: the counterpart of the JAX package's
        ``compiled_step_text``. The step callable is the one
        :meth:`_compiled` hands the run; the live params, moments (EF
        residuals), step count, schedule, prefetched rows and generators
        are left as they were (the accumulator is the step's scratch).
        The log's ``loss`` is read after the step, as the trainer loop
        reads it. ``watch=False`` records the collectives and storage
        only (:func:`~repro_torch.launch.steplog.record_step`)."""
        import copy
        import dataclasses

        from repro_torch.launch.steplog import record_step

        state = self.state if state is None else state
        batch = self._step_batch(state)
        taken = copy.deepcopy(self._step_state())
        params, opt, *rest = taken
        out, log = record_step(
            self._step_fn, (params, opt, batch, *rest),
            donated=_state_leaves(taken),
            returned=lambda out: _state_leaves(out[:2] + out[3:]),
            names=self._state_leaf_names(), watch=watch)
        # the trainer loop's read, outside the step
        return dataclasses.replace(log, loss=float(out[2]["loss"]))

    def _state_leaf_names(self) -> list[str]:
        n = len(tree_leaves(self.params))
        return ([f"params[{i}]" for i in range(n)]
                + [f"mu[{i}]" for i in range(n)]
                + [f"nu[{i}]" for i in range(n)])

    # ---------------------------------------------------------------- #
    # snapshot tiers                                                   #
    # ---------------------------------------------------------------- #
    def _snapshot_now(self) -> None:
        """Record the rollback point: the CheckpointManager's memory tier
        when one is configured, else the trainer's own host copies — a
        wipe-out must never keep post-failure params. Either overwrites
        the previous snapshot's host tensors in place."""
        live = (self.params, self.opt_state)
        if self.ckpt is not None:
            self.ckpt.snapshot(self.step, live)
        else:
            self._snapshot = (self.step, host_copy(
                live, None if self._snapshot is None else self._snapshot[1]))

    def _rollback(self) -> tuple[int, Any]:
        """Copy the snapshot back into the live tensors, in place."""
        if self.ckpt is not None:
            step, (params, opt_state) = self.ckpt.rollback()
        else:
            assert self._snapshot is not None, "no snapshot taken yet"
            step, (params, opt_state) = self._snapshot
        copy_into((self.params, self.opt_state), (params, opt_state))
        self.opt_state.step = opt_state.step
        return step, (self.params, self.opt_state)

    @property
    def _writes_disk(self) -> bool:
        """Does this process write the disk checkpoints? The one process
        here; of several ranks, one (the mesh executor's)."""
        return True

    def _save_disk(self, report: TrainReport) -> None:
        """The disk tier at a snapshot boundary: the checkpoint manager
        writes the snapshot in the background when its Eq.-1 interval is
        due (the memory tier's own host tree: no second host copy)."""
        if self.ckpt is not None and self._writes_disk:
            self.ckpt.maybe_save(self.step, self.ckpt.last_snapshot[1])
            report.ckpt_saves = self.ckpt.saves

    def _snapshot_step(self) -> int:
        """Step of the current rollback point WITHOUT restoring it — the
        rollback-depth estimate recovery policies cost restarts with."""
        snap = self.ckpt.last_snapshot if self.ckpt is not None \
            else self._snapshot
        return snap[0] if snap is not None else self.step

    def _poll_events(self, injector) -> list[list[int]]:
        """One victim batch per failure event this step. A scenario
        bridge (``poll``) yields per-event blast radii; a plain callable
        yields at most one merged batch."""
        if injector is None:
            return []
        poll = getattr(injector, "poll", None)
        if poll is not None:
            return [ev.victims for ev in poll(self.state)]
        failed = injector(self.state)
        return [list(failed)] if failed else []

    # ---------------------------------------------------------------- #
    # recovery-tier hooks (the elastic tier overrides these)           #
    # ---------------------------------------------------------------- #
    def _event_victims(self, victims: list[int]) -> list[int]:
        """Map one event's victim ids into the trainer's group space
        (identity here)."""
        return victims

    def _unmaskable_action(self, victims: list[int], injector) -> str:
        """What an unmaskable failure set costs: ``"restart"`` (wipe-out
        rollback, the only option here) or ``"reshape"`` (continue
        degraded on a survivor group: the elastic tier)."""
        return "restart"

    def _apply_reshape(self, event: RecoveryEvent, victims: list[int],
                       injector, report: TrainReport) -> None:
        """Shrink onto the surviving ranks and continue. Only the elastic
        executor implements this; the base trainer never routes here
        because :meth:`_unmaskable_action` always restarts."""
        raise NotImplementedError(
            "elastic reshaping needs repro_torch.elastic."
            "ElasticMeshExecutor")

    def _global_restart(self) -> None:
        """Wipe-out: every group comes back at full capacity (the
        modeled cluster restart) before the rollback restores params.
        Degraded hardware is swapped during the outage, so demotion and
        detector history reset with it."""
        self.state.reset()
        self._demoted.clear()
        self._demote_snapshot = None
        self._schedule_version += 1
        if self.detector is not None:
            self.detector.reset()

    # ---------------------------------------------------------------- #
    # gray-failure tier: straggler detection -> demote / re-admit      #
    # ---------------------------------------------------------------- #
    def _mask_feasible(self, victims: list[int]) -> bool:
        """Would masking ``victims`` out of the sync leave every shard
        type covered? Probed on a scratch copy because RECTLR mutates
        ``alive``/``supplier`` before its wipe-out short-circuit."""
        import copy
        probe = copy.deepcopy(self.state)
        return not Rectlr().on_failures(probe, list(victims)).wipeout

    def _degraded_dp_new(self, victims: list[int]) -> int:
        """DP degree an elastic reshape excluding ``victims`` would
        continue at; 0 here — the base trainer has no elastic tier."""
        return 0

    def _health_tick(self, injector, report: TrainReport) -> None:
        """One detector observation per completed step: feed per-group
        modeled timings, then act on verdict changes — demote freshly
        flagged stragglers (when the degraded-TTT policy says so) and
        re-admit demoted groups the detector has cleared."""
        det = self.detector
        if det is None or injector is None:
            return
        timings_fn = getattr(injector, "group_step_seconds", None)
        if timings_fn is None:
            return
        timings = np.asarray(timings_fn(), dtype=np.float64)
        if timings.shape != self.state.alive.shape:
            return      # post-reshape logical/physical mismatch: skip
        # demoted groups are schedule-dead but physically alive: keep
        # observing them (their flag must persist until the episode
        # actually heals, else demote/re-admit would flap)
        live = self.state.alive.copy()
        for g in self._demoted:
            live[g] = True
        hr = det.observe(timings, alive=live, step=self.step)
        tel = self.telemetry
        if tel is not None:
            tel.gauge("health.flagged").set(len(hr.flagged))
            for g in hr.newly_flagged:
                tel.instant("straggler", track=f"dp/{g}",
                            args={"step": self.step})
            for g in hr.newly_cleared:
                tel.instant("healed", track=f"dp/{g}",
                            args={"step": self.step})

        # re-admission first: a healed group rejoins before new
        # demotions are weighed, so the policy sees the true barrier
        healed = [g for g in sorted(self._demoted)
                  if g not in hr.flagged and not self.state.alive[g]]
        if healed:
            self._readmit(healed, hr, injector, report)

        candidates = [g for g in hr.flagged
                      if g not in self._demoted and self.state.alive[g]]
        if not candidates:
            return
        maskable = self._mask_feasible(candidates)
        sps = float(getattr(injector, "seconds_per_step", 0.0) or 0.0)
        kw = dict(
            factors=hr.factors, candidates=candidates,
            remaining_steps=max(self.total_steps - self.step, 1),
            seconds_per_step=sps, dp_full=self.state.n,
            dp_new=self._degraded_dp_new(candidates), maskable=maskable,
            alive=self.state.alive, demoted=sorted(self._demoted),
            rollback_steps=max(self.step - self._snapshot_step(), 0),
            t_restart=self._t_restart)
        decide = getattr(self.scheme, "decide_degraded", None)
        if decide is not None:
            action = decide(**kw)
        else:
            from repro_torch.health.policy import degraded_ttt_estimates
            action = degraded_ttt_estimates(
                **{k: v for k, v in kw.items()},
                t_reshape=float("inf"))["action"]
        self.health_log.append({
            "step": self.step, "candidates": list(candidates),
            "factors": [round(float(hr.factors[g]), 4)
                        for g in candidates],
            "maskable": maskable, "action": action})
        if action == "demote":
            self._demote(candidates, hr, injector, report)
        elif action == "restart":
            self._health_restart(candidates, hr, injector, report)
        elif action == "reshape":
            self._health_reshape(candidates, hr, injector, report)
        # "tolerate": keep everyone in the barrier, observe again next
        # step — the episode may heal on its own

    def _demote(self, groups: list[int], hr, injector,
                report: TrainReport) -> None:
        """SPARe-demote alive-but-slow ``groups``: mask them out of the
        weighted sync exactly as a failure would — a pure weight-table
        edit through the scheme's controller — while remembering the
        pre-demotion schedule for bit-identical re-admission."""
        tel = self.telemetry
        st = self.state
        snap = (st.stacks.copy(), st.alive.copy(), int(st.s_a),
                st.supplier.copy())
        factor = max(float(hr.factors[g]) for g in groups)
        ev_args = {"step": self.step, "victims": list(groups),
                   "demote": True}
        with maybe_span(tel, "recover", args=ev_args):
            outcome = self.scheme.recover(st, list(groups),
                                          step=self.step)
            self._schedule_version += 1
            if outcome.wipeout:     # feasibility probe said otherwise
                raise RuntimeError(
                    f"demotion of {groups} wiped out the schedule "
                    f"despite passing the feasibility probe")
            self._demote_snapshot = (snap, self._schedule_version)
            self._demoted.update(int(g) for g in groups)
            notify = getattr(injector, "notify_demoted", None)
            if notify is not None:
                notify(groups, True)
            event = RecoveryEvent(
                step=self.step, victims=list(groups), wipeout=False,
                reordered=outcome.reordered,
                patch_count=outcome.patch_count,
                s_a_before=outcome.s_a_before,
                s_a_after=outcome.s_a_after, moves=outcome.moves,
                demote=True, slow_factor=factor)
            event.step_seconds = outcome.controller_seconds
            ev_args.update(s_a_before=outcome.s_a_before,
                           s_a_after=outcome.s_a_after,
                           wipeout=False)
        event.wall_seconds = 0.0
        report.controller_seconds += outcome.controller_seconds
        report.demotes += 1
        report.reorders += int(outcome.reordered)
        report.patches += outcome.patch_count
        report.events.append(event)
        if tel is not None:
            tel.counter("health.demotes").inc()
            tel.gauge("train.s_a").set(outcome.s_a_after)

    def _readmit(self, groups: list[int], hr, injector,
                 report: TrainReport) -> None:
        """Fold healed ``groups`` back into the weighted sync. The fast
        path restores the pre-demotion schedule snapshot verbatim —
        bit-identical to an always-healthy run's weight table. If any
        other recovery touched the schedule since the demotion, the
        snapshot is stale: rebuild from a clean reset by replaying the
        still-dead and still-demoted sets through the controller."""
        tel = self.telemetry
        st = self.state
        s_a_before = int(st.s_a)
        ev_args = {"step": self.step, "victims": list(groups),
                   "readmit": True}
        with maybe_span(tel, "recover", args=ev_args):
            snap = self._demote_snapshot
            clean = (snap is not None
                     and snap[1] == self._schedule_version
                     and set(groups) == set(self._demoted))
            if clean:
                stacks, alive, s_a, supplier = snap[0]
                st.stacks[:] = stacks
                st.alive[:] = alive
                st.s_a = s_a
                st.supplier[:] = supplier
            else:
                still_out = sorted(
                    int(w) for w in np.flatnonzero(~st.alive)
                    if w not in groups)
                st.reset()
                if still_out:
                    self.scheme.recover(st, still_out, step=self.step)
            st.assert_invariants()
            self._schedule_version += 1
            self._demote_snapshot = None
            self._demoted.difference_update(int(g) for g in groups)
            notify = getattr(injector, "notify_demoted", None)
            if notify is not None:
                notify(groups, False)
            event = RecoveryEvent(
                step=self.step, victims=list(groups), wipeout=False,
                reordered=False, patch_count=0, s_a_before=s_a_before,
                s_a_after=int(st.s_a), readmit=True)
            ev_args.update(s_a_before=s_a_before, s_a_after=int(st.s_a),
                           wipeout=False)
        report.readmits += 1
        report.events.append(event)
        if tel is not None:
            tel.counter("health.readmits").inc()
            tel.gauge("train.s_a").set(int(st.s_a))

    def _health_restart(self, groups: list[int], hr, injector,
                        report: TrainReport) -> None:
        """The policy judged the degradation worth a full restart: swap
        the slow hardware during the outage and roll back."""
        tel = self.telemetry
        ev_args = {"step": self.step, "victims": list(groups),
                   "demote": False}
        with maybe_span(tel, "recover", args=ev_args):
            report.wipeouts += 1
            self._global_restart()
            rolled_from = self.step
            self.step, (self.params, self.opt_state) = self._rollback()
            sec_per_step = float(getattr(
                injector, "seconds_per_step", 0.0) or 0.0)
            event = RecoveryEvent(
                step=rolled_from, victims=list(groups), wipeout=True,
                reordered=False, patch_count=0, s_a_before=1,
                s_a_after=1, rollback_depth=rolled_from - self.step,
                slow_factor=max(float(hr.factors[g]) for g in groups))
            event.step_seconds = event.rollback_depth * sec_per_step
            event.restart_seconds = self._t_restart
            ev_args.update(wipeout=True,
                           rollback_depth=event.rollback_depth,
                           restart_seconds=event.restart_seconds)
            notify = getattr(injector, "notify_outage", None)
            if notify is not None:
                notify(self._t_restart, kind="restart")
        report.events.append(event)
        if tel is not None:
            tel.counter("train.wipeouts").inc()
            tel.counter("train.rollback_steps").inc(event.rollback_depth)

    def _health_reshape(self, groups: list[int], hr, injector,
                        report: TrainReport) -> None:
        """Elastic escape hatch: shrink the data-parallel group away from
        the slow groups. Only meaningful where :meth:`_apply_reshape`
        exists (the elastic executor); the base policy never picks it
        because :meth:`_degraded_dp_new` returns 0."""
        event = RecoveryEvent(
            step=self.step, victims=list(groups), wipeout=False,
            reordered=False, patch_count=0,
            s_a_before=int(self.state.s_a), s_a_after=int(self.state.s_a),
            slow_factor=max(float(hr.factors[g]) for g in groups))
        tel = self.telemetry
        ev_args = {"step": self.step, "victims": list(groups),
                   "reshape": True}
        with maybe_span(tel, "recover", args=ev_args):
            report.reshapes += 1
            self._apply_reshape(event, list(groups), injector, report)
            self._schedule_version += 1
            # the reshape rebuilt the schedule in a new group space:
            # demotion bookkeeping does not survive it
            self._demoted.clear()
            self._demote_snapshot = None
            ev_args.update(dp_before=event.dp_before,
                           dp_after=event.dp_after,
                           reshape_seconds=event.reshape_seconds)
        report.events.append(event)
        if tel is not None:
            tel.counter("train.reshapes").inc()
            tel.gauge("train.dp_degree").set(event.dp_after)

    # ---------------------------------------------------------------- #
    def run(self, steps: int,
            injector: Callable[[SpareState], list[int]] | None = None,
            snapshot_every: int = 10,
            verify_equivalence: bool = False,
            equivalence_tol: float = 1e-2) -> TrainReport:
        report = TrainReport()
        tel = self.telemetry
        if tel is not None and injector is not None \
                and hasattr(injector, "telemetry"):
            injector.telemetry = tel
        self._snapshot_now()
        target = self.step + steps
        while self.step < target:
            wiped = False
            for victims in self._poll_events(injector):
                # detection at the all-reduce: the in-flight step fails;
                # the scheme decides wipe-out vs. mask/reorder. Every
                # event's full victim batch reaches recover() in ONE call
                victims = self._event_victims([int(w) for w in victims])
                victims = [w for w in victims if self.state.alive[w]]
                if not victims:
                    continue
                report.failures += len(victims)
                if tel is not None:
                    tel.counter("train.failures").inc(len(victims))
                    for g in victims:
                        tel.instant("failure", track=f"dp/{g}",
                                    args={"step": self.step})
                ev_args = {"step": self.step, "victims": list(victims)}
                t_ev = time.perf_counter()
                with maybe_span(tel, "recover", args=ev_args):
                    outcome = self.scheme.recover(self.state, victims,
                                                  step=self.step)
                    # any fail-stop recovery invalidates the demotion
                    # snapshot (re-admit falls back to a clean rebuild)
                    self._schedule_version += 1
                    report.controller_seconds += outcome.controller_seconds
                    action = "mask"
                    if outcome.wipeout:
                        # the elastic tier may absorb an unmaskable set
                        # by shrinking the group instead of restarting
                        action = self._unmaskable_action(victims, injector)
                    event = RecoveryEvent(
                        step=self.step, victims=victims,
                        wipeout=outcome.wipeout and action != "reshape",
                        reordered=outcome.reordered,
                        patch_count=outcome.patch_count,
                        s_a_before=outcome.s_a_before,
                        s_a_after=outcome.s_a_after, moves=outcome.moves)
                    ev_args.update(wipeout=event.wipeout,
                                   s_a_before=outcome.s_a_before,
                                   s_a_after=outcome.s_a_after)
                    if action == "reshape":
                        report.reshapes += 1
                        self._apply_reshape(event, victims, injector,
                                            report)
                        event.step_seconds = outcome.controller_seconds
                        ev_args.update(
                            reshape=True, dp_before=event.dp_before,
                            dp_after=event.dp_after,
                            s_a_after=event.s_a_after,
                            reshape_seconds=event.reshape_seconds)
                    elif outcome.wipeout:
                        report.wipeouts += 1
                        self._global_restart()
                        rolled_from = self.step
                        self.step, (self.params, self.opt_state) = \
                            self._rollback()
                        event.rollback_depth = rolled_from - self.step
                        sec_per_step = float(getattr(
                            injector, "seconds_per_step", 0.0) or 0.0)
                        event.step_seconds = \
                            event.rollback_depth * sec_per_step
                        event.restart_seconds = self._t_restart
                        ev_args.update(
                            rollback_depth=event.rollback_depth,
                            restart_seconds=event.restart_seconds)
                        notify = getattr(injector, "notify_outage", None)
                        if notify is not None:
                            # outage elapsed; re-arm the arrival model
                            notify(self._t_restart, kind="restart")
                        else:
                            legacy = getattr(injector, "notify_wipeout",
                                             None)
                            if legacy is not None:
                                legacy()
                        wiped = True
                    else:
                        # masked: the step-clock cost is the controller
                        event.step_seconds = outcome.controller_seconds
                event.wall_seconds = time.perf_counter() - t_ev
                if tel is not None:
                    if event.wipeout:
                        tel.counter("train.wipeouts").inc()
                        tel.counter("train.rollback_steps").inc(
                            event.rollback_depth)
                    if event.reshape:
                        tel.counter("train.reshapes").inc()
                        tel.gauge("train.dp_degree").set(event.dp_after)
                    tel.gauge("train.s_a").set(event.s_a_after)
                if wiped:
                    report.events.append(event)
                    break   # later events hit a system already down
                report.reorders += int(outcome.reordered)
                report.patches += outcome.patch_count
                if verify_equivalence:
                    # §3.1 invariant: the recovered schedule must still
                    # collect vanilla DP's exact batch gradient
                    with maybe_span(tel, "grad_check",
                                    args={"step": self.step}):
                        event.grad_check_err = self.equivalence_error()
                    if event.grad_check_err > equivalence_tol:
                        raise RuntimeError(
                            f"§3.1 gradient equivalence violated after "
                            f"recovering {victims} at step {self.step}: "
                            f"rel err {event.grad_check_err:.3e} > "
                            f"{equivalence_tol:.3e}")
                report.events.append(event)
            if wiped:
                continue
            with maybe_span(
                    tel, "step",
                    args=(None if tel is None else
                          {"step": self.step,
                           "s_a": self.state.s_a})) as step_span:
                with maybe_span(tel, "compute"):
                    new_params, new_opt, metrics = self._dispatch(report)
                    self.params, self.opt_state = new_params, new_opt
                    loss = float(metrics["loss"])   # blocks on the device
                report.losses.append(loss)
                self.step += 1
                report.steps_done += 1
                if self.step % snapshot_every == 0:
                    with maybe_span(tel, "ckpt_save"):
                        self._snapshot_now()
                        self._save_disk(report)
            if tel is not None:
                tel.counter("train.steps").inc()
                tel.histogram("train.step_seconds").observe(step_span.dur)
                if step_span.dur > 0:
                    tel.gauge("train.steps_per_s").set(1.0 / step_span.dur)
            # gray-failure tier: one detector observation per completed
            # step; may demote stragglers or re-admit healed groups
            self._health_tick(injector, report)
        if self.ckpt is not None:
            self.ckpt.wait()
            # saves land between snapshot boundaries: refresh after the
            # final wait so the report counts them all
            report.ckpt_saves = self.ckpt.saves
        return report

    # ---------------------------------------------------------------- #
    def _batch_grads(self, batch: dict):
        """Total-batch gradient (fp32, summed over the stack) of the
        current params: the §3.1 oracle."""
        layout = bucket_layout(accumulator_specs(self.params))
        grads = unflatten_grads(layout, layout.zeros(self.device))
        accumulate_grads(self.model, self.params, batch, grads)
        return grads

    def vanilla_reference_grads(self, step: int | None = None):
        """Vanilla-DP gradient of the same logical batch (all N types,
        weight 1/N each) — the §3.1 equivalence oracle."""
        step = self.step if step is None else step
        pristine = SpareState(self.state.n, self.state.r)
        return self._batch_grads(self._to_device(
            spare_batch(self.pipeline, pristine, step)))

    def equivalence_error(self, step: int | None = None) -> float:
        """§3.1 check: relative gradient-equivalence error of the current
        schedule vs the vanilla-DP oracle."""
        # lazy: repro_torch.exec pulls in this module at import time
        from repro_torch.exec.equivalence import tree_max_rel_err
        return tree_max_rel_err(self.spare_grads(step),
                                self.vanilla_reference_grads(step))

    def spare_grads(self, step: int | None = None):
        """Gradient under the *current* (possibly failed/reordered)
        schedule — must equal :meth:`vanilla_reference_grads`."""
        step = self.step if step is None else step
        return self._batch_grads(self._to_device(
            spare_batch(self.pipeline, self.state, step)))
