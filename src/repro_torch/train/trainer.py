"""SpareTrainer — the paper's Alg. 1 as an executable training loop (the
PyTorch counterpart of ``repro.train.trainer``).

Glues every substrate together:

  data pipeline  ->  SPARe schedule (stacks, weights)   [host, RECTLR]
       |                      |
       v                      v
  train_step(params, opt, stacked_batch)                 [device]
       |
  in-memory snapshot (host copies) for wipe-out rollback

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
    into the live tensors in place);
  * ``report.recompiles`` counts the new stack depths ``S_A`` the run
    meets — what costs the JAX package a compile. Eager PyTorch compiles
    nothing, so here it is the same count, kept for the same reports.

Not ported yet (each raises ``NotImplementedError`` naming ROADMAP.md):
the checkpoint directory (``repro.ckpt``) and the gray-failure detector
(``repro.health``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import Rectlr, SpareState
from repro_torch.data import ShardedTokenPipeline, spare_batch
from repro_torch.des import DESParams, FaultToleranceScheme, get_scheme
from repro_torch.dist.collectives import bucket_layout, unflatten_grads
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.obs.trace import Telemetry, maybe_span
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.train.step import (accumulate_grads, accumulator_specs,
                                    make_train_step)

__all__ = ["SpareTrainer", "PoissonInjector", "TrainReport",
           "RecoveryEvent", "host_copy", "copy_into"]


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, AdamWState):
        return AdamWState(tree.step, _tree_map(fn, tree.mu),
                          _tree_map(fn, tree.nu))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def host_copy(tree):
    """A host (CPU) copy of every tensor of ``tree``; other leaves (the
    optimizer's step count) as they are."""
    return _tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def copy_into(live, saved) -> None:
    """Copy the tensors of ``saved`` (a :func:`host_copy`) back into the
    matching tensors of ``live``, in place."""
    for dst, src in zip(_tensors(live), _tensors(saved)):
        dst.copy_(src)


def _tensors(tree) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


class SpareTrainer:
    def __init__(self, cfg: ModelConfig, *, n_groups: int, redundancy: int,
                 seq: int = 128, per_type_batch: int = 2, seed: int = 0,
                 ckpt_dir: str | None = None, mtbf: float = 300.0,
                 t_save: float = 60.0, t_restart: float = 3600.0,
                 base_lr: float = 3e-4, total_steps: int = 1000,
                 scheme: FaultToleranceScheme | None = None,
                 telemetry: Telemetry | None = None,
                 detector=None, device: torch.device | str = "cuda"):
        if ckpt_dir is not None:
            raise NotImplementedError(
                "ckpt_dir: repro.ckpt is not ported yet (ROADMAP.md, "
                "'What waits'); the in-memory snapshot is always kept")
        if detector is not None:
            raise NotImplementedError(
                "detector: repro.health is not ported yet (ROADMAP.md, "
                "'What waits')")
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
        self._jitted: dict[Any, Any] = {}       # S_A depths seen
        self.ckpt = None
        # in-memory snapshot: a wipe-out must roll params/step back
        self._snapshot: tuple[int, Any] | None = None
        self.step = 0

    # ---------------------------------------------------------------- #
    def _compiled(self, s_a: int, report: TrainReport):
        if s_a not in self._jitted:
            self._jitted[s_a] = self._step_fn
            report.recompiles += 1
            if self.telemetry is not None:
                self.telemetry.counter("train.recompiles").inc()
        return self._jitted[s_a]

    def _to_device(self, batch_np: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch_np.items()}

    def _dispatch(self, report: TrainReport):
        batch = self._to_device(spare_batch(self.pipeline, self.state,
                                            self.step))
        fn = self._compiled(self.state.s_a, report)
        return fn(self.params, self.opt_state, batch)

    # ---------------------------------------------------------------- #
    # snapshot tier                                                    #
    # ---------------------------------------------------------------- #
    def _snapshot_now(self) -> None:
        """Record the rollback point: host copies of params and optimizer
        state — a wipe-out must never keep post-failure params."""
        self._snapshot = (self.step, host_copy((self.params,
                                                self.opt_state)))

    def _rollback(self) -> tuple[int, Any]:
        """Copy the snapshot back into the live tensors, in place."""
        assert self._snapshot is not None, "no snapshot taken yet"
        step, (params, opt_state) = self._snapshot
        copy_into((self.params, self.opt_state), (params, opt_state))
        self.opt_state.step = opt_state.step
        return step, (self.params, self.opt_state)

    def _snapshot_step(self) -> int:
        """Step of the current rollback point WITHOUT restoring it."""
        return self._snapshot[0] if self._snapshot is not None \
            else self.step

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
        rollback, the only option here) or ``"reshape"`` (the elastic
        tier, not ported)."""
        return "restart"

    def _apply_reshape(self, event: RecoveryEvent, victims: list[int],
                       injector, report: TrainReport) -> None:
        raise NotImplementedError(
            "elastic reshaping is not ported yet (ROADMAP.md)")

    def _global_restart(self) -> None:
        """Wipe-out: every group comes back at full capacity (the
        modeled cluster restart) before the rollback restores params."""
        self.state.reset()

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
                    report.controller_seconds += outcome.controller_seconds
                    action = "mask"
                    if outcome.wipeout:
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
            if tel is not None:
                tel.counter("train.steps").inc()
                tel.histogram("train.step_seconds").observe(step_span.dur)
                if step_span.dur > 0:
                    tel.gauge("train.steps_per_s").set(1.0 / step_span.dur)
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
