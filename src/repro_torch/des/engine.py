"""Shared bulk-synchronous DES engine for fault-tolerance schemes.

Every scheme in the paper's comparison (App. E flowchart, Sec. 5.2) runs
the same outer timeline::

    [maybe checkpoint] -> compute phase -> all-reduce attempt
        |- no failure detected: commit step
        |- failure(s): failed all-reduce (0.5 T_a) -> scheme-specific recovery

What differs between CKPT-only, Rep+CKPT, SPARe+CKPT (and any future
policy) is *only* the per-step compute load, the failure-detection timing,
and the recovery protocol. This module factors the shared skeleton into
:func:`run_scheme` driving a :class:`FaultToleranceScheme` through its
lifecycle hooks:

``on_step_start``
    called once per step, before the compute phase; returns the compute
    duration (seconds) and the number of stacks the step will commit.
``on_allreduce``
    called when failures land *inside* an otherwise-successful all-reduce
    window; returns whether the scheme detects them now (failing the
    all-reduce late) or defers detection to the next step's attempt.
``on_failure``
    the recovery protocol: the scheme performs its recovery advances on
    the clock (controller, patch computes, shrink, redo-all-reduce) and
    reports wipe-out vs. masked, plus any extra committed work/stacks.
``on_wipeout``
    reset scheme-private state right before the engine's global restart.
``on_checkpoint``
    called after each checkpoint save commits (the natural point for
    adaptive policies to re-evaluate, since a checkpoint is the only
    clean switch boundary — committed work can never be rolled past it).

Accounting (identical to the original three hand-rolled loops):

* ``wall``       — total simulated wall-clock = time-to-train;
* ``committed``  — work time of steps that survived to the end (compute
  including redundant stacks and patches + successful all-reduces).
  Checkpoint saves, failed all-reduces, shrink/controller time, global
  restarts, and rolled-back (reworked) steps are downtime/waste.
  ``availability = committed / wall`` — matching Eq. 2's semantics, where
  J(r) = ttt/T0 = S_bar / A.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .params import DESParams

__all__ = ["SimResult", "SimClock", "FailureRecovery", "FaultToleranceScheme",
           "run_scheme"]


@dataclass
class SimResult:
    scheme: str
    n: int
    r: int
    wall: float
    committed: float
    t0: float
    steps_done: int
    node_failures: int
    wipeouts: int
    ckpt_count: int
    total_stacks: float      # stacks computed across committed steps
    patches: int
    controller_seconds: float = 0.0
    mode_switches: int = 0   # adaptive-policy mode changes (0 for fixed)

    @property
    def ttt_norm(self) -> float:
        return self.wall / self.t0

    @property
    def availability(self) -> float:
        return self.committed / self.wall if self.wall > 0 else 1.0

    @property
    def avg_stacks(self) -> float:
        return self.total_stacks / max(self.steps_done, 1)


class SimClock:
    """Shared clock / failure-stream / accounting plumbing.

    Failure arrivals and victim selection are delegated to a pluggable
    :class:`repro.scenarios.models.FailureModel`; the default
    ``RenewalModel`` draws *exactly* the sequence the pre-scenario clock
    drew (one interval via ``FailureProcess``, one uniform victim), so
    the legacy parity tests stay bit-for-bit. Non-default models may
    kill several groups per event (rack/pod bursts, trace replay) —
    every victim lands in ``pending`` and the scheme's ``on_failure``
    sees the whole simultaneous-failure set.
    """

    def __init__(self, p: DESParams, seed: int, failure_model=None,
                 topology=None):
        # local import to avoid the des <-> scenarios cycle; keep the
        # window drain as an attribute so advance() pays no per-call
        # import-machinery cost in the hot loop
        from ..scenarios.models import RenewalModel, drain_event_window
        self._drain = drain_event_window
        self.p = p
        self.rng = np.random.default_rng(seed)
        self.topology = topology
        self.model = failure_model if failure_model is not None \
            else RenewalModel()
        self.model.bind(p, self.rng, topology)
        self.proc = getattr(self.model, "proc", None)  # legacy attribute
        self.now = 0.0
        self.alive = p.n
        self.next_fail = self.model.next_arrival(0.0, self.alive, p.n)
        self.pending: list[int] = []        # failed groups awaiting detection
        self.dead: set[int] = set()
        # accounting
        self.committed = 0.0
        self.work_since_ckpt = 0.0
        self.node_failures = 0
        self.wipeouts = 0
        self.ckpt_count = 0
        self.total_stacks = 0.0
        self.patches = 0
        self.stacks_since_ckpt = 0.0
        self.total_stacks_committed = 0.0

    # -------------------------------------------------------------- #
    def jitter(self) -> float:
        return max(0.0, float(self.rng.normal(1.0, self.p.jitter_std)))

    def advance(self, duration: float) -> float:
        """Advance the clock by a jittered duration; harvest failure
        arrivals that land inside the window into ``pending`` (via the
        victim-batching loop shared with the live trainer bridge)."""
        dur = duration * self.jitter()
        end = self.now + dur
        events, self.next_fail, self.alive = self._drain(
            self.model, self.next_fail, end, self.dead, self.alive, self.p.n)
        for _, victims in events:
            self.pending.extend(victims)
            self.node_failures += len(victims)
        self.now = end
        return dur

    def restart(self) -> None:
        """Global restart: T_r downtime, full capacity restored, progress
        rolls back to the last checkpoint (handled by caller), pending
        failure queue cleared, arrival process re-armed."""
        self.now += self.p.t_restart * self.jitter()
        self.dead.clear()
        self.pending.clear()
        self.alive = self.p.n
        self.wipeouts += 1
        self.work_since_ckpt = 0.0
        self.stacks_since_ckpt = 0.0
        self.next_fail = self.model.reset(self.now, self.alive, self.p.n)

    def checkpoint(self) -> None:
        self.advance(self.p.t_save)
        self.committed += self.work_since_ckpt
        self.total_stacks_committed += self.stacks_since_ckpt
        self.work_since_ckpt = 0.0
        self.stacks_since_ckpt = 0.0
        self.ckpt_count += 1

    def finish(self) -> None:
        self.committed += self.work_since_ckpt
        self.total_stacks_committed += self.stacks_since_ckpt


def build_result(sim: SimClock, scheme: str, r: int, steps_done: int,
                 controller_seconds: float = 0.0,
                 mode_switches: int = 0) -> SimResult:
    p = sim.p
    return SimResult(
        scheme=scheme, n=p.n, r=r,
        wall=sim.now, committed=sim.committed, t0=p.t0,
        steps_done=steps_done,
        node_failures=sim.node_failures, wipeouts=sim.wipeouts,
        ckpt_count=sim.ckpt_count,
        total_stacks=sim.total_stacks_committed,
        patches=sim.patches,
        controller_seconds=controller_seconds,
        mode_switches=mode_switches,
    )


@dataclass
class FailureRecovery:
    """What a scheme's :meth:`on_failure` decided.

    ``wipeout``      — the failure set exceeded the scheme's redundancy;
                       the engine rolls back to the last checkpoint and
                       performs the global restart.
    ``work``         — the step's updated committed-work total: the
                       ``work`` the hook received plus any recovery time
                       that counts as useful (redone all-reduce, patch
                       computes), accumulated *by the scheme* so the
                       float summation order matches the recovery's
                       advance order exactly. Ignored on wipe-out.
    ``extra_stacks`` — additional stacks committed by the recovery (e.g.
                       SPARe patch computes on the critical path).
    """

    wipeout: bool
    work: float = 0.0
    extra_stacks: float = 0.0


class FaultToleranceScheme:
    """Base class for pluggable fault-tolerance policies.

    A scheme instance is created via :func:`repro.des.get_scheme` (or
    directly), then either simulated with :meth:`simulate` / consumed by
    :class:`repro.train.trainer.SpareTrainer` for live recovery decisions
    via :meth:`recover`.

    Subclasses set :attr:`name`, implement the lifecycle hooks, and may
    carry per-run state (initialised in :meth:`bind`, which the engine
    calls once per simulation).
    """

    #: registry key / SimResult.scheme label
    name: str = "base"
    #: does a failure landing inside a successful all-reduce window fail
    #: that all-reduce (detected now), or surface at the next attempt?
    late_detection: bool = True
    #: does the failed all-reduce fraction count as committed work when
    #: the step ultimately survives?  (SPARe charges it — the partial
    #: all-reduce moved real gradient bytes; replication discards it.)
    failed_allreduce_in_work: bool = False

    # ---------------------------------------------------------------- #
    # lifecycle hooks (engine-facing)                                  #
    # ---------------------------------------------------------------- #
    def bind(self, p: DESParams, sim: SimClock,
             t_c: float | None = None) -> None:
        """Initialise per-run state. Called once before the event loop."""
        self.p = p
        self.sim = sim
        self._t_c = t_c if t_c is not None else self.default_t_c(p)

    def default_t_c(self, p: DESParams) -> float:
        """Scheme's optimal static checkpoint interval (Eq. 1)."""
        raise NotImplementedError

    def checkpoint_interval(self, sim: SimClock) -> float:
        """Current checkpoint interval (may adapt to observed hazard)."""
        return self._t_c

    def on_step_start(self, sim: SimClock) -> tuple[float, float]:
        """Return ``(compute_seconds, stacks)`` for the next step."""
        raise NotImplementedError

    def on_allreduce(self, sim: SimClock) -> bool:
        """Failures landed inside the successful all-reduce window; return
        True to fail the all-reduce now (late detection)."""
        return self.late_detection

    def on_failure(self, sim: SimClock, failed: list[int],
                   work: float) -> FailureRecovery:
        """Run the scheme's recovery protocol for ``failed`` groups.
        ``work`` is the step's committed-work total so far; return it
        (plus any recovery work) in :attr:`FailureRecovery.work`."""
        raise NotImplementedError

    def on_wipeout(self, sim: SimClock) -> None:
        """Reset scheme-private state; the engine restarts right after."""

    def on_checkpoint(self, sim: SimClock) -> None:
        """A checkpoint just committed (clean policy-switch boundary)."""

    # ---------------------------------------------------------------- #
    # results / introspection                                          #
    # ---------------------------------------------------------------- #
    @property
    def result_r(self) -> int:
        """Redundancy degree reported in :class:`SimResult`."""
        return getattr(self, "r", 1)

    @property
    def controller_seconds(self) -> float:
        return 0.0

    @property
    def mode_switches(self) -> int:
        return 0

    def predicted_overhead(self) -> float:
        """Closed-form normalized time-to-train J = ttt/T0 (Sec. 4 theory)."""
        raise NotImplementedError

    # ---------------------------------------------------------------- #
    # trainer-facing protocol                                          #
    # ---------------------------------------------------------------- #
    def prepare(self, p: DESParams) -> None:
        """Attach the live system's failure model (N, MTBF, T_s, T_r) for
        trainer use — the out-of-simulation counterpart of :meth:`bind`.
        Called once by :class:`SpareTrainer`; adaptive policies use it to
        pick their initial mode from the configured prior."""
        self.p = p

    def recover(self, state, failed: list[int], step: int | None = None):
        """Live recovery decision for :class:`SpareTrainer`: given the
        trainer's :class:`repro.core.SpareState` and newly failed groups,
        return a :class:`repro.core.rectlr.RectlrOutcome`-compatible
        object (``wipeout`` / ``reordered`` / ``patch`` / ...).
        ``step`` is the trainer's current step counter; adaptive policies
        use it to estimate the observed failure rate."""
        raise NotImplementedError

    # ---------------------------------------------------------------- #
    def simulate(self, p: DESParams, seed: int = 0,
                 t_c: float | None = None,
                 max_wall: float | None = None,
                 failure_model=None, topology=None) -> SimResult:
        """Run this scheme through the shared engine.

        ``failure_model`` / ``topology`` select the failure regime (see
        :mod:`repro.scenarios`); the default is the legacy single-victim
        renewal stream."""
        return run_scheme(self, p, seed=seed, t_c=t_c, max_wall=max_wall,
                          failure_model=failure_model, topology=topology)


def run_scheme(scheme: FaultToleranceScheme, p: DESParams, seed: int = 0,
               t_c: float | None = None,
               max_wall: float | None = None,
               failure_model=None, topology=None) -> SimResult:
    """The one bulk-synchronous event loop every scheme runs on.

    Event order (and therefore RNG-draw order) is identical to the three
    original hand-rolled loops — the parity tests in
    ``tests/test_scheme_api.py`` assert bit-for-bit equality against the
    frozen copies in :mod:`repro.des._legacy`.

    ``failure_model`` may inject multi-group simultaneous failures
    (rack/pod bursts, trace replay): all victims of one event surface in
    the same ``on_failure`` call, so wipe-out and stack accounting see
    the full blast radius at once.
    """
    sim = SimClock(p, seed, failure_model=failure_model, topology=topology)
    scheme.bind(p, sim, t_c=t_c)
    max_wall = max_wall if max_wall is not None else 500.0 * p.t0

    step = 0
    ckpt_step = 0
    last_ckpt_wall = 0.0
    while step < p.steps and sim.now < max_wall:
        if sim.now - last_ckpt_wall >= scheme.checkpoint_interval(sim) \
                and step > ckpt_step:
            sim.checkpoint()
            ckpt_step = step
            last_ckpt_wall = sim.now
            scheme.on_checkpoint(sim)
        compute_s, stacks = scheme.on_step_start(sim)
        work = sim.advance(compute_s)
        if not sim.pending:
            work += sim.advance(p.t_allreduce)
            if not sim.pending or not scheme.on_allreduce(sim):
                # committed step (failures inside the window, if any,
                # surface at the next step's attempt)
                step += 1
                sim.work_since_ckpt += work
                sim.stacks_since_ckpt += stacks
                continue
            # late detection: the all-reduce fails near its end — only
            # the failed fraction of it was useful motion
            work -= p.t_allreduce * (1.0 - p.failed_allreduce_frac)
        else:
            dur = sim.advance(p.t_allreduce * p.failed_allreduce_frac)
            if scheme.failed_allreduce_in_work:
                work += dur

        # ---- recovery path ----
        failed = sim.pending[:]
        sim.pending.clear()
        rec = scheme.on_failure(sim, failed, work)
        if rec.wipeout:
            scheme.on_wipeout(sim)
            step = ckpt_step                    # rework to last ckpt
            sim.restart()
            last_ckpt_wall = sim.now
            continue
        work = rec.work
        step += 1
        sim.work_since_ckpt += work
        sim.stacks_since_ckpt += stacks + rec.extra_stacks
    sim.finish()
    return build_result(sim, scheme.name, r=scheme.result_r, steps_done=step,
                        controller_seconds=scheme.controller_seconds,
                        mode_switches=scheme.mode_switches)
