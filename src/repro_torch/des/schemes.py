"""Pluggable fault-tolerance schemes (paper App. E flowchart, Sec. 5.2).

Every scheme is a :class:`repro.des.engine.FaultToleranceScheme` driven by
the one shared bulk-synchronous engine (:func:`repro.des.engine.run_scheme`)
and registered under a string key::

    from repro_torch.des import get_scheme, DESParams

    res = get_scheme("spare", r=9).simulate(DESParams(n=200), seed=0)

Registered schemes:

``ckpt_only``    — vanilla synchronous DP + checkpointing: any node failure
                   is a system failure (Sec. 5.2.1).
``replication``  — traditional replication of degree ``r`` (Fig. 2):
                   every group always computes all ``r`` hosted stacks.
``spare``        — SPARe+CKPT with exact Alg. 1/2 semantics via the real
                   :class:`repro.core.SpareState` / :class:`repro.core.Rectlr`
                   controller objects (plus the beyond-paper dynamic-ckpt
                   and straggler-masking options).
``adaptive``     — Chameleon-style policy selector: starts from the
                   closed-form-optimal policy for the configured MTBF and
                   re-evaluates against the *observed* failure rate at
                   every checkpoint / restart, switching policies at those
                   clean boundaries.

The legacy ``simulate_ckpt_only`` / ``simulate_replication`` /
``simulate_spare`` entry points are kept as thin deprecated aliases over
the registry; ``tests/test_scheme_api.py`` proves each ported scheme
reproduces the frozen pre-refactor loops (:mod:`repro.des._legacy`)
bit-for-bit at fixed seeds.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..core.rectlr import Rectlr, RectlrOutcome
from ..core.state import SpareState
from ..core.theory import availability_star, mu as mu_theory, s_bar, tc_star
from .engine import (FailureRecovery, FaultToleranceScheme, SimClock,
                     SimResult, run_scheme)
from .params import DESParams

__all__ = [
    "SimResult",
    "CkptOnlyScheme", "ReplicationScheme", "SpareScheme", "AdaptiveScheme",
    "register_scheme", "get_scheme", "list_schemes",
    "simulate_ckpt_only", "simulate_replication", "simulate_spare",
]


# ------------------------------------------------------------------ #
# registry                                                           #
# ------------------------------------------------------------------ #
_REGISTRY: dict[str, type[FaultToleranceScheme]] = {}


def register_scheme(cls: type[FaultToleranceScheme]):
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name or cls.name == "base":
        raise ValueError(f"{cls.__name__} must set a unique `name`")
    _REGISTRY[cls.name] = cls
    return cls


def get_scheme(name: str, **kwargs) -> FaultToleranceScheme:
    """Instantiate a registered scheme: ``get_scheme("spare", r=9)``."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scheme {name!r}; registered: {list_schemes()}"
        ) from None
    return cls(**kwargs)


def list_schemes() -> list[str]:
    return sorted(_REGISTRY)


def _overhead(stacks: float, t_f: float, p: DESParams) -> float:
    """Time-accurate normalized ttt: step-cost ratio over availability."""
    a = availability_star(t_f, p.t_save, p.t_restart)
    return ((stacks * p.t_comp + p.t_allreduce)
            / (p.t_comp + p.t_allreduce)) / a


# ------------------------------------------------------------------ #
# Scheme 1: CKPT-only (vanilla DP + checkpointing)                    #
# ------------------------------------------------------------------ #
@register_scheme
class CkptOnlyScheme(FaultToleranceScheme):
    """Vanilla synchronous DP: *any* node failure is a system failure
    (all N partial gradients required), so every failure costs a global
    restart plus rework. In the restart-dominant regime this barely makes
    progress (paper Sec. 5.2.1)."""

    name = "ckpt_only"
    late_detection = True
    failed_allreduce_in_work = False

    def default_t_c(self, p: DESParams) -> float:
        return tc_star(p.mtbf, p.t_save, p.t_restart)

    def on_step_start(self, sim: SimClock) -> tuple[float, float]:
        return sim.p.t_comp, 1.0

    def on_failure(self, sim: SimClock, failed: list[int],
                   work: float) -> FailureRecovery:
        return FailureRecovery(wipeout=True)

    def predicted_overhead(self, p: DESParams | None = None,
                           mtbf: float | None = None) -> float:
        p = p if p is not None else self.p
        m = mtbf if mtbf is not None else p.mtbf
        return _overhead(1.0, m, p)

    def recover(self, state: SpareState, failed: list[int],
                step: int | None = None) -> RectlrOutcome:
        """Vanilla DP cannot mask anything: every failure is a wipe-out."""
        return RectlrOutcome(wipeout=True, reordered=False,
                             s_a_before=state.s_a, s_a_after=state.s_a)


# ------------------------------------------------------------------ #
# Scheme 2: Rep+CKPT (traditional replication, degree r)              #
# ------------------------------------------------------------------ #
@register_scheme
class ReplicationScheme(FaultToleranceScheme):
    """Traditional replication (Fig. 2): group ``w`` hosts the ``r``
    consecutive types ``{w .. w+r-1 mod N}`` and computes *all* of them
    every step (r x workload). Failures are masked while every type keeps
    >= 1 surviving host; wipe-out forces the global restart."""

    name = "replication"
    late_detection = False          # masked failures surface next step
    failed_allreduce_in_work = False

    def __init__(self, r: int):
        self.r = r
        self.ctl = Rectlr()        # trainer-facing recovery bookkeeping

    def bind(self, p: DESParams, sim: SimClock,
             t_c: float | None = None) -> None:
        super().bind(p, sim, t_c=t_c)
        self._host_alive = np.full(p.n, self.r, dtype=np.int64)

    def default_t_c(self, p: DESParams) -> float:
        t_f = mu_theory(p.n, self.r) * p.mtbf
        return tc_star(t_f, p.t_save, p.t_restart)

    def on_step_start(self, sim: SimClock) -> tuple[float, float]:
        return self.r * sim.p.t_comp, float(self.r)

    def _apply_failures(self, n: int, groups: list[int]) -> bool:
        """Returns True on wipe-out."""
        for w in groups:
            types_of_w = (w + np.arange(self.r)) % n
            self._host_alive[types_of_w] -= 1
        return bool((self._host_alive == 0).any())

    def on_failure(self, sim: SimClock, failed: list[int],
                   work: float) -> FailureRecovery:
        if self._apply_failures(sim.p.n, failed):
            return FailureRecovery(wipeout=True)
        sim.advance(sim.p.t_shrink)
        # surviving copies already computed: redo all-reduce only
        work += sim.advance(sim.p.t_allreduce)
        return FailureRecovery(wipeout=False, work=work)

    def on_wipeout(self, sim: SimClock) -> None:
        self._host_alive[:] = self.r

    def predicted_overhead(self, p: DESParams | None = None,
                           mtbf: float | None = None) -> float:
        p = p if p is not None else self.p
        m = mtbf if mtbf is not None else p.mtbf
        return _overhead(float(self.r), mu_theory(p.n, self.r) * m, p)

    def recover(self, state: SpareState, failed: list[int],
                step: int | None = None) -> RectlrOutcome:
        """Live recovery on a trainer's :class:`SpareState`: replication
        masks by redundancy alone, so the shared reordering controller is
        used only for supplier bookkeeping (it reports wipe-out exactly
        when some shard type lost every host)."""
        return self.ctl.on_failures(state, failed)


# ------------------------------------------------------------------ #
# Scheme 3: SPARe+CKPT (Alg. 1 exact semantics)                        #
# ------------------------------------------------------------------ #
@register_scheme
class SpareScheme(FaultToleranceScheme):
    """SPARe+CKPT with the *actual* protocol implementation: the DES calls
    the same :class:`SpareState`/:class:`Rectlr` objects the trainer uses,
    so simulated availability reflects the real controller decisions
    (all-reduce stack evolution, reordering, patch computes, wipe-outs).

    ``dynamic_ckpt`` enables the beyond-paper Weibull-aware checkpoint
    interval (Sec. 5.2.2 of the paper suggests it closes the low-r gap):
    with shape k < 1 the hazard rate is highest right after a failure, so
    the policy shortens the interval while failures are recent and relaxes
    back to T_c* as the system stays quiet.

    ``straggler_frac`` > 0 enables the beyond-paper straggler model: each
    step, that fraction of groups runs ``straggler_slowdown``x slow.
    Vanilla DP (and replication) wait for the slowest group; SPARe's
    early-all-reduce trigger fires as soon as every shard *type* is
    collectible from the fast groups' stacks — when redundancy covers a
    straggler's types elsewhere, its compute is off the critical path.
    """

    name = "spare"
    late_detection = True
    failed_allreduce_in_work = True

    def __init__(self, r: int, binary_search: bool = False,
                 dynamic_ckpt: bool = False, straggler_frac: float = 0.0,
                 straggler_slowdown: float = 3.0):
        self.r = r
        self.binary_search = binary_search
        self.dynamic_ckpt = dynamic_ckpt
        self.straggler_frac = straggler_frac
        self.straggler_slowdown = straggler_slowdown
        self.ctl = Rectlr(binary_search=binary_search)
        self._controller_seconds = 0.0

    def bind(self, p: DESParams, sim: SimClock,
             t_c: float | None = None) -> None:
        super().bind(p, sim, t_c=t_c)
        self._state = SpareState(p.n, self.r)
        self._last_failure_wall = -p.mtbf
        self._controller_seconds = 0.0

    def default_t_c(self, p: DESParams) -> float:
        t_f = mu_theory(p.n, self.r) * p.mtbf
        return tc_star(t_f, p.t_save, p.t_restart)

    def checkpoint_interval(self, sim: SimClock) -> float:
        if not self.dynamic_ckpt:
            return self._t_c
        # hazard-adapted interval: fresh failures (age << MTBF) => shorter
        p = sim.p
        age = max(sim.now - self._last_failure_wall, 1.0)
        k = p.weibull_shape
        scale = min((age / p.mtbf) ** (1.0 - k), 1.5)
        return max(2.0 * p.t_save, self._t_c * scale)

    def on_step_start(self, sim: SimClock) -> tuple[float, float]:
        p = sim.p
        state = self._state
        s_a = state.s_a
        if self.straggler_frac > 0.0:
            # which alive groups are slow this step?
            alive_groups = state.survivors
            slow = sim.rng.random(alive_groups.size) < self.straggler_frac
            fast = alive_groups[~slow]
            # fast groups' committed prefixes cover the stragglers' types?
            covered = np.zeros(state.n, dtype=bool)
            covered[state.stacks[fast, :s_a].ravel()] = True
            if covered.all():
                step_comp = s_a * p.t_comp          # stragglers irrelevant
            else:
                # SPARe masking: fast hosts supply the missing types by
                # computing extra stacks (the patch-compute path) — the
                # step costs the minimal covering depth d <= r, or waiting
                # for the stragglers, whichever is cheaper
                wait = self.straggler_slowdown * s_a
                best = wait
                for d in range(s_a + 1, state.r + 1):
                    if d >= wait:
                        break
                    cov = np.zeros(state.n, dtype=bool)
                    cov[state.stacks[fast, :d].ravel()] = True
                    if cov.all():
                        best = float(d)
                        break
                step_comp = best * p.t_comp
        else:
            step_comp = s_a * p.t_comp
        return step_comp, float(s_a)

    def on_failure(self, sim: SimClock, failed: list[int],
                   work: float) -> FailureRecovery:
        p = sim.p
        self._last_failure_wall = sim.now
        outcome = self.ctl.on_failures(self._state, failed)
        self._controller_seconds += outcome.controller_seconds
        sim.advance(p.t_controller)
        if outcome.wipeout:
            return FailureRecovery(wipeout=True)
        # patch computes run in parallel across groups: time = max per-group
        patch_stacks = 0
        if outcome.patch:
            loads: dict[int, int] = {}
            for w, _ in outcome.patch:
                loads[w] = loads.get(w, 0) + 1
            patch_stacks = max(loads.values())
            work += sim.advance(patch_stacks * p.t_comp)
            sim.patches += len(outcome.patch)
        sim.advance(p.t_shrink)
        work += sim.advance(p.t_allreduce)          # redo the all-reduce
        # wall-time-equivalent extra stacks: the critical-path patch depth
        # (S_A itself was already accounted at step start — together this
        # is exactly the c(k)+rho_k quantity of Thm. 4.2, measured)
        return FailureRecovery(wipeout=False, work=work,
                               extra_stacks=float(patch_stacks))

    def on_wipeout(self, sim: SimClock) -> None:
        self._state.reset()

    @property
    def controller_seconds(self) -> float:
        return self._controller_seconds

    def predicted_overhead(self, p: DESParams | None = None,
                           mtbf: float | None = None) -> float:
        p = p if p is not None else self.p
        m = mtbf if mtbf is not None else p.mtbf
        return _overhead(s_bar(p.n, self.r), mu_theory(p.n, self.r) * m, p)

    def recover(self, state: SpareState, failed: list[int],
                step: int | None = None) -> RectlrOutcome:
        """Live recovery decision (Alg. 2): shared verbatim between the
        DES above and :class:`repro.train.trainer.SpareTrainer`."""
        outcome = self.ctl.on_failures(state, failed)
        self._controller_seconds += outcome.controller_seconds
        return outcome


# ------------------------------------------------------------------ #
# Scheme 4: adaptive policy selector (beyond-paper, Chameleon-style)  #
# ------------------------------------------------------------------ #
@register_scheme
class AdaptiveScheme(FaultToleranceScheme):
    """Real-time policy selection between ckpt-only / replication / SPARe.

    The selector keeps a smoothed estimate of the system MTBF,

        m_hat = (t_elapsed + w * m_prior) / (n_failures + w),

    and at every clean boundary — a committed checkpoint, or the global
    restart after a wipe-out — re-evaluates each candidate's closed-form
    ``predicted_overhead`` (Sec. 4 theory, :mod:`repro.core.theory`) at
    ``m_hat`` and switches to the argmin.  Switching at a checkpoint
    (only possible with no outstanding dead groups) charges ``t_reconfig``
    for the resharding; switching during a restart is free — the restart
    rebuilds every group anyway.

    With a quiet cluster the selector stays on cheap vanilla-DP
    checkpointing; as the observed failure rate approaches the
    restart-dominant regime it moves to SPARe, tracking the best fixed
    policy without knowing the failure rate in advance.
    """

    name = "adaptive"
    # detection/work attributes delegate to the active mode (see below)

    def __init__(self, r: int, r_rep: int = 2, initial: str | None = None,
                 prior_weight: float = 1.0, **spare_kwargs):
        self.r = r
        self.r_rep = r_rep
        self.initial = initial
        self.prior_weight = prior_weight
        self._modes: dict[str, FaultToleranceScheme] = {
            "ckpt_only": CkptOnlyScheme(),
            "replication": ReplicationScheme(r=r_rep),
            "spare": SpareScheme(r=r, **spare_kwargs),
        }
        self._mode_name = initial or "spare"
        self._switches = 0
        self.history: list[tuple[float, str]] = []   # (wall, mode) log
        # live-trainer observation state (see prepare()/recover())
        self._live_failures = 0
        self._live_step0: int | None = None
        # per-event mask-vs-reshape-vs-restart estimates (live trainer)
        self.unmaskable_decisions: list[dict] = []

    # -------------------------------------------------------------- #
    @property
    def mode(self) -> FaultToleranceScheme:
        return self._modes[self._mode_name]

    @property
    def ctl(self) -> Rectlr:
        """Shared reordering controller (the SPARe candidate's)."""
        return self._modes["spare"].ctl

    @property
    def mode_name(self) -> str:
        return self._mode_name

    @property
    def late_detection(self) -> bool:  # type: ignore[override]
        return self.mode.late_detection

    @property
    def failed_allreduce_in_work(self) -> bool:  # type: ignore[override]
        return self.mode.failed_allreduce_in_work

    # -------------------------------------------------------------- #
    def bind(self, p: DESParams, sim: SimClock,
             t_c: float | None = None) -> None:
        self.p, self.sim = p, sim
        self._switches = 0
        for m in self._modes.values():
            m.bind(p, sim, t_c=t_c)
        if self.initial is None:
            self._mode_name = self._best_mode(p.mtbf)
        else:
            self._mode_name = self.initial
        self.history = [(0.0, self._mode_name)]

    def _mtbf_hat(self, sim: SimClock) -> float:
        w = self.prior_weight
        return (sim.now + w * sim.p.mtbf) / (sim.node_failures + w)

    def _best_mode(self, mtbf: float) -> str:
        scores = {name: m.predicted_overhead(self.p, mtbf=mtbf)
                  for name, m in self._modes.items()}
        return min(scores, key=scores.get)

    def _switch_to(self, name: str, sim: SimClock, free: bool) -> None:
        if name == self._mode_name:
            return
        # the target must start from consistent (fully-redundant) state
        self._modes[name].on_wipeout(sim)
        self._mode_name = name
        self._switches += 1
        self.history.append((sim.now, name))
        if not free:
            sim.advance(sim.p.t_reconfig)   # resharding / policy rollout

    # -------------------------------------------------------------- #
    # delegated lifecycle                                            #
    # -------------------------------------------------------------- #
    def checkpoint_interval(self, sim: SimClock) -> float:
        return self.mode.checkpoint_interval(sim)

    def on_step_start(self, sim: SimClock) -> tuple[float, float]:
        return self.mode.on_step_start(sim)

    def on_allreduce(self, sim: SimClock) -> bool:
        return self.mode.on_allreduce(sim)

    def on_failure(self, sim: SimClock, failed: list[int],
                   work: float) -> FailureRecovery:
        return self.mode.on_failure(sim, failed, work)

    def on_wipeout(self, sim: SimClock) -> None:
        self.mode.on_wipeout(sim)
        # the engine restarts next: every group comes back, so switching
        # here is free and always consistent
        self._switch_to(self._best_mode(self._mtbf_hat(sim)), sim, free=True)

    def on_checkpoint(self, sim: SimClock) -> None:
        if sim.dead:
            return      # mid-degradation: no clean reshard point
        self._switch_to(self._best_mode(self._mtbf_hat(sim)), sim, free=False)

    # -------------------------------------------------------------- #
    @property
    def result_r(self) -> int:
        return self.r

    @property
    def controller_seconds(self) -> float:
        return self._modes["spare"].controller_seconds

    @property
    def mode_switches(self) -> int:
        return self._switches

    def predicted_overhead(self, p: DESParams | None = None,
                           mtbf: float | None = None) -> float:
        p = p if p is not None else self.p
        return min(m.predicted_overhead(p, mtbf=mtbf)
                   for m in self._modes.values())

    # -------------------------------------------------------------- #
    # live-trainer protocol                                          #
    # -------------------------------------------------------------- #
    def prepare(self, p: DESParams) -> None:
        """Pick the initial policy for live training from the trainer's
        failure model (the Chameleon prior); observation state resets."""
        self.p = p
        self._live_failures = 0
        self._live_step0 = None
        self.unmaskable_decisions = []
        self.degraded_decisions = []
        if self.initial is None:
            self._mode_name = self._best_mode(p.mtbf)
        self.history = [(0.0, self._mode_name)]

    def recover(self, state: SpareState, failed: list[int],
                step: int | None = None) -> RectlrOutcome:
        """Delegate to the current mode; on a wipe-out (the trainer's
        global-restart boundary — every group comes back, so any policy
        is consistent) re-evaluate against the failure rate observed in
        *step* time, converted to wall time via the prepared step cost."""
        if self._live_step0 is None:
            self._live_step0 = step if step is not None else 0
        self._live_failures += len(failed)
        decision = self.mode.recover(state, failed, step=step)
        if decision.wipeout and step is not None and hasattr(self, "p"):
            p = self.p
            elapsed = (step - self._live_step0) * (p.t_comp + p.t_allreduce)
            w = self.prior_weight
            mtbf_hat = ((elapsed + w * p.mtbf)
                        / (self._live_failures + w))
            target = self._best_mode(mtbf_hat)
            if target != self._mode_name:
                self._mode_name = target
                self._switches += 1
                self.history.append((elapsed, target))
        return decision

    def decide_unmaskable(self, *, dp_full: int, dp_new: int,
                          remaining_steps: int, seconds_per_step: float,
                          rollback_steps: int = 0,
                          t_restart: float | None = None,
                          t_reshape: float | None = None, **_) -> str:
        """The live third-regime decision: an unmaskable failure set is
        past every mode's masking power, so the selector weighs the
        paper's closed-form TTT of degraded-continue at ``dp_new``
        against restart-and-rollback (:func:`repro.elastic.policy
        .ttt_estimates`). Outage defaults come from the prepared
        :class:`DESParams` (``t_restart``; ``t_reconfig`` as the
        resharding cost). Every estimate is logged in
        ``unmaskable_decisions`` for the campaign's policy audit."""
        from ..elastic.policy import ttt_estimates
        p = getattr(self, "p", None)
        if t_restart is None:
            t_restart = p.t_restart if p is not None else 3600.0
        if t_reshape is None:
            t_reshape = p.t_reconfig if p is not None else 1.0
        est = ttt_estimates(
            dp_full=dp_full, dp_new=dp_new,
            remaining_steps=remaining_steps,
            seconds_per_step=seconds_per_step,
            rollback_steps=rollback_steps,
            t_restart=t_restart, t_reshape=t_reshape)
        self.unmaskable_decisions.append(est)
        return est["action"]

    def decide_degraded(self, *, factors, candidates, remaining_steps: int,
                        seconds_per_step: float, dp_full: int,
                        dp_new: int = 0, maskable: bool = True,
                        alive=None, demoted=(), rollback_steps: int = 0,
                        t_restart: float | None = None,
                        t_reshape: float | None = None,
                        t_demote: float = 0.0, **_) -> str:
        """The gray-failure decision: the detector flagged
        ``candidates`` as stragglers (per-group slowdown ``factors``),
        and the selector weighs tolerate vs SPARe demotion vs elastic
        reshape vs restart with the closed-form degraded-throughput
        model (:func:`repro.health.policy.degraded_ttt_estimates` —
        step time = max factor over groups still in the barrier).
        ``maskable=False`` means RECTLR cannot re-cover the candidate
        set, ruling demotion out. Outage defaults come from the
        prepared :class:`DESParams` as in :meth:`decide_unmaskable`;
        every estimate lands in ``degraded_decisions``."""
        from ..health.policy import degraded_ttt_estimates
        p = getattr(self, "p", None)
        if t_restart is None:
            t_restart = p.t_restart if p is not None else 3600.0
        if t_reshape is None:
            t_reshape = p.t_reconfig if p is not None else 1.0
        est = degraded_ttt_estimates(
            factors=factors, candidates=candidates,
            remaining_steps=remaining_steps,
            seconds_per_step=seconds_per_step,
            dp_full=dp_full, dp_new=dp_new, maskable=maskable,
            alive=alive, demoted=demoted, rollback_steps=rollback_steps,
            t_restart=t_restart, t_reshape=t_reshape, t_demote=t_demote)
        if not hasattr(self, "degraded_decisions"):
            self.degraded_decisions = []
        self.degraded_decisions.append(est)
        return est["action"]


# ------------------------------------------------------------------ #
# deprecated aliases (pre-registry entry points)                      #
# ------------------------------------------------------------------ #
def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro.des.{old} is deprecated; use repro.des.get_scheme({new})"
        f".simulate(p, ...) instead",
        DeprecationWarning, stacklevel=3)


def simulate_ckpt_only(p: DESParams, seed: int = 0,
                       t_c: float | None = None,
                       max_wall: float | None = None) -> SimResult:
    """Deprecated alias for ``get_scheme("ckpt_only").simulate(...)``."""
    _deprecated("simulate_ckpt_only", '"ckpt_only"')
    return run_scheme(CkptOnlyScheme(), p, seed=seed, t_c=t_c,
                      max_wall=max_wall)


def simulate_replication(p: DESParams, r: int, seed: int = 0,
                         t_c: float | None = None,
                         max_wall: float | None = None) -> SimResult:
    """Deprecated alias for ``get_scheme("replication", r=r).simulate(...)``."""
    _deprecated("simulate_replication", '"replication", r=r')
    return run_scheme(ReplicationScheme(r=r), p, seed=seed, t_c=t_c,
                      max_wall=max_wall)


def simulate_spare(p: DESParams, r: int, seed: int = 0,
                   t_c: float | None = None,
                   max_wall: float | None = None,
                   binary_search: bool = False,
                   dynamic_ckpt: bool = False,
                   straggler_frac: float = 0.0,
                   straggler_slowdown: float = 3.0) -> SimResult:
    """Deprecated alias for ``get_scheme("spare", r=r, ...).simulate(...)``."""
    _deprecated("simulate_spare", '"spare", r=r')
    scheme = SpareScheme(r=r, binary_search=binary_search,
                         dynamic_ckpt=dynamic_ckpt,
                         straggler_frac=straggler_frac,
                         straggler_slowdown=straggler_slowdown)
    return run_scheme(scheme, p, seed=seed, t_c=t_c, max_wall=max_wall)
