"""Live failure injection for the trainer and the serving tier (a copy of
the JAX package's jax-free ``repro.train.injection``).

* :class:`ScenarioInjector` binds any registered
  :class:`repro_torch.scenarios.models.FailureModel` plus a
  :class:`repro_torch.scenarios.topology.ClusterTopology` to the live
  loop: model arrival times convert to the step clock (each poll
  advances it by ``seconds_per_step``), blast radii resolve to DP-group
  (or replica) victim batches through the topology, one
  :class:`StepEvent` per model event; an optional fail-slow model
  drives the slow channel on its own RNG. On a wipe-out the trainer
  calls :meth:`ScenarioInjector.notify_outage`: the clock advances past
  the restart and the arrival streams re-arm.
* :class:`ScriptedInjector` is a fixed ``{poll index: victims}`` script,
  with an optional scripted slow schedule.

An injector satisfies the plain protocol (``injector(state) ->
list[int]``) and ``poll(state) -> [StepEvent]``, which the trainer and
:class:`~repro_torch.serve.replicas.ReplicaServer` consume per event.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.state import SpareState
from repro_torch.des.params import DESParams
from repro_torch.scenarios.models import (bind_model, drain_event_window,
                                          drain_slow_window, model_from_spec)

__all__ = ["StepEvent", "ScenarioInjector", "ScriptedInjector"]


class StepEvent:
    """One failure event delivered at a poll.

    ``victims`` is the full simultaneous-kill set (replica or DP-group
    indices); ``time`` is the injector's clock in seconds; ``step`` is
    the injector's own monotone poll index.
    """

    __slots__ = ("step", "time", "victims")

    def __init__(self, step: int, time: float, victims: list[int]):
        self.step = step
        self.time = time
        self.victims = list(victims)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"StepEvent(step={self.step}, time={self.time:.1f}, "
                f"victims={self.victims})")


class _SlowChannel:
    """Shared fail-slow bookkeeping for both injector flavors.

    Per-group slowdown state lives in ``_slow: {group: (factor,
    until)}``. Because every gradient sync is a barrier, the effective
    step window is ``seconds_per_step * max(factor)`` over groups that
    are alive *and still in the sync* — demoting a straggler (masking
    it out of the weighted all-reduce) removes its factor from that max
    while its degradation keeps being tracked for re-admission.
    """

    def _init_slow(self) -> None:
        self._slow: dict[int, tuple[float, float]] = {}
        self._demoted: set[int] = set()
        self.slow_events_delivered = 0
        self.last_step_seconds = float(self.seconds_per_step)
        # one entry per poll: the effective window in seconds — the
        # benchmark's per-step throughput record
        self.window_log: list[float] = []

    # ---------------------------------------------------------- #
    def slow_factor(self, group: int) -> float:
        """Current modeled slowdown factor of ``group`` (1.0 = healthy)."""
        ent = self._slow.get(int(group))
        return ent[0] if ent is not None else 1.0

    def group_step_seconds(self) -> np.ndarray:
        """Per-group modeled step seconds — what each group's local
        compute+comm would take this step. The detector's input."""
        out = np.full(self.n, float(self.seconds_per_step))
        for g, (factor, _) in self._slow.items():
            out[g] *= factor
        return out

    @property
    def demoted(self) -> frozenset[int]:
        return frozenset(self._demoted)

    def notify_demoted(self, groups, flag: bool = True) -> None:
        """Mark ``groups`` as masked out of (``flag=True``) or
        re-admitted to (``flag=False``) the synchronous step barrier."""
        if isinstance(groups, (int, np.integer)):
            groups = [groups]
        if flag:
            self._demoted.update(int(g) for g in groups)
        else:
            self._demoted.difference_update(int(g) for g in groups)

    # ---------------------------------------------------------- #
    def _apply_episode(self, groups, factor: float, until: float) -> None:
        for g in groups:
            g = int(g)
            old = self._slow.get(g)
            if old is not None:        # overlap: max factor, extend
                factor = max(factor, old[0])
                until = max(until, old[1])
            self._slow[g] = (float(factor), float(until))

    def _expire_slow(self, now: float) -> None:
        healed = [g for g, (_, until) in self._slow.items() if until <= now]
        for g in healed:
            del self._slow[g]

    def _window_factor(self, state: SpareState) -> float:
        factor = 1.0
        for g, (f, _) in self._slow.items():
            if state.alive[g] and g not in self._demoted:
                factor = max(factor, f)
        return factor

    def _clear_slow(self) -> None:
        self._slow.clear()
        self._demoted.clear()



class ScenarioInjector(_SlowChannel):
    """Step-time failure injection from a scenario model + topology.

    Parameters
    ----------
    model: failure-model spec — registry name, ``{"kind": ...}`` dict, or
        a :class:`FailureModel` instance (see :func:`model_from_spec`).
    topology: cluster layout — preset name, dict, instance, or ``None``
        for the default small layout at ``n_groups``.
    n_groups: the trainer's data-parallel degree N (must match the
        trainer this injector drives).
    seconds_per_step: wall seconds one trainer step represents on the
        model's clock; defaults to ``params.t_comp + params.t_allreduce``
        (the DES per-step cost, so DES-calibrated MTBFs carry over).
    params: :class:`DESParams` the model binds against (MTBF, Weibull
        shape, restart latency...); ``n`` is forced to ``n_groups``.
    seed: RNG seed for arrival draws and victim choices.
    slow_model: optional fail-slow stream spec (a
        :class:`repro_torch.scenarios.models.SlowdownModel`) driven on its own
        RNG (``seed + 1`` unless ``slow_seed`` given) so adding a slow
        channel never perturbs the kill stream's pinned draw order.
    slow_seed: RNG seed for the slow channel (default ``seed + 1``).
    """

    def __init__(self, model, topology=None, *, n_groups: int,
                 seconds_per_step: float | None = None,
                 params: DESParams | None = None, seed: int = 0,
                 slow_model=None, slow_seed: int | None = None):
        self.n = n_groups
        self.rng = np.random.default_rng(seed)
        self.model, self.p, self.topology = bind_model(
            model, n_groups, self.rng, topology=topology, params=params)
        self.seconds_per_step = (seconds_per_step
                                 if seconds_per_step is not None
                                 else self.p.t_comp + self.p.t_allreduce)
        if self.seconds_per_step <= 0:
            raise ValueError("seconds_per_step must be positive")
        self.clock = 0.0                 # model-time seconds elapsed
        self.step = 0                    # step windows polled
        self._next_fail = self.model.next_arrival(0.0, self.n, self.n)
        self.events_delivered = 0
        self.victims_delivered = 0
        self.outage_seconds = 0.0        # cumulative downtime accounted
        self._init_slow()
        self.slow_model = None
        self._next_slow = float("inf")
        if slow_model is not None:
            self.slow_model = model_from_spec(slow_model)
            if not getattr(self.slow_model, "degrades", False):
                raise TypeError("slow_model must be a SlowdownModel "
                                "(fail-stop specs go in `model`)")
            self.slow_rng = np.random.default_rng(
                slow_seed if slow_seed is not None else seed + 1)
            self.slow_model.bind(self.p, self.slow_rng, self.topology)
            self._next_slow = self.slow_model.next_arrival(0.0, self.n,
                                                           self.n)
        # SpareTrainer.run auto-attaches its Telemetry here (if any) so
        # injection counters land in the same metrics snapshot
        self.telemetry = None

    # ------------------------------------------------------------- #
    def poll(self, state: SpareState) -> list[StepEvent]:
        """Advance one step on the model clock; return the failure
        events whose arrival landed inside the step window, one
        :class:`StepEvent` per model event (victims already resolved to
        live DP groups through the topology)."""
        dead = set(int(w) for w in np.flatnonzero(~state.alive))
        alive = int(state.alive.sum())
        # fail-slow channel: heal expired episodes at the window
        # boundary, then stretch this step's window by the worst factor
        # among groups still in the sync barrier (episodes arriving
        # inside the window take effect from the *next* step)
        self._expire_slow(self.clock)
        window = self.seconds_per_step * self._window_factor(state)
        self.last_step_seconds = window
        self.window_log.append(window)
        end = self.clock + window
        if self.slow_model is not None:
            episodes, self._next_slow = drain_slow_window(
                self.slow_model, self._next_slow, end, set(self._slow))
            for _, groups, factor, until in episodes:
                self._apply_episode(groups, factor, until)
            self.slow_events_delivered += len(episodes)
            if self.telemetry is not None and episodes:
                self.telemetry.counter("inject.slow_events").inc(
                    len(episodes))
        events, self._next_fail, _ = drain_event_window(
            self.model, self._next_fail, end, dead, alive, self.n)
        self.clock = end
        out = [StepEvent(self.step, t, victims) for t, victims in events]
        self.step += 1
        self.events_delivered += len(out)
        self.victims_delivered += sum(len(e.victims) for e in out)
        if self.telemetry is not None and out:
            self.telemetry.counter("inject.events").inc(len(out))
            self.telemetry.counter("inject.victims").inc(
                sum(len(e.victims) for e in out))
        return out

    def __call__(self, state: SpareState) -> list[int]:
        """Plain-injector protocol: the flattened victim set of every
        event in this step's window (one merged batch)."""
        return [w for ev in self.poll(state) for w in ev.victims]

    # ------------------------------------------------------------- #
    def notify_outage(self, seconds: float | None = None,
                      kind: str = "restart") -> None:
        """Account ``seconds`` of downtime on the model clock.

        ``kind="restart"`` (the wipe-out path) additionally re-arms the
        arrival stream at full capacity — trace replay drops events that
        hit the downed system, renewal models re-draw. Other kinds
        (``"reshape"``) only advance the clock: the arrival process keeps
        running because the surviving hardware stays powered through the
        reconfiguration."""
        if seconds is None:
            seconds = self.p.t_restart
        self.clock += float(seconds)
        self.outage_seconds += float(seconds)
        if kind == "restart":
            self._next_fail = self.model.reset(self.clock, self.n, self.n)
            # a global restart swaps/repairs degraded hardware and
            # rebuilds the full schedule: clear slow + demotion state
            # and re-arm the slow stream past the outage
            self._clear_slow()
            if self.slow_model is not None:
                self._next_slow = self.slow_model.reset(
                    self.clock, self.n, self.n)

    def notify_wipeout(self) -> None:
        """Legacy alias for ``notify_outage(kind="restart")``."""
        self.notify_outage(self.p.t_restart, kind="restart")


class ScriptedInjector(_SlowChannel):
    """Deterministic injector: a fixed ``{poll index: victims}`` script.

    Used by the elastic campaign arms and CI smoke runs, where the
    benchmark needs the *same* beyond-recoverable burst at the same step
    in every arm. Satisfies both injector protocols (``poll`` and plain
    call) and the ``notify_outage`` accounting interface.

    ``slow_schedule`` scripts the fail-slow channel deterministically:
    ``{poll_idx: [(group, factor, until_poll_idx), ...]}`` — each entry
    degrades ``group`` by ``factor`` for poll windows
    ``[poll_idx, until_poll_idx)`` (``until_poll_idx=None`` for a
    persistent episode). Requires ``n_groups`` so
    :meth:`group_step_seconds` knows its width.
    """

    def __init__(self, schedule: dict[int, list[int]], *,
                 seconds_per_step: float = 1.0,
                 slow_schedule: dict | None = None,
                 n_groups: int | None = None):
        self.schedule = {int(k): list(v) for k, v in schedule.items()}
        self.seconds_per_step = float(seconds_per_step)
        self.n = n_groups
        self.clock = 0.0
        self.step = 0
        self.outage_seconds = 0.0
        self.events_delivered = 0
        self.victims_delivered = 0
        self.telemetry = None
        self._init_slow()
        self.slow_schedule = {
            int(k): [(int(g), float(f),
                      float("inf") if until is None else float(until))
                     for g, f, until in v]
            for k, v in (slow_schedule or {}).items()}
        if self.slow_schedule and self.n is None:
            raise ValueError("slow_schedule needs n_groups")

    def group_step_seconds(self) -> np.ndarray:
        if self.n is None:
            raise ValueError("ScriptedInjector needs n_groups for "
                             "group_step_seconds()")
        return super().group_step_seconds()

    def poll(self, state: SpareState) -> list[StepEvent]:
        # scripted slow episodes: entries at this poll index take
        # effect for this window; `until` is a poll index, so the
        # slow-state clock here is the step counter, not seconds
        for g, factor, until in self.slow_schedule.get(self.step, []):
            self._apply_episode([g], factor, until)
        self._expire_slow(float(self.step))
        window = self.seconds_per_step * self._window_factor(state)
        self.last_step_seconds = window
        self.window_log.append(window)
        victims = self.schedule.get(self.step, [])
        self.clock += window
        out = ([StepEvent(self.step, self.clock, victims)]
               if victims else [])
        self.step += 1
        self.events_delivered += len(out)
        self.victims_delivered += sum(len(e.victims) for e in out)
        return out

    def __call__(self, state: SpareState) -> list[int]:
        return [w for ev in self.poll(state) for w in ev.victims]

    def notify_outage(self, seconds: float | None = None,
                      kind: str = "restart") -> None:
        if seconds is None:
            seconds = 0.0
        self.clock += float(seconds)
        self.outage_seconds += float(seconds)
        if kind == "restart":
            self._clear_slow()

    def notify_wipeout(self) -> None:
        self.notify_outage(0.0, kind="restart")
