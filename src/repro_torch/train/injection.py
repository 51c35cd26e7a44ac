"""Failure injection for the serving tier: scripted replica kills.

A copy of the parts of ``repro.train.injection`` the serving slice
needs: :class:`StepEvent`, the fail-slow bookkeeping
:class:`_SlowChannel`, and the deterministic :class:`ScriptedInjector`
(a fixed ``{poll index: victims}`` script). The scenario-driven
``ScenarioInjector`` waits until ``scenarios/`` and ``des/`` are ported.

An injector satisfies the plain protocol (``injector(state) ->
list[int]``) and ``poll(state) -> [StepEvent]``, which
:class:`~repro_torch.serve.replicas.ReplicaServer` consumes per event.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.state import SpareState

__all__ = ["StepEvent", "ScriptedInjector"]


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
