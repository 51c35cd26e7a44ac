"""Pluggable failure models: composable streams over a cluster topology.

The legacy DES injects failures from one renewal stream
(:class:`repro.des.failures.FailureProcess`) and picks victims uniformly
among survivors. Production failure logs disagree on all three axes the
paper's claims are sensitive to (Sec. 5, App. C/E): failures are
*spatially correlated* (rack/pod co-failures), *bursty*, and
*time-varying* (diurnal load, maintenance windows). This module
generalizes injection into a :class:`FailureModel` protocol the engine
(:class:`repro.des.engine.SimClock`) and the Monte-Carlo driver
(:func:`repro.core.montecarlo.run_montecarlo`) both consume:

``bind(p, rng, topology)``
    attach the run's parameters, RNG, and cluster topology (once per
    simulation — must fully reset model state so instances are reusable).
``next_arrival(now, alive, n)``
    absolute time of the next failure *event* (which may kill several
    groups at once).
``draw_victims(now, dead)``
    the groups killed by the event at ``now`` (already-dead groups are
    filtered by the caller as well, for safety).
``reset(now, alive, n)``
    re-arm after a global restart; returns the next arrival time.

Registered models (``get_failure_model`` / campaign ``kind`` keys):

* ``weibull`` / ``poisson`` — single-victim renewal baselines,
  bit-for-bit compatible with the legacy ``FailureProcess`` at fixed
  seeds (same RNG-draw order: one interval draw per event, one uniform
  victim choice).
* ``correlated`` — renewal arrivals whose events escalate, with
  configurable probability, from a single group to the victim's whole
  rack / pod / DCI domain (blast-radius kills).
* ``diurnal`` — wraps any base model, modulating its rate by a sinusoid
  (period/amplitude/peak) plus an optional daily maintenance window.
* ``trace`` — JSONL trace replay through the topology; three synthetic
  traces shaped like published cluster logs ship in ``traces/``.
* ``superposed`` — superposition of independent component streams
  (e.g. quiet Poisson background + rare pod kills).
* ``fail_slow`` / ``flaky_link`` — *gray-failure* streams
  (:class:`SlowdownModel`): arrivals open slowdown episodes that
  inflate victims' per-step time instead of killing them — persistent
  (degraded NIC / thermal throttle) or self-healing (flaky links) —
  consumed by the injector's slow channel and the
  :mod:`repro.health` straggler detector.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from ..des.failures import FailureProcess
from .topology import ClusterTopology, topology_from_spec

__all__ = [
    "FailureModel", "RenewalModel", "PoissonModel", "CorrelatedModel",
    "RackBurstModel", "DiurnalModel", "TraceReplayModel", "SuperposedModel",
    "SlowdownModel", "FailSlowModel", "FlakyLinkModel",
    "register_failure_model", "get_failure_model", "list_failure_models",
    "model_from_spec", "bundled_traces", "load_trace", "sample_kill_batches",
    "bind_model", "drain_event_window", "drain_slow_window", "to_step_events",
]

TRACES_DIR = Path(__file__).parent / "traces"


# ------------------------------------------------------------------ #
# protocol + registry                                                #
# ------------------------------------------------------------------ #
class FailureModel:
    """Base class for pluggable failure streams (see module docstring)."""

    #: registry key / campaign spec ``kind``
    name: str = "base"

    def bind(self, p, rng: np.random.Generator,
             topology: ClusterTopology | None = None) -> None:
        """Attach run state; must fully reset internal state."""
        self.p = p
        self.rng = rng
        self.n = p.n
        self.topology = topology

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        raise NotImplementedError

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        raise NotImplementedError

    def reset(self, now: float, alive: int, n: int) -> float:
        """Re-arm after a global restart (full capacity restored)."""
        return self.next_arrival(now, alive, n)

    # ---------------------------------------------------------- #
    def _uniform_victim(self, dead: set[int]) -> int | None:
        candidates = [w for w in range(self.n) if w not in dead]
        if not candidates:
            return None
        return int(self.rng.choice(candidates))


_MODEL_REGISTRY: dict[str, type[FailureModel]] = {}


def register_failure_model(cls: type[FailureModel]):
    """Class decorator: register ``cls`` under ``cls.name``."""
    if not cls.name or cls.name == "base":
        raise ValueError(f"{cls.__name__} must set a unique `name`")
    _MODEL_REGISTRY[cls.name] = cls
    return cls


def get_failure_model(name: str, **kwargs) -> FailureModel:
    """Instantiate a registered model: ``get_failure_model("correlated",
    scope="rack", burst_prob=0.2)``."""
    try:
        cls = _MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown failure model {name!r}; "
                       f"registered: {list_failure_models()}") from None
    return cls(**kwargs)


def list_failure_models() -> list[str]:
    return sorted(_MODEL_REGISTRY)


def model_from_spec(spec) -> FailureModel:
    """Build a model from a kind string, ``{"kind": ..., **kwargs}``
    dict (the picklable campaign-cell form), or an existing instance."""
    if isinstance(spec, FailureModel):
        return spec
    if spec is None:
        return RenewalModel()
    if isinstance(spec, str):
        return get_failure_model(spec)
    if isinstance(spec, dict):
        kw = dict(spec)
        kw.pop("label", None)          # campaign display name, not a kwarg
        kind = kw.pop("kind")
        return get_failure_model(kind, **kw)
    raise TypeError(f"cannot build a failure model from {spec!r}")


# ------------------------------------------------------------------ #
# renewal baselines (legacy-parity)                                  #
# ------------------------------------------------------------------ #
@register_failure_model
class RenewalModel(FailureModel):
    """Single-victim renewal stream — the legacy behavior, verbatim.

    With no overrides this draws *exactly* the sequence the pre-scenario
    :class:`SimClock` drew (one Weibull/exponential interval per event
    via ``FailureProcess``, then one uniform ``rng.choice`` victim), so
    the scheme-parity tests against :mod:`repro.des._legacy` stay
    bit-for-bit. Constructor kwargs override the corresponding
    :class:`repro.des.params.DESParams` fields.
    """

    name = "weibull"
    _law: str | None = None

    def __init__(self, mtbf: float | None = None, shape: float | None = None,
                 law: str | None = None,
                 scale_with_survivors: bool | None = None):
        self.mtbf = mtbf
        self.shape = shape
        self.law = law if law is not None else self._law
        self.scale_with_survivors = scale_with_survivors

    def bind(self, p, rng, topology=None) -> None:
        super().bind(p, rng, topology)
        self.proc = FailureProcess(
            self.mtbf if self.mtbf is not None else p.mtbf,
            self.shape if self.shape is not None else p.weibull_shape,
            rng,
            law=self.law if self.law is not None else p.failure_law,
            scale_with_survivors=(
                p.scale_rate_with_survivors
                if self.scale_with_survivors is None
                else self.scale_with_survivors),
        )

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        return self.proc.next_arrival(now, alive, n)

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        v = self._uniform_victim(dead)
        return [] if v is None else [v]


@register_failure_model
class PoissonModel(RenewalModel):
    """Memoryless renewal baseline (exponential inter-arrivals)."""

    name = "poisson"
    _law = "exponential"


# ------------------------------------------------------------------ #
# spatially-correlated burst kills                                   #
# ------------------------------------------------------------------ #
@register_failure_model
class CorrelatedModel(RenewalModel):
    """Rack/pod/DCI burst kills over renewal arrivals.

    Each arrival draws a uniform seed victim, then escalates: with
    probability ``scope_probs[scope]`` (evaluated largest scope first)
    the event kills every *alive* group in the seed's blast radius at
    that scope. ``burst_prob``/``scope`` is shorthand for a single-entry
    ``scope_probs``. Models the rack- and pod-level co-failures that
    dominate downtime in production logs (Kokolis et al. 2025).
    """

    name = "correlated"

    def __init__(self, scope: str = "rack", burst_prob: float = 0.15,
                 scope_probs: dict[str, float] | None = None, **renewal_kw):
        super().__init__(**renewal_kw)
        self.scope_probs = dict(scope_probs) if scope_probs else \
            {scope: burst_prob}
        if sum(self.scope_probs.values()) > 1.0:
            raise ValueError("scope escalation probabilities exceed 1")

    def bind(self, p, rng, topology=None) -> None:
        super().bind(p, rng, topology)
        self.topo = topology_from_spec(topology, n_groups=p.n)

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        v = self._uniform_victim(dead)
        if v is None:
            return []
        u = float(self.rng.random())
        acc = 0.0
        # largest blast radius first, so "pod" wins over "rack" draws
        for scope in ("dci", "pod", "rack"):
            prob = self.scope_probs.get(scope, 0.0)
            if prob <= 0.0:
                continue
            acc += prob
            if u < acc:
                blast = self.topo.blast_radius(v, scope)
                return [w for w in blast if w not in dead]
        return [v]


@register_failure_model
class RackBurstModel(CorrelatedModel):
    """Every arrival is a full-rack kill — the Kokolis-style rackstorm
    regime as a one-word preset (``--failure-model rack_burst``): a
    uniform seed victim always escalates to its whole rack's alive
    groups. Equivalent to ``{"kind": "correlated", "scope": "rack",
    "burst_prob": 1.0}``; renewal kwargs (``mtbf``, ``shape``...) pass
    through."""

    name = "rack_burst"

    def __init__(self, **renewal_kw):
        super().__init__(scope="rack", burst_prob=1.0, **renewal_kw)


# ------------------------------------------------------------------ #
# diurnal / maintenance-window rate modulation                       #
# ------------------------------------------------------------------ #
@register_failure_model
class DiurnalModel(FailureModel):
    """Time-varying hazard: wraps a base model and rescales its
    inter-arrival intervals by ``1 / rate_factor(now)``.

    ``rate_factor`` is a sinusoid of the wall clock — period one day by
    default, ``amplitude`` in [0, 1), peaking at fraction ``peak`` of
    the period — optionally multiplied by ``maintenance_factor`` inside
    a daily ``[maintenance_start, maintenance_start + maintenance_len)``
    window (elevated failure discovery during maintenance, as cluster
    logs show). The factor is evaluated at the interval's start — the
    standard piecewise-constant thinning approximation, exact as the
    interval shrinks relative to the period.
    """

    name = "diurnal"

    def __init__(self, base=None, period: float = 86_400.0,
                 amplitude: float = 0.5, peak: float = 0.5,
                 maintenance_start: float | None = None,
                 maintenance_len: float = 7_200.0,
                 maintenance_factor: float = 4.0):
        if not 0.0 <= amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")
        self.base = base
        self.period = period
        self.amplitude = amplitude
        self.peak = peak
        self.maintenance_start = maintenance_start
        self.maintenance_len = maintenance_len
        self.maintenance_factor = maintenance_factor

    def bind(self, p, rng, topology=None) -> None:
        super().bind(p, rng, topology)
        self.inner = model_from_spec(self.base)
        self.inner.bind(p, rng, topology)

    def rate_factor(self, t: float) -> float:
        phase = (t / self.period) - self.peak
        f = 1.0 + self.amplitude * math.cos(2.0 * math.pi * phase)
        if self.maintenance_start is not None:
            tod = t % self.period
            if (self.maintenance_start <= tod
                    < self.maintenance_start + self.maintenance_len):
                f *= self.maintenance_factor
        return max(f, 1e-9)

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        interval = self.inner.next_arrival(now, alive, n) - now
        return now + interval / self.rate_factor(now)

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        return self.inner.draw_victims(now, dead)

    def reset(self, now: float, alive: int, n: int) -> float:
        interval = self.inner.reset(now, alive, n) - now
        return now + interval / self.rate_factor(now)


# ------------------------------------------------------------------ #
# trace replay                                                       #
# ------------------------------------------------------------------ #
def bundled_traces() -> list[str]:
    """Names of the synthetic traces shipped with the package."""
    return sorted(f.stem for f in TRACES_DIR.glob("*.jsonl"))


def load_trace(name_or_path: str | Path) -> list[dict]:
    """Load a JSONL trace — one event per line:
    ``{"t": <seconds>, "scope": "host"|"rack"|"pod"|"dci"|"group",
    "loc": <int>}`` (extra keys ignored). Bundled traces resolve by
    bare name (see :func:`bundled_traces`)."""
    path = Path(name_or_path)
    if not path.exists():
        candidate = TRACES_DIR / f"{name_or_path}.jsonl"
        if not candidate.exists():
            raise FileNotFoundError(
                f"no trace file {name_or_path!r}; bundled: {bundled_traces()}")
        path = candidate
    events = []
    with path.open() as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ev = json.loads(line)
            events.append({"t": float(ev["t"]), "scope": ev["scope"],
                           "loc": int(ev["loc"])})
    if not events:
        raise ValueError(f"trace {path} has no events")
    events.sort(key=lambda e: e["t"])
    return events


@register_failure_model
class TraceReplayModel(FailureModel):
    """Replay a recorded failure log through the topology.

    ``trace`` is a bundled-trace name, a path, or an in-memory event
    list. Event times stretch by ``time_scale``; with ``loop=True``
    (default) the trace wraps around with a cumulative offset once
    exhausted, so any training horizon is covered. Events that fall
    inside a global-restart outage are skipped — those failures hit a
    system that was already down.
    """

    name = "trace"

    def __init__(self, trace="meta_hsdp_rackstorm", loop: bool = True,
                 time_scale: float = 1.0):
        self.trace = trace
        self.loop = loop
        self.time_scale = time_scale

    def bind(self, p, rng, topology=None) -> None:
        super().bind(p, rng, topology)
        self.topo = topology_from_spec(topology, n_groups=p.n)
        events = (self.trace if isinstance(self.trace, list)
                  else load_trace(self.trace))
        self._events = events
        self._times = [e["t"] * self.time_scale for e in events]
        # wrap period: trace span plus one mean gap, so the loop seam
        # does not create a double event
        span = self._times[-1] - self._times[0]
        gap = span / max(len(events) - 1, 1)
        self._period = self._times[-1] + max(gap, 1e-9)
        self._i = 0
        self._offset = 0.0

    def _event_time(self, i: int) -> float:
        return self._times[i] + self._offset

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        while True:
            if self._i >= len(self._events):
                if not self.loop:
                    return math.inf
                self._i = 0
                self._offset += self._period
            t = self._event_time(self._i)
            if t < now:            # event landed during an outage: skip
                self._i += 1
                continue
            return t

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        ev = self._events[self._i]
        self._i += 1
        return [w for w in self.topo.resolve(ev["scope"], ev["loc"])
                if w not in dead]


# ------------------------------------------------------------------ #
# superposition                                                      #
# ------------------------------------------------------------------ #
@register_failure_model
class SuperposedModel(FailureModel):
    """Superposition of independent component streams: the next event is
    the earliest component arrival; only the fired component re-draws.

    ``components`` is a list of model specs, e.g. a quiet Poisson
    background plus rare correlated pod kills::

        {"kind": "superposed", "components": [
            {"kind": "poisson", "mtbf": 2000.0},
            {"kind": "correlated", "scope": "pod", "burst_prob": 1.0,
             "mtbf": 50000.0}]}
    """

    name = "superposed"

    def __init__(self, components: list):
        if not components:
            raise ValueError("superposed model needs >= 1 component")
        self.components = components

    def bind(self, p, rng, topology=None) -> None:
        super().bind(p, rng, topology)
        self.models = [model_from_spec(s) for s in self.components]
        for m in self.models:
            m.bind(p, rng, topology)
        self._next: list[float] | None = None
        self._fired = 0

    def _arm(self, now: float, alive: int, n: int) -> float:
        self._next = [m.next_arrival(now, alive, n) for m in self.models]
        return self._pick()

    def _pick(self) -> float:
        assert self._next is not None
        k = min(range(len(self._next)), key=self._next.__getitem__)
        self._fired = k
        return self._next[k]

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        if self._next is None:
            return self._arm(now, alive, n)
        self._next[self._fired] = \
            self.models[self._fired].next_arrival(now, alive, n)
        return self._pick()

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        return self.models[self._fired].draw_victims(now, dead)

    def reset(self, now: float, alive: int, n: int) -> float:
        for m in self.models:
            m.reset(now, alive, n)
        return self._arm(now, alive, n)


# ------------------------------------------------------------------ #
# fail-slow (gray-failure) streams                                   #
# ------------------------------------------------------------------ #
class SlowdownModel(FailureModel):
    """Base class for *fail-slow* streams: degraded NICs, thermal
    throttling, flaky links. Unlike fail-stop models these never kill a
    group — each arrival opens a slowdown *episode* that inflates the
    victims' per-step time by a multiplicative ``factor`` until the
    episode's ``until`` time (``math.inf`` for persistent degradation
    that only a repair/restart clears). Because every collective is
    synchronous, one slowed group drags the whole step down to its
    pace — which is exactly what SPARe demotion (a weight-table edit)
    buys back.

    Same registry / ``bind`` contract as :class:`FailureModel`; the
    extra hook is :meth:`draw_episode`. Arrivals are exponential with
    mean ``mtbs`` (mean time between slowdowns) — slow events track
    component count, not survivor count, so no survivor scaling.
    """

    #: marks the model as a slowdown (not kill) stream for the injector
    degrades = True
    name = "slow-base"

    #: mean seconds between slowdown episodes
    mtbs: float = 3600.0

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        return now + float(self.rng.exponential(self.mtbs))

    def draw_victims(self, now: float, dead: set[int]) -> list[int]:
        return []                      # slow streams never kill

    def draw_episode(self, now: float, slowed: set[int],
                     ) -> tuple[list[int], float, float]:
        """Return ``(groups, factor, until)`` for the episode at ``now``.
        ``until`` is the absolute end time (``math.inf`` = persistent)."""
        raise NotImplementedError

    # ---------------------------------------------------------- #
    def _seed_victim(self, slowed: set[int]) -> int:
        # prefer groups not already degraded so episodes spread out;
        # one rng.choice either way keeps the draw order fixed
        fresh = [w for w in range(self.n) if w not in slowed]
        return int(self.rng.choice(fresh if fresh else list(range(self.n))))

    def _draw_factor(self, lo: float, hi: float) -> float:
        # log-uniform in [lo, hi]; always one rng.random() draw so the
        # stream stays deterministic even when lo == hi
        u = float(self.rng.random())
        if hi <= lo:
            return float(lo)
        return float(math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo))))


@register_failure_model
class FailSlowModel(SlowdownModel):
    """Persistent per-group degradation (degraded NIC / thermal
    throttle): each arrival slows one group — or, with ``scope`` set,
    the seed's whole blast radius (a bad ToR switch slows its rack) —
    by a log-uniform factor in ``[factor_min, factor_max]``, forever
    (until an external repair: demotion + later restart, or the
    injector's outage reset).
    """

    name = "fail_slow"

    def __init__(self, mtbs: float = 3600.0, factor_min: float = 2.0,
                 factor_max: float = 4.0, scope: str | None = None):
        if factor_min < 1.0:
            raise ValueError("slowdown factors must be >= 1")
        self.mtbs = mtbs
        self.factor_min = factor_min
        self.factor_max = factor_max
        self.scope = scope

    def bind(self, p, rng, topology=None) -> None:
        super().bind(p, rng, topology)
        self.topo = topology_from_spec(topology, n_groups=p.n)

    def draw_episode(self, now, slowed):
        v = self._seed_victim(slowed)
        factor = self._draw_factor(self.factor_min, self.factor_max)
        groups = (list(self.topo.blast_radius(v, self.scope))
                  if self.scope else [v])
        return groups, factor, math.inf


@register_failure_model
class FlakyLinkModel(FailSlowModel):
    """Intermittent flaky-link episodes: like :class:`FailSlowModel`
    but each episode heals on its own after an exponential duration
    with mean ``episode_len`` seconds (link retraining, transient
    congestion). Draw order per event: victim, factor, duration.
    """

    name = "flaky_link"

    def __init__(self, mtbs: float = 1800.0, episode_len: float = 600.0,
                 factor_min: float = 1.5, factor_max: float = 3.0,
                 scope: str | None = None):
        super().__init__(mtbs=mtbs, factor_min=factor_min,
                         factor_max=factor_max, scope=scope)
        self.episode_len = episode_len

    def draw_episode(self, now, slowed):
        groups, factor, _ = super().draw_episode(now, slowed)
        duration = float(self.rng.exponential(self.episode_len))
        return groups, factor, now + duration


# ------------------------------------------------------------------ #
# event-stream adapters                                              #
# ------------------------------------------------------------------ #
def drain_event_window(model: FailureModel, next_fail: float, end: float,
                       dead: set[int], alive: int, n: int,
                       ) -> tuple[list[tuple[float, list[int]]], float, int]:
    """Harvest every failure event with arrival time ``<= end``.

    The one victim-batching loop shared by the DES clock
    (:meth:`repro.des.engine.SimClock.advance`) and the live trainer
    bridge (:class:`repro.train.injection.ScenarioInjector`): per event,
    one ``draw_victims`` call (already-dead victims filtered) followed by
    one ``next_arrival`` re-arm — exactly the RNG-draw order the legacy
    parity tests pin down.

    ``dead`` is mutated in place; returns ``(events, next_fail, alive)``
    where ``events`` is one ``(arrival_time, victims)`` entry per event
    that killed at least one live group.
    """
    events: list[tuple[float, list[int]]] = []
    while next_fail <= end and alive > 0:
        victims: list[int] = []
        for v in model.draw_victims(next_fail, dead):
            if v in dead:
                continue
            dead.add(v)
            alive -= 1
            victims.append(v)
        if victims:
            events.append((next_fail, victims))
        next_fail = model.next_arrival(next_fail, max(alive, 1), n)
    return events, next_fail, alive


def drain_slow_window(model: SlowdownModel, next_slow: float, end: float,
                      slowed: set[int],
                      ) -> tuple[list[tuple[float, list[int], float, float]],
                                 float]:
    """Harvest every slowdown episode with arrival time ``<= end`` —
    the fail-slow counterpart of :func:`drain_event_window`, with the
    same pinned RNG discipline: per event one ``draw_episode`` call
    followed by one ``next_arrival`` re-arm.

    ``slowed`` (the groups currently degraded, mutated in place) only
    biases victim selection; overlap resolution — max factor wins,
    episodes extend — is the caller's (the injector keeps per-group
    ``(factor, until)`` state and expires entries itself).

    Returns ``(episodes, next_slow)`` where each episode is
    ``(arrival_time, groups, factor, until)``.
    """
    episodes: list[tuple[float, list[int], float, float]] = []
    while next_slow <= end:
        groups, factor, until = model.draw_episode(next_slow, slowed)
        if groups:
            episodes.append((next_slow, list(groups), factor, until))
            slowed.update(groups)
        next_slow = model.next_arrival(next_slow, model.n, model.n)
    return episodes, next_slow


def bind_model(model, n: int, rng: np.random.Generator,
               topology=None, params=None):
    """Coerce specs and bind a model for an ``n``-group system: returns
    ``(model, params, topology)`` with ``params.n`` forced to ``n`` and
    the topology validated against it (a mismatched layout would resolve
    blast radii to group ids outside ``[0, n)``). The one entry point
    shared by :func:`to_step_events` and the live trainer bridge."""
    from ..des.params import DESParams

    model = model_from_spec(model)
    p = params if params is not None else DESParams(n=n)
    if p.n != n:
        p = p.with_(n=n)
    topology = topology_from_spec(topology, n_groups=n)
    if topology.n_groups != n:
        raise ValueError(f"topology has n_groups={topology.n_groups} "
                         f"but the event stream targets n_groups={n}")
    model.bind(p, rng, topology)
    return model, p, topology


def to_step_events(model, n: int, *, seconds_per_step: float,
                   max_steps: int, rng: np.random.Generator,
                   topology: ClusterTopology | None = None,
                   params=None) -> list[tuple[int, list[int]]]:
    """Open-loop step-clock view of a failure model: bind it and map its
    arrival stream onto the trainer's step counter, resolving blast radii
    to DP-group victim batches.

    Returns ``[(step_index, victims), ...]`` for every event landing in
    ``[0, max_steps * seconds_per_step)``, where ``step_index ==
    floor(arrival / seconds_per_step)`` — the step whose all-reduce
    detects the failure. Groups stay dead for the rest of the horizon
    (no restarts), so this is the planning/analysis view; the *closed*
    loop — where wipe-outs restore capacity and re-arm the model — is
    :class:`repro.train.injection.ScenarioInjector`.
    """
    if seconds_per_step <= 0:
        raise ValueError("seconds_per_step must be positive")
    model, _, _ = bind_model(model, n, rng, topology=topology,
                             params=params)
    dead: set[int] = set()
    horizon = max_steps * seconds_per_step
    first = model.next_arrival(0.0, n, n)
    events, _, _ = drain_event_window(model, first, horizon, dead, n, n)
    return [(int(t // seconds_per_step), victims)
            for t, victims in events if t < horizon]


# ------------------------------------------------------------------ #
# Monte-Carlo bridge                                                 #
# ------------------------------------------------------------------ #
def sample_kill_batches(model, n: int, rng: np.random.Generator,
                        topology: ClusterTopology | None = None,
                        max_events: int | None = None) -> list[list[int]]:
    """Time-free victim sampling for the Monte-Carlo driver: bind the
    model and drain its event stream into an ordered list of kill
    batches (one list per simultaneous-failure event) until every group
    has failed. If the stream dries up first (finite non-looping
    trace), the remaining groups fail one-by-one in uniform random
    order so every trial reaches wipe-out.
    """
    from ..des.params import DESParams

    model = model_from_spec(model)
    model.bind(DESParams(n=n), rng, topology)
    max_events = max_events if max_events is not None else 50 * n
    dead: set[int] = set()
    batches: list[list[int]] = []
    t = model.next_arrival(0.0, n, n)
    events = 0
    # bound *iterations*, not non-empty batches: a looping trace whose
    # locations never cover all n groups yields empty draws forever
    while len(dead) < n and t != math.inf and events < max_events:
        events += 1
        victims = [v for v in model.draw_victims(t, dead) if v not in dead]
        if victims:
            batches.append(victims)
            dead.update(victims)
        t = model.next_arrival(t, max(n - len(dead), 1), n)
    if len(dead) < n:
        for w in rng.permutation(n):
            w = int(w)
            if w not in dead:
                batches.append([w])
                dead.add(w)
    return batches
