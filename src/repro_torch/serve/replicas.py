"""SPARe-masked serving replicas (the counterpart of
``repro.serve.replicas``).

A failure is **pure weight-table data**. A :class:`ReplicaServer`
tracks the liveness of R serving replicas in a ``SpareState(R, 1)``, and
routes requests by smooth weighted round-robin over the SPARe
supplier-style weight table ``alive / alive.sum()``. When a replica
dies:

* its weight drops to 0 and survivors absorb its share — a host-side
  array edit, **no rebuild**: all replicas share one
  :class:`~repro_torch.serve.engine.ExecutableCache`, whose ``misses``
  counter is frozen after warmup;
* its queued *and in-flight* requests requeue onto survivors from their
  prompts — the counter-based
  :class:`~repro_torch.data.pipeline.RequestStream` plus greedy decode
  make the re-run bit-identical, so zero requests are dropped while any
  replica survives;
* wipe-out (every replica dead — e.g. a rack that hosts all of them)
  reloads the parameters through
  :class:`~repro_torch.ckpt.CheckpointManager` when one is given
  (``restore_latest`` onto the parameters' device and dtype; the server
  saves them once at construction), rebuilds the engines, requeues
  everything and calls ``injector.notify_wipeout()`` to account the
  outage. Without a manager it rebuilds over the same parameters.

Failures arrive through an injector's ``poll(state) -> [StepEvent]``
(:class:`~repro_torch.train.injection.ScenarioInjector` or a
``ScriptedInjector``) with ``n_groups == n_replicas``: replica r is
group r of the cluster ``topology``, so rack and pod blast radii
resolve as they do for training. An optional straggler ``detector``
(:class:`repro_torch.health.StragglerDetector`) folds per-replica
timings into the routing weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.state import SpareState
from repro_torch.data.pipeline import ServeRequest
from repro_torch.models.model import Model
from repro_torch.obs.trace import maybe_span
from repro_torch.scenarios.topology import ClusterTopology

from .engine import ExecutableCache, FinishedRequest, ServeEngine

__all__ = ["ReplicaServer", "ReplicaEvent"]


@dataclass
class ReplicaEvent:
    """One liveness transition, for reports/tests."""

    step: int
    kind: str                              # "kill" | "wipeout" | "slow" | "healed"
    victims: list[int] = field(default_factory=list)
    requeued: int = 0


class ReplicaServer:
    """R serving replicas with SPARe weight-table failure masking."""

    def __init__(self, model: Model, params, *, n_replicas: int,
                 topology: ClusterTopology | None = None,
                 injector=None, ckpt=None, engine_kwargs: dict,
                 telemetry=None, detector=None):
        self.model = model
        self.params = params
        self.topology = topology
        self.injector = injector
        self.ckpt = ckpt
        self.telemetry = telemetry      # repro_torch.obs.Telemetry | None
        self.detector = detector
        if telemetry is not None and injector is not None \
                and hasattr(injector, "telemetry"):
            injector.telemetry = telemetry
        self.spare = SpareState(n_replicas, 1)
        self.exec_cache = ExecutableCache(
            None if telemetry is None else telemetry.metrics)
        self.engine_kwargs = dict(engine_kwargs)
        self.engines = [self._new_engine(r) for r in range(n_replicas)]
        # smooth weighted round-robin credits over the weight table
        self._credits = np.zeros(n_replicas, np.float64)
        self.step_idx = 0
        self.events: list[ReplicaEvent] = []
        self.dropped = 0                   # must stay 0 unless wiped out
        if ckpt is not None:
            # durable base image for the wipe-out path
            ckpt.maybe_save(0, params, block=True, force=True)

    def _new_engine(self, r: int) -> ServeEngine:
        return ServeEngine(self.model, self.params,
                           exec_cache=self.exec_cache,
                           telemetry=self.telemetry, track=f"replica/{r}",
                           **self.engine_kwargs)

    # ------------------------------------------------------------- #
    # weight table + routing                                         #
    # ------------------------------------------------------------- #
    @property
    def health_factors(self) -> np.ndarray:
        """Per-replica slowdown estimates from the detector (all 1.0
        without one)."""
        n = self.spare.n
        if self.detector is None or not self.detector.reports:
            return np.ones(n, np.float64)
        return np.maximum(self.detector.reports[-1].factors, 1.0)

    @property
    def weights(self) -> np.ndarray:
        """SPARe-style masking weights with detector health folded in:
        a dead replica's entry is zero; a live replica's share is
        proportional to its estimated throughput ``1 / factor``; a
        replica the detector has *flagged* is routed around entirely
        while any unflagged replica survives."""
        alive = self.spare.alive.astype(np.float64)
        w = alive / self.health_factors
        if self.detector is not None:
            flagged = list(self.detector.flagged)
            if flagged:
                spared = w.copy()
                spared[flagged] = 0.0
                if spared.any():
                    w = spared
        total = w.sum()
        return w / total if total else w

    @property
    def recompiles(self) -> int:
        return self.exec_cache.misses

    def warmup(self) -> None:
        for eng in self.engines:
            eng.warmup()

    def submit(self, req: ServeRequest) -> None:
        self._route(req)

    def _route(self, req: ServeRequest) -> None:
        w = self.weights
        if not w.any():
            # wiped out mid-recovery: park on replica 0's queue; the
            # wipe-out rebuild requeues it properly
            self.engines[0].submit(req)
            return
        self._credits += w
        # only weight-bearing replicas are eligible
        pick = int(np.argmax(np.where(self.spare.alive & (w > 0),
                                      self._credits, -np.inf)))
        self._credits[pick] -= 1.0
        self.engines[pick].submit(req)

    # ------------------------------------------------------------- #
    # failure handling                                               #
    # ------------------------------------------------------------- #
    def _kill(self, victims: list[int]) -> int:
        requeued = []
        for v in victims:
            if not self.spare.alive[v]:
                continue
            self.spare.alive[v] = False
            self._credits[v] = 0.0
            requeued += self.engines[v].drain_requests()
        for req in sorted(requeued, key=lambda r: r.req_id):
            self._route(req)
        return len(requeued)

    def _wipeout(self) -> int:
        """Every replica dead: reload params (with a checkpoint manager),
        rebuild engines, requeue everything."""
        pending: list[ServeRequest] = []
        for eng in self.engines:
            pending += eng.drain_requests()
        if self.injector is not None:
            self.injector.notify_wipeout()
        if self.ckpt is not None:
            _, self.params = self.ckpt.restore_latest(self.params)
        self.spare.reset()
        self._credits[:] = 0.0
        self.engines = [self._new_engine(r)
                        for r in range(len(self.engines))]
        # fresh pools over the restored params; step functions are
        # shape-keyed, so the shared cache still hits — a wipe-out
        # reload builds nothing either
        for req in sorted(pending, key=lambda r: r.req_id):
            self._route(req)
        return len(pending)

    # ------------------------------------------------------------- #
    # gray failures: detector-weighted routing                       #
    # ------------------------------------------------------------- #
    def _health_tick(self) -> None:
        """Feed the straggler detector one tick of per-replica timings
        from the injector's fail-slow model. Flag transitions surface as
        ``slow`` / ``healed`` events and reshape the routing weights."""
        if self.detector is None or self.injector is None:
            return
        timings_fn = getattr(self.injector, "group_step_seconds", None)
        if timings_fn is None:
            return
        t = np.asarray(timings_fn(), dtype=np.float64)
        if t.shape != self.spare.alive.shape:
            return
        hr = self.detector.observe(t, alive=self.spare.alive,
                                   step=self.step_idx)
        tel = self.telemetry
        for v in hr.newly_flagged:
            self.events.append(ReplicaEvent(step=self.step_idx,
                                            kind="slow", victims=[v]))
            if tel is not None:
                tel.instant("straggler", track=f"replica/{v}",
                            args={"step": self.step_idx})
        for v in hr.newly_cleared:
            self.events.append(ReplicaEvent(step=self.step_idx,
                                            kind="healed", victims=[v]))
            if tel is not None:
                tel.instant("healed", track=f"replica/{v}",
                            args={"step": self.step_idx})
        if tel is not None:
            tel.gauge("serve.slow_replicas").set(len(hr.flagged))

    # ------------------------------------------------------------- #
    # the loop                                                       #
    # ------------------------------------------------------------- #
    def step(self) -> list[FinishedRequest]:
        """One server tick: deliver failures, mask, drive live engines."""
        tel = self.telemetry
        self._health_tick()
        if self.injector is not None:
            for ev in self.injector.poll(self.spare):
                if tel is not None:
                    for v in ev.victims:
                        tel.instant("failure", track=f"replica/{v}",
                                    args={"step": self.step_idx})
                    tel.counter("serve.kills").inc(len(ev.victims))
                n = self._kill(ev.victims)
                if tel is not None and n:
                    tel.counter("serve.requeued").inc(n)
                self.events.append(ReplicaEvent(
                    step=self.step_idx, kind="kill",
                    victims=list(ev.victims), requeued=n))
            if not self.spare.alive.any():
                with maybe_span(tel, "recover",
                                args=(None if tel is None else
                                      {"step": self.step_idx,
                                       "wipeout": True})):
                    n = self._wipeout()
                if tel is not None:
                    tel.counter("serve.wipeouts").inc()
                    if n:
                        tel.counter("serve.requeued").inc(n)
                self.events.append(ReplicaEvent(
                    step=self.step_idx, kind="wipeout", requeued=n))

        done: list[FinishedRequest] = []
        for r in np.flatnonzero(self.spare.alive):
            done += self.engines[int(r)].step()
        self.step_idx += 1
        if tel is not None:
            tel.gauge("serve.replicas_alive").set(
                int(self.spare.alive.sum()))
            tel.gauge("serve.queue_depth").set(
                sum(e.pending for e in self.engines))
            tel.gauge("serve.kv_pages.free").set(
                sum(e.alloc.free_pages for e in self.engines))
        return done

    def run(self, max_steps: int = 10_000) -> list[FinishedRequest]:
        """Step until every submitted request completes."""
        out: list[FinishedRequest] = []
        for _ in range(max_steps):
            if not any(eng.pending or eng.in_flight
                       for eng in self.engines):
                break
            out += self.step()
        return out

    # ------------------------------------------------------------- #
    @property
    def pending(self) -> int:
        return sum(eng.pending + eng.in_flight for eng in self.engines)

    def report(self) -> dict:
        return {
            "replicas": len(self.engines),
            "alive": int(self.spare.alive.sum()),
            "weights": self.weights.tolist(),
            "steps": self.step_idx,
            "admitted": sum(e.admitted for e in self.engines),
            "completed": sum(e.completed for e in self.engines),
            "recompiles": self.recompiles,
            "executables": [list(k) for k in self.exec_cache.keys],
            "flagged_slow": ([] if self.detector is None
                             else list(self.detector.flagged)),
            "health_factors": self.health_factors.tolist(),
            "events": [(e.step, e.kind, e.victims, e.requeued)
                       for e in self.events],
        }
