"""Online straggler detection over per-group step timings (a copy of the
JAX package's jax-free ``repro.health.detector``).

The detector consumes one observation per training step: a vector of
per-DP-group step seconds — what each group's local compute + comm
took (or, on the emulated mesh, the injector's modeled
``group_step_seconds()``; on real hardware, the per-group sync-wait
timings the telemetry tracks already capture). It must be

* **robust** — one straggler must not poison the baseline it is
  compared against, so the center/scale statistics are median + MAD,
  not mean + stddev;
* **stable** — gray failures are noisy, so raw timings are EWMA-
  smoothed and the flag decision uses hysteresis (a higher flag
  threshold than clear threshold) plus dwell counters: a group is only
  flagged after ``min_dwell`` consecutive anomalous steps and only
  cleared after ``clear_dwell`` consecutive healthy ones — no
  demote/re-admit flapping on transient noise;
* **deterministic** — pure numpy over the inputs, no wall clock, no
  randomness; identical timing streams produce identical flag
  sequences (the lint sweep's determinism rules apply here as to any
  hot-path module).

The robust z-score is the standard consistent estimate
``0.6745 * (x - median) / MAD`` with the MAD floored at
``mad_floor_frac * median`` so a perfectly uniform healthy fleet
(MAD = 0) cannot produce infinite scores from float dust.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["StragglerDetector", "HealthReport"]

#: Phi^-1(0.75): scales MAD to a stddev-consistent estimate
_MAD_CONSISTENCY = 0.6745


@dataclass(frozen=True)
class HealthReport:
    """One observation's verdict (all arrays length ``n_groups``)."""

    step: int
    #: EWMA-smoothed per-group step seconds
    smoothed: np.ndarray
    #: robust z-score vs the live-group median
    zscores: np.ndarray
    #: estimated slowdown factor: smoothed / median (1.0 = healthy)
    factors: np.ndarray
    #: groups currently flagged as stragglers (sorted)
    flagged: tuple[int, ...]
    #: groups whose flag rose this observation (sorted)
    newly_flagged: tuple[int, ...] = ()
    #: groups whose flag cleared this observation (sorted)
    newly_cleared: tuple[int, ...] = ()

    def factor(self, group: int) -> float:
        return float(self.factors[group])


class StragglerDetector:
    """Median+MAD straggler detector with EWMA smoothing, hysteresis,
    and dwell counters (see module docstring).

    Parameters
    ----------
    n_groups: DP-group count (observation vectors must match).
    ewma_alpha: smoothing weight of the newest sample in ``(0, 1]``.
    flag_z / clear_z: robust-z thresholds — a group must score above
        ``flag_z`` to accumulate flag dwell, and below ``clear_z`` to
        accumulate clear dwell (``flag_z > clear_z`` is the hysteresis
        band where state holds).
    flag_factor / clear_factor: slowdown-factor thresholds combined
        (AND) with the z thresholds, so a tightly-packed fleet's tiny
        MAD cannot flag a materially-healthy group.
    min_dwell / clear_dwell: consecutive observations required to
        raise / clear a flag.
    warmup: observations before any group may be flagged (the EWMA
        needs a few samples to mean anything).
    mad_floor_frac: MAD floor as a fraction of the median.
    """

    def __init__(self, n_groups: int, *, ewma_alpha: float = 0.4,
                 flag_z: float = 3.5, clear_z: float = 2.0,
                 flag_factor: float = 1.5, clear_factor: float = 1.2,
                 min_dwell: int = 3, clear_dwell: int = 3,
                 warmup: int = 2, mad_floor_frac: float = 0.02):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if clear_z > flag_z or clear_factor > flag_factor:
            raise ValueError("clear thresholds must not exceed flag "
                             "thresholds (hysteresis)")
        if min_dwell < 1 or clear_dwell < 1:
            raise ValueError("dwell counts must be >= 1")
        self.n = int(n_groups)
        self.ewma_alpha = float(ewma_alpha)
        self.flag_z = float(flag_z)
        self.clear_z = float(clear_z)
        self.flag_factor = float(flag_factor)
        self.clear_factor = float(clear_factor)
        self.min_dwell = int(min_dwell)
        self.clear_dwell = int(clear_dwell)
        self.warmup = int(warmup)
        self.mad_floor_frac = float(mad_floor_frac)
        self.reset()

    def reset(self) -> None:
        """Forget all history (e.g. after a global restart)."""
        self._smoothed: np.ndarray | None = None
        self._flag_dwell = np.zeros(self.n, dtype=np.int64)
        self._clear_dwell = np.zeros(self.n, dtype=np.int64)
        self._flagged = np.zeros(self.n, dtype=bool)
        self.observations = 0
        self.reports: list[HealthReport] = []

    # ------------------------------------------------------------- #
    @property
    def flagged(self) -> tuple[int, ...]:
        return tuple(int(g) for g in np.flatnonzero(self._flagged))

    def estimated_factor(self, group: int) -> float:
        """Latest slowdown-factor estimate for ``group`` (1.0 before
        any observation)."""
        if not self.reports:
            return 1.0
        return self.reports[-1].factor(group)

    # ------------------------------------------------------------- #
    def observe(self, group_seconds, *, alive=None,
                step: int | None = None) -> HealthReport:
        """Feed one step's per-group timings; return the verdict.

        ``alive`` masks dead groups out of the baseline statistics and
        from flagging (a dead group is fail-stop, not fail-slow). The
        baseline deliberately *includes* already-flagged stragglers —
        the median absorbs a minority of outliers, and excluding them
        would let the clear decision compare a healed group against a
        baseline it no longer belongs to.
        """
        x = np.asarray(group_seconds, dtype=np.float64)
        if x.shape != (self.n,):
            raise ValueError(f"expected {self.n} group timings, "
                             f"got shape {x.shape}")
        live = (np.ones(self.n, dtype=bool) if alive is None
                else np.asarray(alive, dtype=bool).copy())
        if step is None:
            step = self.observations

        if self._smoothed is None:
            self._smoothed = x.copy()
        else:
            a = self.ewma_alpha
            self._smoothed = a * x + (1.0 - a) * self._smoothed
        s = self._smoothed

        base = s[live] if live.any() else s
        med = float(np.median(base))
        mad = float(np.median(np.abs(base - med)))
        mad = max(mad, self.mad_floor_frac * max(med, 1e-12), 1e-12)
        z = _MAD_CONSISTENCY * (s - med) / mad
        factors = s / max(med, 1e-12)

        self.observations += 1
        warm = self.observations > self.warmup
        anomalous = live & (z >= self.flag_z) & (factors >= self.flag_factor)
        healthy = (z <= self.clear_z) & (factors <= self.clear_factor)

        self._flag_dwell = np.where(anomalous, self._flag_dwell + 1, 0)
        self._clear_dwell = np.where(healthy, self._clear_dwell + 1, 0)
        # dead groups drop their flag immediately: fail-stop recovery
        # owns them now
        self._clear_dwell[~live] = self.clear_dwell
        before = self._flagged.copy()
        rise = warm & (self._flag_dwell >= self.min_dwell)
        fall = self._clear_dwell >= self.clear_dwell
        self._flagged = (self._flagged | rise) & ~fall

        newly_flagged = tuple(
            int(g) for g in np.flatnonzero(self._flagged & ~before))
        newly_cleared = tuple(
            int(g) for g in np.flatnonzero(before & ~self._flagged))
        report = HealthReport(
            step=int(step), smoothed=s.copy(), zscores=z, factors=factors,
            flagged=self.flagged, newly_flagged=newly_flagged,
            newly_cleared=newly_cleared)
        self.reports.append(report)
        return report
