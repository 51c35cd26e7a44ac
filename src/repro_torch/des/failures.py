"""Failure injection for the DES (paper Sec. 5.1).

Node failures arrive as a renewal process whose inter-arrival law is
Weibull with the seminal Schroeder-Gibson shape ``k = 0.78`` (or
exponential, for apples-to-apples checks against the Sec. 4 theory, which
assumes memorylessness). The *system* rate is calibrated so the mean
inter-failure time equals the configured MTBF when all groups are active.

Two empirical effects from the paper are modeled:

* **Rate ∝ active GPUs** (Schroeder & Gibson 2009; Kokolis et al. 2025):
  as groups die and are not replaced until the next global restart, the
  aggregate failure rate drops proportionally — this is exactly why the
  paper observes SPARe beating its own theory at high r (Sec. 5.2.2).
* **k < 1 burstiness**: with ``k = 0.78`` failures cluster; the renewal
  intervals are drawn i.i.d. but their coefficient of variation > 1, which
  is what degrades low-r SPARe below the exponential-based prediction.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["FailureProcess"]


class FailureProcess:
    """Renewal failure stream with survivor-scaled rate.

    ``next_arrival(now, alive, n)`` returns the absolute time of the next
    node failure given the current clock and survivor count. The victim
    group is drawn uniformly among survivors by the caller (group-level
    abstraction: one node failure interrupts its whole model-parallel
    group).
    """

    def __init__(self, mtbf: float, shape: float, rng: np.random.Generator,
                 law: str = "weibull", scale_with_survivors: bool = True):
        if mtbf <= 0:
            raise ValueError("mtbf must be positive")
        self.mtbf = mtbf
        self.shape = shape
        self.rng = rng
        self.law = law
        self.scale_with_survivors = scale_with_survivors
        if law == "weibull":
            # numpy's weibull(k) has scale 1 => mean Gamma(1 + 1/k)
            self._norm = math.gamma(1.0 + 1.0 / shape)
        elif law == "exponential":
            self._norm = 1.0
        else:
            raise ValueError(f"unknown failure law {law!r}")

    def draw_interval(self, alive: int, n: int) -> float:
        """One inter-arrival sample at the current survivor count."""
        if self.law == "weibull":
            base = float(self.rng.weibull(self.shape)) / self._norm * self.mtbf
        else:
            base = float(self.rng.exponential(self.mtbf))
        if self.scale_with_survivors and alive < n:
            if alive <= 0:
                return math.inf
            base *= n / alive  # rate ∝ active GPUs => interval ∝ N / alive
        return base

    def next_arrival(self, now: float, alive: int, n: int) -> float:
        return now + self.draw_interval(alive, n)
