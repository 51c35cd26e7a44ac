"""Metrics registry: counters, gauges, exact-quantile histograms.

The live half of the observability substrate (the other half is the
span recorder in :mod:`repro_torch.obs.trace`). Three primitive types:

* :class:`Counter` — monotone accumulator (steps, failures, wire bytes,
  executable-cache misses);
* :class:`Gauge` — last-write-wins level (S_A, KV-page-pool occupancy,
  serve queue depth, per-step wire bytes);
* :class:`Histogram` — stores *every* observation, so quantiles are
  exact (``np.quantile``-identical), not sketch approximations — at
  repro scale the observation count is bounded by steps/tokens, and the
  serving acceptance gates (p99, p99.9) must not move with sketch
  resolution.

A :class:`MetricsRegistry` is a flat get-or-create namespace of those
three; :meth:`MetricsRegistry.snapshot` renders it to a JSON-able dict
with sorted keys, so two seeded runs that observe the same deterministic
values snapshot to byte-identical JSON (the determinism gate in
``tests/test_obs.py``).

A copy of ``repro.obs.metrics`` (the port keeps its own copies of the
JAX package's jax-free modules). It imports numpy only: the serving
tier's :class:`~repro_torch.serve.engine.ExecutableCache` keeps its miss
counter here as the single source of truth.
"""
from __future__ import annotations

import json

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "quantile_key", "latency_stats"]

#: default snapshot quantiles (percent)
DEFAULT_QUANTILES = (50.0, 90.0, 99.0, 99.9)


def quantile_key(q: float) -> str:
    """``50 -> "p50"``, ``99.9 -> "p99_9"`` — stable JSON field names."""
    s = f"{q:g}".replace(".", "_")
    return f"p{s}"


class Counter:
    """Monotone accumulator. ``inc`` only; resets are a new Counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Exact-quantile histogram: every observation is retained.

    Quantiles use numpy's default linear interpolation, so
    ``h.quantile(99.0) == np.percentile(h.values, 99.0)`` exactly —
    property-tested against random data in ``tests/test_obs.py``.
    """

    __slots__ = ("_values",)

    def __init__(self):
        self._values: list[float] = []

    def observe(self, v: float) -> None:
        self._values.append(float(v))

    def observe_many(self, vs) -> None:
        self._values.extend(float(v) for v in np.asarray(vs).ravel())

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def sum(self) -> float:
        return float(np.sum(self._values)) if self._values else 0.0

    @property
    def values(self) -> np.ndarray:
        return np.asarray(self._values, np.float64)

    def quantile(self, q: float) -> float:
        """Exact q-th percentile (``q`` in percent, numpy semantics)."""
        if not self._values:
            raise ValueError("quantile of an empty histogram")
        return float(np.percentile(self.values, q))

    def summary(self, quantiles=DEFAULT_QUANTILES) -> dict:
        if not self._values:
            return {"count": 0}
        v = self.values
        out = {"count": len(self._values), "sum": float(v.sum()),
               "min": float(v.min()), "max": float(v.max()),
               "mean": float(v.mean())}
        for q in quantiles:
            out[quantile_key(q)] = float(np.percentile(v, q))
        return out


class MetricsRegistry:
    """Flat get-or-create namespace of counters/gauges/histograms."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif type(m) is not cls:
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self, quantiles=DEFAULT_QUANTILES) -> dict:
        """JSON-able view with sorted keys — deterministic given
        deterministic observations."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary(quantiles)
        return out

    def dumps(self, quantiles=DEFAULT_QUANTILES) -> str:
        return json.dumps(self.snapshot(quantiles), indent=1,
                          sort_keys=True)

    def dump(self, path, quantiles=DEFAULT_QUANTILES) -> None:
        with open(path, "w") as fh:
            fh.write(self.dumps(quantiles))


# ------------------------------------------------------------------ #
# serving latency stats (shared by launch/serve.py and the bench)    #
# ------------------------------------------------------------------ #
def latency_stats(done, *, quantiles=(50.0, 99.0, 99.9)) -> dict:
    """Aggregate per-token latency stats over finished requests.

    The one implementation behind ``repro_torch.launch.serve`` and
    ``chip_smoke.py``: builds an
    exact-quantile :class:`Histogram` over every token latency and
    reports ``{"tokens", "p50_ms", "p99_ms", "p99_9_ms"}`` (one
    ``p<q>_ms`` key per requested percent, ``None`` when no tokens
    finished).
    """
    h = Histogram()
    for d in done:
        h.observe_many(d.latencies)
    out = {"tokens": h.count}
    for q in quantiles:
        key = quantile_key(q) + "_ms"
        out[key] = (round(h.quantile(q) * 1e3, 3) if h.count else None)
    return out
