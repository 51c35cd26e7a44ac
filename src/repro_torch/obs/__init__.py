"""repro_torch.obs — unified telemetry: span tracing + metrics registry.

Copies of the JAX package's jax-free ``repro.obs`` modules:

* :mod:`repro_torch.obs.trace` — low-overhead host-side span recorder
  with Chrome-trace/Perfetto export and the nullable :class:`Telemetry`
  handle the trainer, the mesh executor and the serving tier thread
  through their hot loops (``None`` keeps the uninstrumented path
  allocation-free);
* :mod:`repro_torch.obs.metrics` — counters / gauges / exact-quantile
  histograms, snapshottable to deterministic JSON;
* ``python -m repro_torch.launch.obs trace.json`` — text timeline and
  the recovery-attribution table rendered from a dumped trace.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, latency_stats,
                                     quantile_key)
from repro_torch.obs.trace import (Instant, Span, Telemetry, TraceRecorder,
                                   TraceView, load_trace, maybe_span, tick)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "latency_stats",
    "quantile_key",
    "Telemetry", "TraceRecorder", "TraceView", "Span", "Instant",
    "load_trace", "maybe_span", "tick",
]
