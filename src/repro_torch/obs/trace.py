"""Host-side span recorder with Chrome-trace / Perfetto JSON export.

The tracing half of the observability substrate. Design constraints:

* **low overhead** — recording a span is two clock reads and one tuple
  append; no per-span dict churn until export. The telemetry-off path
  never reaches this module at all (``maybe_span`` returns a module
  singleton), so the uninstrumented hot loop is allocation-free — the
  tracemalloc gate in ``tests/test_obs.py``.
* **deterministic export** — the clock is injectable. With the default
  ``time.perf_counter`` the trace carries real wall time; with a
  deterministic clock (``tick()`` below) two seeded runs export
  byte-identical JSON, which is how the trace format itself is
  regression-tested.
* **Perfetto-loadable** — ``dump()`` writes the Chrome trace-event
  format (``{"traceEvents": [...]}``, complete ``"X"`` events + instant
  ``"i"`` markers + ``"M"`` thread-name metadata). Load it at
  https://ui.perfetto.dev or ``chrome://tracing`` unchanged.

Tracks are named lanes (``main``, ``dp/<g>``, ``replica/<r>``): each
becomes one Perfetto thread row, created on first use. Failure and
recovery events land as instant markers on the per-DP-group tracks, so
the Perfetto view shows exactly *which* groups died under each
recovery span on the main track.

Span vocabulary used by the instrumented layers (the obs CLI's
attribution table keys off these names):

====================  ==================================================
``step``              one trainer loop iteration (main track)
``compute``           device step: dispatch through blocking on loss
``feed``              per-host input feed wait (mesh executor)
``ckpt_save``         snapshot + async checkpoint save
``recover``           one failure event's recovery (args carry kind/victims)
``grad_check``        post-recovery §3.1 gradient re-verification
``prefill``           serving: fused cache-filling prefill (per admission)
``decode``            serving: one batched decode step
``admit``/``evict``   serving: admission / eviction bookkeeping
``compile``           executable-cache miss (args carry the cache key)
====================  ==================================================
"""
from __future__ import annotations

import json
import time

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["TraceRecorder", "Telemetry", "maybe_span", "tick",
           "load_trace", "TraceView", "Span", "Instant"]


def tick(step: float = 1.0):
    """A deterministic monotone clock for byte-stable traces/tests."""
    state = {"t": 0.0}

    def clock() -> float:
        state["t"] += step
        return state["t"]

    return clock


class _SpanCtx:
    """Context manager recording one complete ("X") event.

    Exposes ``dur`` (seconds) after exit so callers can feed the same
    measurement into a histogram without a second clock read pair.
    """

    __slots__ = ("_rec", "name", "track", "args", "t0", "dur")

    def __init__(self, rec: "TraceRecorder", name: str, track: str, args):
        self._rec = rec
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0.0
        self.dur = 0.0

    def __enter__(self) -> "_SpanCtx":
        self.t0 = self._rec._clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._rec._clock()
        self.dur = t1 - self.t0
        self._rec._events.append(
            ("X", self.name, self.track, self.t0, t1, self.args))
        return False


class _NullSpan:
    """The telemetry-off span: a reusable no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _TimedSpan:
    """Metrics-only span: measures ``dur`` but records no trace event.

    What ``Telemetry(trace=False).span(...)`` hands out, so callers
    that feed a span's duration into a histogram (the trainer's
    ``train.step_seconds``) work identically with span recording off.
    """

    __slots__ = ("_clock", "t0", "dur")

    def __init__(self, clock):
        self._clock = clock
        self.t0 = 0.0
        self.dur = 0.0

    def __enter__(self) -> "_TimedSpan":
        self.t0 = self._clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = self._clock() - self.t0
        return False


class TraceRecorder:
    """Append-only span/instant recorder for one process."""

    def __init__(self, clock=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._t0 = self._clock()
        # (ph, name, track, t_start, t_end, args) — args may be None
        self._events: list[tuple] = []
        self._tracks: dict[str, int] = {}       # track name -> tid

    # -- recording ------------------------------------------------- #
    def span(self, name: str, track: str = "main",
             args: dict | None = None) -> _SpanCtx:
        return _SpanCtx(self, name, track, args)

    def instant(self, name: str, track: str = "main",
                args: dict | None = None) -> None:
        t = self._clock()
        self._events.append(("i", name, track, t, t, args))

    @property
    def n_events(self) -> int:
        return len(self._events)

    # -- export ---------------------------------------------------- #
    def _tid(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            # main pinned to row 0; other tracks in first-seen order
            tid = self._tracks[track] = \
                0 if track == "main" else len(self._tracks) + 1
        return tid

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable)."""
        events = []
        body = []
        for ph, name, track, t0, t1, args in self._events:
            ev = {"name": name, "ph": ph, "pid": 0,
                  "tid": self._tid(track), "ts": self._us(t0)}
            if ph == "X":
                ev["dur"] = round((t1 - t0) * 1e6, 3)
            else:
                ev["s"] = "t"
            if args:
                ev["args"] = args
            body.append(ev)
        events.append({"name": "process_name", "ph": "M", "pid": 0,
                       "args": {"name": "repro"}})
        for track in sorted(self._tracks, key=self._tracks.get):
            tid = self._tracks[track]
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": track}})
            events.append({"name": "thread_sort_index", "ph": "M",
                           "pid": 0, "tid": tid,
                           "args": {"sort_index": tid}})
        events.extend(body)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dumps(self) -> str:
        return json.dumps(self.to_chrome(), sort_keys=True,
                          separators=(",", ":"))

    def dump(self, path) -> None:
        with open(path, "w") as fh:
            fh.write(self.dumps())


class Telemetry:
    """The nullable handle threaded through trainer/executor/serving.

    Layers take ``telemetry: Telemetry | None = None`` and guard every
    touch with ``if tel is not None`` (or :func:`maybe_span`), so the
    uninstrumented path stays allocation-free. One Telemetry carries
    both halves: the span recorder (``tracer``, optional) and the
    metrics registry (always present — counters are cheap).

    The JAX package's deep mode (in-program markers through
    ``jax.debug.callback``) has no counterpart here: PyTorch runs
    eagerly, so a host-side span already brackets each device call.
    """

    def __init__(self, *, trace: bool = True, clock=None):
        self.tracer = TraceRecorder(clock=clock) if trace else None
        self._clock = clock if clock is not None else time.perf_counter
        self.metrics = MetricsRegistry()

    # -- tracing --------------------------------------------------- #
    def span(self, name: str, track: str = "main", args: dict | None = None):
        if self.tracer is None:
            return _TimedSpan(self._clock)     # metrics-only: dur still real
        return self.tracer.span(name, track, args)

    def instant(self, name: str, track: str = "main",
                args: dict | None = None) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, track, args)

    # -- metrics --------------------------------------------------- #
    def counter(self, name: str):
        return self.metrics.counter(name)

    def gauge(self, name: str):
        return self.metrics.gauge(name)

    def histogram(self, name: str):
        return self.metrics.histogram(name)

    def snapshot(self, **kw) -> dict:
        return self.metrics.snapshot(**kw)

    def dump_trace(self, path) -> None:
        if self.tracer is None:
            raise ValueError("telemetry was built with trace=False")
        self.tracer.dump(path)


def maybe_span(tel: Telemetry | None, name: str, track: str = "main",
               args: dict | None = None):
    """``tel.span(...)`` or the allocation-free null span when off."""
    if tel is None:
        return NULL_SPAN
    return tel.span(name, track, args)


# ------------------------------------------------------------------ #
# loading (the obs CLI + tests)                                      #
# ------------------------------------------------------------------ #
class Span:
    __slots__ = ("name", "track", "ts", "dur", "depth", "args")

    def __init__(self, name, track, ts, dur, depth, args):
        self.name = name
        self.track = track
        self.ts = ts              # µs from trace start
        self.dur = dur            # µs
        self.depth = depth        # 0 = top-level on its track
        self.args = args

    @property
    def end(self) -> float:
        return self.ts + self.dur

    def __repr__(self):  # pragma: no cover - debug aid
        return (f"Span({self.name!r}, track={self.track!r}, ts={self.ts}, "
                f"dur={self.dur}, depth={self.depth})")


class Instant:
    __slots__ = ("name", "track", "ts", "args")

    def __init__(self, name, track, ts, args):
        self.name = name
        self.track = track
        self.ts = ts
        self.args = args


class TraceView:
    """Parsed trace: spans with nesting depth, instants, track names."""

    def __init__(self, spans, instants, tracks):
        self.spans = spans
        self.instants = instants
        self.tracks = tracks

    def track_spans(self, track: str, depth: int | None = None):
        return [s for s in self.spans if s.track == track
                and (depth is None or s.depth == depth)]

    def named(self, name: str):
        return [s for s in self.spans if s.name == name]

    def wall_us(self, track: str = "main") -> float:
        """Last end minus first start over the track's events."""
        ts = [s.ts for s in self.spans if s.track == track] + \
             [i.ts for i in self.instants if i.track == track]
        ends = [s.end for s in self.spans if s.track == track] + \
               [i.ts for i in self.instants if i.track == track]
        return (max(ends) - min(ts)) if ts else 0.0


def load_trace(source) -> TraceView:
    """Parse a Chrome trace (path, JSON string, or dict) back into
    spans with containment-derived nesting depth."""
    if isinstance(source, dict):
        doc = source
    else:
        text = None
        try:
            with open(source) as fh:
                text = fh.read()
        except (OSError, TypeError):
            text = source
        doc = json.loads(text)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    names = {}          # tid -> track name
    for ev in events:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            names[ev.get("tid", 0)] = ev["args"]["name"]

    raw_spans, instants = [], []
    for ev in events:
        ph = ev.get("ph")
        track = names.get(ev.get("tid", 0), str(ev.get("tid", 0)))
        if ph == "X":
            raw_spans.append((ev["ts"], ev.get("dur", 0.0), ev["name"],
                              track, ev.get("args")))
        elif ph in ("i", "I"):
            instants.append(Instant(ev["name"], track, ev["ts"],
                                    ev.get("args")))

    # depth by containment: per track, sweep by (start, -dur) with a
    # stack of open end-times (spans from one recorder nest properly)
    spans: list[Span] = []
    by_track: dict[str, list] = {}
    for rec in raw_spans:
        by_track.setdefault(rec[3], []).append(rec)
    for track, recs in by_track.items():
        recs.sort(key=lambda r: (r[0], -r[1]))
        stack: list[float] = []
        for ts, dur, name, trk, args in recs:
            while stack and ts >= stack[-1]:
                stack.pop()
            spans.append(Span(name, trk, ts, dur, len(stack), args))
            stack.append(ts + dur)
    spans.sort(key=lambda s: (s.ts, -s.dur))
    instants.sort(key=lambda i: i.ts)
    tracks = sorted({s.track for s in spans} |
                    {i.track for i in instants})
    return TraceView(spans, instants, tracks)
