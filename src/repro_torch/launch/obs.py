"""Trace analyzer: ``python -m repro_torch.launch.obs trace.json`` (a copy
of the JAX package's jax-free ``repro.launch.obs``; it reads the traces
of either package).

Renders a dumped telemetry trace
(:meth:`repro_torch.obs.Telemetry.dump_trace` — the Chrome/Perfetto JSON
the trainer's ``--trace`` flag writes) into:

* a **phase table** — wall-clock per span name, top-level and nested,
  with the coverage fraction (how much of the traced wall-clock landed
  inside *named* phases; the acceptance gate demands >= 95%);
* a **recovery-attribution table** — one row per failure event, its
  victims, and where the time went: *masking* (recovery handling that
  kept training — controller + schedule re-plan), *rollback* (steps
  re-executed after a wipe-out, costed at the run's median step
  duration), *restart* (the modeled cluster restart outage the injector
  accounted on its clock);
* optionally a **text timeline** of the main track (``--timeline``).

Exit status enforces the CI gates: ``--assert-coverage 0.95`` and
``--assert-recovery-markers`` (at least one failure marker AND one
recover span — an injected-failure run whose trace shows neither is a
broken bridge, not a quiet one).

The same trace loads unchanged at https://ui.perfetto.dev (failure
markers ride per-DP-group tracks under the main span rows).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.obs.trace import TraceView, load_trace

__all__ = ["phase_table", "attribution_table", "coverage", "analyze",
           "main"]


def phase_table(view: TraceView, track: str = "main") -> list[dict]:
    """Aggregate spans by (depth, name) on one track."""
    agg: dict[tuple, dict] = {}
    for s in view.track_spans(track):
        key = (s.depth, s.name)
        row = agg.setdefault(key, {"depth": s.depth, "phase": s.name,
                                   "count": 0, "total_us": 0.0})
        row["count"] += 1
        row["total_us"] += s.dur
    wall = view.wall_us(track)
    rows = sorted(agg.values(),
                  key=lambda r: (r["depth"], -r["total_us"]))
    for row in rows:
        row["total_s"] = row["total_us"] / 1e6
        row["pct_of_wall"] = (100.0 * row["total_us"] / wall) if wall else 0.0
    return rows


def coverage(view: TraceView, track: str = "main") -> float:
    """Fraction of the track's wall-clock inside top-level named spans.

    Top-level spans from one recorder never overlap (they come off one
    nesting stack), so the sum of their durations is the covered time.
    """
    wall = view.wall_us(track)
    if wall <= 0:
        return 0.0
    covered = sum(s.dur for s in view.track_spans(track, depth=0))
    return covered / wall


def _median_step_us(view: TraceView) -> float:
    steps = [s.dur for s in view.named("step")]
    return float(np.median(steps)) if steps else 0.0


def attribution_table(view: TraceView) -> list[dict]:
    """One row per ``recover`` span: where did the event's time go?

    * ``masking_s`` — host wall inside the recover span for masked
      (non-wipe-out) recoveries: the RECTLR controller + schedule
      re-plan that kept training alive;
    * ``rollback_s`` — wiped-out steps re-executed, costed at the run's
      median step duration (``rollback_depth x median(step)``);
    * ``restart_s`` — the modeled restart outage the injector accounted
      on its failure clock (``restart_seconds`` span arg), i.e. what a
      real cluster would additionally pay to come back;
    * ``reshape_s`` — the modeled resharding outage of an elastic
      degraded-continue (``reshape_seconds`` span arg): the event kept
      training at a reduced DP degree instead of restarting.

    Gray-failure events get their own kinds: ``demote`` (a fail-slow
    group proactively masked out of the weighted sync — the victims
    were alive, just slow) and ``readmit`` (the healed group folded
    back in); both are weight-table edits, so their cost lands in
    ``masking_s`` like any mask.
    """
    step_us = _median_step_us(view)
    rows = []
    for s in view.named("recover"):
        args = s.args or {}
        wipe = bool(args.get("wipeout"))
        reshape = bool(args.get("reshape"))
        depth = int(args.get("rollback_depth", 0))
        if args.get("demote"):
            kind = "demote"
        elif args.get("readmit"):
            kind = "readmit"
        elif reshape:
            kind = "reshape"
        elif wipe:
            kind = "restart"
        else:
            kind = "mask"
        rows.append({
            "t_s": s.ts / 1e6,
            "step": args.get("step"),
            "kind": kind,
            "victims": args.get("victims", []),
            "handling_s": s.dur / 1e6,
            "masking_s": (s.dur / 1e6
                          if kind in ("mask", "demote", "readmit")
                          else 0.0),
            "rollback_depth": depth,
            "rollback_s": depth * step_us / 1e6,
            "restart_s": float(args.get("restart_seconds", 0.0)),
            "reshape_s": float(args.get("reshape_seconds", 0.0)),
            "dp": (f"{args.get('dp_before', '?')}->"
                   f"{args.get('dp_after', '?')}" if reshape else ""),
            "s_a": f"{args.get('s_a_before', '?')}->"
                   f"{args.get('s_a_after', '?')}",
        })
    return rows


def analyze(view: TraceView) -> dict:
    """Everything the text report prints, as one JSON-able dict."""
    failures = [i for i in view.instants if i.name == "failure"]
    att = attribution_table(view)
    return {
        "tracks": view.tracks,
        "wall_s": view.wall_us("main") / 1e6,
        "coverage": coverage(view),
        "phases": phase_table(view),
        "failure_markers": len(failures),
        "failure_tracks": sorted({i.track for i in failures}),
        "recovery_events": att,
        "lost": {
            "masking_s": sum(r["masking_s"] for r in att),
            "rollback_s": sum(r["rollback_s"] for r in att),
            "restart_s": sum(r["restart_s"] for r in att),
            "reshape_s": sum(r["reshape_s"] for r in att),
        },
    }


def _fmt_s(x: float) -> str:
    return f"{x:9.3f}"


def _print_report(rep: dict, view: TraceView, timeline: int) -> None:
    print(f"trace: {rep['wall_s']:.3f}s wall on main | "
          f"tracks: {', '.join(rep['tracks'])}")
    print(f"\nphases (main track, % of {rep['wall_s']:.3f}s wall):")
    print(f"  {'phase':<16} {'count':>6} {'total_s':>9} {'% wall':>7}")
    for row in rep["phases"]:
        pad = "  " * row["depth"]
        print(f"  {pad}{row['phase']:<{16 - 2 * row['depth']}} "
              f"{row['count']:>6} {_fmt_s(row['total_s'])} "
              f"{row['pct_of_wall']:>6.1f}%")
    print(f"  coverage (top-level named spans): "
          f"{100.0 * rep['coverage']:.1f}%")

    att = rep["recovery_events"]
    print(f"\nrecovery attribution ({rep['failure_markers']} failure "
          f"markers on {len(rep['failure_tracks'])} group tracks, "
          f"{len(att)} recovery events):")
    if att:
        print(f"  {'t_s':>8} {'step':>5} {'kind':>7} {'victims':<14} "
              f"{'masking_s':>9} {'rollback_s':>10} {'restart_s':>9} "
              f"{'reshape_s':>9} {'DP':>6} {'S_A':>6}")
        for r in att:
            vict = ",".join(str(v) for v in r["victims"])
            print(f"  {r['t_s']:>8.3f} {str(r['step']):>5} "
                  f"{r['kind']:>7} {vict:<14} "
                  f"{r['masking_s']:>9.3f} {r['rollback_s']:>10.3f} "
                  f"{r['restart_s']:>9.1f} {r['reshape_s']:>9.1f} "
                  f"{r.get('dp', ''):>6} {r['s_a']:>6}")
        lost = rep["lost"]
        print(f"  {'TOTAL':>22} {'':<14} {lost['masking_s']:>9.3f} "
              f"{lost['rollback_s']:>10.3f} {lost['restart_s']:>9.1f} "
              f"{lost['reshape_s']:>9.1f}")
        print("  (masking = recovery handling that kept training, incl. "
              "demote/readmit weight-table edits for fail-slow groups; "
              "rollback = wiped steps x median step; restart = modeled "
              "outage on the injector clock; reshape = modeled elastic "
              "resharding outage, training continued degraded)")

    if timeline:
        print(f"\ntimeline (main track, first {timeline} spans):")
        for s in view.track_spans("main")[:timeline]:
            pad = "  " * s.depth
            print(f"  {s.ts / 1e6:>9.3f}s {pad}{s.name:<14} "
                  f"{s.dur / 1e6:8.3f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome/Perfetto trace JSON "
                                  "(--trace output of launch.train/serve)")
    ap.add_argument("--timeline", type=int, nargs="?", const=60, default=0,
                    help="also print the first N main-track spans")
    ap.add_argument("--json", default=None,
                    help="write the analysis dict to this path")
    ap.add_argument("--assert-coverage", type=float, default=None,
                    help="exit non-zero unless named top-level spans "
                         "cover >= this fraction of wall-clock")
    ap.add_argument("--assert-recovery-markers", action="store_true",
                    help="exit non-zero unless the trace carries >= 1 "
                         "failure marker and >= 1 recover span")
    args = ap.parse_args(argv)

    view = load_trace(args.trace)
    rep = analyze(view)
    _print_report(rep, view, args.timeline)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(rep, fh, indent=1, sort_keys=True)

    ok = True
    if args.assert_coverage is not None and \
            rep["coverage"] < args.assert_coverage:
        print(f"FAIL: coverage {rep['coverage']:.3f} < "
              f"{args.assert_coverage}", file=sys.stderr)
        ok = False
    if args.assert_recovery_markers and not (
            rep["failure_markers"] and rep["recovery_events"]):
        print(f"FAIL: expected failure markers + recovery spans, got "
              f"{rep['failure_markers']} markers / "
              f"{len(rep['recovery_events'])} events", file=sys.stderr)
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
