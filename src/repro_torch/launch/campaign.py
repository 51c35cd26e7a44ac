"""Campaign CLI: ``python -m repro_torch.launch.campaign [--preset regimes]``
(the counterpart of ``repro.launch.campaign``).

Runs a declarative scenario grid (scheme x N x r x failure model x seed)
through the process-parallel campaign runner and writes byte-stable
CSV/JSON artifacts under ``results/campaign/``, byte-identical to the
JAX CLI's for the same grid. The cells are discrete-event simulations on
the host: no device is needed. Grids come from a named preset
(``--preset``, see ``--list``) or a JSON spec file (``--grid``) with the
:class:`repro_torch.scenarios.campaign.CampaignSpec` fields::

    {"name": "my_sweep",
     "schemes": ["spare", ["replication", {"r": 2}]],
     "ns": [200], "rs": [4, 9],
     "models": [{"kind": "correlated", "label": "rack", "burst_prob": 0.2}],
     "seeds": [0, 1], "steps": 600}

Determinism: each cell seeds its RNG from a hash of its own identity,
so ``--jobs 4`` (spawned workers) produces byte-identical artifacts to
``--jobs 1``.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", default="smoke",
                    help="named grid (see --list)")
    ap.add_argument("--grid", default=None,
                    help="JSON CampaignSpec file (overrides --preset)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes (1 = serial)")
    ap.add_argument("--seeds", type=int, default=None,
                    help="override: sweep seeds 0..K-1")
    ap.add_argument("--steps", type=int, default=None,
                    help="override the grid's training horizon")
    ap.add_argument("--base-seed", type=int, default=None,
                    help="override the grid's seed-hash salt")
    ap.add_argument("--out", default=None,
                    help="artifact basename (default: the grid's name)")
    ap.add_argument("--outdir", default=None,
                    help="artifact directory (default: results/campaign)")
    ap.add_argument("--list", action="store_true",
                    help="list presets, schemes, failure models, traces")
    args = ap.parse_args(argv)

    from repro_torch.des import list_schemes
    from repro_torch.scenarios import (CAMPAIGN_PRESETS, CampaignSpec,
                                       bundled_traces, list_failure_models,
                                       ranking_by_regime, run_campaign,
                                       save_artifacts)

    if args.list:
        print(f"presets:  {sorted(CAMPAIGN_PRESETS)}")
        print(f"schemes:  {list_schemes()}")
        print(f"models:   {list_failure_models()}")
        print(f"traces:   {bundled_traces()}")
        return

    if args.grid:
        spec = CampaignSpec.from_json(args.grid)
    else:
        try:
            spec = CAMPAIGN_PRESETS[args.preset]
        except KeyError:
            sys.exit(f"unknown preset {args.preset!r}; "
                     f"have {sorted(CAMPAIGN_PRESETS)}")
    if args.seeds is not None:
        spec.seeds = list(range(args.seeds))
    if args.steps is not None:
        spec.steps = args.steps

    cells = spec.cells()
    print(f"[campaign] {spec.name}: {len(cells)} cells, "
          f"jobs={args.jobs}", file=sys.stderr)
    t0 = time.perf_counter()
    results = run_campaign(cells, jobs=args.jobs, base_seed=args.base_seed)
    elapsed = time.perf_counter() - t0

    csv_path, json_path = save_artifacts(args.out or spec.name, results,
                                         outdir=args.outdir)
    cell_s = sum(r["elapsed_s"] for r in results)
    print(f"[campaign] done in {elapsed:.1f}s wall; {cell_s:.1f}s total "
          f"cell-time ({cell_s / max(elapsed, 1e-9):.2f}x speedup vs "
          f"serial)", file=sys.stderr)
    print(f"[campaign] artifacts: {csv_path} {json_path}", file=sys.stderr)

    for regime, ranking in ranking_by_regime(results).items():
        order = " > ".join(
            f"{e['scheme']}({e['mean_ttt_norm']:.2f})" for e in ranking)
        print(f"{regime}: {order}")


if __name__ == "__main__":
    main()
