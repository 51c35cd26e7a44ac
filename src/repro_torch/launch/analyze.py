"""Dry-run deep analysis: the collectives and the HBM traffic of one
traced cell, by what moves them (the counterpart of
``repro.launch.analyze``).

  python -m repro_torch.launch.analyze --arch qwen2.5-3b --shape train_4k \\
      [--multi-pod] [--top 15] [--set n_layers=2]

The JAX package walks a compiled module and multiplies each instruction
by its loops' trip counts. A traced eager step (``launch.dryrun
.record_cell``) has run every loop already, so its log and cost hold
every call: :func:`top_collectives` sums the recorded collectives by op,
output shape and source (the block and leaf a gather moves, or what a
reduction sums), :func:`top_buffers` the bytes every op and kernel read
and wrote, by op and the block it ran in. A layer's index is folded
(``layer 0.*``), so each row sums one op over the layers of a segment,
as the JAX tables sum a scanned body's instruction over its trips.
"""
from __future__ import annotations

import argparse
import ast
import re
from collections import defaultdict

__all__ = ["top_collectives", "top_buffers"]

_LAYER = re.compile(r"^layer (\d+)\.\d+")


def _fold(source: str) -> str:
    """``source`` with its layer's index folded: ``layer 0.*``."""
    return _LAYER.sub(r"layer \1.*", source)


def top_collectives(cell, k: int = 15):
    """``[(bytes moved x calls, calls, (op, shape, source))]``, largest
    first: the recorded collectives summed by op, output shape and
    source."""
    items = defaultdict(lambda: [0.0, 0])
    for c in cell.log.collectives:
        shp = f"{c.dtype}{list(c.shape)}"
        key = (c.op, shp, _fold(c.source or "?")[-110:])
        items[key][0] += c.moved
        items[key][1] += 1
    return sorted(((v[0], v[1], key) for key, v in items.items()),
                  reverse=True)[:k]


def top_buffers(cell, k: int = 15):
    """``[(bytes accessed, calls, (op, source))]``, largest first: every
    op's and kernel's operands and outputs, by op and the block it ran
    in (the op's name alone outside the blocks)."""
    items = defaultdict(lambda: [0, 0])
    for (op, src), (b, n) in cell.cost.traffic.items():
        row = items[(op, _fold(src)[-100:] or op)]
        row[0] += b
        row[1] += n
    return sorted(((v[0], v[1], key) for key, v in items.items()),
                  reverse=True)[:k]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.analyze")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (python literal)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        key, _, v = kv.partition("=")
        overrides[key] = ast.literal_eval(v)
    from repro_torch.launch.dryrun import record_cell

    cell, meta = record_cell(args.arch, args.shape, args.multi_pod,
                             overrides=overrides or None)
    if cell is None:
        raise SystemExit(f"{args.arch} {args.shape}: skipped: "
                         f"{meta['reason']}")
    print("== top collectives (bytes moved x trips) ==")
    for moved, trips, (op, shp, src) in top_collectives(cell, args.top):
        print(f"{moved / 2**30:9.2f} GiB x{trips:5d} {op:22s} {shp:28s} "
              f"{src}")
    print("\n== top HBM traffic contributors ==")
    for b, trips, (op, src) in top_buffers(cell, args.top):
        print(f"{b / 2**30:9.2f} GiB x{trips:5d} {op:22s} {src}")


if __name__ == "__main__":
    main()
