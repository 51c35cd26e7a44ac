#!/usr/bin/env python3
"""Probe the collectives of the int8 EF sync and of the elastic tier on
CUDA tensors, over a gloo group whose ranks share one card.

    PYTHONPATH=src python tools/gloo_cuda_probe.py [RANKS] [MIB ...]

Spawns ``RANKS`` ranks (default 4) on the one card through
:func:`repro_torch.launch.mesh.spawn_ranks` (more ranks than cards: gloo
alone, which takes CUDA tensors through the host) and runs on each,
every call through :func:`repro_torch.dist.collectives.collective`:
``all_reduce`` (fp32), ``all_to_all_single`` (int8),
``all_gather_into_tensor`` (int8), ``broadcast`` (fp32), then
``all_gather_object``, and a ``new_group`` over the upper half of the
ranks (every rank calls it) with an ``all_reduce`` on it. Each result is
checked against the values the ranks put in. Each collective is timed at
every size given (MiB a rank puts in; default 8 and 256) with the host
clock around a call that ends in a synchronize (the third of three
calls). Prints one JSON line, and the card's name and power limit; exits
1 if a check fails. Needs a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def probe_rank(rank: int, world: int, sizes_mib: list) -> list | None:
    import torch
    import torch.distributed as dist

    from repro_torch.dist.collectives import collective

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []

    def run(name, mib, fn, check):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rows.append({"op": name, "mib": mib, "ok": bool(check(got)),
                     "s": secs[-1]})

    for mib in sizes_mib:
        n = int(mib * (1 << 20))          # bytes a rank puts in
        f32 = n // 4 // world * world
        i8 = n // world * world

        def all_reduce():
            x = torch.full((f32,), float(rank + 1), device=dev)
            collective(dist.all_reduce, x)
            return x
        run("all_reduce", mib, all_reduce,
            lambda x: bool((x == world * (world + 1) / 2).all()))

        def all_to_all():
            src = torch.arange(world, device=dev, dtype=torch.int8)
            inp = (src + rank * world).repeat_interleave(i8 // world)
            out = torch.empty_like(inp)
            collective(dist.all_to_all_single, out, inp)
            return out
        want_a2a = (torch.arange(world, device=dev) * world + rank).to(
            torch.int8).repeat_interleave(i8 // world)
        run("all_to_all_single", mib, all_to_all,
            lambda x: torch.equal(x, want_a2a))

        def all_gather():
            inp = torch.full((i8 // world,), rank, dtype=torch.int8,
                             device=dev)
            out = torch.empty(i8, dtype=torch.int8, device=dev)
            collective(dist.all_gather_into_tensor, out, inp)
            return out
        want_ag = torch.arange(world, device=dev).to(
            torch.int8).repeat_interleave(i8 // world)
        run("all_gather_into_tensor", mib, all_gather,
            lambda x: torch.equal(x, want_ag))

        def broadcast():
            x = torch.full((f32,), float(rank), device=dev)
            collective(dist.broadcast, x, src=world - 1)
            return x
        run("broadcast", mib, broadcast,
            lambda x: bool((x == world - 1).all()))

    objs = [None] * world
    dist.all_gather_object(objs, {"rank": rank})
    rows.append({"op": "all_gather_object", "mib": 0, "s": None,
                 "ok": objs == [{"rank": r} for r in range(world)]})
    upper = list(range(world // 2, world))
    sub = dist.new_group(upper)
    if rank in upper:
        x = torch.ones(1024, device=dev)
        collective(dist.all_reduce, x, group=sub)
        rows.append({"op": "new_group all_reduce", "mib": 0, "s": None,
                     "ok": bool((x == len(upper)).all())})
    every = [None] * world
    dist.all_gather_object(every, rows)
    return every if rank == 0 else None


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.launch.mesh import spawn_ranks

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    world = int(argv[0]) if argv else 4
    sizes = [float(a) for a in argv[1:]] or [8.0, 256.0]
    t0 = time.perf_counter()
    per_rank, backend = spawn_ranks(probe_rank, world, device="cuda",
                                    args=(sizes,))
    secs = time.perf_counter() - t0
    ok = all(r["ok"] for rows in per_rank for r in rows)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps({"backend": backend, "ranks": world, "ok": ok,
                      "seconds": secs, "per_rank": per_rank}))
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
