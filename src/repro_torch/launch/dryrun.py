"""The dry run: one step of a production cell, traced on one rank of a
fake grid of 256 or 512 ranks, with no card (the counterpart of
``repro.launch.dryrun``).

The JAX package lowers and compiles each cell's step for the emulated
production mesh and reads the compiled program's memory, FLOPs and
collectives. Eager PyTorch compiles nothing, so here the step itself is
run once, by rank 0 of torch's fake process group of ``16 x 16`` (or
``2 x 16 x 16``) ranks, on storage-free tensors (``meta``):

  1. the production grid (:func:`repro_torch.launch.mesh
     .production_groups`), the model built on it (``build_model(cfg,
     "meta", mesh=groups)``: the FSDP x TP program), the rank's blocks of
     the parameters under the rule table, its AdamW moments and its slice
     of the cell's batch (:func:`input_specs`);
  2. the train step (``make_train_step(model, grad_shardings=specs)``),
     the prefill (``make_prefill``) or the decode step
     (``make_serve_step``) recorded once (:func:`record_cell`,
     ``launch.steplog.record_cost``): every kernel takes the card's route
     to its fake implementation, which allocates what the launch
     allocates; the fake group's collectives move nothing but are
     recorded as the ranks would issue them;
  3. the record (:func:`run_cell`): the rank's argument, output and
     aliased bytes, the live storage at its most (``peak_bytes``), the
     products' FLOPs, the bytes every op reads and writes, the collective
     table, and the roofline on the H100's data-sheet rates.

Storage-free tensors are ``meta`` ones, not ``FakeTensor`` s on
``cuda``: a torch built without CUDA aborts the process (it does not
raise) when autograd meets a CUDA tensor, fake or not, so a machine with
no card could not trace the backward; a ``meta`` tensor has the shapes,
dtypes and storage sizes the card's would have, and
:mod:`repro_torch.kernels.ops` sends it down the card's route while the
trace runs (``ops.tracing_card``).

The FSDP x TP program runs qwen2.5-3b; every other config raises
``NotImplementedError`` naming its ``ROADMAP.md`` item
(:func:`repro_torch.models.model.mesh_refusal`), which the CLI records as
a failed cell (``ok: false``), not a skip. ``long_500k`` on a
full-attention config is the JAX package's documented skip.

Results go to ``results/dryrun/*.json`` (one file per cell).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k \\
      [--multi-pod] [--s-a 2] [--set n_layers=2] [--out-dir DIR]
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import ast
import json
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.dist import tree_leaves
from repro_torch.dist.sharding import batch_spec, local_shard, shard_tree
from repro_torch.launch.mesh import (PRODUCTION_AXES, init_mesh_groups,
                                     production_groups)
from repro_torch.kernels import ops
from repro_torch.launch.steplog import StepCost, StepLog, record_cost

__all__ = ["input_specs", "model_flops_per_device", "record_cell",
           "run_cell", "cell_list", "RecordedCell", "PEAK_FLOPS", "HBM_BW",
           "LINK_BW", "RESULTS_DIR"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun"

# NVIDIA H100 SXM (700 W) data-sheet rates
PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # bytes/s
#: NVLink 4, each way; a model axis of 16 spans two 8-card nodes, so the
#: collective term it gives is optimistic
LINK_BW = 450e9              # bytes/s

#: the AdamW step counter: a host int here, JAX's int32 scalar there
STEP_COUNTER_BYTES = 4
#: XLA counts its output tuple's table, a pointer an output leaf
TUPLE_ENTRY_BYTES = 8
#: a train step's metrics: loss, grad_norm, lr (fp32 scalars)
METRIC_BYTES = 12


def input_specs(cfg, shape, axes: dict, multi_pod: bool, s_a: int = 1):
    """Storage-free tensors of the step's whole inputs and their spec
    entries (the rule table's batch specs), for one cell: ``(batch,
    specs)``. Train cells stack ``s_a * grad_accum`` microbatches of
    ``global_batch / grad_accum`` examples."""
    bspec = batch_spec(shape.global_batch, axes, multi_pod)
    meta = torch.device("meta")

    def sds(shape_, dtype):
        return torch.empty(tuple(shape_), dtype=dtype, device=meta)

    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: the embeds= frontends "
                                  f"(ROADMAP.md §1)")
    if shape.kind == "train":
        n_micro = s_a * cfg.grad_accum
        b_micro = shape.global_batch // cfg.grad_accum
        batch = {"labels": sds((n_micro, b_micro, shape.seq), torch.int32),
                 "weights": sds((n_micro, b_micro), torch.float32),
                 "tokens": sds((n_micro, b_micro, shape.seq), torch.int32)}
        specs = {"labels": (None, bspec, None), "weights": (None, bspec),
                 "tokens": (None, bspec, None)}
        return batch, specs
    b = shape.global_batch
    seq = shape.seq if shape.kind == "prefill" else 1
    return ({"tokens": sds((b, seq), torch.int32)},
            {"tokens": (bspec, None)})


def model_flops_per_device(cfg, shape, n_devices: int) -> float:
    """MODEL_FLOPS = 6*N_active*D (train) / 2*N_active*D (inference),
    per device."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq
        return 6.0 * n_active * tokens / n_devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq
        return 2.0 * n_active * tokens / n_devices
    return 2.0 * n_active * shape.global_batch / n_devices


@dataclass
class RecordedCell:
    """One traced step of a cell: its log, its cost and the bytes of its
    arguments (``arg_bytes``), outputs and aliased outputs, as the JAX
    package's ``memory_analysis()`` counts them."""

    log: StepLog
    cost: StepCost
    arg_bytes: int
    out_bytes: int
    alias_bytes: int


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _grid(world_group, axes: dict, multi_pod: bool):
    """The production grid, or a ``(data, model)`` grid of ``axes``."""
    if axes == PRODUCTION_AXES["multi_pod" if multi_pod else "single_pod"]:
        return production_groups(world_group, multi_pod)
    return init_mesh_groups(world_group, axes["model"])


def record_cell(arch: str, shape_name: str, multi_pod: bool, s_a: int = 1,
                overrides: dict | None = None, *, axes: dict | None = None,
                shape=None, rank: int = 0, weights=None,
                watch: bool = False, cfg=None, dtype=None):
    """Trace one step of a cell on ``rank`` of a fake grid (``axes``,
    default the production mesh) and return ``(RecordedCell, meta)``, or
    ``(None, {"skipped": True, "reason": ...})`` for an inapplicable
    cell. ``meta`` carries what the JAX package's ``lower_cell`` gives
    the step passes: the donated argnums, the arguments' flat leaf counts
    and the per-rank weight table's shape.

    ``weights`` replaces the whole ``(n_micro, b_micro)`` weight table
    (the lint records a cell under two); ``watch`` records the host
    reads, fp64 outputs and draws too (``launch.steplog.record_step``).
    ``cfg`` replaces ``arch``'s config (``overrides`` apply to it), and
    ``dtype`` casts the parameters (the CPU tests' fp32 cell).

    Every rank's trace costs as much as rank 0's, and every collective
    of one names the global ranks of its group, so ``rank`` picks whose
    schedule the trace gives (the card's gates compare each rank's)."""
    from repro_torch.launch.lint import fake_grid
    from repro_torch.models import build_model
    from repro_torch.models.model import Model, cast_params
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_prefill, make_serve_step, \
        make_train_step

    cfg = cfg or get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = shape or SHAPES[shape_name]
    ok_run, why = applicable(cfg, shape)
    if not ok_run:
        return None, {"skipped": True, "reason": why}
    axes = dict(axes or PRODUCTION_AXES["multi_pod" if multi_pod
                                        else "single_pod"])
    world = 1
    for n in axes.values():
        world *= int(n)
    with fake_grid(rank, world) as world_group, ops.tracing_card():
        grid = _grid(world_group, axes, multi_pod)
        model = build_model(cfg, "meta", mesh=grid)
        coords, sizes = grid.coords(), grid.axis_sizes()
        whole = cast_params(Model(cfg, torch.device("meta")).init(0),
                            dtype=dtype)
        blocks = shard_tree(whole, model.specs, coords, sizes)
        batch, bspecs = input_specs(cfg, shape, axes, multi_pod, s_a)
        if weights is not None:
            batch["weights"] = weights
        local = {k: local_shard(v, bspecs[k], coords, sizes)
                 for k, v in batch.items()}
        p_leaves = tree_leaves(blocks)
        meta = {"devices": world, "kind": shape.kind}
        if shape.kind == "train":
            opt = adamw_init(blocks, moment_dtype=cfg.moment_dtype)
            state = p_leaves + tree_leaves(opt.mu) + tree_leaves(opt.nu)
            step = make_train_step(model, grad_shardings=model.specs)
            out, log, cost = record_cost(
                step, (blocks, opt, local), donated=state,
                returned=lambda r: tree_leaves(r[0]) + tree_leaves(r[1].mu)
                + tree_leaves(r[1].nu), watch=watch)
            arg = _bytes(state) + STEP_COUNTER_BYTES + _bytes(local.values())
            alias = _bytes(state) + STEP_COUNTER_BYTES
            n_out = len(state) + 1 + 3
            out_b = alias + METRIC_BYTES + TUPLE_ENTRY_BYTES * n_out
            w = local["weights"]
            meta.update(donate=(0, 1),
                        arg_leaves=[len(p_leaves), 1 + 2 * len(p_leaves),
                                    len(local)],
                        weights_shape=f"f32[{w.shape[0]},{w.shape[1]}]")
        elif shape.kind == "prefill":
            fn = make_prefill(model)
            out, log, cost = record_cost(
                lambda p, t: fn(p, tokens=t), (blocks, local["tokens"]),
                donated=[], returned=lambda r: [], watch=watch)
            arg = _bytes(p_leaves) + _bytes(local.values())
            alias, out_b = 0, _bytes([out])
            meta.update(donate=(), arg_leaves=[len(p_leaves), 1, 0],
                        weights_shape=None)
        else:
            cache = model.init_decode_state(shape.global_batch, shape.seq)
            c_leaves = tree_leaves(cache)
            fn = make_serve_step(model)
            out, log, cost = record_cost(
                lambda p, c, t: fn(p, c, 0, tokens=t),
                (blocks, cache, local["tokens"]), donated=c_leaves,
                returned=lambda r: tree_leaves(r[1]), watch=watch)
            arg = _bytes(p_leaves) + _bytes(c_leaves) + \
                _bytes(local.values()) + 4
            alias = _bytes(c_leaves)
            out_b = _bytes([out[0]]) + alias + \
                TUPLE_ENTRY_BYTES * (1 + len(c_leaves))
            meta.update(donate=(1,), arg_leaves=[len(p_leaves),
                                                 len(c_leaves), 1, 1, 0],
                        weights_shape=None)
    return RecordedCell(log=log, cost=cost, arg_bytes=arg, out_bytes=out_b,
                        alias_bytes=alias), meta


def run_cell(arch: str, shape_name: str, multi_pod: bool, s_a: int = 1,
             variant: str = "baseline", overrides: dict | None = None, *,
             axes: dict | None = None, shape=None) -> dict:
    """One cell's record (see the module doc): the JAX package's keys,
    the roofline on the H100's rates."""
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape_spec = shape or SHAPES[shape_name]
    axes_ = dict(axes or PRODUCTION_AXES["multi_pod" if multi_pod
                                         else "single_pod"])
    mesh_name = "x".join(str(n) for n in axes_.values())
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "variant": variant, "s_a": s_a, "ok": False}
    t0 = time.perf_counter()
    cell, meta = record_cell(arch, shape_name, multi_pod, s_a, overrides,
                             axes=axes, shape=shape)
    if cell is None:
        rec.update(skipped=True, reason=meta["reason"], ok=True)
        return rec
    rec["record_s"] = round(time.perf_counter() - t0, 1)
    c = cell.cost
    n_dev = meta["devices"]
    colls = {"counts": dict(sorted(c.collective_counts.items())),
             "bytes": {k: round(v) for k, v in
                       sorted(c.collective_bytes.items())},
             "total_bytes": round(c.total_collective_bytes)}
    mf = model_flops_per_device(cfg, shape_spec, n_dev)
    temp = max(0, c.peak_bytes - cell.arg_bytes
               - (cell.out_bytes - cell.alias_bytes))
    rec.update(
        ok=True, devices=n_dev, n_layers=cfg.n_layers,
        arg_bytes=int(cell.arg_bytes), out_bytes=int(cell.out_bytes),
        temp_bytes=int(temp), alias_bytes=int(cell.alias_bytes),
        peak_bytes=int(c.peak_bytes), flops_per_device=c.flops,
        bytes_per_device=c.bytes_accessed,
        unknown_trip_loops=c.unknown_trip_loops, collectives=colls,
        model_flops_per_device=mf,
        useful_flops_ratio=(mf / c.flops if c.flops else 0.0),
        roofline={
            "compute_s": c.flops / PEAK_FLOPS,
            # every op's operands and outputs: the eager program's traffic
            "memory_s": c.bytes_accessed / HBM_BW,
            # outputs only: the lower bound a fused program could reach
            "memory_lb_s": c.bytes_written / HBM_BW,
            "collective_s": c.total_collective_bytes / LINK_BW,
        },
    )
    terms = {k: rec["roofline"][k]
             for k in ("compute_s", "memory_s", "collective_s")}
    rec["bottleneck"] = max(terms, key=terms.get)
    return rec


def cell_list():
    cells = []
    for arch in ARCHS:
        for shape_name in SHAPES:
            for multi_pod in (False, True):
                cells.append((arch, shape_name, multi_pod))
    return cells


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--s-a", type=int, default=1,
                    help="all-reduce stack depth to trace (SPARe S_A)")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (python literal), "
                         "e.g. --set n_layers=2")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    if args.list:
        for arch, shape, mp in cell_list():
            print(f"{arch} {shape} {'2x16x16' if mp else '16x16'}")
        return

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    tag = f"{args.arch}__{args.shape}__{mesh_name}__{args.variant}"
    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = ast.literal_eval(v)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       s_a=args.s_a, variant=args.variant,
                       overrides=overrides or None)
    except Exception as e:  # noqa: BLE001 — record the failure
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "variant": args.variant, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    status = "OK" if rec.get("ok") else "FAIL"
    if rec.get("skipped"):
        status = "SKIP"
    print(f"[{status}] {tag} "
          f"record={rec.get('record_s', '-')}s "
          f"peak={rec.get('peak_bytes', 0) / 2**30:.2f}GiB "
          f"bottleneck={rec.get('bottleneck', '-')}")
    if not rec.get("ok"):
        print(rec.get("error", ""))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
