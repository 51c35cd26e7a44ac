"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the counterpart of ``repro.launch.train``).

Runs the SPARe loop (Alg. 1) on the smoke-size configuration, as the JAX
launcher does, on ``cuda`` unless ``--device cpu`` is given (the same
configuration on either):

    python -m repro_torch.launch.train --device cpu --arch qwen2.5-3b \
        --steps 6 --n-groups 6 -r 2 --mtbf-steps 2

Every ported family's config runs: the dense GQA configs, the SSM
mamba2-1.3b and the hybrid jamba-v0.1-52b (one period of 8 layers, 8
experts top-2; the MoE layers run every routed slot, as the JAX model
without a ``model`` mesh axis does).

``--mesh`` runs the step through the :class:`repro_torch.exec
.MeshExecutor` on a one-rank ``torch.distributed`` group (the program
every data-parallel rank runs), with ``--grad-compress int8_ef`` for the
int8 error-feedback sync. ``--model-degree M`` above 1 lays the JAX
launcher's ``(n_groups, M)`` mesh out as ``n_groups * M`` spawned ranks
on ``--device`` (:func:`repro_torch.launch.mesh.spawn_ranks`; ranks that
share a card do so over gloo), and ``--sync gspmd`` shards the
parameters and AdamW moments on the model axis (the mesh executor's
module doc); ``--sync gspmd`` refuses ``--grad-compress int8_ef``, as
the JAX launcher's executor does:

    python -m repro_torch.launch.train --device cpu --mesh \
        --model-degree 2 --sync gspmd --n-groups 2 -r 1 --steps 4 --seq 16

``--mesh --elastic`` adds the elastic recovery tier
(:class:`repro_torch.elastic.ElasticMeshExecutor`): ``--n-groups`` rows
of ``--model-degree`` ranks, a row per SPARe group, each rank a spawned
process on ``--device`` (ranks that share a card do so over gloo; the
backend is printed), in either sync; an
unmaskable failure set shrinks the data-parallel degree and continues
degraded when the TTT policy favors it over a restart (``--t-reshape``
is the modeled outage of one reshape). ``--ckpt-dir`` adds the disk
checkpoint (written in the background at the Eq.-1 interval, by logical
rank 0).

Failure injection comes in two flavors, as in the JAX launcher:

* ``--mtbf-steps K`` — Poisson arrivals every ~K steps, single-group
  victims;
* ``--failure-model SPEC [--topology SPEC] [--seconds-per-step S]`` —
  the scenario bridge (:class:`repro_torch.train.injection
  .ScenarioInjector`): any registered failure model drives the trainer
  through the cluster topology, so rack and pod bursts and trace
  replays deliver multi-group kill batches. SPEC is a registry name or
  a JSON object; it takes priority over ``--mtbf-steps``.

``--sweep-regimes`` ignores ``--arch`` and runs the trainer campaign
preset instead (:func:`repro_torch.scenarios.campaign
.trainer_regime_cells`): the smoke-size trainer across the three
scenario regimes (weibull / rack-burst / trace replay), verifying the
§3.1 gradient invariant after every recovery, on ``--device``.

``--trace PATH`` records telemetry and writes a Perfetto-loadable trace
(analyze it with ``python -m repro_torch.launch.obs PATH``) and a
metrics snapshot at ``PATH.metrics.json``; with ``--sweep-regimes`` PATH
is a directory that gets one trace per regime. ``--trace-deep`` adds
the EF residual norms and per-bucket sync spans.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _spec(arg: str | None):
    """Parse a model/topology CLI spec: JSON object or bare name."""
    if arg is None:
        return None
    arg = arg.strip()
    if arg.startswith("{"):
        return json.loads(arg)
    return arg


def _resolve_r(args) -> int:
    """'-r 0 = Thm-4.3 optimal' — the JAX launcher's policy."""
    from repro_torch.core.theory import r_star
    return args.redundancy or max(2, min(r_star(args.n_groups),
                                         args.n_groups - 1))


def _sweep_regimes(args) -> None:
    from repro_torch.scenarios.campaign import (run_trainer_cell,
                                                trainer_regime_cells)

    trace_dir = args.trace     # in sweep mode --trace names a DIRECTORY
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        print(f"[sweep] telemetry on: one trace per regime under "
              f"{trace_dir}/", file=sys.stderr)
    cells = trainer_regime_cells(steps=args.steps, n=args.n_groups,
                                 r=_resolve_r(args),
                                 topology=_spec(args.topology),
                                 seconds_per_step=args.seconds_per_step,
                                 base_seed=args.seed,
                                 trace_dir=trace_dir or None)
    rows = []
    for cell in cells:
        label = cell["model"].get("label", cell["model"]["kind"])
        print(f"[sweep] {label}: N={cell['n']} r={cell['r']} "
              f"steps={cell['steps']}", file=sys.stderr)
        row = run_trainer_cell(cell, device=args.device)
        rows.append(row)
        print(f"[sweep] {label}: steps={row['steps_done']} "
              f"failures={row['failures']} wipeouts={row['wipeouts']} "
              f"reorders={row['reorders']} patches={row['patches']} "
              f"multi_group={row['multi_group_events']} "
              f"max_grad_err={row['max_grad_check_err']:.2e}")
    multi = sum(r["multi_group_events"] for r in rows)
    print(f"[sweep] total multi-group kill batches delivered to "
          f"scheme.recover: {multi}")
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(rows, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--n-groups", type=int, default=8,
                    help="SPARe data-parallel degree N")
    ap.add_argument("--redundancy", "-r", type=int, default=0,
                    help="stack redundancy r (0 = Thm-4.3 optimal)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--per-type-batch", type=int, default=2)
    ap.add_argument("--mtbf-steps", type=float, default=0.0,
                    help="Poisson injector: failures every ~K steps "
                         "(0 = none)")
    ap.add_argument("--failure-model", default=None,
                    help="scenario-bridge injection: model name or JSON "
                         "spec (repro_torch.scenarios registry)")
    ap.add_argument("--topology", default=None,
                    help="cluster topology: preset name or JSON spec "
                         "(default: small layout at N)")
    ap.add_argument("--seconds-per-step", type=float, default=None,
                    help="step duration on the failure model's clock "
                         "(default: DES t_comp + t_allreduce)")
    ap.add_argument("--verify-equivalence", action="store_true",
                    help="check the §3.1 gradient invariant after every "
                         "successful recovery")
    ap.add_argument("--sweep-regimes", action="store_true",
                    help="run the smoke-size trainer (seq=32, per-type "
                         "batch 1, §3.1-verified) across the three "
                         "scenario regimes and exit; honors --steps/"
                         "--n-groups/-r/--seed/--topology/"
                         "--seconds-per-step/--device/--trace, ignores "
                         "the other flags")
    ap.add_argument("--mesh", action="store_true",
                    help="run the step through the MeshExecutor on a "
                         "one-rank torch.distributed group")
    ap.add_argument("--model-degree", type=int, default=1,
                    help="tensor-parallel degree of the --mesh grid: "
                         "n_groups x model_degree spawned ranks above 1")
    ap.add_argument("--sync", default="shard_map",
                    choices=("shard_map", "gspmd"),
                    help="--mesh gradient-sync spelling: the explicit "
                         "bucketed sync over replicas, or params and "
                         "moments sharded on the model axis")
    ap.add_argument("--grad-compress", default="none",
                    choices=("none", "int8_ef"),
                    help="--mesh only: the int8 error-feedback sync "
                         "(requires --sync shard_map)")
    ap.add_argument("--elastic", action="store_true",
                    help="with --mesh: the elastic recovery tier "
                         "(repro_torch.elastic.ElasticMeshExecutor) on "
                         "--n-groups x --model-degree spawned ranks, a "
                         "row of the grid per SPARe group "
                         "— an unmaskable failure set shrinks the DP "
                         "degree and continues degraded when the TTT "
                         "policy favors it over restart")
    ap.add_argument("--t-reshape", type=float, default=60.0,
                    help="--elastic only: modeled outage seconds per "
                         "online resharding (weighed against the "
                         "t_restart outage by the TTT policy)")
    ap.add_argument("--scheme", default="spare",
                    help="fault-tolerance scheme (repro_torch.des "
                         "registry: spare | replication | ckpt_only | "
                         "adaptive)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--report-json", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record telemetry and write a Perfetto-loadable "
                         "Chrome trace here (analyze with python -m "
                         "repro_torch.launch.obs PATH); a metrics "
                         "snapshot lands next to it at PATH.metrics.json")
    ap.add_argument("--trace-deep", action="store_true",
                    help="with --trace: EF residual norms and per-bucket "
                         "sync spans (adds device syncs; for attribution "
                         "runs)")
    args = ap.parse_args(argv)
    if args.sweep_regimes:
        _sweep_regimes(args)
        return 0
    if args.grad_compress != "none" and not args.mesh:
        ap.error("--grad-compress needs --mesh")
    if args.elastic and not args.mesh:
        ap.error("--elastic needs --mesh (the elastic tier reshapes a "
                 "data-parallel group)")
    if args.grad_compress != "none" and args.sync != "shard_map":
        ap.error("--grad-compress needs --sync shard_map (gspmd derives "
                 "its own fp32 all-reduce)")

    from repro_torch.configs import smoke_config
    from repro_torch.models import resolve_device

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch).scaled(grad_accum=1)
    r = _resolve_r(args)
    tag = "" if args.grad_compress == "none" else f"+{args.grad_compress}"
    plane = (f"{args.n_groups}x{args.model_degree}/{args.sync}{tag}"
             if args.mesh else "emulated")
    print(f"[train] arch={args.arch} N={args.n_groups} r={r} "
          f"scheme={args.scheme} steps={args.steps} mesh={plane} "
          f"params={cfg.param_count():,} head_dim={cfg.resolved_head_dim}")

    t0 = time.perf_counter()
    if args.elastic:
        from repro_torch.launch.mesh import spawn_ranks
        world = args.n_groups * args.model_degree
        (rep, s_a, dp, policy_log), backend = spawn_ranks(
            _elastic_rank, world, device=device,
            args=(args, cfg, r, str(device)))
        per = "one per group" if args.model_degree == 1 else \
            f"a row of {args.model_degree} per group"
        print(f"[train] {world} ranks on {device.type}, {per}; backend "
              f"{backend}")
    elif args.mesh and args.model_degree > 1:
        from repro_torch.launch.mesh import spawn_ranks
        world = args.n_groups * args.model_degree
        (rep, s_a, dp, policy_log), backend = spawn_ranks(
            _mesh_rank, world, device=device,
            args=(args, cfg, r, str(device)))
        print(f"[train] {world} ranks on {device.type}: {args.n_groups} "
              f"data slices x {args.model_degree} model ranks; backend "
              f"{backend}")
    else:
        rep, s_a, dp, policy_log = _run_here(args, cfg, r, device)
    dt = time.perf_counter() - t0
    where = torch_device_name(device)
    print(f"[train] done: {rep.steps_done} steps in {dt:.1f}s "
          f"({dt / max(rep.steps_done, 1):.2f}s/step) on {where}")
    print(f"[train] loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} | "
          f"failures={rep.failures} wipeouts={rep.wipeouts} "
          f"reshapes={rep.reshapes} reorders={rep.reorders} "
          f"patches={rep.patches} S_A={s_a} "
          f"ckpts={rep.ckpt_saves}")
    if rep.reshapes:
        print(f"[train] elastic: DP degree now {dp} (full "
              f"{args.n_groups}); policy log: {policy_log}")
    if rep.events:
        print(f"[train] recovery events={len(rep.events)} "
              f"multi_group={rep.multi_group_events} "
              f"rollback_steps={rep.rollback_steps} "
              f"max_grad_err={rep.max_grad_check_err:.2e}")
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump({"losses": rep.losses, "failures": rep.failures,
                       "wipeouts": rep.wipeouts, "steps": rep.steps_done,
                       "multi_group_events": rep.multi_group_events,
                       "max_grad_check_err": rep.max_grad_check_err,
                       "device": where}, f)
    if args.trace is not None:
        print(f"[train] trace -> {args.trace} (analyze: python -m "
              f"repro_torch.launch.obs {args.trace}) | metrics -> "
              f"{args.trace}.metrics.json")
    return 0


def _setup(args, r: int, device):
    """The telemetry (with ``--trace``) and the trainer's arguments."""
    from repro_torch.des import get_scheme

    tel = None
    if args.trace is not None:
        from repro_torch.obs import Telemetry
        tel = Telemetry(deep=args.trace_deep)
    scheme_kwargs = {} if args.scheme == "ckpt_only" else {"r": r}
    common = dict(n_groups=args.n_groups, redundancy=r, seq=args.seq,
                  per_type_batch=args.per_type_batch, seed=args.seed,
                  ckpt_dir=args.ckpt_dir, base_lr=args.lr,
                  total_steps=args.steps, device=device, telemetry=tel,
                  scheme=get_scheme(args.scheme, **scheme_kwargs))
    return tel, common


def _injector(args):
    from repro_torch.train.trainer import PoissonInjector

    if args.failure_model is not None:
        from repro_torch.train.injection import ScenarioInjector
        return ScenarioInjector(
            _spec(args.failure_model), _spec(args.topology),
            n_groups=args.n_groups,
            seconds_per_step=args.seconds_per_step, seed=args.seed)
    if args.mtbf_steps > 0:
        return PoissonInjector(args.mtbf_steps, seed=args.seed)
    return None


def _dump(tel, args) -> None:
    if tel is not None:
        tel.dump_trace(args.trace)
        tel.metrics.dump(args.trace + ".metrics.json")


def _run_here(args, cfg, r: int, device):
    """The trainer (``--mesh``: the executor on a one-rank group) in
    this process; returns the report, the final ``S_A`` and DP degree,
    and an empty policy log."""
    from repro_torch.train.trainer import SpareTrainer

    tel, common = _setup(args, r, device)
    close = False
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.exec import MeshExecutor
        close = not dist.is_initialized()     # the group is ours to close
        compress = None if args.grad_compress == "none" \
            else args.grad_compress
        trainer = MeshExecutor(cfg, grad_compress=compress,
                               sync=args.sync, **common)
    else:
        trainer = SpareTrainer(cfg, **common)
    try:
        rep = trainer.run(args.steps, injector=_injector(args),
                          verify_equivalence=args.verify_equivalence)
    finally:
        if close:
            from repro_torch.launch.mesh import close_data_group
            close_data_group()
    _dump(tel, args)
    return rep, trainer.state.s_a, trainer.state.n, []


def _mesh_rank(rank: int, world: int, args, cfg, r: int, device: str):
    """One rank of ``--mesh --model-degree M`` (M > 1): the mesh executor
    over the spawned grid; returns the run's report (the same on every
    rank), the final ``S_A`` and DP degree and an empty policy log. The
    trace is written by the grid's rank 0."""
    from repro_torch.exec import MeshExecutor

    tel, common = _setup(args, r, device)
    compress = None if args.grad_compress == "none" else args.grad_compress
    trainer = MeshExecutor(cfg, model_degree=args.model_degree,
                           sync=args.sync, grad_compress=compress, **common)
    try:
        rep = trainer.run(args.steps, injector=_injector(args),
                          verify_equivalence=args.verify_equivalence)
    finally:
        trainer.close()
    if rank == 0:
        _dump(tel, args)
    return rep, trainer.state.s_a, trainer.state.n, []


def _elastic_rank(rank: int, world: int, args, cfg, r: int, device: str):
    """One rank of ``--mesh --elastic``: the elastic executor over the
    spawned grid (``--n-groups`` rows of ``--model-degree`` ranks);
    returns the run's report (the same on every rank), the final ``S_A``
    and DP degree and the policy log. The trace is written by the rank
    that ends at (logical row 0, model 0)."""
    from repro_torch.elastic import ElasticMeshExecutor

    tel, common = _setup(args, r, device)
    compress = None if args.grad_compress == "none" else args.grad_compress
    trainer = ElasticMeshExecutor(cfg, t_reshape=args.t_reshape,
                                  model_degree=args.model_degree,
                                  sync=args.sync, grad_compress=compress,
                                  **common)
    try:
        rep = trainer.run(args.steps, injector=_injector(args),
                          verify_equivalence=args.verify_equivalence)
    finally:
        trainer.close()
    if trainer.rank == 0 and trainer.model_rank == 0:
        _dump(tel, args)
    return rep, trainer.state.s_a, trainer.state.n, trainer.policy_log


def torch_device_name(device) -> str:
    """The card's name for a CUDA device, ``cpu`` for the CPU."""
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


if __name__ == "__main__":
    raise SystemExit(main())
