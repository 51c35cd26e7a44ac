"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the counterpart of ``repro.launch.train``).

Runs the SPARe loop (Alg. 1) on the smoke-size configuration, as the JAX
launcher does, on ``cuda`` unless ``--device cpu`` is given (on the card
with the attention head dim widened to one the flash-attention kernel
takes: :func:`repro_torch.launch.launch_config`):

    python -m repro_torch.launch.train --device cpu --arch qwen2.5-3b \
        --steps 6 --n-groups 6 -r 2 --mtbf-steps 2

``--mesh`` runs the step through the :class:`repro_torch.exec
.MeshExecutor` on a one-rank ``torch.distributed`` group (the program
every data-parallel rank runs), with ``--grad-compress int8_ef`` for the
int8 error-feedback sync. ``--ckpt-dir`` adds the disk checkpoint
(written in the background at the Eq.-1 interval).

Failure injection comes in two flavors, as in the JAX launcher:

* ``--mtbf-steps K`` — Poisson arrivals every ~K steps, single-group
  victims;
* ``--failure-model SPEC [--topology SPEC] [--seconds-per-step S]`` —
  the scenario bridge (:class:`repro_torch.train.injection
  .ScenarioInjector`): any registered failure model drives the trainer
  through the cluster topology, so rack and pod bursts and trace
  replays deliver multi-group kill batches. SPEC is a registry name or
  a JSON object; it takes priority over ``--mtbf-steps``.

The JAX launcher's ``--sweep-regimes`` (the campaign runner),
``--elastic``, ``--sync gspmd`` and ``--trace`` are not ported yet.
"""
from __future__ import annotations

import argparse
import json
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
    ap.add_argument("--mesh", action="store_true",
                    help="run the step through the MeshExecutor on a "
                         "one-rank torch.distributed group")
    ap.add_argument("--grad-compress", default="none",
                    choices=("none", "int8_ef"),
                    help="--mesh only: the int8 error-feedback sync")
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
    args = ap.parse_args(argv)
    if args.grad_compress != "none" and not args.mesh:
        ap.error("--grad-compress needs --mesh")

    from repro_torch.des import get_scheme
    from repro_torch.launch import launch_config
    from repro_torch.models import resolve_device
    from repro_torch.train.trainer import PoissonInjector, SpareTrainer

    device = resolve_device(args.device)
    cfg = launch_config(args.arch, device).scaled(grad_accum=1)
    r = _resolve_r(args)
    tag = "" if args.grad_compress == "none" else f"+{args.grad_compress}"
    plane = f"{args.n_groups}x1/shard_map{tag}" if args.mesh else "emulated"
    print(f"[train] arch={args.arch} N={args.n_groups} r={r} "
          f"scheme={args.scheme} steps={args.steps} mesh={plane} "
          f"params={cfg.param_count():,} head_dim={cfg.resolved_head_dim}")

    scheme_kwargs = {} if args.scheme == "ckpt_only" else {"r": r}
    common = dict(n_groups=args.n_groups, redundancy=r, seq=args.seq,
                  per_type_batch=args.per_type_batch, seed=args.seed,
                  ckpt_dir=args.ckpt_dir, base_lr=args.lr,
                  total_steps=args.steps, device=device,
                  scheme=get_scheme(args.scheme, **scheme_kwargs))
    close = False
    if args.mesh:
        import torch.distributed as dist

        from repro_torch.exec import MeshExecutor
        close = not dist.is_initialized()     # the group is ours to close
        compress = None if args.grad_compress == "none" \
            else args.grad_compress
        trainer = MeshExecutor(cfg, grad_compress=compress, **common)
    else:
        trainer = SpareTrainer(cfg, **common)
    if args.failure_model is not None:
        from repro_torch.train.injection import ScenarioInjector
        injector = ScenarioInjector(
            _spec(args.failure_model), _spec(args.topology),
            n_groups=args.n_groups,
            seconds_per_step=args.seconds_per_step, seed=args.seed)
    elif args.mtbf_steps > 0:
        injector = PoissonInjector(args.mtbf_steps, seed=args.seed)
    else:
        injector = None
    t0 = time.perf_counter()
    try:
        rep = trainer.run(args.steps, injector=injector,
                          verify_equivalence=args.verify_equivalence)
    finally:
        if close:
            from repro_torch.launch.mesh import close_data_group
            close_data_group()
    dt = time.perf_counter() - t0
    where = torch_device_name(device)
    print(f"[train] done: {rep.steps_done} steps in {dt:.1f}s "
          f"({dt / max(rep.steps_done, 1):.2f}s/step) on {where}")
    print(f"[train] loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f} | "
          f"failures={rep.failures} wipeouts={rep.wipeouts} "
          f"reshapes={rep.reshapes} reorders={rep.reorders} "
          f"patches={rep.patches} S_A={trainer.state.s_a} "
          f"ckpts={rep.ckpt_saves}")
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
    return 0


def torch_device_name(device) -> str:
    """The card's name for a CUDA device, ``cpu`` for the CPU."""
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


if __name__ == "__main__":
    raise SystemExit(main())
