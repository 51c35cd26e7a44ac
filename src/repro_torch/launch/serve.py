"""Serving launcher: continuous-batching decode over SPARe-masked replicas,
on the card (the counterpart of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen2.5-3b --requests 16``
runs the serving tier end to end on ``cuda``: a deterministic
:class:`~repro_torch.data.pipeline.RequestStream` feeds a
:class:`~repro_torch.serve.replicas.ReplicaServer` (paged KV cache, fused
prefill, per-slot decode) on the smoke-size configuration of a ported
family (the dense GQA configs such as qwen2.5-3b, the SSM mamba2-1.3b,
the hybrid jamba-v0.1-52b: one period of 8 layers, 8 experts top-2), as
the JAX launcher does, on every device. ``--kill STEP:R[,R]`` kills
replicas at a server step through a ``ScriptedInjector``:

    python -m repro_torch.launch.serve --arch mamba2-1.3b --kill 6:0
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --kill 3:0

``--failure-model SPEC`` (a JSON object) runs a live failure campaign
through the ``ScenarioInjector`` instead, over ``--topology`` (a JSON
``ClusterTopology``; one replica per rack by default); it takes
priority over ``--kill``. ``--ckpt-dir`` enables the wipe-out reload
from a checkpoint:

    python -m repro_torch.launch.serve --arch qwen2.5-3b --replicas 3 \
        --failure-model '{"kind": "correlated", "scope": "rack",
                          "burst_prob": 1.0, "mtbf": 400.0}'

Reports aggregate tokens/s, p50/p99 per-token latency and the replica
event log, with the card's name; exits non-zero if a request was
dropped or anything was rebuilt after warmup. ``--device cpu`` runs on
the CPU (plain versions of the kernels).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.obs.metrics import latency_stats


def parse_kill(spec: str | None) -> dict[int, list[int]]:
    """``"6:0"`` or ``"6:0,1;9:2"`` -> ``{6: [0], ...}``."""
    out: dict[int, list[int]] = {}
    if not spec:
        return out
    for part in spec.split(";"):
        step, victims = part.split(":")
        out[int(step)] = [int(v) for v in victims.split(",")]
    return out


def build_server(args, model, params, telemetry=None):
    from repro_torch.serve import ReplicaServer, pool_pages_for

    injector = None
    if args.failure_model:
        from repro_torch.des.params import DESParams
        from repro_torch.scenarios.topology import ClusterTopology
        from repro_torch.train import ScenarioInjector
        topo = (ClusterTopology(**json.loads(args.topology))
                if args.topology else
                ClusterTopology(n_groups=args.replicas, hosts_per_group=1,
                                hosts_per_rack=1))
        injector = ScenarioInjector(
            json.loads(args.failure_model), topo, n_groups=args.replicas,
            seconds_per_step=args.seconds_per_step,
            params=DESParams(n=args.replicas), seed=args.seed)
    elif args.kill:
        from repro_torch.train import ScriptedInjector
        injector = ScriptedInjector(parse_kill(args.kill),
                                    n_groups=args.replicas)

    ckpt = None
    if args.ckpt_dir:
        from repro_torch.ckpt import CheckpointManager
        ckpt = CheckpointManager(args.ckpt_dir, n_groups=args.replicas,
                                 redundancy=1, mtbf=1e6, t_save=1.0,
                                 t_restart=1.0)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    kwargs = dict(
        n_slots=args.slots, page_size=args.page_size, max_new=args.max_new,
        buckets=buckets,
        n_pages=pool_pages_for(args.slots, max(buckets) + args.max_new,
                               args.page_size))
    return ReplicaServer(model, params, n_replicas=args.replicas,
                         injector=injector, ckpt=ckpt, engine_kwargs=kwargs,
                         telemetry=telemetry)


def serve_and_measure(srv, requests):
    """Drive the server to drain; return (finished, wall_seconds). Every
    token is read back to the host inside the loop, so the wall time
    covers the device's work."""
    for req in requests:
        srv.submit(req)
    t0 = time.perf_counter()
    done = srv.run()
    return done, time.perf_counter() - t0


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots per replica")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--buckets", default="8,16",
                    help="prompt-length buckets (prompts are exact-length, "
                         "never padded)")
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kill", default=None, metavar="STEP:R[,R][;...]",
                    help="scripted replica kills at server steps")
    ap.add_argument("--failure-model", default=None,
                    help='failure-model JSON, e.g. \'{"kind": '
                         '"correlated", "scope": "rack", ...}\' (takes '
                         'priority over --kill)')
    ap.add_argument("--topology", default=None,
                    help="ClusterTopology JSON (defaults to one replica "
                         "per rack)")
    ap.add_argument("--seconds-per-step", type=float, default=100.0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="enables the wipe-out reload path")
    ap.add_argument("--report-json", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record telemetry and write a Perfetto-loadable "
                         "trace; metrics snapshot at PATH.metrics.json")
    return ap


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)

    import torch

    from repro_torch.configs import smoke_config
    from repro_torch.data import RequestStream
    from repro_torch.models import build_model
    from repro_torch.obs import Telemetry

    cfg = smoke_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)

    tel = Telemetry(trace=args.trace is not None)
    srv = build_server(args, model, params, telemetry=tel)
    srv.warmup()
    frozen = tel.snapshot()["counters"]["serve.exec_cache.misses"]
    buckets = tuple(int(b) for b in args.buckets.split(","))
    stream = RequestStream(cfg, buckets=buckets, max_new=args.max_new,
                           seed=args.seed)
    done, wall = serve_and_measure(srv, stream.requests(args.requests))

    stats = latency_stats(done)
    device = model.device
    report = {
        "arch": args.arch,
        "n_layers": cfg.n_layers,
        "head_dim": cfg.resolved_head_dim,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        **srv.report(),
        **stats,
        "wall_s": wall,
        "tokens_per_s": stats["tokens"] / wall if wall else None,
        "requests": args.requests,
        "completed_requests": len(done),
    }
    print(json.dumps(report, indent=1))
    if args.report_json:
        with open(args.report_json, "w") as fh:
            json.dump(report, fh, indent=1)
    if args.trace:
        tel.dump_trace(args.trace)
        tel.metrics.dump(args.trace + ".metrics.json")

    assert len(done) == args.requests, (
        f"dropped {args.requests - len(done)} requests")
    snap = tel.snapshot()
    assert snap["counters"]["serve.exec_cache.misses"] == frozen, (
        f"rebuilt after warmup: "
        f"{snap['counters']['serve.exec_cache.misses'] - frozen} misses")


if __name__ == "__main__":
    main()
