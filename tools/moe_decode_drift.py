#!/usr/bin/env python3
"""How far a MoE model's decode drifts from its prefill, and why.

    PYTHONPATH=src python tools/moe_decode_drift.py --layers 6

Builds deepseek-v2-lite-16b (or ``--arch``) at published width with
``--layers`` layers, random weights from ``--seed``, in ``--dtype``
(bf16 by default: the model's dtypes, its norms and router in fp32),
on ``--device`` (the CPU by default). It prefills
``--tokens`` random tokens, prefills their first ``--prompt`` again,
copies that state into dense caches and decodes the rest one token at a
time, teacher-forced. For every decoded position it prints the RMS of
the logit difference from the long prefill, whether the greedy choice
agrees, and the MoE layers whose top-k experts for that position
differ between the two paths (``route_topk`` recorded in both).
Positions that take the same experts everywhere stay within the
dtype's rounding; a position routed otherwise in some layer is a
different function from there on. At published width one MoE layer
holds 0.585B parameters: 6 layers need ~7 GB of host memory in bf16.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--tokens", type=int, default=40)
    ap.add_argument("--prompt", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.dist import tree_leaves
    from repro_torch.models import build_model, cast_params
    from repro_torch.models import moe as moe_mod

    dtype = getattr(torch, args.dtype)
    cfg = get_config(args.arch).scaled(n_layers=args.layers)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)       # bf16, the norms and router fp32
    if dtype == torch.float32:
        params = cast_params(params, dtype=dtype)
    seq = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (1, args.tokens))).long().to(model.device)

    routes: list[torch.Tensor] = []
    route_topk = moe_mod.route_topk

    def recording(x_flat, router_w, top_k):
        idx, w = route_topk(x_flat, router_w, top_k)
        routes.append(idx.sort(-1).values)
        return idx, w
    moe_mod.route_topk = recording
    try:
        with torch.no_grad():
            full, _ = model.prefill(params, seq)
            prefill_routes = list(routes)
            _, state = model.prefill(params, seq[:, :args.prompt])
            caches = cast_params(model.init_decode_state(1, args.tokens),
                                 dtype=dtype)
            for big, small in zip(tree_leaves(caches), tree_leaves(state)):
                big[:, :, :args.prompt].copy_(small)
            for pos in range(args.prompt, args.tokens):
                routes.clear()
                logits, caches = model.decode_step(
                    params, caches, pos, seq[:, pos:pos + 1])
                got, want = logits[0, 0].float(), full[0, pos].float()
                flipped = [i for i, r in enumerate(routes)
                           if not torch.equal(r[0], prefill_routes[i][pos])]
                agree = int(got[:cfg.vocab].argmax()) == \
                    int(want[:cfg.vocab].argmax())
                rms = (got - want).square().mean().sqrt().item()
                print(f"position {pos}: logit RMS difference {rms:.4f}, "
                      f"greedy {'agrees' if agree else 'differs'}, MoE "
                      f"layers routed otherwise {flipped}")
    finally:
        moe_mod.route_topk = route_topk
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
