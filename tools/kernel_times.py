#!/usr/bin/env python3
"""Device time of each kernel that K1-bwd (RMSNorm backward) and K4 (the
SSD chunk scan) launch, at the main paths' shapes, by kernel name.

    PYTHONPATH=src python tools/kernel_times.py [--variants]

Needs one CUDA card. The kernels are reached through the port's public
wrappers (``repro_torch.kernels.ops``), so the same script times any tree
of the port: put that tree's ``src`` first on ``PYTHONPATH`` to time its
kernels, and compare two trees in one call, in turns (parent, change,
change, parent). Each case runs 3 warm calls, then ``ITERS`` calls under
``torch.profiler``; it prints one JSON line per case: the device time per
call of each kernel name, its launches per call, and the card's name and
power limit. K1-bwd runs at one qwen2.5-3b training microbatch (2,048
rows of 2,048, bf16), K4 at the mamba2-1.3b prefill of 512 tokens (H 64,
P 64, N 128, G 1, chunks of 256, bf16).

``--variants`` also times K1-bwd with other values of the module's
tuning constants (``PROGRAMS_PER_SM``, ``DW_ROWS``, ``DW_COLS``), where
the tree has them.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch

ITERS = 20


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def by_kernel(fn) -> dict:
    """Device ms per call and launches per call of each kernel ``fn``
    runs."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.self_device_time_total > 0:
            out[e.key[:60]] = {"ms": e.self_device_time_total / 1e3 / ITERS,
                               "launches": e.count / ITERS}
    if not out:
        raise AssertionError("the profiler saw no device time")
    return out


def rmsnorm_bwd_case():
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((2048, 2048), generator=gen, device="cuda") * 2).to(
        torch.bfloat16).requires_grad_()
    w = (torch.rand((2048,), generator=gen, device="cuda")
         + 0.5).requires_grad_()
    dy = torch.randn((2048, 2048), generator=gen, device="cuda").to(
        torch.bfloat16)
    y = ops.rmsnorm(x, w)
    # the forward's launch is recorded once, outside the timed calls
    return lambda: torch.autograd.grad(y, (x, w), dy, retain_graph=True)


def ssd_scan_case():
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    b, s, h, p, n, g = 1, 512, 64, 64, 128, 1
    x = torch.randn((b, s, h, p), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    dt = (torch.rand((b, s, h), generator=gen, device="cuda") * 0.099
          + 0.001).transpose(1, 2)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device="cuda"))
    bb, cc = (torch.randn((b, s, g, n), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    return lambda: ops.ssd_scan(x, dt, a_log, bb, cc, chunk=256)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    import repro_torch
    from repro_torch.kernels import rmsnorm

    where = repro_torch.__file__
    name = card()
    cases = [("rmsnorm_bwd", {}), ("ssd_scan", {})]
    knobs = ("PROGRAMS_PER_SM", "DW_ROWS", "DW_COLS")
    if args.variants and all(hasattr(rmsnorm, k) for k in knobs):
        for v in ((1, 64, 32), (4, 64, 32), (2, 32, 64), (2, 128, 16),
                  (2, 256, 16), (2, 64, 16), (2, 128, 8), (1, 128, 16)):
            cases.append(("rmsnorm_bwd", dict(zip(knobs, v))))
    for case, knob in cases:
        saved = {k: getattr(rmsnorm, k) for k in knob}
        for k, v in knob.items():
            setattr(rmsnorm, k, v)
        fn = (rmsnorm_bwd_case if case == "rmsnorm_bwd" else ssd_scan_case)()
        print(json.dumps({"case": case, "knobs": knob, "tree": where,
                          "kernels": by_kernel(fn), "card": name}),
              flush=True)
        for k, v in saved.items():
            setattr(rmsnorm, k, v)


if __name__ == "__main__":
    main()
