#!/usr/bin/env python3
"""How far the SSD scan's fp32 backwards sit from an fp64 evaluation of
the same algorithm, and how sensitive the gradients are to their inputs.

    PYTHONPATH=src python tools/ssd_bwd_numerics.py            # CPU
    PYTHONPATH=src python tools/ssd_bwd_numerics.py --device cuda  # + K4-bwd

At the mamba2-1.3b training widths (H 64, P 64, N 128, G 1, chunks of
256, S 512; B 2, fp32 inputs) and two timestep distributions, the model's
(softplus of N(-4.6, 0.5), ~0.01, as its init makes it) and a harsher one
(U(0.001, 0.1), as the forward's card tests use), it prints, per gradient
(dx, ddt, da_log, db, dc), the largest error over the tensor's largest
|fp64| of:

* ``spec``: ``ssd_scan_bwd_ref`` in fp32 (the plain backward, K4-bwd's
  spec);
* ``autograd``: torch's autograd of the plain forward ``ssd_scan_ref``,
  which differentiates ``cum_i - cum_j`` entry by entry, so the diagonal
  of the intra-chunk term enters the decays' gradient twice, in fp32,
  and cancels;
* ``kernel`` (``--device cuda``): K4-bwd;
* ``cum->fp32``: the spec in fp64 but for ``cum``, rounded once to fp32
  as the forward (and K4-bwd, and the spec) round it (the spec rounds
  ``cum`` to dt's precision, so this is the spec on fp64 inputs with dt
  left in fp32): how much of the fp32 versions' distance is that rounding
  (one fp32 ulp is 6e-5 where cum reaches ~-800, at dt up to 0.1 and
  a = -64);
* ``ulp(a_log)``: the spec in fp64 with a_log moved by one fp32 ulp,
  against the spec in fp64: the gradients' own sensitivity to their
  inputs.

The fp64 evaluation is ``ssd_scan_bwd_ref`` itself on fp64 inputs (it
computes in its inputs' precision, fp32 at the least).
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_scan as k4

B, H, S, P, N, G, Q = 2, 64, 512, 64, 128, 1, 256
GRADS = ("dx", "ddt", "da_log", "db", "dc")


def inputs(dist: str, device: str, seed: int = 0):
    g = torch.Generator().manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g)

    if dist == "softplus":
        dt = F.softplus(randn(B, H, S) * 0.5 - 4.6)
    else:
        dt = torch.rand((B, H, S), generator=g) * 0.099 + 0.001
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32))
    out = (randn(B, H, S, P), dt, a_log, randn(B, G, S, N), randn(B, G, S, N),
           randn(B, H, S, P), randn(B, H, P, N))
    return tuple(t.to(device) for t in out)


def autograd(x, dt, a_log, b, c, dy, d_final):
    leaves = [t.clone().requires_grad_() for t in (x, dt, a_log, b, c)]
    y, final = k4.ssd_scan_ref(leaves[0], leaves[1], -torch.exp(leaves[2]),
                               leaves[3], leaves[4], Q)
    return torch.autograd.grad([y, final], leaves, [dy, d_final])


def rel(got, want) -> float:
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    spec = k4.ssd_scan_bwd_ref
    for dist in ("softplus", "uniform"):
        args_ = inputs(dist, args.device)
        dt, a_log = args_[1:3]
        x64, dt64, a64, b64, c64, dy64, df64 = (t.double() for t in args_)
        truth = spec(x64, dt64, a64, b64, c64, dy64, df64, Q)
        moved = torch.nextafter(a_log, torch.full_like(a_log, 1e3))
        nudged = spec(x64, dt64, moved.double(), b64, c64, dy64, df64, Q)
        rows = {"spec": spec(*args_, Q),
                "autograd": autograd(*args_)}
        if args.device == "cuda":
            rows["kernel"] = k4.ssd_scan_bwd_cuda(*args_, Q)
        rows["cum->fp32"] = spec(x64, dt, a64, b64, c64, dy64, df64, Q)
        rows["ulp(a_log)"] = nudged
        for name, grads in rows.items():
            errs = "  ".join(f"{g} {rel(v, t):.2e}"
                             for g, v, t in zip(GRADS, grads, truth))
            print(f"dt {dist:8s} {name:10s} {errs}")


if __name__ == "__main__":
    main()
