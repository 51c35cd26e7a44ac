#!/usr/bin/env python3
"""How far the bf16 SSD chunk-scan kernel's roundings put its results from
the fp32 reference, emulated on the CPU.

    PYTHONPATH=src python tools/ssd_rounding.py

The bf16 route of K4 (``src/repro_torch/kernels/csrc/ssd_scan.cu``) runs
its products on the tensor cores, which take bf16 operands. x, B and C
are bf16 already; three operands are fp32 and must be rounded or split:

* W = (C B^T) . exp(cum_i - cum_j) . dt_j, the A operand of y += W X;
* the carried state S (P x N), the B operand of y += exp(cum_i) C S^T;
* x . u with u = dt exp(seg - cum), the A operand of the state update
  S <- exp(seg) S + (x . u)^T B (the same products as x^T (B . u)).

This script repeats the scan at the mamba2-1.3b prefill shape (B 1,
S 512 in chunks of 256, H 64, P 64, N 128, G 1; inputs made as
``chip_smoke.py`` makes them) in float64, with each of those operands
rounded to bf16 once ("1"), split into a bf16 high part plus the bf16 of
the remainder ("2") or into three such parts ("3"), and prints the
error against the unrounded scan in units of the card's gates: for y,
one bf16 ulp of each (head, position) row's largest |ref| (2**-7 of it;
gate 1, and once rounded, two values less than half a unit apart land
at most one ulp apart); for the final state, 1e-5 of its largest |ref|
(gate 1).
"""
from __future__ import annotations

import torch

B, H, S, P, N, G, Q = 1, 64, 512, 64, 128, 1, 256


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def parts(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` as the sum of ``k`` bf16 parts, each the bf16 of what the
    earlier parts left; ``k == 0`` leaves it unrounded."""
    if k == 0:
        return t
    out = torch.zeros_like(t)
    for _ in range(k):
        out = out + bf16(t - out)
    return out


def inputs(seed: int):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g).bfloat16().transpose(1, 2)
    dt = (torch.rand(B, S, H, generator=g) * 0.099 + 0.001).transpose(1, 2)
    a = -torch.arange(1, H + 1, dtype=torch.float32)
    b, c = (torch.randn(B, S, G, N, generator=g).bfloat16().transpose(1, 2)
            for _ in range(2))
    return x, dt, a, b, c


def scan(x, dt, a, b, c, w_parts: int, s_parts: int, xu_parts: int):
    """The chunked scan in float64 with W, the state fed to the inter
    product and x . u each taken as ``parts(., k)``; cum is summed in
    float64 and rounded once to fp32, as both the kernel and the plain
    version sum it."""
    f = torch.float64
    rep = H // G
    xf, dtf = x.to(f), dt.to(f)
    bf = b.to(f).repeat_interleave(rep, 1)
    cf = c.to(f).repeat_interleave(rep, 1)
    dta = (dt * a[None, :, None]).double()
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    state = torch.zeros(B, H, P, N, dtype=f)
    ys = []
    for t0 in range(0, S, Q):
        sl = slice(t0, t0 + Q)
        cum = torch.cumsum(dta[..., sl], -1).float().to(f)
        seg = cum[..., -1:]
        diff = cum[..., :, None] - cum[..., None, :]
        lmat = torch.exp(torch.where(causal, diff, float("-inf")))
        w = (cf[..., sl, :] @ bf[..., sl, :].transpose(-1, -2)) * lmat \
            * dtf[..., None, sl]
        y = parts(w, w_parts) @ xf[..., sl, :]
        y = y + (cf[..., sl, :] @ parts(state, s_parts).transpose(-1, -2)) \
            * torch.exp(cum)[..., None]
        ys.append(y)
        xu = xf[..., sl, :] * (dtf[..., sl] * torch.exp(seg - cum))[..., None]
        state = state * torch.exp(seg)[..., None] \
            + parts(xu, xu_parts).transpose(-1, -2) @ bf[..., sl, :]
    return torch.cat(ys, 2), state


def y_units(y: torch.Tensor, ref: torch.Tensor) -> float:
    err = (y - ref).abs().amax(-1)
    return (err / (2.0 ** -7 * ref.abs().amax(-1)).clamp_min(1e-300)) \
        .max().item()


def state_units(st: torch.Tensor, ref: torch.Tensor) -> float:
    return ((st - ref).abs().max() / (1e-5 * ref.abs().max())).item()


def main() -> None:
    for seed in (8, 9):
        args = inputs(seed)
        y_ref, st_ref = scan(*args, 0, 0, 0)
        print(f"seed {seed}: y in bf16 ulps of its row (gate 1), state in "
              f"1e-5 of max|ref| (gate 1)")
        for w, s, xu in ((1, 0, 0), (2, 0, 0), (0, 1, 0), (0, 2, 0),
                         (0, 0, 1), (0, 0, 2), (0, 0, 3), (2, 2, 2),
                         (2, 2, 3)):
            y, st = scan(*args, w, s, xu)
            print(f"  W {w or '-'} S {s or '-'} x.u {xu or '-'}: y "
                  f"{y_units(y, y_ref):.4f}, state "
                  f"{state_units(st, st_ref):.4f}")


if __name__ == "__main__":
    main()
