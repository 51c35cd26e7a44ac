#!/usr/bin/env python3
"""How far the bf16 flash-attention kernels' roundings put their results
from the fp32 reference, emulated on the CPU.

    PYTHONPATH=src python tools/flash_rounding.py

The bf16 kernels (``src/repro_torch/kernels/csrc/flash_attention.cu``)
feed P (forward and backward) and dS (backward) to the tensor cores in
bf16. This script repeats that arithmetic in fp32 PyTorch on random
qwen2.5-3b-shaped inputs (H 16, KV 2, D 128) and prints, before the
results' own rounding to bf16, the largest error of a row against the
reference in units of the card's gates: one bf16 ulp of the row's
largest |ref| (2**-7 of it) for the forward, whose gate is 1, and for
dq, dk, dv, whose gate is 2. Once rounded, two results that differ by
less than half that unit can land at most one ulp apart.

Forward: P rounded to bf16 once, and P split into a bf16 high part plus
the bf16 of the remainder (what the kernel does). Backward: P and dS
rounded once (what the kernel does), with dS of a one-key row set to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_ref

H, KV, D = 16, 2, 128


def row_units(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest error of a row (last axis) in units of 2**-7 of the row's
    largest |ref|."""
    err = (out - ref).abs().amax(-1)
    return (err / (2.0 ** -7 * ref.abs().amax(-1)).clamp_min(1e-30)).max() \
        .item()


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def inputs(b: int, s: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, s, D, generator=g).bfloat16()
            for n in (H, KV, KV, H)]


def scores(q, k):
    s = q.shape[2]
    kr = k.float().repeat_interleave(H // KV, 1)
    sc = q.float() @ kr.transpose(-1, -2) * D ** -0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    return sc.masked_fill(~causal, -1e30)


def probs(q, k):
    return torch.softmax(scores(q, k), -1)


def forward(b: int, s: int, seed: int) -> tuple[float, float]:
    q, k, v, _ = inputs(b, s, seed)
    ref = flash_attention_ref(q.float(), k.float(), v.float())
    sc = scores(q, k)
    # the kernel's P: exp of the scores less the row's maximum, in [0, 1];
    # its sum l in fp32, unrounded
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    vr = v.float().repeat_interleave(H // KV, 1)
    once = bf16(p) @ vr / l
    split = (bf16(p) @ vr + bf16(p - bf16(p)) @ vr) / l
    return row_units(once, ref), row_units(split, ref)


def backward(b: int, s: int, seed: int) -> list[float]:
    q, k, v, do = inputs(b, s, seed)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = flash_attention_ref(*leaves)
    refs = torch.autograd.grad(out, leaves, do.float())
    with torch.no_grad():
        rep = H // KV
        kr, vr = (t.float().repeat_interleave(rep, 1) for t in (k, v))
        p = probs(q, k)
        dof = do.float()
        ds = p * (dof @ vr.transpose(-1, -2) - (dof * out).sum(-1, True))
        ds[:, :, 0, :] = 0.0  # query 0 has one key
        fold = lambda x: x.reshape(b, KV, rep, s, D).sum(2)  # noqa: E731
        dq = bf16(ds) @ kr * D ** -0.5
        dk = fold(bf16(ds).transpose(-1, -2) @ q.float()) * D ** -0.5
        dv = fold(bf16(p).transpose(-1, -2) @ dof)
    return [row_units(g, r) for g, r in zip((dq, dk, dv), refs)]


def main() -> None:
    for b, s, seed in ((1, 512, 10), (1, 512, 11), (8, 256, 10),
                       (8, 256, 11)):
        once, split = forward(b, s, seed)
        print(f"forward B {b} S {s} seed {seed}: P rounded once {once:.3f}, "
              f"P split {split:.4f} (gate 1)")
    for b, s, seed in ((8, 256, 0), (1, 512, 1)):
        dq, dk, dv = backward(b, s, seed)
        print(f"backward B {b} S {s} seed {seed}: dq {dq:.3f}, dk {dk:.3f}, "
              f"dv {dv:.3f} (gate 2)")


if __name__ == "__main__":
    main()
