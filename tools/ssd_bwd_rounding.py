#!/usr/bin/env python3
"""How far the bf16 SSD backward kernel's roundings put its gradients from
the unrounded backward, emulated on the CPU in float64.

    PYTHONPATH=src python tools/ssd_bwd_rounding.py

K4-bwd's bf16 route (``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu``)
runs its products on the tensor cores, which take bf16 operands. x, dy,
B and C are bf16 already; seven operands are fp32 and must be rounded to
one bf16 part or split into two or three (each part the bf16 of what the
earlier parts left):

* ``W^T`` = ((C B^T) . L . dt_j)^T, the A operand of dx_j += W^T dY_i;
* ``dCB^T`` = ((dY X^T) . L . dt_j)^T, the A operand of db_j += dCB^T C_i;
* ``dCB``, the A operand of dc_i += dCB B_j;
* ``S_prev``, the state entering a chunk, the B operand of dY_i S_prev
  (dc's inter-chunk term and, through its row dot with C_i, dcum's);
* ``dS``, the gradient of the state leaving a chunk, the B operand of
  B_j dS^T and X_j dS (dx's and db's state terms and, through the row dot
  x_j . (dS b_j), ddt's and dcum's);
* ``x.u`` (u = dt exp(seg - cum)), the A operand of the state recompute
  S <- exp(seg) S + (x . u)^T B in the sweep;
* ``dy.e`` (e = exp(cum)), the A operand of the reverse sweep dS_prev =
  exp(seg) dS + (dy . e)^T C.

This script runs the backward (the algorithm of ``kernels.ssd_scan.
ssd_scan_bwd_ref``) in float64 at the mamba2-1.3b training widths (H 64,
P 64, N 128, G 1, chunks of 256, S 512; B 2; inputs made as
``chip_smoke.py::check_ssd_scan_bwd`` makes them, with a d_final), once
unrounded and once with each operand alone taken in 1, 2 or 3 parts,
then with the kernel's part counts (:data:`KERNEL_PARTS`) together, and
prints each gradient's distance from the unrounded one in units of the
card's gates: dx, db and dc in bf16 ulps of each row's largest |ref|
(2**-7 of it; gate 1), ddt and da_log in 1e-5 of the tensor's largest
|ref| (gate 1). ``tests/test_torch_ssm_train.py`` runs
:func:`emulate` with :data:`KERNEL_PARTS` at a small shape and holds
every gradient well inside its gate.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

#: each fp32 operand's count of bf16 parts in the kernel
KERNEL_PARTS = {"W^T": 2, "dCB^T": 2, "dCB": 2, "S_prev": 3, "dS": 3,
                "x.u": 3, "dy.e": 3}
GRADS = ("dx", "ddt", "da_log", "db", "dc")
MAIN = dict(B=2, H=64, G=1, S=512, P=64, N=128, Q=256)


def parts(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` as the sum of ``k`` bf16 parts, each the bf16 of what the
    earlier parts left; ``k == 0`` leaves it unrounded."""
    if k == 0:
        return t
    out = torch.zeros_like(t)
    for _ in range(k):
        out = out + (t - out).to(torch.bfloat16).to(t.dtype)
    return out


def inputs(B, H, G, S, P, N, seed: int = 9):
    """x, dt, a_log, b, c, dy, d_final as the card check makes them:
    bf16 activations, dt from the model's softplus, a_log = log(1..H)."""
    g = torch.Generator().manual_seed(seed)

    def act(*shape):
        return torch.randn(shape, generator=g).bfloat16().double()
    x, b, c, dy = act(B, H, S, P), act(B, G, S, N), act(B, G, S, N), \
        act(B, H, S, P)
    dt = F.softplus(torch.randn((B, H, S), generator=g) * 0.5 - 4.6)
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32))
    d_final = torch.randn((B, H, P, N), generator=g)
    return x, dt.double(), a_log.double(), b, c, dy, d_final.double()


def emulate(x, dt, a_log, b, c, dy, d_final, chunk: int,
            k: dict | None = None) -> tuple[torch.Tensor, ...]:
    """The backward in float64 with each fp32 operand the kernel feeds to
    the tensor cores taken as ``parts(., k[name])`` (missing names, or
    ``k`` None: unrounded). ``cum`` is summed in float64 and rounded once
    to fp32, as every version sums it. Returns (dx, ddt, da_log, db,
    dc)."""
    k = k or {}
    kp = {name: k.get(name, 0) for name in KERNEL_PARTS}
    bs, h, s, p = x.shape
    rep = h // b.shape[1]
    bf = b.repeat_interleave(rep, 1)
    cf = c.repeat_interleave(rep, 1)
    a = -torch.exp(a_log)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    below = causal.tril(-1)
    chunks = [slice(t0, t0 + chunk) for t0 in range(0, s, chunk)]
    cums, states = [], []
    state = torch.zeros((bs, h, p, b.shape[-1]), dtype=torch.float64)
    for sl in chunks:                      # the sweep, forward
        cum = torch.cumsum(dt[..., sl] * a[None, :, None], -1).float() \
            .double()
        seg = cum[..., -1:]
        cums.append(cum)
        states.append(state)
        xu = x[..., sl, :] * (dt[..., sl] * torch.exp(seg - cum))[..., None]
        state = state * torch.exp(seg)[..., None] \
            + parts(xu, kp["x.u"]).transpose(-1, -2) @ bf[..., sl, :]
    d_state = d_final.clone()
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros((bs, h), dtype=torch.float64)
    for i in reversed(range(len(chunks))):
        sl, cum, s_prev = chunks[i], cums[i], states[i]
        xk, dyk, bk, ck, dtk = (x[..., sl, :], dy[..., sl, :], bf[..., sl, :],
                                cf[..., sl, :], dt[..., sl])
        seg = cum[..., -1:]
        ecum, dec = torch.exp(cum), torch.exp(seg - cum)
        u = dtk * dec
        lmat = torch.exp(torch.where(causal, cum[..., :, None]
                                     - cum[..., None, :], float("-inf")))
        cb = ck @ bk.transpose(-1, -2)
        gxy = dyk @ xk.transpose(-1, -2)
        kk = cb * lmat * gxy
        w = cb * lmat * dtk[..., None, :]
        dcb = gxy * lmat * dtk[..., None, :]
        ds_k = parts(d_state, kp["dS"])
        sp_k = parts(s_prev, kp["S_prev"])
        dsb = bk @ ds_k.transpose(-1, -2)
        xdsb = (xk * dsb).sum(-1)
        dx[..., sl, :] = parts(w.transpose(-1, -2), kp["W^T"]) @ dyk \
            + u[..., None] * dsb
        inter = dyk @ sp_k
        dc[..., sl, :] = parts(dcb, kp["dCB"]) @ bk + ecum[..., None] * inter
        db[..., sl, :] = parts(dcb.transpose(-1, -2), kp["dCB^T"]) @ ck \
            + u[..., None] * (xk @ ds_k)
        off = torch.where(below, kk * dtk[..., None, :], 0.0)
        dcum = off.sum(-1) - off.sum(-2) + ecum * (inter * ck).sum(-1)
        dcum[..., -1] += torch.exp(seg[..., 0]) \
            * (d_state * s_prev).sum((-1, -2))
        r = u * xdsb
        ddta = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,)) \
            + (torch.cumsum(r, -1) - r)
        ddt[..., sl] = kk.sum(-2) + dec * xdsb + a[None, :, None] * ddta
        da += (dtk * ddta).sum(-1)
        dye = dyk * ecum[..., None]
        d_state = d_state * torch.exp(seg)[..., None] \
            + parts(dye, kp["dy.e"]).transpose(-1, -2) @ ck
    g = b.shape[1]
    db = db.view(bs, g, rep, s, -1).sum(2)
    dc = dc.view(bs, g, rep, s, -1).sum(2)
    return dx, ddt, a * da.sum(0), db, dc


def units(got, ref) -> dict:
    """Each gradient's distance from ``ref`` in units of its gate: bf16
    ulps of each row's largest |ref| for dx, db, dc; 1e-5 of the largest
    |ref| for ddt and da_log."""
    out = {}
    for name, g_, r in zip(GRADS, got, ref):
        if name in ("ddt", "da_log"):
            out[name] = ((g_ - r).abs().max() / (1e-5 * r.abs().max())).item()
        else:
            row = (2.0 ** -7 * r.abs().amax(-1)).clamp_min(1e-300)
            out[name] = ((g_ - r).abs().amax(-1) / row).max().item()
    return out


def main() -> None:
    shape = dict(MAIN)
    q = shape.pop("Q")
    args = inputs(**shape)
    ref = emulate(*args, q)
    print(f"B {shape['B']} H {shape['H']} S {shape['S']} P {shape['P']} "
          f"N {shape['N']} Q {q}, float64: each gradient's distance from "
          f"the unrounded backward in gate units (dx, db, dc: bf16 ulps of "
          f"the row's largest |ref|; ddt, da_log: 1e-5 of the largest "
          f"|ref|)")
    for name in KERNEL_PARTS:
        for n_parts in (1, 2, 3):
            e = units(emulate(*args, q, {name: n_parts}), ref)
            print(f"  {name:6s} in {n_parts}: "
                  + "  ".join(f"{g} {e[g]:.4f}" for g in GRADS))
    e = units(emulate(*args, q, KERNEL_PARTS), ref)
    print("  the kernel's parts " + str(KERNEL_PARTS) + ": "
          + "  ".join(f"{g} {e[g]:.4f}" for g in GRADS))


if __name__ == "__main__":
    main()
