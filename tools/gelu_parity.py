#!/usr/bin/env python3
"""How the tanh GELU's spellings compare with ``jax.nn.gelu``, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/gelu_parity.py

``jax.nn.gelu`` (``approximate=True`` by default) computes
``x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))`` op by op in
the input's dtype, with both constants rounded to that dtype. The port's
``repro_torch.models.layers.gelu`` spells the same ops. This script
counts, over N normal inputs of scale 3 (default 65,536, seed 0), the
elements where each spelling differs from ``jax.jit(jax.nn.gelu)``:
in bf16, ``F.gelu(x, approximate="tanh")``, ``F.gelu(x)`` and the
port's; in fp32, ``torch.tanh`` against ``jnp.tanh`` on the same inputs
and the port's gelu, with the largest gap relative to max(|x|,
|gelu(x)|). Needs jax and torch, not the card.
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.layers import gelu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    x = (np.random.default_rng(args.seed).standard_normal(args.n)
         * 3.0).astype(np.float32)
    jgelu = jax.jit(jax.nn.gelu)

    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jgelu(xb)).view(np.int16)
    tb = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    for name, fn in (("F.gelu(x, approximate='tanh')",
                      lambda t: F.gelu(t, approximate="tanh")),
                     ("F.gelu(x)", F.gelu), ("layers.gelu(x)", gelu)):
        got = fn(tb).view(torch.int16).numpy()
        print(f"bf16 {name}: {int((got != want).sum())} of {args.n} "
              f"elements differ from jax.nn.gelu")

    tf = torch.from_numpy(x.copy())
    tanh_diff = int((torch.tanh(tf).numpy()
                     != np.asarray(jax.jit(jnp.tanh)(jnp.asarray(x)))).sum())
    print(f"fp32 torch.tanh: {tanh_diff} of {args.n} elements differ from "
          f"XLA's tanh")
    want32 = np.asarray(jgelu(jnp.asarray(x)))
    got32 = gelu(tf).numpy()
    scale = np.maximum(np.abs(want32), np.abs(x))
    print(f"fp32 layers.gelu(x): {int((got32 != want32).sum())} of "
          f"{args.n} elements differ; largest gap "
          f"{float((np.abs(got32 - want32) / scale).max()):.3g} of "
          f"max(|x|, |gelu(x)|)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
