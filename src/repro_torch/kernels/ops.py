"""Dispatch wrappers around the port's Hopper kernels.

The JAX package's ``ops`` picks the Pallas kernel or its interpret mode
by backend (``on_tpu``); here the choice is the tensor's device:

* a tensor on the CPU goes to the kernel's plain PyTorch version (the
  CPU tests, which hold the port against the JAX package);
* a tensor on a CUDA device launches the kernel, after the wrapper has
  checked device, dtype, shape and strides — and raises on anything the
  kernel does not take. There is no fallback to the plain version.

``launches`` counts, per kernel, the launches made through these
wrappers (one per call that reaches the kernel, nowhere else), so a run
can show that its main path really went through the kernels; reset it
with :func:`reset_launches`.
"""
from __future__ import annotations

import torch

from .flash_attention import (DTYPES, HEAD_DIMS, flash_attention_cuda,
                              flash_attention_ref)
from .rmsnorm import rmsnorm_ref, rmsnorm_triton

__all__ = ["rmsnorm", "flash_attention", "launches", "reset_launches",
           "on_cuda"]

launches = {"rmsnorm": 0, "flash_attention": 0}

_RMSNORM_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. x (..., D); w (D,) fp32."""
    _require(w.device == x.device,
             f"rmsnorm: x on {x.device}, w on {w.device}")
    if not on_cuda(x):
        return rmsnorm_ref(x, w, eps)
    d = x.shape[-1]
    _require(x.dtype in _RMSNORM_DTYPES, f"rmsnorm: x dtype {x.dtype}")
    _require(w.dtype == torch.float32, f"rmsnorm: w dtype {w.dtype}")
    _require(tuple(w.shape) == (d,), f"rmsnorm: w shape {tuple(w.shape)}, "
                                     f"x last axis {d}")
    _require(x.is_contiguous() and w.is_contiguous(),
             "rmsnorm: x and w must be contiguous")
    _require(x.numel() > 0, "rmsnorm: empty input")
    y = rmsnorm_triton(x.reshape(-1, d), w, eps)
    launches["rmsnorm"] += 1
    return y.reshape(x.shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA flash attention. q (B, H, S, D); k/v (B, KV, S, D);
    any strides with a unit stride on D. Returns (B, H, S, D)."""
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "flash_attention: q, k, v must be 4-d")
    b, h, s, d = q.shape
    kv = k.shape[1]
    _require(tuple(k.shape) == (b, kv, s, d) and k.shape == v.shape,
             f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
             f"v {tuple(v.shape)}")
    _require(kv > 0 and h % kv == 0,
             f"flash_attention: GQA needs H % KV == 0, got {h} % {kv}")
    _require(k.device == q.device and v.device == q.device,
             "flash_attention: q, k, v on different devices")
    _require(k.dtype == q.dtype and v.dtype == q.dtype,
             "flash_attention: q, k, v dtypes differ")
    if not on_cuda(q):
        return flash_attention_ref(q, k, v, causal=causal)
    _require(q.dtype in DTYPES, f"flash_attention: dtype {q.dtype}")
    _require(d in HEAD_DIMS, f"flash_attention: head dim {d} not in "
                             f"{HEAD_DIMS}")
    _require(s > 0, "flash_attention: empty sequence")
    _require(all(t.stride(-1) == 1 for t in (q, k, v)),
             "flash_attention: D must have unit stride")
    out = flash_attention_cuda(q, k, v, causal=causal)
    launches["flash_attention"] += 1
    return out
