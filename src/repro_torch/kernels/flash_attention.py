"""Causal GQA flash attention: the CUDA kernel's binding and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_kernel`` (reached through ``flash_attention_pallas``).
The kernel itself, with the note on what bounds it on this card and what
its design does about that, is ``csrc/flash_attention.cu``; it is
compiled for ``sm_90a`` at first use (:mod:`._build`) and called through
``ctypes`` on PyTorch's current stream.

Both versions compute the Pallas kernel's function: q ``(B, H, S, D)``,
k/v ``(B, KV, S, D)``, KV head ``h // (H / KV)``, scores and online
softmax in fp32 with scale ``D**-0.5``, output in q's dtype. Unlike the
Pallas kernel, S need not be a multiple of a block: the last tile is
masked.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_attention_ref", "flash_attention_cuda", "HEAD_DIMS",
           "DTYPES"]

HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30

_FN = None


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The plain version: full fp32 score matrix, fp32 softmax and PV,
    cast to q's dtype."""
    b, h, s, d = q.shape
    rep = h // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scores = torch.matmul(q.float(), kf.transpose(-1, -2)) * d ** -0.5
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, vf).to(q.dtype)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        i64, i32 = ctypes.c_int64, ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [i32] * 6 + [i64] * 12
                       + [i32, ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel. q (B, H, S, D), k/v (B, KV, S, D) on one CUDA
    device, any strides with a unit stride on D (the model passes
    ``(B, S, H, D)`` tensors transposed, without a copy). Returns
    (B, H, S, D) as a transposed view of a contiguous (B, S, H, D)
    tensor. The caller checks the inputs."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = []
    for t in (q, k, v, out):
        sb, sh, ss, _ = t.stride()
        strides += [sb, ss, sh]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, h, kv, s, d, *strides, int(causal),
                d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return out
