"""Causal GQA flash attention: the CUDA kernels' binding (K2 forward and
K2-bwd) and their plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py::
flash_attention_kernel`` (reached through ``flash_attention_pallas``);
the JAX package differentiates its plain attention, so the backward has
no Pallas counterpart and its plain version is autograd through
:func:`flash_attention_ref`. The kernels themselves, with the note on
what bounds them on this card and what their design does about that,
are ``csrc/flash_attention.cu``; compiled for ``sm_90a`` at first use
(:mod:`._build`) and called through ``ctypes`` on PyTorch's current
stream.

Each dtype has one route on the card: bf16 (the main paths) runs its
products on the tensor cores (``wgmma`` bf16 -> fp32) with tiles
streamed by asynchronous copies, which need every row of q, k, v (and
the output's gradient) to start on a 16-byte boundary
(:func:`rows_aligned`); fp32 (the fp32 references) runs them as fp32
``fmaf`` on the CUDA cores, with no alignment rule.

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

__all__ = ["flash_attention_ref", "flash_attention_cuda",
           "flash_attention_bwd_cuda", "rows_aligned", "bsh_strides", "HEAD_DIMS", "DTYPES",
           "ROW_ALIGN", "flash_attention_flops", "flash_attention_bwd_flops"]

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
#: bytes: the tensor-core route copies rows 16 bytes at a time
ROW_ALIGN = 16

_FN = None
_BWD = None


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


def flash_attention_flops(q: torch.Tensor, causal: bool = True) -> float:
    """The forward's products, JAX's matmul convention (2 flops a
    multiply-add): ``QK^T`` and ``PV`` over the causal pairs of each of
    the ``B * H`` heads (the tiles above the diagonal are skipped; a
    non-causal call takes every pair)."""
    b, h, s, d = q.shape
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * b * h * d * pairs


def flash_attention_bwd_flops(q: torch.Tensor, causal: bool = True) -> float:
    """The backward's five products over the same pairs: ``QK^T`` again,
    ``dO V^T``, ``P^T dO``, ``dS^T Q`` and ``dS K``."""
    return 2.5 * flash_attention_flops(q, causal)


def rows_aligned(ptr: int, strides, element_size: int,
                 align: int = ROW_ALIGN) -> bool:
    """Whether every row of a tensor starts on an ``align``-byte boundary:
    its address ``ptr`` and each of ``strides`` (its batch, sequence and
    head strides, in elements of ``element_size`` bytes) are multiples of
    ``align``. The rule of the bf16 kernels' asynchronous copies."""
    return ptr % align == 0 and all(s * element_size % align == 0
                                    for s in strides)


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("flash_attention").flash_attention_fwd
        i64, i32 = ctypes.c_int64, ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [i32] * 6 + [i64] * 12
                       + [i32, ctypes.c_float] + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bwd():
    global _BWD
    if _BWD is None:
        fn = _build.load("flash_attention").flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def _like_bshd(t: torch.Tensor) -> torch.Tensor:
    """An empty (B, X, S, D) tensor laid out as a contiguous (B, S, X, D)
    one, the layout the model keeps its heads in."""
    b, x, s, d = t.shape
    return torch.empty((b, s, x, d), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def bsh_strides(*ts: torch.Tensor) -> list[int]:
    """The (batch, sequence, head) strides, in elements, of each (B, X, S,
    D) tensor, as the kernels take them; an axis of length 1 is never
    stepped along, so its stride is given as 0."""
    out = []
    for t in ts:
        (b, x, s, _), (sb, sh, ss, _) = t.shape, t.stride()
        out += [sb if b > 1 else 0, ss if s > 1 else 0, sh if x > 1 else 0]
    return out


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, for_backward: bool = False,
                         launch: bool = True):
    """Launch the forward kernel. q (B, H, S, D), k/v (B, KV, S, D) on one
    CUDA device, any strides with a unit stride on D (the model passes
    ``(B, S, H, D)`` tensors transposed, without a copy). Returns
    (B, H, S, D) as a transposed view of a contiguous (B, S, H, D)
    tensor; with ``for_backward`` also what the backward reads: the fp32
    log-sum-exp of each row's scaled scores, (B, H, S), and the output
    in fp32 before its rounding, (B, S, H, D). The caller checks the
    inputs. ``launch=False`` allocates the outputs and launches nothing:
    the card route's fake implementation, on storage-free tensors."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    out = _like_bshd(q)
    lse = o32 = None
    if for_backward:
        lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        o32 = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    if not launch:
        return (out, lse, o32) if for_backward else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, h, kv, s, d,
                *bsh_strides(q, k, v, out), int(causal), d ** -0.5,
                None if lse is None else lse.data_ptr(),
                None if o32 is None else o32.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    return (out, lse, o32) if for_backward else out


def flash_attention_bwd_cuda(q, k, v, o32, dout, lse, causal: bool = True,
                             launch: bool = True):
    """Launch the backward kernels: ``(dq, dk, dv)`` for the forward's
    inputs, its fp32 output ``o32`` and log-sum-exp ``lse`` (from
    ``flash_attention_cuda(..., for_backward=True)``), and the output's
    gradient ``dout`` (unit stride on D). Each gradient is laid out as
    the model keeps its heads (a transposed view of a contiguous
    (B, S, X, D) tensor). The caller checks the inputs; ``launch=False``
    allocates as the launch does and launches nothing."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    dq, dk, dv = _like_bshd(q), _like_bshd(k), _like_bshd(v)
    dvec = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if not launch:
        return dq, dk, dv
    strides = torch.tensor(bsh_strides(q, k, v, dout, dq, dk, dv),
                           dtype=torch.int64)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _bwd()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 DTYPES[q.dtype], b, h, kv, s, d, strides.data_ptr(),
                 int(causal), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch "
                           f"failed: cudaError {err}")
    return dq, dk, dv
