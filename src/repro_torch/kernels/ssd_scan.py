"""Mamba-2 SSD chunk scan: the CUDA kernel's binding (K4) and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/ssd_scan.py::
ssd_scan_kernel`` (reached through ``ssd_scan_pallas``). The kernel
itself, with the note on what bounds it on this card and what its design
does about that, is ``csrc/ssd_scan.cu``; compiled for ``sm_90a`` at
first use (:mod:`._build`) and called through ``ctypes`` on PyTorch's
current stream.

Each dtype has one route on the card: bf16 (the serving path) runs its
products on the tensor cores (``wgmma`` bf16 -> fp32, the fp32 operands
split into bf16 parts) with tiles streamed by asynchronous copies, which
need every row of x, b and c to start on a 16-byte boundary; fp32 (the
fp32 references) runs them as fp32 ``fmaf`` on the CUDA cores, with no
alignment rule.

Both versions compute the Pallas kernel's function: x ``(B, H, S, P)``,
dt ``(B, H, S)`` fp32, ``a = -exp(a_log)`` ``(H,)`` fp32, b/c
``(B, G, S, N)`` with head h reading group ``h // (H / G)``; per chunk of
Q tokens ``cum = cumsum(dt * a)``, the intra-chunk ``((C B^T) . L . dt_j)
X`` with ``L_ij = exp(cum_i - cum_j)`` for ``j <= i`` (selected before
the exponential, so a masked entry is 0 and never inf), the inter-chunk
``exp(cum_i) C_i S`` and the state ``S <- exp(seg) S + X^T (B dt
exp(seg - cum))`` carried in fp32. y comes out in x's dtype, the final
state ``(B, H, P, N)`` in fp32. ``cum`` is summed in fp64 and rounded
once to fp32 in both versions, so it does not depend on the order of
the sum. Unlike the Pallas kernel, the chunk need not be a power of
two.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ssd_scan_ref", "ssd_scan_cuda", "HEAD_DIMS", "STATE_DIMS",
           "DTYPES", "MAX_CHUNK"]

HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256

_FN = None


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the chunked algorithm, one chunk at a time over
    every (batch, head) at once, fp32 math. ``chunk`` divides S."""
    bs, h, s, p = x.shape
    rep = h // b.shape[1]
    xf, dtf = x.float(), dt.float()
    bf = b.float().repeat_interleave(rep, dim=1)     # (B, H, S, N)
    cf = c.float().repeat_interleave(rep, dim=1)
    dta = dtf * a.float()[None, :, None]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    state = torch.zeros((bs, h, p, b.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        cum = torch.cumsum(dta[..., sl].double(), dim=-1).float()  # (B,H,Q)
        seg = cum[..., -1:]
        diff = cum[..., :, None] - cum[..., None, :]
        l = torch.exp(torch.where(causal, diff, float("-inf")))
        cb = torch.matmul(cf[..., sl, :], bf[..., sl, :].transpose(-1, -2))
        w = cb * l * dtf[..., None, sl]
        y_intra = torch.matmul(w, xf[..., sl, :])
        y_inter = torch.matmul(cf[..., sl, :], state.transpose(-1, -2)) \
            * torch.exp(cum)[..., None]
        ys.append((y_intra + y_inter).to(x.dtype))
        bw = bf[..., sl, :] * (dtf[..., sl] * torch.exp(seg - cum))[..., None]
        state = state * torch.exp(seg)[..., None] \
            + torch.matmul(xf[..., sl, :].transpose(-1, -2), bw)
    return torch.cat(ys, dim=2), state


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("ssd_scan").ssd_scan_fwd
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bhs_strides(t: torch.Tensor) -> list[int]:
    """The (batch, head or group, sequence) strides, in elements, of a
    (B, X, S, ...) tensor, as the kernel takes them; an axis of length 1
    is never stepped along, so its stride is given as 0."""
    return [st if n > 1 else 0 for n, st in zip(t.shape[:3], t.stride()[:3])]


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel. x (B, H, S, P), b/c (B, G, S, N) with a unit
    stride on P and N, dt (B, H, S) fp32 with any strides, a_log (H,)
    fp32 contiguous (the kernel forms ``a = -exp(a_log)``), all on one
    CUDA device (the model passes its (B, S, H, P) and (B, S, G, N)
    activations transposed, without a copy). Returns y (B, H, S, P) as a transposed view of a contiguous
    (B, S, H, P) tensor, and the final state (B, H, P, N) fp32. The
    caller checks the inputs."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    y = torch.empty((bs, s, h, p), dtype=x.dtype,
                    device=x.device).transpose(1, 2)
    state = torch.empty((bs, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 15)(*(
        _bhs_strides(x) + _bhs_strides(dt) + _bhs_strides(b)
        + _bhs_strides(c) + _bhs_strides(y)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                c.data_ptr(), y.data_ptr(), state.data_ptr(), DTYPES[x.dtype],
                bs, h, g, s, chunk, p, n, ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    return y, state
