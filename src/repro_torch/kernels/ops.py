"""Dispatch wrappers around the port's Hopper kernels.

The JAX package's ``ops`` picks the Pallas kernel or its interpret mode
by backend (``on_tpu``); here the choice is the tensor's device:

* a tensor on the CPU goes to the kernel's plain PyTorch version (the
  CPU tests, which hold the port against the JAX package); autograd
  differentiates it there;
* a tensor on a CUDA device launches the kernel, after the wrapper has
  checked device, dtype, shape and strides — and raises on anything the
  kernel does not take. There is no fallback to the plain version.
  Where autograd needs a gradient, RMSNorm and flash attention go
  through a ``torch.autograd.Function`` whose backward is a kernel too
  (K1-bwd, K2-bwd); without one (serving, ``no_grad``) the forward runs
  alone, and flash attention then writes nothing for a backward. The SSD
  scan (K4) goes the same way, its backward K4-bwd.

``launches`` counts, per kernel, the launches made through these
wrappers (one per call that reaches the kernel, nowhere else), so a run
can show that its main path really went through the kernels; reset it
with :func:`reset_launches`.

A ``meta`` tensor while :func:`tracing_card` is on stands for a
card's (:func:`is_fake`) and takes the card's route too, with its
checks, but to a fake implementation that allocates what the launch
allocates, outputs and workspaces, and launches nothing (``launches``
does not move). The dry run (:mod:`repro_torch.launch.dryrun`) traces
the card's program that way: such a tensor never takes the plain
version, whose S x S scores would inflate the peak it reads. Outside a
trace a ``meta`` tensor is rejected, as any device without a kernel or
a plain version. While a step's cost is recorded
(:mod:`repro_torch.launch.steplog`), each kernel call, launched or fake,
reports its name, its products' flops (K2's and K2-bwd's formulas,
``flash_attention_flops`` and ``flash_attention_bwd_flops``; the other
kernels compute no product) and its operands and outputs to
:data:`cost_hook`.
"""
from __future__ import annotations

import contextlib

import torch

from .flash_attention import (DTYPES, HEAD_DIMS, ROW_ALIGN, bsh_strides,
                              flash_attention_bwd_cuda,
                              flash_attention_bwd_flops, flash_attention_cuda,
                              flash_attention_flops, flash_attention_ref,
                              rows_aligned)
from .int8_ef import GRAD_DTYPES, int8_ef_cuda, int8_ef_ref
from .rmsnorm import DTYPES as RMSNORM_DTYPES
from .rmsnorm import (bwd_programs, rmsnorm_bwd_triton, rmsnorm_cuda,
                      rmsnorm_ref)
from .ssd_scan import DTYPES as SSD_DTYPES, HEAD_DIMS as SSD_HEAD_DIMS
from .ssd_scan import (MAX_CHUNK, STATE_DIMS, bwd_heads_per_block,
                       bwd_workspace, ssd_scan_bwd_cuda, ssd_scan_cuda,
                       ssd_scan_ref)

__all__ = ["rmsnorm", "flash_attention", "ssd_scan", "int8_ef_quantize",
           "launches", "reset_launches", "on_cuda", "is_fake", "FAKE_SMS",
           "tracing_card"]

launches = {"rmsnorm": 0, "rmsnorm_bwd": 0, "flash_attention": 0,
            "flash_attention_bwd": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
            "int8_ef_absmax": 0, "int8_ef_quantize": 0}


#: the SMs of the card a fake K1-bwd sizes its partial rows for (the
#: H100 SXM's 132)
FAKE_SMS = 132

#: ``hook(name, flops, operands, outputs)`` for every kernel call while a
#: step's cost is recorded; None otherwise
cost_hook = None

#: whether a ``meta`` tensor stands for a card's (:func:`tracing_card`)
_meta_is_card = False


@contextlib.contextmanager
def tracing_card():
    """While on, a ``meta`` tensor takes the card's route to its fake
    implementation (the dry run's trace)."""
    global _meta_is_card
    before, _meta_is_card = _meta_is_card, True
    try:
        yield
    finally:
        _meta_is_card = before


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def is_fake(x: torch.Tensor) -> bool:
    """A ``meta`` tensor while :func:`tracing_card` is on: a storage-free
    one standing for a card's."""
    return _meta_is_card and x.device.type == "meta"


def on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor or a storage-free one (the card's route,
    see the module doc), False for a CPU one; raises otherwise."""
    if x.device.type == "cuda" or is_fake(x):
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {x.device}")


def _cost(name: str, flops: float, operands, outputs) -> None:
    if cost_hook is not None:
        cost_hook(name, flops, tuple(t for t in operands if t is not None),
                  tuple(t for t in outputs if t is not None))


def _ptr(t: torch.Tensor) -> int:
    """The address the alignment rules read (0 for a storage-free
    tensor, whose rows the card would place)."""
    return 0 if is_fake(t) else t.data_ptr()


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ------------------------------------------------------------------ #
# K1: RMSNorm                                                         #
# ------------------------------------------------------------------ #
def _rmsnorm_fwd(x2: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    if is_fake(x2):
        y = torch.empty_like(x2)
    else:
        y = rmsnorm_cuda(x2, w, eps)
        launches["rmsnorm"] += 1
    _cost("rmsnorm", 0.0, (x2, w), (y,))
    return y


def _rmsnorm_bwd(x2, w, dy2, eps):
    if not is_fake(x2):
        dx, dw = rmsnorm_bwd_triton(x2, w, dy2, eps)
        launches["rmsnorm_bwd"] += 1
    else:
        # the launch's allocations: dx, one fp32 partial row of dw a
        # program, dw
        dx = torch.empty_like(x2)
        partial = torch.empty((bwd_programs(x2.shape[0], FAKE_SMS)[1],
                               x2.shape[1]), dtype=torch.float32,
                              device=x2.device)
        dw = torch.empty((x2.shape[1],), dtype=torch.float32,
                         device=x2.device)
        del partial
    _cost("rmsnorm_bwd", 0.0, (x2, w, dy2), (dx, dw))
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """K1 forward, K1-bwd backward; x (rows, D) contiguous."""

    @staticmethod
    def forward(ctx, x2, w, eps):
        ctx.save_for_backward(x2, w)
        ctx.eps = eps
        return _rmsnorm_fwd(x2, w, eps)

    @staticmethod
    def backward(ctx, dy2):
        x2, w = ctx.saved_tensors
        dx, dw = _rmsnorm_bwd(x2, w, dy2.contiguous(), ctx.eps)
        return dx, dw, None


def _check_rmsnorm_card(x: torch.Tensor, w: torch.Tensor) -> None:
    """What K1 takes: dtypes, w's shape, contiguity, a nonempty x. Each
    message is built only on failure: the decode step runs this 2L+1
    times."""
    d = x.shape[-1]
    if x.dtype not in RMSNORM_DTYPES:
        raise ValueError(f"rmsnorm: x dtype {x.dtype}")
    if w.dtype != torch.float32:
        raise ValueError(f"rmsnorm: w dtype {w.dtype}")
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w shape {tuple(w.shape)}, x last axis "
                         f"{d}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if x.numel() == 0:
        raise ValueError("rmsnorm: empty input")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. x (..., D); w (D,) fp32."""
    if w.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, w on {w.device}")
    if not on_cuda(x):
        return rmsnorm_ref(x, w, eps)
    _check_rmsnorm_card(x, w)
    x2 = x.view(-1, x.shape[-1])
    if _wants_grad(x, w):
        y = _RMSNorm.apply(x2, w, eps)
    else:
        y = _rmsnorm_fwd(x2, w, eps)
    return y.view(x.shape)


# ------------------------------------------------------------------ #
# K2: causal GQA flash attention                                     #
# ------------------------------------------------------------------ #
class _FlashAttention(torch.autograd.Function):
    """K2 forward (with the log-sum-exp), K2-bwd backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse, o32 = _flash_fwd(q, k, v, causal, for_backward=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        _require_rows_aligned("flash_attention backward: dout", dout)
        fake = is_fake(q)
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o32, dout, lse,
                                              causal=ctx.causal,
                                              launch=not fake)
        if not fake:
            launches["flash_attention_bwd"] += 1
        _cost("flash_attention_bwd", flash_attention_bwd_flops(q, ctx.causal),
              (q, k, v, o32, dout, lse), (dq, dk, dv))
        return dq, dk, dv, None


def _flash_fwd(q, k, v, causal, for_backward=False):
    """K2 (or its fake, which launches nothing) and its cost."""
    fake = is_fake(q)
    got = flash_attention_cuda(q, k, v, causal=causal,
                               for_backward=for_backward, launch=not fake)
    if not fake:
        launches["flash_attention"] += 1
    _cost("flash_attention", flash_attention_flops(q, causal), (q, k, v),
          got if for_backward else (got,))
    return got


def _require_rows_aligned(what: str, *ts: torch.Tensor) -> None:
    """The bf16 kernels copy rows 16 bytes at a time: each row of each
    tensor must start on a 16-byte boundary (fp32 has no such rule)."""
    if ts[0].dtype != torch.bfloat16:
        return
    _require(all(rows_aligned(_ptr(t), bsh_strides(t), t.element_size())
                 for t in ts),
             f"{what}: each bf16 row must start on a {ROW_ALIGN}-byte "
             f"boundary (base address and batch, sequence, head strides)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA flash attention. q (B, H, S, D); k/v (B, KV, S, D);
    any strides with a unit stride on D (on the card in bf16, every row
    must also start on a 16-byte boundary). Returns (B, H, S, D)."""
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
    _require_rows_aligned("flash_attention: q, k, v", q, k, v)
    if _wants_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_fwd(q, k, v, causal)


# ------------------------------------------------------------------ #
# K4: SSD chunk scan                                                  #
# ------------------------------------------------------------------ #
def _ssd_fwd(x, dt, a32, b, c, q):
    if is_fake(x):
        bs, h, s, p = x.shape
        y = torch.empty((bs, s, h, p), dtype=x.dtype,
                        device=x.device).transpose(1, 2)
        state = torch.empty((bs, h, p, b.shape[-1]), dtype=torch.float32,
                            device=x.device)
    else:
        y, state = ssd_scan_cuda(x, dt, a32, b, c, q)
        launches["ssd_scan"] += 1
    _cost("ssd_scan", 0.0, (x, dt, a32, b, c), (y, state))
    return y, state


def _ssd_bwd(x, dt, a32, b, c, dy, d_final, q):
    """K4-bwd, or its fake: the launch's outputs and workspaces."""
    if not is_fake(x):
        got = ssd_scan_bwd_cuda(x, dt, a32, b, c, dy, d_final, q)
        launches["ssd_scan_bwd"] += 1
    else:
        bs, h, s, p = x.shape
        g, n = b.shape[1], b.shape[-1]
        dev = x.device
        hw = bwd_heads_per_block(x.dtype, bs, h, g, s, q)
        floats, doubles = bwd_workspace(x.dtype, bs, h, s, q, p, n, hw)
        ws = (torch.empty(floats, dtype=torch.float32, device=dev),
              torch.empty(doubles, dtype=torch.float64, device=dev))
        got = (torch.empty((bs, s, h, p), dtype=x.dtype,
                           device=dev).transpose(1, 2),
               torch.empty((bs, s, h), dtype=torch.float32,
                           device=dev).transpose(1, 2),
               torch.empty((h,), dtype=torch.float32, device=dev),
               *(torch.empty((bs, s, g, n), dtype=b.dtype,
                             device=dev).transpose(1, 2) for _ in range(2)))
        del ws
    _cost("ssd_scan_bwd", 0.0, (x, dt, a32, b, c, dy, d_final), got)
    return got


class _SSDScan(torch.autograd.Function):
    """K4 forward, K4-bwd backward; ``a32`` is a_log as contiguous fp32
    (the gradient goes back in a_log's dtype). An unused final state
    (the training path's) reaches the backward as None, not as zeros."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, q):
        a32 = a_log.float().contiguous()
        ctx.save_for_backward(x, dt, a32, b, c)
        ctx.q, ctx.a_dtype = q, a_log.dtype
        ctx.set_materialize_grads(False)
        return _ssd_fwd(x, dt, a32, b, c, q)

    @staticmethod
    def backward(ctx, dy, d_final):
        x, dt, a32, b, c = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        # K4-bwd's fp32 route reads dy elementwise; its bf16 route copies
        # dy's rows 16 bytes at a time, so a misaligned dy is copied first
        if dy.stride(-1) != 1 or (dy.dtype == torch.bfloat16 and not
                                  rows_aligned(_ptr(dy), bsh_strides(dy),
                                               dy.element_size())):
            dy = dy.clone(memory_format=torch.contiguous_format)
        if d_final is not None:
            d_final = d_final.float().contiguous()
        dx, ddt, da_log, db, dc = _ssd_bwd(x, dt, a32, b, c, dy, d_final,
                                           ctx.q)
        return dx, ddt, da_log.to(ctx.a_dtype), db, dc, None


def _check_ssd_card(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, q: int) -> None:
    """What the K4 kernel takes beyond :func:`ssd_scan`'s shape rules:
    dtypes, P and N, the chunk, unit strides on P and N and, in bf16, rows
    on 16-byte boundaries (its asynchronous copies)."""
    p, n = x.shape[-1], b.shape[-1]
    _require(x.dtype in SSD_DTYPES, f"ssd_scan: dtype {x.dtype}")
    _require(dt.dtype == torch.float32, f"ssd_scan: dt dtype {dt.dtype}")
    _require(p in SSD_HEAD_DIMS, f"ssd_scan: head dim {p} not in "
                                 f"{SSD_HEAD_DIMS}")
    _require(n in STATE_DIMS, f"ssd_scan: state dim {n} not in {STATE_DIMS}")
    _require(q <= MAX_CHUNK, f"ssd_scan: chunk {q} > {MAX_CHUNK}")
    _require(all(t.stride(-1) == 1 for t in (x, b, c)),
             "ssd_scan: P and N must have unit stride")
    _require_rows_aligned("ssd_scan: x, b, c", x, b, c)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD chunk scan. x (B, H, S, P); dt (B, H, S); a_log (H,); b/c
    (B, G, S, N) with H % G == 0; chunks of ``min(chunk, S)`` tokens,
    which must divide S. Any strides with a unit stride on P and N (on
    the card in bf16, every row of x, b and c must also start on a
    16-byte boundary).
    Returns (y (B, H, S, P) in x's dtype, final state (B, H, P, N)
    fp32)."""
    _require(x.dim() == 4 and dt.dim() == 3 and b.dim() == 4
             and c.dim() == 4 and a_log.dim() == 1,
             "ssd_scan: x, b, c must be 4-d, dt 3-d, a_log 1-d")
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    _require(tuple(dt.shape) == (bs, h, s) and tuple(a_log.shape) == (h,),
             f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
             f"{tuple(a_log.shape)}")
    _require(tuple(b.shape) == (bs, g, s, n) and c.shape == b.shape,
             f"ssd_scan: x {tuple(x.shape)}, b {tuple(b.shape)}, c "
             f"{tuple(c.shape)}")
    _require(g > 0 and h % g == 0,
             f"ssd_scan: groups need H % G == 0, got {h} % {g}")
    _require(all(t.device == x.device for t in (dt, a_log, b, c)),
             "ssd_scan: inputs on different devices")
    _require(b.dtype == x.dtype and c.dtype == x.dtype,
             f"ssd_scan: x {x.dtype}, b {b.dtype}, c {c.dtype}")
    _require(s > 0, "ssd_scan: empty sequence")
    q = min(chunk, s)
    _require(q > 0 and s % q == 0, f"ssd_scan: seq {s} % chunk {q} != 0")
    if not on_cuda(x):
        return ssd_scan_ref(x, dt, -torch.exp(a_log.float()), b, c, q)
    _check_ssd_card(x, dt, b, c, q)
    if _wants_grad(x, dt, a_log, b, c):
        return _SSDScan.apply(x, dt, a_log, b, c, q)
    return _ssd_fwd(x, dt, a_log.float().contiguous(), b, c, q)


# ------------------------------------------------------------------ #
# K3a + K3b: int8 error-feedback quantization                        #
# ------------------------------------------------------------------ #
def int8_ef_quantize(grad: torch.Tensor, error: torch.Tensor, *,
                     out_err: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Int8 EF quantization of ``grad + error`` (the compressed sync's hot
    path). Returns ``(q int8, scale fp32 0-d, new_error fp32)``; on the
    card the residual goes to ``out_err`` when given (it may be
    ``error`` itself, for an in-place update), and the scale stays on
    the device."""
    _require(error.shape == grad.shape,
             f"int8_ef: grad {tuple(grad.shape)}, error "
             f"{tuple(error.shape)}")
    _require(error.device == grad.device,
             "int8_ef: grad and error on different devices")
    if not on_cuda(grad):
        q, scale, err = int8_ef_ref(grad, error)
        if out_err is not None:
            out_err.copy_(err)
            err = out_err
        return q, scale, err
    _require(grad.dtype in GRAD_DTYPES, f"int8_ef: grad dtype {grad.dtype}")
    _require(error.dtype == torch.float32,
             f"int8_ef: error dtype {error.dtype}")
    _require(grad.is_contiguous() and error.is_contiguous(),
             "int8_ef: grad and error must be contiguous")
    if out_err is not None:
        _require(out_err.dtype == torch.float32 and out_err.is_contiguous()
                 and out_err.shape == grad.shape
                 and out_err.device == grad.device,
                 "int8_ef: out_err must be a contiguous fp32 tensor of "
                 "grad's shape on its device")
    if is_fake(grad):
        q = torch.empty(grad.shape, dtype=torch.int8, device=grad.device)
        scale = torch.empty((), dtype=torch.float32, device=grad.device)
        err = torch.empty_like(error) if out_err is None else out_err
    else:
        q, scale, err = int8_ef_cuda(grad, error, out_err)
        launches["int8_ef_absmax"] += 1
        launches["int8_ef_quantize"] += 1
    _cost("int8_ef_quantize", 0.0, (grad, error), (q, scale, err))
    return q, scale, err
