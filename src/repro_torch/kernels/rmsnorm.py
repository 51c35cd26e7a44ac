"""RMSNorm for Hopper, forward (K1, CUDA) and backward (K1-bwd, Triton),
beside its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::
rmsnorm_kernel`` (reached through ``rmsnorm_pallas``): per row
``y = x * rsqrt(mean(x^2) + eps) * w`` with fp32 math, stored in
``x.dtype``. The JAX package differentiates its plain RMSNorm, so the
backward has no Pallas counterpart; its plain version is autograd
through :func:`rmsnorm_ref`. With ``rstd = rsqrt(mean(x^2) + eps)``,
``xhat = x * rstd`` and ``g = dy * w`` in fp32, the backward is
``dx = rstd * (g - xhat * mean(g * xhat))`` in ``x.dtype`` and
``dw = sum_rows dy * xhat`` in fp32.

Both are bound by bytes: each element is read once and written once
(plus the fp32 weight row) for a few flops, far below the ~295 flops per
byte at which the H100's arithmetic would become the limit.

The forward is ``csrc/rmsnorm.cu`` (the note there says what bounds it
and what its design does about that), compiled for ``sm_90a`` at first
use (:mod:`._build`) and called through ``ctypes`` on PyTorch's current
stream: one C call per launch, its argument types set once. It has two
routes, picked here by :func:`rmsnorm_route`: a block per row with the
row in registers (16-byte loads; rows of at most ``VECTOR_ROW_BYTES``),
and a scalar warp per row for anything the 16-byte loads cannot take.

The backward is two Triton launches. The row pass gives each of about
two programs per SM a run of consecutive rows: it recomputes ``rstd``
from x (nothing is saved by the forward), writes dx, and keeps its rows'
share of dw in registers, writing one fp32 partial row at the end (about
2 MB at 2,048 rows of 2,048, which stays in the L2 cache). Each
iteration loads the next row's x and dy before it computes on this one,
so a row's loads are in flight while the last one is reduced. The dw
pass sums the partial rows over many programs, each a strip of
``DW_COLS`` columns that loads ``[DW_ROWS, DW_COLS]`` tiles of partials
and reduces them along the rows once at the end. There are no atomics
and every sum has a fixed order, so dw is the same bits on every call.

``triton`` is imported and the CUDA library built when a kernel is first
launched, never at import: the CPU tests import this module where
neither exists.
"""
import ctypes

import torch

from . import _build

__all__ = ["rmsnorm_ref", "rmsnorm_cuda", "rmsnorm_route",
           "rmsnorm_bwd_triton", "rmsnorm_bwd_rows", "rmsnorm_bwd_dw",
           "DTYPES"]

#: the dtype codes of ``csrc/rmsnorm.cu``
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: its routes: a block per row with the row in registers, a scalar warp
#: per row
VECTOR, SCALAR = 0, 1
#: the widest row (bytes) of the vector route: 1,024 threads of up to four
#: 16-byte chunks each
VECTOR_ROW_BYTES = 64 * 1024

# bound to ``triton.language`` by _bwd_kernels(); the kernel bodies read it
# as a module global when Triton compiles them
tl = None
_FN = None
_BWD_KERNELS = None


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """The plain version: fp32 math, cast back to ``x.dtype``."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w.float()).to(x.dtype)


def rmsnorm_route(x_ptr: int, w_ptr: int, y_ptr: int, d: int,
                  elem_size: int) -> int:
    """The route of ``csrc/rmsnorm.cu`` for a contiguous (rows, d) x of
    ``elem_size``-byte elements: the 16-byte vector route needs every row
    of x and y, and w, on 16-byte boundaries (a row of a multiple of 16
    bytes, and all three base addresses on one) and rows of at most
    ``VECTOR_ROW_BYTES``, else :data:`SCALAR`."""
    row = d * elem_size
    if row % 16 or (x_ptr | w_ptr | y_ptr) % 16 or row > VECTOR_ROW_BYTES:
        return SCALAR
    return VECTOR


def _fn():
    global _FN
    if _FN is None:
        fn = _build.load("rmsnorm").rmsnorm_fwd
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def rmsnorm_cuda(x2: torch.Tensor, w: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Launch K1 on ``x2`` (rows, D), contiguous, and ``w`` (D,) fp32
    contiguous, both on one CUDA device. The caller checks the inputs;
    raises if the launch fails."""
    rows, d = x2.shape
    y = torch.empty_like(x2)
    xp, wp, yp = x2.data_ptr(), w.data_ptr(), y.data_ptr()
    err = _fn()(xp, wp, yp, rows, d, DTYPES[x2.dtype],
                rmsnorm_route(xp, wp, yp, d, x2.element_size()), eps,
                torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: cudaError {err}")
    return y


#: row-pass programs per SM, and the dw pass's tile of partial rows
PROGRAMS_PER_SM = 2
DW_ROWS, DW_COLS = 64, 16


def _bwd_kernels():
    global _BWD_KERNELS, tl
    if _BWD_KERNELS is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_bwd_kernel(x_ptr, w_ptr, dy_ptr, dx_ptr, dwp_ptr, rows,
                               rows_per_prog, stride_x, stride_dy,
                               stride_dx, d, eps, BLOCK: tl.constexpr):
            pid = tl.program_id(0)
            cols = tl.arange(0, BLOCK)
            mask = cols < d
            w = tl.load(w_ptr + cols, mask=mask, other=0.0)
            dw = tl.zeros([BLOCK], dtype=tl.float32)
            row0 = pid * rows_per_prog
            end = tl.minimum(row0 + rows_per_prog, rows)
            x = tl.load(x_ptr + row0 * stride_x + cols, mask=mask, other=0.0)
            dy = tl.load(dy_ptr + row0 * stride_dy + cols, mask=mask,
                         other=0.0)
            for row in range(row0, end):
                # the next row's loads go out before this row's reductions
                more = mask & (row + 1 < end)
                x_next = tl.load(x_ptr + (row + 1) * stride_x + cols,
                                 mask=more, other=0.0)
                dy_next = tl.load(dy_ptr + (row + 1) * stride_dy + cols,
                                  mask=more, other=0.0)
                xf = x.to(tl.float32)
                dyf = dy.to(tl.float32)
                rstd = tl.rsqrt(tl.sum(xf * xf, axis=0) / d + eps)
                xhat = xf * rstd
                g = dyf * w
                c = tl.sum(g * xhat, axis=0) / d
                dx = rstd * (g - xhat * c)
                tl.store(dx_ptr + row * stride_dx + cols,
                         dx.to(dx_ptr.dtype.element_ty), mask=mask)
                dw += dyf * xhat
                x = x_next
                dy = dy_next
            tl.store(dwp_ptr + pid * d + cols, dw, mask=mask)

        @triton.jit
        def rmsnorm_dw_kernel(dwp_ptr, dw_ptr, n_prog, d,
                              BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr):
            cols = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
            cmask = cols < d
            acc = tl.zeros([BLOCK_M, BLOCK_N], dtype=tl.float32)
            for m0 in range(0, n_prog, BLOCK_M):
                r = m0 + tl.arange(0, BLOCK_M)
                acc += tl.load(dwp_ptr + r[:, None] * d + cols[None, :],
                               mask=(r[:, None] < n_prog) & cmask[None, :],
                               other=0.0)
            tl.store(dw_ptr + cols, tl.sum(acc, axis=0), mask=cmask)

        _BWD_KERNELS = (rmsnorm_bwd_kernel, rmsnorm_dw_kernel)
    return _BWD_KERNELS


def bwd_programs(rows: int, sms: int) -> tuple[int, int]:
    """``(rows a program, programs)`` of the row pass over ``rows`` rows
    on a card of ``sms`` SMs."""
    per = -(-rows // min(rows, PROGRAMS_PER_SM * sms))
    return per, -(-rows // per)


def rmsnorm_bwd_rows(x2: torch.Tensor, w: torch.Tensor, dy2: torch.Tensor,
                     eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward's row pass: ``(dx, partial)``, with one fp32 row of
    dw's partial sums per program."""
    import triton

    rows, d = x2.shape
    block = triton.next_power_of_2(d)
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    per, n_prog = bwd_programs(rows, sms)
    dx = torch.empty_like(x2)
    partial = torch.empty((n_prog, d), dtype=torch.float32, device=x2.device)
    _bwd_kernels()[0][(n_prog,)](
        x2, w, dy2, dx, partial, rows, per, x2.stride(0), dy2.stride(0),
        dx.stride(0), d, eps, BLOCK=block,
        num_warps=min(max(block // 256, 1), 16))
    return dx, partial


def rmsnorm_bwd_dw(partial: torch.Tensor) -> torch.Tensor:
    """The backward's dw pass: the column sums of ``partial``, fp32."""
    import triton

    n_prog, d = partial.shape
    dw = torch.empty((d,), dtype=torch.float32, device=partial.device)
    _bwd_kernels()[1][(triton.cdiv(d, DW_COLS),)](
        partial, dw, n_prog, d, BLOCK_M=DW_ROWS, BLOCK_N=DW_COLS,
        num_warps=4)
    return dw


def rmsnorm_bwd_triton(x2: torch.Tensor, w: torch.Tensor, dy2: torch.Tensor,
                       eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward on ``x2`` and ``dy2`` (rows, D), rows
    contiguous, and ``w`` (D,) fp32, all on one CUDA device. Returns
    ``(dx (rows, D) in x's dtype, dw (D,) fp32)``. The caller checks the
    inputs."""
    dx, partial = rmsnorm_bwd_rows(x2, w, dy2, eps)
    return dx, rmsnorm_bwd_dw(partial)
