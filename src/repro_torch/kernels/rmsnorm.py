"""RMSNorm for Hopper in Triton, beside its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/rmsnorm.py::
rmsnorm_kernel`` (reached through ``rmsnorm_pallas``): per row
``y = x * rsqrt(mean(x^2) + eps) * w`` with fp32 math, stored in
``x.dtype``.

What bounds it on this card: bytes. Each element is read once and
written once (plus the fp32 weight row) for about four flops, far below
the ~295 flops per byte at which the H100's arithmetic would become the
limit.

What the design does about that: one program per row, the whole row in
one block of ``next_pow2(D)`` lanes (masked), so the row is read from
device memory once, squared, summed and scaled in registers, and written
once — no second pass and no intermediate in device memory. D = 2048 for
qwen2.5-3b is one block of 2048 lanes over 8 warps.

``triton`` is imported when the kernel is first launched, never at
import: the CPU tests import this module where no ``triton`` exists.
"""
import torch

__all__ = ["rmsnorm_ref", "rmsnorm_triton"]

# bound to ``triton.language`` by _kernel(); the kernel body reads it as a
# module global when Triton compiles it
tl = None
_KERNEL = None


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """The plain version: fp32 math, cast back to ``x.dtype``."""
    xf = x.float()
    scale = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale * w.float()).to(x.dtype)


def _kernel():
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rmsnorm_kernel(x_ptr, w_ptr, y_ptr, stride_x, stride_y, d, eps,
                           BLOCK: tl.constexpr):
            row = tl.program_id(0)
            cols = tl.arange(0, BLOCK)
            mask = cols < d
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / d
            w = tl.load(w_ptr + cols, mask=mask, other=0.0)
            y = x * tl.rsqrt(var + eps) * w
            tl.store(y_ptr + row * stride_y + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        _KERNEL = rmsnorm_kernel
    return _KERNEL


def rmsnorm_triton(x2: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch the kernel on ``x2`` (rows, D), rows contiguous, and ``w``
    (D,) fp32, both on one CUDA device. The caller checks the inputs."""
    import triton

    rows, d = x2.shape
    y = torch.empty_like(x2)
    block = triton.next_power_of_2(d)
    num_warps = min(max(block // 256, 1), 16)
    _kernel()[(rows,)](x2, w, y, x2.stride(0), y.stride(0), d, eps,
                       BLOCK=block, num_warps=num_warps)
    return y
