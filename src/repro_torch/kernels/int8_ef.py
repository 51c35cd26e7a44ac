"""Int8 error-feedback quantization: the CUDA kernels' binding (K3a, the
absmax pass; K3b, the quantize pass) and their plain PyTorch version.

Replaces the Pallas TPU kernels of ``src/repro/kernels/int8_ef.py``
(``int8_ef_absmax_kernel`` and ``int8_ef_quantize_kernel``, reached
through ``int8_ef_pallas``). The kernels themselves, with the note on
what bounds them on this card and what their design does about that,
are ``csrc/int8_ef.cu``; compiled for ``sm_90a`` at first use
(:mod:`._build`) and called through ``ctypes`` on PyTorch's current
stream.

Both versions compute ``src/repro/kernels/ref.py::int8_ef_ref``: for
``x = grad + error`` in fp32, ``scale = max|x| / 127``, ``q =
clip(round_half_even(x / safe), -127, 127)`` with ``safe = 1`` where
``scale == 0``, and the residual ``x - q * scale``, so that
``q * scale + residual == grad + error`` exactly. The kernels' ``q``,
``scale`` and residual are bit-identical to the plain version, and a NaN
or an infinity in ``x`` comes out as there: a NaN or infinite scale, NaN
residuals, and code 0 where ``x / safe`` is NaN.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_ef_ref", "int8_ef_absmax_ref", "int8_ef_quantize_ref",
           "int8_ef_cuda", "int8_ef_absmax_cuda", "int8_ef_quantize_cuda",
           "GRAD_DTYPES"]

GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FNS = None


def int8_ef_absmax_ref(grad: torch.Tensor,
                       error: torch.Tensor) -> torch.Tensor:
    """The plain version of K3a: ``max |grad + error|``, fp32 0-d."""
    return (grad.float() + error.float()).abs().max()


def int8_ef_quantize_ref(grad: torch.Tensor, error: torch.Tensor,
                         amax: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of K3b, given K3a's maximum."""
    x = grad.float() + error.float()
    # a device tensor, not a Python number, as the divisor: PyTorch's CUDA
    # division by a host scalar multiplies by its reciprocal instead (made
    # on the device: a copy from the host would wait for the stream)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe), -127.0, 127.0).to(torch.int8)
    return q, scale, x - q.float() * scale


def int8_ef_ref(grad: torch.Tensor, error: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version (the JAX package's ``int8_ef_ref``), op by op in
    fp32. Returns ``(q int8, scale fp32 0-d, new_error fp32)``."""
    return int8_ef_quantize_ref(grad, error,
                                int8_ef_absmax_ref(grad, error))


def _fns():
    global _FNS
    if _FNS is None:
        lib = _build.load("int8_ef")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        absmax, quantize = lib.int8_ef_absmax, lib.int8_ef_quantize
        absmax.argtypes = [vp, i32, vp, i64, vp, vp]
        quantize.argtypes = [vp, i32, vp, i64, vp, vp, vp, vp, vp]
        absmax.restype = quantize.restype = ctypes.c_int
        _FNS = (absmax, quantize)
    return _FNS


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def int8_ef_absmax_cuda(grad: torch.Tensor,
                        error: torch.Tensor) -> torch.Tensor:
    """Launch K3a: the bits of ``max |grad + error|`` as a 1-element
    int32 tensor on the device."""
    absmax, _ = _fns()
    amax = torch.empty((1,), dtype=torch.int32, device=grad.device)
    _check(absmax(grad.data_ptr(), GRAD_DTYPES[grad.dtype],
                  error.data_ptr(), grad.numel(), amax.data_ptr(),
                  torch.cuda.current_stream(grad.device).cuda_stream),
           "int8_ef_absmax")
    return amax


def int8_ef_quantize_cuda(grad: torch.Tensor, error: torch.Tensor,
                          amax: torch.Tensor,
                          out_err: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K3b given K3a's ``amax``: ``(q, scale, residual)``."""
    _, quantize = _fns()
    dev = grad.device
    scale = torch.empty((), dtype=torch.float32, device=dev)
    q = torch.empty(grad.shape, dtype=torch.int8, device=dev)
    err = torch.empty_like(error) if out_err is None else out_err
    _check(quantize(grad.data_ptr(), GRAD_DTYPES[grad.dtype],
                    error.data_ptr(), grad.numel(), amax.data_ptr(),
                    q.data_ptr(), err.data_ptr(), scale.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream),
           "int8_ef_quantize")
    return q, scale, err


def int8_ef_cuda(grad: torch.Tensor, error: torch.Tensor,
                 out_err: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K3a then K3b on one CUDA device: ``grad`` (fp32 or bf16)
    and ``error`` (fp32) contiguous, of one shape. The residual goes to
    ``out_err`` (fp32, contiguous; may be ``error`` itself, for an
    in-place update) or to a new tensor. The scale stays on the device:
    no host sync between the passes. The caller checks the inputs."""
    return int8_ef_quantize_cuda(grad, error,
                                 int8_ef_absmax_cuda(grad, error), out_err)
