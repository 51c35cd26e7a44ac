"""The port's int8 error-feedback quantization (the plain version of K3a
and K3b, which the CPU runs) against the JAX package, on the same numpy
inputs.

Tolerances: ``q`` and ``scale`` bit-identical to ``int8_ef_ref`` and to
the Pallas kernel in interpret mode; the residual bit-identical to the
op-by-op reference, and within one fp32 ulp of the dequantized value
against the interpret kernel (its ``x - q * scale`` may be contracted
into an FMA, ``src/repro/kernels/int8_ef.py:17-26``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import int8_ef_quantize as jax_kernel
from repro.kernels.ref import int8_ef_ref as jax_ref
from repro_torch.dist import compress_grad_int8, decompress_grad_int8
from repro_torch.kernels import ops
from repro_torch.kernels.int8_ef import int8_ef_ref

CASES = [
    ((1_000_003,), "float32", False),     # ragged: no (256, 128) tiles
    ((4099,), "bfloat16", False),
    ((37, 130), "float32", False),
    ((3, 5, 7), "bfloat16", False),
    ((2048,), "float32", True),           # all zero: scale 0, safe 1
]


def _inputs(shape, dtype, zero, seed=0):
    rng = np.random.default_rng(seed)
    if zero:
        g = np.zeros(shape, np.float32)
        e = np.zeros(shape, np.float32)
    else:
        g = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
        e = (rng.standard_normal(shape) * 1e-4).astype(np.float32)
    gj = jnp.asarray(g, getattr(jnp, dtype))
    gt = torch.from_numpy(np.array(gj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return gj, jnp.asarray(e), gt, torch.from_numpy(e.copy())


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                   np.float32)
    return a.view(np.uint32)


@pytest.mark.parametrize("shape,dtype,zero", CASES)
def test_plain_version_matches_int8_ef_ref_bit_for_bit(shape, dtype, zero):
    gj, ej, gt, et = _inputs(shape, dtype, zero)
    q, scale, err = jax_ref(gj, ej)
    qt, st, errt = int8_ef_ref(gt, et)
    assert qt.dtype == torch.int8 and qt.shape == gt.shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(q))
    np.testing.assert_array_equal(_bits(st), _bits(scale))
    np.testing.assert_array_equal(_bits(errt), _bits(err))
    if zero:
        assert float(st) == 0.0 and not qt.any() and not errt.any()


@pytest.mark.parametrize("shape,dtype,zero", CASES)
def test_plain_version_matches_the_interpret_kernel(shape, dtype, zero):
    gj, ej, gt, et = _inputs(shape, dtype, zero, seed=1)
    q, scale, err = jax_kernel(gj, ej, interpret=True)
    qt, st, errt = int8_ef_ref(gt, et)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(q))
    np.testing.assert_array_equal(_bits(st), _bits(scale))
    deq = np.abs(qt.numpy().astype(np.float32) * st.numpy())
    assert np.all(np.abs(errt.numpy() - np.asarray(err))
                  <= np.spacing(deq.astype(np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_nan_and_inf_come_out_as_in_the_reference(bad, dtype):
    """A NaN or an infinity in the gradient: a NaN or infinite scale, NaN
    residuals and code 0 where ``x / safe`` is NaN, as ``int8_ef_ref``
    and the interpret kernel give them (the CUDA kernel is held to the
    same plain version on the card)."""
    gj, ej, gt, et = _inputs((4099,), dtype, False, seed=4)
    gj = gj.at[17].set(bad).at[4000].set(bad)
    gt = gt.clone()
    gt[[17, 4000]] = bad
    qt, st, errt = int8_ef_ref(gt, et)
    for q, scale, err in (jax_ref(gj, ej), jax_kernel(gj, ej, interpret=True)):
        np.testing.assert_array_equal(qt.numpy(), np.asarray(q))
        np.testing.assert_array_equal(st.numpy(), np.asarray(scale))
        np.testing.assert_array_equal(errt.numpy(), np.asarray(err))
    assert np.isnan(errt.numpy()).all()
    assert not np.isfinite(float(st)) and int(qt[17]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_error_feedback_invariant_and_in_place_residual(dtype):
    """``q * scale + new_error == grad + error`` exactly, and the wrapper
    writes the residual into ``out_err`` (the sync's in-place update)."""
    rng = np.random.default_rng(2)
    g = torch.from_numpy(rng.standard_normal(5000).astype(np.float32)).to(
        dtype)
    e = torch.from_numpy(rng.standard_normal(5000).astype(np.float32)
                         * 1e-3)
    want = g.float() + e
    q, scale, err = compress_grad_int8(g, e, out_err=e)
    assert err is e
    torch.testing.assert_close(decompress_grad_int8(q, scale) + e, want,
                               rtol=0, atol=0)
    assert int(q.abs().max()) == 127
    with pytest.raises(ValueError, match="int8_ef: grad"):
        ops.int8_ef_quantize(g, e[:10])


def test_error_feedback_converges_over_steps():
    """With the residual carried, the cumulative transmitted signal
    tracks the cumulative gradient within one quantization step."""
    rng = np.random.default_rng(3)
    err = torch.zeros(1000)
    sent = torch.zeros(1000)
    total = torch.zeros(1000)
    for _ in range(20):
        g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        q, scale, err = compress_grad_int8(g, err)
        sent += decompress_grad_int8(q, scale)
        total += g
        assert float((total - sent).abs().max()) <= float(scale) / 2 + 1e-6
