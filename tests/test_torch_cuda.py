"""The port's Hopper kernels on the card, against their plain versions.

Needs a CUDA card and imports no jax, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode).
Tolerances: fp32 1e-5 (summation order); bf16 outputs may land one bf16
ulp apart (fp32 math in another order, then one rounding).
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.rmsnorm import rmsnorm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Triton and CUDA kernels have "
                    "no CPU mode")
    ops.reset_launches()
    return torch.device("cuda")


def _tol(dtype, scale=4.0):
    return (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
            else dict(atol=2 ** -7 * scale, rtol=0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 2048), (37, 2048), (8, 96)])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(rows)
    x = (torch.randn((2, rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = torch.rand((d,), generator=gen, device=dev) + 0.5
    y = ops.rmsnorm(x, w)
    ref = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert ops.launches["rmsnorm"] == 1
    torch.testing.assert_close(y.float(), ref.float(),
                               **_tol(dtype, ref.abs().max().item()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kv,s,d,causal", [
    (16, 2, 128, 128, True),     # the qwen2.5-3b prefill
    (16, 2, 200, 128, True),     # ragged last tile
    (8, 8, 1, 64, True),         # one token
    (8, 1, 65, 64, True),        # group 8, one row past a tile
    (4, 2, 100, 128, False),     # not causal
])
def test_flash_attention_kernel_matches_plain(dev, h, kv, s, d, causal,
                                              dtype):
    gen = torch.Generator(device=dev).manual_seed(s)
    # the model's (B, S, H, D) layout, passed transposed
    q = torch.randn((2, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((2, s, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((2, s, kv, d), generator=gen, device=dev).to(dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    out = ops.flash_attention(*args, causal=causal)
    ref = flash_attention_ref(*args, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (2, h, s, d)
    assert ops.launches["flash_attention"] == 1
    torch.testing.assert_close(out.float(), ref.float(), **_tol(dtype))


def test_flash_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 2, 8, 16), device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 256), device=dev)[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ops.flash_attention(q, q, q)
    assert ops.launches["flash_attention"] == 0

