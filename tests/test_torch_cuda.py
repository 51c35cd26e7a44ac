"""The port's Hopper kernels on the card, against their plain versions.

Needs a CUDA card and imports no jax, so it runs on a GPU machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the kernels have no CPU mode).
Tolerances: fp32 1e-5 (summation order); bf16 outputs may land one bf16
ulp apart (fp32 math in another order, then one rounding); K1 in bf16
and fp16 also within one ulp of its type at each row's largest |ref|.
K2 and K2-bwd take two routes by dtype: bf16 on the tensor cores (P
split into two bf16 parts in the forward; P and dS rounded to bf16 once
in the backward), fp32 on the CUDA cores. Backwards:
K1-bwd dx within one bf16 ulp of each row's largest |ref| (fp32 1e-5),
dw within 1e-5 relative; K2-bwd fp32 within 1e-4 x max|ref| per tensor,
bf16 within 2 bf16 ulps of each row's largest |ref|. K3a/K3b: q, scale
and the residual bit-identical to the plain version (a NaN equal to a NaN
in the same place, whatever its payload). K4: y within 1e-5 of each
row's largest |ref| in fp32 (summation order) and one bf16 ulp of it in
bf16 (the tensor cores' fp32 sums of products whose fp32 operands enter
as bf16 parts, then one rounding); the final state within 1e-5 of its
largest |ref| (fp32 in both). K1, K1-bwd, K2 and K4 in bf16 give the
same bits on repeated calls.
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.int8_ef import int8_ef_ref
from repro_torch.kernels.rmsnorm import SCALAR, rmsnorm_ref, rmsnorm_route
from repro_torch.kernels.ssd_scan import ssd_scan_ref

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


def _row_ulps(out, ref, unit: float = 2.0 ** -7) -> float:
    """Largest error of a row (last axis) in units of ``unit`` times the
    row's largest |ref| (by default bf16 ulps)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs().amax(-1)
    return (err / (unit * r.abs().amax(-1)).clamp_min(1e-30)).max().item()


#: K1's gate in bf16 and fp16, beside ``_tol``'s: within one ulp of the
#: output type at each row's largest |ref| (fp32 math in another order,
#: then one rounding)
RMSNORM_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _check_rmsnorm(y, ref, dtype) -> None:
    torch.testing.assert_close(y.float(), ref.float(),
                               **_tol(dtype, ref.abs().max().item()))
    if dtype != torch.float32:
        assert _row_ulps(y, ref, RMSNORM_ULP[dtype]) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [8, 96, 2048, 2050, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 8, 511, 2048])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, dtype):
    """Both routes: a block per row (rows of up to 64 KB), the scalar
    route (D 2050: rows off 16-byte boundaries)."""
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = torch.rand((d,), generator=gen, device=dev) + 0.5
    y = ops.rmsnorm(x, w)
    ref = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert ops.launches["rmsnorm"] == 1
    assert torch.isfinite(y).all()
    _check_rmsnorm(y, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_takes_any_storage_offset(dev, dtype):
    """A contiguous x one element into its storage (2 bytes in bf16) and
    a w 4 bytes into its own: no row on a 16-byte boundary, so the
    scalar route, with the same gate."""
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(1 + 2 * 8 * 2048, generator=gen, device=dev).to(
        dtype)[1:].view(2, 8, 2048)
    w = (torch.rand(1 + 2048, generator=gen, device=dev) + 0.5)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 and w.data_ptr() % 16
    assert rmsnorm_route(x.data_ptr(), w.data_ptr(), 0, 2048,
                         x.element_size()) == SCALAR
    y = ops.rmsnorm(x, w)
    ref = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == 1
    _check_rmsnorm(y, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(3, 16384), (2, 32768), (2, 40000)])
def test_rmsnorm_kernel_matches_plain_on_wide_rows(dev, rows, d, dtype):
    """Rows of two and four chunks a thread (bf16 16,384 and 32,768; fp32
    16,384) and rows past the vector route's 64 KB (the scalar route)."""
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=dev) * 3).to(dtype)
    w = torch.rand((d,), generator=gen, device=dev) + 0.5
    y = ops.rmsnorm(x, w)
    ref = rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == 1
    _check_rmsnorm(y, ref, dtype)


@pytest.mark.parametrize("rows,d", [(2048, 2048), (8, 4096), (3, 16384),
                                    (2, 32768), (2, 40000), (5, 2050)])
def test_rmsnorm_kernel_gives_the_same_bits_every_call(dev, rows, d):
    """Fixed summation orders on every route (one, two and four chunks a
    thread; scalar for the last two here): two calls on the same bf16
    input give the same bits, one launch each."""
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn((rows, d), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.rand((d,), generator=gen, device=dev) + 0.5
    first, second = ops.rmsnorm(x, w), ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == 2
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal", [
    (2, 16, 2, 128, 128, True),     # the qwen2.5-3b prefill
    (2, 16, 2, 200, 128, True),     # ragged last tile
    (2, 16, 2, 63, 128, True),      # one short of a tile
    (2, 16, 2, 64, 128, True),      # one exact tile
    (2, 16, 2, 159, 128, True),     # ragged, three tiles
    (1, 16, 2, 512, 128, True),     # the longest prompt bucket
    (8, 16, 2, 256, 128, True),     # one training microbatch
    (2, 8, 8, 1, 64, True),         # one token
    (2, 8, 1, 65, 64, True),        # group 8, one row past a tile
    (2, 4, 2, 100, 128, False),     # not causal
])
def test_flash_attention_kernel_matches_plain(dev, b, h, kv, s, d, causal,
                                              dtype):
    gen = torch.Generator(device=dev).manual_seed(s)
    # the model's (B, S, H, D) layout, passed transposed
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kv, d), generator=gen, device=dev).to(dtype)
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    out = ops.flash_attention(*args, causal=causal)
    ref = flash_attention_ref(*args, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (b, h, s, d)
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


def test_flash_attention_rejects_misaligned_bf16_rows(dev):
    """The bf16 kernels copy rows 16 bytes at a time: a view whose rows
    do not start on 16-byte boundaries raises before any launch; fp32
    has no such rule."""
    # one element into its storage: every row on a 2-byte boundary
    buf = torch.zeros(2 * 8 * 4 * 128 + 1, dtype=torch.bfloat16, device=dev)
    q = buf[1:].view(2, 8, 4, 128).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, q[:, :2], q[:, :2])
    # rows 68 elements (136 bytes) apart
    q = torch.zeros((2, 8, 4, 68), dtype=torch.bfloat16,
                    device=dev)[..., :64].transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, q[:, :2], q[:, :2])
    k = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(k.transpose(1, 2), q[:, :2], k.transpose(1, 2))
    assert ops.launches["flash_attention"] == 0
    gen = torch.Generator(device=dev).manual_seed(9)
    buf = torch.randn(2 * 8 * 4 * 128 + 1, generator=gen, device=dev)
    qf = buf[1:].view(2, 8, 4, 128).transpose(1, 2)
    out = ops.flash_attention(qf, qf[:, :2], qf[:, :2])
    ref = flash_attention_ref(qf, qf[:, :2], qf[:, :2])
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 1
    torch.testing.assert_close(out, ref, **_tol(torch.float32))


def test_flash_attention_bf16_gives_the_same_bits_every_call(dev):
    """No atomics and fixed summation orders: two calls on the same bf16
    inputs give bit-identical outputs, and bit-identical dq, dk, dv."""
    gen = torch.Generator(device=dev).manual_seed(10)
    base = [torch.randn((8, 256, n, 128), generator=gen, device=dev).to(
        torch.bfloat16) for n in (16, 2, 2)]
    dout = torch.randn((8, 256, 16, 128), generator=gen, device=dev).to(
        torch.bfloat16).transpose(1, 2)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in base]
        out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves))
        out.backward(dout)
        runs.append([out.detach(), *(t.grad for t in leaves)])
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 2
    assert ops.launches["flash_attention_bwd"] == 2
    for first, second in zip(*runs):
        assert torch.equal(first.contiguous().view(torch.int16),
                           second.contiguous().view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [
    (37, 2048), (2048, 2048), (5, 96),
    (1, 2048),       # one row, one program
    (2047, 2048),    # a ragged last program
    (2048, 4096),    # the mamba2 gated norm's width
])
def test_rmsnorm_backward_kernel_matches_plain(dev, rows, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(rows + d)
    x0 = (torch.randn((rows, d), generator=gen, device=dev) * 2).to(dtype)
    w0 = torch.rand((d,), generator=gen, device=dev) + 0.5
    dy = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    ops.rmsnorm(x, w).backward(dy)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    rmsnorm_ref(xr, wr).backward(dy)
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm"] == 1 and ops.launches["rmsnorm_bwd"] == 1
    assert x.grad.dtype == dtype and w.grad.dtype == torch.float32
    if dtype == torch.bfloat16:
        assert _row_ulps(x.grad, xr.grad) <= 1.0
    else:
        torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-5)
    assert ((w.grad - wr.grad).abs().max()
            <= 1e-5 * wr.grad.abs().max())


def test_rmsnorm_backward_gives_the_same_bits_every_call(dev):
    """No atomics and fixed summation orders: two backward calls on the
    same inputs give bit-identical dx and dw."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x0 = torch.randn((2048, 2048), generator=gen, device=dev).to(
        torch.bfloat16)
    w0 = torch.rand((2048,), generator=gen, device=dev) + 0.5
    dy = torch.randn((2048, 2048), generator=gen, device=dev).to(
        torch.bfloat16)
    runs = []
    for _ in range(2):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        ops.rmsnorm(x, w).backward(dy)
        runs.append((x.grad, w.grad))
    torch.cuda.synchronize()
    assert ops.launches["rmsnorm_bwd"] == 2
    (dx1, dw1), (dx2, dw2) = runs
    assert torch.equal(dx1.view(torch.int16), dx2.view(torch.int16))
    assert torch.equal(dw1.view(torch.int32), dw2.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal", [
    (8, 16, 2, 256, 128, True),    # one qwen2.5-3b training microbatch
    (1, 16, 2, 200, 128, True),    # ragged last tile
    (1, 16, 2, 63, 128, True),     # one short of a tile
    (1, 16, 2, 64, 128, True),     # one exact tile
    (1, 16, 2, 159, 128, True),    # ragged, three tiles
    (1, 16, 2, 512, 128, True),    # the longest prompt bucket
    (2, 8, 1, 65, 64, True),       # group 8, one row past a tile
    (1, 4, 2, 100, 128, False),    # not causal
])
def test_flash_attention_backward_kernel_matches_plain(dev, b, h, kv, s, d,
                                                       causal, dtype):
    gen = torch.Generator(device=dev).manual_seed(s + d)
    base = [torch.randn((b, s, n, d), generator=gen, device=dev).to(dtype)
            for n in (h, kv, kv)]
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(
        dtype).transpose(1, 2)
    leaves = [t.clone().requires_grad_() for t in base]
    ops.flash_attention(*(t.transpose(1, 2) for t in leaves),
                        causal=causal).backward(dout)
    ref = [t.clone().requires_grad_() for t in base]
    flash_attention_ref(*(t.transpose(1, 2) for t in ref),
                        causal=causal).backward(dout)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 1
    for got, want in zip(leaves, ref):
        assert got.grad.dtype == dtype
        if dtype == torch.bfloat16:
            assert _row_ulps(got.grad, want.grad) <= 2.0
        else:
            assert ((got.grad - want.grad).abs().max()
                    <= 1e-4 * want.grad.abs().max())


def test_serving_forward_needs_no_backward_state(dev):
    """Without a gradient to record, K1 and K2 run forward only."""
    x = torch.randn((4, 64, 2, 64), device=dev)
    with torch.no_grad():
        ops.flash_attention(x, x[:, :1], x[:, :1])
    assert ops.launches["flash_attention"] == 1
    assert ops.launches["flash_attention_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 255, 256 * 128 + 1, 1_000_003])
def test_int8_ef_kernels_are_bit_identical_to_plain(dev, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(n)
    g = (torch.randn(n, generator=gen, device=dev) * 1e-3).to(dtype)
    e = torch.randn(n, generator=gen, device=dev) * 1e-5
    q_ref, s_ref, err_ref = int8_ef_ref(g, e)
    q, scale, err = ops.int8_ef_quantize(g, e, out_err=e)
    torch.cuda.synchronize()
    assert err is e
    assert ops.launches["int8_ef_absmax"] == 1
    assert ops.launches["int8_ef_quantize"] == 1
    assert torch.equal(q, q_ref)
    assert torch.equal(scale.view(torch.int32), s_ref.view(torch.int32))
    assert torch.equal(err.view(torch.int32), err_ref.view(torch.int32))


def _same_bits(a, b) -> bool:
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(
        a.masked_fill(nan, 0).view(torch.int32),
        b.masked_fill(nan, 0).view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_int8_ef_kernels_keep_nan_and_inf_as_plain(dev, bad, dtype):
    gen = torch.Generator(device=dev).manual_seed(3)
    g = (torch.randn(1_000_003, generator=gen, device=dev) * 1e-3).to(dtype)
    g[[17, 999_999]] = bad
    e = torch.randn(g.numel(), generator=gen, device=dev) * 1e-5
    q_ref, s_ref, err_ref = int8_ef_ref(g, e)
    q, scale, err = ops.int8_ef_quantize(g, e)
    torch.cuda.synchronize()
    assert torch.equal(q, q_ref) and int(q[17]) == 0
    assert _same_bits(scale, s_ref) and not scale.isfinite()
    assert _same_bits(err, err_ref) and err.isnan().all()


def test_int8_ef_all_zero_and_what_the_kernels_do_not_take(dev):
    z = torch.zeros(1000, device=dev)
    q, scale, err = ops.int8_ef_quantize(z, z.clone())
    assert float(scale) == 0.0 and not q.any() and not err.any()
    with pytest.raises(ValueError, match="grad dtype"):
        ops.int8_ef_quantize(z.half(), z)
    with pytest.raises(ValueError, match="contiguous"):
        ops.int8_ef_quantize(z[::2], z[::2])


def _ssd_inputs(dev, b, h, g, s, p, n, dtype, seed=0):
    """The model's (B, S, H, P), (B, S, H) and (B, S, G, N) layouts,
    passed transposed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.099 + 0.001
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                   device=dev))
    bb = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    cc = torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
    return (x.transpose(1, 2), dt.transpose(1, 2), a_log,
            bb.transpose(1, 2), cc.transpose(1, 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,g,s,p,n,chunk", [
    (1, 64, 1, 512, 64, 128, 256),   # the mamba2-1.3b prefill
    (1, 64, 1, 159, 64, 128, 256),   # ragged: one chunk of 159
    (2, 8, 4, 256, 64, 16, 128),     # G > 1, N 16, two chunks
    (1, 4, 2, 96, 16, 32, 32),       # small head dim, three chunks
    (1, 2, 1, 64, 8, 16, 32),        # the smoke configuration's widths
])
def test_ssd_scan_kernel_matches_plain(dev, b, h, g, s, p, n, chunk, dtype):
    args = _ssd_inputs(dev, b, h, g, s, p, n, dtype, seed=s)
    y, st = ops.ssd_scan(*args, chunk=chunk)
    x, dt, a_log, bb, cc = args
    y_ref, st_ref = ssd_scan_ref(x, dt, -torch.exp(a_log), bb, cc,
                                 min(chunk, s))
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == 1
    assert y.dtype == dtype and tuple(y.shape) == (b, h, s, p)
    assert st.dtype == torch.float32 and tuple(st.shape) == (b, h, p, n)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert _row_ulps(y, y_ref) <= (1.0 if dtype == torch.bfloat16 else
                                   1e-5 * 2 ** 7)
    assert ((st - st_ref).abs().max() <= 1e-5 * st_ref.abs().max())


def test_ssd_scan_bf16_gives_the_same_bits_every_call(dev):
    """No atomics and fixed summation orders: two calls on the same bf16
    inputs give bit-identical y and final state."""
    args = _ssd_inputs(dev, 1, 64, 1, 512, 64, 128, torch.bfloat16, seed=4)
    y1, st1 = ops.ssd_scan(*args, chunk=256)
    y2, st2 = ops.ssd_scan(*args, chunk=256)
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == 2
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    assert torch.equal(st1.view(torch.int32), st2.view(torch.int32))


def test_ssd_scan_rejects_misaligned_bf16_rows(dev):
    """The bf16 route copies rows 16 bytes at a time: a view whose rows
    do not start on 16-byte boundaries raises before any launch."""
    x, dt, a_log, bb, cc = _ssd_inputs(dev, 1, 4, 1, 64, 64, 128,
                                       torch.bfloat16)
    buf = torch.zeros(64 * 4 * 64 + 1, dtype=torch.bfloat16, device=dev)
    bad = buf[1:].view(1, 64, 4, 64).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(bad, dt, a_log, bb, cc, chunk=64)
    wide = torch.zeros((1, 64, 1, 136), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        ops.ssd_scan(x, dt, a_log, wide[..., 1:129].transpose(1, 2), cc,
                     chunk=64)
    assert ops.launches["ssd_scan"] == 0


def test_ssd_scan_rejects_what_the_kernel_does_not_take(dev):
    x, dt, a_log, bb, cc = _ssd_inputs(dev, 1, 4, 1, 64, 64, 128,
                                       torch.bfloat16)
    with pytest.raises(ValueError, match="chunk 512 > 256"):
        ops.ssd_scan(*_ssd_inputs(dev, 1, 2, 1, 512, 64, 128,
                                  torch.bfloat16), chunk=512)
    with pytest.raises(ValueError, match="head dim"):
        ops.ssd_scan(x[..., :48], dt, a_log, bb, cc)
    with pytest.raises(ValueError, match="state dim"):
        ops.ssd_scan(x, dt, a_log, bb[..., :96], cc[..., :96])
    with pytest.raises(ValueError, match="dtype"):
        ops.ssd_scan(x.half(), dt, a_log, bb.half(), cc.half())
    with pytest.raises(ValueError, match="dt dtype"):
        ops.ssd_scan(x, dt.to(torch.bfloat16), a_log, bb, cc)
    with pytest.raises(ValueError, match="unit stride"):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                     a_log, bb, cc)
    with pytest.raises(ValueError, match="different devices"):
        ops.ssd_scan(x, dt.cpu(), a_log, bb, cc)
    assert ops.launches["ssd_scan"] == 0


def test_ssd_scan_on_the_card_refuses_a_gradient(dev):
    """K4 has no backward kernel yet: a CUDA call that needs a gradient
    raises rather than quietly taking the plain version."""
    x, dt, a_log, bb, cc = _ssd_inputs(dev, 1, 4, 1, 64, 64, 128,
                                       torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.ssd_scan(x.detach().requires_grad_(), dt, a_log, bb, cc)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.ssd_scan(x, dt, a_log.requires_grad_(), bb, cc)
    with torch.no_grad():
        ops.ssd_scan(x, dt, a_log, bb, cc)
    assert ops.launches["ssd_scan"] == 1


def test_checkpoint_of_a_card_state_restores_bit_for_bit(dev, tmp_path):
    """A bf16/fp32 training state on the card, with the optimizer's step:
    saved in the npz-v1 format (bf16 through a uint16 view), restored
    onto the card into the same dtypes, bit for bit; the memory tier's
    host copy rolls back the same bits."""
    from repro_torch.ckpt import CheckpointManager, restore_checkpoint
    from repro_torch.ckpt.checkpoint import copy_into, tree_tensors
    from repro_torch.optim import AdamWState

    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn(64, 96, generator=gen, device=dev).to(
        torch.bfloat16), "norm": torch.randn(96, generator=gen, device=dev)}
    state = (params, AdamWState(
        5, {k: torch.randn(v.shape, generator=gen, device=dev)
            for k, v in params.items()},
        {k: torch.rand(v.shape, generator=gen, device=dev)
         for k, v in params.items()}))
    mgr = CheckpointManager(tmp_path, n_groups=8, redundancy=2, mtbf=300,
                            t_save=60, t_restart=3600)
    mgr.snapshot(5, state)
    assert mgr.maybe_save(5, mgr.last_snapshot[1], force=True, block=True)
    like = (params, AdamWState(0, state[1].mu, state[1].nu))
    step, got = restore_checkpoint(tmp_path, like)
    assert step == 5 and got[1].step == 5
    ints = {2: torch.int16, 4: torch.int32}
    for a, b in zip(tree_tensors(got), tree_tensors(state)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.view(ints[a.element_size()]),
                           b.view(ints[b.element_size()]))
    want = [t.clone() for t in tree_tensors(state)]
    for t in tree_tensors(state):
        t.zero_()
    copy_into(state, mgr.rollback()[1])
    for a, b in zip(tree_tensors(state), want):
        assert torch.equal(a.view(ints[a.element_size()]),
                           b.view(ints[b.element_size()]))


def test_trainer_cell_runs_on_the_card(dev, tmp_path, monkeypatch):
    """A short live trainer cell (the rack-burst regime of the trainer
    campaign, 12 steps) through ``run_trainer_cell`` on the card at the
    smoke size widened for K2 (the default ``cfg`` there): the report's
    counts equal the same cell's on the CPU (the injector and the scheme
    are host-side), the §3.1 error is within the trainer's 1e-2, the
    losses are finite, the training kernels launched, and the trace
    passes the obs CLI's gates. The trace path is part of the cell's key
    and so of its seed: it is relative, in a fresh directory."""
    import math

    from repro_torch.launch import obs as obs_cli
    from repro_torch.scenarios.campaign import (run_trainer_cell,
                                                trainer_regime_cells)

    monkeypatch.chdir(tmp_path)
    (tmp_path / "traces").mkdir()
    cell = trainer_regime_cells(steps=12, trace_dir="traces")[1]
    cpu = run_trainer_cell(cell, device="cpu")
    ops.reset_launches()
    card = run_trainer_cell(cell)
    counts = ("steps_done", "failures", "wipeouts", "reorders", "patches",
              "recovery_events", "multi_group_events", "rollback_steps",
              "final_s_a")
    assert {k: card[k] for k in counts} == {k: cpu[k] for k in counts}
    assert card["multi_group_events"] > 0
    assert card["max_grad_check_err"] <= 1e-2
    assert math.isfinite(card["loss_first"])
    assert math.isfinite(card["loss_last"])
    for k in ("rmsnorm", "rmsnorm_bwd", "flash_attention",
              "flash_attention_bwd"):
        assert ops.launches[k] > 0
    assert obs_cli.main([cell["trace"], "--assert-coverage", "0.95",
                         "--assert-recovery-markers"]) == 0
