"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain versions; those
are held here against the Pallas kernels run in interpret mode (as the
JAX package's own tests run them off-TPU), on the same numpy inputs.
The Triton and CUDA kernels themselves run only on the card: see
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 1e-5 (summation order only). bf16: both compute in
fp32 and round once to bf16, so a value may land one bf16 ulp apart
(2^-7 relative; the data here stays below 4 in magnitude, so 3e-2
absolute).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ops import rmsnorm as jax_rmsnorm
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (bsh_strides,
                                                 flash_attention_ref,
                                                 rows_aligned)
from repro_torch.kernels.rmsnorm import rmsnorm_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=3e-2, rtol=2 ** -7)}


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(arr, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture(autouse=True)
def _zero_launches():
    ops.reset_launches()
    yield
    # CPU tensors never reach a kernel
    assert {"rmsnorm", "flash_attention"} <= set(ops.launches)
    assert all(n == 0 for n in ops.launches.values()), ops.launches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 64), (37, 128), (300, 64)])
def test_rmsnorm_plain_matches_pallas(rows, d, dtype):
    """Ragged row counts (not a multiple of the Pallas row block)."""
    rng = np.random.default_rng(rows)
    xj, xt = _pair(rng.normal(size=(rows, d)) * 3.0, dtype)
    w = rng.uniform(0.5, 1.5, size=(d,)).astype(np.float32)
    want = jax_rmsnorm(xj, jnp.asarray(w), eps=1e-5, block_rows=256,
                       interpret=True)
    got = ops.rmsnorm(xt, torch.from_numpy(w), eps=1e-5)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (rows, d)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,s,block,d", [
    pytest.param(4, 4, 64, 32, 16, id="4-4-64-32"),   # MHA, two blocks
    pytest.param(8, 1, 64, 32, 16, id="8-1-64-32"),   # GQA group 8
    pytest.param(8, 1, 48, 48, 16, id="8-1-48-48"),   # one block, S 48
    (4, 2, 64, 32, 16),  # GQA group 2 at D 16: the launchers' smoke heads
    (8, 2, 64, 32, 32),  # GQA group 4 at D 32, two blocks
    (4, 4, 48, 48, 32),  # MHA at D 32, one block
])
def test_flash_attention_plain_matches_pallas(h, kv, s, block, d, dtype):
    rng = np.random.default_rng(s + h)
    qj, qt = _pair(rng.normal(size=(1, h, s, d)), dtype)
    kj, kt = _pair(rng.normal(size=(1, kv, s, d)), dtype)
    vj, vt = _pair(rng.normal(size=(1, kv, s, d)), dtype)
    want = jax_flash(qj, kj, vj, block_q=block, block_k=block,
                     interpret=True)
    got = ops.flash_attention(qt, kt, vt)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (1, h, s, d)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])


def test_flash_attention_takes_the_model_layout_through_strides():
    """(B, S, H, D) activations passed transposed give the same result as
    contiguous (B, H, S, D) ones, for a ragged S the Pallas kernel's
    block rule would refuse."""
    rng = np.random.default_rng(5)
    b, s, h, kv, d = 2, 37, 4, 2, 16
    q = torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, s, kv, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, s, kv, d)).astype(np.float32))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    want = jax_flash_ref(*(jnp.asarray(t.transpose(1, 2).numpy())
                           for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_wrappers_send_cpu_tensors_to_the_plain_versions():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(3, 5, 32)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=(32,)).astype(np.float32))
    assert torch.equal(ops.rmsnorm(x, w), rmsnorm_ref(x, w))
    q = torch.from_numpy(rng.normal(size=(1, 2, 9, 16)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q[:, :1], q[:, :1]),
                       flash_attention_ref(q, q[:, :1], q[:, :1]))


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="device"):
        ops.rmsnorm(x.to("meta"), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="on cpu, w on meta"):
        ops.rmsnorm(x, torch.zeros(8, device="meta"))
    q = torch.zeros(1, 3, 4, 16)
    with pytest.raises(ValueError, match="H % KV"):
        ops.flash_attention(q, q[:, :2], q[:, :2])
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.flash_attention(q, q[:, :1].double(), q[:, :1])
    with pytest.raises(ValueError, match="shape|k "):
        ops.flash_attention(q, q[:, :1, :3], q[:, :1])


@pytest.mark.parametrize("ptr,strides,esize,want", [
    # the model's (B, S, H, D) activations, D 128, bf16
    (1 << 20, (256 * 16 * 128, 16 * 128, 128), 2, True),
    # B 1 (its stride given as 0), D 64
    (4096, (0, 2 * 64, 64), 2, True),
    # a view one element into its storage
    (2, (256 * 16 * 128, 16 * 128, 128), 2, False),
    # rows 68 elements (136 bytes) apart
    (0, (8 * 4 * 68, 4 * 68, 68), 2, False),
    # rows 72 elements (144 bytes) apart
    (0, (8 * 4 * 72, 4 * 72, 72), 2, True),
    # fp32: 16-byte strides, a 4-byte base
    (4, (32, 8, 4), 4, False),
    (16, (32, 8, 4), 4, True),
])
def test_rows_aligned_is_the_16_byte_rule(ptr, strides, esize, want):
    assert rows_aligned(ptr, strides, esize) is want


def test_bsh_strides_read_the_model_layout_and_drop_unit_axes():
    x = torch.zeros(2, 5, 16, 128).transpose(1, 2)  # (B, H, S, D) view
    assert bsh_strides(x) == [5 * 16 * 128, 16 * 128, 128]
    one = torch.zeros(1, 1, 16, 128).transpose(1, 2)  # B 1 and S 1
    assert bsh_strides(one, x) == [0, 0, 128, 5 * 16 * 128, 16 * 128, 128]


def test_the_bf16_alignment_check_raises_before_a_launch():
    """``ops`` holds bf16 inputs to the rule (a ValueError, not another
    route); fp32 inputs, which the CUDA-core kernels take at any
    alignment, pass."""
    buf = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)
    bad = buf[1:].view(2, 8, 4, 64).transpose(1, 2)
    good = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="16-byte"):
        ops._require_rows_aligned("q, k, v", good, bad, good)
    ops._require_rows_aligned("q, k, v", good, good, good)
    bad32 = torch.zeros(2 * 8 * 4 * 64 + 1)[1:].view(2, 8, 4, 64)
    ops._require_rows_aligned("q, k, v", bad32.transpose(1, 2))


def _ssd_views(conv_width: int, offsets, widths, heads, seq: int = 64,
               base: int = 0):
    """x, dt, b, c as the mamba2 model makes them: slices of one bf16
    ``conv_out`` (B, S, conv_width), ``base`` elements into its storage,
    reshaped to (B, S, X, W) and passed transposed."""
    buf = torch.zeros(base + 2 * seq * conv_width, dtype=torch.bfloat16)
    conv_out = buf[base:].view(2, seq, conv_width)
    x, b, c = (conv_out[..., o:o + w * n].reshape(2, seq, n, w)
               .transpose(1, 2)
               for o, w, n in zip(offsets, widths, heads))
    dt = torch.zeros(2, seq, heads[0]).transpose(1, 2)
    return x, dt, b, c


def test_the_ssd_card_checks_hold_bf16_rows_to_16_bytes():
    """K4's bf16 route copies rows 16 bytes at a time: a view whose rows
    do not start on 16-byte boundaries raises before any launch; the
    mamba2-1.3b model's own views of ``conv_out`` (rows of 4,352
    elements, B at 4,096 and C at 4,224) pass, and fp32 views pass at any
    alignment."""
    from repro_torch.configs import get_config

    s = get_config("mamba2-1.3b").ssm
    d_in = s.d_inner(2048)
    gn = s.n_groups * s.d_state
    heads = (s.n_heads(2048), s.n_groups, s.n_groups)
    widths = (s.head_dim, s.d_state, s.d_state)
    offsets = (0, d_in, d_in + gn)
    assert (d_in + 2 * gn, offsets[1:]) == (4352, (4096, 4224))
    ops._check_ssd_card(*_ssd_views(d_in + 2 * gn, offsets, widths, heads),
                        q=64)
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_ssd_card(*_ssd_views(d_in + 2 * gn, offsets, widths,
                                        heads, base=1), q=64)
    # B one element off its 16-byte boundary
    with pytest.raises(ValueError, match="16-byte"):
        ops._check_ssd_card(*_ssd_views(d_in + 2 * gn + 8,
                                        (0, d_in + 1, d_in + gn + 8),
                                        widths, heads), q=64)
    x, dt, b, c = _ssd_views(d_in + 2 * gn, offsets, widths, heads, base=1)
    ops._check_ssd_card(x.float(), dt, b.float(), c.float(), q=64)
    assert ops.launches["ssd_scan"] == 0


def test_a_changed_header_gives_another_library(tmp_path, monkeypatch):
    """A library is named by the hash of its source and of every shared
    header, so editing a header rebuilds every kernel instead of loading
    a stale library."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new\n")
    assert _build._lib_path("k") not in (first, second)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n// edited\n')
    assert _build._lib_path("k") not in (first, second)


def test_build_sources_name_every_cuda_source():
    """``_build.SOURCES`` (what ``build_all`` compiles) is every
    ``csrc/*.cu``: a source left out would build only at its first
    launch, inside a timed run."""
    from repro_torch.kernels import _build

    assert sorted(_build.SOURCES) == sorted(
        p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.mark.parametrize("ptrs,d,esize,want", [
    # the main paths: qwen2.5-3b's width and mamba2-1.3b's gated norm, bf16
    ((0, 1 << 20, 4096), 2048, 2, "VECTOR"),
    ((0, 0, 0), 4096, 2, "VECTOR"),
    ((16, 32, 48), 2048, 4, "VECTOR"),
    ((0, 0, 0), 96, 2, "VECTOR"),
    ((0, 0, 0), 8, 2, "VECTOR"),              # one 16-byte chunk a row
    ((0, 0, 0), 32768, 2, "VECTOR"),          # the widest vector row
    ((0, 0, 0), 32776, 2, "SCALAR"),
    ((2, 0, 0), 2048, 2, "SCALAR"),           # x one bf16 off
    ((0, 4, 0), 2048, 2, "SCALAR"),           # w one fp32 off
    ((0, 0, 8), 2048, 2, "SCALAR"),           # y off
    ((0, 0, 0), 2050, 2, "SCALAR"),           # rows of 4,100 bytes
    ((0, 0, 0), 6, 4, "SCALAR"),
])
def test_rmsnorm_route_is_the_16_byte_rule(ptrs, d, esize, want):
    from repro_torch.kernels import rmsnorm

    assert rmsnorm.rmsnorm_route(*ptrs, d, esize) == getattr(rmsnorm, want)


@pytest.mark.parametrize("x,w,match", [
    (torch.zeros(2, 8, dtype=torch.float64), torch.zeros(8), "x dtype"),
    (torch.zeros(2, 8), torch.zeros(8, dtype=torch.float16), "w dtype"),
    (torch.zeros(2, 8), torch.zeros(6), "w shape"),
    (torch.zeros(8, 2).T, torch.zeros(8), "contiguous"),
    (torch.zeros(0, 8), torch.zeros(8), "empty"),
])
def test_the_rmsnorm_card_checks_name_what_k1_does_not_take(x, w, match):
    """What ``ops.rmsnorm`` raises on a CUDA tensor that K1 does not take
    (the checks are testable on CPU tensors); what it takes passes."""
    with pytest.raises(ValueError, match=match):
        ops._check_rmsnorm_card(x, w)
    ops._check_rmsnorm_card(torch.zeros(2, 8, dtype=torch.bfloat16),
                            torch.zeros(8))
