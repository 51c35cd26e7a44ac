"""Mamba-2 SSD chunk scan: the CUDA kernels' bindings (K4 and its
backward, K4-bwd) and their plain PyTorch versions.

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

K4-bwd (``csrc/ssd_scan_bwd.cu``) replaces no Pallas kernel: the JAX
package differentiates its plain ``ssd_chunked``. :func:`ssd_scan_bwd_ref`
is its spec. Its routes split by dtype as K4's do: bf16 on the tensor
cores (four launches; a block walks :func:`bwd_heads_per_block` heads of a
group; every row of x, dy, b and c on a 16-byte boundary), fp32 on the
CUDA cores (three launches, no alignment rule).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["ssd_scan_ref", "ssd_scan_cuda", "ssd_scan_bwd_ref",
           "ssd_scan_bwd_cuda", "bwd_heads_per_block", "bwd_workspace",
           "HEAD_DIMS", "STATE_DIMS", "DTYPES", "MAX_CHUNK"]

HEAD_DIMS = (8, 16, 32, 64)
STATE_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 256
#: the fewest blocks K4-bwd's bf16 route launches a pass while a block
#: walks more than one head: one a streaming multiprocessor (132)
BWD_MIN_BLOCKS = 132

_FN = None
_BWD = None


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


def ssd_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                     d_final: torch.Tensor | None, chunk: int
                     ) -> tuple[torch.Tensor, ...]:
    """The backward's plain version (the spec K4-bwd follows): the
    gradients of :func:`ssd_scan_ref`'s ``(y, final state)`` given ``dy``
    (x's shape) and ``d_final`` ((B, H, P, N) fp32, or None for zero),
    chunk by chunk in reverse over every (batch, head) at once, in fp32
    math (fp64 for fp64 inputs). Returns ``(dx, ddt, da_log, db, dc)``:
    dx in x's dtype, ddt and da_log in the math's dtype, db and dc
    (summed over the heads of each group) in b's dtype.

    Per chunk, with ``L_ij = exp(cum_i - cum_j)`` (j <= i), the state
    ``S_prev`` entering the chunk (recomputed by the forward's
    recurrence) and ``dS`` the gradient of the state leaving it:
    ``dS_prev = exp(seg) dS + sum_i exp(cum_i) dy_i c_i^T``; the
    intra-chunk terms through ``W = (C B^T) . L . dt_j`` and ``dCB = (dY
    X^T) . L . dt_j``; the inter-chunk terms through ``exp(cum_i) S_prev
    c_i``; the state terms through ``u_j = dt_j exp(seg - cum_j)``; and
    ``dcum``, which the reverse cumsum turns into the gradient of
    ``dt * a``. Two exact rearrangements keep that gradient from
    cancelling large terms: the diagonal of ``M = (C B^T) . L . dt_j .
    (dY X^T)`` (added to ``dcum_i`` by its row and taken away by its
    column) is left out, and the state's ``r_j = u_j x_j . (dS b_j)``
    (taken from ``dcum_j``, added to ``dcum_{Q-1}``) enters as its sum
    over ``j < t``. ``cum`` is summed in fp64 as the forward sums it and
    rounded once to dt's precision (fp32 in every call the port makes);
    ``dcum``'s row and column sums, the sums over t and ``da_log``'s sum
    over (batch, position) are summed in fp64, each rounded once to the
    math's dtype."""
    bs, h, s, p = x.shape
    rep = h // b.shape[1]
    n = b.shape[-1]
    wt = torch.promote_types(x.dtype, torch.float32)  # the math's dtype
    cum_t = torch.promote_types(dt.dtype, torch.float32)
    xf, dtf, dyf = x.to(wt), dt.to(wt), dy.to(wt)
    bf = b.to(wt).repeat_interleave(rep, dim=1)      # (B, H, S, N)
    cf = c.to(wt).repeat_interleave(rep, dim=1)
    a = -torch.exp(a_log.to(wt))
    dta = dtf * a[None, :, None]
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    below = causal.tril(-1)
    chunks = [slice(t0, t0 + chunk) for t0 in range(0, s, chunk)]
    cums, states = [], []
    state = torch.zeros((bs, h, p, n), dtype=wt, device=x.device)
    for sl in chunks:                                # the forward's states
        cum = torch.cumsum(dta[..., sl].double(), dim=-1).to(cum_t).to(wt)
        seg = cum[..., -1:]
        cums.append(cum)
        states.append(state)
        u = dtf[..., sl] * torch.exp(seg - cum)
        state = state * torch.exp(seg)[..., None] \
            + torch.matmul(xf[..., sl, :].transpose(-1, -2),
                           bf[..., sl, :] * u[..., None])
    d_state = (torch.zeros_like(state) if d_final is None
               else d_final.to(wt, copy=True))
    dx, ddt = torch.empty_like(xf), torch.empty_like(dtf)
    db, dc = torch.empty_like(bf), torch.empty_like(cf)
    da = torch.zeros((bs, h), dtype=torch.float64, device=x.device)
    for k in reversed(range(len(chunks))):
        sl, cum, s_prev = chunks[k], cums[k], states[k]
        xk, dyk, bk, ck, dtk = (xf[..., sl, :], dyf[..., sl, :],
                                bf[..., sl, :], cf[..., sl, :], dtf[..., sl])
        seg = cum[..., -1:]
        ecum, dec = torch.exp(cum), torch.exp(seg - cum)
        u = dtk * dec
        l = torch.exp(torch.where(causal, cum[..., :, None]
                                  - cum[..., None, :], float("-inf")))
        cb = torch.matmul(ck, bk.transpose(-1, -2))          # (.., Q, Q)
        gxy = torch.matmul(dyk, xk.transpose(-1, -2))        # dy_i . x_j
        kk = cb * l * gxy
        mm = kk * dtk[..., None, :]
        w = cb * l * dtk[..., None, :]
        dcb = gxy * l * dtk[..., None, :]
        dsb = torch.matmul(bk, d_state.transpose(-1, -2))    # (dS b_j)_p
        xdsb = (xk * dsb).sum(-1)                            # x_j . dS b_j
        dx[..., sl, :] = torch.matmul(w.transpose(-1, -2), dyk) \
            + u[..., None] * dsb
        dc[..., sl, :] = torch.matmul(dcb, bk) \
            + ecum[..., None] * torch.matmul(dyk, s_prev)
        db[..., sl, :] = torch.matmul(dcb.transpose(-1, -2), ck) \
            + u[..., None] * torch.matmul(xk, d_state)
        # the diagonal of M enters dcum_i twice and cancels: left out
        off = torch.where(below, mm, 0.0).double()
        dcum = off.sum(-1) - off.sum(-2) + (ecum * (
            dyk * torch.matmul(ck, s_prev.transpose(-1, -2))).sum(-1)).double()
        dcum[..., -1] += (torch.exp(seg[..., 0]) * (
            d_state * s_prev).sum((-1, -2))).double()
        # the state's share, r_j in dcum_{Q-1} and -r_j in dcum_j, reaches
        # d(dt a)_t as the sum of r_j over j < t
        r = (u * xdsb).double()
        ddta = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), dim=-1),
                          (-1,)) + (torch.cumsum(r, dim=-1) - r)
        ddt[..., sl] = kk.sum(-2) + dec * xdsb + a[None, :, None] \
            * ddta.to(wt)
        da += (dtk.double() * ddta).sum(-1)
        d_state = d_state * torch.exp(seg)[..., None] + torch.matmul(
            (dyk * ecum[..., None]).transpose(-1, -2), ck)
    g = b.shape[1]
    db = db.view(bs, g, rep, s, n).sum(2)
    dc = dc.view(bs, g, rep, s, n).sum(2)
    da_log = (a.double() * da.sum(0)).to(wt)
    return (dx.to(x.dtype), ddt, da_log, db.to(b.dtype), dc.to(c.dtype))


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


def _bwd():
    global _BWD
    if _BWD is None:
        fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _BWD = fn
    return _BWD


def bwd_heads_per_block(dtype: torch.dtype, batch: int, heads: int,
                        groups: int, seq: int, chunk: int) -> int:
    """How many heads of a group one block of K4-bwd's bf16 route walks
    (its db and dc partials are summed over them in registers, so the
    workspaces the reduce reads shrink by as much, and B and C tiles are
    shared): the largest of 4 and 2 that divides H / G and still leaves a
    block for every streaming multiprocessor (:data:`BWD_MIN_BLOCKS`),
    else 1. The fp32 route takes 1. At the training microbatch 4 is the
    fastest (``tools/kernel_times.py --variants``; PERF.md §6)."""
    if dtype != torch.bfloat16:
        return 1
    units = batch * heads * (seq // chunk)
    for hw in (4, 2):
        if (heads // groups) % hw == 0 and units // hw >= BWD_MIN_BLOCKS:
            return hw
    return 1


def bwd_workspace(dtype: torch.dtype, batch: int, heads: int, seq: int,
                  chunk: int, p: int, n: int, hw: int) -> tuple[int, int]:
    """K4-bwd's workspaces as ``(fp32 elements, fp64 elements)``: the
    states entering and the gradients leaving each chunk (fp32, or on the
    bf16 route three bf16 parts of a tile of 64 rows by N padded to 64 or
    128: the image of the tiles its passes copy), db's and dc's partials
    (one per ``hw`` heads) and, on the bf16 route, r and dcum's row and
    column parts per position; each chunk's share of da_log."""
    units = batch * heads * (seq // chunk)
    bf16 = dtype == torch.bfloat16
    states = 2 * units * (3 * 64 * (64 if n <= 64 else 128) // 2 if bf16
                          else p * n)
    floats = states + 2 * batch * (heads // hw) * seq * n
    doubles = units
    if bf16:
        floats += batch * heads * seq
        doubles += batch * heads * seq
    return floats, doubles


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      d_final: torch.Tensor | None, chunk: int, *,
                      heads_per_block: int | None = None
                      ) -> tuple[torch.Tensor, ...]:
    """Launch K4-bwd (``csrc/ssd_scan_bwd.cu``): the gradients of
    :func:`ssd_scan_cuda`'s ``(y, final state)`` given ``dy`` (x's shape
    and dtype, a unit stride on P) and ``d_final`` ((B, H, P, N) fp32
    contiguous, or None for zero); the other inputs as the forward took
    them. Returns ``(dx, ddt, da_log, db, dc)`` as
    :func:`ssd_scan_bwd_ref` does, dx, ddt, db and dc as transposed views
    of contiguous (B, S, ...) tensors (the model's layout). Its
    workspaces (:func:`bwd_workspace`) come from PyTorch's allocator.
    The caller checks the inputs; in bf16 every row of dy must also
    start on a 16-byte boundary. ``heads_per_block`` overrides
    :func:`bwd_heads_per_block` (bf16 only)."""
    bs, h, s, p = x.shape
    g, n = b.shape[1], b.shape[-1]
    dev = x.device
    hw = heads_per_block or bwd_heads_per_block(x.dtype, bs, h, g, s, chunk)
    dx = torch.empty((bs, s, h, p), dtype=x.dtype, device=dev).transpose(1, 2)
    ddt = torch.empty((bs, s, h), dtype=torch.float32,
                      device=dev).transpose(1, 2)
    da_log = torch.empty((h,), dtype=torch.float32, device=dev)
    db, dc = (torch.empty((bs, s, g, n), dtype=b.dtype,
                          device=dev).transpose(1, 2) for _ in range(2))
    floats, doubles = bwd_workspace(x.dtype, bs, h, s, chunk, p, n, hw)
    ws = torch.empty(floats, dtype=torch.float32, device=dev)
    ws_da = torch.empty(doubles, dtype=torch.float64, device=dev)
    strides = (ctypes.c_int64 * 27)(*(
        _bhs_strides(x) + _bhs_strides(dt) + _bhs_strides(b)
        + _bhs_strides(c) + _bhs_strides(dy) + _bhs_strides(dx)
        + _bhs_strides(ddt) + _bhs_strides(db) + _bhs_strides(dc)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd()(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
                 c.data_ptr(), dy.data_ptr(),
                 None if d_final is None else d_final.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), da_log.data_ptr(),
                 db.data_ptr(), dc.data_ptr(), ws.data_ptr(),
                 ws_da.data_ptr(), DTYPES[x.dtype], bs, h, g, s, chunk, p, n,
                 hw, ctypes.addressof(strides), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: cudaError "
                           f"{err}")
    return dx, ddt, da_log, db, dc
