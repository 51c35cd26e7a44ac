"""Mamba-2 (SSD, state-space duality) block — the PyTorch counterpart of
``repro.models.ssm``.

Within chunks of length Q the recurrence is computed as a masked
attention-like quadratic form; across chunks the (heads, head_dim,
d_state) state is carried in fp32. The full-sequence scan goes through
:func:`repro_torch.kernels.ops.ssd_scan` (the K4 kernel on a CUDA tensor,
its plain version on a CPU one), where the JAX model runs its plain
``lax.scan``: both compute the chunked SSD of Dao & Gu (2024). Decode
keeps O(1) state per token and stays plain PyTorch.

Projections are split per component (z/x/B/C/dt), as in the JAX package.
The numerics follow it step for step: the causal conv sums its taps in
fp32 in tap order, then adds the bias; the SiLU of the conv output is
cast back to the compute dtype; the timestep is ``softplus`` spelled as
``logaddexp(x, 0)`` (as ``jax.nn.softplus`` is) in fp32; ``d_skip`` is
cast to y's dtype before it scales x; and the conv tail a prefill leaves
for decode is bf16 whatever the parameters' dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .config import ModelConfig, SSMConfig
from .layers import rmsnorm
from .remat import dot

__all__ = ["ssd_chunked", "ssd_decode_step", "mamba_forward", "mamba_decode",
           "MambaCache", "init_mamba_cache"]


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, conv_dim) — rolling conv window
    state: torch.Tensor  # (B, nheads, head_dim, d_state) — SSD state, fp32


def init_mamba_cache(cfg: ModelConfig, batch: int, *,
                     device: torch.device | str,
                     dtype=torch.bfloat16) -> MambaCache:
    s = cfg.ssm
    assert s is not None
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return MambaCache(
        torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32,
                    device=device))


# ------------------------------------------------------------------ #
# SSD core                                                            #
# ------------------------------------------------------------------ #
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan through the K4 wrapper.

    x (B, S, H, P); dt (B, S, H) softplus'd timestep; a_log (H,) with
    A = -exp(a_log); b, c (B, S, G, N) — one row per B/C group, head h
    reading group ``h // (H / G)`` (the JAX function takes them already
    broadcast to H groups, which is the case G = H here). Returns
    (y (B, S, H, P), final_state (B, H, P, N) fp32). The (B, S, ...)
    tensors go to the kernel as transposed views, without a copy.
    """
    y, final = ops.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2), a_log,
                            b.transpose(1, 2), c.transpose(1, 2),
                            chunk=chunk)
    return y.transpose(1, 2), final


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update. x (B, H, P), dt (B, H), b, c (B, H, N),
    state (B, H, P, N) fp32. Returns (y (B, H, P), new_state)."""
    dtf = dt.float()
    a = -torch.exp(a_log.float())
    decay = torch.exp(dtf * a[None, :])                      # (B, H)
    outer = (x.float()[..., :, None] * b.float()[..., None, :]) \
        * dtf[:, :, None, None]
    new_state = state * decay[:, :, None, None] + outer
    y = torch.matmul(new_state, c.float()[..., None])[..., 0]
    return y.to(x.dtype), new_state


# ------------------------------------------------------------------ #
# full block                                                          #
# ------------------------------------------------------------------ #
def _conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C); w (C, W). fp32 taps summed in
    tap order, then the bias: the decode path computes the same window
    product in fp32."""
    width = w.shape[1]
    pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1).float()
    wf = w.float()
    out = sum(xp[:, i:i + x.shape[1], :] * wf[None, None, :, i]
              for i in range(width))
    return out + bias[None, None, :].float()


def _split_proj(x: torch.Tensor, p: dict):
    return (dot(x, p["wz"]),      # (B, S, d_in)
            dot(x, p["wx"]),      # (B, S, d_in)
            dot(x, p["wb"]),      # (B, S, G*N)
            dot(x, p["wc"]),      # (B, S, G*N)
            dot(x, p["wdt"]))     # (B, S, H)


def _broadcast_groups(t: torch.Tensor, n_heads: int,
                      s: SSMConfig) -> torch.Tensor:
    """(..., G*N) -> (..., H, N) by repeating each group across its heads
    (decode only: the prefill's scan reads the groups in place)."""
    t = t.reshape(*t.shape[:-1], s.n_groups, s.d_state)
    return t.repeat_interleave(n_heads // s.n_groups, dim=-2)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (torch's ``F.softplus``
    switches to the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _gate_out(y: torch.Tensor, z: torch.Tensor, p: dict,
              cfg: ModelConfig) -> torch.Tensor:
    """Gated RMSNorm (mamba-2), ``norm(y * silu(z))``, then out_proj."""
    y = rmsnorm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return dot(y, p["out_proj"])


def mamba_forward(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
                  return_cache: bool = False):
    """Full-sequence Mamba-2 mixer. x (B, S, D) -> (B, S, D).

    ``return_cache`` returns ``(out, MambaCache(conv_tail, final_state))``
    — the cache :func:`mamba_decode` would hold after consuming the
    sequence token by token: the last W-1 raw ``conv_in`` rows (bf16)
    plus the final SSD state. The SSD recurrence runs through every input
    token, so callers feed exact-length prompts. The JAX function's
    ``state0`` and ``return_state`` options are not ported (no path uses
    them).
    """
    s = cfg.ssm
    assert s is not None
    bsz, seq, _ = x.shape
    nh = s.n_heads(cfg.d_model)
    d_in = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state

    z, xc, bp, cp, dt = _split_proj(x, p)
    conv_in = torch.cat([xc, bp, cp], dim=-1)
    conv_out = F.silu(_conv1d_causal(conv_in, p["conv_w"], p["conv_b"])
                      ).to(x.dtype)
    xh = conv_out[..., :d_in].reshape(bsz, seq, nh, s.head_dim)
    bs_ = conv_out[..., d_in:d_in + gn].reshape(bsz, seq, s.n_groups,
                                                s.d_state)
    cs = conv_out[..., d_in + gn:].reshape(bsz, seq, s.n_groups, s.d_state)
    dt_sp = _softplus(dt.float() + p["dt_bias"].float())

    y, final = ssd_chunked(xh, dt_sp, p["a_log"], bs_, cs,
                           min(s.chunk, seq))
    y = y + xh * p["d_skip"].float()[None, None, :, None].to(y.dtype)
    out = _gate_out(y.reshape(bsz, seq, d_in), z, p, cfg)
    if not return_cache:
        return out
    pad = torch.zeros((bsz, s.conv_width - 1, conv_in.shape[-1]),
                      dtype=conv_in.dtype, device=x.device)
    tail = torch.cat([pad, conv_in], dim=1)[:, -(s.conv_width - 1):]
    return out, MambaCache(tail.to(torch.bfloat16), final)


def mamba_decode(x: torch.Tensor, p: dict, cfg: ModelConfig,
                 cache: MambaCache) -> tuple[torch.Tensor, MambaCache]:
    """One-token decode. x (B, 1, D). Returns ``(out, new cache)`` as new
    tensors; the window is ``cat(cache.conv, conv_in)`` in the dtype the
    two promote to (fp32 in an fp32 run whose cache holds bf16), as in
    the JAX package."""
    s = cfg.ssm
    assert s is not None
    bsz = x.shape[0]
    nh = s.n_heads(cfg.d_model)
    d_in = s.d_inner(cfg.d_model)
    gn = s.n_groups * s.d_state

    z, xc, bp, cp, dt = _split_proj(x, p)
    conv_in = torch.cat([xc, bp, cp], dim=-1)                 # (B, 1, C)
    window = torch.cat([cache.conv, conv_in], dim=1)          # (B, W, C)
    conv_out = torch.einsum("bwc,cw->bc", window.float(),
                            p["conv_w"].float()) + p["conv_b"].float()
    conv_out = F.silu(conv_out).to(x.dtype)

    xh = conv_out[:, :d_in].reshape(bsz, nh, s.head_dim)
    bh = _broadcast_groups(conv_out[:, d_in:d_in + gn], nh, s)
    ch = _broadcast_groups(conv_out[:, d_in + gn:], nh, s)
    dt_sp = _softplus(dt[:, 0].float() + p["dt_bias"].float())

    y, new_state = ssd_decode_step(xh, dt_sp, p["a_log"], bh, ch,
                                   cache.state)
    y = y + xh * p["d_skip"].float()[None, :, None].to(y.dtype)
    out = _gate_out(y.reshape(bsz, 1, d_in), z, p, cfg)
    return out, MambaCache(window[:, 1:, :], new_state)
