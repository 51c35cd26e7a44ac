"""Command-line entry points of the port (``python -m
repro_torch.launch.<name>``)."""
from __future__ import annotations

import torch

from repro_torch.configs import smoke_config
from repro_torch.models.config import ModelConfig


def launch_config(arch: str, device: torch.device) -> ModelConfig:
    """The smoke-size configuration the launchers run, as the JAX
    launchers do. On a CUDA device a GQA head dim that the
    flash-attention kernel does not take (the smoke size's 16) is
    widened to the smallest one it takes, 64; MLA never runs that kernel
    and never reads ``head_dim``, so an MLA config stays the JAX
    launchers' own."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    cfg = smoke_config(arch)
    hd = cfg.resolved_head_dim
    if (device.type == "cuda" and cfg.n_heads and cfg.attn_kind == "gqa"
            and hd not in HEAD_DIMS):
        cfg = cfg.scaled(head_dim=min(d for d in HEAD_DIMS if d >= hd))
    return cfg
