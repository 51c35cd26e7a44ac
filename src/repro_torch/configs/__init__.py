"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ smoke variants)."""
from __future__ import annotations

from dataclasses import replace

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

from . import (
    deepseek_v2_lite_16b,
    deepseek_v3_671b,
    glm4_9b,
    jamba_v0_1_52b,
    mamba2_1_3b,
    minitron_4b,
    musicgen_medium,
    qwen2_5_3b,
    qwen2_vl_2b,
    starcoder2_7b,
)
from .shapes import SHAPES, ShapeSpec, applicable, cells

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        musicgen_medium, qwen2_vl_2b, deepseek_v3_671b, deepseek_v2_lite_16b,
        minitron_4b, starcoder2_7b, qwen2_5_3b, glm4_9b, mamba2_1_3b,
        jamba_v0_1_52b,
    )
}

__all__ = ["ARCHS", "get_config", "smoke_config", "SHAPES", "ShapeSpec",
           "applicable", "cells"]


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config: small width/depth, few experts, tiny
    vocab — one CPU train step must run in seconds (per-arch smoke tests).
    """
    cfg = get_config(arch)
    kw: dict = {
        "d_model": 64,
        "vocab": 512,
        "rope_theta": 1e4,
    }
    if cfg.family == "hybrid":
        kw["n_layers"] = cfg.hybrid_period          # one full period
    else:
        kw["n_layers"] = 2 if cfg.moe is None else max(2, (cfg.moe.first_k_dense > 0) + 2)
    if cfg.n_heads:
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, min(cfg.n_kv_heads, 2))
        kw["head_dim"] = 16
    if cfg.d_ff:
        kw["d_ff"] = 128
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=32, q_lora_rank=(32 if cfg.q_lora_rank else 0),
                  mla_d_nope=16, mla_d_rope=8, mla_d_v=16)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_experts=8, top_k=2, d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            layer_period=cfg.moe.layer_period,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, head_dim=8, expand=2,
                              conv_width=4, n_groups=1, chunk=32)
    return replace(cfg, **kw)
