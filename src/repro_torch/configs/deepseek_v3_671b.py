"""deepseek-v3-671b [moe] — 61L d_model=7168 128H (MLA) vocab=129280,
MoE 256 routed + 1 shared, top-8, expert d_ff=2048 [arXiv:2412.19437; hf].

MLA: kv_lora=512, q_lora=1536, d_nope=128, d_rope=64, d_v=128; first 3
layers use a dense FFN (18432), the rest are MoE. (MTP head omitted —
orthogonal to SPARe; noted in DESIGN.md.)
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense FFN of the first_k_dense layers
    vocab=129280,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    mla_d_nope=128,
    mla_d_rope=64,
    mla_d_v=128,
    rope_theta=1e4,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_expert=2048,
        n_shared=1,
        first_k_dense=3,
    ),
    # 671B on v5e HBM arithmetic: params bf16 (1.34 TB) + fp32 Adam
    # (5.4 TB) cannot fit even the 512-chip multi-pod (8.2 TB aggregate).
    # bf16 moments + bf16 grad accumulation is the memory point that fits
    # multi-pod (DeepSeek-V3 itself trained with a low-precision
    # optimizer); see EXPERIMENTS.md §Dry-run.
    moment_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    grad_accum=8,
)
