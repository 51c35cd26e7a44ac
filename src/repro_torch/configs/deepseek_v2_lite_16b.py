"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H (MLA kv_lora=512)
vocab=102400, MoE 64 routed + 2 shared, top-6, expert d_ff=1408
[arXiv:2405.04434; hf].

V2-Lite has no q compression (q_lora_rank=0); first layer is dense
(d_ff=10944).
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,               # dense FFN of the first layer
    vocab=102400,
    attn_kind="mla",
    kv_lora_rank=512,
    q_lora_rank=0,
    mla_d_nope=128,
    mla_d_rope=64,
    mla_d_v=128,
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_expert=1408,
        n_shared=2,
        first_k_dense=1,
    ),
)
