"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 interleave (1 attention block per period of 8,
at offset 4), MoE 16 experts top-2 every other layer [arXiv:2403.19887; hf].

The Mamba sublayers use our SSD implementation at Jamba's d_state=16 —
Jamba ships Mamba-1 selective-scan; SSD is the successor formulation with
identical state size and interface (deviation recorded in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    head_dim=128,
    hybrid_period=8,
    hybrid_attn_pos=4,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
    moe=MoEConfig(
        n_experts=16,
        top_k=2,
        d_expert=14336,
        n_shared=0,
        layer_period=2,
    ),
)
