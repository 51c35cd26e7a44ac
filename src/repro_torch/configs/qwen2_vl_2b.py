"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, QKV bias, M-RoPE [arXiv:2409.12191; hf].

Vision frontend is a stub: ``input_specs`` provides precomputed patch
embeddings mixed into the token stream (B, S, d_model). M-RoPE's text-only
case degenerates to standard 1-D RoPE (the three position components
coincide), which is what the backbone applies here — see DESIGN.md.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    frontend="vlm",
)
