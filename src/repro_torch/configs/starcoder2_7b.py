"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, RoPE, two-matrix GELU MLP [arXiv:2402.19173; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    mlp_kind="gelu",
    vocab=49152,
    head_dim=128,
)
