"""musicgen-medium [audio] — decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (MHA: kv=24) d_ff=6144 vocab=2048 [arXiv:2306.05284; hf].
The EnCodec frontend is a stub: ``input_specs`` provides precomputed frame
embeddings (B, S, d_model); the backbone predicts the next audio token.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    mlp_kind="gelu",
    vocab=2048,
    frontend="audio",
)
