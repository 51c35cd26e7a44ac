"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free vocab=50280 (tied
embeddings), SSD d_state=128 head_dim=64 expand=2 [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk=256),
)
