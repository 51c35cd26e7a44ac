"""Model zoo, PyTorch port: the dense GQA family (qwen2.5-3b and its
relatives), the SSM family (mamba2-1.3b) and the hybrid family
(jamba-v0.1-52b, with the MoE FFN of :mod:`repro_torch.models.moe`) so
far. See :mod:`repro_torch.models.model`."""
from .config import ModelConfig, MoEConfig, SSMConfig
from .model import (Model, build_model, cast_params, params_from_numpy,
                    resolve_device)

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "Model", "build_model",
           "params_from_numpy", "cast_params", "resolve_device"]
