"""Architecture configuration dataclasses.

``ModelConfig`` is the single source of truth consumed by the model
builder, the sharding rules, the data pipeline, and the dry-run launcher.
One instance per assigned architecture lives in ``repro/configs/<id>.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig"]


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block parameters (DeepSeek / Jamba style)."""

    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared: int = 0              # always-on shared experts
    first_k_dense: int = 0         # leading dense layers (DeepSeek V2/V3)
    layer_period: int = 1          # MoE every `period` layers (Jamba: 2)
    capacity_factor: float = 1.25  # dispatch buffer slack


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block parameters."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1
    chunk: int = 256               # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture.

    ``family`` selects the block layout:
      dense  — [attn + mlp] x L
      moe    — [mla-attn + (dense | moe) mlp] x L (first_k_dense leading)
      ssm    — [mamba2] x L
      hybrid — period of ``hybrid_period`` blocks with one attention block
               at position ``hybrid_attn_pos`` and MoE every
               ``moe.layer_period`` blocks (Jamba 1:7)
    """

    name: str
    family: str                    # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free
    n_kv_heads: int
    d_ff: int                      # dense FFN hidden (0 for pure-MoE/ssm)
    vocab: int
    head_dim: int = 0              # 0 => d_model // n_heads
    mlp_kind: str = "swiglu"       # swiglu (3-matrix) | gelu | relu2 (2-matrix)
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention flavor
    attn_kind: str = "gqa"         # gqa | mla
    # MLA (DeepSeek) dims
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    mla_d_nope: int = 128
    mla_d_rope: int = 64
    mla_d_v: int = 128

    # subfamilies
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid_period: int = 0         # jamba: 8
    hybrid_attn_pos: int = 0       # attention block index within period

    # modality frontend stub: None | "audio" | "vlm"
    frontend: str | None = None

    # training defaults
    grad_accum: int = 4            # paper Table 1: 4 gradient accumulations
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots | none (no remat)
    moment_dtype: str = "float32"      # Adam m/v ("bfloat16" at 671B scale)
    grad_accum_dtype: str = "float32"  # microbatch accumulator dtype

    # ------------------------------------------------------------------ #
    @property
    def padded_vocab(self) -> int:
        """Embedding-table vocab padded to a multiple of 512 (divisible by
        every mesh axis combination we shard it over — Megatron-style).
        Logit columns >= ``vocab`` are masked to -inf in the forward."""
        return -(-self.vocab // 512) * 512

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads == 0:
            return 0
        return self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if decode cost per token is o(seq) in attention state —
        SSM and hybrid families qualify for long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_moe(self) -> bool:
        return self.moe is not None

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced-config clone for smoke tests."""
        return replace(self, **kw)

    # -- parameter counting (for roofline MODEL_FLOPS = 6 N D) ---------- #
    def param_count(self) -> int:
        """Exact parameter count of the constructed model (all layers)."""
        total = self.vocab * self.d_model            # embed
        if not self.tie_embeddings:
            total += self.d_model * self.vocab       # lm_head
        total += self.d_model                        # final norm
        for kind in self.block_kinds():
            total += self._block_params(kind)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        total = self.vocab * self.d_model
        if not self.tie_embeddings:
            total += self.d_model * self.vocab
        total += self.d_model
        for kind in self.block_kinds():
            total += self._block_params(kind, active_only=True)
        return total

    def block_kinds(self) -> list[str]:
        """Per-layer block kind sequence, length ``n_layers``.

        Kinds: ``attn_dense``, ``attn_moe``, ``mamba_dense``, ``mamba_moe``,
        ``mamba`` (no mlp), ``attn`` (no mlp).
        """
        kinds = []
        for i in range(self.n_layers):
            if self.family == "dense":
                kinds.append("attn_dense")
            elif self.family == "moe":
                assert self.moe is not None
                if i < self.moe.first_k_dense:
                    kinds.append("attn_dense")
                else:
                    kinds.append("attn_moe")
            elif self.family == "ssm":
                kinds.append("mamba")
            elif self.family == "hybrid":
                assert self.moe is not None and self.hybrid_period > 0
                mixer = "attn" if i % self.hybrid_period == self.hybrid_attn_pos else "mamba"
                mlp = "moe" if i % self.moe.layer_period == self.moe.layer_period - 1 else "dense"
                kinds.append(f"{mixer}_{mlp}")
            else:
                raise ValueError(f"unknown family {self.family!r}")
        return kinds

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla":
            h = self.n_heads
            dn, dr, dv = self.mla_d_nope, self.mla_d_rope, self.mla_d_v
            p = 0
            if self.q_lora_rank:
                p += d * self.q_lora_rank + self.q_lora_rank  # wq_a + norm
                p += self.q_lora_rank * h * (dn + dr)
            else:
                p += d * h * (dn + dr)
            p += d * (self.kv_lora_rank + dr) + self.kv_lora_rank  # wkv_a + norm
            p += self.kv_lora_rank * h * dn                   # wk_b
            p += self.kv_lora_rank * h * dv                   # wv_b
            p += h * dv * d                                   # wo
            return p
        dh = self.resolved_head_dim
        p = d * self.n_heads * dh + d * 2 * self.n_kv_heads * dh
        p += self.n_heads * dh * d
        if self.qkv_bias:
            p += (self.n_heads + 2 * self.n_kv_heads) * dh
        return p

    def _mamba_params(self) -> int:
        assert self.ssm is not None
        s, d = self.ssm, self.d_model
        d_in = s.d_inner(d)
        nh = s.n_heads(d)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj
        p += conv_dim * s.conv_width + conv_dim               # conv w + b
        p += 3 * nh                                           # A_log, D, dt_bias
        p += d_in                                             # gated norm
        p += d_in * d                                         # out_proj
        return p

    def _mlp_params(self, moe: bool, active_only: bool = False) -> int:
        d = self.d_model
        if not moe:
            n_mats = 3 if self.mlp_kind == "swiglu" else 2
            return n_mats * d * self.d_ff
        assert self.moe is not None
        m = self.moe
        per_expert = 3 * d * m.d_expert
        n_routed = m.top_k if active_only else m.n_experts
        return d * m.n_experts + n_routed * per_expert + m.n_shared * per_expert

    def _block_params(self, kind: str, active_only: bool = False) -> int:
        p = 0
        mixer, _, mlp = kind.partition("_")
        if mixer == "attn":
            p += self._attn_params() + self.d_model  # + ln
        elif mixer == "mamba":
            p += self._mamba_params() + self.d_model
        if mlp == "dense":
            p += self._mlp_params(False) + self.d_model
        elif mlp == "moe":
            p += self._mlp_params(True, active_only) + self.d_model
        return p
