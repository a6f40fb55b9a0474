"""Model configuration: the port's copy of `repro.models.config`.

The fields and `smoke()` are the reference's, so a configuration means
the same model in both packages. The port runs all six families.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


def pad_vocab(v: int, multiple: int = 256) -> int:
    """Megatron-style vocab padding for clean TP sharding."""
    return ((v + multiple - 1) // multiple) * multiple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0      # 0 -> d_model // n_heads (gemma overrides to 256)
    act: str = "swiglu"    # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    rope: bool = True       # whisper uses learned absolute positions instead
    rope_theta: float = 1e4
    mrope: bool = False    # qwen2-vl M-RoPE (t/h/w sections)
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    moe_dp_groups: int = 1
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # hybrid (zamba2): one *shared* attention block applied every N blocks
    shared_attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # serving / sLSM-KV cache
    lsm_hot_window: int = 4096
    lsm_block: int = 1024     # mu for the KV tier (tokens per cold block)
    lsm_topk: int = 16
    lsm_dp_groups: int = 1    # block-selection groups
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests (the
        reference's `smoke()`, field for field)."""
        return replace(
            self, n_layers=4 if self.shared_attn_every else 2, d_model=64,
            n_heads=4, n_kv=max(1, min(self.n_kv, 2)),
            d_ff=128, vocab=512, head_dim=16 if self.head_dim else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.moe_top_k else 0,
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=32 if self.encoder_layers else 1500,
            shared_attn_every=2 if self.shared_attn_every else 0,
            mrope_sections=(4, 2, 2) if self.mrope else self.mrope_sections,
            lsm_hot_window=64, lsm_block=16, lsm_topk=2,
            dtype="float32",
        )


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration no family of this port runs: an unknown
    family, activation or norm."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; {FAMILIES} run")
    if cfg.act not in ("swiglu", "geglu", "gelu"):
        raise ValueError(f"{cfg.name}: unknown activation {cfg.act!r}")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise ValueError(f"{cfg.name}: unknown norm {cfg.norm!r}")
