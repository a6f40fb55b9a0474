"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155,
MoE 32 experts top-8. Granite's logit/residual multipliers are omitted
(noted in DESIGN.md — they do not change shapes or sharding).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8,
    d_ff=512, vocab=49155,
    n_experts=32, moe_top_k=8,
    act="swiglu", rope_theta=1e4,
)
