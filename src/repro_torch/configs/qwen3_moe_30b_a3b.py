"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) d_ff=768/expert vocab=151936,
MoE 128 experts top-8.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv=4,
    d_ff=768, vocab=151936,
    n_experts=128, moe_top_k=8,
    act="swiglu", rope_theta=1e6,
)
