"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936 — QKV bias.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv=20,
    d_ff=6912, vocab=151936,
    act="swiglu", qkv_bias=True, rope_theta=1e4,
)
