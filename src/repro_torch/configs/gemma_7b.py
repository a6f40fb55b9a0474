"""Gemma-7B [arXiv:2403.08295].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000 — GeGLU,
head_dim=256 (> d_model/n_heads), sqrt(d_model) embedding scaling.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv=16,
    d_ff=24576, vocab=256000, head_dim=256,
    act="geglu", embed_scale=True, rope_theta=1e4,
)
