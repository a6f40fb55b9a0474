"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — M-RoPE, QKV
bias. The vision tower is a stub, as in the reference: the text backbone
carries M-RoPE with (t, h, w) position streams (`positions3`, all equal
for text).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4,
    d_ff=18944, vocab=152064,
    act="swiglu", qkv_bias=True,
    rope_theta=1e6, mrope=True, mrope_sections=(16, 24, 24),
)
