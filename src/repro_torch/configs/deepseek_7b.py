"""DeepSeek-LLM-7B [arXiv:2401.02954; hf].

30L d_model=4096 32H (MHA kv=32) d_ff=11008 vocab=102400 — llama arch.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv=32,
    d_ff=11008, vocab=102400,
    act="swiglu", rope_theta=1e4,
)
