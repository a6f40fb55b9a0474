"""Zamba2-1.2B [arXiv:2411.15242].

38 Mamba2 blocks d_model=2048, ssm_state=64, plus ONE shared attention
block (32H kv=32, d_ff=8192 MLP) applied every 6 mamba blocks — the
parameter-shared hybrid. Zamba2's LoRA-projectors on the shared block and
embedding-concat re-injection are simplified away, as in the reference.
The shared block's 6 applications each keep their own KV cache, which
the sLSM tiers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_groups=1,
    shared_attn_every=6,
)
