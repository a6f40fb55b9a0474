"""Mamba2-370M [arXiv:2405.21060].

48L d_model=1024, attention-free, ssm_state=128 — SSD (state-space
duality). d_inner = 2*d_model, head_dim 64 -> 32 SSD heads.

sLSM-KV applicability: NONE — there is no KV cache to tier; decode state
is O(1). `generate(kind="lsm")` raises for this family.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_groups=1,
)
