"""lsm_attention kernel package: decode attention over the KV cache."""
from repro_torch.kernels.lsm_attention.ops import (  # noqa: F401
    decode_attention, decode_attention_op, decode_attention_plain,
    lsm_decode_attention, lsm_decode_attention_op,
    lsm_decode_attention_plain, select_blocks, tiered_inputs)
