"""LM serving over the sLSM-tiered KV cache (port of `repro.serving`)."""
from repro_torch.serving.kv_cache import (generate,  # noqa: F401
                                          grow_dense, lsm_from_dense,
                                          seal_hot_block)
