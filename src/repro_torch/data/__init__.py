"""Data: the synthetic token stream and the KV workload generator (port
of `repro.data`)."""
from repro_torch.data.pipeline import (KVWorkload, TokenStream,  # noqa: F401
                                       make_kv_workload)
