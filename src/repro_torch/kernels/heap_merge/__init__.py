"""Heap-merge (run tournament) kernel package."""
from repro_torch.kernels.heap_merge.ops import (  # noqa: F401
    heap_merge, merge_round, merge_round_plain)
