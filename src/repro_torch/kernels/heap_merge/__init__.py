"""Heap-merge (k-way run merge) kernel package."""
from repro_torch.kernels.heap_merge.ops import (  # noqa: F401
    heap_merge, kway_merge, kway_merge_plain, merge_round, merge_round_plain)
