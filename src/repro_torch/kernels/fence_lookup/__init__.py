"""Fence-lookup kernel package."""
from repro_torch.kernels.fence_lookup.ops import (  # noqa: F401
    fence_lookup_many, fence_lookup_plain)
