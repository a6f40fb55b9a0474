"""Bloom-probe kernel package."""
from repro_torch.kernels.bloom_probe.ops import (  # noqa: F401
    bloom_probe_levels, bloom_probe_many, bloom_probe_plain)
