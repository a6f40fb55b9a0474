"""Range-merge (scan merge-dedup) kernel package."""
from repro_torch.kernels.range_merge.ops import (  # noqa: F401
    merge_round, merge_round_plain, range_merge, range_merge_plain)
