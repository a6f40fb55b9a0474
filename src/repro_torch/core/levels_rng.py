"""Fast O(1) geometric skiplist levels (paper 2.2.1), port of
`repro.core.levels_rng`.

The paper replaces the coin-flip loop with: draw MAXLEVEL random bits,
return find-first-set, so P(level = n) = 2^-n, exactly geometric(p=.5).
One vector expression makes a whole batch: isolate the lowest set bit
with `r & -r`, then count its trailing zeros.

The draws are not the reference's (`jax.random.bits` is another
generator); the distribution is. Trap T1 again: torch's uint32 tensors
lack `>>`, `%` and `+`, so the bits live in int64 masked to `maxlevel`
bits, and, torch having no popcount, the trailing zeros of the isolated
bit (a power of two) are counted exactly by comparing it with the
powers of two below 2^maxlevel.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

MAXLEVEL = 16  # paper 2.2.1: experimentally optimal


def fast_geometric_levels(generator: torch.Generator, shape: tuple[int, ...],
                          maxlevel: int = MAXLEVEL,
                          device=None) -> torch.Tensor:
    """int32 levels in [1, maxlevel] of `shape`, P(level = n) = 2^-n
    (capped at maxlevel), drawn from `generator` on `device` (the card
    unless the caller asks for the CPU; the generator must live there).

    The port of the paper's `ffs(random_bits)`: O(1) per element."""
    device = resolve_device(device)
    r = torch.randint(0, 1 << maxlevel, tuple(shape), generator=generator,
                      dtype=torch.int64, device=device)
    lowest = r & -r                       # 0 where r == 0, else 2^ctz
    ctz = torch.zeros_like(r)
    for j in range(1, maxlevel):
        ctz += lowest >= (1 << j)
    # r == 0 (prob 2^-maxlevel) -> cap at maxlevel; ffs is 1-based.
    level = torch.where(r == 0, maxlevel - 1, ctz) + 1
    return level.clamp(max=maxlevel).to(torch.int32)


def express_lane_offsets(rn: int) -> list[int]:
    """Deterministic express lanes: lane l samples every 2^l-th key.

    The dense-array limit of the paper's 2.2.2 "vertical arrays": the
    geometric level distribution realized as strided samples over a
    sorted run, a skiplist descent over contiguous memory instead of
    pointer chasing.
    """
    lanes = []
    stride = 1
    while stride < rn:
        lanes.append(stride)
        stride *= 2
    return lanes
