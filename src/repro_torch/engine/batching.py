"""Batching policy: the pad/bucket grid of the batched entry points.

The port keeps the reference's grid (`repro.engine.batching`) so both
engines see the same padded widths: `bucket_pow2` for lookups (the
coarser `ADAPTIVE_BUCKETS` under adaptive tuning), `RANGE_BUCKETS` for
scans, `TAPE_BUCKETS` for mixed-op tape slots, KEY_EMPTY padding, and
`range_many_host`, the pad/dispatch/trim helper of `range_many`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.params import KEY_EMPTY

# adaptive engines quantize batched-lookup lanes to this coarse grid
ADAPTIVE_BUCKETS = (256, 1024, 4096)

# batched range scans quantize to this scan-count grid
RANGE_BUCKETS = (8, 32)

# mixed-op tapes quantize their slot count to this grid (NOP slots pad)
TAPE_BUCKETS = (4, 16, 64)


def bucket_pow2(n: int, floor: int = 16) -> int:
    """Round a query count up to the next power-of-two bucket (>= floor)."""
    return max(floor, 1 << (n - 1).bit_length())


def pad_to(qs: np.ndarray, width: int) -> np.ndarray:
    """Pad a query vector with KEY_EMPTY to `width` lanes."""
    out = np.full(width, KEY_EMPTY, np.int32)
    out[:len(qs)] = qs
    return out


def pad_pow2(qs: np.ndarray) -> np.ndarray:
    """Pad a query vector with KEY_EMPTY to its `bucket_pow2` width."""
    return pad_to(qs, bucket_pow2(len(qs)))


def _grid_bucket(grid: tuple, n: int) -> int:
    """Smallest bucket of `grid` holding n (pow2 past the grid)."""
    for b in grid:
        if n <= b:
            return b
    return bucket_pow2(n)


def adaptive_bucket(n: int) -> int:
    """Smallest adaptive lookup bucket holding n lanes."""
    return _grid_bucket(ADAPTIVE_BUCKETS, n)


def range_bucket(n: int) -> int:
    """Smallest scan-count bucket holding n lanes."""
    return _grid_bucket(RANGE_BUCKETS, n)


def tape_bucket(n: int) -> int:
    """Smallest tape-slot bucket holding n slots."""
    return _grid_bucket(TAPE_BUCKETS, n)


def pad_windows(ranges, device):
    """(Q, 2) windows -> (q, los, his) with los/his int32 tensors on
    `device` padded to the `RANGE_BUCKETS` grid (zeros past q)."""
    r = np.asarray(ranges, np.int32).reshape(-1, 2)
    q = r.shape[0]
    width = range_bucket(max(q, 1))
    los = np.zeros(width, np.int32)
    his = np.zeros(width, np.int32)
    los[:q], his[:q] = r[:, 0], r[:, 1]
    return q, torch.from_numpy(los).to(device), torch.from_numpy(his).to(
        device)


def range_many_host(dispatch, max_range: int, ranges, device):
    """Shared `range_many` host loop: pad the scan list to the bucket grid,
    run ``dispatch(los, his, n_valid)``, trim back to the Q requested
    rows as numpy arrays."""
    q, los, his = pad_windows(ranges, device)
    if q == 0:
        return (np.zeros((0, max_range), np.int32),
                np.zeros((0, max_range), np.int32),
                np.zeros(0, np.int32), np.zeros(0, bool))
    k, v, c, trunc = dispatch(los, his, q)
    return (k[:q].cpu().numpy(), v[:q].cpu().numpy(), c[:q].cpu().numpy(),
            trunc[:q].cpu().numpy())
