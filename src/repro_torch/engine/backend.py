"""Ops-dispatch layer: the engine's four hot primitives and their helpers.

The reference picks its primitives by `SLSMParams.backend` ("jnp" or
"pallas"). The port picks by device instead: each of the four slots is a
kernel wrapper from `repro_torch.kernels`, which launches the CUDA kernel
for CUDA tensors and runs its plain PyTorch version for CPU tensors.

  bloom_probe_levels: ([(blooms (D_l, W_l) i32, k_l, bits_l), ...], qs (Q,))
                     -> [(D_l, Q) bool, ...]   [one launch, every level]
  bloom_probe_many:  (blooms (D, W) i32, qs (Q,), k, bits) -> (D, Q) bool
  fence_lookup_many: (qs (Q,), fences (D, F), keys (D, cap), counts (D,),
                      mu) -> (D, Q) i32 idx | -1
  merge_runs:        (keys (k, cap), vals, wts, seqs, drop)
                     -> (keys, vals, wts, seqs, count)   [heap_merge]
  range_merge:       (keys (Q, C), vals, wts, seqs, offsets (Q, P+1),
                      drop) -> (keys, vals, wts, seqs, keep)

The helpers around them (`strided_fences`, `fence_window_idx`,
`fence_window_bounds`, `in_window`, `candidate_gate`, `gated_hits`,
`lookup_level_many`) are plain tensor code on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bloom_probe import (bloom_probe_levels,
                                             bloom_probe_many)
from repro_torch.kernels.fence_lookup import fence_lookup_many
from repro_torch.kernels.fence_lookup.ops import page_search
from repro_torch.kernels.heap_merge import heap_merge as merge_runs
from repro_torch.kernels.range_merge import range_merge

__all__ = ["bloom_probe_levels", "bloom_probe_many", "fence_lookup_many",
           "merge_runs", "range_merge", "strided_fences",
           "fence_window_idx", "fence_window_bounds", "in_window",
           "candidate_gate", "gated_hits", "lookup_level_many"]


def strided_fences(fences: torch.Tensor, stride: int) -> torch.Tensor:
    """A level's effective fence array under the stride view: every
    stride-th fence (an (mu*stride)-wide page window). Stride 1 returns
    the physical array untouched."""
    return fences[..., ::stride].contiguous() if stride > 1 else fences


def fence_window_idx(queries, fences, keys, count, mu: int) -> torch.Tensor:
    """Fence-pointer lookup on one disk run (paper 2.4): binary-search the
    fences, then the mu-wide page they bound. Returns the element index
    of the hit, or -1."""
    return fence_lookup_many(queries, fences[None], keys[None],
                             count.reshape(1), mu)[0]


def in_window(qs, mins, maxs) -> torch.Tensor:
    """(D, Q) mask: query q lies in run d's [min, max] window (with the
    operands' leading shard dimension, if any)."""
    q = qs[..., None, :]
    return (q >= mins[..., :, None]) & (q <= maxs[..., :, None])


def candidate_gate(qs, blooms, mins, maxs, k: int,
                   bits: int | None = None) -> torch.Tensor:
    """(D, Q) candidate mask over one level's runs: min/max window AND
    Bloom positive (paper 2.3)."""
    return in_window(qs, mins, maxs) & bloom_probe_many(blooms, qs, k, bits)


def gated_hits(qs, bloom, mins, maxs, fences, keys, counts, mu: int):
    """A level's hits from its Bloom verdicts `bloom` (D, Q): one
    fence-search launch covers every (run, query) pair, and a pair hits
    where it is in its run's window, Bloom positive and found. Returns
    ``(hit (D, Q) bool, idx (D, Q) i32)``; ``idx`` is clamped to a
    gatherable index (meaningful only where ``hit``)."""
    idx = fence_lookup_many(qs, fences, keys, counts, mu)
    gate = in_window(qs, mins, maxs) & bloom
    return gate & (idx >= 0), idx.clamp(min=0)


def lookup_level_many(qs, blooms, mins, maxs, fences, keys, counts, k: int,
                      mu: int, bits: int | None = None):
    """One candidate pass over all D runs of a level for Q queries: the
    level's Bloom probes, then `gated_hits`."""
    return gated_hits(qs, bloom_probe_many(blooms, qs, k, bits), mins, maxs,
                      fences, keys, counts, mu)


def fence_window_bounds(lo, hi, fences, keys, counts, mu: int):
    """[start, end) element bounds of each window [lo, hi) in each of a
    level's D runs, located through the fence pointers (paper 2.4/2.9):
    the page each bound falls in, then a search inside that mu-wide page.
    lo/hi (Q,), fences (D, F), keys (D, cap), counts (D,) -> (start, end)
    (D, Q) int32 with start <= end <= count; fences, keys and counts may
    carry a leading shard dimension (the windows are every shard's)."""
    def locate(q):
        start, off, _ = page_search(q, fences, keys, mu)
        return start + off

    start, end = locate(lo), locate(hi)
    end = torch.minimum(end, counts[..., None].to(end.dtype))
    return torch.minimum(start, end).to(torch.int32), end.to(torch.int32)
