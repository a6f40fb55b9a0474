"""bloom_probe: Bloom membership of Q keys in each of a level's D filters.

The wrapper `bloom_probe_many` launches `csrc/bloom_probe.cu` for CUDA
tensors and runs `bloom_probe_plain` for CPU tensors. It counts its
launches in `bloom_probe_many.launches`.
"""
from __future__ import annotations

import torch

from repro_torch.core import bloom as BL
from repro_torch.kernels import _build


def bloom_probe_plain(blooms: torch.Tensor, qs: torch.Tensor, k: int,
                      bits: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: (D, W) int32 filters, (Q,) int32 keys ->
    (D, Q) bool. `bits` = the effective filter width (default W*32)."""
    if bits is None:
        bits = blooms.shape[1] * 32
    pos = BL.probe_positions(qs, k, bits)                      # (Q, k)
    w = blooms[:, pos // 32].to(torch.int64)                   # (D, Q, k)
    return torch.all(((w >> (pos % 32)) & 1) == 1, dim=-1)


def bloom_probe_many(blooms: torch.Tensor, qs: torch.Tensor, k: int,
                     bits: int | None = None) -> torch.Tensor:
    """(D, W) int32 filters, (Q,) int32 keys -> (D, Q) bool membership."""
    if bits is None:
        bits = blooms.shape[1] * 32
    if blooms.device.type == "cpu":
        return bloom_probe_plain(blooms, qs, k, bits)
    if blooms.device.type != "cuda" or qs.device != blooms.device:
        raise ValueError("bloom_probe: blooms and keys must share one "
                         "CUDA device (or both lie on the CPU)")
    if blooms.dtype != torch.int32 or qs.dtype != torch.int32:
        raise TypeError("bloom_probe: int32 filters and keys expected")
    if blooms.dim() != 2 or qs.dim() != 1:
        raise ValueError("bloom_probe: blooms (D, W) and keys (Q,) expected")
    if not (blooms.is_contiguous() and qs.is_contiguous()):
        raise ValueError("bloom_probe: contiguous tensors expected")
    if not 0 < bits <= blooms.shape[1] * 32 or not 0 < k:
        raise ValueError(f"bloom_probe: bad geometry bits={bits} k={k}")
    d_n, q_n = blooms.shape[0], qs.shape[0]
    out = torch.empty((d_n, q_n), dtype=torch.bool, device=blooms.device)
    fn = _build.bind("bloom_probe", "bloom_probe_launch", 3, 5)
    _build.check(fn(qs.data_ptr(), blooms.data_ptr(), out.data_ptr(), d_n,
                    q_n, blooms.shape[1], k, bits,
                    torch.cuda.current_stream(blooms.device).cuda_stream),
                 "bloom_probe")
    bloom_probe_many.launches += 1
    return out


bloom_probe_many.launches = 0
