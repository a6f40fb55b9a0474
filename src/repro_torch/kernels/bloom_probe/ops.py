"""bloom_probe: Bloom membership of Q keys in every run of every disk level.

`bloom_probe_levels` takes one lookup batch's keys and each level's
filter stack, with the level's own k and bits — of one tree, or of S
trees with a leading shard dimension: on CUDA tensors it is one launch
of `csrc/bloom_probe.cu` for all of them, on CPU tensors it runs
`bloom_probe_plain` level by level. `bloom_probe_many` is the same for
one stack. Launches are counted in `bloom_probe_levels.launches`.
"""
from __future__ import annotations

import array
from typing import Sequence

import torch

from repro_torch.core import bloom as BL
from repro_torch.kernels import _build

MAX_LEVELS = 16     # levels one launch takes (bloom_probe.cu kMaxLevels)


def bloom_probe_plain(blooms: torch.Tensor, qs: torch.Tensor, k: int,
                      bits: int | None = None) -> torch.Tensor:
    """Plain PyTorch version: (..., D, W) int32 filters, (..., Q) int32
    keys with the same leading (shard) dimensions -> (..., D, Q) bool.
    `bits` = the effective filter width (default W*32)."""
    if bits is None:
        bits = blooms.shape[-1] * 32
    lead, d_n, q_n = qs.shape[:-1], blooms.shape[-2], qs.shape[-1]
    pos = BL.probe_positions(qs, k, bits)                     # (..., Q, k)
    idx = (pos // 32).reshape(*lead, 1, q_n * k).expand(*lead, d_n, -1)
    w = blooms.gather(-1, idx).to(torch.int64).reshape(*lead, d_n, q_n, k)
    bit = (w >> (pos % 32).unsqueeze(-3)) & 1                # (..., D, Q, k)
    return torch.all(bit == 1, dim=-1)


def _check(blooms: torch.Tensor, qs: torch.Tensor, k: int, bits: int):
    if blooms.device != qs.device:
        raise ValueError("bloom_probe: filters and keys must share one "
                         "CUDA device (or all lie on the CPU)")
    if blooms.dtype != torch.int32 or qs.dtype != torch.int32:
        raise TypeError("bloom_probe: int32 filters and keys expected")
    if blooms.dim() != qs.dim() + 1 or qs.dim() not in (1, 2) or (
            blooms.shape[:-2] != qs.shape[:-1]):
        raise ValueError("bloom_probe: blooms (D, W) and keys (Q,), or "
                         "blooms (S, D, W) and keys (S, Q), expected")
    if not (blooms.is_contiguous() and qs.is_contiguous()):
        raise ValueError("bloom_probe: contiguous tensors expected")
    if not 0 < bits <= min(blooms.shape[-1] * 32, 2 ** 31 - 1) or not 0 < k:
        raise ValueError(f"bloom_probe: bad geometry bits={bits} k={k}")


def bloom_probe_levels(stacks: Sequence, qs: torch.Tensor
                       ) -> list[torch.Tensor]:
    """Bloom membership of keys (Q,) int32 in each level's filters.

    `stacks` holds one ``(blooms (D_l, W_l) int32, k_l, bits_l)`` a level
    (bits None: W_l * 32). Returns one (D_l, Q) bool a level. With a
    leading shard dimension — keys (S, Q), filters (S, D_l, W_l) — shard
    s's runs probe key row s and each level gives (S, D_l, Q): the
    reference's kernel under `jax.vmap`. On the card every level of
    every shard goes in one launch, whose output is one (S * sum D_l, Q)
    tensor cut into views."""
    dev = qs.device
    if dev.type == "cpu" and all(b.device.type == "cpu"
                                 for b, _, _ in stacks):
        return [bloom_probe_plain(b, qs, k, bits) for b, k, bits in stacks]
    if dev.type != "cuda":
        raise ValueError("bloom_probe: filters and keys must share one "
                         "CUDA device (or all lie on the CPU)")
    if len(stacks) > MAX_LEVELS:
        raise ValueError(f"bloom_probe: {len(stacks)} levels, one launch "
                         f"takes at most {MAX_LEVELS}")
    # the kernel's level table: filters' address, D, W, k, bits a level
    table, rows = array.array("q"), 0
    lead = qs.shape[:-1]
    n_shards = qs.shape[0] if lead else 1
    for b, k, bits in stacks:
        if bits is None:
            bits = b.shape[-1] * 32
        _check(b, qs, k, bits)
        table.extend((b.data_ptr(), b.shape[-2], b.shape[-1], k, bits))
        rows += n_shards * b.shape[-2]
    q_n = qs.shape[-1]
    out = torch.empty((rows, q_n), dtype=torch.bool, device=dev)
    if rows and q_n:
        fn = _build.bind("bloom_probe", "bloom_probe_shards_launch", 3, 3)
        _build.check(fn(qs.data_ptr(), out.data_ptr(), table.buffer_info()[0],
                        len(stacks), q_n, n_shards,
                        torch.cuda.current_stream(dev).cuda_stream),
                     "bloom_probe")
        bloom_probe_levels.launches += 1
    views, r0 = [], 0
    for b, _, _ in stacks:
        n = n_shards * b.shape[-2]
        views.append(out[r0:r0 + n].view(*lead, b.shape[-2], q_n))
        r0 += n
    return views


bloom_probe_levels.launches = 0


def bloom_probe_many(blooms: torch.Tensor, qs: torch.Tensor, k: int,
                     bits: int | None = None) -> torch.Tensor:
    """(D, W) int32 filters, (Q,) int32 keys -> (D, Q) bool membership:
    `bloom_probe_levels` with one level (a leading shard dimension
    allowed, as there)."""
    return bloom_probe_levels([(blooms, k, bits)], qs)[0]


def work(q: int, rows: int, words: int, shards: int = 1
         ) -> tuple[float, float]:
    """(FLOPs, bytes) of one call, each input byte it needs read once and
    each output byte written once: `q` int32 keys and a verdict byte for
    each of the `rows` filters probed (all levels), in each of `shards`
    shards, and the `words` distinct filter words the probes read (this
    call's data). Integer work: 0 FLOPs."""
    return 0.0, float(shards * (q * 4 + rows * q) + words * 4)
