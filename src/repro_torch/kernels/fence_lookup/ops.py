"""fence_lookup: fence-pointer page search of Q keys in a level's D runs.

The wrapper `fence_lookup_many` launches `csrc/fence_lookup.cu` for CUDA
tensors and runs `fence_lookup_plain` for CPU tensors, for one tree's
level or, with a leading shard dimension, for that level of every shard
in one launch. It counts its
launches in `fence_lookup_many.launches`. The kernel searches every
(run, query) pair with the run's fences staged in shared memory: all of
them where FENCE_SMEM_BYTES holds them, else every G-th
(`fence_geometry`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def page_search(qs: torch.Tensor, fences: torch.Tensor, keys: torch.Tensor,
                mu: int):
    """The fence-pointer search of each query in each of D runs (paper
    2.4): `upper_bound` over the run's fences, minus one, clamped to a
    fence, times mu gives the page start — pinned to cap - mu, since a
    strided fence view can leave a partial last page (the window still
    covers it; keys are sorted across the whole run) — then the
    `lower_bound` of the query inside the mu-wide page. Trap T4: the pin
    and the clamp to 0 are the reference's `dynamic_slice` start clamp,
    written out. qs (Q,), fences (D, F), keys (D, cap) -> (start (D, Q)
    int64, offset in the page (D, Q), page (D, Q, mu)); leading shard
    dimensions of fences and keys carry through (qs (S, Q) or (Q,), the
    same queries for every shard)."""
    lead, (d_n, cap) = keys.shape[:-2], keys.shape[-2:]
    f = torch.searchsorted(
        fences, qs.unsqueeze(-2).expand(*lead, d_n, -1).contiguous(),
        right=True) - 1
    start = (f.clamp(0, fences.shape[-1] - 1) * mu).clamp(max=cap - mu)
    start = start.clamp(min=0)
    lane = torch.arange(mu, device=keys.device)
    win = keys.gather(-1, (start[..., None] + lane).reshape(*lead, d_n, -1))
    win = win.reshape(start.shape + (mu,))
    return start, (win < qs[..., None, :, None]).sum(dim=-1), win


def fence_lookup_plain(qs, fences, keys, counts, mu: int) -> torch.Tensor:
    """Plain PyTorch version: qs (Q,), fences (D, F), keys (D, cap),
    counts (D,) -> (D, Q) int32 element index of each hit, or -1. With
    a leading shard dimension (qs (S, Q), fences (S, D, F), ...) shard
    s's runs search query row s."""
    start, off, win = page_search(qs, fences, keys, mu)
    offc = off.clamp(max=mu - 1)
    hit = ((off < mu)
           & (win.gather(-1, offc[..., None])[..., 0] == qs[..., None, :])
           & (start + offc < counts[..., None]))
    return torch.where(hit, start + offc, -1).to(torch.int32)


FENCE_SMEM_BYTES = 48 * 1024   # a run's fences a CTA stages


def fence_geometry(f_n: int) -> tuple[int, int]:
    """(group G, staged) of the kernel for runs of `f_n` fences: every
    G-th fence is staged in shared memory, `staged` = ceil(F / G) of
    them, G the least power of two whose staged fences fit
    FENCE_SMEM_BYTES. The search then takes log2(G) steps in L2."""
    group = 1
    while 4 * -(-f_n // group) > FENCE_SMEM_BYTES:
        group *= 2
    return group, -(-f_n // group)


def fence_lookup_many(qs, fences, keys, counts, mu: int) -> torch.Tensor:
    """qs (Q,), fences (D, F), keys (D, cap), counts (D,), page width mu
    -> (D, Q) int32 hit indices, -1 for misses. With a leading shard
    dimension — qs (S, Q), fences (S, D, F), keys (S, D, cap), counts
    (S, D) -> (S, D, Q), shard s's runs searching query row s (the
    reference's kernel under `jax.vmap`) — still one launch."""
    if keys.device.type == "cpu":
        return fence_lookup_plain(qs, fences, keys, counts, mu)
    dev = keys.device
    if keys.device.type != "cuda" or any(t.device != dev
                                         for t in (qs, fences, counts)):
        raise ValueError("fence_lookup: all tensors must share one CUDA "
                         "device (or all lie on the CPU)")
    if any(t.dtype != torch.int32 for t in (qs, fences, keys, counts)):
        raise TypeError("fence_lookup: int32 tensors expected")
    if not all(t.is_contiguous() for t in (qs, fences, keys, counts)):
        raise ValueError("fence_lookup: contiguous tensors expected")
    lead = keys.shape[:-2]
    d_n, cap = keys.shape[-2:]
    f_n = fences.shape[-1]
    if (len(lead) > 1 or fences.shape[:-1] != keys.shape[:-1]
            or counts.shape != keys.shape[:-1] or qs.shape[:-1] != lead
            or qs.dim() != len(lead) + 1):
        raise ValueError("fence_lookup: shapes (Q,), (D, F), (D, cap), "
                         "(D,) expected, or (S, Q), (S, D, F), "
                         "(S, D, cap), (S, D)")
    if not (f_n >= 1 and f_n * mu >= cap >= mu):
        raise ValueError("fence_lookup: fences must cover the run")
    q_n = qs.shape[-1]
    runs = counts.numel()
    if runs > 65535:
        raise ValueError(f"fence_lookup: at most 65,535 runs (shards x D) "
                         f"a launch, not {runs}")
    out = torch.empty(lead + (d_n, q_n), dtype=torch.int32, device=dev)
    group, staged = fence_geometry(f_n)
    fn = _build.bind("fence_lookup", "fence_lookup_launch", 5, 8)
    _build.check(fn(qs.data_ptr(), fences.data_ptr(), keys.data_ptr(),
                    counts.data_ptr(), out.data_ptr(), runs, q_n, f_n, cap,
                    mu, max(d_n, 1), group, staged,
                    torch.cuda.current_stream(dev).cuda_stream),
                 "fence_lookup")
    fence_lookup_many.launches += 1
    return out


fence_lookup_many.launches = 0


def work(q: int, runs: int, fence_words: int, key_words: int,
         shards: int = 1) -> tuple[float, float]:
    """(FLOPs, bytes) of one call, each input byte it needs read once and
    each output byte written once: `q` int32 keys, the `runs` counts and
    an int32 slot for each (run, key), in each of `shards` shards, and
    the distinct fence and key words the searches read (this call's
    data). Integer work: 0 FLOPs."""
    return 0.0, float(shards * (q * 4 + runs * 4 + runs * q * 4)
                      + (fence_words + key_words) * 4)
