"""Sorted-run primitives: sort, weighted survivor dedup, k-way merge, fences.

The port of `repro.core.runs` on the Z-set record algebra: a record is
``(key, weight, seq | payload)``, weight +1 for an insert and -1 for a
delete, one tensor per lane. Runs are sorted by (key, seq) and padded
with KEY_EMPTY; the newest record of each key (the last of its equal-key
block) carries the telescoped weight sum; annihilation (dropping keys
whose newest weight is <= 0) happens only in merges into the deepest
data. Merges move the (key, weight, seq, source-index) lanes and gather
the payload once, for surviving rows.

Trap T2 (two-key sort): the reference's ``lax.sort(num_keys=2)`` becomes
one stable sort of the int64 ``(key << 32) | seq``. Seqs are
non-negative int32, so the low word orders exactly as seq does.
Trap T3 (int32 reductions): counts come back as int32.

`merge_two_ranked` and `merge_kway_ranked` are the reference's
rank-merge (its HeapMerge step without a heap), kept for the tests and
benchmarks that hold the merge paths against each other; the engine
merges through `merge_runs` and the heap_merge kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.params import KEY_EMPTY

_KEY_MIN = int(torch.iinfo(torch.int32).min)
_KEY_EMPTY = int(KEY_EMPTY)


def composite(keys: torch.Tensor, seqs: torch.Tensor) -> torch.Tensor:
    """int64 sort key ordering lexicographically by (key, seq) for
    seq >= 0 (trap T2)."""
    return (keys.to(torch.int64) << 32) | seqs.to(torch.int64)


def sort_records(keys, vals, wts, seqs):
    """Sort by (key, seq); vals/wts ride as payload. Sentinels sort to
    the end. Returns (keys, vals, wts, seqs)."""
    order = torch.sort(composite(keys, seqs), dim=-1, stable=True).indices
    return (keys.gather(-1, order), vals.gather(-1, order),
            wts.gather(-1, order), seqs.gather(-1, order))


def survivor_mask(keys: torch.Tensor, wts: torch.Tensor,
                  drop_annihilated: bool) -> torch.Tensor:
    """Valid-mask over a (key, seq)-sorted run (each row of a batch):
    keep the newest record of each key; drop padding; when
    `drop_annihilated`, drop keys whose newest weight is <= 0."""
    nxt = torch.cat([keys[..., 1:],
                     keys.new_full(keys.shape[:-1] + (1,), _KEY_EMPTY)], dim=-1)
    valid = (keys != _KEY_EMPTY) & (keys != nxt)
    if drop_annihilated:
        valid &= wts > 0
    return valid


def partition_order(valid: torch.Tensor) -> torch.Tensor:
    """Stable permutation moving `valid` lanes to the front (of each row,
    for a leading batch dimension)."""
    return torch.sort((~valid).to(torch.int32), dim=-1, stable=True).indices


def compact(keys, vals, wts, seqs, valid):
    """Stable-partition valid elements to the front of each row; pad the
    rest. Returns (keys, vals, wts, seqs, count)."""
    order = partition_order(valid)
    ok = valid.gather(-1, order)
    keys = torch.where(ok, keys.gather(-1, order), _KEY_EMPTY)
    vals = torch.where(ok, vals.gather(-1, order), 0)
    wts = torch.where(ok, wts.gather(-1, order), 0)
    seqs = torch.where(ok, seqs.gather(-1, order), 0)
    return keys, vals, wts, seqs, valid.sum(dim=-1).to(torch.int32)


def merge_runs(keys2d, vals2d, wts2d, seqs2d, drop_annihilated: bool):
    """Merge k sorted runs (k, cap) -> one compacted run (k*cap,).

    Sort-based: one stable sort of the (key, seq) composite moves the
    (key, weight, seq, source-index) lanes; the payload is gathered
    through the survivors' source indices at the end.
    Returns (keys, vals, wts, seqs, count)."""
    k, w, s = keys2d.reshape(-1), wts2d.reshape(-1), seqs2d.reshape(-1)
    order = torch.sort(composite(k, s), stable=True).indices
    k, w, s = k[order], w[order], s[order]
    valid = survivor_mask(k, w, drop_annihilated)
    part = partition_order(valid)
    ok = valid[part]
    keys = torch.where(ok, k[part], _KEY_EMPTY)
    wts = torch.where(ok, w[part], 0)
    seqs = torch.where(ok, s[part], 0)
    vals = torch.where(ok, vals2d.reshape(-1)[order[part]], 0)
    return keys, vals, wts, seqs, valid.sum().to(torch.int32)


def _rank_in(other_k, other_s, qk, qs) -> torch.Tensor:
    """Lower bound of each (qk, qs) in the (key, seq)-sorted run
    (other_k, other_s): the reference's fixed-step binary search, step
    for step, so it ranks as the reference does even in a run that an
    earlier rank-merge left with a gap (see `merge_two_ranked`)."""
    size = other_k.shape[0]
    lo = torch.zeros(qk.shape, dtype=torch.int64, device=qk.device)
    hi = torch.full(qk.shape, size, dtype=torch.int64, device=qk.device)
    for _ in range(max(1, math.ceil(math.log2(size + 1)))):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, size - 1)
        ok_, os_mid = other_k[midc], other_s[midc]
        before = (ok_ < qk) | ((ok_ == qk) & (os_mid < qs))
        active = lo < hi
        lo, hi = (torch.where(active & before, mid + 1, lo),
                  torch.where(active & ~before, mid, hi))
    return lo


def merge_two_ranked(ak, av, aw, as_, bk, bv, bw, bs):
    """Rank-merge of two (key, seq)-sorted runs: a[i] goes to slot
    i + #{b < a[i]}, b[j] to j + #{a < b[j]}, by (key, seq).

    Where a and b hold equal (key, seq) pairs (padding lanes, for
    example) both rank to one slot: as in the reference, a is written
    first and b second, so b's lanes win, and the slot that no element
    reaches keeps KEY_EMPTY and zeros. Returns (keys, vals, wts, seqs)."""
    n, m = ak.shape[0], bk.shape[0]
    pa = torch.arange(n, device=ak.device) + _rank_in(bk, bs, ak, as_)
    pb = torch.arange(m, device=ak.device) + _rank_in(ak, as_, bk, bs)
    out = []
    for a, b, fill in ((ak, bk, _KEY_EMPTY), (av, bv, 0), (aw, bw, 0),
                       (as_, bs, 0)):
        o = a.new_full((n + m,), fill)
        o[pa] = a                       # two scatters: b overwrites a
        o[pb] = b
        out.append(o)
    return tuple(out)


def merge_kway_ranked(keys2d, vals2d, wts2d, seqs2d, drop_annihilated: bool):
    """Tournament of rank-merges over k sorted runs (k, cap): log2(k)
    rounds of `merge_two_ranked`, then survivor dedup and compaction.
    Returns (keys, vals, wts, seqs, count)."""
    runs = [(keys2d[i], vals2d[i], wts2d[i], seqs2d[i])
            for i in range(keys2d.shape[0])]
    while len(runs) > 1:
        nxt = [merge_two_ranked(*runs[i], *runs[i + 1])
               for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    k, v, w, s = runs[0]
    return compact(k, v, w, s, survivor_mask(k, w, drop_annihilated))


def build_fences(keys: torch.Tensor, mu: int, n_fences: int) -> torch.Tensor:
    """Fence pointers (paper 2.4): the key at every mu-th slot."""
    idx = torch.arange(n_fences, dtype=torch.int64, device=keys.device) * mu
    return keys[idx.clamp(0, keys.shape[0] - 1)]


def run_minmax(keys: torch.Tensor, count: torch.Tensor):
    """(min, max) key of a compacted sorted run (paper 2.3 min/max
    filter), as 0-d int32 tensors. Trap T4: a count past the run's
    capacity (a deepest-level overflow, which the scheduler then raises)
    reads the last slot, as JAX clamps the gather."""
    last = keys[(count.to(torch.int64) - 1).clamp(0, keys.shape[0] - 1)]
    mn = torch.where(count > 0, keys[0], _KEY_EMPTY)
    mx = torch.where(count > 0, last, _KEY_MIN)
    return mn.to(torch.int32), mx.to(torch.int32)
