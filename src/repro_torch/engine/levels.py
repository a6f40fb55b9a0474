"""Disk-tier state (paper 2.4): D immutable sorted runs per level.

A level is a NamedTuple of tensors: run payloads plus the per-run index
structures the paper attaches to disk runs — min/max keys, a Bloom
filter and fence pointers every mu slots — in the reference's field
order (`repro.engine.levels.LevelState`). Slot 0 is always the oldest
resident run; `shift_level` keeps that invariant when runs spill.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bloom as BL
from repro_torch.core import runs as RU
from repro_torch.core.params import KEY_EMPTY, SLSMParams

I32 = torch.int32
_KEY_EMPTY = int(KEY_EMPTY)
# -inf key sentinel for "max key of an empty run"
_KEY_MIN = -(2 ** 31)


class LevelState(NamedTuple):
    """One disk tier: D immutable sorted runs (paper 2.4)."""
    keys: torch.Tensor    # (D, cap_l) sorted ascending, KEY_EMPTY padded
    vals: torch.Tensor    # (D, cap_l)
    wts: torch.Tensor     # (D, cap_l) record weights: +1 insert, -1 delete
    seqs: torch.Tensor    # (D, cap_l)
    counts: torch.Tensor  # (D,)
    mins: torch.Tensor    # (D,)
    maxs: torch.Tensor    # (D,)
    blooms: torch.Tensor  # (D, words_l) int32 words holding uint32 bits
    fences: torch.Tensor  # (D, n_fences_l)
    n_runs: torch.Tensor  # () occupied run slots (oldest = slot 0)


def empty_level(p: SLSMParams, level: int, device,
                n_shards: int | None = None) -> LevelState:
    """Fresh all-empty tier with `level_cap(level)` geometry (with
    `n_shards`, a leading shard dimension on every leaf)."""
    cap = p.level_cap(level)
    w = p.bloom_words_physical(cap, p.level_eps(level))
    lead = () if n_shards is None else (n_shards,)

    def full(shape, fill):
        return torch.full(lead + shape, fill, dtype=I32, device=device)

    return LevelState(
        keys=full((p.D, cap), _KEY_EMPTY), vals=full((p.D, cap), 0),
        wts=full((p.D, cap), 0), seqs=full((p.D, cap), 0),
        counts=full((p.D,), 0), mins=full((p.D,), _KEY_EMPTY),
        maxs=full((p.D,), _KEY_MIN), blooms=full((p.D, w), 0),
        fences=full((p.D, p.n_fences(level)), _KEY_EMPTY),
        n_runs=full((), 0))


def index_new_run(p: SLSMParams, level: int, k, v, w_, s, cnt):
    """Pad a merged run to level capacity; build its Bloom filter and
    min/max index (paper 2.3) and fence pointers every mu slots (2.4).
    The filter is built at the pre-pad width: padding adds only
    KEY_EMPTY lanes, which the valid mask drops, so it is bit-identical
    to building after padding."""
    cap = p.level_cap(level)
    bits, _, kk = p.bloom_geometry(cap, p.level_eps(level))
    w = p.bloom_words_physical(cap, p.level_eps(level))
    pad = cap - k.shape[0]
    if pad < 0:  # deepest-level compaction scratch is larger than cap
        k, v, w_, s = k[:cap], v[:cap], w_[:cap], s[:cap]
    filt = BL.bloom_build(k, k != _KEY_EMPTY, w, kk, bits)
    if pad > 0:
        k = torch.cat([k, k.new_full((pad,), _KEY_EMPTY)])
        v = torch.cat([v, v.new_zeros(pad)])
        w_ = torch.cat([w_, w_.new_zeros(pad)])
        s = torch.cat([s, s.new_zeros(pad)])
    fences = RU.build_fences(k, p.mu, p.n_fences(level))
    mn, mx = RU.run_minmax(k, cnt)
    return k, v, w_, s, filt, fences, mn, mx


def set_level_run(lv: LevelState, slot: int, k, v, w, s, cnt, filt, fences,
                  mn, mx, bump: int = 1) -> LevelState:
    """Install an indexed run into `slot` (runs land append-order, newest
    last — the recency order Do-Merge relies on, paper 2.5).

    Writes the slot in place: a level's arrays are hundreds of MB at the
    paper geometry, and copying all D runs to replace one would double
    the traffic of every merge. Only the engine's own state holds them."""
    for dst, src in ((lv.keys, k), (lv.vals, v), (lv.wts, w), (lv.seqs, s),
                     (lv.counts, cnt), (lv.mins, mn), (lv.maxs, mx),
                     (lv.blooms, filt), (lv.fences, fences)):
        dst[slot] = src
    return lv._replace(n_runs=lv.n_runs + bump)


def shift_level(p: SLSMParams, lv: LevelState, n: int) -> LevelState:
    """Drop the n oldest runs (slots [0, n)), shifting the rest down —
    the source-level half of a Do-Merge spill (paper 2.5)."""
    def roll(a, fill):
        return torch.cat([a[n:], a.new_full((n,) + a.shape[1:], fill)])
    return LevelState(
        keys=roll(lv.keys, _KEY_EMPTY), vals=roll(lv.vals, 0),
        wts=roll(lv.wts, 0), seqs=roll(lv.seqs, 0),
        counts=roll(lv.counts, 0), mins=roll(lv.mins, _KEY_EMPTY),
        maxs=roll(lv.maxs, _KEY_MIN), blooms=roll(lv.blooms, 0),
        fences=roll(lv.fences, _KEY_EMPTY), n_runs=lv.n_runs - n)
