"""Read path (paper 2.7/2.9): point lookups, range scans, aggregates.

Lookups walk newest -> oldest across every structure — staging buffer,
sealed memory runs, then each disk level — keeping the match with the
highest seqno; presence is the sign of the newest record's weight. Disk
levels are gated by min/max windows AND Bloom positives (paper 2.3):
one `bloom_probe` launch a batch covers every (level, run, query) triple
(`backend.bloom_probe_levels`). Two disk searches follow it:

  dense  — one `fence_lookup` launch a level covers every (run, query)
           pair (`backend.gated_hits`). Exact; the default.
  sparse — the gated (run, query) pairs are compacted, in row-major
           order, to `cand_factor` a query; only those do the fence and
           page search (torch ops, as in the reference, whose per-pair
           search is plain jnp). Pairs past the cap are dropped, the
           pairs the reference drops.

With `skip_empty` (the adaptive engine's read path) a structure that
holds no run is left out: the memory runs when `run_count` is 0, an
empty disk level out of the `bloom_probe_levels` stacks and out of its
fence search. The occupancy comes from the host (`SLSM.runs`, which
each adaptive scheduler step stores), so a lookup adds no blocking
read.
`level_probe_stats` is the tuner's per-level probe telemetry.

Range scans run the fence-pruned scan engine: every structure's window
bounds come through the fence machinery, the in-window extents are
gathered front-compacted into one candidate row of width
`range_cand_eff`, and the `range_merge` tournament returns the rows in
(key, seq) order with the survivor mask. `aggregate_many` reduces the
same mask to count/sum.

PyTorch runs eagerly, so the reference's `*_impl` forms and their jitted
wrappers are one function here. The dense lookup, the scans and the
aggregates also take a state with a leading shard dimension (the
sharded engine's stacked state, `engine.sharded`): every op is then the
single-tree op batched over the shards, as the reference vmaps it — one
`bloom_probe` launch a batch and one `fence_lookup` launch a level for
all shards, and each scan batch's S x Q candidate rows in one
`range_merge` call. Queries are (S, Q) there (each shard its own), scan
windows (Q,) (every shard the same).
"""
from __future__ import annotations

import torch

from repro_torch.core.params import KEY_EMPTY, SEQ_NONE, SLSMParams
from repro_torch.engine import backend as BE
from repro_torch.engine.levels import LevelState
from repro_torch.engine.memtable import SLSMState

I32 = torch.int32
_KEY_EMPTY = int(KEY_EMPTY)
_SEQ_NONE = int(SEQ_NONE)
_I32_MIN = -(2 ** 31)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (trap T3: a torch
    sum of int32 is int64; the reference's int32 sums wrap)."""
    return (((x + 2 ** 31) % 2 ** 32) - 2 ** 31).to(I32)


def consider(best_seq, best_val, best_wt, seq_c, val_c, wt_c):
    """Newest-wins fold (paper 2.7): keep the candidate iff its seqno is
    higher."""
    take = seq_c > best_seq
    return (torch.where(take, seq_c, best_seq),
            torch.where(take, val_c, best_val),
            torch.where(take, wt_c, best_wt))


def _pick_newest(seqs, vals, wts):
    """Per query (column) the row with the highest seqno (first on ties,
    as `argmax` picks)."""
    j = torch.argmax(seqs, dim=-2, keepdim=True)
    return (seqs.gather(-2, j).squeeze(-2), vals.gather(-2, j).squeeze(-2),
            wts.gather(-2, j).squeeze(-2))


def search_stage(state: SLSMState, qs: torch.Tensor):
    """Probe the staging buffer for Q queries; per-query (seq, val, wt)
    with seq=SEQ_NONE on a miss."""
    eq = state.stage_keys[..., None, :] == qs[..., :, None]   # (Q, 2Rn)
    seqm = torch.where(eq, state.stage_seqs[..., None, :], _SEQ_NONE)
    j = torch.argmax(seqm, dim=-1)
    seq_c = seqm.gather(-1, j[..., None])[..., 0]
    hit = seq_c >= 0
    return (seq_c, torch.where(hit, state.stage_vals.gather(-1, j), 0),
            torch.where(hit, state.stage_wts.gather(-1, j), 0))


def search_memory_runs(state: SLSMState, qs: torch.Tensor):
    """All R sealed memory runs in one pass (paper 2.2/2.7): a binary
    search per (run, query), newest-wins across runs."""
    keys = state.buf_keys
    lead, (r_n, rn) = keys.shape[:-2], keys.shape[-2:]
    i = torch.searchsorted(
        keys, qs.unsqueeze(-2).expand(*lead, r_n, -1).contiguous())  # (R, Q)
    ic = i.clamp(max=rn - 1)
    hit = ((i < state.buf_counts[..., None])
           & (keys.gather(-1, ic) == qs.unsqueeze(-2)))
    return _pick_newest(
        torch.where(hit, state.buf_seqs.gather(-1, ic), _SEQ_NONE),
        torch.where(hit, state.buf_vals.gather(-1, ic), 0),
        torch.where(hit, state.buf_wts.gather(-1, ic), 0))


def bloom_verdicts(p: SLSMParams, levels, qs: torch.Tensor, which=None):
    """The Bloom verdicts of the disk levels `which` (default: all of
    `levels`) for Q queries, (D, Q) bool a level, from one
    `bloom_probe_levels` call (each level with its own k and bits)."""
    which = range(len(levels)) if which is None else which
    stacks = []
    for level in which:
        bits, _, kk = p.bloom_geometry(p.level_cap(level),
                                       p.level_eps(level))
        stacks.append((levels[level].blooms, kk, bits))
    return BE.bloom_probe_levels(stacks, qs)


def search_level_dense(p: SLSMParams, lv: LevelState, level: int,
                       qs: torch.Tensor, bloom: torch.Tensor):
    """Exact disk-level search: the level's Bloom verdicts `bloom` (D, Q)
    AND its min/max windows AND one fence-search pass over all (run,
    query) pairs, then newest-wins across the D runs."""
    stride, mu_eff = p.fence_view(level)
    fences = BE.strided_fences(lv.fences, stride)
    hit, idxc = BE.gated_hits(qs, bloom, lv.mins, lv.maxs, fences, lv.keys,
                              lv.counts, mu_eff)
    idxc = idxc.long()
    return _pick_newest(
        torch.where(hit, lv.seqs.gather(-1, idxc), _SEQ_NONE),
        torch.where(hit, lv.vals.gather(-1, idxc), 0),
        torch.where(hit, lv.wts.gather(-1, idxc), 0))


def _run_key(run: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """int64 composite ordered by (run, key) for int32 keys."""
    return (run << 32) | (key.long() + 2 ** 31)


def compact_pairs(gate: torch.Tensor, cap: int) -> torch.Tensor:
    """The first `cap` set entries of a (D, Q) mask in row-major order,
    as flat indices d * Q + q, -1 past the last — what the reference's
    ``jnp.nonzero(gate, size=cap, fill_value=-1)`` keeps. A cumsum and a
    scatter to the fixed width: no host read of the count."""
    flat = gate.reshape(-1)
    rank = torch.cumsum(flat, 0) - 1
    slot = torch.where(flat & (rank < cap), rank, cap)
    out = torch.full((cap + 1,), -1, dtype=torch.int64, device=gate.device)
    out.scatter_(0, slot, torch.arange(flat.numel(), device=gate.device))
    return out[:cap]


def search_level_sparse(p: SLSMParams, lv: LevelState, level: int,
                        qs: torch.Tensor, bloom: torch.Tensor):
    """Bloom-compacted disk search: only gated (run, query) pairs do the
    fence and page search. At most `cand_factor` pairs a query on
    average; an overflowing gate drops the pairs past the cap (in
    row-major (run, query) order), which can miss a hit, as in the
    reference."""
    q_n = qs.shape[0]
    gate = BE.in_window(qs, lv.mins, lv.maxs) & bloom            # (D, Q)
    pair = compact_pairs(gate, q_n * p.cand_factor)
    ok = pair >= 0
    d_c = torch.where(ok, pair // q_n, 0)
    q_c = torch.where(ok, pair % q_n, 0)
    qk = qs[q_c]
    stride, mu_eff = p.fence_view(level)
    fences = BE.strided_fences(lv.fences, stride)
    n_f, cap = fences.shape[1], lv.keys.shape[1]
    # each pair's fence: one search over every run's fences as (run, key)
    # composites, sorted run after run
    runs = torch.arange(fences.shape[0], device=qs.device)[:, None]
    f = torch.searchsorted(_run_key(runs, fences).reshape(-1),
                           _run_key(d_c, qk), right=True) - d_c * n_f - 1
    # a partial last page of a stride view: the window is pinned inside
    # the run (keys are sorted, so the wider reach still refines right)
    st = (f.clamp(0, n_f - 1) * mu_eff).clamp(max=cap - mu_eff)
    flat = lv.keys.reshape(-1)
    windows = flat.as_strided((flat.numel() - mu_eff + 1, mu_eff), (1, 1))
    win = windows[d_c * cap + st]                          # (pairs, mu_eff)
    off = torch.searchsorted(win, qk[:, None])[:, 0]
    idx = st + off.clamp(max=mu_eff - 1)
    at = d_c * cap + idx
    hit = ((off < mu_eff) & (flat[at] == qk) & (idx < lv.counts[d_c]))
    seq_c = torch.where(ok & hit, lv.seqs.reshape(-1)[at], _SEQ_NONE)
    val_c = torch.where(hit, lv.vals.reshape(-1)[at], 0)
    wt_c = torch.where(hit, lv.wts.reshape(-1)[at], 0)
    # newest wins a query: amax of the seqs, then of the winners' lanes
    best_seq = torch.full((q_n,), _SEQ_NONE, dtype=I32, device=qs.device)
    best_seq.scatter_reduce_(0, q_c, seq_c, "amax")
    newest = ok & (seq_c == best_seq[q_c]) & (seq_c >= 0)
    best = []
    for lane in (val_c, wt_c):
        out = torch.full((q_n,), _I32_MIN, dtype=I32, device=qs.device)
        best.append(out.scatter_reduce_(0, q_c,
                                        torch.where(newest, lane, _I32_MIN),
                                        "amax"))
    found = best_seq >= 0
    return (best_seq, torch.where(found, best[0], 0),
            torch.where(found, best[1], 0))


def host_occupancy(state: SLSMState):
    """(run_count, n_runs a disk level) read from the state in one
    blocking transfer."""
    n = torch.stack([state.run_count]
                    + [lv.n_runs for lv in state.levels]).tolist()
    return n[0], tuple(n[1:])


def lookup_batch(p: SLSMParams, state: SLSMState, qs: torch.Tensor,
                 sparse: bool = False, skip_empty: bool = False,
                 occupancy=None):
    """Point lookups, newest-to-oldest across every structure (paper
    2.7). Returns (vals, found); deleted keys report found=False.

    `sparse` picks the Bloom-compacted disk search. `skip_empty` leaves
    out the structures that hold no run, by `occupancy` = (run_count,
    n_runs a level) as the host knows it (None: read from the state);
    the answers are the same either way."""
    qs = qs.to(I32)
    levels = range(len(state.levels))
    mem_occupied = True
    if skip_empty:
        run_count, level_runs = (host_occupancy(state) if occupancy is None
                                 else occupancy)
        mem_occupied = run_count > 0
        levels = [lvl for lvl in levels if level_runs[lvl] > 0]
    best = search_stage(state, qs)
    if mem_occupied:
        best = consider(*best, *search_memory_runs(state, qs))
    search = search_level_sparse if sparse else search_level_dense
    blooms = bloom_verdicts(p, state.levels, qs, levels)
    for level, bloom in zip(levels, blooms):
        best = consider(*best, *search(p, state.levels[level], level, qs,
                                       bloom))
    best_seq, best_val, best_wt = best
    found = (best_seq >= 0) & (best_wt > 0)
    return torch.where(found, best_val, 0), found


def lookup_many(p: SLSMParams, state: SLSMState, qs: torch.Tensor,
                n_valid: int, sparse: bool = False, skip_empty: bool = False,
                occupancy=None):
    """Padded-batch point lookup: `lookup_batch` over qs[:n_valid]; padded
    lanes report found=False, val=0. Sharded (qs (S, Q)), `n_valid` is
    an (S,) tensor of each shard's live lanes."""
    vals, found = lookup_batch(p, state, qs, sparse, skip_empty, occupancy)
    if torch.is_tensor(n_valid):
        n_valid = n_valid[..., None]
    lane = torch.arange(qs.shape[-1], device=qs.device) < n_valid
    found = found & lane
    return torch.where(found, vals, 0), found


def level_probe_stats(p: SLSMParams, state: SLSMState, qs: torch.Tensor):
    """Per-level read telemetry for the tuner: ``(candidates, hits)``,
    each (max_levels,) int32 on the state's device — per disk level, the
    (run, query) pairs that passed the min/max + Bloom gate and those
    that were true key matches. One `bloom_probe_levels` call, then one
    `fence_lookup` launch a level; levels not materialized report 0."""
    qs = qs.to(I32)
    cands = torch.zeros(p.max_levels, dtype=I32, device=qs.device)
    hits = torch.zeros_like(cands)
    blooms = bloom_verdicts(p, state.levels, qs)
    for level, (lv, bloom) in enumerate(zip(state.levels, blooms)):
        stride, mu_eff = p.fence_view(level)
        fences = BE.strided_fences(lv.fences, stride)
        gate = BE.in_window(qs, lv.mins, lv.maxs) & bloom
        idx = BE.fence_lookup_many(qs, fences, lv.keys, lv.counts, mu_eff)
        cands[level] = gate.sum()
        hits[level] = (gate & (idx >= 0)).sum()
    return cands, hits


# --------------------------------------------------------------------------
# range queries (paper 2.9) — the fence-pruned scan engine
# --------------------------------------------------------------------------

def _range_group_bounds(p: SLSMParams, state: SLSMState, los: torch.Tensor,
                        his: torch.Tensor):
    """Per-structure [start, end) window bounds for Q scans: a list of
    ``(keys2d (N, cap), vals2d, wts2d, seqs2d, starts (Q, N),
    ends (Q, N))`` groups — the staging buffer, the sealed memory runs,
    then each materialized disk level (through its fences); a state
    with a leading shard dimension gives each of them that dimension.

    Trap T5: the reference skips a level no window touches with a
    `lax.cond` (a select per shard under `vmap`); here the bounds are
    always computed and replaced by zeros when nothing is touched, so
    `starts` (which the budget cut reads) match the reference."""
    def sorted_bounds(keys, counts):
        # keys (..., N, cap) sorted rows, counts (..., N) -> (..., N, Q)
        rows = keys.shape[:-1]
        start = torch.searchsorted(keys, los.expand(*rows, -1).contiguous())
        end = torch.minimum(
            torch.searchsorted(keys, his.expand(*rows, -1).contiguous()),
            counts[..., None].long())
        return torch.minimum(start, end).to(I32), end.to(I32)

    groups = []
    stage = (state.stage_keys[..., None, :], state.stage_vals[..., None, :],
             state.stage_wts[..., None, :], state.stage_seqs[..., None, :])
    st, en = sorted_bounds(stage[0], state.stage_count[..., None])
    groups.append(stage + (st.transpose(-1, -2), en.transpose(-1, -2)))
    st, en = sorted_bounds(state.buf_keys, state.buf_counts)
    groups.append((state.buf_keys, state.buf_vals, state.buf_wts,
                   state.buf_seqs, st.transpose(-1, -2),
                   en.transpose(-1, -2)))
    for level, lv in enumerate(state.levels):
        stride, mu_eff = p.fence_view(level)
        fences = BE.strided_fences(lv.fences, stride)
        st, en = BE.fence_window_bounds(los, his, fences, lv.keys, lv.counts,
                                        mu_eff)
        touched = ((lv.mins[..., None, :] < his[:, None])
                   & (lv.maxs[..., None, :] >= los[:, None])
                   & (lv.counts[..., None, :] > 0)).flatten(-2).any(-1)
        st = torch.where(touched[..., None, None], st.transpose(-1, -2), 0)
        en = torch.where(touched[..., None, None], en.transpose(-1, -2), 0)
        groups.append((lv.keys, lv.vals, lv.wts, lv.seqs, st, en))
    return groups


def _take(lane: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """lane (..., N, cap), flat (..., Q, C) indices into each row-major
    (N, cap) block -> (..., Q, C) values."""
    return lane.flatten(-2).gather(-1, flat.flatten(-2)).view(flat.shape)


def _gather_candidates(p: SLSMParams, state: SLSMState, los: torch.Tensor,
                       his: torch.Tensor):
    """Front-compacted candidate gather shared by the range and aggregate
    engines: fence-prune every structure to its in-window extent, fill
    the ``range_cand_eff`` budget part by part, and cut everything at or
    past the first key any structure's extent was cut at (so dedup over
    the survivors stays exact).

    Returns ``(k, v, w, s, offsets, partial)``: (Q, C) candidate lanes
    (KEY_EMPTY / zero past each row's fill), (Q, P+1) int32 segment
    boundaries and the (Q, P) per-part overflow flags — each with the
    state's leading shard dimension, if it has one."""
    cand = p.range_cand_eff(len(state.levels))
    lead, q_n = tuple(state.stage_count.shape), los.shape[0]
    dev = los.device

    groups = _range_group_bounds(p, state, los, his)
    starts = torch.cat([g[4] for g in groups], dim=-1).long()  # (Q, P)
    ends = torch.cat([g[5] for g in groups], dim=-1).long()
    exts = (ends - starts).clamp(min=0)
    n_parts = starts.shape[-1]

    # sequential budget fill: part p gets clip(C - cum_p, 0, ext_p) slots
    zero = exts.new_zeros(exts.shape[:-1] + (1,))
    cum_full = torch.cumsum(exts, dim=-1)
    cum_full_ex = torch.cat([zero, cum_full[..., :-1]], dim=-1)
    taken = torch.minimum((cand - cum_full_ex).clamp(min=0), exts)
    partial = taken < exts
    offsets = torch.cat([zero, torch.cumsum(taken, dim=-1)], dim=-1)
    total = offsets[..., -1]

    # lane j of a row belongs to the part whose span covers j
    j = torch.arange(cand, device=dev)
    part = torch.searchsorted(
        offsets, j.expand(*offsets.shape[:-1], -1).contiguous(),
        right=True) - 1                                         # (Q, C)
    part_c = part.clamp(0, n_parts - 1)
    src = starts.gather(-1, part_c) + j - offsets.gather(-1, part_c)

    k = torch.full(lead + (q_n, cand), _KEY_EMPTY, dtype=I32, device=dev)
    v = torch.zeros(lead + (q_n, cand), dtype=I32, device=dev)
    w = torch.zeros_like(v)
    s = torch.zeros_like(v)
    cut_keys = torch.full(lead + (q_n, n_parts), _KEY_EMPTY, dtype=I32,
                          device=dev)
    g0 = 0
    for gk, gv, gw, gs, gst, _ in groups:
        n_g, cap_g = gk.shape[-2:]
        in_g = (part >= g0) & (part < g0 + n_g) & (j < total[..., None])
        flat = ((part - g0).clamp(0, n_g - 1) * cap_g
                + src.clamp(0, cap_g - 1))
        k = torch.where(in_g, _take(gk, flat), k)
        v = torch.where(in_g, _take(gv, flat), v)
        w = torch.where(in_g, _take(gw, flat), w)
        s = torch.where(in_g, _take(gs, flat), s)
        cut_idx = (gst.long() + taken[..., g0:g0 + n_g]).clamp(0, cap_g - 1)
        cut_at = gk.gather(-1, cut_idx.transpose(-1, -2)).transpose(-1, -2)
        cut_keys[..., g0:g0 + n_g] = torch.where(
            partial[..., g0:g0 + n_g], cut_at, _KEY_EMPTY)
        g0 += n_g
    cut = cut_keys.min(dim=-1).values                           # (Q,)

    ok = k < cut[..., None]
    k = torch.where(ok, k, _KEY_EMPTY)
    v = torch.where(ok, v, 0)
    w = torch.where(ok, w, 0)
    s = torch.where(ok, s, 0)
    return k, v, w, s, offsets.to(I32), partial


def _merge_rows(k, v, w, s, offsets):
    """`range_merge` over every candidate row at once — a sharded
    state's S x Q rows go in one call — with the rows' shape kept."""
    shape = k.shape

    def rows(a):
        return a.reshape(-1, a.shape[-1])

    outs = BE.range_merge(rows(k), rows(v), rows(w), rows(s), rows(offsets),
                          True)
    return tuple(o.reshape(shape) for o in outs)


def range_scan(p: SLSMParams, state: SLSMState, los: torch.Tensor,
               his: torch.Tensor):
    """Q range scans [lo, hi) in one pass (paper 2.9). Returns
    ``(keys (Q, max_range), vals, counts (Q,), truncated (Q,))``: each
    row a correct sorted prefix of the window's live keys, `truncated`
    False iff the row is the whole window."""
    mr = p.max_range
    los, his = los.to(I32), his.to(I32)

    k, v, w, s, offsets, partial = _gather_candidates(p, state, los, his)
    k, v, w, s, keep = _merge_rows(k, v, w, s, offsets)
    live = keep.sum(dim=-1).to(I32)
    pos = torch.cumsum(keep, dim=-1) - 1
    # trap T4: the reference scatters kept lanes to their rank and drops
    # ranks >= max_range (and every non-kept lane, sent to max_range);
    # here such lanes land in a spare column that is cut off
    idx = torch.where(keep, pos, mr).clamp(max=mr)
    shape = k.shape[:-1] + (mr + 1,)
    out_k = torch.full(shape, _KEY_EMPTY, dtype=I32, device=k.device)
    out_v = torch.zeros(shape, dtype=I32, device=k.device)
    out_k.scatter_(-1, idx, k)
    out_v.scatter_(-1, idx, v)
    return (out_k[..., :mr], out_v[..., :mr], live.clamp(max=mr),
            (live > mr) | partial.any(dim=-1))


def range_query(p: SLSMParams, state: SLSMState, lo: int, hi: int):
    """All live (key, value) with lo <= key < hi — one row of
    `range_scan` (a row a shard, sharded). Returns (keys, vals, count,
    truncated)."""
    dev = state.stage_keys.device
    k, v, cnt, trunc = range_scan(
        p, state, torch.tensor([lo], dtype=I32, device=dev),
        torch.tensor([hi], dtype=I32, device=dev))
    return k[..., 0, :], v[..., 0, :], cnt[..., 0], trunc[..., 0]


def range_many(p: SLSMParams, state: SLSMState, los: torch.Tensor,
               his: torch.Tensor, n_valid: int):
    """Padded-batch range scans: `range_scan` over the first n_valid
    windows; padded lanes report count 0, truncated False."""
    k, v, cnt, trunc = range_scan(p, state, los, his)
    lane = torch.arange(los.shape[0], device=los.device) < n_valid
    return (torch.where(lane[:, None], k, _KEY_EMPTY),
            torch.where(lane[:, None], v, 0),
            torch.where(lane, cnt, 0), trunc & lane)


# --------------------------------------------------------------------------
# aggregates — count / sum over a window, riding the scan machinery
# --------------------------------------------------------------------------

def aggregate_many(p: SLSMParams, state: SLSMState, los: torch.Tensor,
                   his: torch.Tensor, n_valid: int):
    """Q windowed aggregates ``count(lo, hi)`` and ``sum(lo, hi)`` over
    the live keys of each window, from the merged keep mask (no
    max_range cut). Sums are int32 with wraparound. Returns
    ``(counts (Q,), sums (Q,), truncated (Q,))``; padded lanes report
    zeros / False."""
    los, his = los.to(I32), his.to(I32)
    k, v, w, s, offsets, partial = _gather_candidates(p, state, los, his)
    k, v, w, s, keep = _merge_rows(k, v, w, s, offsets)
    counts = keep.sum(dim=-1).to(I32)
    sums = wrap_i32(torch.where(keep, v, 0).sum(dim=-1, dtype=torch.int64))
    trunc = partial.any(dim=-1)
    lane = torch.arange(los.shape[0], device=los.device) < n_valid
    return (torch.where(lane, counts, 0), torch.where(lane, sums, 0),
            trunc & lane)
