"""Memory tier (paper 2.1-2.3): the staging buffer + sealed memory runs.

The staging buffer is the dense-tensor form of the paper's active
skiplist: the ordered insert becomes a sort of the 2*Rn staging region,
and the in-place update of duplicate keys (3.9.1) is the newest-wins
dedup. Sealing turns Rn staged elements into an immutable sorted run
with a Bloom filter and min/max index. Records are weighted (+1 insert,
-1 delete) in their own lane beside keys/vals/seqs.

`SLSMState` keeps the reference's field order, so a state flattens to
the same leaf list as the reference's pytree (see `repro_torch.convert`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import bloom as BL
from repro_torch.core import runs as RU
from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.engine.levels import LevelState, empty_level

I32 = torch.int32
_KEY_EMPTY = int(KEY_EMPTY)
# -inf key sentinel for "max key of an empty run"
_KEY_MIN = -(2 ** 31)


class SLSMState(NamedTuple):
    # staging buffer == the active run (kept key-sorted, newest-wins deduped)
    stage_keys: torch.Tensor   # (2*Rn,)
    stage_vals: torch.Tensor
    stage_wts: torch.Tensor    # (2*Rn,) record weights: +1 insert, -1 delete
    stage_seqs: torch.Tensor
    stage_count: torch.Tensor  # ()
    # sealed memory runs
    buf_keys: torch.Tensor     # (R, Rn)
    buf_vals: torch.Tensor
    buf_wts: torch.Tensor      # (R, Rn)
    buf_seqs: torch.Tensor
    buf_counts: torch.Tensor   # (R,)
    buf_mins: torch.Tensor     # (R,)
    buf_maxs: torch.Tensor     # (R,)
    buf_blooms: torch.Tensor   # (R, words_buf) int32 words (uint32 bits)
    run_count: torch.Tensor    # ()
    next_seq: torch.Tensor     # () global write counter == recency order
    levels: Tuple[LevelState, ...]


def init_state(p: SLSMParams, device, n_levels: int = 0,
               n_shards: int | None = None) -> SLSMState:
    """Fresh engine state on `device` with `n_levels` disk tiers
    preallocated (`SLSM` grows them lazily from 0). With `n_shards`
    every leaf gains a leading shard dimension (the sharded engine's
    stacked state)."""
    wb = p.bloom_words_physical(p.Rn, p.mem_eps)
    lead = () if n_shards is None else (n_shards,)

    def full(shape, fill):
        return torch.full(lead + shape, fill, dtype=I32, device=device)

    return SLSMState(
        stage_keys=full((p.stage_cap,), _KEY_EMPTY),
        stage_vals=full((p.stage_cap,), 0),
        stage_wts=full((p.stage_cap,), 0),
        stage_seqs=full((p.stage_cap,), 0),
        stage_count=full((), 0),
        buf_keys=full((p.R, p.Rn), _KEY_EMPTY),
        buf_vals=full((p.R, p.Rn), 0),
        buf_wts=full((p.R, p.Rn), 0),
        buf_seqs=full((p.R, p.Rn), 0),
        buf_counts=full((p.R,), 0),
        buf_mins=full((p.R,), _KEY_EMPTY),
        buf_maxs=full((p.R,), _KEY_MIN),
        buf_blooms=full((p.R, wb), 0),
        run_count=full((), 0),
        next_seq=full((), 0),
        levels=tuple(empty_level(p, lvl, device, n_shards)
                     for lvl in range(n_levels)),
    )


# --------------------------------------------------------------------------
# insertion path (paper Algorithm 2, batched)
# --------------------------------------------------------------------------

def stage_append(p: SLSMParams, state: SLSMState, keys: torch.Tensor,
                 vals: torch.Tensor, wts: torch.Tensor,
                 n_valid) -> SLSMState:
    """Append an Rn-sized chunk into the active run, then re-sort + dedup
    (newest wins: each record retracts its predecessor, so keeping the
    newest IS the telescoped weight sum).

    A state with a leading shard dimension takes an (S, Rn) chunk and an
    (S,) tensor `n_valid`, a row a shard (the reference's op under
    `jax.vmap`); every shard is re-sorted, those with no lane included.
    The chunk is written at each shard's `stage_count`. Trap T4: the
    reference's `dynamic_update_slice` clamps that start so the chunk
    fits; the same clamp is written out here."""
    rn = p.Rn
    pos = torch.arange(rn, dtype=I32, device=keys.device)
    n = n_valid[..., None] if torch.is_tensor(n_valid) else n_valid
    valid = pos < n
    ck = torch.where(valid, keys, _KEY_EMPTY)
    cw = torch.where(valid, wts, 0)
    # seqnos only on valid lanes (padded lanes get the dead value 0)
    cs = torch.where(valid, state.next_seq[..., None] + pos, 0)
    start = state.stage_count.clamp(0, p.stage_cap - rn)
    at = (start[..., None] + pos).long()
    sk, sv, sw, ss = (a.clone().scatter_(-1, at, c)
                      for a, c in ((state.stage_keys, ck),
                                   (state.stage_vals, vals),
                                   (state.stage_wts, cw),
                                   (state.stage_seqs, cs)))
    k, v, w, s = RU.sort_records(sk, sv, sw, ss)
    ok = RU.survivor_mask(k, w, drop_annihilated=False)
    k, v, w, s, cnt = RU.compact(k, v, w, s, ok)
    return state._replace(stage_keys=k, stage_vals=v, stage_wts=w,
                          stage_seqs=s, stage_count=cnt,
                          next_seq=state.next_seq + n_valid)


def seal_run(p: SLSMParams, state: SLSMState) -> SLSMState:
    """Seal Rn staged elements into memory run slot `run_count`: build
    the run's Bloom filter and min/max index (paper 2.3). The buffer's
    run slot is written in place."""
    rn = p.Rn
    bits, _, kk = p.bloom_geometry(rn, p.mem_eps)
    wb = p.bloom_words_physical(rn, p.mem_eps)
    rk, rv, rw, rs = (state.stage_keys[:rn], state.stage_vals[:rn],
                      state.stage_wts[:rn], state.stage_seqs[:rn])
    slot = int(state.run_count)
    filt = BL.bloom_build(rk, torch.ones_like(rk, dtype=torch.bool), wb, kk,
                          bits)
    for dst, src in ((state.buf_keys, rk), (state.buf_vals, rv),
                     (state.buf_wts, rw), (state.buf_seqs, rs),
                     (state.buf_blooms, filt)):
        dst[slot] = src
    state.buf_counts[slot] = rn
    state.buf_mins[slot] = rk[0]
    state.buf_maxs[slot] = rk[rn - 1]

    def tail(a, fill):
        return torch.cat([a[rn:], a.new_full((rn,), fill)])

    return state._replace(
        stage_keys=tail(state.stage_keys, _KEY_EMPTY),
        stage_vals=tail(state.stage_vals, 0),
        stage_wts=tail(state.stage_wts, 0),
        stage_seqs=tail(state.stage_seqs, 0),
        stage_count=state.stage_count - rn,
        run_count=state.run_count + 1)
