"""The sharded engine: S hash-partitioned sLSM trees in one stacked state.

The port of `repro.engine.sharded`, the many-tenant serving shape. The S
trees live in one `SLSMState` whose every leaf has a leading shard
dimension, and every device op is the single-tree op batched over that
dimension, as the reference vmaps it: one call drives all shards. The
key space is hash-partitioned by the Bloom filters' Murmur3 finalizer
(`shard_ids`), so shards never share keys and their results merge
trivially. The four engine kernels take the shard as a launch dimension:
a lookup batch is one `bloom_probe` launch and one `fence_lookup` launch
a level for the whole fleet, a scan or aggregate batch puts its S x Q
candidate rows through one `range_merge` call, and a masked maintenance
step is one `heap_merge` call (two launches) for every masked shard.

Control flow stays on the host, as in the single-tree engine: the host
reads the (S,) occupancy counters and applies each maintenance step to
the shards of a mask. The reference runs a step on every shard and keeps
the result only where the mask is set (`_select`); the port runs it on
the masked shards alone and writes their rows in place, which leaves
the state bitwise equal and the other shards untouched.

Maintenance is scheduled per shard by the single tree's step model
(`engine.scheduler`): after every lockstep insert round each shard runs
up to `merge_budget` voluntary steps (per-shard masks, deepest level
first), then the forced chain covers what the next round requires.

As in the reference, two simplifications against the single tree:
  * all `max_levels` tiers are allocated at init, so every shard has one
    structure (no lazy growth);
  * annihilated records are dropped only at the deepest-level compaction
    (flush and spill pass ``drop_annihilated=False``), always legal
    (paper 2.5/2.8).
Compaction is the paper's tiering policy; lookups take the dense path
(the reference's sparse candidate compaction does not vmap), with every
query routed on the host to its owner shard.
"""
from __future__ import annotations

import collections
import json
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import bloom as BL
from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.device import resolve_device
from repro_torch.engine import backend as BE
from repro_torch.engine import read_path as RP
from repro_torch.engine import scheduler as SCH
from repro_torch.engine import tape as TP
from repro_torch.engine import tuner as TU
from repro_torch.engine import wal as WAL
from repro_torch.engine.batching import (bucket_pow2, pad_windows,
                                         range_bucket, range_many_host)
from repro_torch.engine.compaction import TieringPolicy
from repro_torch.engine.engine import reject_reserved
from repro_torch.engine.levels import (_KEY_MIN, LevelState, index_new_run,
                                       set_level_run)
from repro_torch.engine.memtable import SLSMState, init_state, stage_append

I32 = torch.int32
_KEY_EMPTY = int(KEY_EMPTY)

_GOLDEN = np.uint32(0x9E3779B9)   # core.bloom.SEED1: the same hash family
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)

# the fill of each field of a disk level and of the memory runs, in
# field order (n_runs / run_count aside)
_LEVEL_FILL = (_KEY_EMPTY, 0, 0, 0, 0, _KEY_EMPTY, _KEY_MIN, 0, _KEY_EMPTY)
_BUF_FIELDS = (("buf_keys", _KEY_EMPTY), ("buf_vals", 0), ("buf_wts", 0),
               ("buf_seqs", 0), ("buf_counts", 0), ("buf_mins", _KEY_EMPTY),
               ("buf_maxs", _KEY_MIN), ("buf_blooms", 0))
_STAGE_FIELDS = (("stage_keys", _KEY_EMPTY), ("stage_vals", 0),
                 ("stage_wts", 0), ("stage_seqs", 0))


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """numpy Murmur3 32-bit finalizer over uint32 lanes (the host-side
    routing hash; `core.bloom.fmix32` on the device)."""
    x = x.astype(np.uint32)
    x ^= x >> 16
    x = x * _C1
    x ^= x >> 13
    x = x * _C2
    x ^= x >> 16
    return x


def shard_ids(keys, n_shards: int) -> np.ndarray:
    """Owner shard of each key: fmix32(key ^ SEED1) mod S."""
    u = np.asarray(keys, np.int32).reshape(-1).view(np.uint32)
    return (_fmix32_np(u ^ _GOLDEN) % np.uint32(n_shards)).astype(np.int64)


# --------------------------------------------------------------------------
# masked maintenance on the stacked state (rows of the masked shards are
# written in place; the others are not touched)
# --------------------------------------------------------------------------

def _shard_level(lv: LevelState, s: int) -> LevelState:
    """Shard s's rows of a stacked level, as views."""
    return LevelState(*(x[s] for x in lv))


def _drop_oldest(a: torch.Tensor, idx, n: int, fill: int) -> None:
    """In the rows `idx` of a (S, N, ...) leaf, drop the n first entries
    of dim 1, shifting the rest down and filling the tail."""
    for s in idx:
        row = a[s]
        row[:-n] = row[n:].clone()
        row[-n:] = fill


def _rows(idx, like: torch.Tensor) -> torch.Tensor:
    """The shard indices `idx` as an index tensor on `like`'s device."""
    return torch.as_tensor(idx, dtype=torch.int64, device=like.device)


def _install(p: SLSMParams, lv: LevelState, level: int, idx, k, v, w, s,
             cnt) -> None:
    """Index each masked shard's merged run (b-th row of the (B, n) merge
    outputs) and install it at the shard's next free slot of `lv`."""
    slots = lv.n_runs.cpu().numpy()[np.asarray(idx)].tolist()
    for b, (shard, slot) in enumerate(zip(idx, slots)):
        run = index_new_run(p, level, k[b], v[b], w[b], s[b], cnt[b])
        kk, vv, ww, ss, filt, fences, mn, mx = run
        set_level_run(_shard_level(lv, shard), slot, kk, vv, ww, ss, cnt[b],
                      filt, fences, mn, mx)
    lv.n_runs[_rows(idx, lv.n_runs)] += 1


def _seal_where(p: SLSMParams, state: SLSMState, idx) -> None:
    """Seal Rn staged elements into memory-run slot `run_count` of every
    shard in `idx` (`memtable.seal_run` a shard)."""
    rn = p.Rn
    bits, _, kk = p.bloom_geometry(rn, p.mem_eps)
    wb = p.bloom_words_physical(rn, p.mem_eps)
    it = _rows(idx, state.stage_count)
    slots = state.run_count[it].long()
    head = [getattr(state, f)[it, :rn] for f, _ in _STAGE_FIELDS]
    filt = torch.stack([BL.bloom_build(k, torch.ones_like(k, dtype=torch.bool),
                                       wb, kk, bits) for k in head[0]])
    for (f, _), src in zip(_BUF_FIELDS[:4], head):
        getattr(state, f)[it, slots] = src
    state.buf_blooms[it, slots] = filt
    state.buf_counts[it, slots] = rn
    state.buf_mins[it, slots] = head[0][:, 0]
    state.buf_maxs[it, slots] = head[0][:, rn - 1]
    for f, fill in _STAGE_FIELDS:
        _drop_oldest(getattr(state, f), idx, rn, fill)
    state.stage_count[it] -= rn
    state.run_count[it] += 1


def _flush_where(p: SLSMParams, state: SLSMState, idx) -> None:
    """Flush the ceil(m*R_eff) oldest memory runs of every shard in `idx`
    into its disk level 0, one batched merge (no annihilation)."""
    mr = p.runs_merged_eff
    it = _rows(idx, state.stage_count)
    merged = BE.merge_runs(state.buf_keys[it, :mr], state.buf_vals[it, :mr],
                           state.buf_wts[it, :mr], state.buf_seqs[it, :mr],
                           False)
    _install(p, state.levels[0], 0, idx, *merged)
    for f, fill in _BUF_FIELDS:
        _drop_oldest(getattr(state, f), idx, mr, fill)
    state.run_count[it] -= mr


def _merge_level_down_where(p: SLSMParams, state: SLSMState, level: int,
                            n_merge: int, idx) -> None:
    """Merge the `n_merge` oldest runs of `level` into one run of
    `level + 1` on every shard in `idx`, one batched merge (no
    annihilation)."""
    src = state.levels[level]
    it = _rows(idx, state.stage_count)
    merged = BE.merge_runs(src.keys[it, :n_merge], src.vals[it, :n_merge],
                           src.wts[it, :n_merge], src.seqs[it, :n_merge],
                           False)
    _install(p, state.levels[level + 1], level + 1, idx, *merged)
    for a, fill in zip(src[:-1], _LEVEL_FILL):
        _drop_oldest(a, idx, n_merge, fill)
    src.n_runs[it] -= n_merge


def _compact_last_merge(p: SLSMParams, state: SLSMState, idx):
    """The deepest level's D runs of every shard in `idx` merged into one,
    annihilating deleted keys: ``(keys, vals, wts, seqs, raw counts)``,
    nothing written yet (the host checks the counts first)."""
    lv = state.levels[p.max_levels - 1]
    it = _rows(idx, state.stage_count)
    return BE.merge_runs(lv.keys[it], lv.vals[it], lv.wts[it], lv.seqs[it],
                         True)


def _compact_last_install(p: SLSMParams, state: SLSMState, idx,
                          merged) -> None:
    """Replace the deepest level of every shard in `idx` by its compacted
    run in slot 0 (`compaction.compact_last_level` a shard)."""
    last = p.max_levels - 1
    lv = state.levels[last]
    it = _rows(idx, state.stage_count)
    for a, fill in zip(lv[:-1], _LEVEL_FILL):
        a[it] = fill
    lv.n_runs[it] = 0
    k, v, w, s, cnt = merged
    _install(p, lv, last, idx, k, v, w, s,
             torch.clamp(cnt, max=p.level_cap(last)))


def _retune_filters_sharded(p: SLSMParams, state: SLSMState) -> None:
    """Rebuild every shard's resident filters under `p`'s allocation —
    `tuner.retune_filters` a shard, written back in place."""
    for s in range(state.stage_count.shape[0]):
        view = SLSMState(*(x[s] for x in state[:-1]),
                         tuple(_shard_level(lv, s) for lv in state.levels))
        new = TU.retune_filters(p, view)
        state.buf_blooms[s] = new.buf_blooms
        for lv, nl in zip(state.levels, new.levels):
            lv.blooms[s] = nl.blooms


def _merge_shard_ranges(p: SLSMParams, k, v, c, tr):
    """Fold the (S, Q, max_range) scan rows of the shards into one row a
    scan: shards hold disjoint keys and each row is key-sorted, so one
    sort a scan merges them. Only KEY_EMPTY padding lanes tie, and they
    all carry payload 0, so a stable sort gives the reference's
    (unstable) `lax.sort` result. Returns ``(keys (Q, max_range), vals,
    counts, truncated)``, truncated where a shard truncated or the
    shards' live keys exceed max_range."""
    mr = p.max_range
    s_n, q_n = k.shape[0], k.shape[1]
    kq = k.transpose(0, 1).reshape(q_n, s_n * mr)
    vq = v.transpose(0, 1).reshape(q_n, s_n * mr)
    order = torch.sort(kq, dim=-1, stable=True).indices
    kq, vq = kq.gather(-1, order), vq.gather(-1, order)
    total = c.sum(dim=0)
    return (kq[:, :mr], vq[:, :mr], torch.clamp(total, max=mr).to(I32),
            tr.any(dim=0) | (total > mr))


def _range_many_sharded(p: SLSMParams, state: SLSMState, los, his,
                        n_valid: int):
    """Q scans against every shard in one pass, merged on the device:
    the single tree's `read_path.range_many` over the stacked state (S x
    Q candidate rows, one `range_merge` call), then
    `_merge_shard_ranges`."""
    return _merge_shard_ranges(p, *RP.range_many(p, state, los, his,
                                                 n_valid))


def _aggregate_many_sharded(p: SLSMParams, state: SLSMState, los, his,
                            n_valid: int):
    """Q windowed aggregates against every shard in one pass: each shard
    reduces its own live rows, and the disjoint partials fold by int32
    addition with wraparound (trap T3)."""
    c, s, t = RP.aggregate_many(p, state, los, his, n_valid)
    return (RP.wrap_i32(c.sum(dim=0, dtype=torch.int64)),
            RP.wrap_i32(s.sum(dim=0, dtype=torch.int64)), t.any(dim=0))


# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------

class ShardedSLSM:
    """S hash-partitioned sLSM trees in one stacked state, on the card
    unless ``device="cpu"``."""

    def __init__(self, params: SLSMParams | None = None, n_shards: int = 4,
                 durability=None, device=None):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.p = params or SLSMParams()
        self.device = resolve_device(device)
        self.S = n_shards
        self.policy = TieringPolicy()
        self.state = init_state(self.p, self.device, self.p.max_levels,
                                n_shards)
        # the tuner's allocation applied to p (== p under static tuning):
        # one allocation governs the fleet, so a retune is a lockstep swap
        # and a rebuild of every shard's filters
        self.p_active = self.p
        self.tuner = TU.Tuner(self)
        # maintenance counters summed over shards; backlog_peak = most
        # pending steps on any ONE shard
        self.stats = collections.Counter(seals=0, flushes=0, spills=0,
                                         compactions=0, backlog_peak=0,
                                         retunes=0, reads=0, writes=0,
                                         rows_merged_in=0, rows_merged_out=0,
                                         rows_annihilated=0,
                                         ghost_payload_bytes_skipped=0)
        # write ops are logged before shard routing, so a single tree and
        # a sharded engine fed one stream write the same records
        self._replaying = False
        self.durability = WAL.as_durability(durability)
        if self.durability is not None:
            self.durability.ensure_header(self._wal_meta())
        # a replication leader or follower claims this; a fenced (deposed)
        # leader's writes raise until promote()
        self.replication = None
        self.fenced = False

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def _host(self, *ts: torch.Tensor) -> np.ndarray:
        """Stacked (S,) counters read to the host in one transfer."""
        return torch.stack(ts).cpu().numpy()

    # -- write path -------------------------------------------------------
    def _guard_writes(self) -> None:
        """Reject writes into a fenced (deposed) leader or a replica.
        Replay and `apply_replicated` pass (``_replaying``)."""
        if self._replaying:
            return
        if self.fenced:
            raise RuntimeError(
                "write rejected: this engine was fenced (deposed leader) "
                "— demote() happened; rejoin via the new leader's "
                "bootstrap or promote() to lead again")
        if self.durability is not None and self.durability.replica:
            raise RuntimeError(
                "write rejected: replica engines are read-only until "
                "promote()")

    def insert(self, keys, vals) -> None:
        """Batched insert: bucket by owner shard, then feed all shards in
        lockstep Rn-chunks; each round ends with the per-shard scheduler
        pass (budgeted voluntary steps, then the forced chain)."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        vals = np.asarray(vals, np.int32).reshape(-1)
        if keys.shape != vals.shape:
            raise ValueError("insert: keys and vals differ in length")
        reject_reserved(keys, vals, op="insert")
        self._insert(keys, vals, np.ones_like(keys))

    def _insert(self, keys: np.ndarray, vals: np.ndarray,
                wts: np.ndarray) -> None:
        """The weighted write path (delete() enters with weight -1). With
        durability the call is one WAL record, logged before routing and
        synced once at the end."""
        if len(keys) == 0:
            return
        self._guard_writes()
        log = self.durability is not None and not self._replaying
        if log:
            self.durability.log_write(keys, vals, wts)
        self.stats["writes"] += len(keys)
        self.tuner.note_writes(len(keys))
        sid = shard_ids(keys, self.S)
        buckets = [(keys[sid == s], vals[sid == s], wts[sid == s])
                   for s in range(self.S)]
        rn = self.p.Rn
        rounds = max((len(bk) + rn - 1) // rn for bk, _, _ in buckets)
        for r in range(rounds):
            chunk = np.zeros((3, self.S, rn), np.int32)
            chunk[0] = KEY_EMPTY
            n = np.zeros((self.S,), np.int32)
            for s, bucket in enumerate(buckets):
                seg = [a[r * rn:(r + 1) * rn] for a in bucket]
                n[s] = len(seg[0])
                for lane, a in zip(chunk, seg):
                    lane[s, :len(a)] = a
            c = self._tensor(chunk)
            self.state = stage_append(self.p_active, self.state, c[0], c[1],
                                      c[2], self._tensor(n))
            self._maintain()
        if log:
            self.durability.sync()

    def delete(self, keys) -> None:
        """Weight -1 records (paper 2.8), annihilated at the deepest-level
        compaction (paper 2.5)."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(keys, op="delete")
        self._insert(keys, np.zeros_like(keys), np.full_like(keys, -1))

    # -- merge scheduling (per-shard step masks) ----------------------------
    def _occupancies(self) -> list:
        """Per-shard occupancy snapshots for the scheduler's step logic
        (one transfer)."""
        st = self.state
        n = self._host(st.stage_count, st.run_count,
                       *(lv.n_runs for lv in st.levels))
        return [SCH.Occupancy(int(n[0, s]), int(n[1, s]),
                              tuple(int(x) for x in n[2:, s]))
                for s in range(self.S)]

    def _book_merge(self, rows_in: int, rows_out: int) -> None:
        """Z-set merge telemetry over the masked shards of one step."""
        st = self.stats
        st["rows_merged_in"] += rows_in
        st["rows_merged_out"] += rows_out
        st["rows_annihilated"] += rows_in - rows_out
        st["ghost_payload_bytes_skipped"] += 4 * (rows_in - rows_out)

    def _slot_rows(self, lv: LevelState, idx, slots) -> int:
        """Rows of the runs the masked shards just installed at `slots`."""
        counts = lv.counts.cpu().numpy()
        return int(counts[idx, slots].sum())

    def _apply_step(self, kind: str, level: int, mask: np.ndarray) -> None:
        """Run one step kind on every masked shard (one batched merge for
        flush, spill and compaction); the other shards are untouched."""
        p, st = self.p_active, self.state
        idx = np.flatnonzero(mask)
        if kind == SCH.SEAL:
            _seal_where(p, st, idx)
            self.stats["seals"] += int(mask.sum())
        elif kind == SCH.FLUSH:
            mr = p.runs_merged_eff
            rows_in = int(st.buf_counts.cpu().numpy()[idx, :mr].sum())
            slots = st.levels[0].n_runs.cpu().numpy()[idx]
            _flush_where(p, st, idx)
            self._book_merge(rows_in, self._slot_rows(st.levels[0], idx,
                                                      slots))
            self.stats["flushes"] += int(mask.sum())
        elif kind == SCH.SPILL:
            nm = p.disk_runs_merged
            rows_in = int(st.levels[level].counts.cpu().numpy()[
                idx, :nm].sum())
            slots = st.levels[level + 1].n_runs.cpu().numpy()[idx]
            _merge_level_down_where(p, st, level, nm, idx)
            self._book_merge(rows_in, self._slot_rows(st.levels[level + 1],
                                                      idx, slots))
            self.stats["spills"] += int(mask.sum())
        else:   # COMPACT
            last = p.max_levels - 1
            rows_in = int(st.levels[last].counts.cpu().numpy()[idx].sum())
            merged = _compact_last_merge(p, st, idx)
            raws = merged[4].cpu().numpy()
            cap = p.level_cap(last)
            if (raws > cap).any():
                # raise before committing: the compacted run would be cut
                raise RuntimeError(
                    f"sLSM deepest level overflow ({int(raws.max())} > {cap} "
                    f"live elements in a shard): increase max_levels beyond "
                    f"{p.max_levels}")
            _compact_last_install(p, st, idx, merged)
            self._book_merge(rows_in, int(raws.sum()))
            self.stats["compactions"] += int(mask.sum())

    def _step_masks(self, kind: str, level: int, occs):
        """(pending, ready) per-shard masks for one step kind."""
        p, policy = self.p_active, self.policy
        pend = np.array([SCH.step_pending(kind, level, o, p, policy)
                         for o in occs], dtype=bool)
        ready = np.array([SCH.step_ready(kind, level, o, p, policy)
                          for o in occs], dtype=bool)
        return pend, pend & ready

    def _apply_retune(self) -> None:
        """Lockstep allocation switch: swap the fleet's active parameters
        and rebuild every shard's filters. A retune cannot be masked per
        shard (one allocation governs the fleet): it applies at the round
        boundary that decided it. With durability it is logged and
        synced."""
        t = self.tuner
        log = self.durability is not None and not self._replaying
        if log:
            self.durability.log_retune(t.target)
        self.p_active = t.allocation(t.target).apply(self.p)
        _retune_filters_sharded(self.p_active, self.state)
        t.applied()
        self.stats["retunes"] += 1
        if log:
            self.durability.sync()

    def _maintain(self) -> None:
        """Per-round scheduler pass: tuner decision, backlog telemetry,
        budgeted voluntary steps (merge_budget > 0), then the forced
        chain."""
        self.tuner.decide()
        if self.tuner.pending:
            self._apply_retune()
        occs = self._occupancies()
        p, policy = self.p_active, self.policy
        peak = max(len(SCH.pending_steps(p, policy, o)) for o in occs)
        self.stats["backlog_peak"] = max(self.stats["backlog_peak"], peak)
        if p.merge_budget > 0:
            self._voluntary_pass()
        self._forced_pass()

    def _voluntary_pass(self) -> None:
        """Up to merge_budget steps a shard, deepest first; the masks are
        re-read after every applied step."""
        budget = np.full(self.S, self.p_active.merge_budget, np.int64)
        while (budget > 0).any():
            occs = self._occupancies()
            ran = False
            for kind, level in SCH.step_order(self.p_active):
                _, ready = self._step_masks(kind, level, occs)
                mask = ready & (budget > 0)
                if mask.any():
                    self._apply_step(kind, level, mask)
                    budget[mask] -= 1
                    ran = True
                    break   # state changed: re-read before the next op
            if not ran:
                return

    def _forced_pass(self) -> None:
        """Seal, flush and cascade every shard the next round requires
        (the whole of maintenance when merge_budget == 0)."""
        p = self.p_active
        while True:
            stage, runs = self._host(self.state.stage_count,
                                     self.state.run_count)
            need_seal = stage >= p.Rn
            if not need_seal.any():
                return
            need_flush = need_seal & (runs >= p.R)
            if need_flush.any():
                self._cascade(need_flush)
                self._apply_step(SCH.FLUSH, -1, need_flush)
            self._apply_step(SCH.SEAL, -1, need_seal)

    def _cascade(self, flush_mask: np.ndarray) -> None:
        """Forced deepest-first spill chain: shard s spills level l+1 only
        if its level-l spill is about to push a run into a full level
        l+1."""
        p = self.p_active
        n_runs = self._host(*(lv.n_runs for lv in self.state.levels))
        spill, mask = [], flush_mask
        for lvl in range(p.max_levels):
            mask = mask & (n_runs[lvl] >= p.D)
            spill.append(mask.copy())
        last = p.max_levels - 1
        if spill[last].any():
            self._apply_step(SCH.COMPACT, last, spill[last])
        for lvl in range(last - 1, -1, -1):
            if spill[lvl].any():
                self._apply_step(SCH.SPILL, lvl, spill[lvl])

    def warm(self) -> None:
        """Build every kernel and launch each read op once at every
        preset's allocation (the configured one under static tuning); the
        answers are discarded. PyTorch runs eagerly, so nothing else
        needs warming."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()
        presets = ([a.apply(self.p) for a in self.tuner.presets.values()]
                   if self.tuner.enabled else [self.p])
        qs = self._tensor(np.full((self.S, 16), KEY_EMPTY, np.int32))
        _, los, his = pad_windows([(0, 0)], self.device)
        for pa in presets:
            RP.lookup_batch(pa, self.state, qs)
            _range_many_sharded(pa, self.state, los, his, 0)
            _aggregate_many_sharded(pa, self.state, los, his, 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_tape(self) -> None:
        """`warm()`: a tape runs the engine's own read ops."""
        self.warm()

    def drain(self) -> None:
        """Merge barrier: retire every shard's pending steps (a decided
        retune first)."""
        if self.tuner.pending:
            self._apply_retune()
        while True:
            occs = self._occupancies()
            pending_any = progressed = False
            for kind, level in SCH.step_order(self.p_active):
                pend, ready = self._step_masks(kind, level, occs)
                pending_any |= bool(pend.any())
                if ready.any():
                    self._apply_step(kind, level, ready)
                    progressed = True
                    break   # state changed: re-read before the next op
            if not pending_any:
                return
            if not progressed:   # pragma: no cover — invariant violation
                raise RuntimeError("sharded merge drain stalled")

    def voluntary_steps(self, budget: int) -> int:
        """Run up to `budget` ready maintenance steps a shard, deepest
        first (a pending retune first, counted as one step): the serving
        governor's entry point. Returns the steps applied across the
        fleet."""
        self.tuner.decide()
        ran = 0
        if self.tuner.pending and budget > 0:
            self._apply_retune()
            ran, budget = 1, budget - 1
        per_shard = np.full(self.S, budget, np.int64)
        while (per_shard > 0).any():
            occs = self._occupancies()
            progressed = False
            for kind, level in SCH.step_order(self.p_active):
                _, ready = self._step_masks(kind, level, occs)
                mask = ready & (per_shard > 0)
                if mask.any():
                    self._apply_step(kind, level, mask)
                    per_shard[mask] -= 1
                    ran += int(mask.sum())
                    progressed = True
                    break   # state changed: re-read before the next op
            if not progressed:
                break
        return ran

    # -- read path ----------------------------------------------------------
    def _on_reads(self, n: int) -> None:
        """Count the reads; under adaptive tuning feed and roll the tuner
        on the fleet's global counts (a decision binds at the next insert
        round or drain)."""
        self.stats["reads"] += n
        t = self.tuner
        if not t.enabled:
            return
        t.note_reads(n)
        t.decide()

    def _route(self, qs: np.ndarray, width: int | None = None):
        """Each key's (shard, rank in its shard), the keys a shard, and
        the (S, width) rows of routed keys, KEY_EMPTY padded (width
        None: the largest shard's count, padded to a power of two)."""
        sid = shard_ids(qs, self.S)
        counts = np.bincount(sid, minlength=self.S)
        if width is None:
            width = bucket_pow2(int(counts.max()))
        # stable sort by shard: a key's slot is its index minus the start
        # of its shard's block
        order = np.argsort(sid, kind="stable")
        starts = np.zeros(self.S + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.empty(len(qs), np.int64)
        pos[order] = np.arange(len(qs), dtype=np.int64) - starts[sid[order]]
        routed = np.full((self.S, width), KEY_EMPTY, np.int32)
        routed[sid, pos] = qs
        return sid, pos, counts, routed

    def lookup(self, keys):
        """Batched lookup: each query routed to its owner shard, every
        shard's row answered in one pass of the dense read path (one
        Bloom-probe launch, one fence-search launch a level), the results
        scattered back. Rows are padded to a power-of-two width."""
        qs = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(qs, op="lookup")
        nq = len(qs)
        if nq == 0:
            return np.zeros(0, np.int32), np.zeros(0, bool)
        self._on_reads(nq)
        sid, pos, _, routed = self._route(qs)
        vals, found = RP.lookup_batch(self.p_active, self.state,
                                      self._tensor(routed))
        vals, found = torch.stack([vals, found.to(I32)]).cpu().numpy()
        return vals[sid, pos], found[sid, pos].astype(bool)

    def lookup_many(self, keys, sparse: bool = False):
        """`lookup` under `SLSM.lookup_many`'s name and signature; `sparse`
        is accepted and served densely (exact), as in the reference."""
        del sparse
        return self.lookup(keys)

    def range(self, lo: int, hi: int, return_truncated: bool = False):
        """Global range [lo, hi): the shards' rows (disjoint keys) joined
        and key-sorted. Exact while no shard truncates; with
        `return_truncated` also the (S,) per-shard truncation flags."""
        k, v, c, trunc = RP.range_query(self.p_active, self.state, lo, hi)
        k, v = k.cpu().numpy(), v.cpu().numpy()
        c = c.cpu().numpy()
        ks = np.concatenate([k[s, :c[s]] for s in range(self.S)])
        vs = np.concatenate([v[s, :c[s]] for s in range(self.S)])
        order = np.argsort(ks, kind="stable")
        out = ks[order], vs[order]
        return out + (trunc.cpu().numpy(),) if return_truncated else out

    def range_device(self, lo: int, hi: int):
        """Device-resident global range: the shards' rows merged on the
        device. Returns tensors ``(keys (max_range,), vals, count,
        truncated)``, truncation folded across shards."""
        width = range_bucket(1)
        los = np.zeros(width, np.int32)
        his = np.zeros(width, np.int32)
        los[0], his[0] = lo, hi
        k, v, c, tr = _range_many_sharded(self.p_active, self.state,
                                          self._tensor(los),
                                          self._tensor(his), 1)
        return k[0], v[0], c[0], tr[0]

    def range_many(self, ranges):
        """Batched scans over the fleet: every shard answers all Q scans in
        one pass and the rows merge on the device — `SLSM.range_many`'s
        numpy contract."""
        return range_many_host(
            lambda los, his, n: _range_many_sharded(
                self.p_active, self.state, los, his, n),
            self.p.max_range, ranges, self.device)

    def aggregate_many(self, ranges):
        """Batched windowed count/sum over the fleet: each shard reduces
        its own rows in one pass and the partials fold by int32 addition.
        Returns numpy ``(counts, sums, truncated)``."""
        q, los, his = pad_windows(ranges, self.device)
        if q == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, bool))
        c, s, t = _aggregate_many_sharded(self.p_active, self.state, los,
                                          his, q)
        c, s, t = torch.stack([c, s, t.to(I32)]).cpu().numpy()
        return c[:q], s[:q], t[:q].astype(bool)

    def count(self, lo: int, hi: int) -> int:
        """Live-key count over [lo, hi) across all shards."""
        c, _, _ = self.aggregate_many([(lo, hi)])
        return int(c[0])

    def sum(self, lo: int, hi: int) -> int:
        """Sum of live values over [lo, hi) across all shards (int32
        wraparound)."""
        _, s, _ = self.aggregate_many([(lo, hi)])
        return int(s[0])

    # -- mixed-op tape (engine.tape) -----------------------------------------
    def _route_lanes(self, keys, vals=None, wts=None):
        """Route one chunk's lanes to their owner shards: ``(k (S, Rn), v,
        w, n (S,), sid, pos)``, sid/pos the scatter map of each lane."""
        qs = np.asarray(keys, np.int32).reshape(-1)
        sid, pos, counts, k = self._route(qs, self.p.Rn)
        v = np.zeros_like(k)
        if vals is not None:
            v[sid, pos] = np.asarray(vals, np.int32).reshape(-1)
        w = np.zeros_like(k)
        if wts is not None:
            w[sid, pos] = np.asarray(wts, np.int32).reshape(-1)
        return k, v, w, counts.astype(np.int32), sid, pos

    def tape_write_capacity(self) -> int:
        """Max write keys the next `run_tape` segment may carry: the
        single tree's bound a shard, the least over shards (routing may
        put every key on one)."""
        p = self.p_active
        rcs, scs = self._host(self.state.run_count, self.state.stage_count)
        caps = []
        for rc, sc in zip(rcs.tolist(), scs.tolist()):
            while sc >= p.Rn:
                if rc >= p.R:
                    rc -= p.runs_merged_eff
                rc += 1
                sc -= p.Rn
            free = p.R - rc % p.runs_merged_eff
            caps.append((free + 1) * p.Rn - 1 - sc)
        return min(caps)

    def _reserve_run_slots(self, need: np.ndarray) -> None:
        """Masked flushes (cascading first where level 0 is full) until
        every shard has need[s] free run slots."""
        p = self.p_active
        rm = p.runs_merged_eff
        while True:
            rc = self.state.run_count.cpu().numpy()
            short = (p.R - rc) < need
            if not short.any():
                return
            mask = short & (rc >= rm)
            if not mask.any():
                floors = rc % rm
                raise ValueError(
                    f"cannot reserve {need.max()} run slots on every "
                    f"shard: worst shard reaches {p.R - int(floors.max())} "
                    f"(R={p.R})")
            self._cascade(mask)
            self._apply_step(SCH.FLUSH, -1, mask)

    def run_tape(self, chunks):
        """Execute a coalesced mixed-op window, in stream order —
        `SLSM.run_tape`'s chunk kinds, results, headroom and segmentation,
        every precondition per shard. Write and lookup lanes are routed
        to their owner shards; each range slot is answered by every shard
        and merged on the device. A slot is one op over all shards."""
        chunks = [c if isinstance(c, TP.TapeChunk) else TP.TapeChunk(*c)
                  for c in chunks]
        if not chunks:
            return []
        n_writes = n_reads = 0
        for ch in chunks:
            k = np.asarray(ch.keys, np.int32).reshape(-1)
            if ch.kind == "write":
                reject_reserved(k, op="tape write")
                n_writes += k.size
            elif ch.kind == "lookup":
                reject_reserved(k, op="tape lookup")
                n_reads += k.size
            elif ch.kind != "range":
                raise ValueError(f"unknown tape chunk kind {ch.kind!r}")
        if n_writes:
            self._guard_writes()
        # one WAL record a write chunk, before routing, synced before the
        # window's results return (log-before-ack)
        log = self.durability is not None and not self._replaying
        if log:
            TP.log_write_chunks(self.durability, chunks)
        rb = TP.range_lanes(self.p_active)
        results = [0] * len(chunks)
        work = list(enumerate(chunks))
        while work:
            self._forced_pass()   # every shard's stage absorbs a chunk
            seg, seg_idx = TP.take_segment(work, self.tape_write_capacity())
            self._run_tape_segment(seg, seg_idx, rb, results)
        self.stats["writes"] += n_writes
        self.stats["reads"] += n_reads
        if n_writes:
            self.tuner.note_writes(n_writes)
        if n_reads:
            self.tuner.note_reads(n_reads)
        if log:
            self.durability.sync()
        return results

    def _run_tape_segment(self, seg, seg_idx, rb, results) -> None:
        """Pack, reserve, execute and scatter back one tape segment."""
        p = self.p_active
        rn, t = p.Rn, len(seg)
        t_pad = TP.tape_bucket(t)
        ops = np.zeros(t_pad, np.int32)
        lanes = np.zeros((3, t_pad, self.S, rn), np.int32)
        lanes[0] = KEY_EMPTY
        nv = np.zeros((t_pad, self.S), np.int32)
        scatter = [None] * t
        seal_need = self.state.stage_count.cpu().numpy().astype(np.int64)
        for i, ch in enumerate(seg):
            if ch.kind == "range":
                los = np.asarray(ch.keys, np.int32).reshape(-1)
                his = np.asarray(ch.vals, np.int32).reshape(-1)
                if len(los) > rb:
                    raise ValueError(
                        f"range chunk of {len(los)} scans exceeds its "
                        f"per-slot capacity {rb}")
                ops[i] = TP.OP_RANGE
                lanes[0, i, :, :len(los)] = los[None, :]
                lanes[1, i, :, :len(his)] = his[None, :]
                nv[i, :] = len(los)
                continue
            if ch.kind == "write":
                k, v, w, n, sid, pos = self._route_lanes(*TP.write_lanes(ch))
                seal_need += np.bincount(sid, minlength=self.S)
            else:
                k, v, w, n, sid, pos = self._route_lanes(ch.keys)
            ops[i] = TP.OPCODES[ch.kind]
            lanes[:, i] = k, v, w
            nv[i] = n
            scatter[i] = (sid, pos)
        need = seal_need // rn
        if need.any():
            self._reserve_run_slots(need)
        lv, lf, rk, rv, rc, rt, sealed = self._tape_exec(ops, lanes, nv)
        for i, ch in enumerate(seg):
            j = seg_idx[i]
            if ch.kind == "write":
                results[j] += int(sealed[i])
                self.stats["seals"] += int(sealed[i])
            elif ch.kind == "lookup":
                sid, pos = scatter[i]
                results[j] = (lv[i, sid, pos], lf[i, sid, pos])
            else:
                n = len(np.asarray(ch.keys).reshape(-1))
                results[j] = (rk[i, :n], rv[i, :n], rc[i, :n], rt[i, :n])

    def _tape_exec(self, ops, lanes, nv):
        """Run a packed sharded tape slot by slot, in stream order (the
        reference's `lax.scan`, as `tape.exec_tape` runs the single
        tree's): a write slot stages every shard's lanes and seals the
        shards whose stage filled; a lookup slot answers every shard's
        lanes; a range slot's windows go to every shard and the rows
        merge. Outputs come to the host in one transfer: ``(lookup vals
        (T, S, Rn), found, range keys (T, rb, max_range), vals, counts
        (T, rb), truncated, seals (T,))``."""
        p = self.p_active
        rb, mr = TP.range_lanes(p), p.max_range
        t, rn = len(ops), p.Rn
        dev = self.device
        out = {"lv": torch.zeros((t, self.S, rn), dtype=I32, device=dev),
               "lf": torch.zeros((t, self.S, rn), dtype=I32, device=dev),
               "rk": torch.full((t, rb, mr), _KEY_EMPTY, dtype=I32,
                                device=dev),
               "rv": torch.zeros((t, rb, mr), dtype=I32, device=dev),
               "rc": torch.zeros((t, rb), dtype=I32, device=dev),
               "rt": torch.zeros((t, rb), dtype=I32, device=dev)}
        sealed = np.zeros(t, np.int32)
        dl, dn = self._tensor(lanes), self._tensor(nv)
        for i in range(t):
            op = int(ops[i])
            if op == TP.OP_WRITE:
                self.state = stage_append(p, self.state, dl[0, i], dl[1, i],
                                          dl[2, i], dn[i])
                full = self.state.stage_count.cpu().numpy() >= rn
                if full.any():
                    _seal_where(p, self.state, np.flatnonzero(full))
                    sealed[i] = int(full.sum())
            elif op == TP.OP_LOOKUP:
                v, f = RP.lookup_many(p, self.state, dl[0, i], dn[i])
                out["lv"][i], out["lf"][i] = v, f
            elif op == TP.OP_RANGE:
                k, v, c, tr = _range_many_sharded(
                    p, self.state, dl[0, i, 0, :rb], dl[1, i, 0, :rb],
                    int(nv[i, 0]))
                out["rk"][i], out["rv"][i], out["rc"][i] = k, v, c
                out["rt"][i] = tr
        flat = torch.cat([x.reshape(-1) for x in out.values()]).cpu().numpy()
        host, off = [], 0
        for name, x in out.items():
            a = flat[off:off + x.numel()].reshape(x.shape)
            host.append(a.astype(bool) if name in ("lf", "rt") else a)
            off += x.numel()
        return (*host, sealed)

    # -- durability (engine.wal) -----------------------------------------------
    def _wal_meta(self) -> dict:
        """Engine fingerprint for the WAL's META record (driver kind,
        params, shard count), checked on every reattach."""
        return {"driver": "sharded",
                "params": WAL.params_to_dict(self.p),
                "policy": "tiering", "n_shards": self.S,
                "wal": WAL.WAL_FORMAT}

    def _snapshot_meta(self) -> dict:
        """Host state that rides a snapshot beside the stacked leaves
        (every tier is allocated, so n_levels is max_levels)."""
        return {**self._wal_meta(), "n_levels": self.p.max_levels,
                "tuner": {"active": self.tuner.active,
                          "read_frac": float(self.tuner.read_frac)},
                "stats": {k: int(v) for k, v in self.stats.items()}}

    def snapshot(self):
        """Copy the fleet's stacked state to the host as one atomic
        snapshot stamped with the WAL's seqno watermark. Requires a
        durability layer."""
        if self.durability is None:
            raise ValueError("snapshot() requires a durability layer: "
                             "construct with ShardedSLSM(..., "
                             "durability=path)")
        return self.durability.snapshot(self)

    def _adopt_snapshot(self, leaves, meta: dict) -> None:
        """Install a snapshot's stacked leaves as the state and adopt the
        tuner position and stats in `meta` (raises if the leaves do not
        fit this fleet)."""
        try:
            self.state = convert.state_from_leaves(
                self.p, leaves, self.device, self.p.max_levels, self.S)
        except ValueError as e:
            raise WAL.SnapshotError(f"snapshot does not fit this engine: "
                                    f"{e}") from None
        for k, v in meta.get("stats", {}).items():
            self.stats[k] = int(v)
        t = meta.get("tuner")
        if t and self.tuner.enabled:
            name = t.get("active", self.tuner.active)
            self.tuner.active = self.tuner.target = name
            self.tuner.read_frac = float(t.get("read_frac",
                                               self.tuner.read_frac))
            self.p_active = self.tuner.allocation(name).apply(self.p)

    def _replay(self, records) -> None:
        """Re-apply WAL records through the write path with logging off
        (answer-exact, not bitwise-state-exact, as `SLSM._replay`)."""
        self._replaying = True
        try:
            n = 0
            for rec in records:
                if rec.kind in WAL.WRITE_KINDS:
                    k, v, w = WAL.decode_write(rec.payload, rec.kind)
                    self._insert(k, v, w)
                elif rec.kind == WAL.REC_RETUNE:
                    if self.tuner.enabled:
                        self.tuner.target = rec.payload.decode()
                        if self.tuner.pending:
                            self._apply_retune()
                else:
                    continue
                n += 1
            self.stats["replayed_records"] += n
        finally:
            self._replaying = False

    @classmethod
    def restore(cls, path, params: SLSMParams | None = None,
                n_shards: int | None = None, durability=None, device=None):
        """Recover a fleet from a durability directory (written by the
        port or the reference): the newest valid snapshot, then the WAL
        records past its watermark; a torn final record is dropped.
        `params` and `n_shards` default to the recorded fingerprint; the
        fleet lives on `device` (the card unless ``device="cpu"``)."""
        t0 = time.perf_counter()
        device = resolve_device(device)
        dur = WAL.as_durability(durability if durability is not None
                                else path)
        records = dur.read_records()
        header = next((json.loads(r.payload.decode()) for r in records
                       if r.kind == WAL.REC_META), None)
        snap = WAL.load_latest_snapshot(dur.dir)
        meta = snap[2] if snap is not None else header
        if meta is None and params is None:
            raise ValueError(f"nothing to restore in {dur.dir}: no valid "
                             "snapshot and no readable WAL header")
        if params is None:
            params = WAL.params_from_dict(meta["params"])
        if n_shards is None:
            # a single tree's fingerprint has no shard count: the
            # constructor's header check then raises the mismatch
            n_shards = (int(meta.get("n_shards", 4))
                        if meta is not None else 4)
        drv = cls(params, n_shards, durability=dur, device=device)
        watermark = -1
        if snap is not None:
            num, leaves, smeta = snap
            drv._adopt_snapshot(leaves, smeta)
            watermark = num
        drv._replay([r for r in records if r.seqno > watermark])
        drv.stats["restore_us"] += int((time.perf_counter() - t0) * 1e6)
        return drv

    @classmethod
    def open_replica(cls, path, *, fsync: bool = False, device=None):
        """Open a sharded replication follower over a bootstrapped
        directory: a `restore` under a replica-mode durability layer that
        never writes a META record of its own."""
        return cls.restore(path, durability=WAL.Durability(
            path, fsync=fsync, replica=True), device=device)

    def apply_replicated(self, records) -> int:
        """Apply decoded leader WAL records through the replay path.
        Returns the records applied."""
        before = self.stats["replayed_records"]
        self._replay(records)
        return self.stats["replayed_records"] - before

    def promote(self) -> "ShardedSLSM":
        """Failover: make this replica fleet a writable leader (epoch bump,
        local logging on). Returns self."""
        if self.durability is None:
            raise ValueError("promote() requires a durability layer")
        self.durability.writer.bump_epoch()
        self.durability.replica = False
        self.fenced = False
        self.stats["promotions"] += 1
        return self

    def demote(self) -> "ShardedSLSM":
        """Fence this fleet against writes (a deposed leader): reads stay
        served, writes raise until `promote()`. Returns self."""
        self.fenced = True
        self.stats["demotions"] += 1
        return self

    # -- stats ----------------------------------------------------------------
    @property
    def n_live(self) -> int:
        """Resident elements across every shard's stage, memory runs and
        disk levels (duplicates and delete records count until merges
        drop them)."""
        return int(self.shard_occupancy().sum())

    def shard_occupancy(self) -> np.ndarray:
        """(S,) resident elements a shard — routing-balance introspection."""
        st = self.state
        per = st.stage_count.long() + st.buf_counts.long().sum(dim=1)
        for lv in st.levels:
            per = per + lv.counts.long().sum(dim=1)
        return per.cpu().numpy()
