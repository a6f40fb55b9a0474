"""The Do-Merge cascade (paper Algorithm 2 / 2.5) as explicit policy + ops.

Device side: three merge ops (buffer flush, level spill, deepest
compaction), all built on the k-way merge slot (`backend.merge_runs`,
the heap_merge tournament). Merges move (key, weight, seq) lanes and
gather payloads only for surviving rows.

Host side: a `CompactionPolicy` decides when a level spills and how many
runs move — `TieringPolicy` (the paper's rule) or `LevelingPolicy`.
Annihilation stays a host decision (`scheduler.drop_annihilated_into`).
"""
from __future__ import annotations

import torch

from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.engine import backend as BE
from repro_torch.engine.levels import (_KEY_MIN, empty_level, index_new_run,
                                       set_level_run, shift_level)
from repro_torch.engine.memtable import SLSMState

_KEY_EMPTY = int(KEY_EMPTY)


# --------------------------------------------------------------------------
# host-driven merge policies
# --------------------------------------------------------------------------

class CompactionPolicy:
    """Decides when a disk level spills and how many runs move down."""

    name = "abstract"

    def validate(self, p: SLSMParams) -> None:
        """Raise if the parameter geometry cannot support this policy."""

    def needs_spill(self, p: SLSMParams, n_runs: int,
                    level: int = 0) -> bool:
        """Should a level holding `n_runs` runs be merged down?"""
        raise NotImplementedError

    def runs_to_spill(self, p: SLSMParams, n_runs: int) -> int:
        """How many of the level's oldest runs one spill moves down."""
        raise NotImplementedError


class TieringPolicy(CompactionPolicy):
    """The paper's policy (2.5): spill ceil(m*D) runs once a level is full."""

    name = "tiering"

    def needs_spill(self, p: SLSMParams, n_runs: int,
                    level: int = 0) -> bool:
        return n_runs >= p.D

    def runs_to_spill(self, p: SLSMParams, n_runs: int) -> int:
        """The paper's ceil(m*D) oldest runs (2.5), regardless of depth."""
        return p.disk_runs_merged


class LevelingPolicy(CompactionPolicy):
    """Leveling variant: merge a level down as soon as `max_resident` runs
    coexist, so a level holds ~1 run at rest. Requires ceil(m*D) >=
    max_resident so a spill's output always fits one run of the next
    level."""

    name = "leveling"

    def __init__(self, max_resident: int = 2):
        if max_resident < 2:
            raise ValueError("max_resident must be >= 2")
        self.max_resident = max_resident

    def validate(self, p: SLSMParams) -> None:
        if p.D < self.max_resident:
            raise ValueError(
                f"LevelingPolicy(max_resident={self.max_resident}) needs "
                f"D >= {self.max_resident} run slots per level (D={p.D})")
        if p.disk_runs_merged < self.max_resident:
            raise ValueError(
                "LevelingPolicy needs ceil(m*D) >= max_resident so a spill "
                f"fits the next level's run capacity (ceil(m*D)="
                f"{p.disk_runs_merged}, max_resident={self.max_resident})")

    def needs_spill(self, p: SLSMParams, n_runs: int,
                    level: int = 0) -> bool:
        return n_runs >= self.max_resident

    def runs_to_spill(self, p: SLSMParams, n_runs: int) -> int:
        """All resident runs: a leveling spill leaves its level empty."""
        return n_runs


# --------------------------------------------------------------------------
# merge ops (all k-way merges go through the heap_merge slot)
# --------------------------------------------------------------------------

def merge_buffer_to_level0(p: SLSMParams, state: SLSMState,
                           drop_annihilated: bool) -> SLSMState:
    """Flush the ceil(m*R_eff) oldest memory runs into disk level 0 (paper
    2.1/2.5)."""
    mr = p.runs_merged_eff
    k, v, w, s, cnt = BE.merge_runs(state.buf_keys[:mr], state.buf_vals[:mr],
                                    state.buf_wts[:mr], state.buf_seqs[:mr],
                                    drop_annihilated)
    k, v, w, s, filt, fences, mn, mx = index_new_run(p, 0, k, v, w, s, cnt)
    lv0 = state.levels[0]
    lv0 = set_level_run(lv0, int(lv0.n_runs), k, v, w, s, cnt, filt, fences,
                        mn, mx)

    def roll(a, fill):
        return torch.cat([a[mr:], a.new_full((mr,) + a.shape[1:], fill)])

    return state._replace(
        buf_keys=roll(state.buf_keys, _KEY_EMPTY),
        buf_vals=roll(state.buf_vals, 0),
        buf_wts=roll(state.buf_wts, 0),
        buf_seqs=roll(state.buf_seqs, 0),
        buf_counts=roll(state.buf_counts, 0),
        buf_mins=roll(state.buf_mins, _KEY_EMPTY),
        buf_maxs=roll(state.buf_maxs, _KEY_MIN),
        buf_blooms=roll(state.buf_blooms, 0),
        run_count=state.run_count - mr,
        levels=(lv0,) + state.levels[1:],
    )


def merge_level_down(p: SLSMParams, state: SLSMState, level: int,
                     n_merge: int, drop_annihilated: bool) -> SLSMState:
    """Merge the `n_merge` oldest runs of `level` into one run of
    `level+1`."""
    src = state.levels[level]
    k, v, w, s, cnt = BE.merge_runs(src.keys[:n_merge], src.vals[:n_merge],
                                    src.wts[:n_merge], src.seqs[:n_merge],
                                    drop_annihilated)
    k, v, w, s, filt, fences, mn, mx = index_new_run(p, level + 1,
                                                     k, v, w, s, cnt)
    dst = state.levels[level + 1]
    dst = set_level_run(dst, int(dst.n_runs), k, v, w, s, cnt, filt, fences,
                        mn, mx)
    src = shift_level(p, src, n_merge)
    levels = (state.levels[:level] + (src, dst)
              + state.levels[level + 2:])
    return state._replace(levels=levels)


def compact_last_level(p: SLSMParams, state: SLSMState):
    """In-place compaction of the deepest level: merge all D runs into
    slot 0, annihilating deleted keys (they are the deepest data).
    Returns (state, raw_count); the host raises if raw_count exceeds the
    deepest run capacity."""
    last = p.max_levels - 1
    lv = state.levels[last]
    k, v, w, s, cnt = BE.merge_runs(lv.keys, lv.vals, lv.wts, lv.seqs, True)
    k, v, w, s, filt, fences, mn, mx = index_new_run(p, last, k, v, w, s, cnt)
    fresh = empty_level(p, last, lv.keys.device)
    fresh = set_level_run(fresh, 0, k, v, w, s,
                          torch.clamp(cnt, max=p.level_cap(last)),
                          filt, fences, mn, mx)
    return state._replace(levels=state.levels[:last] + (fresh,)), cnt
