"""Adaptive memory/filter tuner: one byte budget, re-partitioned at runtime.

The port of `repro.engine.tuner` (reference DESIGN.md §9). A static
choice of the sLSM's parameters serves one workload; this controller
moves one byte budget between the write buffer (`r_eff`), the memory
runs' and each disk level's Bloom bits (Monkey-style `eps_per_level`)
and the fence view (`fence_stride`) as the read/write mix shifts.

  Allocation — one point of that space. `apply` swaps the engine's
      active `SLSMParams`; tensor shapes never change, because the state
      is physically sized for the densest allocation the policy admits
      (`SLSMParams.bloom_words_physical`).
  byte model — `allocation_bytes`: 12 bytes a buffered element, 4 a
      filter word, 4 a consulted fence. Presets must fit the policy's
      budget (default: what the static configuration already uses).
  Tuner — the host-side controller: an EWMA of the read share, sampled
      per-level probe telemetry (`read_path.level_probe_stats`), and at
      each decision point the write-/balanced-/read-optimized preset. A
      decision becomes a pending `RETUNE` scheduler step.

A RETUNE rebuilds every resident filter from the keys it covers
(`retune_filters`), so no probe ever sees a filter built at another
geometry than the one it probes with. The arithmetic (the byte model,
the Monkey bisection, the EWMA) is the reference's, in Python floats,
so both tuners decide at the same op.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import bloom as BL
from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.engine.compaction import CompactionPolicy

ELEM_BYTES = 12          # key + value + seqno, int32 each
WORD_BYTES = 4           # Bloom filters are 32-bit word arrays
FENCE_BYTES = 4          # one int32 key per consulted fence
EPS_CEIL = 0.5           # never allocate a filter worse than a coin flip

BALANCED, WRITE, READ = "balanced", "write", "read"


@dataclass(frozen=True)
class Allocation:
    """One point in the tuner's search space."""

    name: str
    r_eff: int                     # active memory runs (<= physical R)
    eps_mem: float                 # memory-run filter FP rate
    eps_per_level: tuple           # per-disk-level FP rates (Monkey-style)
    fence_stride: int = 1          # read-side fence subsampling

    def apply(self, p: SLSMParams) -> SLSMParams:
        """The active parameter set realizing this allocation: only the
        effective fields change, the physical geometry is `p`'s."""
        return dataclasses.replace(
            p, r_eff=self.r_eff, eps_mem=self.eps_mem,
            eps_per_level=self.eps_per_level,
            fence_stride=self.fence_stride)


def _words(p: SLSMParams, n: int, eps: float) -> int:
    return p.bloom_geometry(n, eps)[1]


def allocation_bytes(p: SLSMParams, alloc: Allocation) -> int:
    """Modeled resident bytes of an allocation: write buffer (staging +
    active runs), filter words (memory + disk) and consulted fences."""
    mem = p.stage_cap * ELEM_BYTES + alloc.r_eff * p.Rn * ELEM_BYTES
    filt = alloc.r_eff * _words(p, p.Rn, alloc.eps_mem) * WORD_BYTES
    fences = 0
    for lvl in range(p.max_levels):
        cap = p.level_cap(lvl)
        filt += p.D * _words(p, cap, alloc.eps_per_level[lvl]) * WORD_BYTES
        n_f = p.n_fences(lvl)
        fences += p.D * -(-n_f // alloc.fence_stride) * FENCE_BYTES
    return mem + filt + fences


def monkey_eps_per_level(p: SLSMParams, filter_budget_bytes: int,
                         floor: float) -> tuple:
    """Monkey-style per-level FP rates under a filter byte budget:
    eps_l = base * T^l (T = max(2, ceil(m*D))), `base` bisected in log
    space (60 steps) to the densest profile that fits, each rate clamped
    to [floor, EPS_CEIL]."""
    growth = max(2, p.disk_runs_merged)

    def profile(base: float) -> tuple:
        return tuple(min(EPS_CEIL, max(floor, base * growth ** lvl))
                     for lvl in range(p.max_levels))

    def cost(eps_levels: tuple) -> int:
        return sum(p.D * _words(p, p.level_cap(lvl), e) * WORD_BYTES
                   for lvl, e in enumerate(eps_levels))

    lo, hi = math.log(floor), math.log(EPS_CEIL)
    if cost(profile(floor)) <= filter_budget_bytes:
        return profile(floor)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if cost(profile(math.exp(mid))) <= filter_budget_bytes:
            hi = mid
        else:
            lo = mid
    return profile(math.exp(hi))


def build_presets(p: SLSMParams) -> dict:
    """The three allocations the controller moves between, each priced
    within the budget:

      balanced — the configured static parameters (applying it is a
                 no-op).
      write    — full write buffer, sparse `eps_write` filters (never
                 denser than the statics), fence stride >= 2.
      read     — one active memory run, the balanced filter bytes
                 reshaped Monkey-style, fence stride 1.
    """
    floor = min(p.eps, p.tuning.eps_floor)
    eps_levels_now = tuple(p.level_eps(lvl) for lvl in range(p.max_levels))
    balanced = Allocation(BALANCED, p.R_eff, p.mem_eps, eps_levels_now,
                          p.fence_stride)
    budget = (p.tuning.budget_bytes if p.tuning.budget_bytes is not None
              else allocation_bytes(p, balanced))
    write = Allocation(
        WRITE, p.R,
        min(EPS_CEIL, max(p.tuning.eps_write, floor, p.mem_eps)),
        tuple(min(EPS_CEIL, max(p.tuning.eps_write, floor, p.level_eps(lvl)))
              for lvl in range(p.max_levels)),
        fence_stride=max(2, p.fence_stride))
    balanced_filter_bytes = sum(
        p.D * _words(p, p.level_cap(lvl), p.level_eps(lvl)) * WORD_BYTES
        for lvl in range(p.max_levels))
    read = Allocation(
        READ, 1, p.mem_eps,
        monkey_eps_per_level(p, balanced_filter_bytes, floor),
        fence_stride=1)
    presets = {BALANCED: balanced, WRITE: write, READ: read}
    for alloc in presets.values():
        used = allocation_bytes(p, alloc)
        if used > budget:
            raise ValueError(
                f"tuner preset {alloc.name!r} needs {used} bytes, over the "
                f"{budget}-byte budget — raise TuningPolicy.budget_bytes "
                "or eps_floor")
    return presets


class ReadModePolicy(CompactionPolicy):
    """Depth-aware eager compaction overlay of the read allocation: level
    0 spills every resident run as soon as it holds one, so the read
    phase empties it and lookups leave it out; deeper levels keep the
    paper's tiering rule."""

    name = "read-mode"

    def needs_spill(self, p: SLSMParams, n_runs: int,
                    level: int = 0) -> bool:
        if level == 0:
            return n_runs >= 1
        return n_runs >= p.D

    def runs_to_spill(self, p: SLSMParams, n_runs: int) -> int:
        """All resident runs: a read-mode fold leaves its level empty."""
        return n_runs


# --------------------------------------------------------------------------
# filter rebuild (the device half of a RETUNE step)
# --------------------------------------------------------------------------

def retune_filters(p: SLSMParams, state):
    """Rebuild every resident Bloom filter at `p`'s effective allocation
    from its run's keys (the memory runs, then each disk level), with
    the build rules of `memtable.seal_run` and `levels.index_new_run`:
    retuning to the active allocation is a bitwise no-op. Fences and run
    payloads are untouched."""
    rn = p.Rn
    bits_m, _, k_m = p.bloom_geometry(rn, p.mem_eps)
    wb = p.bloom_words_physical(rn, p.mem_eps)
    valid = (torch.arange(rn, dtype=torch.int32, device=state.buf_keys.device)
             < state.buf_counts[:, None])
    buf_blooms = torch.stack([BL.bloom_build(k, v, wb, k_m, bits_m)
                              for k, v in zip(state.buf_keys, valid)])
    levels = []
    for lvl, lv in enumerate(state.levels):
        cap = p.level_cap(lvl)
        bits, _, kk = p.bloom_geometry(cap, p.level_eps(lvl))
        w = p.bloom_words_physical(cap, p.level_eps(lvl))
        blooms = torch.stack([BL.bloom_build(k, k != int(KEY_EMPTY), w, kk,
                                             bits) for k in lv.keys])
        levels.append(lv._replace(blooms=blooms))
    return state._replace(buf_blooms=buf_blooms, levels=tuple(levels))


# --------------------------------------------------------------------------
# the controller
# --------------------------------------------------------------------------

class Tuner:
    """Host-side workload observer + allocation chooser. Owns no device
    state; the scheduler applies its decisions as `RETUNE` steps. Under
    a static policy every method is an inert no-op."""

    def __init__(self, eng):
        p = eng.p
        self.policy = p.tuning
        self.enabled = self.policy.mode == "adaptive"
        self.presets = build_presets(p) if self.enabled else {}
        self.active = BALANCED
        self.target = BALANCED
        self.budget_bytes = (allocation_bytes(p, self.presets[BALANCED])
                             if self.enabled else None)
        self.read_frac = 0.5                # EWMA of the read share
        self._win_reads = 0
        self._win_writes = 0
        self._since_decision = 0
        self._windows = 0
        self._probe_sampled = False
        # per-level probe telemetry, sampled at write boundaries from the
        # most recent read batch: gate passes vs true hits
        self.last_queries: np.ndarray | None = None
        self.level_candidates = np.zeros(p.max_levels, np.int64)
        self.level_hits = np.zeros(p.max_levels, np.int64)
        self._n_samples = 0

    # -- observation hooks ---------------------------------------------------
    def note_writes(self, n: int) -> None:
        """Fold `n` write ops into the current observation window."""
        if self.enabled and n:
            self._win_writes += int(n)
            self._since_decision += int(n)

    def note_reads(self, n: int) -> None:
        """Fold `n` read ops into the current observation window."""
        if self.enabled and n:
            self._win_reads += int(n)
            self._since_decision += int(n)

    def take_probe_sample(self) -> bool:
        """At most one probe-telemetry sample every fourth decision
        window."""
        if not self.enabled or self._probe_sampled or self._windows % 4:
            return False
        self._probe_sampled = True
        return True

    def note_probe_stats(self, candidates, hits) -> None:
        """Fold one sampled `read_path.level_probe_stats` result in."""
        if self.enabled:
            self.level_candidates += np.asarray(candidates, np.int64)
            self.level_hits += np.asarray(hits, np.int64)
            self._n_samples += 1

    def _disk_traffic_observed(self) -> bool:
        """Do sampled reads reach the disk levels? (No samples yet: yes.)"""
        return self._n_samples == 0 or int(self.level_candidates.sum()) > 0

    @property
    def level_fp_observed(self) -> np.ndarray:
        """Per-level observed false-positive fraction of gate passes."""
        c = np.maximum(self.level_candidates, 1)
        return (self.level_candidates - self.level_hits) / c

    # -- decisions ------------------------------------------------------------
    @property
    def pending(self) -> bool:
        """True when a decided allocation switch awaits its RETUNE step."""
        return self.enabled and self.target != self.active

    def allocation(self, name: str) -> Allocation:
        """The preset `Allocation` registered under `name`."""
        return self.presets[name]

    def decide(self) -> None:
        """Fold the observation window into the EWMA and (re)pick the
        target preset, at most once per `policy.interval` observed ops;
        between the two thresholds the target is kept (hysteresis)."""
        if not self.enabled or self._since_decision < self.policy.interval:
            return
        total = self._win_reads + self._win_writes
        if total == 0:
            return
        frac = self._win_reads / total
        a = self.policy.ewma
        self.read_frac = (1 - a) * self.read_frac + a * frac
        self._win_reads = self._win_writes = 0
        self._since_decision = 0
        self._windows += 1
        self._probe_sampled = False
        if (self.read_frac >= self.policy.read_heavy
                and self._disk_traffic_observed()):
            self.target = READ
        elif (1.0 - self.read_frac) >= self.policy.write_heavy:
            self.target = WRITE

    def applied(self) -> None:
        """The scheduler ran the RETUNE step: the target is now active."""
        self.active = self.target
