"""Incremental merge scheduler: the Do-Merge cascade as paced, bounded steps.

A port of `repro.engine.scheduler` without `warm()` (PyTorch is eager:
there is nothing to precompile). The cascade is four bounded step kinds,
and the adaptive tuner adds a fifth:

  seal     — stage -> one sealed memory run (memtable.seal_run)
  flush    — ceil(m*R_eff) memory runs -> one L0 run
             (compaction.merge_buffer_to_level0)
  spill l  — runs of level l -> one l+1 run (compaction.merge_level_down)
  compact  — all runs of the deepest level -> one run
             (compaction.compact_last_level)
  retune   — swap the engine's active allocation and rebuild every
             resident filter under it (tuner.retune_filters)

After every staged insert chunk the tuner decides, up to
`SLSMParams.merge_budget` voluntary steps run, deepest level first (to
quiescence while the read allocation is active or pending), then
whatever the next chunk structurally forces. Budget 0 is the
synchronous cascade. `drain()` retires every pending step, a pending
retune included. A step elides zero-sum (deleted) keys iff its output
becomes the deepest data at the moment it runs. Every step runs at the
engine's active parameters (`SLSM.p_active`) and under its active
compaction policy (`SLSM.policy_active`).

Under adaptive tuning each step ends by storing the run occupancy it
left on the engine (`SLSM.runs`), where lookups read which structures
to leave out without a read of their own.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

from repro_torch.core.params import SLSMParams
from repro_torch.engine.compaction import (CompactionPolicy,
                                           compact_last_level,
                                           merge_buffer_to_level0,
                                           merge_level_down)
from repro_torch.engine.levels import empty_level
from repro_torch.engine.memtable import seal_run
from repro_torch.engine.read_path import host_occupancy
from repro_torch.engine.tuner import READ

SEAL, FLUSH, SPILL, COMPACT = "seal", "flush", "spill", "compact"
RETUNE = "retune"


class Occupancy(NamedTuple):
    """Host-side occupancy snapshot — all the scheduler ever reads."""
    stage_count: int
    run_count: int
    level_runs: Tuple[int, ...]   # n_runs per *materialized* level


def occupancy_of(state) -> Occupancy:
    """Snapshot a state's occupancy counters (one host read each)."""
    return Occupancy(int(state.stage_count), int(state.run_count),
                     tuple(int(lv.n_runs) for lv in state.levels))


def step_order(p: SLSMParams) -> List[Tuple[str, int]]:
    """Canonical deepest-first step order."""
    order: List[Tuple[str, int]] = [(COMPACT, p.max_levels - 1)]
    order += [(SPILL, lvl) for lvl in range(p.max_levels - 2, -1, -1)]
    order += [(FLUSH, -1), (SEAL, -1)]
    return order


def step_pending(kind: str, level: int, occ: Occupancy, p: SLSMParams,
                 policy: CompactionPolicy) -> bool:
    """Does this step have work queued under the current occupancy?"""
    if kind == SEAL:
        return occ.stage_count >= p.Rn
    if kind == FLUSH:
        return occ.run_count >= p.R_eff
    if level >= len(occ.level_runs):
        return False
    return policy.needs_spill(p, occ.level_runs[level], level)


def step_ready(kind: str, level: int, occ: Occupancy, p: SLSMParams,
               policy: CompactionPolicy) -> bool:
    """Can this step run now without violating a policy bound?"""
    if kind == SEAL:
        return occ.stage_count >= p.Rn and occ.run_count < p.R
    if kind == FLUSH:
        if occ.run_count < p.runs_merged_eff:
            return False
        return (len(occ.level_runs) == 0
                or not policy.needs_spill(p, occ.level_runs[0], 0))
    if kind in (COMPACT, RETUNE):
        return True
    dst = level + 1
    return (dst >= len(occ.level_runs)
            or not policy.needs_spill(p, occ.level_runs[dst], dst))


def step_cost(kind: str, level: int, p: SLSMParams) -> int:
    """Elements touched by one step's merge (the pacing cost axis)."""
    if kind == SEAL:
        return p.Rn
    if kind == FLUSH:
        return p.runs_merged_eff * p.Rn
    if kind == COMPACT:
        return p.D * p.level_cap(p.max_levels - 1)
    if kind == RETUNE:   # every resident filter is rebuilt from its keys
        return p.R * p.Rn + sum(p.D * p.level_cap(lvl)
                                for lvl in range(p.max_levels))
    return p.disk_runs_merged * p.level_cap(level)


class MergeStep(NamedTuple):
    """One bounded unit of Do-Merge work."""
    kind: str
    level: int     # source level for spill/compact; -1 for seal/flush
    cost: int      # elements touched (step_cost)

    def ready(self, occ: Occupancy, p, policy) -> bool:
        """Can this step run now without violating a policy bound?"""
        return step_ready(self.kind, self.level, occ, p, policy)


def pending_steps(p: SLSMParams, policy: CompactionPolicy,
                  occ: Occupancy, retune: bool = False) -> List[MergeStep]:
    """The step backlog under `occ`, deepest-first (execution order); a
    pending allocation switch (`retune`) goes first, so every merge after
    it already builds filters at the new allocation."""
    steps = [MergeStep(kind, level, step_cost(kind, level, p))
             for kind, level in step_order(p)
             if step_pending(kind, level, occ, p, policy)]
    if retune:
        steps.insert(0, MergeStep(RETUNE, -1, step_cost(RETUNE, -1, p)))
    return steps


def backlog_cost(steps) -> int:
    """Total device-op cost of a backlog (telemetry)."""
    return sum(s.cost for s in steps)


def drop_annihilated_into(state, target_level: int) -> bool:
    """Deletes commit when the merge output becomes the deepest data."""
    for lv in state.levels[target_level:]:
        if int(lv.n_runs) > 0:
            return False
    return True


class MergeScheduler:
    """Single-tree scheduler: reads the engine's occupancy and executes
    steps against the engine's state (`SLSM.p_active`, `.policy_active`,
    `.tuner`, `.state`, `.stats`, `.device`)."""

    def __init__(self, eng):
        self.eng = eng

    @property
    def p(self) -> SLSMParams:
        """The engine's active parameter set (the tuner's allocation)."""
        return self.eng.p_active

    @property
    def policy(self) -> CompactionPolicy:
        """The engine's active compaction policy."""
        return self.eng.policy_active

    def _retune_pending(self) -> bool:
        return self.eng.tuner.pending

    def _materialize(self, level: int) -> None:
        """Grow the levels tuple through `level` (lazy, up to max_levels)."""
        eng = self.eng
        while len(eng.state.levels) <= level:
            eng.state = eng.state._replace(
                levels=eng.state.levels
                + (empty_level(self.p, len(eng.state.levels), eng.device),))

    def _book_merge(self, rows_in: int, rows_out: int) -> None:
        """Z-set merge telemetry: rows entering vs surviving the merge."""
        st = self.eng.stats
        st["rows_merged_in"] += rows_in
        st["rows_merged_out"] += rows_out
        st["rows_annihilated"] += rows_in - rows_out
        st["ghost_payload_bytes_skipped"] += 4 * (rows_in - rows_out)

    def run_step(self, step: MergeStep) -> None:
        """Execute one step and bump its stats counter; under adaptive
        tuning, store the run occupancy it left on the engine."""
        eng, p = self.eng, self.p
        if step.kind == RETUNE:
            eng.apply_retune()
            eng.stats["retunes"] += 1
        elif step.kind == SEAL:
            eng.state = seal_run(p, eng.state)
            eng.stats["seals"] += 1
        elif step.kind == FLUSH:
            self._materialize(0)
            mr = p.runs_merged_eff
            rows_in = int(eng.state.buf_counts[:mr].sum())
            slot = int(eng.state.levels[0].n_runs)
            eng.state = merge_buffer_to_level0(
                p, eng.state, drop_annihilated_into(eng.state, 0))
            self._book_merge(rows_in, int(eng.state.levels[0].counts[slot]))
            eng.stats["flushes"] += 1
        elif step.kind == SPILL:
            self._materialize(step.level + 1)
            n_merge = self.policy.runs_to_spill(
                p, int(eng.state.levels[step.level].n_runs))
            rows_in = int(eng.state.levels[step.level].counts[:n_merge].sum())
            slot = int(eng.state.levels[step.level + 1].n_runs)
            eng.state = merge_level_down(
                p, eng.state, step.level, n_merge,
                drop_annihilated_into(eng.state, step.level + 1))
            self._book_merge(
                rows_in, int(eng.state.levels[step.level + 1].counts[slot]))
            eng.stats["spills"] += 1
        else:   # COMPACT
            last = p.max_levels - 1
            rows_in = int(eng.state.levels[last].counts.sum())
            new_state, raw = compact_last_level(p, eng.state)
            cap = p.level_cap(last)
            if int(raw) > cap:
                raise RuntimeError(
                    f"sLSM deepest level overflow ({int(raw)} > {cap} "
                    f"live elements): increase max_levels beyond "
                    f"{p.max_levels}")
            eng.state = new_state
            self._book_merge(rows_in, int(raw))
            eng.stats["compactions"] += 1
        if eng.tuner.enabled:
            eng.runs = host_occupancy(eng.state)

    def seal(self) -> None:
        """One SEAL step (a tape's write slot that filled the stage)."""
        self.run_step(MergeStep(SEAL, -1, step_cost(SEAL, -1, self.p)))

    def force_space(self, level: int) -> None:
        """Guarantee `level` can accept one run, recursing deeper first."""
        eng, p = self.eng, self.p
        if level >= p.max_levels:
            raise RuntimeError(
                "sLSM capacity exceeded: increase max_levels "
                f"(currently {p.max_levels})")
        if level >= len(eng.state.levels):
            self._materialize(level)
            return
        if not self.policy.needs_spill(
                p, int(eng.state.levels[level].n_runs), level):
            return
        if level == p.max_levels - 1:
            self.run_step(MergeStep(COMPACT, level,
                                    step_cost(COMPACT, level, p)))
        else:
            self.force_space(level + 1)
            self.run_step(MergeStep(SPILL, level, step_cost(SPILL, level, p)))

    def _next_ready(self):
        """Deepest pending step that is ready under the live occupancy."""
        p, policy = self.p, self.policy
        occ = occupancy_of(self.eng.state)
        for step in pending_steps(p, policy, occ, self._retune_pending()):
            if step.ready(occ, p, policy):
                return step
        return None

    def on_chunk(self) -> None:
        """The tuner decides (and now and then takes a probe sample), then
        voluntary budgeted steps run — to quiescence while the read
        allocation is active or pending — then whatever the next chunk
        forces. With budget 0 a pending retune runs inline."""
        eng = self.eng
        tuner = eng.tuner
        tuner.decide()
        if tuner.take_probe_sample():
            eng.sample_probe_stats()
        p = self.p
        backlog = pending_steps(p, self.policy, occupancy_of(eng.state),
                                self._retune_pending())
        eng.stats["backlog_peak"] = max(eng.stats["backlog_peak"],
                                        len(backlog))
        budget = p.merge_budget
        catch_up = (budget > 0 and tuner.enabled
                    and (tuner.active == READ
                         or (tuner.pending and tuner.target == READ)))
        while budget > 0 or catch_up:
            step = self._next_ready()
            if step is None:
                break
            self.run_step(step)
            budget -= 1
        if p.merge_budget == 0 and self._retune_pending():
            self.run_step(MergeStep(RETUNE, -1, step_cost(RETUNE, -1, p)))
        self.ensure_stage_space()

    def ensure_stage_space(self) -> None:
        """Forced chain: seal (flushing/cascading first when the buffer is
        out of run slots) until the staging buffer can absorb a full
        Rn-chunk."""
        eng, p = self.eng, self.p
        while int(eng.state.stage_count) >= p.Rn:
            if int(eng.state.run_count) >= p.R:
                self.force_space(0)
                self.run_step(MergeStep(FLUSH, -1, step_cost(FLUSH, -1, p)))
            self.run_step(MergeStep(SEAL, -1, step_cost(SEAL, -1, p)))

    def reserve_run_slots(self, n: int) -> None:
        """Guarantee >= `n` free memory-run slots (flushing, and cascading
        when level 0 is full, until they exist): the headroom a mixed-op
        tape needs before it seals in the tape. A flush retires
        `runs_merged_eff` runs, so the reachable floor is ``run_count %
        runs_merged_eff``; more than ``R - floor`` raises ValueError."""
        p = self.p
        floor = int(self.eng.state.run_count) % p.runs_merged_eff
        if n > p.R - floor:
            raise ValueError(
                f"cannot reserve {n} run slots: only {p.R - floor} "
                f"reachable (R={p.R}, {floor} unflushable resident runs)")
        while p.R - int(self.eng.state.run_count) < n:
            self.force_space(0)
            self.run_step(MergeStep(FLUSH, -1, step_cost(FLUSH, -1, p)))

    def voluntary_steps(self, budget: int) -> int:
        """Run up to `budget` ready steps, deepest-first (a pending RETUNE
        rides the backlog like any merge); returns how many ran."""
        ran = 0
        while ran < budget:
            step = self._next_ready()
            if step is None:
                break
            self.run_step(step)
            ran += 1
        return ran

    def on_read(self) -> None:
        """Decision boundary on the read path (adaptive only): reads roll
        the controller but never execute maintenance — a decision binds
        at the next write chunk, `voluntary_steps` or `drain()`."""
        if self.eng.tuner.enabled:
            self.eng.tuner.decide()

    def drain(self) -> None:
        """Retire every pending step, a pending retune included (the
        read-equivalence barrier)."""
        while True:
            backlog = pending_steps(self.p, self.policy,
                                    occupancy_of(self.eng.state),
                                    self._retune_pending())
            if not backlog:
                return
            step = self._next_ready()
            if step is None:   # pragma: no cover — invariant violation
                raise RuntimeError(
                    f"merge scheduler drain stalled with backlog {backlog}")
            self.run_step(step)

    @property
    def backlog(self) -> List[MergeStep]:
        """Current pending steps (introspection)."""
        return pending_steps(self.p, self.policy,
                             occupancy_of(self.eng.state),
                             self._retune_pending())
