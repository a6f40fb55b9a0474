"""Named benchmark scenarios + parameter sweeps over the paper's knobs
(port of `repro.bench.scenarios`).

A `Scenario` = one workload family + one full engine configuration
(SLSMParams overrides, compaction policy, shard count). The canonical
eight (`scenarios_for("all")`) cover the workload taxonomy — uniform,
sequential, zipfian, delete-heavy, range-scan, the mid-run `shifting`
scenario that proves the adaptive tuner, the closed-loop `serving`
scenario that proves the continuous-batching layer, and the
`replication` scenario that prices single-leader replication over the
WAL — at the CPU-scaled paper baseline; the sweep families
(`scenarios_for("sweeps")`, or one of `sweep-R|sweep-Rn|sweep-D|sweep-m|
sweep-eps|sweep-merge-budget|sweep-policy|sweep-backend|sweep-shards|
sweep-durability|sweep-tuner`) vary exactly one knob at a time: the
paper's experimental axes (Table 1 + Section 3) plus the merge
scheduler's pacing budget, the compaction policy, the shard count, the
WAL on vs off and the adaptive tuner vs every static eps.

The registry is the reference's, name for name and in its order, with
the same overrides. One field differs: the port's `SLSMParams` has no
`backend` selector (a tensor's device picks the plain version or the
kernel), so `sweep_backend_jnp` and `sweep_backend_pallas` keep their
``params`` dicts but `Scenario.engine_params` never passes ``backend``
on; `Scenario.device` maps it to a device instead ("jnp" to the CPU's
plain versions, "pallas" to the card's kernels).

Scenario names are stable identifiers: a benchmark keys its results on
them, so renaming one breaks the history it anchors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List

from repro_torch.core.params import SLSMParams, TuningPolicy


def bench_params(**over) -> SLSMParams:
    """The paper's tuned baseline (Section 3: R=50, Rn=800, D=20, mu=512)
    scaled so every scenario runs in seconds on one CPU core, keeping the
    ratios (R/D, Rn/mu) and eps=1e-3 intact.

    merge_budget=1 paces the Do-Merge cascade one bounded step per insert
    chunk: a synchronous cascade buries the insert tail under the whole
    flush->spill->compact chain. The sweep-merge-budget family keeps the
    synchronous point (merge_budget=0) measured.

    range_cand=512 caps every scan's candidate gather: the canonical scan
    windows hold ~100-250 in-window elements across all structures, so
    the budget leaves 2x+ headroom while keeping a scan's merge width
    ~1000x under the tree's total capacity. Overflowing scans are flagged
    (`truncated`).
    """
    base = dict(R=8, Rn=256, eps=1e-3, D=4, m=1.0, mu=64, max_levels=3,
                max_range=4096, cand_factor=8, merge_budget=1,
                range_cand=512)
    base.update(over)
    return SLSMParams(**base)


# Sizing profiles: n inserts / n point lookups / per-query-path sample /
# batched dispatch width. smoke is the CI gate (seconds); default is the
# trajectory point; full approaches the figure benches.
PROFILES: Dict[str, Dict[str, int]] = {
    # n must exceed (4/3)*(2*R*Rn + insert chunk) for the scenario's
    # engine params: the insert warmup has to cover the first two buffer
    # flushes. smoke satisfies this only for the base params (canonical
    # five); default/full also cover the largest sweep points (Rn=1024,
    # R=32: 2*R*Rn + chunk = 20480).
    # serving_clients = the closed-loop offered-load sweep (client
    # counts, each client 1 outstanding request); serving_ops scales the
    # serving scenario's request stream separately from n (the stream is
    # ~6 ops/request, so n-sized streams would dominate the suite's wall
    # clock at per-request dispatch)
    "smoke": dict(n=7_500, n_lookups=1_024, n_per_query=24, batch=256,
                  n_ranges=8, serving_ops=2_000, serving_clients=(1, 8)),
    "default": dict(n=30_000, n_lookups=4_096, n_per_query=64, batch=1_024,
                    n_ranges=32, serving_ops=8_000,
                    serving_clients=(1, 8, 32)),
    "full": dict(n=60_000, n_lookups=8_192, n_per_query=128, batch=1_024,
                 n_ranges=64, serving_ops=16_000,
                 serving_clients=(1, 8, 32, 64)),
}

# the device of each `backend` value of the sweep-backend family: the
# reference's plain jnp ops are the port's plain versions on the CPU,
# its Pallas kernels the port's CUDA kernels on the card
BACKEND_DEVICE = {"jnp": "cpu", "pallas": "cuda"}


@dataclass
class Scenario:
    """One benchmark point: workload family + engine configuration."""

    name: str                                  # the point's stable identity
    workload: str                              # WORKLOAD_FAMILIES key
    wargs: Dict[str, Any] = field(default_factory=dict)
    params: Dict[str, Any] = field(default_factory=dict)  # SLSMParams overrides
    policy: str = "tiering"                    # tiering | leveling
    n_shards: int = 1                          # 1 = single tree, >1 = ShardedSLSM
    seed: int = 0
    durability: bool = False                   # WAL + fsync on
    replication: int = 0                       # followers to attach after the
                                               # phases (requires durability)

    def engine_params(self) -> SLSMParams:
        """The scenario's full `SLSMParams`: the CPU-scaled paper
        baseline with this scenario's overrides applied, ``backend``
        left out (`device` reads it)."""
        return bench_params(**{k: v for k, v in self.params.items()
                               if k != "backend"})

    def device(self) -> str:
        """The device of the scenario's engine: "cpu" under a
        ``backend="jnp"`` override, else "cuda"."""
        return BACKEND_DEVICE[self.params.get("backend", "pallas")]


# -- the canonical eight: one per workload family (scenarios_for("all")) ---

# the adaptive tuner's policy for the canonical shifting point: decide
# every 512 ops so both phases see decisions even at the smoke profile
ADAPTIVE = TuningPolicy(mode="adaptive", interval=512, eps_floor=1e-4)

# every shifting scenario (tuned + static baselines) shares this
# geometry: Rn=128 halves the buffer capacity so the phase-1 bulk load
# builds real multi-level structure by the flip — the structure a static
# engine then drags through the read phase and the tuner folds away
SHIFT_PARAMS = dict(Rn=128)

CANONICAL: List[Scenario] = [
    Scenario("uniform", "uniform"),
    Scenario("sequential", "sequential"),
    Scenario("zipfian", "zipfian"),
    Scenario("delete_heavy", "delete-heavy"),
    Scenario("range_scan", "range-scan", params=dict(max_range=8192)),
    # the tuner's proving ground: write-heavy -> read-heavy mid-run, the
    # adaptive controller on; sweep-tuner holds the static comparisons
    Scenario("shifting", "shifting",
             params=dict(tuning=ADAPTIVE, **SHIFT_PARAMS)),
    # the continuous-batching serving layer (repro_torch.serve):
    # closed-loop offered-load sweep, coalesced mixed-op tape dispatch vs
    # the per-request baseline at the top offered load
    Scenario("serving", "serving"),
    # single-leader replication over the WAL: the uniform load on a
    # fsyncing leader, then two followers stream the full log (apply
    # throughput + lag drain), and one is promoted (failover wall time +
    # answer-exactness)
    Scenario("replication", "uniform", durability=True, replication=2),
]


def _sweep(prefix: str, axis: str, values, **extra) -> List[Scenario]:
    out = []
    for v in values:
        tag = str(v).replace(".", "p")
        out.append(Scenario(f"{prefix}_{tag}", "uniform",
                            params={axis: v}, **extra))
    return out


SWEEPS: Dict[str, List[Scenario]] = {
    # paper Table 1 knobs, one axis at a time, on the uniform load
    "sweep-R": _sweep("sweep_R", "R", (2, 8, 32)),
    "sweep-Rn": _sweep("sweep_Rn", "Rn", (64, 256, 1024)),
    "sweep-D": _sweep("sweep_D", "D", (2, 4, 8)),
    "sweep-m": _sweep("sweep_m", "m", (0.5, 1.0)),
    "sweep-eps": _sweep("sweep_eps", "eps", (0.1, 1e-3, 1e-5)),
    # this repro's own axes
    # merge pacing: 0 = the paper's synchronous cascade (the write-stall
    # baseline), >0 = steps per insert chunk
    "sweep-merge-budget": _sweep("sweep_merge_budget", "merge_budget",
                                 (0, 1, 2, 4)),
    "sweep-policy": [
        Scenario("sweep_policy_tiering", "uniform", policy="tiering"),
        Scenario("sweep_policy_leveling", "uniform", policy="leveling"),
    ],
    # the reference's ops backend: a device here (Scenario.device)
    "sweep-backend": [
        Scenario("sweep_backend_jnp", "uniform", params=dict(backend="jnp")),
        Scenario("sweep_backend_pallas", "uniform",
                 params=dict(backend="pallas")),
    ],
    "sweep-shards": [
        Scenario("sweep_shards_1", "uniform", n_shards=1),
        Scenario("sweep_shards_4", "uniform", n_shards=4),
    ],
    # the durability tax: the same uniform load with the
    # sequence-numbered WAL group-committing (fsync) at every engine call
    # vs the WAL off
    "sweep-durability": [
        Scenario("sweep_durability_wal", "uniform", durability=True),
        Scenario("sweep_durability_off", "uniform"),
    ],
    # the adaptive tuner vs every static eps on the shifting workload:
    # the canonical `shifting` scenario is the tuned run; these are the
    # best-static-configuration baselines it must beat
    "sweep-tuner": [
        Scenario("sweep_tuner_eps_0p1", "shifting",
                 params=dict(eps=0.1, **SHIFT_PARAMS)),
        Scenario("sweep_tuner_eps_0p001", "shifting",
                 params=dict(eps=1e-3, **SHIFT_PARAMS)),
        Scenario("sweep_tuner_eps_1em05", "shifting",
                 params=dict(eps=1e-5, **SHIFT_PARAMS)),
    ],
}

SCENARIOS: Dict[str, Scenario] = {
    s.name: s for group in ([CANONICAL] + list(SWEEPS.values()))
    for s in group
}


def scenarios_for(selector: str) -> List[Scenario]:
    """Resolve a selector: 'all' (canonical eight), 'sweeps' (every
    sweep), a sweep family ('sweep-R'), a scenario name, or a
    comma-separated mix of the above."""
    out: List[Scenario] = []
    for part in selector.split(","):
        part = part.strip()
        if part == "all":
            out.extend(CANONICAL)
        elif part == "sweeps":
            for group in SWEEPS.values():
                out.extend(group)
        elif part in SWEEPS:
            out.extend(SWEEPS[part])
        elif part in SCENARIOS:
            out.append(SCENARIOS[part])
        else:
            raise ValueError(
                f"unknown scenario selector {part!r}; options: all, sweeps, "
                f"{', '.join(sorted(SWEEPS))}, or a name from "
                f"{', '.join(sorted(SCENARIOS))}")
    seen, uniq = set(), []
    for s in out:
        if s.name not in seen:
            seen.add(s.name)
            uniq.append(s)
    return uniq
