"""sLSM tuning parameters — Table 1 of the paper (PyTorch port's copy).

| Parm | Meaning                       | Range    |
|------|-------------------------------|----------|
| R    | Number of runs                | Z > 0    |
| Rn   | Elements per run              | Z > 0    |
| eps  | Bloom filter FP rate          | (0, 1)   |
| D    | Number of disk runs per level | Z > 0    |
| m    | Fraction of runs merged       | (0, 1]   |
| mu   | Fence pointer page size       | Z > 0    |

Paper baseline (Section 3): mu=512, eps=0.001, R=50, Rn=800, D=20, m=1.0.

The geometry is the reference's (`repro.core.params`) property for
property, so both packages size every array identically. One field is
gone: the reference's `backend` selector. The port dispatches each hot
primitive by the device of its tensors instead — a CPU tensor runs the
plain PyTorch version, a CUDA tensor launches the hand-written kernel.

Static-shape bounds: max_levels (preallocated tiers), max_range (result
rows of a range scan), cand_factor (sparse lookup bound), range_cand
(per-scan candidate budget; None = total resident capacity, always
exact). merge_budget paces the Do-Merge cascade (0 = synchronous).
The tuning knobs (eps_per_level, eps_mem, r_eff, fence_stride, tuning)
keep the reference's meaning: with ``tuning.mode == "adaptive"`` the
engine's tuner (`repro_torch.engine.tuner`) moves them at run time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# Key/value sentinels. Keys are int32 (paper: 32-bit integer keys).
KEY_EMPTY = np.int32(np.iinfo(np.int32).max)   # reserved KEY: empty slot/pad
TOMBSTONE = np.int32(np.iinfo(np.int32).min)   # legacy delete value marker
SEQ_NONE = np.int32(-1)                        # "no match" sequence number


@dataclass(frozen=True)
class TuningPolicy:
    """Controller policy of the adaptive tuner (reference DESIGN.md §9):
    ``mode="static"`` never retunes; ``mode="adaptive"`` re-partitions
    `budget_bytes` (None: the static allocation's own bytes) between
    write buffer, filters (no denser than `eps_floor`; `eps_write` for
    the write preset) and fence view, deciding every `interval` ops from
    an EWMA (`ewma`) of the read share against `read_heavy` and
    `write_heavy`."""

    mode: str = "static"
    budget_bytes: int | None = None
    eps_floor: float = 1e-4
    eps_write: float = 2e-2
    interval: int = 2048
    read_heavy: float = 0.7
    write_heavy: float = 0.7
    ewma: float = 0.4

    def __post_init__(self):
        if self.mode not in ("static", "adaptive"):
            raise ValueError(f"unknown tuning mode {self.mode!r}; "
                             "expected 'static' or 'adaptive'")
        if not 0.0 < self.eps_floor < 1.0 or not 0.0 < self.eps_write < 1.0:
            raise ValueError("eps_floor and eps_write must lie in (0, 1)")
        if self.interval < 1:
            raise ValueError("interval must be >= 1")
        if not (0.0 < self.read_heavy <= 1.0 and 0.0 < self.write_heavy <= 1.0
                and 0.0 < self.ewma <= 1.0):
            raise ValueError("read_heavy/write_heavy/ewma must lie in (0, 1]")


@dataclass(frozen=True)
class SLSMParams:
    """Hashable parameter set (the reference's, without `backend`)."""

    R: int = 50
    Rn: int = 800
    eps: float = 1e-3
    D: int = 20
    m: float = 1.0
    mu: int = 512
    max_levels: int = 3
    max_range: int = 4096
    cand_factor: int = 8
    range_cand: int | None = None
    merge_budget: int = 0
    eps_per_level: tuple | None = None
    eps_mem: float | None = None
    r_eff: int | None = None
    fence_stride: int = 1
    tuning: TuningPolicy = TuningPolicy()

    def __post_init__(self):
        if not (self.R > 0 and self.Rn > 0 and self.D > 0 and self.mu > 0):
            raise ValueError("R, Rn, D and mu must be positive")
        if not (0.0 < self.eps < 1.0 and 0.0 < self.m <= 1.0):
            raise ValueError("eps must lie in (0, 1) and m in (0, 1]")
        if self.merge_budget < 0:
            raise ValueError(
                f"merge_budget must be >= 0 (got {self.merge_budget}); "
                "0 = synchronous merges, >0 = steps per insert chunk")
        if self.range_cand is not None and self.range_cand < 1:
            raise ValueError(
                f"range_cand must be >= 1 or None (got {self.range_cand})")
        if self.eps_per_level is not None:
            if len(self.eps_per_level) != self.max_levels:
                raise ValueError(
                    f"eps_per_level needs one rate per level "
                    f"(got {len(self.eps_per_level)}, max_levels="
                    f"{self.max_levels})")
            if not all(0.0 < e < 1.0 for e in self.eps_per_level):
                raise ValueError("eps_per_level rates must lie in (0, 1)")
        if self.eps_mem is not None and not 0.0 < self.eps_mem < 1.0:
            raise ValueError("eps_mem must lie in (0, 1)")
        if self.r_eff is not None and not 1 <= self.r_eff <= self.R:
            raise ValueError(
                f"r_eff must lie in [1, R={self.R}] (got {self.r_eff})")
        if self.fence_stride < 1 or (self.fence_stride
                                     & (self.fence_stride - 1)):
            raise ValueError(
                f"fence_stride must be a power of two >= 1 "
                f"(got {self.fence_stride})")

    # ---- derived geometry -------------------------------------------------
    @property
    def runs_merged(self) -> int:
        """ceil(m*R) memory runs flushed per buffer merge (paper 2.1);
        sizes level 0."""
        return max(1, math.ceil(self.m * self.R))

    @property
    def disk_runs_merged(self) -> int:
        """ceil(m*D) disk runs merged when a level spills (paper 2.5)."""
        return max(1, math.ceil(self.m * self.D))

    def level_cap(self, level: int) -> int:
        """Capacity (elements) of one run at `level`: ceil(m*R)*Rn rounded
        up to a mu multiple, times ceil(m*D)**level, times D at the
        deepest preallocated level (room for an in-place compaction)."""
        c0 = self.runs_merged * self.Rn
        c = ((c0 + self.mu - 1) // self.mu) * self.mu
        c *= self.disk_runs_merged ** level
        if level == self.max_levels - 1:
            c *= self.D
        return c

    def n_fences(self, level: int) -> int:
        """Fence pointers per run at `level` (one every mu slots)."""
        return self.level_cap(level) // self.mu

    @property
    def stage_cap(self) -> int:
        """Staging (active-run) capacity: 2*Rn so an Rn-chunk always fits."""
        return 2 * self.Rn

    def range_cand_eff(self, n_levels: int) -> int:
        """Per-scan candidate-row width with `n_levels` materialized disk
        levels: `range_cand` clamped to the total resident capacity."""
        total = self.stage_cap + self.R * self.Rn + sum(
            self.D * self.level_cap(lvl) for lvl in range(n_levels))
        return total if self.range_cand is None else min(self.range_cand,
                                                         total)

    @property
    def max_candidates(self) -> int:
        """Static bound of the Bloom-compacted (sparse) disk lookup."""
        return self.cand_factor

    # ---- effective tuning views -------------------------------------------
    @property
    def R_eff(self) -> int:
        """Memory runs in active use (a flush is pending at this count)."""
        return self.R if self.r_eff is None else self.r_eff

    @property
    def runs_merged_eff(self) -> int:
        """ceil(m*R_eff) memory runs a flush actually merges."""
        return max(1, math.ceil(self.m * self.R_eff))

    @property
    def mem_eps(self) -> float:
        """FP rate of the sealed-memory-run filters."""
        return self.eps if self.eps_mem is None else self.eps_mem

    def level_eps(self, level: int) -> float:
        """FP rate of `level`'s run filters."""
        if self.eps_per_level is None:
            return self.eps
        return self.eps_per_level[min(level, len(self.eps_per_level) - 1)]

    def bloom_geometry(self, n: int, eps: float | None = None
                       ) -> tuple[int, int, int]:
        """(bits, words, k) for an n-element run at FP rate `eps`:
        bits = ceil(-n ln eps / ln(2)^2) rounded up to 32 (min 64),
        k = round(-log2 eps)."""
        e = self.eps if eps is None else eps
        bits = int(math.ceil(-n * math.log(e) / (math.log(2.0) ** 2)))
        bits = max(64, ((bits + 31) // 32) * 32)
        k = max(1, int(round(-math.log(e) / math.log(2.0))))
        return bits, bits // 32, k

    def bloom_words_physical(self, n: int, eff_eps: float) -> int:
        """Allocated filter width (32-bit words) for an n-element run."""
        if self.tuning.mode == "adaptive":
            return self.bloom_geometry(n, min(self.eps,
                                              self.tuning.eps_floor))[1]
        return self.bloom_geometry(n, eff_eps)[1]

    def fence_view(self, level: int) -> tuple[int, int]:
        """(stride, mu_eff): the read-side fence view of `level`."""
        stride = min(self.fence_stride, max(1, self.n_fences(level)))
        return stride, self.mu * stride
