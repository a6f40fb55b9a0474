"""Seeded workload generators — the paper's Section 3 families as data
(port of `repro.bench.workloads`).

Every generator is a pure function of ``(n, seed, **knobs)`` returning a
`Workload`: fixed arrays for each op phase (insert, delete, point lookup,
range scan). The streams are numpy, drawn from the reference's seeds in
the reference's order, so both packages replay byte-identical op streams
for the same family, size and seed (tests/test_torch_workloads.py holds
them bitwise); one reordered draw would change every later byte.

Key-space convention: **inserted keys are always even**; ``key | 1`` is
therefore guaranteed-absent. That gives every family an exact absent-key
stream for Bloom false-positive measurement and miss-path lookups without
any membership bookkeeping.

Families (registry `WORKLOAD_FAMILIES`):
  uniform      — uniform random keys + mixed hit/miss point lookups
                 (paper 3.2-3.8: the default load for every sweep)
  sequential   — monotonically increasing keys, the LSM best case
                 (runs never overlap; cf. paper 3.9.1 low-variance limit)
  zipfian      — bounded Zipf(theta) over a shuffled key universe; the
                 YCSB-style skew the paper's update-in-place dedup (3.9.1)
                 and clustered-lookup experiments (3.9.2) are about
  delete-heavy — insert then tombstone a configured fraction (paper 2.8);
                 lookups split between deleted (must miss) and live keys
  range-scan   — uniform load + a stream of [lo, hi) scan windows
                 (paper 2.9 / 3.7: latency linear in span)
  shifting     — uniform write-heavy, then Zipf read-heavy, no drain
                 between (the adaptive tuner's proving ground)
  serving      — interleaved multi-client tagged request stream (a
                 `ServingWorkload`, not phase arrays: the input of
                 `repro_torch.serve`'s `closed_loop`)

`make_kv_workload` (the per-figure generator, parameterized by raw
variance) lives here too; `repro_torch.data` re-exports it.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import numpy as np

_I32_MAX = 2**31 - 2


def _rng(family: str, seed: int) -> np.random.Generator:
    """Family-salted generator: distinct families never share a stream
    even at the same seed (crc32 is stable across platforms/runs)."""
    return np.random.default_rng((zlib.crc32(family.encode()), seed))


@dataclass
class Workload:
    """One deterministic op stream: phases are fixed arrays, not callbacks."""

    name: str
    kind: str
    seed: int
    keys: np.ndarray                 # insert keys (int32, even)
    vals: np.ndarray                 # insert values (int32)
    lookups: np.ndarray              # point-lookup keys (hits and misses)
    deletes: np.ndarray              # keys to tombstone (may be empty)
    ranges: np.ndarray               # (n_ranges, 2) [lo, hi) windows
    absent: np.ndarray               # guaranteed-absent keys (odd)
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def n(self) -> int:
        """Insert-stream length (the workload's size parameter)."""
        return len(self.keys)


def _finish(rng, kind, seed, keys, lookups_present, *, n_lookups,
            miss_frac, deletes=None, ranges=None, meta=None,
            lookups_override=None) -> Workload:
    """Shared assembly: values, hit/miss lookup mix, absent stream.
    A family with its own lookup semantics (delete-heavy's dead/live
    split) passes the stream via ``lookups_override`` instead."""
    keys = keys.astype(np.int32)
    vals = rng.integers(-2**30, 2**30, len(keys), dtype=np.int32)
    if lookups_override is not None:
        lookups = lookups_override.astype(np.int32)
    else:
        n_miss = int(n_lookups * miss_frac)
        n_hit = n_lookups - n_miss
        hits = rng.choice(lookups_present, size=n_hit, replace=True)
        misses = (rng.choice(keys, size=n_miss, replace=True) | np.int32(1))
        lookups = np.concatenate([hits, misses]).astype(np.int32)
        rng.shuffle(lookups)
    absent = (rng.choice(keys, size=min(4096, 4 * len(keys)),
                         replace=True) | np.int32(1)).astype(np.int32)
    return Workload(
        name=f"{kind}-n{len(keys)}-s{seed}", kind=kind, seed=seed,
        keys=keys, vals=vals, lookups=lookups,
        deletes=(np.zeros(0, np.int32) if deletes is None
                 else deletes.astype(np.int32)),
        ranges=(np.zeros((0, 2), np.int32) if ranges is None
                else ranges.astype(np.int32)),
        absent=absent, meta=meta or {})


def _even_uniform(rng, n, key_space) -> np.ndarray:
    return (rng.integers(0, key_space // 2, n, dtype=np.int64) * 2).astype(
        np.int32)


def make_uniform(n: int, seed: int = 0, *, key_space: int = _I32_MAX,
                 lookup_frac: float = 0.5,
                 miss_frac: float = 0.25) -> Workload:
    """Uniform random keys — the paper's default load (Section 3.2)."""
    rng = _rng("bench-uniform", seed)
    keys = _even_uniform(rng, n, key_space)
    return _finish(rng, "uniform", seed, keys, keys,
                   n_lookups=int(n * lookup_frac), miss_frac=miss_frac,
                   meta={"key_space": key_space})


def make_sequential(n: int, seed: int = 0, *, lookup_frac: float = 0.5,
                    miss_frac: float = 0.25) -> Workload:
    """Monotonically increasing keys — runs never overlap (LSM best case).

    The seeded start offset keeps distinct seeds on distinct key ranges;
    keys stay even so the `| 1` absent-stream convention holds.
    """
    rng = _rng("bench-sequential", seed)
    start = int(rng.integers(0, 2**20))
    keys = ((start + np.arange(n, dtype=np.int64)) * 2).astype(np.int32)
    return _finish(rng, "sequential", seed, keys, keys,
                   n_lookups=int(n * lookup_frac), miss_frac=miss_frac,
                   meta={"start": start})


def zipf_probs(universe: int, theta: float) -> np.ndarray:
    """Exact rank probabilities p_i ∝ 1/i^theta for a bounded Zipf."""
    w = 1.0 / np.power(np.arange(1, universe + 1, dtype=np.float64), theta)
    return w / w.sum()


def zipf_expected_top_mass(universe: int, theta: float,
                           frac: float = 0.01) -> float:
    """Probability mass the top ``frac`` of ranks receives — the analytic
    skew target the tests check the sampler against."""
    top = max(1, int(universe * frac))
    return float(zipf_probs(universe, theta)[:top].sum())


def make_zipfian(n: int, seed: int = 0, *, universe: int = 20_000,
                 theta: float = 1.1, lookup_frac: float = 0.5,
                 miss_frac: float = 0.25) -> Workload:
    """Bounded Zipf(theta) via inverse-CDF over a shuffled key universe.

    Unlike ``numpy.random.zipf`` (unbounded, theta > 1 only) this draws
    ranks from the exact truncated distribution, then maps rank -> key
    through a seeded permutation so the hot keys are scattered across the
    key space (the paper's skew experiments, 3.9.1/3.9.2, are about
    *frequency* skew, not key-space clustering). Heavy duplication
    exercises the staging buffer's update-in-place dedup.
    """
    rng = _rng("bench-zipfian", seed)
    probs = zipf_probs(universe, theta)
    cdf = np.cumsum(probs)
    ranks = np.searchsorted(cdf, rng.random(n), side="right")
    ranks = np.minimum(ranks, universe - 1)
    perm = rng.permutation(universe).astype(np.int64)
    keys = (perm[ranks] * 2).astype(np.int32)
    # hit-lookup pool: zipf-weighted over the ranks actually inserted, so
    # the configured miss_frac holds exactly (an unconditional zipf draw
    # would hit never-inserted tail ranks and drift the miss rate with n)
    ins_ranks = np.unique(ranks)
    cdf_ins = np.cumsum(probs[ins_ranks])
    cdf_ins /= cdf_ins[-1]
    lookup_ranks = ins_ranks[np.minimum(
        np.searchsorted(cdf_ins, rng.random(n), side="right"),
        len(ins_ranks) - 1)]
    lookup_pool = (perm[lookup_ranks] * 2).astype(np.int32)
    return _finish(
        rng, "zipfian", seed, keys, lookup_pool,
        n_lookups=int(n * lookup_frac), miss_frac=miss_frac,
        meta={"universe": universe, "theta": theta,
              "expected_top1pct_mass": zipf_expected_top_mass(universe, theta)})


def _scan_windows(rng, keys: np.ndarray, n_ranges: int,
                  span: int) -> np.ndarray:
    """(n_ranges, 2) [lo, hi) windows centred on inserted keys, so every
    scan touches data. Drawn *after* every other phase's stream so
    enabling scans in a family leaves its insert/delete/lookup bytes
    untouched."""
    if n_ranges <= 0:
        return np.zeros((0, 2), np.int32)
    centres = rng.choice(keys, size=n_ranges, replace=True).astype(np.int64)
    lo = np.maximum(0, centres - span // 2)
    hi = np.minimum(_I32_MAX, lo + span)
    return np.stack([lo, hi], axis=1).astype(np.int32)


def make_delete_heavy(n: int, seed: int = 0, *, delete_frac: float = 0.4,
                      key_space: int = 2**26, lookup_frac: float = 0.5,
                      miss_frac: float = 0.0, n_ranges: int = 0,
                      span: int = 2**18) -> Workload:
    """Insert then tombstone ``delete_frac`` of the distinct keys (paper
    2.8). Lookups: ``miss_frac`` absent probes; the rest split ~50/50
    between deleted keys (must miss once the tombstone is newest) and
    surviving keys. ``n_ranges`` adds post-delete scan windows (paper
    2.9) — scans over tombstone-dense data, the range engine's dedup
    stress case."""
    rng = _rng("bench-delete-heavy", seed)
    keys = _even_uniform(rng, n, key_space)
    distinct = np.unique(keys)
    n_del = max(1, int(len(distinct) * delete_frac))
    deleted = rng.choice(distinct, size=n_del, replace=False)
    live_mask = ~np.isin(distinct, deleted)
    live = distinct[live_mask] if live_mask.any() else deleted
    n_lookups = int(n * lookup_frac)
    n_absent = int(n_lookups * miss_frac)
    n_present = n_lookups - n_absent
    lk_absent = rng.choice(keys, size=n_absent, replace=True) | np.int32(1)
    lk_dead = rng.choice(deleted, size=n_present // 2, replace=True)
    lk_live = rng.choice(live, size=n_present - n_present // 2, replace=True)
    lookups = np.concatenate([lk_absent, lk_dead, lk_live]).astype(np.int32)
    rng.shuffle(lookups)
    out = _finish(rng, "delete-heavy", seed, keys, keys,
                  n_lookups=n_lookups, miss_frac=miss_frac,
                  deletes=deleted, lookups_override=lookups,
                  meta={"delete_frac": delete_frac,
                        "n_deleted": int(n_del), "span": span})
    out.ranges = _scan_windows(rng, keys, n_ranges, span)
    return out


def make_range_scan(n: int, seed: int = 0, *, key_space: int = 2**24,
                    n_ranges: int = 64, span: int = 2**16,
                    lookup_frac: float = 0.1,
                    miss_frac: float = 0.25) -> Workload:
    """Uniform load over a compact key space + [lo, hi) scan windows
    centred on inserted keys, so every scan touches data (paper 2.9/3.7:
    scan latency is linear in span)."""
    rng = _rng("bench-range-scan", seed)
    keys = _even_uniform(rng, n, key_space)
    centres = rng.choice(keys, size=n_ranges, replace=True).astype(np.int64)
    lo = np.maximum(0, centres - span // 2)
    hi = np.minimum(_I32_MAX, lo + span)
    ranges = np.stack([lo, hi], axis=1)
    return _finish(rng, "range-scan", seed, keys, keys,
                   n_lookups=max(1, int(n * lookup_frac)),
                   miss_frac=miss_frac, ranges=ranges,
                   meta={"n_ranges": n_ranges, "span": span,
                         "key_space": key_space})


def make_shifting(n: int, seed: int = 0, *, write_frac: float = 0.85,
                  key_space: int = 2**24, theta: float = 1.1,
                  lookup_frac: float = 4.0, miss_frac: float = 0.25,
                  n_ranges: int = 0, span: int = 2**16) -> Workload:
    """Mid-run workload shift: uniform write-heavy, then zipfian read-heavy.

    The adaptive tuner's proving ground: phase 1 is a bulk
    uniform insert stream with a trickle of lookups (the write-heavy
    regime the write-optimized allocation serves); phase 2 flips to
    Zipf(theta)-skewed lookups over the inserted data with a trickle of
    fresh inserts (the read-heavy regime; ``lookup_frac`` defaults well
    above 1 — a serving phase reads its data many times over, which is
    what makes paying an adaptation worthwhile). No drain separates the
    phases — the engine meets the shift mid-flight, exactly as a static
    configuration would.

    Phase geometry rides in ``meta``: ``n_phase1`` splits ``keys``,
    ``n_lookups_phase1`` splits ``lookups``. Keys stay even (absent
    probes are ``key | 1``, the module-wide convention). ``n_ranges``
    adds scan windows over the phase-1 data (measured after the
    read-heavy phase, like the per-query lookups).
    """
    rng = _rng("bench-shifting", seed)
    n1 = max(1, int(n * write_frac))
    n2 = max(1, n - n1)
    keys1 = _even_uniform(rng, n1, key_space)
    keys2 = _even_uniform(rng, n2, key_space)
    keys = np.concatenate([keys1, keys2])
    vals = rng.integers(-2**30, 2**30, len(keys), dtype=np.int32)
    n_lookups = max(2, int(n * lookup_frac))
    nl1 = max(1, n_lookups // 20)            # phase-1 read trickle
    nl2 = n_lookups - nl1

    def mixed(pool: np.ndarray, count: int) -> np.ndarray:
        n_miss = int(count * miss_frac)
        hits = rng.choice(pool, size=count - n_miss, replace=True)
        miss = rng.choice(keys1, size=n_miss, replace=True) | np.int32(1)
        out = np.concatenate([hits, miss]).astype(np.int32)
        rng.shuffle(out)
        return out

    l1 = mixed(keys1, nl1)
    # phase 2: zipf-skewed over the distinct phase-1 keys (hot working set)
    distinct = np.unique(keys1)
    probs = zipf_probs(len(distinct), theta)
    ranks = np.minimum(
        np.searchsorted(np.cumsum(probs), rng.random(nl2), side="right"),
        len(distinct) - 1)
    hot_perm = rng.permutation(len(distinct))
    l2 = mixed(distinct[hot_perm[ranks]], nl2)
    absent = (rng.choice(keys1, size=min(4096, 4 * n1), replace=True)
              | np.int32(1)).astype(np.int32)
    return Workload(
        name=f"shifting-n{n}-s{seed}", kind="shifting", seed=seed,
        keys=keys.astype(np.int32), vals=vals,
        lookups=np.concatenate([l1, l2]),
        deletes=np.zeros(0, np.int32),
        ranges=_scan_windows(rng, keys1, n_ranges, span),
        absent=absent,
        meta={"n_phase1": int(n1), "n_lookups_phase1": int(nl1),
              "theta": theta, "key_space": key_space,
              "write_frac": write_frac, "span": span})


@dataclass
class ServingRequest:
    """One tagged request in a serving stream: ``kind`` is insert /
    delete / lookup / range; ``keys``/``vals`` follow `repro_torch.serve`'s
    submit convention (vals = values for inserts, hi bounds for ranges,
    unused otherwise). ``client`` tags the generating client — the
    closed-loop load generator re-partitions the stream by concurrency,
    so the tag documents provenance rather than routing."""

    client: int
    kind: str
    keys: np.ndarray
    vals: np.ndarray


@dataclass
class ServingWorkload:
    """One deterministic interleaved multi-client request stream (the
    `serving` scenario's input — not phase arrays like `Workload`, but
    a stream-ordered tagged request list the batching server coalesces
    at runtime)."""

    name: str
    kind: str
    seed: int
    requests: list
    absent: np.ndarray               # guaranteed-absent keys (odd)
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def n(self) -> int:
        """Total ops across the stream (the size parameter)."""
        return int(sum(len(r.keys) for r in self.requests))


def make_serving(n: int, seed: int = 0, *, n_clients: int = 16,
                 key_space: int = 2**22, insert_frac: float = 0.50,
                 lookup_frac: float = 0.33, delete_frac: float = 0.07,
                 miss_frac: float = 0.25, max_req: int = 16,
                 span: int = 2**12) -> ServingWorkload:
    """Interleaved multi-client tagged request stream (~`n` total ops).

    Serving-shaped requests: each carries 1..`max_req` ops (scan
    requests carry 1-2 windows), kinds drawn from the configured mix
    (the remainder after insert/lookup/delete is range scans). The
    stream opens with an insert-only warm prefix (~10% of `n`) so reads
    have data to hit; lookups mix hits over the inserted-so-far prefix
    with guaranteed-absent probes (``key | 1`` — inserted keys are even,
    the module-wide convention), deletes tombstone previously inserted
    keys, and scan windows are centred on inserted keys. Deterministic
    under (family, seed), like every generator here.
    """
    rng = _rng("bench-serving", seed)
    kinds = np.array(["insert", "lookup", "delete", "range"])
    probs = np.array([insert_frac, lookup_frac, delete_frac,
                      1.0 - insert_frac - lookup_frac - delete_frac])
    if probs[-1] < 0:
        raise ValueError("serving op mix exceeds 1.0")
    requests: list = []
    inserted: list = []
    ops = 0
    warm_ops = max(max_req, n // 10)
    i = 0
    while ops < n:
        client = i % n_clients
        kind = ("insert" if ops < warm_ops or not inserted
                else str(rng.choice(kinds, p=probs)))
        if kind == "insert":
            sz = int(rng.integers(1, max_req + 1))
            ks = _even_uniform(rng, sz, key_space)
            vs = rng.integers(1, 2**30, sz, dtype=np.int32)
            inserted.append(ks)
            requests.append(ServingRequest(client, "insert", ks, vs))
        elif kind == "lookup":
            sz = int(rng.integers(1, max_req + 1))
            pool = inserted[int(rng.integers(0, len(inserted)))]
            ks = rng.choice(pool, sz, replace=True).astype(np.int32)
            miss = rng.random(sz) < miss_frac
            ks[miss] |= np.int32(1)
            requests.append(ServingRequest(
                client, "lookup", ks, np.zeros(sz, np.int32)))
        elif kind == "delete":
            sz = int(rng.integers(1, max(2, max_req // 4)))
            pool = inserted[int(rng.integers(0, len(inserted)))]
            ks = rng.choice(pool, sz, replace=True).astype(np.int32)
            requests.append(ServingRequest(
                client, "delete", ks, np.zeros(sz, np.int32)))
        else:  # range
            sz = int(rng.integers(1, 3))
            pool = inserted[int(rng.integers(0, len(inserted)))]
            centres = rng.choice(pool, sz, replace=True).astype(np.int64)
            lo = np.maximum(0, centres - span // 2).astype(np.int32)
            hi = np.minimum(_I32_MAX, lo.astype(np.int64) + span).astype(
                np.int32)
            requests.append(ServingRequest(client, "range", lo, hi))
        ops += len(requests[-1].keys)
        i += 1
    all_keys = np.concatenate(inserted)
    absent = (rng.choice(all_keys, size=min(4096, 4 * len(all_keys)),
                         replace=True) | np.int32(1)).astype(np.int32)
    return ServingWorkload(
        name=f"serving-n{n}-s{seed}", kind="serving", seed=seed,
        requests=requests, absent=absent,
        meta={"n_clients": n_clients, "key_space": key_space,
              "insert_frac": insert_frac, "lookup_frac": lookup_frac,
              "delete_frac": delete_frac, "miss_frac": miss_frac,
              "max_req": max_req, "span": span,
              "n_requests": len(requests)})


WORKLOAD_FAMILIES: Dict[str, Callable[..., Workload]] = {
    "uniform": make_uniform,
    "sequential": make_sequential,
    "zipfian": make_zipfian,
    "delete-heavy": make_delete_heavy,
    "range-scan": make_range_scan,
    "shifting": make_shifting,
    "serving": make_serving,
}


def make_workload(kind: str, n: int, seed: int = 0, **kw) -> Workload:
    """Build one workload from the family registry (see module docstring)."""
    try:
        fn = WORKLOAD_FAMILIES[kind]
    except KeyError:
        raise ValueError(f"unknown workload family {kind!r}; options: "
                         f"{sorted(WORKLOAD_FAMILIES)}") from None
    return fn(n, seed, **kw)


# --------------------------------------------------------------------------
# legacy generator (the per-figure benches + examples; paper Section 3
# parameterization by raw variance rather than named families)
# --------------------------------------------------------------------------

@dataclass
class KVWorkload:
    keys: np.ndarray      # insert keys, int32
    vals: np.ndarray      # insert values, int32
    lookups: np.ndarray   # lookup keys, int32
    name: str


def make_kv_workload(kind: str, n: int, seed: int = 0, *,
                     variance: float = 1e6, lookup_variance: float = 1e6,
                     lookup_frac: float = 0.5, zipf_a: float = 1.2,
                     key_space: int = 2**31 - 2) -> KVWorkload:
    """Paper Section 3 workload generators (figure benches).

    kind: uniform | normal | zipf | cluster-lookup
    """
    rng = np.random.default_rng(seed)
    n_lookup = int(n * lookup_frac)
    if kind == "uniform":
        keys = rng.integers(0, key_space, n, dtype=np.int64)
        lookups = rng.integers(0, key_space, n_lookup, dtype=np.int64)
    elif kind == "normal":
        keys = np.rint(rng.normal(0.0, np.sqrt(variance), n)).astype(np.int64)
        lookups = np.rint(
            rng.normal(0.0, np.sqrt(lookup_variance), n_lookup)).astype(np.int64)
    elif kind == "zipf":
        keys = rng.zipf(zipf_a, n).astype(np.int64) % key_space
        lookups = rng.zipf(zipf_a, n_lookup).astype(np.int64) % key_space
    elif kind == "cluster-lookup":
        keys = rng.integers(0, key_space, n, dtype=np.int64)
        centre = rng.integers(0, key_space, dtype=np.int64)
        lookups = (centre + np.rint(
            rng.normal(0.0, np.sqrt(lookup_variance), n_lookup)
        ).astype(np.int64))
    else:
        raise ValueError(kind)
    clip = 2**31 - 2
    keys = np.clip(keys, -clip, clip).astype(np.int32)
    lookups = np.clip(lookups, -clip, clip).astype(np.int32)
    vals = rng.integers(-2**30, 2**30, n, dtype=np.int32)
    return KVWorkload(keys=keys, vals=vals, lookups=lookups,
                      name=f"{kind}-n{n}")
