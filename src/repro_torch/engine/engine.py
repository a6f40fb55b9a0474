"""Host-side engine — the paper's insert/merge control flow (Algorithm 2).

`SLSM` owns the state (a NamedTuple of tensors on one device); *when*
maintenance runs is the `MergeScheduler`'s decision (`merge_budget` 0 =
the synchronous Do-Merge cascade, > 0 = paced steps, `drain()` the
barrier). The engine runs on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel slot runs its plain PyTorch
version, on the card its CUDA kernel.

This slice covers the single tree with durability off and static
tuning: write, dense point read, range read, aggregates. The adaptive
tuner, the sparse lookup, the WAL and the mixed-op tape raise
NotImplementedError.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.device import resolve_device
from repro_torch.engine.batching import (bucket_pow2, pad_to, pad_windows,
                                         range_many_host)
from repro_torch.engine.compaction import CompactionPolicy, TieringPolicy
from repro_torch.engine.memtable import init_state, stage_append
from repro_torch.engine.read_path import (aggregate_many, lookup_batch,
                                          lookup_many, range_many,
                                          range_query)
from repro_torch.engine.scheduler import MergeScheduler


def reject_reserved(keys: np.ndarray, vals: np.ndarray | None = None,
                    op: str = "insert") -> None:
    """Reserved-sentinel guard at the public API boundary: KEY_EMPTY
    (INT32_MAX) is the engine's padding key and cannot be stored or
    queried. Every int32 value is a legal payload."""
    del vals
    if keys.size and (keys == KEY_EMPTY).any():
        raise ValueError(
            f"{op}: key {int(KEY_EMPTY)} (KEY_EMPTY/INT32_MAX) is reserved "
            "as the engine's empty-slot sentinel and cannot be stored or "
            "queried")


class SLSM:
    """Host-side engine: owns the state; the merge scheduler owns the
    maintenance schedule. `insert`/`delete`/`lookup`/`range` match the
    paper's API."""

    def __init__(self, params: SLSMParams | None = None,
                 policy: CompactionPolicy | None = None, device=None,
                 durability=None):
        self.p = params or SLSMParams()
        if durability is not None:
            raise NotImplementedError("durability (WAL/snapshots) is not "
                                      "ported yet")
        if self.p.tuning.mode == "adaptive":
            raise NotImplementedError("the adaptive tuner is not ported yet")
        self.device = resolve_device(device)
        self.policy = policy or TieringPolicy()
        self.policy.validate(self.p)
        self.state = init_state(self.p, self.device)
        self.scheduler = MergeScheduler(self)
        self.stats = collections.Counter(seals=0, flushes=0, spills=0,
                                         compactions=0, backlog_peak=0,
                                         retunes=0, reads=0, writes=0,
                                         rows_merged_in=0, rows_merged_out=0,
                                         rows_annihilated=0,
                                         ghost_payload_bytes_skipped=0)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # -- write path -------------------------------------------------------
    def insert(self, keys, vals) -> None:
        """Batched insert (paper Algorithm 1/2): stage in Rn-sized chunks;
        after each chunk the scheduler runs up to `merge_budget` voluntary
        merge steps plus whatever the next chunk structurally forces."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        vals = np.asarray(vals, np.int32).reshape(-1)
        if keys.shape != vals.shape:
            raise ValueError("insert: keys and vals differ in length")
        reject_reserved(keys, vals, op="insert")
        self._insert(keys, vals, np.ones_like(keys))

    def _insert(self, keys: np.ndarray, vals: np.ndarray,
                wts: np.ndarray) -> None:
        self.stats["writes"] += len(keys)
        rn = self.p.Rn
        for off in range(0, len(keys), rn):
            ck, cv = keys[off:off + rn], vals[off:off + rn]
            cw = wts[off:off + rn]
            n = len(ck)
            if n < rn:
                ck = np.pad(ck, (0, rn - n), constant_values=KEY_EMPTY)
                cv = np.pad(cv, (0, rn - n))
                cw = np.pad(cw, (0, rn - n))
            chunk = self._tensor(np.stack([ck, cv, cw]))
            self.state = stage_append(self.p, self.state, chunk[0], chunk[1],
                                      chunk[2], n)
            self.scheduler.on_chunk()

    def delete(self, keys) -> None:
        """Deletes are weight -1 records (paper 2.8); the pair annihilates
        when a merge creates the deepest data (paper 2.5)."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(keys, op="delete")
        self._insert(keys, np.zeros_like(keys), np.full_like(keys, -1))

    def drain(self) -> None:
        """Merge barrier: retire every pending maintenance step."""
        self.scheduler.drain()

    def run_tape(self, chunks, sparse: bool = False):
        """The mixed-op tape is not ported yet."""
        raise NotImplementedError("run_tape (mixed-op tape) is not ported "
                                  "yet")

    # -- read path ----------------------------------------------------------
    def lookup(self, keys, sparse: bool = False):
        """Point lookups (paper 2.7): newest-to-oldest across stage, memory
        runs, then Bloom/fence-gated disk levels. Returns numpy
        (vals, found)."""
        if sparse:
            raise NotImplementedError("the sparse (Bloom-compacted) lookup "
                                      "is not ported yet")
        qs = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(qs, op="lookup")
        self.stats["reads"] += qs.size
        vals, found = lookup_batch(self.p, self.state, self._tensor(qs))
        return vals.cpu().numpy(), found.cpu().numpy()

    def lookup_many(self, keys, sparse: bool = False):
        """Batched multi-key fast path: the queries padded to a
        power-of-two bucket, one Bloom-probe launch over every disk level
        and one fence-search launch a level for all of them. Same results
        as `lookup`."""
        if sparse:
            raise NotImplementedError("the sparse (Bloom-compacted) lookup "
                                      "is not ported yet")
        qs = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(qs, op="lookup_many")
        if qs.size == 0:
            return np.zeros(0, np.int32), np.zeros(0, bool)
        self.stats["reads"] += qs.size
        vals, found = lookup_many(self.p, self.state,
                                  self._tensor(pad_to(qs, bucket_pow2(
                                      qs.size))), qs.size)
        return (vals[:qs.size].cpu().numpy(),
                found[:qs.size].cpu().numpy())

    def range_device(self, lo: int, hi: int):
        """Device-resident range query [lo, hi) (paper 2.9): tensors
        ``(keys (max_range,), vals, count, truncated)``, rows KEY_EMPTY
        padded past ``count``."""
        return range_query(self.p, self.state, lo, hi)

    def range(self, lo: int, hi: int, return_truncated: bool = False):
        """Range query [lo, hi): newest-wins, deleted keys dropped,
        key-sorted, at most `max_range` results; with `return_truncated`
        also whether the result is only a prefix of the window."""
        k, v, c, trunc = self.range_device(lo, hi)
        c = int(c)
        out = k[:c].cpu().numpy(), v[:c].cpu().numpy()
        return out + (bool(trunc),) if return_truncated else out

    def range_many(self, ranges):
        """Batched scans ``[(lo, hi), ...)`` in one pass of the scan
        engine. Returns numpy ``(keys (Q, max_range), vals, counts (Q,),
        truncated (Q,))``."""
        return range_many_host(
            lambda los, his, n: range_many(self.p, self.state, los, his, n),
            self.p.max_range, ranges, self.device)

    def aggregate_many(self, ranges):
        """Batched windowed aggregates ``count(lo, hi)`` and ``sum(lo,
        hi)``. Returns numpy ``(counts (Q,), sums (Q,), truncated (Q,))``;
        sums use int32 wraparound."""
        q, los, his = pad_windows(ranges, self.device)
        if q == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, bool))
        c, s, t = aggregate_many(self.p, self.state, los, his, q)
        return (c[:q].cpu().numpy(), s[:q].cpu().numpy(),
                t[:q].cpu().numpy())

    def count(self, lo: int, hi: int) -> int:
        """Live-key count over [lo, hi)."""
        c, _, _ = self.aggregate_many([(lo, hi)])
        return int(c[0])

    def sum(self, lo: int, hi: int) -> int:
        """Sum of live values over [lo, hi) (int32 wraparound)."""
        _, s, _ = self.aggregate_many([(lo, hi)])
        return int(s[0])

    # -- stats ----------------------------------------------------------------
    @property
    def n_live(self) -> int:
        """Resident elements across stage + memory runs + disk levels
        (duplicates and delete records count until a merge drops them)."""
        n = int(self.state.stage_count) + int(self.state.buf_counts.sum())
        for lv in self.state.levels:
            n += int(lv.counts.sum())
        return n

    @property
    def n_levels(self) -> int:
        """Disk levels materialized so far (grown lazily up to
        `max_levels`)."""
        return len(self.state.levels)
