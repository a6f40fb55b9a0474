"""Host-side engine — the paper's insert/merge control flow (Algorithm 2).

`SLSM` owns the state (a NamedTuple of tensors on one device); *when*
maintenance runs is the `MergeScheduler`'s decision (`merge_budget` 0 =
the synchronous Do-Merge cascade, > 0 = paced steps, `drain()` the
barrier). The engine runs on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel slot runs its plain PyTorch
version, on the card its CUDA kernel.

With ``tuning.mode == "adaptive"`` the `Tuner` moves one byte budget
between the write buffer, the filters and the fence view as the mix
shifts (reference DESIGN.md §9): every state change runs at the active
allocation `p_active`, a decided switch is a scheduler RETUNE step, and
lookups leave out the structures that hold no run. `run_tape` executes a
coalesced window of mixed ops (`engine.tape`).

With ``durability=`` (a path or a `wal.Durability`) every write op is
logged before any state changes and group-committed before the call
returns; `snapshot` copies the state to the host, and `restore` rebuilds
an engine from a directory that either package wrote (`engine.wal`).
"""
from __future__ import annotations

import collections
import json
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.device import resolve_device
from repro_torch.engine import tape as TP
from repro_torch.engine import wal as WAL
from repro_torch.engine.batching import (ADAPTIVE_BUCKETS, adaptive_bucket,
                                         bucket_pow2, pad_to, pad_windows,
                                         range_many_host)
from repro_torch.engine.compaction import (CompactionPolicy, LevelingPolicy,
                                           TieringPolicy)
from repro_torch.engine.memtable import init_state, stage_append
from repro_torch.engine.read_path import (aggregate_many, host_occupancy,
                                          level_probe_stats, lookup_batch,
                                          lookup_many, range_many,
                                          range_query)
from repro_torch.engine.scheduler import MergeScheduler
from repro_torch.engine.tuner import (READ, ReadModePolicy, Tuner,
                                      retune_filters)

# width of the tuner's sampled probe-telemetry pass
PROBE_SAMPLE = 256

# WAL and snapshot fingerprints name compaction policies by kind, so
# restore() rebuilds the configured policy (the reference's names)
_POLICY_KINDS = {"tiering": TieringPolicy, "leveling": LevelingPolicy}


def _policy_kind(policy: CompactionPolicy) -> str:
    """Fingerprint name of a compaction policy (the inverse of the
    `_POLICY_KINDS` lookup restore() makes)."""
    for name, cls in _POLICY_KINDS.items():
        if type(policy) is cls:
            return name
    return type(policy).__name__.lower()


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
        self.device = resolve_device(device)
        self.policy = policy or TieringPolicy()
        self.policy.validate(self.p)
        self.state = init_state(self.p, self.device)
        # (run_count, n_runs a level) as the last scheduler step left it
        # (kept under adaptive tuning): lookups skip the empty structures
        # by it without a read of their own
        self.runs = (0, ())
        # the tuner's allocation applied to p (== p under static tuning)
        self.p_active = self.p
        self.tuner = Tuner(self)
        self._read_policy = ReadModePolicy()
        self.scheduler = MergeScheduler(self)
        self.stats = collections.Counter(seals=0, flushes=0, spills=0,
                                         compactions=0, backlog_peak=0,
                                         retunes=0, reads=0, writes=0,
                                         rows_merged_in=0, rows_merged_out=0,
                                         rows_annihilated=0,
                                         ghost_payload_bytes_skipped=0)
        # durability: None = volatile; _replaying stops re-logging while
        # restore() replays the WAL through this same write path
        self._replaying = False
        self.durability = WAL.as_durability(durability)
        if self.durability is not None:
            self.durability.ensure_header(self._wal_meta())
        # a replication Leader / Follower claims this (the serving layer
        # pumps it between windows); a deposed leader's writes raise
        # until promote()
        self.replication = None
        self.fenced = False

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    # -- write path -------------------------------------------------------
    def _guard_writes(self) -> None:
        """Reject writes into a read-only engine: a fenced (deposed)
        leader or a replica. Replay and `apply_replicated` pass (they
        run with ``_replaying`` set)."""
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
        """The weighted write path (delete() enters with weight -1). With
        durability, the whole call is one WAL record, logged before any
        state changes and synced once at the end."""
        if len(keys) > 0:
            self._guard_writes()
        log = (self.durability is not None and not self._replaying
               and len(keys) > 0)
        if log:
            self.durability.log_write(keys, vals, wts)
        self.stats["writes"] += len(keys)
        self.tuner.note_writes(len(keys))
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
            self.state = stage_append(self.p_active, self.state, chunk[0],
                                      chunk[1], chunk[2], n)
            self.scheduler.on_chunk()
        if log:
            self.durability.sync()

    def delete(self, keys) -> None:
        """Deletes are weight -1 records (paper 2.8); the pair annihilates
        when a merge creates the deepest data (paper 2.5)."""
        keys = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(keys, op="delete")
        self._insert(keys, np.zeros_like(keys), np.full_like(keys, -1))

    def drain(self) -> None:
        """Merge barrier: retire every pending maintenance step, a pending
        retune included."""
        self.scheduler.drain()

    def voluntary_steps(self, budget: int) -> int:
        """Roll the tuner's decision boundary, then run up to `budget`
        ready maintenance steps (a decided RETUNE rides the backlog like
        any merge) — the serving governor's entry point between windows.
        Returns how many steps ran."""
        self.tuner.decide()
        return self.scheduler.voluntary_steps(budget)

    def warm(self) -> None:
        """Build every kernel and launch each read op once at every
        preset's allocation (the configured one under static tuning), so
        no read — the first after a RETUNE included — pays a build. The
        answers are discarded."""
        if self.device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build_all()
        presets = ([a.apply(self.p) for a in self.tuner.presets.values()]
                   if self.tuner.enabled else [self.p])
        qs = self._tensor(np.full(ADAPTIVE_BUCKETS[0], KEY_EMPTY, np.int32))
        _, los, his = pad_windows([(0, 0)], self.device)
        for pa in presets:
            for sparse in (False, True):
                lookup_many(pa, self.state, qs, 0, sparse, self.tuner.enabled,
                            self.runs)
            range_many(pa, self.state, los, his, 0)
            aggregate_many(pa, self.state, los, his, 0)
            if self.tuner.enabled:
                level_probe_stats(pa, self.state, qs[:PROBE_SAMPLE])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- read path ----------------------------------------------------------
    def _on_reads(self, qs: np.ndarray) -> None:
        """Count the reads; under adaptive tuning also feed the tuner,
        keep the batch for write-boundary probe telemetry and roll the
        controller (a decision binds at the next write chunk)."""
        self.stats["reads"] += qs.size
        t = self.tuner
        if not t.enabled:
            return
        t.note_reads(qs.size)
        t.last_queries = qs[:PROBE_SAMPLE].copy()
        self.scheduler.on_read()

    def lookup(self, keys, sparse: bool = False):
        """Point lookups (paper 2.7): newest-to-oldest across stage, memory
        runs, then Bloom/fence-gated disk levels (`sparse`: the
        Bloom-compacted disk search). Returns numpy (vals, found)."""
        qs = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(qs, op="lookup")
        self._on_reads(qs)
        vals, found = lookup_batch(self.p_active, self.state,
                                   self._tensor(qs), sparse,
                                   self.tuner.enabled, self.runs)
        return vals.cpu().numpy(), found.cpu().numpy()

    def lookup_many(self, keys, sparse: bool = False):
        """Batched multi-key fast path: the queries padded to a bucket
        (`ADAPTIVE_BUCKETS` under adaptive tuning, else a power of two),
        one Bloom-probe launch over every disk level and, dense, one
        fence-search launch a level. Same results as `lookup`."""
        qs = np.asarray(keys, np.int32).reshape(-1)
        reject_reserved(qs, op="lookup_many")
        if qs.size == 0:
            return np.zeros(0, np.int32), np.zeros(0, bool)
        self._on_reads(qs)
        width = (adaptive_bucket(qs.size) if self.tuner.enabled
                 else bucket_pow2(qs.size))
        vals, found = lookup_many(self.p_active, self.state,
                                  self._tensor(pad_to(qs, width)), qs.size,
                                  sparse, self.tuner.enabled, self.runs)
        return (vals[:qs.size].cpu().numpy(),
                found[:qs.size].cpu().numpy())

    def range_device(self, lo: int, hi: int):
        """Device-resident range query [lo, hi) (paper 2.9): tensors
        ``(keys (max_range,), vals, count, truncated)``, rows KEY_EMPTY
        padded past ``count``."""
        return range_query(self.p_active, self.state, lo, hi)

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
            lambda los, his, n: range_many(self.p_active, self.state, los,
                                           his, n),
            self.p.max_range, ranges, self.device)

    def aggregate_many(self, ranges):
        """Batched windowed aggregates ``count(lo, hi)`` and ``sum(lo,
        hi)``. Returns numpy ``(counts (Q,), sums (Q,), truncated (Q,))``;
        sums use int32 wraparound."""
        q, los, his = pad_windows(ranges, self.device)
        if q == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, bool))
        c, s, t = aggregate_many(self.p_active, self.state, los, his, q)
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

    # -- mixed-op tape (engine.tape) ------------------------------------------
    def tape_write_capacity(self) -> int:
        """Max write keys the next `run_tape` segment may carry: its
        headroom pass must reserve one free run slot per seal the writes
        can force, and flushing only brings `run_count` down to
        ``run_count % runs_merged_eff``."""
        p = self.p_active
        rc, sc = int(self.state.run_count), int(self.state.stage_count)
        while sc >= p.Rn:       # ensure_stage_space() seals a full stage
            if rc >= p.R:
                rc -= p.runs_merged_eff
            rc += 1
            sc -= p.Rn
        free = p.R - rc % p.runs_merged_eff
        return (free + 1) * p.Rn - 1 - sc

    def run_tape(self, chunks, sparse: bool = False):
        """Execute a coalesced mixed-op window, in stream order.

        `chunks` is a sequence of `tape.TapeChunk`s (or ``(kind, keys,
        vals)`` tuples). Results are per chunk, in order: writes -> the
        seals the chunk made, lookups -> ``(vals, found)``, ranges ->
        ``(keys, vals, counts, truncated)``, numpy, trimmed to each
        chunk's op count and equal to what the per-op calls return.

        Before each tape segment the headroom pass runs
        (`scheduler.ensure_stage_space`, then `reserve_run_slots` for
        every seal the segment can make); a window whose writes exceed
        `tape_write_capacity` is cut into segments at write boundaries.
        Flush, spill, compact and retune stay host steps between tapes.
        """
        chunks = [c if isinstance(c, TP.TapeChunk) else TP.TapeChunk(*c)
                  for c in chunks]
        if not chunks:
            return []
        n_writes = n_reads = 0
        last_reads = None
        for ch in chunks:
            k = np.asarray(ch.keys, np.int32).reshape(-1)
            if ch.kind == "write":
                reject_reserved(k, op="tape write")
                n_writes += k.size
            elif ch.kind == "lookup":
                reject_reserved(k, op="tape lookup")
                n_reads += k.size
                last_reads = k
            elif ch.kind != "range":
                raise ValueError(f"unknown tape chunk kind {ch.kind!r}")
        if n_writes:
            self._guard_writes()
        # durability: one WAL record a write chunk, in stream order,
        # synced before this call returns (log-before-ack)
        log = self.durability is not None and not self._replaying
        if log:
            TP.log_write_chunks(self.durability, chunks)
        results = [0] * len(chunks)
        # stream-ordered (chunk index, chunk); an oversized write splits
        # across segments under one index
        work = list(enumerate(chunks))
        while work:
            self.scheduler.ensure_stage_space()
            seg, seg_idx = TP.take_segment(work, self.tape_write_capacity())
            seals = TP.tape_seal_bound(self.p_active,
                                       int(self.state.stage_count), seg)
            if seals:
                self.scheduler.reserve_run_slots(seals)
            ys = TP.exec_tape(self, *TP.build_tape(self.p_active, seg),
                              sparse)
            for i, res in zip(seg_idx, TP.unpack_tape(self.p_active, seg,
                                                      ys)):
                if chunks[i].kind == "write":
                    results[i] += res       # stats["seals"] booked per seal
                else:
                    results[i] = res
        self.stats["writes"] += n_writes
        self.stats["reads"] += n_reads
        self.tuner.note_writes(n_writes)
        self.tuner.note_reads(n_reads)
        if self.tuner.enabled and last_reads is not None:
            self.tuner.last_queries = last_reads[:PROBE_SAMPLE].copy()
        if log:
            self.durability.sync()
        return results

    def warm_tape(self) -> None:
        """`warm()`: a tape runs the engine's own read ops, so building
        the kernels and launching those ops once covers it."""
        self.warm()

    # -- tuner plumbing ----------------------------------------------------
    def sample_probe_stats(self) -> None:
        """One per-level probe-telemetry pass over the most recent read
        batch (`read_path.level_probe_stats`), called by the scheduler at
        a write-chunk boundary, folded into the tuner."""
        qs = self.tuner.last_queries
        if qs is None:
            return
        sample = np.full(PROBE_SAMPLE, KEY_EMPTY, np.int32)
        sample[:min(PROBE_SAMPLE, qs.size)] = qs[:PROBE_SAMPLE]
        c, h = level_probe_stats(self.p_active, self.state,
                                 self._tensor(sample))
        c, h = torch.stack([c, h]).cpu().numpy()
        self.tuner.note_probe_stats(c, h)

    @property
    def policy_active(self) -> CompactionPolicy:
        """The configured compaction policy, or the eager `ReadModePolicy`
        while the read allocation is active."""
        if self.tuner.enabled and self.tuner.active == READ:
            return self._read_policy
        return self.policy

    def apply_retune(self) -> None:
        """The device half of a RETUNE step: swap the active parameter set
        to the tuner's target allocation and rebuild every resident
        filter under it (`tuner.retune_filters`). With durability the
        switch is logged and synced, so a restored engine follows the
        same allocations (losing an unsynced one changes no answer)."""
        if self.durability is not None and not self._replaying:
            self.durability.log_retune(self.tuner.target)
        alloc = self.tuner.allocation(self.tuner.target)
        self.p_active = alloc.apply(self.p)
        self.state = retune_filters(self.p_active, self.state)
        self.tuner.applied()
        if self.durability is not None and not self._replaying:
            self.durability.sync()

    # -- durability (engine.wal) ---------------------------------------------
    def _wal_meta(self) -> dict:
        """Engine fingerprint for the WAL's META record, in the
        reference's form: enough to rebuild — and refuse to mix up —
        this configuration."""
        return {"driver": "slsm", "params": WAL.params_to_dict(self.p),
                "policy": _policy_kind(self.policy),
                "wal": WAL.WAL_FORMAT}

    def _snapshot_meta(self) -> dict:
        """Host state that rides a snapshot beside its leaves: the
        fingerprint, the number of disk levels, the tuner's position and
        the stats counters at the watermark."""
        return {**self._wal_meta(), "n_levels": self.n_levels,
                "tuner": {"active": self.tuner.active,
                          "read_frac": float(self.tuner.read_frac)},
                "stats": {k: int(v) for k, v in self.stats.items()}}

    def snapshot(self):
        """Copy the whole state to the host as one atomic snapshot stamped
        with the WAL's seqno watermark; restore() then replays only the
        records past it. Returns the published directory."""
        if self.durability is None:
            raise ValueError("snapshot() requires a durability layer: "
                             "construct with SLSM(..., durability=path)")
        return self.durability.snapshot(self)

    def _adopt_snapshot(self, leaves, meta: dict) -> None:
        """Install a snapshot's leaves as the state and adopt the tuner
        position and stats in `meta`. The leaves must form exactly
        ``meta["n_levels"]`` disk levels of this geometry (raises
        otherwise). Under adaptive tuning the run occupancy lookups skip
        by (`runs`) is read from the adopted state."""
        try:
            self.state = convert.state_from_leaves(
                self.p, leaves, self.device, int(meta["n_levels"]))
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
        if self.tuner.enabled:
            self.runs = host_occupancy(self.state)

    def _replay(self, records) -> None:
        """Re-apply WAL records through the engine's own write path
        (`_insert`, `apply_retune`) with logging off. Answer-exact, not
        bitwise-state-exact: maintenance may pace differently than in
        the crashed run, but reads are exact between steps."""
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
                            self.apply_retune()
                            self.stats["retunes"] += 1
                else:
                    continue
                n += 1
            self.stats["replayed_records"] += n
        finally:
            self._replaying = False

    @classmethod
    def restore(cls, path, params: SLSMParams | None = None,
                policy: CompactionPolicy | None = None, durability=None,
                device=None):
        """Recover an engine from a durability directory (written by the
        port or the reference): load the newest snapshot that verifies
        (none: replay from genesis), replay every WAL record past its
        watermark, and return the live engine on `device` (the card
        unless ``device="cpu"``; without a card this raises before the
        directory is touched). A torn final record is dropped whole.
        `params`/`policy` default to the recorded fingerprint. Wall time
        and replay size land in ``stats`` as ``restore_us`` and
        ``replayed_records``."""
        t0 = time.perf_counter()
        device = resolve_device(device)
        dur = WAL.as_durability(durability if durability is not None
                                else path)
        # decode the durable prefix before any writer truncates the tail
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
        if policy is None and meta is not None:
            policy = _POLICY_KINDS.get(meta.get("policy", "tiering"),
                                       TieringPolicy)()
        eng = cls(params, policy, device=device, durability=dur)
        watermark = -1
        if snap is not None:
            num, leaves, smeta = snap
            eng._adopt_snapshot(leaves, smeta)
            watermark = num
        eng._replay([r for r in records if r.seqno > watermark])
        eng.stats["restore_us"] += int((time.perf_counter() - t0) * 1e6)
        return eng

    @classmethod
    def open_replica(cls, path, *, fsync: bool = False, device=None):
        """Open a replication follower over a bootstrapped directory: a
        `restore` with a replica-mode durability layer, whose log is a
        verbatim copy of the leader's stream (no local META record is
        ever injected into it)."""
        return cls.restore(path, durability=WAL.Durability(
            path, fsync=fsync, replica=True), device=device)

    def apply_replicated(self, records) -> int:
        """Apply decoded leader WAL records through the replay path (the
        follower's durability layer appended the raw frames first).
        Returns the records applied."""
        before = self.stats["replayed_records"]
        self._replay(records)
        return self.stats["replayed_records"] - before

    def promote(self) -> "SLSM":
        """Failover: make this replica a writable leader. Bumps the WAL
        epoch (stale bytes of the earlier lineage a later crash may
        expose are then rejected) and re-enables local logging. Returns
        self."""
        if self.durability is None:
            raise ValueError("promote() requires a durability layer")
        self.durability.writer.bump_epoch()
        self.durability.replica = False
        self.fenced = False
        self.stats["promotions"] += 1
        return self

    def demote(self) -> "SLSM":
        """Fence this engine against writes (a deposed leader): reads stay
        served, every write raises until a later `promote()`. Returns
        self."""
        self.fenced = True
        self.stats["demotions"] += 1
        return self

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
