"""The continuous-batching server: windows, the governor, and accounting
(port of `repro.serve.server`).

`Server` fronts one engine (`SLSM` or `ShardedSLSM`) with a
submit/pump loop:

  * `submit` enqueues one per-client tagged request (insert / delete /
    lookup / range) and returns its `Ticket` immediately;
  * `pump` closes the current coalescing window when the adaptive
    time/size policy says so (or on `force`), folds the window into
    hazard-ordered tape chunks (`repro_torch.serve.coalescer`), executes
    them as one dispatch (`SLSM.run_tape` — the mixed-op tape),
    scatters results onto the tickets, and lets the
    maintenance governor spend its accumulated merge budget;
  * `drain` is the barrier: every pending request served, every pending
    maintenance step retired.

A window reads the device per tape, not per request: a tape's slot
results stay on the engine's device and come to the host in one
blocking device-to-host read a tape segment (`warm` builds the kernels and runs
each read op once, so no window pays a build). The ``per_request`` mode
is the measured baseline: the same submit/pump loop, but every request
dispatched through the classic per-op engine calls, each read paying its
own device-to-host read.

Per-client latency accounting rides the tickets: every reply stamps
enqueue->reply seconds into the server's client ledgers, and `stats()`
folds them into p50/p99/p999/max-stall percentiles per client and
overall.

Replication roles: ``role="leader"`` (default) serves the full op set
with read-your-writes (log-before-ack is the window boundary's group
commit, and replication ships only durable bytes); ``role="follower"``
fronts a replica engine — write submits are rejected at intake, reads
serve the eventually-consistent applied watermark. Either way, when the
engine carries a ``repro_torch.engine.replication`` endpoint
(``tree.replication``), the pump drives it between windows and in idle
gaps: shipping on a leader, applying on a follower.

Self-healing rides the same seams: ``role`` is live —
a follower that auto-promoted on lease expiry starts accepting writes,
a fenced (deposed) leader stops; a quorum-mode leader holds each
window's write acks until k followers confirm the bytes
(`_pump_replication` releases them against ``quorum_seqno()``); and
idle gaps run watermark-bounded WAL pruning next to snapshots. A held
write never hangs forever: if the leader is deposed, the quorum stays
unreachable past ``quorum_timeout_s``, or `drain` exhausts its bounded
release attempts, the held tickets fail with a typed `QuorumAckError`
instead of leaving clients awaiting a future that never resolves.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.engine.engine import reject_reserved
from repro_torch.engine.replication import Leader as _RepLeader
from repro_torch.serve.coalescer import OP_OF, coalesce, scatter

KINDS = ("insert", "delete", "lookup", "range")


class QuorumAckError(RuntimeError):
    """A quorum-held write ticket cannot be client-acked: the leader
    was deposed before k followers confirmed the bytes, or the quorum
    stayed unreachable past the server's ``quorum_timeout_s``. The
    write executed and is locally durable — its fate is decided by
    whether the stream reached the successor — but the client was
    never acked, which is exactly the §14/§15 contract: an un-acked
    write may or may not survive failover; an acked one always does."""


class Ticket:
    """One submitted request: identity, payload, timing, and (after its
    window executes) the result.

    ``result`` is None for insert/delete, ``(vals, found)`` for lookup,
    ``(keys, vals, counts, truncated)`` for range — the driver-call
    shapes. ``done`` flips when the reply is stamped; ``latency_s`` is
    the enqueue->reply interval the server's accounting is built on.
    ``error`` is None on success; a quorum-held write whose ack became
    impossible carries the `QuorumAckError` here (and raises it from
    the asyncio future when the front-end attached one).
    """

    __slots__ = ("client", "kind", "keys", "vals", "t_enqueue", "t_reply",
                 "result", "future", "error")

    def __init__(self, client: str, kind: str, keys: np.ndarray,
                 vals: np.ndarray, t_enqueue: float):
        self.client = client
        self.kind = kind
        self.keys = keys
        self.vals = vals
        self.t_enqueue = t_enqueue
        self.t_reply: Optional[float] = None
        self.result: Any = None
        self.future: Any = None   # set by the asyncio front-end
        self.error: Optional[Exception] = None

    @property
    def done(self) -> bool:
        """True once the window holding this request has executed."""
        return self.t_reply is not None

    @property
    def latency_s(self) -> float:
        """Enqueue->reply seconds (raises if not yet served)."""
        if self.t_reply is None:
            raise RuntimeError("ticket not served yet")
        return self.t_reply - self.t_enqueue

    @property
    def n_ops(self) -> int:
        """Ops this request carries (keys, queries, or scan windows)."""
        return int(self.keys.size)


@dataclass
class WindowPolicy:
    """Adaptive time/size coalescing window.

    A window closes when either trigger fires: ``max_ops`` pending ops
    (size — the tape bucket grid is full enough to be worth a dispatch)
    or the oldest pending request aging past the adaptive deadline
    ``wait_s`` (time — latency floor under light load). The deadline
    adapts between ``min_wait_s`` and ``max_wait_s`` on every close:
    windows that fill on size push it up (heavier batching is free when
    load is high — requests were not waiting on the clock), windows
    that close by timeout while thin pull it down (waiting longer would
    only add latency, not batch size). ``adapt`` is the multiplicative
    step; ``fill_target`` the occupancy that leaves the deadline alone.
    """

    max_ops: int = 512
    min_wait_s: float = 1e-4
    max_wait_s: float = 5e-3
    adapt: float = 0.25
    fill_target: float = 0.5
    wait_s: float = field(default=1e-3)

    def should_close(self, pending_ops: int, oldest_age_s: float) -> bool:
        """Fire on either trigger: size (pending ops) or time (age of
        the oldest pending request vs the adaptive deadline)."""
        if pending_ops <= 0:
            return False
        return pending_ops >= self.max_ops or oldest_age_s >= self.wait_s

    def closed(self, pending_ops: int) -> None:
        """Adapt the deadline after a close at `pending_ops` occupancy
        (see class docstring for the direction of the adjustment)."""
        fill = pending_ops / max(self.max_ops, 1)
        self.wait_s *= 1.0 + self.adapt * np.clip(
            fill - self.fill_target, -1.0, 1.0)
        self.wait_s = float(np.clip(self.wait_s, self.min_wait_s,
                                    self.max_wait_s))


@dataclass
class Governor:
    """Maintenance governor: merge budget spent at window boundaries
    and in idle gaps instead of per insert chunk.

    The mixed-op tape seals in-scan but defers every other maintenance
    step (flush/spill/compact/RETUNE) to the host. The governor accrues
    the same budget the per-chunk scheduler would have granted —
    ``merge_budget`` steps per Rn write ops — and spends it through the
    drivers' uniform `voluntary_steps` after each window, where no
    request is waiting on the device. Idle pumps (nothing pending)
    additionally spend ``idle_steps`` for free: an idle gap is exactly
    when background work is invisible to clients. ``credit_cap`` bounds
    banked credits so a long write burst cannot bankroll an unbounded
    maintenance storm later.

    Idle gaps are also where durability snapshots land: when the served
    engine has a durability layer whose WAL has grown past its snapshot
    threshold (`wal.Durability.should_snapshot`), an idle pump
    copies the device state to the host — snapshot cost rides
    the same no-client-is-waiting window as background merges, so the
    log-before-ack write path never absorbs a multi-ms snapshot stall.

    On a segmented WAL (`Durability(segment_bytes=...)`) idle gaps also
    run watermark-bounded pruning: a replicating leader
    prunes through `Leader.prune()` (which additionally floors at every
    attached follower's ack), a standalone engine through
    `Durability.prune(prune_floor())` — either way sealed segments the
    newest snapshot no longer needs are deleted, bounding log growth
    without ever touching bytes a bootstrap or replay could still want.
    """

    idle_steps: int = 1
    credit_cap: float = 16.0
    credits: float = 0.0
    steps_run: int = 0
    idle_steps_run: int = 0
    snapshots_run: int = 0
    prunes_run: int = 0
    pruned_segments: int = 0

    def window_done(self, tree, write_ops: int) -> int:
        """Accrue credit for the window's writes and spend whole steps
        (tree.voluntary_steps); returns how many ran."""
        p = tree.p_active
        self.credits = min(self.credit_cap,
                           self.credits
                           + p.merge_budget * write_ops / max(p.Rn, 1))
        budget = int(self.credits)
        if budget <= 0:
            return 0
        ran = tree.voluntary_steps(budget)
        self.credits -= ran
        self.steps_run += ran
        return ran

    def idle(self, tree) -> int:
        """Spend the idle allowance (an empty pump): background steps no
        client can observe, plus a due durability snapshot — the WAL has
        outgrown its threshold and nobody is waiting on the device.
        Returns how many maintenance steps ran."""
        dur = getattr(tree, "durability", None)
        if dur is not None and dur.should_snapshot():
            tree.snapshot()
            self.snapshots_run += 1
        if dur is not None and dur.segment_bytes is not None:
            rep = getattr(tree, "replication", None)
            if isinstance(rep, _RepLeader):
                dropped = rep.prune()
            else:
                dropped = dur.prune(dur.prune_floor())
            if dropped:
                self.prunes_run += 1
                self.pruned_segments += dropped
        if self.idle_steps <= 0:
            return 0
        ran = tree.voluntary_steps(self.idle_steps)
        self.idle_steps_run += ran
        self.steps_run += ran
        return ran


def _percentiles(lat_s: List[float]) -> Dict[str, float]:
    """Latency ledger -> the phase-style percentile block (µs)."""
    ts = np.asarray(lat_s, np.float64) * 1e6
    return {"n": int(ts.size),
            "p50_us": float(np.percentile(ts, 50)),
            "p99_us": float(np.percentile(ts, 99)),
            "p999_us": float(np.percentile(ts, 99.9)),
            "max_stall_us": float(ts.max())}


class Server:
    """Continuous-batching front-end over one engine (see module doc).

    ``mode`` selects the dispatch strategy the pump uses:
    ``"coalesced"`` (default) folds each window into mixed-op tapes;
    ``"per_request"`` serves each request with its own classic driver
    call (`insert`/`delete`/`lookup_many`/`range_many`) — the baseline
    the tape is measured against. Both modes share the
    submit/window/accounting machinery, so their latency numbers are
    directly comparable.

    ``role`` selects the replication stance (module docstring):
    ``"leader"`` accepts everything, ``"follower"`` rejects write
    submits (the stream is the only writer of a replica).
    """

    def __init__(self, tree, *, window: WindowPolicy | None = None,
                 governor: Governor | None = None, mode: str = "coalesced",
                 role: str = "leader", quorum_timeout_s: float = 30.0,
                 clock=time.perf_counter):
        if mode not in ("coalesced", "per_request"):
            raise ValueError(f"unknown serve mode {mode!r}")
        if role not in ("leader", "follower"):
            raise ValueError(f"unknown serve role {role!r}")
        self.role = role
        self.tree = tree
        self.window = window or WindowPolicy()
        self.governor = governor or Governor()
        self.mode = mode
        self.quorum_timeout_s = float(quorum_timeout_s)
        self.clock = clock
        self._pending: List[Ticket] = []
        self._pending_ops = 0
        # quorum ack mode: windows whose write tickets are executed and
        # durable but not yet client-acked —
        # [(commit watermark, tickets, hold time)]
        self._unacked: List[tuple] = []
        self._lat: Dict[str, List[float]] = collections.defaultdict(list)
        self.counters = collections.Counter(
            requests=0, ops=0, windows=0, dispatches=0,
            write_ops=0, read_ops=0, range_ops=0,
            promotions=0, demotions=0, quorum_held=0, quorum_releases=0,
            quorum_failed=0)

    # -- role tracking ------------------------------------------------------
    def _sync_role(self) -> None:
        """Track self-healing role transitions: a
        follower whose engine auto-promoted (its ``replication``
        endpoint became a `Leader`) starts accepting writes; a leader
        whose engine was fenced (deposed by a successor's epoch, or
        still a replica) stops. The submit gate reads ``self.role``,
        so the flip is what turns intake-level write rejection on/off."""
        rep = getattr(self.tree, "replication", None)
        if self.role == "follower":
            lead = rep if isinstance(rep, _RepLeader) else getattr(
                rep, "new_leader", None)
            # a deposed leader endpoint on a fenced engine is NOT a
            # promotion — it's the before-state of a demoted node
            if (isinstance(lead, _RepLeader) and not lead.deposed
                    and not getattr(self.tree, "fenced", False)):
                self.role = "leader"
                self.counters["promotions"] += 1
        elif self.role == "leader":
            dur = getattr(self.tree, "durability", None)
            if getattr(self.tree, "fenced", False) or (
                    dur is not None and dur.replica):
                self.role = "follower"
                self.counters["demotions"] += 1

    # -- intake -------------------------------------------------------------
    def submit(self, client: str, kind: str, keys, vals=None) -> Ticket:
        """Enqueue one tagged request; returns its `Ticket` immediately.

        ``kind``: ``insert`` (keys+vals), ``delete`` (keys), ``lookup``
        (keys), or ``range`` (keys = lo bounds, vals = hi bounds, one
        scan window per lane). Reserved-sentinel validation happens
        here, at the submitting client's call site, so a bad request
        fails fast instead of poisoning a whole window.
        """
        if kind not in KINDS:
            raise ValueError(f"unknown request kind {kind!r}; "
                             f"options: {KINDS}")
        self._sync_role()
        if self.role == "follower" and kind in ("insert", "delete"):
            raise ValueError(
                f"follower is read-only: {kind!r} must go to the leader "
                "(the replication stream is a replica's only writer)")
        keys = np.asarray(keys, np.int32).reshape(-1)
        if kind == "insert":
            vals = np.asarray(vals, np.int32).reshape(-1)
            if keys.shape != vals.shape:
                raise ValueError("insert: keys and vals must match")
            reject_reserved(keys, vals, op="serve insert")
        elif kind == "delete":
            vals = np.zeros_like(keys)
            reject_reserved(keys, op="serve delete")
        elif kind == "lookup":
            vals = np.zeros_like(keys)
            reject_reserved(keys, op="serve lookup")
        else:  # range
            vals = np.asarray(vals, np.int32).reshape(-1)
            if keys.shape != vals.shape:
                raise ValueError("range: lo and hi bounds must match")
        t = Ticket(client, kind, keys, vals, self.clock())
        self._pending.append(t)
        self._pending_ops += t.n_ops
        self.counters["requests"] += 1
        self.counters["ops"] += t.n_ops
        key = {"insert": "write_ops", "delete": "write_ops",
               "lookup": "read_ops", "range": "range_ops"}[kind]
        self.counters[key] += t.n_ops
        return t

    @property
    def pending(self) -> int:
        """Requests currently waiting for a window."""
        return len(self._pending)

    def poll(self) -> bool:
        """Would `pump()` fire a window right now? (per_request mode
        dispatches whenever anything pends — there is no window)."""
        if not self._pending:
            return False
        if self.mode == "per_request":
            return True
        age = self.clock() - self._pending[0].t_enqueue
        return self.window.should_close(self._pending_ops, age)

    # -- the pump -----------------------------------------------------------
    def pump(self, force: bool = False) -> int:
        """Serve one window if due (or `force`d); returns requests served.

        An empty pump is an idle gap: the governor spends its idle
        allowance there and 0 is returned. After a served window the
        governor spends the window's accrued merge budget — both happen
        strictly *between* device dispatches, so maintenance never rides
        inside a request's tape. Replication (when the
        engine carries an endpoint) is pumped in the same seams: after
        each window and in every idle gap — shipping durable frames on
        a leader, applying received ones on a follower — so it never
        rides inside a request's dispatch either.

        Under quorum acks (``Leader(ack_mode="quorum")``) a window's
        *write* tickets are executed and locally
        durable here but not client-acked: they are held on
        ``_unacked`` tagged with the window's commit watermark (the
        leader's durable seqno after the group commit) and released by
        `_pump_replication` once ``quorum_seqno()`` clears it — so a
        client-visible ack always means k followers hold the bytes and
        failover loses nothing (RPO 0). Reads reply immediately.
        """
        self._sync_role()
        if not self._pending:
            self.governor.idle(self.tree)
            self._pump_replication()
            return 0
        if not (force or self.poll()):
            return 0
        batch, self._pending = self._pending, []
        batch_ops, self._pending_ops = self._pending_ops, 0
        if self.mode == "coalesced":
            chunks, placements = coalesce(self.tree.p_active, batch)
            results = self.tree.run_tape(chunks)
            scatter(batch, placements, results)
            self.counters["dispatches"] += 1
        else:
            self._serve_per_request(batch)
        write_ops = sum(t.n_ops for t in batch if OP_OF[t.kind] == "write")
        release = batch
        rep = getattr(self.tree, "replication", None)
        if (isinstance(rep, _RepLeader) and rep.ack_mode == "quorum"
                and write_ops):
            held = [t for t in batch if OP_OF[t.kind] == "write"]
            release = [t for t in batch if OP_OF[t.kind] != "write"]
            watermark = int(self.tree.durability.writer.last_seqno)
            self._unacked.append((watermark, held, self.clock()))
            self.counters["quorum_held"] += len(held)
        self._reply(release)
        self.counters["windows"] += 1
        self.window.closed(batch_ops)
        self.governor.window_done(self.tree, write_ops)
        self._pump_replication()
        return len(batch)

    def _reply(self, tickets: List[Ticket]) -> None:
        """Stamp replies: reply time, the client latency ledger, and
        the asyncio future (when the front-end attached one)."""
        if not tickets:
            return
        t_reply = self.clock()
        for t in tickets:
            t.t_reply = t_reply
            self._lat[t.client].append(t_reply - t.t_enqueue)
            if t.future is not None and not t.future.done():
                t.future.set_result(t.result)

    def _fail(self, tickets: List[Ticket], msg: str) -> None:
        """Fail held tickets with a typed `QuorumAckError`: stamp the
        reply time (so `done` flips and nothing re-holds them), attach
        the error, and reject the asyncio future when one is attached —
        an awaiting client raises instead of hanging forever. Failed
        tickets stay out of the latency ledgers (they measure served
        requests)."""
        t_reply = self.clock()
        err = QuorumAckError(msg)
        for t in tickets:
            t.t_reply = t_reply
            t.error = err
            if t.future is not None and not t.future.done():
                t.future.set_exception(err)
        self.counters["quorum_failed"] += len(tickets)

    def _pump_replication(self) -> None:
        """Drive the engine's replication endpoint (no-op when absent):
        a leader ships the window's now-durable frames, a follower
        applies whatever the stream delivered. On a quorum leader, then
        release every held window whose commit watermark the quorum
        ack has cleared (in window order — acks are monotone, so a
        cleared later window implies every earlier one). Held windows
        never hang forever: deposition (the endpoint is gone, fenced,
        or demoted) fails them all immediately — the successor decides
        those writes' fate now, this node can never learn it — and a
        window still unreleased ``quorum_timeout_s`` after its hold
        fails with a quorum-unreachable error."""
        rep = getattr(self.tree, "replication", None)
        if rep is not None:
            rep.pump()
        if not self._unacked:
            return
        if (not isinstance(rep, _RepLeader) or rep.deposed
                or getattr(self.tree, "fenced", False)):
            held, self._unacked = self._unacked, []
            for _, tickets, _ in held:
                self._fail(tickets,
                           "leader deposed before quorum ack: the write "
                           "executed locally but was never client-acked; "
                           "whether it survived rides on the successor's "
                           "applied stream")
            return
        q = rep.quorum_seqno()
        while self._unacked and self._unacked[0][0] <= q:
            _, held, _ = self._unacked.pop(0)
            self._reply(held)
            self.counters["quorum_releases"] += len(held)
        now = self.clock()
        expired = [w for w in self._unacked
                   if now - w[2] > self.quorum_timeout_s]
        if expired:
            self._unacked = [w for w in self._unacked
                             if now - w[2] <= self.quorum_timeout_s]
            for _, tickets, _ in expired:
                self._fail(tickets,
                           f"quorum not reached within "
                           f"{self.quorum_timeout_s:.1f}s "
                           "(quorum loss or unpumped followers): the "
                           "write executed locally but was never "
                           "client-acked")

    def _serve_per_request(self, batch: List[Ticket]) -> None:
        """Baseline dispatch: one classic driver call per request, in
        stream order — the per-op host/device ping-pong the tape
        replaces (each read pays its own device->host sync)."""
        tree = self.tree
        for t in batch:
            if t.kind == "insert":
                tree.insert(t.keys, t.vals)
            elif t.kind == "delete":
                tree.delete(t.keys)
            elif t.kind == "lookup":
                t.result = tree.lookup_many(t.keys)
            else:
                t.result = tree.range_many(
                    np.stack([t.keys, t.vals], axis=1))
            self.counters["dispatches"] += 1

    # -- barriers / warm-up ---------------------------------------------------
    def drain(self) -> None:
        """Serve everything pending, then retire the engine's whole
        maintenance backlog (the read-equivalence barrier — after this,
        the tree answers exactly as a sequential per-op engine fed the
        same stream). Held quorum windows get a bounded release
        attempt — acks can only arrive if the followers are being
        pumped elsewhere — and whatever is still held afterwards fails
        with `QuorumAckError`: past the barrier no pump will ever run
        again, so leaving the tickets pending would strand their
        awaiting clients forever."""
        while self._pending:
            self.pump(force=True)
        for _ in range(64):
            if not self._unacked:
                break
            self._pump_replication()
        if self._unacked:
            held, self._unacked = self._unacked, []
            for _, tickets, _ in held:
                self._fail(tickets,
                           "quorum unreachable at drain: no further pump "
                           "will run; the write executed locally but was "
                           "never client-acked")
        self.tree.drain()

    def warm(self, full: bool = True) -> None:
        """Build the kernels and run each read op once, so no window pays
        a build: the tape's own read ops (`warm_tape`) and — with `full`
        — the engine's whole read set (`warm`, which covers the tape: a
        tape runs the engine's own ops)."""
        if full:
            self.tree.warm()
        elif self.mode == "coalesced":
            self.tree.warm_tape()

    # -- accounting -----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Serving telemetry: per-client and overall enqueue->reply
        latency percentiles (p50/p99/p999/max stall, µs), the window /
        dispatch / op counters, the governor's spend (including idle-gap
        snapshots), the window policy's current adaptive deadline, and —
        when the served engine is durable — the durability block (WAL
        bytes/records/syncs, snapshots, last snapshot ms). A restored
        engine's ``engine`` block carries its ``restore_us`` /
        ``replayed_records``, so recovery stall time is first-class
        telemetry. With replication attached, the ``replication`` block
        carries the endpoint's stats — on a leader that includes
        ``follower_lag_records`` / ``follower_lag_bytes``. ``role`` is
        live (it flips with auto-promotion / fencing, §15), and the
        quorum hold queue is visible as ``unacked_windows`` /
        ``unacked_writes``."""
        self._sync_role()
        overall: List[float] = []
        clients = {}
        for c, lat in sorted(self._lat.items()):
            clients[c] = _percentiles(lat)
            overall.extend(lat)
        dur = getattr(self.tree, "durability", None)
        rep = getattr(self.tree, "replication", None)
        return {
            "role": self.role,
            "clients": clients,
            "overall": _percentiles(overall) if overall else None,
            "counters": dict(self.counters),
            "governor": {"steps": self.governor.steps_run,
                         "idle_steps": self.governor.idle_steps_run,
                         "snapshots": self.governor.snapshots_run,
                         "prunes": self.governor.prunes_run,
                         "pruned_segments": self.governor.pruned_segments,
                         "credits": self.governor.credits},
            "unacked_windows": len(self._unacked),
            "unacked_writes": sum(len(h) for _, h, _ in self._unacked),
            "window": {"wait_s": self.window.wait_s,
                       "max_ops": self.window.max_ops},
            "engine": {k: int(v) for k, v in self.tree.stats.items()},
            "durability": dur.stats() if dur is not None else None,
            "replication": rep.stats() if rep is not None else None,
        }
