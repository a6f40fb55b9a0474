"""Single-leader replication over the WAL (port of
`repro.engine.replication`; reference DESIGN.md §14–§15).

The durability layer's WAL (`engine.wal`) is already a replication log:
CRC-framed records with consecutive seqnos, a snapshot codec with a seqno
watermark, and replay through the engine's own write path. This module
ships that stream, on the reference's wire, byte for byte — the same
message and ack structs, type codes and heartbeat keys, frames shipped
verbatim — so reference and port nodes can serve in one fleet:

  * the **leader** is any durable engine (`SLSM` / `ShardedSLSM`): a
    `Leader` wraps it, `bootstrap` copies its newest snapshot + WAL tail
    into a follower directory (the initial sync), and `ship` tails the
    leader's *durable* log bytes (`wal.WalTailer`) and sends each frame
    verbatim over a pluggable transport;
  * a **follower** opens that directory through ``open_replica`` (a
    `restore` under a replica-mode durability layer) on its device — the
    CUDA card unless ``device="cpu"`` — then `apply`s incoming frames:
    validate (`wal.check_frame`), drop duplicates and reorder by seqno in
    a *bounded* buffer, append verbatim (`Durability.append_frame`: the
    follower's WAL stays a bitwise copy of the leader's stream), sync,
    replay through `apply_replicated` (so through the engine's kernels),
    and ack;
  * transports are an in-process `QueueLink` (tests inject faults by
    mutating its deques) and a localhost socket pair (`SocketListener` /
    `connect` → `SocketEnd`, length-prefixed messages whose torn tails
    drop with the connection); both raise a typed `TransportError` on a
    severed link, and connect/accept retry with exponential backoff and
    jitter up to a deadline.

Self-healing closes the failover loop:

  * **leases** — the leader stamps heartbeat control messages into the
    ship stream (`T_CTRL`, never a logged WAL record): its epoch, durable
    watermark, the lease duration, ack mode/quorum, and the ack roster. A
    follower holds a lease on a *monotonic clock* from each heartbeat;
    when it expires, the successor rule — highest *rostered* ack, lowest
    follower id on ties, over the last roster ONLY — elects exactly one
    follower among those sharing a roster, which `promote(lead=True)`s.
    Losers re-arm a *fallback* lease: each further expiry with no
    heartbeat peels one rank off the succession order.
  * **epoch fencing** — acks carry the acker's WAL epoch. A promoted
    successor keeps its old transport end as a *fence end*: any frame the
    deposed leader still ships is answered with an ack at the bumped
    epoch. The deposed leader sees ``ack.epoch > own epoch``, fences its
    engine against writes (``drv.fenced``) and rejoins by a fresh
    `bootstrap` from the new leader.
  * **quorum acks** — ``Leader(ack_mode="quorum", quorum=k)`` exposes
    `quorum_seqno()`, the k-th highest *advertised* live follower ack
    (the values the last heartbeat roster carried; an eager heartbeat
    fires whenever fresh acks would advance it). The serving layer holds
    client write acks until that watermark clears them, which makes the
    roster-only successor rule zero-RPO.
  * **watermark-bounded pruning** — `Leader.prune()` truncates sealed WAL
    segments below min(newest snapshot watermark, minimum ack over
    attached followers — dead ones included within ``dead_grace_s``), so
    `bootstrap` of any attached follower finds its tail; a handle dead
    past the grace is detached so it cannot pin disk growth forever.

Consistency: read-your-writes on the leader (replication ships only
*durable* bytes, so nothing a follower applies can be un-acked on the
leader; in quorum mode client acks wait for k follower confirmations);
followers are eventually consistent at their applied watermark. Lag is
observable: `Leader.stats()` reports ``follower_lag_records`` /
``follower_lag_bytes`` from follower acks. Leases are cooperative failure
detection, not consensus: a partially delivered roster update can still
elect divergent winners.
"""
from __future__ import annotations

import collections
import json
import random
import select
import shutil
import socket
import struct
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.device import resolve_device
from repro_torch.engine import wal as WAL
from repro_torch.engine.engine import SLSM
from repro_torch.engine.sharded import ShardedSLSM

# stream message framing (byte-stream transports): type u8 | len u32 | payload
_MSG = struct.Struct("<BI")
# applied seqno i64 | applied bytes u64 | gap u8 | acker's WAL epoch u8
_ACK = struct.Struct("<qQBB")
T_FRAME = 1                         # payload = one verbatim WAL frame
T_ACK = 2                           # payload = _ACK
T_CTRL = 3                          # payload = json heartbeat/lease message


class TransportError(ConnectionError):
    """A replication transport failed: the peer is gone, the link was
    severed, or a dial/accept deadline expired. Subclasses
    `ConnectionError` so pre-existing ``except OSError`` paths keep
    working; the leader's `ship` converts it into detach (and later
    `reattach`) instead of letting it escape a pump."""


class Cursor(NamedTuple):
    """A shipping position in the leader's WAL: byte `offset` (the
    leader-log bytes already covered at bootstrap — lag-bytes
    accounting only; shipping itself is seqno-addressed), the
    `next_seqno` expected (None = accept any first record), and the
    minimum `epoch` of subsequent frames."""

    offset: int
    next_seqno: Optional[int]
    epoch: int = 0


# --------------------------------------------------------------------------
# transports
# --------------------------------------------------------------------------

class QueueEnd:
    """One end of a `QueueLink`. The leader end uses
    `send_frames`/`send_ctrl`/`recv_acks`; the follower end
    `recv_frames`/`recv_ctrl`/`send_ack`. Setting ``closed`` simulates
    a severed link (sends raise `TransportError`, receives return
    nothing) — the partition fault tests flip it directly."""

    def __init__(self, link: "QueueLink", is_leader: bool):
        self.link = link
        self.is_leader = is_leader
        self.closed = False

    def _check_open(self) -> None:
        if self.closed:
            raise TransportError("replication link closed")

    def send_frames(self, frames: List[bytes]) -> None:
        """Enqueue raw WAL frames toward the follower."""
        self._check_open()
        self.link.frames.extend(frames)

    def recv_frames(self) -> List[bytes]:
        """Drain every in-flight frame (empty when closed)."""
        if self.closed:
            return []
        out = list(self.link.frames)
        self.link.frames.clear()
        return out

    def send_ack(self, seqno: int, nbytes: int, gap: bool = False,
                 epoch: int = 0) -> None:
        """Enqueue one follower ack toward the leader."""
        self._check_open()
        self.link.acks.append((seqno, nbytes, gap, epoch))

    def recv_acks(self) -> List[Tuple[int, int, bool, int]]:
        """Drain every in-flight ``(applied_seqno, applied_bytes, gap,
        epoch)`` (legacy 3-tuples injected by tests decode as epoch
        0)."""
        if self.closed:
            return []
        out = [tuple(a) + (0,) * (4 - len(a)) for a in self.link.acks]
        self.link.acks.clear()
        return out

    def send_ctrl(self, msg: Dict[str, Any]) -> None:
        """Enqueue one heartbeat/lease control message (leader →
        follower; never a logged WAL record)."""
        self._check_open()
        self.link.ctrl.append(dict(msg))

    def recv_ctrl(self) -> List[Dict[str, Any]]:
        """Drain every in-flight control message."""
        if self.closed:
            return []
        out = list(self.link.ctrl)
        self.link.ctrl.clear()
        return out

    def close(self) -> None:
        """Sever this end of the link."""
        self.closed = True


class QueueLink:
    """In-process transport: a leader end and a follower end over three
    deques. The wire is inspectable — ``frames`` holds raw frame bytes
    heading to the follower, ``acks`` the ack tuples heading back,
    ``ctrl`` the heartbeat messages — so fault tests duplicate,
    reorder, drop, or bit-flip in-flight traffic by mutating the
    deques between pumps."""

    def __init__(self):
        self.frames: collections.deque = collections.deque()
        self.acks: collections.deque = collections.deque()
        self.ctrl: collections.deque = collections.deque()
        self.leader = QueueEnd(self, is_leader=True)
        self.follower = QueueEnd(self, is_leader=False)


class SocketEnd:
    """One end of a localhost replication stream.

    Messages are length-prefixed (``type u8 | len u32 | payload``); a
    partially received message — the torn stream tail a dying peer
    leaves — stays buffered and is dropped with the connection, the
    transport-level mirror of the WAL's torn-tail rule. Receives are
    non-blocking (`select`-gated drains) into per-type inboxes, so
    draining frames never discards a control message that arrived in
    the same burst; sends are blocking and raise `TransportError` on a
    dead peer."""

    def __init__(self, sock: socket.socket):
        sock.setblocking(True)
        self.sock = sock
        self.closed = False
        self._buf = b""
        self._in: Dict[int, List[bytes]] = {T_FRAME: [], T_ACK: [],
                                            T_CTRL: []}

    def _pump(self) -> None:
        while not self.closed:
            try:
                r, _, _ = select.select([self.sock], [], [], 0)
            except (OSError, ValueError):
                self.closed = True
                return
            if not r:
                return
            try:
                data = self.sock.recv(1 << 16)
            except OSError:
                data = b""
            if not data:
                self.closed = True
                return
            self._buf += data

    def _drain(self) -> None:
        self._pump()
        off = 0
        while off + _MSG.size <= len(self._buf):
            t, n = _MSG.unpack_from(self._buf, off)
            if off + _MSG.size + n > len(self._buf):
                break                   # torn tail: stays pending
            if t in self._in:
                self._in[t].append(self._buf[off + _MSG.size:
                                             off + _MSG.size + n])
            off += _MSG.size + n
        self._buf = self._buf[off:]

    def _take(self, t: int) -> List[bytes]:
        self._drain()
        out, self._in[t] = self._in[t], []
        return out

    def send_frames(self, frames: List[bytes]) -> None:
        """Send raw WAL frames, one message each, in one write."""
        self._send(b"".join(_MSG.pack(T_FRAME, len(f)) + f for f in frames))

    def send_ack(self, seqno: int, nbytes: int, gap: bool = False,
                 epoch: int = 0) -> None:
        """Send one ``(applied_seqno, applied_bytes, gap, epoch)`` ack."""
        self._send(_MSG.pack(T_ACK, _ACK.size)
                   + _ACK.pack(seqno, nbytes, 1 if gap else 0, epoch & 0xFF))

    def send_ctrl(self, msg: Dict[str, Any]) -> None:
        """Send one json heartbeat/lease control message."""
        blob = json.dumps(msg).encode()
        self._send(_MSG.pack(T_CTRL, len(blob)) + blob)

    def _send(self, blob: bytes) -> None:
        if self.closed:
            raise TransportError("replication stream closed")
        try:
            self.sock.sendall(blob)
        except OSError as e:
            self.closed = True
            raise TransportError(f"replication peer gone: {e}") from e

    def recv_frames(self) -> List[bytes]:
        """Drain every fully received frame message."""
        return self._take(T_FRAME)

    def recv_acks(self) -> List[Tuple[int, int, bool, int]]:
        """Drain every fully received ack message."""
        return [(s, b, bool(g), e) for p in self._take(T_ACK)
                if len(p) == _ACK.size
                for s, b, g, e in (_ACK.unpack(p),)]

    def recv_ctrl(self) -> List[Dict[str, Any]]:
        """Drain every fully received control message (malformed json
        is dropped — control traffic is advisory, never durable)."""
        out = []
        for p in self._take(T_CTRL):
            try:
                msg = json.loads(p.decode())
            except (UnicodeDecodeError, ValueError):
                continue
            if isinstance(msg, dict):
                out.append(msg)
        return out

    def close(self) -> None:
        """Close the socket (idempotent)."""
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass


class SocketListener:
    """Follower-side localhost listener: binds an ephemeral port
    (``port=0``) and accepts the leader's single connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(1)
        self.host, self.port = self._sock.getsockname()[:2]

    def accept(self, timeout: float = 30.0) -> SocketEnd:
        """Wait (up to the `timeout` deadline) for the leader to
        connect, retrying transient accept failures with exponential
        backoff + jitter instead of dying on the first `OSError`.
        Raises `TransportError` when the deadline expires."""
        deadline = time.monotonic() + timeout
        delay, attempts = 0.05, 0
        rng = random.Random(self.port)
        while True:
            attempts += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportError(
                    f"accept on :{self.port} timed out after "
                    f"{attempts - 1} attempts ({timeout:.1f}s)")
            self._sock.settimeout(min(max(delay, 0.05), remaining))
            try:
                conn, _ = self._sock.accept()
                return SocketEnd(conn)
            except socket.timeout:
                continue                # the deadline check bounds us
            except OSError:
                # transient accept failure: back off with jitter
                time.sleep(min(delay * (0.5 + rng.random()),
                               max(0.0, deadline - time.monotonic())))
                delay = min(delay * 2, 2.0)

    def close(self) -> None:
        """Stop listening (established ends stay usable)."""
        try:
            self._sock.close()
        except OSError:
            pass


def connect(host: str, port: int, timeout: float = 30.0) -> SocketEnd:
    """Leader-side dial: connect to a follower's `SocketListener`,
    retrying refused/failed attempts with exponential backoff + jitter
    until the `timeout` deadline (a follower that is still binding its
    listener is the common transient). Raises `TransportError` when
    the deadline expires."""
    deadline = time.monotonic() + timeout
    delay, attempts = 0.05, 0
    rng = random.Random(port)
    last: Optional[OSError] = None
    while True:
        attempts += 1
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TransportError(
                f"connect to {host}:{port} failed after {attempts - 1} "
                f"attempts ({timeout:.1f}s): {last}")
        try:
            return SocketEnd(socket.create_connection(
                (host, port), timeout=min(max(delay, 0.05), remaining)))
        except OSError as e:
            last = e
            time.sleep(min(delay * (0.5 + rng.random()),
                           max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2, 2.0)


# --------------------------------------------------------------------------
# leader
# --------------------------------------------------------------------------

class _FollowerHandle:
    """Leader-side per-follower state: its id, transport end, shipping
    tailer, and the ack-derived lag accounting."""

    def __init__(self, end, cursor: Cursor, fid: int = 0):
        self.end = end
        self.fid = fid
        self.tailer: WAL.WalTailer
        self.base_offset = cursor.offset
        self.acked_seqno = (cursor.next_seqno - 1
                            if cursor.next_seqno is not None else -1)
        # the ack value the last heartbeat roster carried for this
        # follower (init: the bootstrap watermark, durable there by
        # construction) — quorum commits gate on this, never on a
        # fresher ack the successor rule has not seen
        self.advertised_seqno = self.acked_seqno
        self.acked_bytes = 0
        self.sent_records = 0
        self.sent_bytes = 0
        self.retransmits = 0
        self.dead = False
        self.dead_since: Optional[float] = None
        self.needs_bootstrap = False    # its cursor fell behind a prune


class Leader:
    """Replication source wrapped around one durable driver.

    ``Leader(drv)`` claims ``drv.replication`` (so `repro_torch.serve` pumps
    shipping between windows); `add_follower` bootstraps + attaches an
    in-process follower in one call, while `bootstrap` + `attach` wire
    a remote one over any transport end. `pump` (= heartbeats + `ship`
    + ack drain + fence replies) only ever reads *durable* WAL bytes —
    the leader's log-before-ack guarantee is untouched, and nothing a
    follower applies can ever be un-acked on the leader.

    ``ack_mode="quorum"`` with ``quorum=k`` does not change shipping —
    it exposes `quorum_seqno()` (the k-th highest *advertised* live
    follower ack, -1 on quorum loss) for the serving layer to gate
    client write acks on. Advertised = carried by the
    last heartbeat roster, so the successor rule's input always covers
    every released write; `pump` heartbeats eagerly when fresh acks
    would advance the quorum, keeping the added ack latency to one
    control message rather than a heartbeat cadence.

    ``lease_s``/``heartbeat_s`` drive the failure detector: every
    `pump` at most one heartbeat control message per `heartbeat_s`
    (default ``lease_s / 4``) is sent to each follower, carrying the
    lease duration and the ack roster the successor rule runs on.

    A leader that observes an ack at a *higher epoch than its own* has
    been deposed by an automatic failover: it stops shipping, fences
    its engine (writes raise), and should `demote()` + rejoin via the
    new leader's `bootstrap`."""

    def __init__(self, drv, *, ack_mode: str = "leader", quorum: int = 1,
                 lease_s: float = 2.0, heartbeat_s: Optional[float] = None,
                 dead_grace_s: Optional[float] = None,
                 clock=time.monotonic):
        if drv.durability is None:
            raise ValueError("replication requires a durable leader: "
                             "construct the engine with durability=...")
        if ack_mode not in ("leader", "quorum"):
            raise ValueError(f"unknown ack_mode {ack_mode!r} "
                             "(expected 'leader' or 'quorum')")
        self.drv = drv
        self.ack_mode = ack_mode
        self.quorum = int(quorum)
        self.lease_s = float(lease_s)
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s is not None
                            else self.lease_s / 4.0)
        # how long a dead handle's frozen ack may keep pinning the
        # prune floor before `prune` auto-detaches it (a permanently
        # gone follower must not make WAL growth unbounded again)
        self.dead_grace_s = (float(dead_grace_s) if dead_grace_s is not None
                             else 8.0 * self.lease_s)
        self.clock = clock
        self.handles: List[_FollowerHandle] = []
        self.fence_ends: List[Any] = []
        self.deposed = False
        self._next_fid = 0
        self._last_hb: Optional[float] = None
        self.counters = collections.Counter(
            heartbeats=0, detaches=0, reattaches=0, fence_acks=0,
            demotions=0, prune_calls=0, pruned_segments=0, pruned_cursors=0,
            expired_handles=0)
        drv.replication = self

    # -- wiring -------------------------------------------------------------
    def bootstrap(self, dst_dir) -> Cursor:
        """Initial sync: copy the newest snapshot (if any) plus every
        *retained* WAL frame past its watermark — across the whole
        segment chain — into `dst_dir`, and return the `Cursor` where
        shipping to that follower starts. The copied tail preserves the
        leader's frame bytes verbatim, so the follower's log begins as
        a bitwise slice of the leader's; a pruned leader log is fine,
        because `prune` never deletes past its snapshot watermark."""
        dur = self.drv.durability
        dur.sync()
        dst = Path(dst_dir)
        dst.mkdir(parents=True, exist_ok=True)
        watermark = -1
        snaps = WAL.list_snapshots(dur.dir)
        if snaps:
            num, spath = snaps[-1]
            shutil.copytree(spath, dst / spath.name, dirs_exist_ok=True)
            watermark = num
        frames = WAL.chain_frames(dur.dir, watermark + 1)
        (dst / "wal.log").write_bytes(WAL.MAGIC + b"".join(frames))
        last = dur.writer.last_seqno
        if last >= 0:
            nxt, epoch = last + 1, dur.writer.epoch
        elif watermark >= 0:
            nxt, epoch = watermark + 1, 0
        else:
            nxt, epoch = None, 0
        return Cursor(dur.log_bytes, nxt, epoch)

    def attach(self, end, cursor: Optional[Cursor] = None) -> _FollowerHandle:
        """Start shipping to transport `end` from `cursor` (default:
        genesis — the whole retained log, META included). Returns the
        handle `stats()` reports lag for."""
        if cursor is None:
            cursor = Cursor(len(WAL.MAGIC), None, 0)
        h = _FollowerHandle(end, cursor, fid=self._next_fid)
        self._next_fid += 1
        h.tailer = WAL.WalTailer(self.drv.durability.wal_path)
        if cursor.next_seqno is not None:
            # seqno-addressed start: the tailer relocates it across the
            # segment chain, wherever rolls/prunes left it
            h.tailer.rewind_to(cursor.next_seqno, cursor.epoch)
        self.handles.append(h)
        return h

    def add_follower(self, directory, *, driver: Optional[str] = None,
                     fsync: bool = False, device=None,
                     **fol_kw) -> "Follower":
        """Bootstrap `directory`, open a `Follower` over it, and attach
        it through an in-process `QueueLink` (reachable as
        ``follower.link`` for fault injection). `driver` defaults to
        the leader's own kind and `device` to the leader engine's device;
        extra keywords (``auto_promote``, ``clock``, ``pending_max``)
        pass through to `Follower`."""
        if driver is None:
            driver = ("sharded" if isinstance(self.drv, ShardedSLSM)
                      else "single")
        if device is None:
            device = self.drv.device
        # resolved before the bootstrap copy: without a card this raises
        # unless the caller (or a CPU leader) asked for the CPU
        device = resolve_device(device)
        cursor = self.bootstrap(directory)
        link = QueueLink()
        fol = Follower(directory, link.follower, driver=driver, fsync=fsync,
                       device=device, **fol_kw)
        fol.link = link
        self.attach(link.leader, cursor)
        return fol

    def detach(self, handle: _FollowerHandle) -> None:
        """Stop shipping to `handle` (its transport end is closed and
        its ack no longer holds back the prune floor)."""
        if handle in self.handles:
            self.handles.remove(handle)
            self.counters["detaches"] += 1
        try:
            handle.end.close()
        except OSError:
            pass

    def reattach(self, handle: _FollowerHandle, end=None) -> None:
        """Resume shipping to a handle `ship` marked dead (transport
        failure): optionally swap in a fresh transport `end`, rewind
        its cursor to the first un-acked seqno, and revive it. The
        follower's duplicate filter makes the overlap harmless."""
        if end is not None:
            handle.end = end
        handle.dead = False
        handle.dead_since = None
        handle.tailer.rewind_to(handle.acked_seqno + 1)
        if handle not in self.handles:
            self.handles.append(handle)
        self.counters["reattaches"] += 1

    def adopt_fence(self, end) -> None:
        """Keep a deposed predecessor's transport end as a *fence end*:
        `pump` answers anything it still ships with an ack at this
        leader's (bumped) epoch, which is how the old leader learns it
        was deposed (a promoted follower passes its old end here —
        `Follower.promote(lead=True)` does it automatically)."""
        self.fence_ends.append(end)

    # -- failure detection / leases ----------------------------------------
    def _mark_dead(self, h: _FollowerHandle) -> None:
        if not h.dead:
            h.dead = True
            h.dead_since = self.clock()
            self.counters["detaches"] += 1

    def _heartbeat(self, force: bool = False) -> None:
        """Send at most one lease heartbeat per `heartbeat_s` (always,
        when `force`d) to every live follower: epoch, durable
        watermark, lease duration, ack mode + quorum (so a promoted
        successor inherits them), the ack roster (the successor rule's
        input), and the receiver's own follower id. The roster values
        sent become the handles' ``advertised_seqno`` — the quorum
        commit watermark only ever advances over advertised acks."""
        if self.deposed or not self.handles:
            return
        now = self.clock()
        if (not force and self._last_hb is not None
                and now - self._last_hb < self.heartbeat_s):
            return
        self._last_hb = now
        w = self.drv.durability.writer
        roster = []
        for h in self.handles:
            if h.dead:
                continue
            h.advertised_seqno = int(h.acked_seqno)
            roster.append([h.fid, h.advertised_seqno])
        base = {"epoch": int(w.epoch), "last_seqno": int(w.last_seqno),
                "lease_s": self.lease_s, "ack_mode": self.ack_mode,
                "quorum": int(self.quorum), "roster": roster}
        for h in self.handles:
            if h.dead:
                continue
            try:
                h.end.send_ctrl({**base, "you": h.fid})
            except (TransportError, OSError):
                self._mark_dead(h)
        self.counters["heartbeats"] += 1

    def _kth_live_ack(self, advertised: bool) -> int:
        """The k-th highest live follower ack (-1 below quorum), over
        advertised or live ack values."""
        acks = sorted((h.advertised_seqno if advertised else h.acked_seqno
                       for h in self.handles if not h.dead), reverse=True)
        if len(acks) < self.quorum:
            return -1
        return int(acks[self.quorum - 1])

    def quorum_seqno(self) -> int:
        """The replication commit watermark: in quorum mode, the k-th
        highest *advertised* live follower ack (-1 while fewer than k
        followers are live — quorum loss, nothing new may be
        client-acked); in leader mode, simply the leader's durable
        watermark. Advertised (not live) acks keep RPO 0 under the
        roster-only successor rule: a write is only client-acked once
        the roster carrying its covering acks has been broadcast, so
        whichever follower the roster elects holds the write."""
        if self.ack_mode != "quorum":
            return int(self.drv.durability.writer.last_seqno)
        return self._kth_live_ack(advertised=True)

    # -- shipping -----------------------------------------------------------
    def ship(self, max_records: Optional[int] = None) -> int:
        """Tail the durable log and send each new frame verbatim to
        every live follower; then drain acks (a gap ack rewinds that
        follower's cursor by seqno — retransmission, with duplicates
        dropped by the follower's filter). A transport failure marks
        the handle dead (`reattach` revives it); a cursor that fell
        behind the prune floor flags ``needs_bootstrap``. Returns
        frames sent (always 0 once deposed — a fenced leader ships
        nothing)."""
        n = 0
        if not self.deposed:
            for h in self.handles:
                if h.dead:
                    continue
                polled = h.tailer.poll(max_records)
                if h.tailer.pruned_gap:
                    # only possible for a handle attached after pruning
                    # ran (attached acks floor `prune`): force a fresh
                    # bootstrap instead of shipping a gapped stream
                    self._mark_dead(h)
                    h.needs_bootstrap = True
                    self.counters["pruned_cursors"] += 1
                    continue
                if polled:
                    try:
                        h.end.send_frames([f for _, f in polled])
                    except (TransportError, OSError):
                        self._mark_dead(h)
                        continue
                    h.sent_records += len(polled)
                    h.sent_bytes += sum(len(f) for _, f in polled)
                    n += len(polled)
        self._drain_acks()
        return n

    def _drain_acks(self) -> None:
        my_epoch = self.drv.durability.writer.epoch
        for h in self.handles:
            if h.dead:
                continue
            try:
                acks = h.end.recv_acks()
            except (TransportError, OSError):
                self._mark_dead(h)
                continue
            for seqno, nbytes, gap, epoch in acks:
                if epoch > my_epoch:
                    # an acker is already at a later epoch: an automatic
                    # failover deposed this leader while it was
                    # partitioned — fence the engine so no further write
                    # can be client-acked, then the caller demote()s
                    if not self.deposed:
                        self.deposed = True
                        self.drv.demote()
                    continue
                if seqno > h.acked_seqno:
                    h.acked_seqno = seqno
                if nbytes > h.acked_bytes:
                    h.acked_bytes = nbytes
                if gap:
                    h.tailer.rewind_to(seqno + 1)
                    h.retransmits += 1

    def _pump_fences(self) -> None:
        """Answer anything a deposed predecessor still ships on an
        adopted fence end with an ack at this leader's epoch (and drop
        its stale heartbeats)."""
        w = self.drv.durability.writer
        for end in list(self.fence_ends):
            try:
                frames = end.recv_frames()
                end.recv_ctrl()         # stale heartbeats: ignore
                if frames:
                    end.send_ack(int(w.last_seqno), 0, gap=False,
                                 epoch=int(w.epoch))
                    self.counters["fence_acks"] += 1
            except (TransportError, OSError):
                self.fence_ends.remove(end)

    # -- pruning ------------------------------------------------------------
    def prune(self) -> int:
        """Watermark-bounded WAL pruning: truncate
        sealed segments at or below min(newest snapshot watermark,
        minimum acked seqno over attached handles — dead ones included
        while they are within ``dead_grace_s`` of their failure, they
        may `reattach`). A handle dead *past* the grace is auto-
        detached first (counted ``expired_handles``): a permanently
        gone follower must not pin the floor — and disk growth —
        forever. If it ever comes back, its rewound cursor trips the
        pruned-gap check and it re-enters via a fresh bootstrap. No
        snapshot or a straggling live follower ⇒ nothing is pruned.
        Returns segments deleted."""
        now = self.clock()
        for h in list(self.handles):
            if (h.dead and h.dead_since is not None
                    and now - h.dead_since > self.dead_grace_s):
                self.detach(h)
                self.counters["expired_handles"] += 1
        dur = self.drv.durability
        floor = dur.prune_floor()
        for h in self.handles:
            floor = min(floor, h.acked_seqno)
        self.counters["prune_calls"] += 1
        if floor < 0:
            return 0
        n = dur.prune(floor)
        self.counters["pruned_segments"] += n
        return n

    def pump(self) -> int:
        """One replication turn: lease heartbeat + ship new frames +
        drain acks + fence replies (the hook `repro_torch.serve.Server.pump`
        drives between windows). In quorum mode, acks just drained
        that would advance the commit watermark trigger an *eager*
        heartbeat — the quorum only commits over advertised acks, so
        advertising immediately keeps quorum ack latency at one pump
        instead of a heartbeat cadence."""
        self._heartbeat()
        n = self.ship()
        if (self.ack_mode == "quorum" and not self.deposed
                and self._kth_live_ack(advertised=False)
                > self._kth_live_ack(advertised=True)):
            self._heartbeat(force=True)
        self._pump_fences()
        return n

    def demote(self) -> Any:
        """Deposed-leader exit: detach every follower, close fence
        ends, fence the engine against writes (`drv.demote()` — writes
        raise until a future `promote()`), and release
        ``drv.replication``. Returns the now read-only engine;
        rejoining the cluster is a fresh `bootstrap` from the new
        leader into a new directory + `Follower` over it."""
        for h in list(self.handles):
            self.detach(h)
        for end in self.fence_ends:
            try:
                end.close()
            except OSError:
                pass
        self.fence_ends.clear()
        self.deposed = True
        self.counters["demotions"] += 1
        drv = self.drv
        drv.demote()
        drv.replication = None
        return drv

    # -- telemetry ----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Leader-side replication telemetry. ``follower_lag_records``
        / ``follower_lag_bytes`` are the *worst* follower's distance
        behind the leader's durable log (ack-derived; per-follower
        detail under ``per_follower``); quorum/lease state and the
        self-healing counters ride along."""
        dur = self.drv.durability
        w = dur.writer
        last, size = w.last_seqno, dur.log_bytes
        per = []
        for h in self.handles:
            lag_r = max(0, last - h.acked_seqno)
            lag_b = max(0, size - (h.base_offset + h.acked_bytes))
            per.append({"fid": int(h.fid),
                        "acked_seqno": int(h.acked_seqno),
                        "advertised_seqno": int(h.advertised_seqno),
                        "lag_records": int(lag_r),
                        "lag_bytes": int(lag_b),
                        "sent_records": int(h.sent_records),
                        "sent_bytes": int(h.sent_bytes),
                        "retransmits": int(h.retransmits),
                        "needs_bootstrap": bool(h.needs_bootstrap),
                        "alive": not h.dead})
        return {
            "role": "deposed" if self.deposed else "leader",
            "followers": len(per),
            "last_seqno": int(last),
            "epoch": int(w.epoch),
            "wal_bytes": int(size),
            "ack_mode": self.ack_mode,
            "quorum": int(self.quorum),
            "quorum_seqno": self.quorum_seqno(),
            "lease_s": float(self.lease_s),
            "heartbeat_s": float(self.heartbeat_s),
            "deposed": bool(self.deposed),
            "fence_ends": len(self.fence_ends),
            "wal_pruned_bytes": int(dur.counters["wal_pruned_bytes"]),
            "wal_pruned_segments": int(dur.counters["wal_pruned_segments"]),
            "shipped_records": int(sum(h.sent_records for h in self.handles)),
            "shipped_bytes": int(sum(h.sent_bytes for h in self.handles)),
            "follower_lag_records": max((p["lag_records"] for p in per),
                                        default=0),
            "follower_lag_bytes": max((p["lag_bytes"] for p in per),
                                      default=0),
            "per_follower": per,
            **{k: int(v) for k, v in self.counters.items()},
        }


# --------------------------------------------------------------------------
# follower
# --------------------------------------------------------------------------

class Follower:
    """Replication sink: a replica engine plus the apply loop.

    Opens `directory` (a `Leader.bootstrap` product — or a promoted
    follower's own dir on restart) via the engine's ``open_replica``,
    then each `apply`/`pump`: receive control messages (lease
    heartbeats) and frames, validate every frame with
    `wal.check_frame` (a corrupted frame is counted ``rejected`` and
    dropped *without poisoning the stream* — later frames still
    apply), drop duplicates (seqno ≤ applied watermark), buffer
    out-of-order arrivals by seqno in a buffer bounded by
    ``pending_max`` (overflow evicts the highest seqnos — the ones a
    retransmit re-covers last — counts ``pending_overflow``, and
    forces an immediate gap ack so one leader round-trip heals it),
    and apply each consecutive frame: append verbatim to the replica
    WAL, group-commit, replay through the engine's chunk-apply
    programs, ack ``(seqno, bytes, gap, epoch)``.

    With ``auto_promote=True`` the follower runs the failure detector:
    each heartbeat renews a lease of the advertised duration on the
    monotonic `clock`; when the lease expires, the successor rule —
    highest rostered ack, lowest follower id on ties, evaluated over
    the last roster ONLY (a follower's live watermark differs per
    follower, so mixing it in would let several caught-up followers
    each elect themselves) — either promotes *this* follower
    (``promote(lead=True)``, the new `Leader` lands in ``new_leader``
    and fences the old stream) or stands down with a re-armed
    *fallback* lease: every further expiry with no heartbeat peels one
    rank off the succession order, so the next-ranked follower
    eventually promotes if the designated successor died too.

    Reads (`lookup_many` / `range_many` / `aggregate_many` on ``drv``)
    are eventually consistent at the applied watermark. `promote` is
    the failover exit: returns the engine as a writable leader.

    The replica engine lives on `device`: the CUDA card unless
    ``device="cpu"`` (without a card, opening raises before the
    directory is touched)."""

    def __init__(self, directory, end=None, *, driver: str = "single",
                 fsync: bool = False, auto_promote: bool = False,
                 pending_max: int = 512, clock=time.monotonic,
                 device=None):
        cls = ShardedSLSM if driver == "sharded" else SLSM
        self.drv = cls.open_replica(directory, fsync=fsync, device=device)
        self.drv.replication = self
        self.end = end
        self.link: Optional[QueueLink] = None   # set by Leader.add_follower
        self.driver = driver
        self.auto_promote = auto_promote
        self.pending_max = int(pending_max)
        self.clock = clock
        self.pending: Dict[int, Tuple[WAL.WalRecord, bytes]] = {}
        self.promoted = False
        self.new_leader: Optional[Leader] = None
        self.fid: Optional[int] = None          # assigned by heartbeats
        self.roster: List[Tuple[int, int]] = []
        self.lease_s: Optional[float] = None
        self.lease_deadline: Optional[float] = None
        self.leader_epoch = 0
        self.leader_ack_mode = "leader"         # advertised by heartbeats:
        self.leader_quorum = 1                  # survives auto-promotion
        self._expiries_since_hb = 0
        self.counters = collections.Counter(
            applied_records=0, applied_bytes=0, duplicates=0, rejected=0,
            gap_signals=0, buffered_peak=0, pending_overflow=0,
            heartbeats_seen=0, lease_expiries=0, auto_promotions=0,
            standdowns=0)

    @property
    def last_seqno(self) -> int:
        """The applied (and durable) watermark: seqno of the last
        record in the replica's WAL."""
        return self.drv.durability.writer.last_seqno

    # -- apply path ---------------------------------------------------------
    def ingest(self, frames: List[bytes],
               max_records: Optional[int] = None) -> int:
        """Feed raw frames through the full apply pipeline (the
        transport-free seam the fault tests drive directly). Returns
        records applied."""
        if self.promoted:
            return 0
        dur = self.drv.durability
        overflowed = False
        for f in frames:
            rec = WAL.check_frame(f)
            if rec is None:
                self.counters["rejected"] += 1
                continue
            if rec.seqno <= self.last_seqno or rec.seqno in self.pending:
                self.counters["duplicates"] += 1
                continue
            if len(self.pending) >= self.pending_max:
                # bounded reorder buffer: keep the lowest seqnos (they
                # unblock the consecutive chain soonest), shed the
                # highest — the immediate gap ack below makes the
                # leader retransmit what was shed in one round-trip
                self.counters["pending_overflow"] += 1
                overflowed = True
                hi = max(self.pending)
                if rec.seqno >= hi:
                    continue            # incoming is the highest: drop it
                del self.pending[hi]
            self.pending[rec.seqno] = (rec, f)
        applied = 0
        while self.pending and (max_records is None
                                or applied < max_records):
            item = self.pending.pop(self.last_seqno + 1, None)
            if item is None:
                break
            rec, f = item
            try:
                dur.append_frame(f)
            except ValueError:          # epoch regression / stale frame
                self.counters["rejected"] += 1
                continue
            self.drv.apply_replicated([rec])
            self.counters["applied_records"] += 1
            self.counters["applied_bytes"] += len(f)
            applied += 1
        self.counters["buffered_peak"] = max(self.counters["buffered_peak"],
                                             len(self.pending))
        if applied:
            dur.sync()
        gap = overflowed or bool(self.pending
                                 and min(self.pending) > self.last_seqno + 1)
        if (applied or gap) and self.end is not None:
            if gap:
                self.counters["gap_signals"] += 1
            try:
                self.end.send_ack(self.last_seqno,
                                  self.counters["applied_bytes"], gap=gap,
                                  epoch=int(dur.writer.epoch))
            except (TransportError, OSError):
                pass                    # leader gone; the lease decides
        return applied

    def apply(self, max_records: Optional[int] = None) -> int:
        """Receive control messages + frames from the transport and
        `ingest`. Returns records applied (0 when detached or already
        promoted)."""
        if self.end is None or self.promoted:
            return 0
        for hb in self.end.recv_ctrl():
            self._on_heartbeat(hb)
        return self.ingest(self.end.recv_frames(), max_records)

    def pump(self) -> int:
        """One replication turn (the `repro_torch.serve` hook): apply, then
        run the lease failure detector.

        The detector reads the *freshest* control traffic: `apply` can
        dwell in `ingest` for longer than a lease (a cold follower
        compiling its first apply shapes), during which heartbeats keep
        landing in the transport inbox. Draining them again here means
        a live, heartbeating leader is never declared dead just because
        we were busy applying its stream."""
        n = self.apply()
        if self.end is not None and not self.promoted:
            for hb in self.end.recv_ctrl():
                self._on_heartbeat(hb)
        self.maybe_promote()
        return n

    # -- leases / automatic failover ---------------------------------------
    def _on_heartbeat(self, hb: Dict[str, Any]) -> None:
        try:
            self.fid = int(hb["you"])
            self.roster = [(int(f), int(a)) for f, a in hb.get("roster", [])]
            self.lease_s = float(hb["lease_s"])
            self.leader_epoch = int(hb.get("epoch", 0))
            self.leader_ack_mode = str(hb.get("ack_mode",
                                              self.leader_ack_mode))
            self.leader_quorum = int(hb.get("quorum", self.leader_quorum))
        except (KeyError, TypeError, ValueError):
            return                      # malformed control traffic: drop
        self.lease_deadline = self.clock() + self.lease_s
        self._expiries_since_hb = 0
        self.counters["heartbeats_seen"] += 1

    def succession_rank(self) -> Optional[int]:
        """This follower's position (0 = designated successor) in the
        deterministic succession order: roster entries sorted by
        highest rostered ack, lowest follower id on ties. Evaluated
        over roster values ONLY — every follower holding the same
        roster computes the same order, which is what makes the
        election single-winner; a live applied watermark would differ
        per follower and let several caught-up followers each elect
        themselves (split-brain). None when this follower has no
        roster entry (no heartbeat ever named it)."""
        if self.fid is None:
            return None
        order = sorted(((a, -f) for f, a in self.roster), reverse=True)
        mine = [a for f, a in self.roster if f == self.fid]
        if not mine:
            return None
        return order.index((mine[0], -self.fid))

    def is_successor(self) -> bool:
        """Does the successor rule designate this follower (rank 0)?"""
        return self.succession_rank() == 0

    def maybe_promote(self) -> Optional[Leader]:
        """The failure detector (a no-op unless ``auto_promote``): on
        lease expiry, count it, and either promote this follower —
        returning the new `Leader`, also kept in ``new_leader`` — or
        stand down behind a re-armed fallback lease. Each consecutive
        expiry with no intervening heartbeat peels one rank off the
        succession order: the designated successor (rank 0) promotes
        on the first expiry, rank 1 on the second, and so on — so a
        cluster whose designated successor died in the same failure
        still converges on a leader instead of waiting for an operator
        (at the price that the lower-ranked fallback may trail the
        dead successor's watermark)."""
        if (not self.auto_promote or self.promoted
                or self.lease_deadline is None
                or self.clock() < self.lease_deadline):
            return None
        self.counters["lease_expiries"] += 1
        self._expiries_since_hb += 1
        rank = self.succession_rank()
        if rank is None or rank > self._expiries_since_hb - 1:
            # stand down — but stay armed: if the winner's stream never
            # arrives, the next expiry promotes the next rank
            self.counters["standdowns"] += 1
            self.lease_deadline = (None if rank is None
                                   else self.clock() + (self.lease_s or 2.0))
            return None
        self.counters["auto_promotions"] += 1
        self.new_leader = self.promote(lead=True)
        return self.new_leader

    def reattach(self, end) -> None:
        """Point this follower at a new transport end (rejoin after a
        failover: the new leader `attach`es the other side). Lease
        state resets until the new leader's first heartbeat."""
        if self.end is not None:
            try:
                self.end.close()
            except OSError:
                pass
        self.end = end
        self.lease_deadline = None
        self._expiries_since_hb = 0

    # -- failover exit ------------------------------------------------------
    def promote(self, lead: bool = False, fence: bool = True):
        """Failover: make this follower the leader. Unacked buffered
        frames are dropped (never acked ⇒ never durable anywhere —
        clients were never told they happened) and the engine's
        ``promote()`` bumps the WAL epoch and re-enables local logging,
        so the seqno stream resumes right after the last applied record
        and any stale pre-failover bytes the reused log file might
        expose later are rejected by the prefix rule's epoch check.

        ``promote()`` closes the transport and returns
        the now-writable *engine*. ``promote(lead=True)`` instead
        returns a ready `Leader` wrapped around it — inheriting the
        lease duration AND the ack mode/quorum the old leader
        advertised, so a quorum (zero-RPO) cluster stays a quorum
        cluster across automatic failover (the fresh leader has no
        followers yet, so its commit watermark is -1 and nothing is
        client-acked until k followers re-attach — strictness, not
        regression) — and (with `fence`) adopts the old transport end
        as a fence end, so a deposed leader that comes back from a
        partition is answered at the bumped epoch and fences itself."""
        self.pending.clear()
        old_end, self.end = self.end, None
        self.promoted = True
        drv = self.drv.promote()
        drv.replication = None
        if not lead:
            if old_end is not None:
                try:
                    old_end.close()
                except OSError:
                    pass
            return drv
        ldr = Leader(drv,
                     ack_mode=self.leader_ack_mode,
                     quorum=self.leader_quorum,
                     lease_s=self.lease_s if self.lease_s else 2.0,
                     clock=self.clock)
        if old_end is not None:
            if fence:
                ldr.adopt_fence(old_end)
            else:
                try:
                    old_end.close()
                except OSError:
                    pass
        return ldr

    def stats(self) -> Dict[str, Any]:
        """Follower-side replication telemetry: applied watermark,
        reorder-buffer occupancy/bound, lease state, and the
        duplicate/reject/overflow counters."""
        return {
            "role": "follower",
            "promoted": self.promoted,
            "applied_seqno": int(self.last_seqno),
            "reorder_buffered": len(self.pending),
            "pending_max": int(self.pending_max),
            "fid": self.fid,
            "auto_promote": bool(self.auto_promote),
            "lease_armed": self.lease_deadline is not None,
            "leader_epoch": int(self.leader_epoch),
            "leader_ack_mode": self.leader_ack_mode,
            "leader_quorum": int(self.leader_quorum),
            "succession_rank": self.succession_rank(),
            **{k: int(v) for k, v in self.counters.items()},
        }


def converge(leader: Leader, *followers: Follower,
             max_rounds: int = 1000) -> int:
    """Pump `leader` and `followers` until every follower's ack says it
    has applied the leader's whole durable log (lag 0). Returns rounds
    used; raises RuntimeError when `max_rounds` pumps don't converge
    (e.g. a severed link)."""
    for r in range(max_rounds):
        leader.pump()
        for f in followers:
            f.pump()
        leader.pump()                   # drain the acks just sent
        if leader.stats()["follower_lag_records"] == 0:
            return r + 1
    raise RuntimeError("replication did not converge: "
                       + json.dumps(leader.stats()))
