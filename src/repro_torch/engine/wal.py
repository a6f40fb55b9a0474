"""Durability: a sequence-numbered write-ahead log and atomic snapshots
(port of `repro.engine.wal`, reference DESIGN.md §12).

The engine's state lives in device memory and dies with the process.
Every engine-call write op (one weighted write chunk a call, one a
tape write chunk, and each applied RETUNE) is appended to a CRC-framed,
strictly sequence-numbered log and group-committed before the call
returns (log-before-ack). A snapshot copies the whole state to the host
and publishes it atomically, stamped with the log's seqno watermark.
``SLSM.restore`` loads the newest valid snapshot and replays the log
past it through the engine's own write path.

Replay is answer-exact, not bitwise-state-exact: a restored engine may
hold its runs at another maintenance progress than the crashed one, but
every lookup and range answers as an engine fed the durable op prefix
would (reads are exact between maintenance steps, and retunes do not
change answers).

The formats are the reference's, byte for byte, in both directions: the
same op stream writes the same ``wal.log`` and the same snapshot leaf
files, and each package restores what the other wrote.

WAL file format (little-endian):

    magic  b"SLSMWAL1"
    record := crc32 u32 | length u32 | seqno u64 | kind u8 | epoch u8
              | pad[2] | payload[length]

The crc32 covers everything after the crc field, so a torn or
bit-flipped tail is rejected as a unit; seqnos are strictly consecutive
and epochs never decrease, so a well-formed record after a gap, or a
stale record of an earlier lineage past a record-aligned cut, is
rejected too. `read_wal` returns the longest well-formed prefix and
`WalWriter` truncates the torn tail before it resumes appending.

Record kinds:

    REC_META    json engine fingerprint (engine kind, params, policy),
                always the first record, checked on reattach; carries
                ``"wal": 2`` (the record-format version)
    REC_WRITE   legacy write chunk: n u32, keys int32[n], vals int32[n]
                (a TOMBSTONE value is a delete); decoded, never written
    REC_WRITE2  one weighted write chunk: n u32, keys int32[n],
                vals int32[n], wts int8[n] (+1 insert, -1 delete)
    REC_RETUNE  one applied tuner allocation switch (utf-8 preset name)

The fingerprint's params are the reference's field set: the port's
`SLSMParams` has no ``backend`` field, so `params_to_dict` writes the
reference's default ``"backend": "jnp"`` in its place, and the
fingerprint comparison of `Durability.ensure_header` leaves ``backend``
out (as well as ``wal``), so a directory the reference wrote with
``backend="pallas"`` reattaches here.

`WalWriter.append` only buffers; `Durability.sync` writes and fsyncs the
batch once: one fsync an engine call (or a tape window), not a record.

Snapshots are directories ``snap_<seqno>/`` (``.tmp-<pid>`` + rename
publish, one ``leaf_<i>.npy`` a leaf, sha256-verified ``meta.json``),
garbage-collected to ``keep_snapshots``. Leaves are stored with the
reference's dtypes (blooms uint32; bfloat16 as its uint16 bits, named
``"bfloat16"``) and read back as CPU tensors of those dtypes; nothing
here needs ``ml_dtypes``.

Replication rides the same framing: `WalTailer` yields each newly
durable frame verbatim, and `WalWriter.append_frame` appends a shipped
frame byte for byte. With ``segment_bytes`` set, `sync` seals the active
``wal.log`` into ``wal_<first_seqno>.log`` once it outgrows that size;
the seqno/epoch stream runs on across files (`read_wal_chain`), and
`Durability.prune` deletes sealed segments at or below a watermark.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import re
import shutil
import struct
import sys
import time
import zlib
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.params import TOMBSTONE, SLSMParams, TuningPolicy

MAGIC = b"SLSMWAL1"

# record framing: crc32 u32 | payload length u32 | seqno u64 | kind u8
#                 | epoch u8 | pad2
_HEADER = struct.Struct("<IIQBB2x")
_CRC_BODY_LEN = _HEADER.size - 4          # crc covers header-after-crc+payload
_MAX_PAYLOAD = 1 << 28                    # sanity bound while scanning

REC_META = 0      # json engine fingerprint (first record of every WAL)
REC_WRITE = 1     # legacy write chunk (keys+vals int32; TOMBSTONE = delete)
REC_RETUNE = 2    # one applied tuner allocation switch (preset name)
REC_WRITE2 = 3    # weighted write chunk (keys+vals int32, wts int8)

WAL_FORMAT = 2    # record-format version stamped into the META record
WRITE_KINDS = (REC_WRITE, REC_WRITE2)


class WalRecord(NamedTuple):
    """One decoded WAL record: its sequence number, kind tag, raw
    payload bytes (see the module docstring for the payload codecs),
    and the failover epoch it was stamped under (0 until the first
    `promote()` of the log's lineage)."""

    seqno: int
    kind: int
    payload: bytes
    epoch: int = 0


class SnapshotError(RuntimeError):
    """A snapshot directory failed integrity verification (missing or
    malformed meta.json, or a leaf whose sha256 does not match)."""


# --------------------------------------------------------------------------
# record codecs
# --------------------------------------------------------------------------

def encode_record(seqno: int, kind: int, payload: bytes,
                  epoch: int = 0) -> bytes:
    """Frame one record: crc32 header (covering length/seqno/kind/epoch
    and the payload) + payload bytes."""
    head = _HEADER.pack(0, len(payload), seqno, kind, epoch)
    crc = zlib.crc32(head[4:] + payload) & 0xFFFFFFFF
    return _HEADER.pack(crc, len(payload), seqno, kind, epoch) + payload


def encode_write(keys, vals, wts) -> bytes:
    """REC_WRITE2 payload: n u32 + keys int32[n] + vals int32[n] +
    wts int8[n] — one engine-call weighted write chunk (weight +1 is
    an insert, -1 a delete)."""
    k = np.ascontiguousarray(np.asarray(keys, np.int32).reshape(-1))
    v = np.ascontiguousarray(np.asarray(vals, np.int32).reshape(-1))
    w = np.ascontiguousarray(np.asarray(wts, np.int8).reshape(-1))
    if k.shape != v.shape or k.shape != w.shape:
        raise ValueError("encode_write: keys, vals and wts must match")
    return struct.pack("<I", k.size) + k.tobytes() + v.tobytes() + w.tobytes()


def decode_write(payload: bytes, kind: int = REC_WRITE2
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a write chunk of either format to weighted form:
    -> (keys int32[n], vals int32[n], wts int32[n]).

    REC_WRITE2 decodes natively; a legacy REC_WRITE record maps its
    reserved TOMBSTONE value to a -1-weight delete with payload 0 — the
    one place the historical sentinel survives, so pre-weighted WAL
    directories replay exactly."""
    (n,) = struct.unpack_from("<I", payload, 0)
    if kind == REC_WRITE2:
        if len(payload) != 4 + 9 * n:
            raise ValueError(f"malformed REC_WRITE2 payload: n={n}, "
                             f"{len(payload)} bytes")
        k = np.frombuffer(payload, np.int32, count=n, offset=4)
        v = np.frombuffer(payload, np.int32, count=n, offset=4 + 4 * n)
        w = np.frombuffer(payload, np.int8, count=n, offset=4 + 8 * n)
        return k.copy(), v.copy(), w.astype(np.int32)
    if len(payload) != 4 + 8 * n:
        raise ValueError(f"malformed REC_WRITE payload: n={n}, "
                         f"{len(payload)} bytes")
    k = np.frombuffer(payload, np.int32, count=n, offset=4)
    v = np.frombuffer(payload, np.int32, count=n, offset=4 + 4 * n)
    is_del = v == np.int32(TOMBSTONE)
    w = np.where(is_del, np.int32(-1), np.int32(1))
    return k.copy(), np.where(is_del, np.int32(0), v), w


def read_wal(path) -> Tuple[List[WalRecord], int]:
    """Decode the longest well-formed prefix of a WAL file.

    Returns ``(records, good_bytes)``: every record up to — but not
    including — the first framing violation (short header, implausible
    length, CRC mismatch, a non-consecutive seqno, or a *decreasing*
    epoch), and the byte offset where that violation starts. A torn or
    corrupted tail is thereby dropped as a unit: no partial record is
    ever surfaced. The epoch check is what makes ``promote()``'s file
    reuse safe — stale pre-failover bytes past a record-aligned cut
    carry an older epoch and are rejected even when their seqno happens
    to be consecutive. ``good_bytes == 0`` means the file (or its
    magic) is unreadable and a resuming writer must start it over. A
    missing file decodes to ``([], 0)``.
    """
    p = Path(path)
    if not p.exists():
        return [], 0
    data = p.read_bytes()
    if len(data) < len(MAGIC) or data[:len(MAGIC)] != MAGIC:
        return [], 0
    records: List[WalRecord] = []
    off = len(MAGIC)
    prev: Optional[int] = None
    prev_epoch = 0
    while off + _HEADER.size <= len(data):
        crc, length, seqno, kind, epoch = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length
        if length > _MAX_PAYLOAD or end > len(data):
            break
        if zlib.crc32(data[off + 4:end]) & 0xFFFFFFFF != crc:
            break
        if prev is not None and seqno != prev + 1:
            break
        if epoch < prev_epoch:
            break
        records.append(WalRecord(seqno, kind,
                                 bytes(data[off + _HEADER.size:end]),
                                 epoch))
        prev = seqno
        prev_epoch = epoch
        off = end
    return records, off


def check_frame(frame: bytes) -> Optional[WalRecord]:
    """Validate one standalone framed record (exact length, CRC) and
    decode it, or return None if the bytes are not a complete well-
    formed frame — the follower-side gate that rejects a corrupted or
    torn replication message without poisoning the stream."""
    if len(frame) < _HEADER.size:
        return None
    crc, length, seqno, kind, epoch = _HEADER.unpack_from(frame, 0)
    if length > _MAX_PAYLOAD or len(frame) != _HEADER.size + length:
        return None
    if zlib.crc32(frame[4:]) & 0xFFFFFFFF != crc:
        return None
    return WalRecord(seqno, kind, bytes(frame[_HEADER.size:]), epoch)


# --------------------------------------------------------------------------
# segmented-log chain (sealed wal_<first_seqno>.log files + active wal.log)
# --------------------------------------------------------------------------

_SEG_RE = re.compile(r"^wal_(\d+)\.log$")


def list_segments(directory) -> List[Tuple[int, Path]]:
    """Sealed, immutable WAL segments under `directory` as
    ``[(first_seqno, path), ...]`` sorted ascending by their first
    record's seqno (encoded in the filename at seal time). The active
    tail (``wal.log``) is never listed here — it is still being
    appended to and must never be pruned."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for p in directory.iterdir():
        m = _SEG_RE.match(p.name)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def _first_seqno(path) -> Optional[int]:
    """Seqno of the first (possibly torn) frame header in a WAL file,
    or None when the file is missing/empty — a cheap O(1) probe used to
    detect that the active file was sealed and replaced underneath a
    tailer's cursor."""
    try:
        with open(path, "rb") as f:
            f.seek(len(MAGIC))
            head = f.read(_HEADER.size)
    except OSError:
        return None
    if len(head) < _HEADER.size:
        return None
    return _HEADER.unpack(head)[2]


def wal_chain(directory, active: str = "wal.log") -> List[Path]:
    """The ordered file chain of a (possibly segmented) WAL directory:
    every sealed segment ascending, then the active tail if present."""
    directory = Path(directory)
    paths = [p for _, p in list_segments(directory)]
    ap = directory / active
    if ap.exists():
        paths.append(ap)
    return paths


def read_wal_chain(directory, active: str = "wal.log"
                   ) -> Tuple[List[WalRecord], int]:
    """Decode the retained record stream of a whole WAL directory —
    every sealed segment in order, then the active tail — enforcing the
    `read_wal` prefix rule *across* file boundaries (consecutive
    seqnos, non-decreasing epochs). Returns ``(records,
    good_bytes_total)``; a pruned directory's stream simply starts at
    the first retained segment's seqno instead of 0."""
    records: List[WalRecord] = []
    total = 0
    prev: Optional[int] = None
    prev_epoch = 0
    for p in wal_chain(directory, active):
        recs, _ = read_wal(p)
        total += len(MAGIC)
        for r in recs:
            if prev is not None and r.seqno != prev + 1:
                return records, total
            if r.epoch < prev_epoch:
                return records, total
            records.append(r)
            prev, prev_epoch = r.seqno, r.epoch
            total += _HEADER.size + len(r.payload)
    return records, total


def chain_frames(directory, from_seqno: int,
                 active: str = "wal.log") -> List[bytes]:
    """Raw frame bytes of every retained record with ``seqno >=
    from_seqno`` across the segment chain, in order — the verbatim tail
    a leader's `bootstrap` copies past a snapshot watermark."""
    t = WalTailer(Path(directory) / active)
    frames: List[bytes] = []
    while True:
        got = t.poll()
        if not got:
            return frames
        frames.extend(f for r, f in got if r.seqno >= from_seqno)


class WalTailer:
    """Incremental reader of a live WAL's durable frame stream.

    A replication leader's shipping cursor: `poll` reads the file from
    a byte offset and yields each newly appended well-formed frame
    exactly once, as ``(record, raw_frame_bytes)`` — raw bytes so
    frames ship verbatim and a follower's `WalWriter.append_frame`
    reproduces the leader's log bitwise. The `read_wal` prefix rule
    applies incrementally: a frame surfaces only when fully present
    with a valid CRC, the expected consecutive seqno, and a
    non-decreasing epoch; a torn tail stays pending until the writer
    completes it.

    Segment chains: `path` names the *active* tail; when the durable
    stream spans sealed ``wal_<first_seqno>.log`` segments, the cursor
    hops files by seqno — a clean EOF on a sealed segment continues
    into the next one, and a mismatch at the cursor's offset (the
    active file was sealed and replaced underneath it) triggers a
    relocation of `next_seqno` across the chain. `pruned_gap` is set
    when the needed seqno was pruned away entirely: the cursor can
    never serve it and the consumer must re-`bootstrap`.
    """

    def __init__(self, path, offset: Optional[int] = None,
                 next_seqno: Optional[int] = None, epoch: int = 0):
        self.path = Path(path)          # the active tail
        self.dir = self.path.parent
        self.offset = len(MAGIC) if offset is None else offset
        self.next_seqno = next_seqno    # None = accept any first seqno
        self.epoch = epoch
        self.pruned_gap = False
        self._cur = self.path           # file the cursor points into
        self._cur_first: Optional[int] = None   # its first seqno, if seen
        # with no explicit position, start at the head of the chain
        self._needs_locate = offset is None and next_seqno is None

    def _poll_file(self, max_records: Optional[int],
                   out: List[Tuple[WalRecord, bytes]]) -> str:
        """Consume frames from the current file at the cursor; returns
        why it stopped: 'budget', 'eof' (cleanly exhausted), 'torn'
        (incomplete tail), 'mismatch' (complete frame that violates the
        prefix rule), or 'missing' (file gone)."""
        if not self._cur.exists():
            return "missing"
        with open(self._cur, "rb") as f:
            f.seek(self.offset)
            data = f.read()
        off = 0
        while True:
            if max_records is not None and len(out) >= max_records:
                return "budget"
            if off + _HEADER.size > len(data):
                return "eof" if off == len(data) else "torn"
            crc, length, seqno, kind, epoch = _HEADER.unpack_from(data, off)
            end = off + _HEADER.size + length
            if length > _MAX_PAYLOAD:
                return "mismatch"
            if end > len(data):
                return "torn"
            frame = bytes(data[off:end])
            if zlib.crc32(frame[4:]) & 0xFFFFFFFF != crc:
                return "mismatch"
            if self.next_seqno is not None and seqno != self.next_seqno:
                return "mismatch"
            if epoch < self.epoch:
                return "mismatch"
            if self.offset == len(MAGIC):
                self._cur_first = seqno
            out.append((WalRecord(seqno, kind, frame[_HEADER.size:], epoch),
                        frame))
            self.next_seqno = seqno + 1
            self.epoch = epoch
            self.offset += len(frame)
            off = end

    def _active_replaced(self) -> bool:
        """Was the active file sealed and restarted underneath a cursor
        positioned in it? (Its first record's seqno changed, or it shrank
        below the cursor while once holding records.)"""
        if self._cur != self.path:
            return False
        first = _first_seqno(self.path)
        if self._cur_first is None:
            # the cursor was parked at the head of a then-empty active:
            # it was replaced iff the file now opens at some seqno other
            # than the one the cursor is waiting for (that seqno was
            # sealed into a segment underneath us)...
            if first is not None:
                return (self.next_seqno is not None
                        and first != self.next_seqno)
            # ...or the active is empty *again* but the awaited seqno
            # was meanwhile sealed into the chain (tiny segments can
            # seal on every append, so the active is empty at each
            # poll and the new frames live only in sealed segments)
            if self.next_seqno is None:
                return False
            sealed = [p for p in wal_chain(self.dir, self.path.name)
                      if p != self.path]
            nf = _first_seqno(sealed[-1]) if sealed else None
            return nf is not None and nf >= self.next_seqno
        if first is None:
            try:
                size = os.path.getsize(self.path)
            except OSError:
                return True
            return self.offset > size
        return first != self._cur_first

    def _locate(self) -> bool:
        """Position the cursor at `next_seqno` (or the chain head when
        None) by walking the segment chain. Returns False — setting
        `pruned_gap` — when the needed seqno precedes every retained
        frame."""
        self._needs_locate = False
        chain = wal_chain(self.dir, self.path.name)
        if not chain:
            return False
        if self.next_seqno is None:
            self._cur, self.offset, self._cur_first = \
                chain[0], len(MAGIC), _first_seqno(chain[0])
            return True
        # last chain file whose first seqno <= next_seqno (an empty
        # active tail is a valid final position: frames arrive later)
        idx = None
        for i, p in enumerate(chain):
            first = _first_seqno(p)
            if first is None:       # empty active tail: head of nothing
                if idx is None:
                    idx = i
                break
            if first <= self.next_seqno:
                idx = i
            else:
                break
        if idx is None:
            self.pruned_gap = True
            return False
        while True:
            p = chain[idx]
            off = len(MAGIC)
            try:
                data = p.read_bytes()
            except OSError:
                return False
            found_end = False
            while off + _HEADER.size <= len(data):
                _, length, seqno, _, _ = _HEADER.unpack_from(data, off)
                end = off + _HEADER.size + length
                if length > _MAX_PAYLOAD or end > len(data):
                    break
                if seqno >= self.next_seqno:
                    found_end = True
                    break
                off = end
            if found_end or idx == len(chain) - 1:
                self._cur, self.offset = p, off
                self._cur_first = _first_seqno(p)
                return True
            idx += 1    # seqno continues in the next chain file

    def poll(self, max_records: Optional[int] = None
             ) -> List[Tuple[WalRecord, bytes]]:
        """Read every frame that became durable since the last poll
        (up to `max_records`), advancing the cursor past each — hopping
        sealed-segment boundaries transparently."""
        out: List[Tuple[WalRecord, bytes]] = []
        if self._needs_locate and not self._locate():
            return out
        relocated = False
        for _hop in range(64):
            status = self._poll_file(max_records, out)
            if status == "budget":
                break
            if status == "eof":
                if self._cur != self.path:
                    if not self._locate():      # sealed: hop the chain
                        break
                    continue
                if not relocated and self._active_replaced():
                    relocated = True
                    if self._locate():
                        continue
                break
            if status in ("mismatch", "torn", "missing"):
                # a roll may have replaced the bytes under the cursor;
                # relocate once — a genuine violation relocates to the
                # same spot and stays pending, exactly as before
                if not relocated and (self._cur != self.path
                                      or status == "missing"
                                      or self._active_replaced()):
                    relocated = True
                    if self._locate():
                        continue
                break
        return out

    def rewind(self, offset: int, next_seqno: Optional[int],
               epoch: int = 0) -> None:
        """Reset the cursor to an explicit byte position in the active
        file (leader retransmit after a follower reports a gap): the
        next `poll` re-reads from `offset` expecting `next_seqno`."""
        self._cur = self.path
        self._cur_first = None
        self._needs_locate = False
        self.pruned_gap = False
        self.offset = offset
        self.next_seqno = next_seqno
        self.epoch = epoch

    def rewind_to(self, next_seqno: int, epoch: int = 0) -> None:
        """Seqno-addressed rewind (segment-chain aware): the next
        `poll` relocates `next_seqno` across the chain, wherever the
        rolls put it — the retransmit path that survives sealing."""
        self.next_seqno = next_seqno
        self.epoch = epoch
        self.pruned_gap = False
        self._needs_locate = True


def record_offsets(path) -> List[Tuple[WalRecord, int, int]]:
    """``[(record, start, end), ...]`` byte extents of every well-formed
    record — the crash-point injection harness's map of where to cut."""
    records, _ = read_wal(path)
    out, off = [], len(MAGIC)
    for rec in records:
        end = off + _HEADER.size + len(rec.payload)
        out.append((rec, off, end))
        off = end
    return out


class WalWriter:
    """Append-only writer with torn-tail recovery and group commit.

    Opening an existing WAL scans it (`read_wal`), truncates whatever
    torn tail a crash left, and resumes seqnos after the last valid
    record (never below ``min_next_seqno``, so a log restarted after
    snapshot-only recovery cannot reuse watermarked seqnos). `append`
    only buffers; `sync` writes the whole batch in one OS write and —
    when asked — one fsync: the per-engine-call group commit the
    serving layer's log-before-ack window boundary rides.
    """

    def __init__(self, path, min_next_seqno: int = 0):
        self.path = Path(path)
        self.head: Optional[WalRecord] = None   # the META record, if any
        self.epoch = 0                          # failover epoch stamp
        self.first_seqno_in_file: Optional[int] = None  # segment-roll bound
        if self.path.exists():
            records, good = read_wal(self.path)
            if good == 0:
                self.path.write_bytes(MAGIC)    # unreadable: start over
                good, records = len(MAGIC), []
            else:
                with open(self.path, "r+b") as f:
                    f.truncate(good)            # drop the torn tail
            self.next_seqno = records[-1].seqno + 1 if records else 0
            self.epoch = records[-1].epoch if records else 0
            if records:
                self.first_seqno_in_file = records[0].seqno
            if records and records[0].kind == REC_META:
                self.head = records[0]
        else:
            self.path.write_bytes(MAGIC)
            good = len(MAGIC)
            self.next_seqno = 0
        self.next_seqno = max(self.next_seqno, min_next_seqno)
        self._f = open(self.path, "ab")
        self._buf: List[bytes] = []
        self.size = good          # well-formed bytes incl. buffered records
        self.records = 0          # records appended by THIS writer
        self.syncs = 0            # sync() calls that flushed something

    @property
    def last_seqno(self) -> int:
        """Seqno of the most recently appended record (-1 if none ever)."""
        return self.next_seqno - 1

    def append(self, kind: int, payload: bytes) -> int:
        """Buffer one framed record; returns the seqno it was stamped
        with. Nothing reaches the OS until `sync`."""
        seqno = self.next_seqno
        rec = encode_record(seqno, kind, payload, self.epoch)
        self._buf.append(rec)
        self.next_seqno += 1
        self.size += len(rec)
        self.records += 1
        if self.first_seqno_in_file is None:
            self.first_seqno_in_file = seqno
        if kind == REC_META and self.head is None:
            self.head = WalRecord(seqno, kind, payload, self.epoch)
        return seqno

    def append_frame(self, frame: bytes) -> int:
        """Buffer one *pre-framed* record verbatim (the replication
        follower path): the frame must pass `check_frame`, carry this
        writer's exact next seqno, and not regress the epoch — its
        leader-assigned stamps are preserved byte-identically. Returns
        the frame's seqno; raises ValueError on any violation (the
        caller drops or re-requests the frame, the log is untouched)."""
        rec = check_frame(frame)
        if rec is None:
            raise ValueError("append_frame: malformed frame (CRC/framing)")
        if rec.seqno != self.next_seqno:
            raise ValueError(f"append_frame: seqno {rec.seqno} != expected "
                             f"{self.next_seqno}")
        if rec.epoch < self.epoch:
            raise ValueError(f"append_frame: epoch regressed "
                             f"({rec.epoch} < {self.epoch})")
        self._buf.append(frame)
        self.next_seqno = rec.seqno + 1
        self.epoch = rec.epoch
        self.size += len(frame)
        self.records += 1
        if self.first_seqno_in_file is None:
            self.first_seqno_in_file = rec.seqno
        if rec.kind == REC_META and self.head is None:
            self.head = rec
        return rec.seqno

    def bump_epoch(self) -> int:
        """Advance the failover epoch stamped into subsequent records —
        called by a follower's ``promote()`` so any stale bytes a later
        crash exposes from the pre-failover lineage are rejected by the
        prefix rule's epoch check. Returns the new epoch."""
        if self.epoch >= 0xFF:
            raise ValueError("epoch exhausted (255 failovers on one log)")
        self.epoch += 1
        return self.epoch

    def sync(self, fsync: bool = True) -> None:
        """Group commit: one OS write of every buffered record, then —
        with `fsync` — one fdatasync-equivalent barrier. A no-op when
        nothing is buffered."""
        if not self._buf:
            return
        self._f.write(b"".join(self._buf))
        self._buf.clear()
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
        self.syncs += 1

    def close(self) -> None:
        """Flush (without fsync) and release the file handle."""
        self.sync(fsync=False)
        self._f.close()


# --------------------------------------------------------------------------
# snapshot codec (the port's one serialization path; the
# repro_torch.checkpoint facade rides it too)
# --------------------------------------------------------------------------

def _encode_leaf(leaf) -> Tuple[np.ndarray, str]:
    """The host array to save for one leaf (a tensor, anywhere, or a
    numpy array) and the dtype name to record. bfloat16 travels as its
    uint16 bits under the name ``"bfloat16"``, as the reference writes
    it; a tensor keeps its shape (0-d stays 0-d)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _decode_leaf(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor of the recorded dtype from the saved array."""
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def write_snapshot(directory, num: int, leaves, meta: Dict[str, Any],
                   keep_last: Optional[int] = None,
                   prefix: str = "snap_") -> Path:
    """Atomically publish one numbered snapshot of `leaves` (tensors or
    numpy arrays, in order).

    Writes ``<directory>/<prefix><num>.tmp-<pid>/`` — one
    ``leaf_<i>.npy`` per leaf plus a ``meta.json`` carrying
    `meta`, per-leaf shapes/dtypes, and sha256 digests — then renames
    it to ``<prefix><num>/`` (the atomic publish: a crash mid-write
    leaves only an ignored ``.tmp`` dir). With `keep_last`, older
    numbered snapshots beyond that count are garbage-collected.
    Returns the published path.
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"{prefix}{num}"
    tmp = Path(f"{final}.tmp-{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    doc = dict(meta)
    doc["leaves"] = []
    for i, leaf in enumerate(leaves):
        fn = f"leaf_{i}.npy"
        enc, dt_name = _encode_leaf(leaf)
        np.save(tmp / fn, enc)
        doc["leaves"].append({"file": fn, "shape": list(enc.shape),
                              "dtype": dt_name,
                              "sha256": _sha256_file(tmp / fn)})
    (tmp / "meta.json").write_text(json.dumps(doc))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last is not None:
        for _, old in list_snapshots(directory, prefix)[:-keep_last]:
            shutil.rmtree(old, ignore_errors=True)
    return final


def list_snapshots(directory, prefix: str = "snap_"
                   ) -> List[Tuple[int, Path]]:
    """Published (non-``.tmp``) snapshots under `directory`, as
    ``[(num, path), ...]`` sorted ascending by number."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    out = []
    for d in directory.iterdir():
        if not d.is_dir() or ".tmp" in d.name:
            continue
        if not d.name.startswith(prefix):
            continue
        suffix = d.name[len(prefix):]
        if suffix.lstrip("-").isdigit():
            out.append((int(suffix), d))
    return sorted(out)


def gc_tmp_snapshots(directory) -> None:
    """Remove orphaned ``.tmp-<pid>`` snapshot dirs (a crash mid-write
    leaves one; it was never published, so deleting it is always safe)."""
    directory = Path(directory)
    if not directory.is_dir():
        return
    for d in directory.iterdir():
        if d.is_dir() and ".tmp-" in d.name:
            shutil.rmtree(d, ignore_errors=True)


def read_snapshot(path) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """Load + verify one published snapshot directory.

    Every leaf file's sha256 is checked against ``meta.json`` before
    its array is surfaced. Returns ``(leaves, meta)``, the leaves CPU
    tensors of their recorded dtypes; raises
    `SnapshotError` on any missing file, malformed metadata, or digest
    mismatch (the caller falls back to an older snapshot)."""
    path = Path(path)
    try:
        meta = json.loads((path / "meta.json").read_text())
    except (OSError, ValueError) as e:
        raise SnapshotError(f"unreadable snapshot meta in {path}: {e}")
    leaves = []
    for entry in meta.get("leaves", []):
        fp = path / entry["file"]
        try:
            if _sha256_file(fp) != entry["sha256"]:
                raise SnapshotError(f"snapshot corruption detected: {fp}")
            arr = np.load(fp)
        except OSError as e:
            raise SnapshotError(f"unreadable snapshot leaf {fp}: {e}")
        leaves.append(_decode_leaf(arr, entry["dtype"]))
    return leaves, meta


def load_latest_snapshot(directory, prefix: str = "snap_"
                         ) -> Optional[Tuple[int, List[torch.Tensor],
                                             Dict[str, Any]]]:
    """Newest snapshot that passes verification, or None.

    Tries snapshots newest-first; a corrupted one is reported to stderr
    and skipped — recovery then proceeds from the previous snapshot (or
    from a full-WAL replay when none survive), trading restore time for
    correctness instead of failing."""
    for num, path in reversed(list_snapshots(directory, prefix)):
        try:
            leaves, meta = read_snapshot(path)
            return num, leaves, meta
        except SnapshotError as e:
            print(f"# durability: skipping bad snapshot {path.name}: {e}",
                  file=sys.stderr)
    return None


# --------------------------------------------------------------------------
# params serialization (the snapshot/WAL engine fingerprint)
# --------------------------------------------------------------------------

# the reference's `SLSMParams.backend`, absent from the port's params:
# written as the reference's default so the reference reattaches to (and
# restores) a port directory, and left out of every comparison
REF_BACKEND = "jnp"


def params_to_dict(p: SLSMParams) -> Dict[str, Any]:
    """JSON-safe dict form of an `SLSMParams` (nested `TuningPolicy`
    included) in the reference's field set and order — the engine
    fingerprint stored in the WAL's META record and every snapshot, so
    `restore` can rebuild the configuration without the caller
    re-supplying it. ``backend`` sits after ``range_cand``, where the
    reference declares it."""
    d = {}
    for k, v in dataclasses.asdict(p).items():
        d[k] = v
        if k == "range_cand":
            d["backend"] = REF_BACKEND
    d["eps_per_level"] = (None if p.eps_per_level is None
                          else list(p.eps_per_level))
    return d


def params_from_dict(d: Dict[str, Any]) -> SLSMParams:
    """Inverse of `params_to_dict`, and the port's `SLSMParams` from a
    fingerprint either package wrote: ``backend`` is dropped, lists go
    back to tuples, the tuning dict back to a `TuningPolicy`."""
    d = dict(d)
    d.pop("backend", None)
    tuning = d.get("tuning")
    if isinstance(tuning, dict):
        d["tuning"] = TuningPolicy(**tuning)
    if d.get("eps_per_level") is not None:
        d["eps_per_level"] = tuple(d["eps_per_level"])
    return SLSMParams(**d)


def _fingerprint(meta: Dict[str, Any]) -> Dict[str, Any]:
    """What `ensure_header` compares: the canonical meta without the
    record-format version ``wal`` and without ``params.backend``."""
    out = {k: v for k, v in _canon(meta).items() if k != "wal"}
    if isinstance(out.get("params"), dict):
        out["params"] = {k: v for k, v in out["params"].items()
                         if k != "backend"}
    return out


def _canon(obj: Any) -> Any:
    """JSON-normalized form (tuples->lists etc.) for fingerprint
    comparison between a fresh meta dict and one parsed from the WAL."""
    return json.loads(json.dumps(obj, sort_keys=True))


# --------------------------------------------------------------------------
# the durability manager (what the engines own)
# --------------------------------------------------------------------------

class Durability:
    """One engine's durability surface: its WAL + its snapshot series.

    Owned by an engine (``SLSM(..., durability=...)``): the engine logs
    every write chunk and applied RETUNE through `log_write`/
    `log_retune`, group-commits with `sync` at each engine call (or tape
    window) boundary, and copies its state to a snapshot with
    `snapshot`. A serving loop polls `should_snapshot` in idle gaps so
    that a snapshot's cost never rides a client's window.

    ``fsync=False`` keeps the write+flush (process-crash durability,
    what the injection tests simulate) but skips the disk barrier — for
    tests and benches that do not model power loss.

    ``replica=True`` marks a replication follower's log: the WAL is a
    shipped copy of the leader's stream (bootstrapped from a snapshot +
    tail, extended via `append_frame`), so `ensure_header` never
    injects a local META record — a tail-only log stays a verbatim
    continuation of the leader's seqno stream.

    ``segment_bytes`` (None = a single unbounded ``wal.log``, the
    pre-segmentation behavior) makes `sync` seal the active file into
    ``wal_<first_seqno>.log`` once it exceeds that size; `prune` can
    then delete sealed segments at or below a watermark (a replication
    leader prunes at min(snapshot watermark, min follower ack), a
    standalone engine at its own snapshot watermark)."""

    def __init__(self, directory, *, fsync: bool = True,
                 snapshot_every_bytes: int = 1 << 20,
                 keep_snapshots: int = 2, replica: bool = False,
                 segment_bytes: Optional[int] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        gc_tmp_snapshots(self.dir)
        self.wal_path = self.dir / "wal.log"
        self.fsync = fsync
        self.replica = replica
        self.snapshot_every_bytes = snapshot_every_bytes
        self.keep_snapshots = keep_snapshots
        self.segment_bytes = segment_bytes
        self._writer: Optional[WalWriter] = None
        self._bytes_at_snapshot = len(MAGIC)
        self._sealed_bytes = sum(p.stat().st_size
                                 for _, p in list_segments(self.dir))
        self.last_snapshot_ms = 0.0
        self.counters = collections.Counter(snapshots=0, wal_rolls=0,
                                            wal_pruned_bytes=0,
                                            wal_pruned_segments=0)

    @property
    def writer(self) -> WalWriter:
        """The lazily opened `WalWriter` (opening truncates any torn
        tail; seqnos resume past the log, the newest snapshot's
        watermark, and any sealed segments — and the epoch carries over
        a roll boundary, so a fresh active tail after a failover keeps
        stamping the bumped epoch)."""
        if self._writer is None:
            snaps = list_snapshots(self.dir)
            min_next = snaps[-1][0] + 1 if snaps else 0
            epoch_floor = 0
            segs = list_segments(self.dir)
            if segs:
                recs, _ = read_wal(segs[-1][1])
                if recs:
                    min_next = max(min_next, recs[-1].seqno + 1)
                    epoch_floor = recs[-1].epoch
            self._writer = WalWriter(self.wal_path, min_next_seqno=min_next)
            self._writer.epoch = max(self._writer.epoch, epoch_floor)
        return self._writer

    # -- logging (engine write boundary) -----------------------------------
    def ensure_header(self, meta: Dict[str, Any]) -> None:
        """Write the leading META record on a fresh WAL, or verify an
        existing one matches `meta` — attaching an engine with different
        params or engine kind to a populated durability directory is a
        configuration error, not something replay can paper over.

        The ``"wal"`` record-format version is stripped from both sides
        of the comparison: it versions the WRITE payload codec, not the
        engine, and replay decodes either format — so a v1 (pre-
        weighted) directory reattaches and upgrades in place. So is
        ``params.backend`` (see `REF_BACKEND`): a directory the reference
        wrote with either backend reattaches here.

        A META record is only ever written to a *genuinely fresh* log
        (no records, no snapshot watermark) — a headless log that
        already holds records, or resumes past a watermark, is
        mid-stream (a replica's tail-only bootstrap, or snapshot-only
        recovery) and injecting a META there would corrupt the seqno
        stream; the fingerprint is then verified via the snapshot's
        copy by `restore` instead."""
        w = self.writer
        if w.head is None:
            if self.replica or w.last_seqno >= 0:
                return
            w.append(REC_META, json.dumps(_canon(meta),
                                          sort_keys=True).encode())
            self.sync()
            return
        existing = json.loads(w.head.payload.decode())
        if _fingerprint(existing) != _fingerprint(meta):
            raise ValueError(
                f"durability dir {self.dir} belongs to a different engine "
                f"configuration (logged {existing.get('driver')!r} "
                f"fingerprint does not match this engine)")

    def header_meta(self) -> Optional[Dict[str, Any]]:
        """The decoded META fingerprint of this WAL, or None when the
        log is missing/unreadable — or when pruning removed the genesis
        segment (restore then falls back to the snapshot's copy)."""
        chain = wal_chain(self.dir)
        if not chain:
            return None
        records, _ = read_wal(chain[0])
        if records and records[0].kind == REC_META:
            return json.loads(records[0].payload.decode())
        return None

    def log_write(self, keys, vals, wts) -> int:
        """Buffer one engine-call weighted write chunk; returns its
        seqno. Durable only after the next `sync` (the engine calls it
        before any result of the op can reach a client)."""
        return self.writer.append(REC_WRITE2, encode_write(keys, vals, wts))

    def append_frame(self, frame: bytes) -> int:
        """Buffer one leader-framed record verbatim (the replication
        follower path — see `WalWriter.append_frame`): leader-assigned
        seqno/epoch stamps are preserved, so the follower's log is a
        bitwise copy of the leader's stream. Durable after `sync`."""
        return self.writer.append_frame(frame)

    def log_retune(self, target: str) -> int:
        """Buffer one applied tuner allocation switch; returns its
        seqno. Replay re-applies it so a restored adaptive engine
        carries the allocation its WAL position had (answers are
        invariant either way)."""
        return self.writer.append(REC_RETUNE, target.encode())

    def sync(self) -> None:
        """Group commit: flush every buffered record in one write (+ one
        fsync unless configured off), then seal the active file into a
        segment if it outgrew ``segment_bytes``."""
        self.writer.sync(fsync=self.fsync)
        self._maybe_roll()

    def _maybe_roll(self) -> None:
        """Seal the active ``wal.log`` into ``wal_<first_seqno>.log``
        once it exceeds ``segment_bytes`` and start a fresh active tail
        continuing the same seqno/epoch stream. Only ever called right
        after a sync, so the sealed file is complete and durable."""
        if self.segment_bytes is None or self._writer is None:
            return
        w = self._writer
        if w.size < self.segment_bytes or w.first_seqno_in_file is None:
            return
        first, nxt, epoch = w.first_seqno_in_file, w.next_seqno, w.epoch
        w.close()
        sealed = self.dir / f"wal_{first}.log"
        os.rename(self.wal_path, sealed)
        self._sealed_bytes += os.path.getsize(sealed)
        self.counters["wal_rolls"] += 1
        nw = WalWriter(self.wal_path, min_next_seqno=nxt)
        nw.epoch = epoch
        self._writer = nw

    def prune(self, upto_seqno: int) -> int:
        """Delete every sealed segment whose records all have ``seqno <=
        upto_seqno`` (the active tail is never touched). The caller owns
        the watermark discipline: a standalone engine passes
        `prune_floor` (its newest snapshot's seqno), a replication
        leader additionally floors it at the minimum follower ack so a
        bootstrap of any attached follower still finds its tail.
        Returns the number of segments deleted."""
        segs = list_segments(self.dir)
        if not segs:
            return 0
        # a sealed segment's last seqno = the next chain file's first - 1
        # (the chain is gapless); the final sealed segment is bounded by
        # the active tail's first record, or decoded directly if the
        # active tail is still empty
        firsts = [f for f, _ in segs]
        active_first = (self._writer.first_seqno_in_file
                        if self._writer is not None
                        else _first_seqno(self.wal_path))
        bounds = firsts[1:] + [active_first]
        n = 0
        for (first, p), nxt_first in zip(segs, bounds):
            if nxt_first is not None:
                last = nxt_first - 1
            else:
                recs, _ = read_wal(p)
                last = recs[-1].seqno if recs else None
            if last is None or last > upto_seqno:
                break
            sz = os.path.getsize(p)
            os.remove(p)
            self._sealed_bytes -= sz
            self.counters["wal_pruned_bytes"] += sz
            self.counters["wal_pruned_segments"] += 1
            n += 1
        return n

    def prune_floor(self) -> int:
        """Highest seqno local recovery no longer needs from the WAL:
        the newest snapshot's watermark (-1 when no snapshot exists —
        then nothing may be pruned)."""
        snaps = list_snapshots(self.dir)
        return snaps[-1][0] if snaps else -1

    def read_records(self) -> List[WalRecord]:
        """Decode the retained record stream — the whole segment chain,
        sealed files then the active tail — without opening a writer
        (pure read: a torn tail is ignored here, truncated only when a
        writer attaches)."""
        return read_wal_chain(self.dir)[0]

    # -- snapshots ----------------------------------------------------------
    @property
    def log_bytes(self) -> int:
        """Monotone bytes ever logged through this directory's WAL
        stream (active + sealed + already-pruned) — the growth measure
        `should_snapshot` compares, immune to rolls and prunes shrinking
        the on-disk footprint."""
        w_size = self._writer.size if self._writer else (
            os.path.getsize(self.wal_path) if self.wal_path.exists() else 0)
        return (self._sealed_bytes + int(self.counters["wal_pruned_bytes"])
                + w_size)

    def should_snapshot(self) -> bool:
        """Has the WAL grown `snapshot_every_bytes` past the last
        snapshot? (The governor's idle-gap trigger.) False until the
        writer exists — an engine that never logged has nothing to
        snapshot."""
        if self._writer is None:
            return False
        return (self.log_bytes
                - self._bytes_at_snapshot) >= self.snapshot_every_bytes

    def snapshot(self, drv) -> Path:
        """Copy `drv`'s whole state to the host as one atomic snapshot
        stamped with the current WAL seqno watermark (everything logged
        is synced first, so snapshot seqno S == "records <= S are fully
        reflected in these leaves"). The leaves are the reference's, in
        its order and dtypes (`convert.state_to_leaves`). Returns the
        published path."""
        from repro_torch import convert     # convert imports this module
        t0 = time.perf_counter()
        self.sync()
        seqno = self.writer.last_seqno
        leaves = convert.state_to_leaves(drv.state)
        meta = {"seqno": seqno, **drv._snapshot_meta()}
        path = write_snapshot(self.dir, seqno, leaves, meta,
                              keep_last=self.keep_snapshots)
        self._bytes_at_snapshot = self.log_bytes
        self.counters["snapshots"] += 1
        self.last_snapshot_ms = (time.perf_counter() - t0) * 1e3
        return path

    # -- telemetry / lifecycle ----------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Durability telemetry: WAL size/record/sync counters, snapshot
        count, last snapshot wall-time, bytes logged since the last
        snapshot (the `should_snapshot` residual), and the segmentation
        ledger (sealed segments on disk, rolls, pruned bytes/segments)."""
        active = self._writer.size if self._writer else (
            os.path.getsize(self.wal_path) if self.wal_path.exists() else 0)
        return {
            "wal_bytes": int(self._sealed_bytes + active),
            "wal_active_bytes": int(active),
            "wal_segments": len(list_segments(self.dir)),
            "wal_rolls": int(self.counters["wal_rolls"]),
            "wal_pruned_bytes": int(self.counters["wal_pruned_bytes"]),
            "wal_pruned_segments": int(self.counters["wal_pruned_segments"]),
            "wal_records": int(self._writer.records if self._writer else 0),
            "wal_syncs": int(self._writer.syncs if self._writer else 0),
            "replica": bool(self.replica),
            "snapshots": int(self.counters["snapshots"]),
            "snapshot_ms_last": float(self.last_snapshot_ms),
            "bytes_since_snapshot": int(max(0, self.log_bytes
                                            - self._bytes_at_snapshot)),
        }

    def close(self) -> None:
        """Flush and release the WAL file handle (idempotent)."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def as_durability(spec) -> Optional[Durability]:
    """Engine-constructor coercion: None passes through, a `Durability`
    passes through, a path becomes ``Durability(path)`` with defaults."""
    if spec is None or isinstance(spec, Durability):
        return spec
    return Durability(spec)
