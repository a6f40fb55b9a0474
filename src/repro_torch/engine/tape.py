"""Mixed-op tape: a coalesced window of write, lookup and range chunks.

The port of `repro.engine.tape` (reference DESIGN.md §11). The reference
lowers a window to one `lax.scan` over T tagged slots; the port runs the
same slots in a host loop, in stream order, through the engine's own
ops — which the reference holds bitwise-equal to the ops one by one, so
the loop is a faithful form of it:

  opcode (T,) i32        OP_NOP | OP_WRITE | OP_LOOKUP | OP_RANGE
  keys   (T, Rn) i32     write keys / lookup queries / range los lanes
  vals   (T, Rn) i32     write values / range his
  wts    (T, Rn) i32     write record weights (+1 insert, -1 delete)
  n_valid (T,) i32       live lanes in the slot

A write slot stages its lanes and seals when the staging count reaches
Rn — nothing more: flush, spill, compact and retune stay host steps
between tapes. `SLSM.run_tape`'s headroom pass guarantees a free run
slot for every seal a tape can make (`tape_seal_bound`). A lookup slot
is `read_path.lookup_many` over its Rn lanes, a range slot
`read_path.range_many` over its `range_lanes(p)` windows. Slot results
stay on the engine's device until the tape ends and come to the host in
one transfer (`exec_tape`).
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.params import KEY_EMPTY, SLSMParams
from repro_torch.engine import read_path as RP
from repro_torch.engine.batching import tape_bucket
from repro_torch.engine.memtable import stage_append

# slot opcodes (NOP pads tapes to their bucket width)
OP_NOP, OP_WRITE, OP_LOOKUP, OP_RANGE = 0, 1, 2, 3

OPCODES = {"write": OP_WRITE, "lookup": OP_LOOKUP, "range": OP_RANGE}


def range_lanes(p: SLSMParams) -> int:
    """Range (lo, hi) lanes a tape slot carries."""
    return min(4, p.Rn)


class TapeChunk(NamedTuple):
    """One coalesced same-kind op chunk, host-side.

    kind: 'write' | 'lookup' | 'range'. Writes: `keys`/`vals` the staged
    pairs, `wts` the record weights (+1 insert, -1 delete; None = all
    +1), at most Rn. Lookups: `keys` the queries, at most Rn. Ranges:
    `keys` the lo bounds and `vals` the hi bounds, at most
    `range_lanes(p)` scans.
    """
    kind: str
    keys: np.ndarray
    vals: np.ndarray
    wts: np.ndarray | None = None


def chunk_capacity(p: SLSMParams, kind: str) -> int:
    """Max ops one tape slot of `kind` carries."""
    return range_lanes(p) if kind == "range" else p.Rn


def build_tape(p: SLSMParams, chunks: Sequence[TapeChunk],
               slots: int | None = None):
    """Pack host chunks into the tape's padded slot arrays: ``(opcodes
    (T,), keys (T, Rn), vals (T, Rn), wts (T, Rn), n_valid (T,))`` numpy
    with ``T = tape_bucket(len(chunks))`` (or `slots`); slots past the
    chunk list are NOP."""
    n = len(chunks)
    t = tape_bucket(n) if slots is None else slots
    if n > t:
        raise ValueError(f"{n} chunks exceed the {t}-slot tape")
    rn = p.Rn
    ops = np.zeros(t, np.int32)
    keys = np.full((t, rn), KEY_EMPTY, np.int32)
    vals = np.zeros((t, rn), np.int32)
    wts = np.zeros((t, rn), np.int32)
    nv = np.zeros(t, np.int32)
    for i, ch in enumerate(chunks):
        cap = chunk_capacity(p, ch.kind)
        k = np.asarray(ch.keys, np.int32).reshape(-1)
        v = np.asarray(ch.vals, np.int32).reshape(-1)
        if len(k) > cap:
            raise ValueError(
                f"{ch.kind} chunk of {len(k)} ops exceeds its per-slot "
                f"capacity {cap}")
        ops[i] = OPCODES[ch.kind]
        keys[i, :len(k)] = k
        vals[i, :len(v)] = v
        if ch.kind == "write":
            w = (np.ones(len(k), np.int32) if ch.wts is None
                 else np.asarray(ch.wts, np.int32).reshape(-1))
            wts[i, :len(w)] = w
        nv[i] = len(k)
    return ops, keys, vals, wts, nv


def exec_tape(eng, ops, keys, vals, wts, nv, sparse: bool = False):
    """Run a packed tape on engine `eng` slot by slot, in stream order.

    Returns the per-slot outputs ``(lookup vals (T, Rn), lookup found,
    range keys (T, rb, max_range), range vals, range counts (T, rb),
    range truncated, seals (T,))`` as numpy — written on the engine's
    device and moved to the host in one transfer at the end. NOP slots
    and the planes a slot's kind does not produce are zeros (range keys
    KEY_EMPTY). Lookup slots take the engine's `skip_empty` and the
    stored run occupancy (`SLSM.runs`), as `SLSM.lookup_many` does."""
    p = eng.p_active
    rb, mr = range_lanes(p), p.max_range
    t, rn = keys.shape
    dev = eng.device
    out_lv = torch.zeros((t, rn), dtype=torch.int32, device=dev)
    out_lf = torch.zeros((t, rn), dtype=torch.bool, device=dev)
    out_rk = torch.full((t, rb, mr), int(KEY_EMPTY), dtype=torch.int32,
                        device=dev)
    out_rv = torch.zeros((t, rb, mr), dtype=torch.int32, device=dev)
    out_rc = torch.zeros((t, rb), dtype=torch.int32, device=dev)
    out_rt = torch.zeros((t, rb), dtype=torch.bool, device=dev)
    sealed = np.zeros(t, np.int32)
    lanes = eng._tensor(np.stack([keys, vals, wts]))
    for i in range(t):
        op, n = int(ops[i]), int(nv[i])
        if op == OP_WRITE:
            eng.state = stage_append(p, eng.state, lanes[0, i], lanes[1, i],
                                     lanes[2, i], n)
            if int(eng.state.stage_count) >= p.Rn:
                eng.scheduler.seal()
                sealed[i] = 1
        elif op == OP_LOOKUP:
            out_lv[i], out_lf[i] = RP.lookup_many(
                p, eng.state, lanes[0, i], n, sparse, eng.tuner.enabled,
                eng.runs)
        elif op == OP_RANGE:
            out_rk[i], out_rv[i], out_rc[i], out_rt[i] = RP.range_many(
                p, eng.state, lanes[0, i, :rb], lanes[1, i, :rb], n)
    planes = (out_lv, out_lf, out_rk, out_rv, out_rc, out_rt)
    flat = torch.cat([x.reshape(-1).to(torch.int32) for x in planes]).cpu()
    host, off = [], 0
    for x in planes:
        host.append(flat[off:off + x.numel()].numpy().reshape(x.shape)
                    .astype(np.bool_ if x.dtype == torch.bool else np.int32))
        off += x.numel()
    return (*host, sealed)


def unpack_tape(p: SLSMParams, chunks: Sequence[TapeChunk], ys) -> List:
    """Per-chunk host results from a tape's stacked outputs, slot i's
    lanes trimmed to chunk i's op count: writes -> the seal count (int);
    lookups -> ``(vals (n,), found (n,))``; ranges -> ``(keys (n,
    max_range), vals, counts (n,), truncated (n,))``."""
    lv, lf, rk, rv, rc, rt, sealed = ys
    out = []
    for i, ch in enumerate(chunks):
        n = len(np.asarray(ch.keys).reshape(-1))
        if ch.kind == "write":
            out.append(int(sealed[i]))
        elif ch.kind == "lookup":
            out.append((lv[i, :n], lf[i, :n]))
        else:
            out.append((rk[i, :n], rv[i, :n], rc[i, :n], rt[i, :n]))
    return out


def write_lanes(ch: TapeChunk):
    """A write chunk's (keys, vals, wts) as int32 arrays (wts None: +1)."""
    k = np.asarray(ch.keys, np.int32).reshape(-1)
    w = (np.ones_like(k) if ch.wts is None
         else np.asarray(ch.wts, np.int32).reshape(-1))
    return k, np.asarray(ch.vals, np.int32).reshape(-1), w


def log_write_chunks(durability, chunks: Sequence[TapeChunk]) -> None:
    """One WAL record a non-empty write chunk, in stream order (the
    engines sync once the window's results are ready: log-before-ack)."""
    for ch in chunks:
        if ch.kind == "write":
            k, v, w = write_lanes(ch)
            if k.size:
                durability.log_write(k, v, w)


def take_segment(work: list, budget: int):
    """Pop the chunks of one tape segment off `work` ((chunk index,
    chunk) pairs in stream order): reads freely, writes while `budget`
    write keys last. A write larger than what is left is split; its tail
    stays at the head of `work` under the same index. Returns ``(seg,
    seg_idx)``; raises if no chunk fits."""
    seg, seg_idx = [], []
    while work:
        i, ch = work[0]
        if ch.kind == "write":
            if budget <= 0:
                break
            k, v, w = write_lanes(ch)
            if k.size > budget:
                seg.append(TapeChunk("write", k[:budget], v[:budget],
                                     w[:budget]))
                seg_idx.append(i)
                work[0] = (i, TapeChunk("write", k[budget:], v[budget:],
                                        w[budget:]))
                budget = 0
                continue
            budget -= k.size
        seg.append(ch)
        seg_idx.append(i)
        work.pop(0)
    if not seg:
        raise RuntimeError("tape segmentation made no progress")
    return seg, seg_idx


def tape_seal_bound(p: SLSMParams, stage_count: int,
                    chunks: Sequence[TapeChunk]) -> int:
    """Upper bound on the seals a tape can make: one every Rn staged keys
    (dedup only lowers the true count)."""
    staged = stage_count + sum(
        len(np.asarray(c.keys).reshape(-1)) for c in chunks
        if c.kind == "write")
    return staged // p.Rn
