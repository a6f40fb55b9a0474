"""Hazard-ordered request coalescing: tickets in, tape chunks out (port
of `repro.serve.coalescer`: a pure function of the ticket stream, so its
chunks and placements are bitwise the reference's).

The server's window holds a stream-ordered list of per-client requests
(`server.Ticket`). This module folds that stream into the mixed-op tape's
chunk form (`repro_torch.engine.tape.TapeChunk`) under one rule — **only
adjacent same-kind ops merge**. A lookup never moves past the write
submitted before it and never behind the write submitted after it, so
executing the coalesced chunks in order through the tape is
bitwise-equivalent to executing every request sequentially through the
per-op engine calls.

Request kinds map onto tape op kinds:

  insert -> write  (keys/vals as submitted, weight +1 lanes)
  delete -> write  (weight -1 lanes with payload 0 — the Z-set
                    retraction; deletes therefore
                    coalesce WITH adjacent inserts)
  lookup -> lookup
  range  -> range  (keys = lo bounds, vals = hi bounds)

Chunks are bounded by `tape.chunk_capacity` (Rn lanes for write/lookup
slots, `range_lanes` windows for range slots); a request larger than the
remaining capacity splits across chunks — order-neutral, since the
split pieces stay adjacent. `Placement` records where each ticket's ops
landed so `scatter` can route the tape's per-chunk results back to the
tickets that asked for them.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

from repro_torch.core.params import SLSMParams
from repro_torch.engine import tape as TP

# request kind -> tape op kind (deletes are weight -1 writes, so they
# coalesce with adjacent inserts into one write chunk)
OP_OF = {"insert": "write", "delete": "write",
         "lookup": "lookup", "range": "range"}


class Placement(NamedTuple):
    """Where one contiguous piece of a ticket's ops landed.

    ``chunk``/``lane``/``n`` locate the piece inside the coalesced chunk
    list; ``off`` is its offset inside the ticket's own op array (a
    ticket larger than a chunk's remaining capacity spans several
    placements)."""
    chunk: int
    lane: int
    n: int
    off: int


def coalesce(p: SLSMParams, tickets: Sequence
             ) -> Tuple[List[TP.TapeChunk], List[List[Placement]]]:
    """Fold a stream-ordered ticket list into tape chunks.

    Returns ``(chunks, placements)``: ``chunks`` is the capacity-bounded
    `TapeChunk` list (stream order preserved; only adjacent same-kind
    ops merged), ``placements[i]`` locates ticket i's ops inside it.
    """
    chunks: List[TP.TapeChunk] = []
    placements: List[List[Placement]] = []
    cur_kind: str | None = None
    cur_keys: List[np.ndarray] = []
    cur_vals: List[np.ndarray] = []
    cur_wts: List[np.ndarray] = []
    cur_len = 0

    def close() -> None:
        nonlocal cur_kind, cur_keys, cur_vals, cur_wts, cur_len
        if cur_kind is not None:
            w = (np.concatenate(cur_wts) if cur_kind == "write" else None)
            chunks.append(TP.TapeChunk(cur_kind, np.concatenate(cur_keys),
                                       np.concatenate(cur_vals), w))
            cur_kind, cur_keys, cur_vals, cur_wts, cur_len = (
                None, [], [], [], 0)

    for t in tickets:
        kind = OP_OF[t.kind]
        keys = np.asarray(t.keys, np.int32).reshape(-1)
        if t.kind == "delete":
            vals = np.zeros_like(keys)
            wts = np.full_like(keys, -1)
        elif t.kind == "lookup":
            vals = np.zeros_like(keys)
            wts = np.zeros_like(keys)
        else:
            vals = np.asarray(t.vals, np.int32).reshape(-1)
            wts = np.ones_like(keys)
        cap = TP.chunk_capacity(p, kind)
        place: List[Placement] = []
        off = 0
        while off < len(keys):
            if cur_kind != kind:          # hazard boundary: close, reopen
                close()
                cur_kind = kind
            take = min(cap - cur_len, len(keys) - off)
            if take == 0:                 # chunk full: next one
                close()
                cur_kind = kind
                continue
            cur_keys.append(keys[off:off + take])
            cur_vals.append(vals[off:off + take])
            cur_wts.append(wts[off:off + take])
            place.append(Placement(len(chunks), cur_len, take, off))
            cur_len += take
            off += take
        placements.append(place)
    close()
    return chunks, placements


def scatter(tickets: Sequence, placements: Sequence[Sequence[Placement]],
            results: Sequence) -> None:
    """Route the tape's per-chunk results back onto each ticket.

    Sets ``ticket.result``: writes (insert/delete) -> None; lookups ->
    ``(vals, found)`` over the ticket's queries; ranges -> ``(keys,
    vals, counts, truncated)`` rows for the ticket's windows — exactly
    the shapes `SLSM.lookup_many` / `SLSM.range_many` return, so serving
    a request and calling the driver directly are interchangeable.
    """
    for t, place in zip(tickets, placements):
        if OP_OF[t.kind] == "write":
            t.result = None
            continue
        parts = [tuple(arr[pl.lane:pl.lane + pl.n]
                       for arr in results[pl.chunk]) for pl in place]
        t.result = tuple(np.concatenate(plane) for plane in zip(*parts))
