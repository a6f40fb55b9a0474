"""Closed-loop multi-client load generator (port of `repro.serve.loadgen`).

Offered load in a closed loop is the number of concurrent clients, each
with exactly one request outstanding: a client submits, waits for its
reply, then immediately submits its next request. Sweeping the client
count sweeps the offered load — and, in the batching server, the
coalescing window's natural size, since a window can hold at most one
request per blocked client.

`closed_loop` runs one fixed request stream at one concurrency level
against one server, synchronously: each round submits the next request
of every idle client, then pumps with ``force=True`` — with every live
client blocked, the input stream is momentarily exhausted, which is
exactly the condition the adaptive time trigger exists to detect in an
open system (the closed loop just reaches it with zero wait). The
stream is re-partitioned round-robin across the clients, so every sweep
point serves the *same total ops* — throughput numbers differ only by
dispatch strategy and window size, not by workload.

Results come back phase-style (ops/s plus enqueue->reply latency
percentiles).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np


class Request(NamedTuple):
    """One client request of a stream: ``kind`` (insert / delete /
    lookup / range), ``keys`` (range: lo bounds) and ``vals`` (insert:
    values, range: hi bounds, else None). `closed_loop` takes any object
    with these three attributes."""
    kind: str
    keys: np.ndarray
    vals: Optional[np.ndarray] = None


def closed_loop(server, requests: Sequence, concurrency: int,
                clock=time.perf_counter) -> Dict[str, Any]:
    """Serve `requests` at `concurrency` clients, one outstanding each.

    ``requests`` is a stream-ordered sequence of objects with
    ``kind``/``keys``/``vals`` attributes (a `Request`, say); it is
    re-partitioned round-robin over
    ``concurrency`` virtual clients. Returns the phase-style summary:
    ``{clients, ops, requests, wall_s, ops_per_s, requests_per_s,
    p50_us, p99_us, p999_us, max_stall_us, windows, dispatches}``.
    """
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    queues: List[List] = [list(requests[i::concurrency])
                          for i in range(concurrency)]
    cursors = [0] * concurrency
    outstanding: List[Any] = [None] * concurrency
    total = sum(len(q) for q in queues)
    done = 0
    win0 = server.counters["windows"]
    disp0 = server.counters["dispatches"]
    lat: List[float] = []
    n_ops = 0
    t0 = clock()
    while done < total:
        for c in range(concurrency):
            if outstanding[c] is None and cursors[c] < len(queues[c]):
                r = queues[c][cursors[c]]
                outstanding[c] = server.submit(f"client-{c}", r.kind,
                                               r.keys, r.vals)
                cursors[c] += 1
        server.pump(force=True)
        for c in range(concurrency):
            t = outstanding[c]
            if t is not None and t.done:
                lat.append(t.latency_s)
                n_ops += t.n_ops
                outstanding[c] = None
                done += 1
    wall = clock() - t0
    ts = np.asarray(lat, np.float64) * 1e6
    return {
        "clients": int(concurrency),
        "ops": int(n_ops),
        "requests": int(total),
        "wall_s": float(wall),
        "ops_per_s": float(n_ops / wall) if wall > 0 else 0.0,
        "requests_per_s": float(total / wall) if wall > 0 else 0.0,
        "p50_us": float(np.percentile(ts, 50)),
        "p99_us": float(np.percentile(ts, 99)),
        "p999_us": float(np.percentile(ts, 99.9)),
        "max_stall_us": float(ts.max()),
        "windows": int(server.counters["windows"] - win0),
        "dispatches": int(server.counters["dispatches"] - disp0),
    }


def sustained_at_slo(sweep: Sequence[Dict[str, Any]],
                     slo_p99_us: float) -> float:
    """Sustained throughput at the p99 SLO: the best ops/s among sweep
    points whose p99 enqueue->reply latency meets the target (0.0 when
    no offered-load point meets it)."""
    ok = [pt["ops_per_s"] for pt in sweep if pt["p99_us"] <= slo_p99_us]
    return float(max(ok)) if ok else 0.0
