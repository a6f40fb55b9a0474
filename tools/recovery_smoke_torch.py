#!/usr/bin/env python
"""Crash-recovery smoke on the PyTorch port: SIGKILL a live serving
process, restore, prove oracle-exact answers (the twin of
`tools/recovery_smoke.py`, over `repro_torch`; DESIGN.md §12).

Parent/child harness in one file:

  * child (``--child``): runs a durable continuous-batching server
    (`repro_torch.serve.Server` over `SLSM` + `repro_torch.engine.wal.Durability`,
    fsync on) against an unbounded deterministic op stream — one
    submitted request + one forced pump per op, a plain idle pump every
    few windows so the maintenance governor takes its snapshot trigger.
    It never exits on its own.
  * parent (default): spawns the child, waits until the WAL has real
    traffic, then SIGKILLs it mid-window — no shutdown hook, no flush,
    the honest crash. It then `SLSM.restore()`s the durability dir and
    replays the *decoded durable WRITE records* through a fresh
    non-durable engine's public insert/delete API (the serving tape
    re-chunks requests, so the WAL's record stream — not the submitted
    op stream — is the durable truth), asserting bitwise-equal
    full-keyspace lookups and range sweeps. The restore stall must be
    reported as first-class telemetry (``restore_us`` in the engine
    stats, surfaced through ``Server.stats()["engine"]``).

Exit 0 == recovery is crash-exact. Any mismatch, missing telemetry, or
unreadable-but-nonempty WAL is a hard failure.

Both processes run on the CUDA card unless given ``--device cpu``; the
child gets the parent's device.

Usage:
    python tools/recovery_smoke_torch.py [--kill-after-bytes N] [--dir DIR]
                                         [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

from repro_torch.core.params import SLSMParams  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402
from repro_torch.engine.engine import SLSM  # noqa: E402

# the stream runs unbounded, so the live key set must stay well under
# the tiny tree's deepest-level capacity (512 at this geometry):
# newest-wins dedup bounds live elements by the keyspace + in-flight
# negative-weight delete records
KEY_SPACE = 300
OP_SIZE = 48


def params() -> SLSMParams:
    """Tiny geometry (as in tests/durability): a few hundred ops cover
    seals, flushes, and spills, so the kill lands on a busy tree."""
    return SLSMParams(R=2, Rn=32, eps=1e-2, D=2, m=1.0, mu=16, max_levels=3,
                      max_range=2048, merge_budget=1)


def op(i: int):
    """The i-th op of the unbounded deterministic stream (same math in
    child and parent — the oracle replays exactly what the child fed).
    Every 4th op is a delete batch (weight -1 WAL records); one op ==
    one driver call == one WAL WRITE record."""
    rng = np.random.default_rng(100_000 + i)
    keys = rng.integers(0, KEY_SPACE, OP_SIZE).astype(np.int32)
    if i % 4 == 3:
        return ("delete", keys[:OP_SIZE // 3], None)
    vals = rng.integers(0, 1 << 20, OP_SIZE).astype(np.int32)
    return ("insert", keys, vals)


def probe(drv):
    """The oracle-comparison read set (full-keyspace stride lookup +
    range sweep), as plain numpy."""
    qs = np.arange(0, KEY_SPACE, dtype=np.int32)
    v, f = drv.lookup_many(qs)
    ranges = [drv.range(lo, hi)
              for lo, hi in ((0, KEY_SPACE), (17, 80), (100, 250))]
    return (np.asarray(v), np.asarray(f),
            [(np.asarray(k), np.asarray(vv)) for k, vv in ranges])


def run_child(durdir: str, device: str) -> None:
    """Serve the deterministic stream forever (until killed)."""
    from repro_torch.serve.server import Server

    dur = WAL.Durability(durdir, fsync=True, snapshot_every_bytes=16_384)
    drv = SLSM(params(), durability=dur, device=device)
    srv = Server(drv)
    i = 0
    while True:
        kind, keys, vals = op(i)
        if kind == "insert":
            srv.submit("smoke", "insert", keys, vals)
        else:
            srv.submit("smoke", "delete", keys)
        srv.pump(force=True)       # one served + group-committed window
        if i % 8 == 7:
            srv.pump()             # idle gap: the governor may snapshot
        i += 1


def run_parent(durdir: str, kill_after_bytes: int, device: str) -> int:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--dir", durdir, "--device", device], env=env)
    wal_path = os.path.join(durdir, "wal.log")
    try:
        deadline = time.time() + 300
        while time.time() < deadline:
            if (os.path.exists(wal_path)
                    and os.path.getsize(wal_path) >= kill_after_bytes):
                break
            if child.poll() is not None:
                print("FAIL: child exited before the kill "
                      f"(rc={child.returncode})")
                return 1
            time.sleep(0.05)
        else:
            print("FAIL: child never produced enough WAL traffic")
            return 1
        # land mid-window, not at a tidy boundary
        time.sleep(0.15)
        child.send_signal(signal.SIGKILL)
        child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    print(f"killed serving child at {os.path.getsize(wal_path)} WAL bytes")
    records, good = WAL.read_wal(wal_path)
    torn = os.path.getsize(wal_path) - good
    writes = [r for r in records if r.kind in WAL.WRITE_KINDS]
    snaps = WAL.list_snapshots(durdir)
    n_neg = 0
    print(f"durable prefix: {len(records)} records ({len(writes)} write "
          f"chunks), {torn} torn tail bytes, {len(snaps)} snapshot(s)")
    if not writes:
        print("FAIL: nothing durable reached the log before the kill")
        return 1

    t0 = time.perf_counter()
    restored = SLSM.restore(durdir, device=device)
    restore_ms = (time.perf_counter() - t0) * 1e3

    # the oracle: a fresh non-durable engine fed the decoded durable
    # chunks in log order through the public API (negative-weight lanes
    # are deletes — the engine's own on-log delete encoding)
    oracle = SLSM(params(), device=device)
    for rec in writes:
        k, v, w = WAL.decode_write(rec.payload, rec.kind)
        is_del = w <= 0
        n_neg += int(is_del.sum())
        start = 0
        for i in range(1, len(k) + 1):       # runs of same op kind,
            if i == len(k) or is_del[i] != is_del[start]:   # order kept
                if is_del[start]:
                    oracle.delete(k[start:i])
                else:
                    oracle.insert(k[start:i], v[start:i])
                start = i
    if n_neg == 0:
        print("FAIL: the durable WAL prefix carries no negative-weight "
              "records — the kill landed before any delete was logged")
        return 1

    gv, gf, gr = probe(restored)
    wv, wf, wr = probe(oracle)
    if not (np.array_equal(gf, wf) and np.array_equal(gv, wv)):
        print("FAIL: restored lookups diverge from the oracle")
        return 1
    for (gk, gvv), (wk, wvv) in zip(gr, wr):
        if not (np.array_equal(gk, wk) and np.array_equal(gvv, wvv)):
            print("FAIL: restored range scans diverge from the oracle")
            return 1

    # the restore stall is first-class stats() telemetry
    from repro_torch.serve.server import Server
    st = Server(restored).stats()
    reported_us = st["engine"].get("restore_us", 0)
    if not reported_us > 0:
        print("FAIL: restore_us missing from stats()")
        return 1
    print(f"OK: restore is oracle-exact at chunk boundary {len(writes)} "
          f"(replayed {restored.stats['replayed_records']} records, "
          f"{n_neg} negative-weight lanes, restore {restore_ms:.0f}ms, "
          f"stats restore_us={reported_us})")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--kill-after-bytes", type=int, default=24_000,
                    help="WAL size that triggers the SIGKILL")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.child:
        run_child(args.dir, args.device)
        return 0
    if args.dir is not None:
        os.makedirs(args.dir, exist_ok=True)
        return run_parent(args.dir, args.kill_after_bytes, args.device)
    with tempfile.TemporaryDirectory(prefix="recovery_smoke_") as d:
        return run_parent(d, args.kill_after_bytes, args.device)


if __name__ == "__main__":
    sys.exit(main())
