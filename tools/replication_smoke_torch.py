#!/usr/bin/env python
"""Replication failover smoke on the PyTorch port: SIGKILL a live
replicating leader process mid-stream, promote the follower, prove
answer-exact failover (the twin of `tools/replication_smoke.py`, over
`repro_torch`; DESIGN.md §14).

Parent/child harness in one file:

  * child (``--child``): a durable continuous-batching leader server
    (`repro_torch.serve.Server(role="leader")` over `SLSM` + fsync WAL)
    whose engine carries a `repro_torch.engine.replication.Leader`. It bootstraps
    the follower directory, dials the parent's socket listener, and
    serves an unbounded deterministic op stream — every pump seam ships
    the window's durable frames. It never exits on its own.
  * parent (default): listens on a localhost socket, accepts the
    child's connection, opens a `Follower` over the bootstrapped
    directory, and applies the live stream. Once enough records have
    applied it SIGKILLs the child mid-stream — no shutdown hook, the
    honest leader death — pumps the torn remainder, and `promote()`s.
    The promoted engine must answer bitwise like a fresh non-durable
    engine fed the *decoded durable WRITE prefix of the follower's own
    WAL* (the acked prefix — exactly what clients were told happened),
    and must immediately accept writes at the bumped epoch.

Exit 0 == failover is answer-exact. Any mismatch, a follower that
applied records its WAL doesn't hold, or a promoted engine that
rejects writes is a hard failure.

``--partition`` runs the self-healing twin (DESIGN.md §15): the leader child is *partitioned, not killed* —
SIGSTOP freezes it mid-stream, so its lease heartbeats stop while the
process lives. The parent's follower (``auto_promote=True``, real
clock) must promote itself automatically within the lease bound. Then
SIGCONT: the revived old leader keeps serving until the promoted
successor's bumped-epoch fence ack reaches it, fences itself (writes
raise, ship inert), re-bootstraps from the new leader as a follower,
and must serve reads bitwise-equal to the new leader. Exit 0 == all of
automatic promotion, fencing, and the rejoined replica's answers hold.

Every process runs on the CUDA card unless given ``--device cpu``; each
child gets the parent's device.

Usage:
    python tools/replication_smoke_torch.py [--kill-after-records N]
    python tools/replication_smoke_torch.py --partition [--lease-s S]
    (either with --device cpu)
"""
from __future__ import annotations

import argparse
import json
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
from repro_torch.engine import replication as R  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402
from repro_torch.engine.engine import SLSM  # noqa: E402

KEY_SPACE = 300
OP_SIZE = 48
BOOT_PREFIX = 6       # ops the child absorbs before bootstrapping


def params() -> SLSMParams:
    """Tiny geometry (as in tests/replication): a few hundred ops cover
    seals, flushes, and spills, so the kill lands on a busy tree."""
    return SLSMParams(R=2, Rn=32, eps=1e-2, D=2, m=1.0, mu=16, max_levels=3,
                      max_range=2048, merge_budget=1)


def op(i: int):
    """The i-th op of the unbounded deterministic stream (same math in
    child and parent); every 4th op deletes. One op == one WAL WRITE
    record."""
    rng = np.random.default_rng(200_000 + i)
    keys = rng.integers(0, KEY_SPACE, OP_SIZE).astype(np.int32)
    if i % 4 == 3:
        return ("delete", keys[:OP_SIZE // 3], None)
    vals = rng.integers(0, 1 << 20, OP_SIZE).astype(np.int32)
    return ("insert", keys, vals)


def probe(drv):
    """Full-keyspace stride lookup + range sweep, as plain numpy."""
    qs = np.arange(0, KEY_SPACE, dtype=np.int32)
    v, f = drv.lookup_many(qs)
    ranges = [drv.range(lo, hi)
              for lo, hi in ((0, KEY_SPACE), (17, 80), (100, 250))]
    return (np.asarray(v), np.asarray(f),
            [(np.asarray(k), np.asarray(vv)) for k, vv in ranges])


def run_child(leader_dir: str, fol_dir: str, port: int, device: str) -> None:
    """Bootstrap the follower dir, dial the parent, then serve (and
    ship) the deterministic stream forever (until killed)."""
    from repro_torch.serve.server import Server

    dur = WAL.Durability(leader_dir, fsync=True,
                         snapshot_every_bytes=1 << 30)
    drv = SLSM(params(), durability=dur, device=device)
    leader = R.Leader(drv)
    srv = Server(drv, role="leader")
    i = 0
    for i in range(BOOT_PREFIX):
        kind, keys, vals = op(i)
        if kind == "insert":
            srv.submit("smoke", "insert", keys, vals)
        else:
            srv.submit("smoke", "delete", keys)
        srv.pump(force=True)
    cursor = leader.bootstrap(fol_dir)
    leader.attach(R.connect("127.0.0.1", port), cursor)
    i = BOOT_PREFIX
    while True:
        kind, keys, vals = op(i)
        if kind == "insert":
            srv.submit("smoke", "insert", keys, vals)
        else:
            srv.submit("smoke", "delete", keys)
        srv.pump(force=True)       # serve + group-commit + ship
        if i % 8 == 7:
            srv.pump()             # idle gap: drain acks
        i += 1


def run_child_partition(leader_dir: str, fol_dir: str, rejoin_dir: str,
                        info_path: str, result_path: str, port: int,
                        lease_s: float, device: str) -> int:
    """The partition-mode leader child: serve + heartbeat until the
    successor's fence deposes us, then rejoin as a follower of the new
    leader and prove our reads match its bitwise."""
    from repro_torch.serve.server import Server

    dur = WAL.Durability(leader_dir, fsync=True,
                         snapshot_every_bytes=1 << 30)
    drv = SLSM(params(), durability=dur, device=device)
    leader = R.Leader(drv, lease_s=lease_s)
    srv = Server(drv, role="leader")
    for i in range(BOOT_PREFIX):
        kind, keys, vals = op(i)
        if kind == "insert":
            srv.submit("smoke", "insert", keys, vals)
        else:
            srv.submit("smoke", "delete", keys)
        srv.pump(force=True)
    cursor = leader.bootstrap(fol_dir)
    leader.attach(R.connect("127.0.0.1", port), cursor)
    i = BOOT_PREFIX
    while True:
        kind, keys, vals = op(i)
        try:
            if kind == "insert":
                srv.submit("smoke", "insert", keys, vals)
            else:
                srv.submit("smoke", "delete", keys)
            srv.pump(force=True)       # serve + group-commit + ship
        except (ValueError, RuntimeError) as e:
            stop_reason = e
            break                      # fenced: the successor deposed us
        srv.pump()                     # idle: acks, heartbeat cadence
        i += 1
        time.sleep(0.002)
    if not (drv.fenced and leader.deposed and srv.stats()["role"]
            == "follower"):
        print(f"[child] stopped wrong: {stop_reason!r} fenced={drv.fenced} "
              f"deposed={leader.deposed} role={srv.stats()['role']}",
              file=sys.stderr, flush=True)
        return 3                       # writes stopped for a wrong reason
    # rejoin: the new leader bootstraps rejoin_dir and posts its
    # listener + target watermark in the info file
    deadline = time.time() + 300
    while not os.path.exists(info_path):
        if time.time() > deadline:
            return 4
        time.sleep(0.05)
    with open(info_path) as fh:
        cfg = json.load(fh)
    fol = R.Follower(rejoin_dir, R.connect("127.0.0.1", cfg["port"]),
                     device=device)
    while fol.last_seqno < cfg["target"]:
        if time.time() > deadline:
            return 5
        fol.pump()
        time.sleep(0.005)
    gv, gf, gr = probe(fol.drv)
    arrays = {"v": gv, "f": gf}
    for j, (rk, rv) in enumerate(gr):
        arrays[f"r{j}k"], arrays[f"r{j}v"] = rk, rv
    np.savez(result_path + ".tmp.npz", **arrays)
    os.replace(result_path + ".tmp.npz", result_path)
    return 0


def run_parent_partition(d: str, kill_after_records: int,
                         lease_s: float, device: str) -> int:
    ldir = os.path.join(d, "leader")
    fdir = os.path.join(d, "follower")
    rdir = os.path.join(d, "rejoin")
    info = os.path.join(d, "rejoin.json")
    result = os.path.join(d, "probe.npz")
    os.makedirs(ldir, exist_ok=True)
    lis = R.SocketListener()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--partition", "--dir", ldir, "--fol-dir", fdir,
         "--rejoin-dir", rdir, "--rejoin-info", info, "--result", result,
         "--port", str(lis.port), "--lease-s", str(lease_s),
         "--device", device], env=env)
    try:
        end = lis.accept(timeout=300)
        lis.close()
        fol = R.Follower(fdir, end, auto_promote=True, device=device)
        deadline = time.time() + 300
        while time.time() < deadline:
            fol.pump()
            if fol.counters["applied_records"] >= kill_after_records:
                break
            if child.poll() is not None:
                print("FAIL: child exited before the partition "
                      f"(rc={child.returncode})")
                return 1
            time.sleep(0.01)
        else:
            print("FAIL: follower never applied enough of the stream")
            return 1
        if fol.lease_deadline is None:
            print("FAIL: lease never armed (no heartbeat reached the "
                  "follower)")
            return 1

        # the partition: freeze (NOT kill) the live leader mid-stream
        os.kill(child.pid, signal.SIGSTOP)
        t0 = time.time()
        bound_s = 2.0 * lease_s + 1.0   # lease + detection slack
        while fol.new_leader is None and time.time() - t0 < bound_s:
            fol.pump()
            time.sleep(0.005)
        if fol.new_leader is None:
            print(f"FAIL: no automatic promotion within {bound_s:.1f}s "
                  f"(lease_s={lease_s})")
            return 1
        auto_ms = (time.time() - t0) * 1e3
        new_lead = fol.new_leader
        if fol.counters["lease_expiries"] < 1:
            print("FAIL: promotion without an observed lease expiry")
            return 1

        # the stream continues on the new leader (post-failover writes)
        for j in range(4):
            keys = np.arange(j * 7, j * 7 + 5, dtype=np.int32)
            new_lead.drv.insert(keys, keys * 11 + 1)

        # heal the partition: the old leader must fence itself on the
        # first bumped-epoch fence ack, then rejoin through a fresh
        # bootstrap of the new leader
        os.kill(child.pid, signal.SIGCONT)
        cursor = new_lead.bootstrap(rdir)
        target = int(new_lead.drv.durability.writer.last_seqno)
        lis2 = R.SocketListener()
        with open(info + ".tmp", "w") as fh:
            json.dump({"port": lis2.port, "target": target}, fh)
        os.replace(info + ".tmp", info)
        end2 = None
        while end2 is None and time.time() < deadline:
            new_lead.pump()             # fence acks depose the child
            try:
                end2 = lis2.accept(timeout=0.2)
            except (R.TransportError, OSError):
                if child.poll() is not None:
                    print("FAIL: child exited before rejoining "
                          f"(rc={child.returncode})")
                    return 1
        lis2.close()
        if end2 is None:
            print("FAIL: deposed leader never dialed back in")
            return 1
        h = new_lead.attach(end2, cursor)
        while child.poll() is None and time.time() < deadline:
            new_lead.pump()
            time.sleep(0.005)
        if child.returncode != 0:
            print(f"FAIL: rejoined child exited rc={child.returncode} "
                  "(3=not fenced, 4=no rejoin info, 5=never converged)")
            return 1
        del h
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    got = np.load(result)
    gv, gf, gr = probe(new_lead.drv)
    if not (np.array_equal(got["f"], gf) and np.array_equal(got["v"], gv)):
        print("FAIL: rejoined old leader's lookups diverge from the "
              "new leader")
        return 1
    for j, (rk, rv) in enumerate(gr):
        if not (np.array_equal(got[f"r{j}k"], rk)
                and np.array_equal(got[f"r{j}v"], rv)):
            print("FAIL: rejoined old leader's range scans diverge")
            return 1
    st = new_lead.stats()
    print(f"OK: automatic promotion in {auto_ms:.0f}ms "
          f"(lease {lease_s:.1f}s, bound {bound_s:.1f}s), "
          f"{st['fence_acks']} fence ack(s) deposed the live leader, "
          "rejoined replica reads bitwise-equal at epoch "
          f"{int(new_lead.drv.durability.writer.epoch)}")
    return 0


def run_parent(leader_dir: str, fol_dir: str,
               kill_after_records: int, device: str) -> int:
    lis = R.SocketListener()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child",
         "--dir", leader_dir, "--fol-dir", fol_dir,
         "--port", str(lis.port), "--device", device], env=env)
    try:
        end = lis.accept(timeout=300)
        lis.close()
        fol = R.Follower(fol_dir, end, device=device)
        deadline = time.time() + 300
        while time.time() < deadline:
            fol.pump()
            if fol.counters["applied_records"] >= kill_after_records:
                break
            if child.poll() is not None:
                print("FAIL: child exited before the kill "
                      f"(rc={child.returncode})")
                return 1
            time.sleep(0.01)
        else:
            print("FAIL: follower never applied enough of the stream")
            return 1
        child.send_signal(signal.SIGKILL)   # leader dies mid-stream
        child.wait()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()

    fol.pump()                      # the torn remainder must not raise
    st = fol.stats()
    print(f"killed leader at follower watermark {st['applied_seqno']} "
          f"({st['applied_records']} applied, "
          f"{st['duplicates']} dups, {st['rejected']} rejected)")

    prom = fol.promote()
    if prom.durability.writer.epoch < 1:
        print("FAIL: promote did not bump the WAL epoch")
        return 1

    # the oracle: a fresh non-durable engine fed the decoded durable
    # WRITE prefix of the follower's own WAL, in log order
    records, _good = WAL.read_wal(os.path.join(fol_dir, "wal.log"))
    writes = [r for r in records if r.kind in WAL.WRITE_KINDS]
    if not writes:
        print("FAIL: nothing durable reached the follower before the kill")
        return 1
    if int(prom.durability.writer.last_seqno) != int(records[-1].seqno):
        print("FAIL: follower applied records its WAL does not hold")
        return 1
    n_neg = 0
    oracle = SLSM(params(), device=device)
    for rec in writes:
        k, v, w = WAL.decode_write(rec.payload, rec.kind)
        is_del = w <= 0
        n_neg += int(is_del.sum())
        start = 0
        for i in range(1, len(k) + 1):
            if i == len(k) or is_del[i] != is_del[start]:
                if is_del[start]:
                    oracle.delete(k[start:i])
                else:
                    oracle.insert(k[start:i], v[start:i])
                start = i
    if n_neg == 0:
        print("FAIL: the durable prefix carries no negative-weight "
              "records — the kill landed before any delete shipped")
        return 1

    gv, gf, gr = probe(prom)
    wv, wf, wr = probe(oracle)
    if not (np.array_equal(gf, wf) and np.array_equal(gv, wv)):
        print("FAIL: promoted lookups diverge from the acked-prefix oracle")
        return 1
    for (gk, gvv), (wk, wvv) in zip(gr, wr):
        if not (np.array_equal(gk, wk) and np.array_equal(gvv, wvv)):
            print("FAIL: promoted range scans diverge from the oracle")
            return 1

    # the promoted node is a writable leader at the bumped epoch
    keys = np.array([1, 3, 5], np.int32)
    prom.insert(keys, keys * 7)
    v, f = prom.lookup_many(keys)
    if not (np.asarray(f).all()
            and np.array_equal(np.asarray(v), keys * 7)):
        print("FAIL: promoted engine rejected or lost a post-failover write")
        return 1
    print(f"OK: failover is answer-exact at write-chunk boundary "
          f"{len(writes)} ({n_neg} negative-weight lanes, epoch "
          f"{prom.durability.writer.epoch}, post-failover writes land)")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--partition", action="store_true",
                    help="self-healing mode: SIGSTOP (not SIGKILL) the "
                         "leader; assert automatic lease promotion, "
                         "fencing, and bitwise rejoin")
    ap.add_argument("--dir", default=None)
    ap.add_argument("--fol-dir", default=None)
    ap.add_argument("--rejoin-dir", default=None)
    ap.add_argument("--rejoin-info", default=None)
    ap.add_argument("--result", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--lease-s", type=float, default=2.0,
                    help="leader lease duration in partition mode")
    ap.add_argument("--kill-after-records", type=int, default=40,
                    help="applied follower records that trigger the "
                         "kill (or the partition)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.child:
        if args.partition:
            return run_child_partition(args.dir, args.fol_dir,
                                       args.rejoin_dir, args.rejoin_info,
                                       args.result, args.port,
                                       args.lease_s, args.device)
        run_child(args.dir, args.fol_dir, args.port, args.device)
        return 0
    with tempfile.TemporaryDirectory(prefix="replication_smoke_") as d:
        if args.partition:
            return run_parent_partition(d, args.kill_after_records,
                                        args.lease_s, args.device)
        ldir = os.path.join(d, "leader")
        fdir = os.path.join(d, "follower")
        os.makedirs(ldir, exist_ok=True)
        return run_parent(ldir, fdir, args.kill_after_records, args.device)


if __name__ == "__main__":
    sys.exit(main())
