"""The reference fault suite's claims (`tests/replication/`), one port
case each, on the CPU at the tiny geometry. Each scenario runs unchanged
through the port and through the reference (``backend="jnp"``); the port
must hold the claim, and where the outcome is a number — the durable
prefix a promotion lands on, the promoted follower's id, the quorum
watermark, the prune cut — it must be the reference's, with answers
bitwise equal to the reference's.

- failover is answer-exact under `sigkill`, `torn_tail`, `dup_reorder`
  and `crc_flip` on the wire (`test_faults.py:29`, `:57`), and after a
  cut at or inside a RETUNE record (`:89`);
- a dropped frame heals by retransmit (`:150`);
- lease expiry promotes exactly one follower (`test_selfheal.py:81`,
  `:183`), and a deposed leader fences and rejoins (`:116`);
- quorum loss blocks the commit watermark (`:157`);
- prune floors at the lagging ack, bootstrap after a prune is snapshot
  plus tail, and a dead handle past its grace stops pinning the prune
  (`test_pruning.py:56`, `:91`, `:146`);
- a legacy format-1 write stream applies as its weighted equal
  (`test_cross_version.py:40`)."""
import random
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_replication import (PKGS, FakeClock,  # noqa: E402
                                    acked_prefix_answers,
                                    assert_matches_oracle, oracle_answers)
from test_torch_wal import (KEY_SPACE, apply_ops,  # noqa: E402
                            assert_same_answers, probe_answers,
                            write_stream)


def both(scenario, tmp_path, *args):
    """`scenario(pkg, directory, *args)` through the port and the
    reference; returns ``(port_result, ref_result)``."""
    return tuple(scenario(PKGS[n], tmp_path / n, *args)
                 for n in ("port", "ref"))


def leader_with_follower(pkg, base, n_prefix=0, snapshot=False, **lkw):
    drv, ld = pkg.leader(base / "leader", **lkw)
    ops = write_stream(n_ops=12)
    apply_ops(drv, ops, upto=n_prefix)
    if snapshot:
        drv.snapshot()
    return drv, ld, ld.add_follower(base / "follower"), ops


def chain_first_seqno(pkg, directory) -> int:
    recs, _ = pkg.WAL.read_wal_chain(directory)
    return recs[0].seqno if recs else -1


# --------------------------------------------------------------------------
# failover under wire faults
# --------------------------------------------------------------------------

FAULTS = ("sigkill", "torn_tail", "dup_reorder", "crc_flip")


def _inject(fault, wire, rng):
    """The reference suite's faults, on the in-flight frame deque."""
    if fault == "sigkill":
        for _ in range(max(1, len(wire) // 2)):
            wire.pop()
    elif fault == "torn_tail":
        last = wire.pop()
        wire.append(last[:max(1, len(last) // 2)])
    elif fault == "dup_reorder":
        frames = list(wire) * 2
        rng.shuffle(frames)
        wire.clear()
        wire.extend(frames)
    else:
        i = len(wire) // 2
        b = bytearray(wire[i])
        b[len(b) // 2] ^= 0x40
        wire[i] = bytes(b)


def _failover(pkg, base, fault):
    drv, ld, fol, ops = leader_with_follower(pkg, base, n_prefix=4,
                                             snapshot=True)
    apply_ops(drv, ops[4:])
    ld.ship()
    wire = fol.link.frames
    assert len(wire) >= len(ops) - 4
    _inject(fault, wire, random.Random(sum(map(ord, fault))))
    fol.pump()
    prom = fol.promote()
    want, j = acked_prefix_answers(pkg, fol, ops, base / "leader")
    got = probe_answers(prom)
    keys = np.array([11, 12, 13], np.int32)
    prom.insert(keys, keys * 10)
    v, f = prom.lookup_many(keys)
    return dict(j=j, got=got, want=want, epoch=prom.durability.writer.epoch,
                new=(np.asarray(v), np.asarray(f)),
                counters=dict(fol.counters))


@pytest.mark.parametrize("fault", FAULTS)
def test_failover_answer_exact_under_fault(tmp_path, fault):
    """The promoted follower answers as a fresh engine fed its durable
    acked prefix (the reference's prefix), and takes writes at epoch 1."""
    port, ref = both(_failover, tmp_path, fault)
    assert port["j"] == ref["j"] >= 4
    if fault in ("sigkill", "torn_tail", "crc_flip"):
        assert port["j"] < 12, f"{fault} failed to cut the stream"
    assert port["counters"] == ref["counters"]
    assert_same_answers(port["got"], port["want"])
    assert_same_answers(port["got"], ref["got"])
    assert port["epoch"] == ref["epoch"] == 1
    assert port["new"][1].all() and (port["new"][0] == [110, 120, 130]).all()


def _retune_cut(pkg, base):
    drv, ld = pkg.leader(base / "leader", adaptive=True)
    ops = write_stream(n_ops=6)
    apply_ops(drv, ops, upto=4)
    fols = [ld.add_follower(base / f"f{i}") for i in range(2)]
    probe = np.arange(0, KEY_SPACE, 2, dtype=np.int32)
    for _ in range(12):
        drv.lookup_many(probe)
    apply_ops(drv, ops[4:])
    assert drv.stats["retunes"] >= 1, "stream failed to provoke a retune"
    ld.ship()
    out = []
    for mode, fol in zip(("after", "torn"), fols):
        wire = fol.link.frames
        idx = next(i for i, fr in enumerate(wire)
                   if pkg.WAL.check_frame(fr).kind == pkg.WAL.REC_RETUNE)
        while len(wire) > idx + 1:
            wire.pop()
        if mode == "torn":
            torn = wire.pop()
            wire.append(torn[:len(torn) // 2])
        fol.pump()
        prom = fol.promote()
        want, j = acked_prefix_answers(pkg, fol, ops, base / "leader",
                                       adaptive=True)
        out.append(dict(j=j, got=probe_answers(prom), want=want,
                        retunes=prom.stats["retunes"]))
    return out


def test_failover_on_mid_retune_cut(tmp_path):
    """Cut right after, and torn inside, the RETUNE record in flight:
    both promotions are answer-exact at the reference's prefix."""
    port, ref = both(_retune_cut, tmp_path)
    for p, r in zip(port, ref):
        assert p["j"] == r["j"] >= 4
        assert p["retunes"] == r["retunes"]
        assert_same_answers(p["got"], p["want"])
        assert_same_answers(p["got"], r["got"])
    assert port[0]["retunes"] == port[1]["retunes"] + 1, "the torn RETUNE"


def _dropped_frame(pkg, base):
    drv, ld, fol, ops = leader_with_follower(pkg, base)
    apply_ops(drv, ops)
    ld.ship()
    wire = fol.link.frames
    del wire[len(wire) // 2]
    fol.pump()
    buffered = fol.stats()["reorder_buffered"]
    rounds = pkg.R.converge(ld, fol)
    return dict(buffered=buffered, rounds=rounds, leader=ld.stats(),
                follower=fol.stats(), got=probe_answers(fol.drv),
                want=probe_answers(drv), ops=ops)


def test_dropped_frame_heals_by_retransmit(tmp_path):
    """The successors wait in the reorder buffer, the gap ack rewinds the
    leader, the overlap is dropped as duplicates; the stream converges
    exactly, with the reference's counters."""
    port, ref = both(_dropped_frame, tmp_path)
    assert port["buffered"] == ref["buffered"] >= 1
    assert port["rounds"] == ref["rounds"]
    assert port["leader"] == ref["leader"]
    assert port["follower"] == ref["follower"]
    assert port["leader"]["per_follower"][0]["retransmits"] >= 1
    assert port["follower"]["duplicates"] >= 1
    assert port["follower"]["reorder_buffered"] == 0
    assert_same_answers(port["got"], port["want"])
    assert_same_answers(port["got"], ref["got"])
    assert_matches_oracle(port["got"], oracle_answers(port["ops"]))


# --------------------------------------------------------------------------
# leases, fencing, quorum
# --------------------------------------------------------------------------

def lease_cluster(pkg, base, n_followers=2, ack_mode="leader", quorum=1):
    """A leader with heartbeats on a fake clock and auto-promoting
    followers, converged and acked on the first 8 ops."""
    clock = FakeClock()
    drv, ld = pkg.leader(base / "leader", ack_mode=ack_mode, quorum=quorum,
                         lease_s=2.0, clock=clock)
    ops = write_stream(n_ops=12)
    apply_ops(drv, ops, upto=8)
    fols = [ld.add_follower(base / f"f{i}", auto_promote=True, clock=clock)
            for i in range(n_followers)]
    for _ in range(3):
        ld.pump()
        for f in fols:
            f.pump()
    ld.pump()
    assert all(f.lease_deadline is not None and f.fid is not None
               for f in fols)
    return clock, drv, ld, fols, ops


def _lease_expiry(pkg, base):
    clock, drv, ld, fols, ops = lease_cluster(pkg, base)
    clock.advance(3.0 * ld.lease_s)
    for f in fols:
        f.pump()
    winners = [f.fid for f in fols if f.new_leader is not None]
    assert len(winners) == 1, winners
    new = next(f for f in fols if f.new_leader is not None).new_leader
    loser = next(f for f in fols if f.new_leader is None)
    want, j = acked_prefix_answers(pkg, fols[0], ops, base / "leader")
    promoted = probe_answers(new.drv)
    link = pkg.R.QueueLink()
    new.attach(link.leader, pkg.R.Cursor(
        0, loser.last_seqno + 1, int(new.drv.durability.writer.epoch)))
    loser.reattach(link.follower)
    apply_ops(new.drv, ops[8:])
    pkg.R.converge(new, loser)
    return dict(winners=winners, j=j, promoted=promoted, want=want,
                counters=[dict(f.counters) for f in fols],
                loser=probe_answers(loser.drv), new=probe_answers(new.drv))


def test_lease_expiry_promotes_exactly_one(tmp_path):
    """The leader goes silent past its lease: exactly the successor (the
    reference's, follower 0) promotes, answer-exact at its acked prefix;
    the other stands down, rejoins the new leader and converges."""
    port, ref = both(_lease_expiry, tmp_path)
    assert port["winners"] == ref["winners"] == [0]
    assert port["j"] == ref["j"] == 8
    assert port["counters"] == ref["counters"]
    assert [c["auto_promotions"] for c in port["counters"]] == [1, 0]
    assert [c["standdowns"] for c in port["counters"]] == [0, 1]
    assert_same_answers(port["promoted"], port["want"])
    assert_same_answers(port["promoted"], ref["promoted"])
    assert_same_answers(port["loser"], port["new"])
    assert_same_answers(port["new"], ref["new"])


def _deposed(pkg, base):
    clock, drv, ld, fols, ops = lease_cluster(pkg, base, n_followers=1)
    clock.advance(3.0 * ld.lease_s)
    fols[0].pump()
    new = fols[0].new_leader
    assert new is not None and new.fence_ends
    apply_ops(drv, ops[8:9])            # the deposed leader writes on
    ld.pump()                           # ...into the fence
    new.pump()                          # fence ack at epoch 1
    ld.pump()                           # epoch 1 > 0: fence itself
    with pytest.raises(RuntimeError, match="fenced"):
        k = np.array([7], np.int32)
        drv.insert(k, k)
    shipped = ld.ship()
    want, j = acked_prefix_answers(pkg, fols[0], ops, base / "leader")
    promoted = probe_answers(new.drv)
    rejoined = new.add_follower(base / "rejoined")
    apply_ops(new.drv, ops[9:])
    pkg.R.converge(new, rejoined)
    return dict(deposed=ld.deposed, fenced=drv.fenced, shipped=shipped,
                fence_acks=new.counters["fence_acks"], j=j,
                promoted=promoted, want=want,
                rejoined=probe_answers(rejoined.drv),
                new=probe_answers(new.drv),
                epoch=rejoined.drv.durability.writer.epoch)


def test_deposed_leader_fences_and_rejoins(tmp_path):
    """The partitioned old leader learns of its deposition from the
    successor's bumped-epoch fence ack, fences (writes raise, ship is
    inert), and rejoins by a fresh bootstrap from the new leader."""
    port, ref = both(_deposed, tmp_path)
    assert port["deposed"] and port["fenced"] and port["shipped"] == 0
    assert port["fence_acks"] == ref["fence_acks"] >= 1
    assert port["j"] == ref["j"] == 8
    assert port["epoch"] == ref["epoch"] == 1
    assert_same_answers(port["promoted"], port["want"])
    assert_same_answers(port["rejoined"], port["new"])
    assert_same_answers(port["new"], ref["new"])


def _quorum_loss(pkg, base):
    clock, drv, ld, fols, ops = lease_cluster(pkg, base, ack_mode="quorum",
                                              quorum=2)
    q_before = ld.quorum_seqno()
    tip = drv.durability.writer.last_seqno
    ld.handles[1].end.close()
    apply_ops(drv, ops[8:])
    ld.pump()
    q_after = ld.quorum_seqno()
    fols[0].pump()
    applied = fols[0].last_seqno
    prom = fols[0].promote()
    want, _ = acked_prefix_answers(pkg, fols[0], ops, base / "leader")
    return dict(q=(q_before, tip, q_after), dead=ld.handles[1].dead,
                applied=applied, got=probe_answers(prom), want=want)


def test_quorum_loss_blocks_the_commit_watermark(tmp_path):
    """Quorum 2 of 2: the watermark is the durable tip while both ack,
    -1 once one is lost (the reference's values), and the survivor holds
    every record the old watermark covered (RPO 0)."""
    port, ref = both(_quorum_loss, tmp_path)
    q_before, tip, q_after = port["q"]
    assert port["q"] == ref["q"]
    assert q_before == tip and q_after == -1 and port["dead"]
    assert port["applied"] >= q_before
    assert_same_answers(port["got"], port["want"])
    assert_same_answers(port["got"], ref["got"])


# --------------------------------------------------------------------------
# pruning
# --------------------------------------------------------------------------

def _prune_floor(pkg, base):
    drv, ld = pkg.leader(base / "leader", segment_bytes=256)
    ops = write_stream(n_ops=16)
    fol = ld.add_follower(base / "fol")
    apply_ops(drv, ops, upto=6)
    for _ in range(3):
        ld.pump()
        fol.pump()
    ld.pump()
    acked = ld.handles[0].acked_seqno
    apply_ops(drv, ops[6:])
    drv.snapshot()
    floor = drv.durability.prune_floor()
    first_pruned = ld.prune()
    first = chain_first_seqno(pkg, base / "leader")
    pkg.R.converge(ld, fol)
    lagging = probe_answers(fol.drv)
    second_pruned = ld.prune()
    # bootstrap after the prune: snapshot + retained tail
    late = ld.add_follower(base / "late")
    pkg.R.converge(ld, late)
    return dict(acked=acked, floor=floor, pruned=(first_pruned,
                                                  second_pruned),
                first=first, after=chain_first_seqno(pkg, base / "leader"),
                pruned_bytes=drv.durability.stats()["wal_pruned_bytes"],
                lagging=lagging, late=probe_answers(late.drv),
                want=probe_answers(drv), ops=ops)


def test_prune_floors_at_the_lagging_ack_and_bootstrap_after_it(tmp_path):
    """A lagging follower's ack floors the prune (its tail is retained and
    it converges); once it has acked the tip the floor lifts to the
    snapshot; a follower bootstrapped after that prune (snapshot plus
    tail) answers exactly. Every cut is the reference's."""
    port, ref = both(_prune_floor, tmp_path)
    for k in ("acked", "floor", "pruned", "first", "after", "pruned_bytes"):
        assert port[k] == ref[k], k
    assert port["floor"] > port["acked"] >= 1
    assert port["first"] <= port["acked"] + 1
    assert port["pruned"][1] >= 1 and port["after"] > port["first"]
    for name in ("lagging", "late"):
        assert_same_answers(port[name], port["want"])
    assert_same_answers(port["want"], ref["want"])
    assert_matches_oracle(port["want"], oracle_answers(port["ops"]))


def _dead_handle(pkg, base):
    clock = FakeClock()
    drv, ld = pkg.leader(base / "leader", segment_bytes=256, lease_s=2.0,
                         clock=clock)
    ops = write_stream(n_ops=16)
    fol = ld.add_follower(base / "fol")
    apply_ops(drv, ops, upto=6)
    for _ in range(3):
        ld.pump()
        fol.pump()
    ld.pump()
    acked = ld.handles[0].acked_seqno
    ld.handles[0].end.close()
    apply_ops(drv, ops[6:14])
    ld.pump()
    drv.snapshot()
    apply_ops(drv, ops[14:])
    ld.prune()
    within = (chain_first_seqno(pkg, base / "leader"), len(ld.handles),
              ld.counters["expired_handles"])
    clock.advance(ld.dead_grace_s + 1.0)
    pruned = ld.prune()
    past = (chain_first_seqno(pkg, base / "leader"), len(ld.handles),
            ld.counters["expired_handles"])
    fol2 = ld.add_follower(base / "fol2")
    pkg.R.converge(ld, fol2)
    return dict(acked=acked, within=within, pruned=pruned, past=past,
                got=probe_answers(fol2.drv), want=probe_answers(drv))


def test_dead_handle_past_its_grace_stops_pinning_the_prune(tmp_path):
    """Within the grace a dead handle's frozen ack floors the prune;
    past it the handle is detached, the floor lifts, and a returning
    replica bootstraps afresh — the reference's cuts and counts."""
    port, ref = both(_dead_handle, tmp_path)
    for k in ("acked", "within", "pruned", "past"):
        assert port[k] == ref[k], k
    assert port["within"][0] <= port["acked"] + 1
    assert port["within"][1:] == (1, 0) and port["past"][1:] == (0, 1)
    assert port["past"][0] > port["acked"] + 1 and port["pruned"] >= 1
    assert_same_answers(port["got"], port["want"])
    assert_same_answers(port["got"], ref["got"])


# --------------------------------------------------------------------------
# the legacy write stream
# --------------------------------------------------------------------------

def test_legacy_write_stream_applies_as_its_weighted_equal(tmp_path):
    """A port follower ingests a hand-encoded format-1 ``REC_WRITE``
    stream (TOMBSTONE value = delete) and answers bitwise like the one
    that trails the live format-2 leader, at the same watermark."""
    from repro_torch.core.params import TOMBSTONE
    pkg = PKGS["port"]
    WAL = pkg.WAL
    drv, ld = pkg.leader(tmp_path / "leader")
    cur = ld.bootstrap(tmp_path / "legacy")
    fol2 = ld.add_follower(tmp_path / "w2")
    fol1 = pkg.follower(tmp_path / "legacy")
    ops = write_stream(n_ops=8)
    apply_ops(drv, ops)
    pkg.R.converge(ld, fol2)
    frames, seq = [], cur.next_seqno
    for kind, keys, vals in ops:
        k = np.ascontiguousarray(np.asarray(keys, np.int32))
        v = (np.ascontiguousarray(np.asarray(vals, np.int32))
             if kind == "insert" else np.full(k.size, TOMBSTONE, np.int32))
        frames.append(WAL.encode_record(seq, WAL.REC_WRITE, struct.pack(
            "<I", k.size) + k.tobytes() + v.tobytes()))
        seq += 1
    assert fol1.ingest(frames) == len(ops)
    assert fol1.last_seqno == fol2.last_seqno
    assert fol1.stats()["rejected"] == 0
    assert_same_answers(probe_answers(fol1.drv), probe_answers(fol2.drv))
    kinds = [r.kind for r in WAL.read_wal(tmp_path / "legacy" / "wal.log")[0]
             if r.kind in WAL.WRITE_KINDS]
    assert kinds == [WAL.REC_WRITE] * len(ops)
    fol1.drv.durability.close()
    back = pkg.restore(tmp_path / "legacy")
    assert_same_answers(probe_answers(back), probe_answers(drv))
