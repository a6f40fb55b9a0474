"""The port's replication (`repro_torch.engine.replication`) against the
reference's, on the CPU at the reference harness's tiny geometry (R=2,
Rn=32, D=2, mu=16; `tests/durability/harness.py`), the reference with
``backend="jnp"``.

- The wire: `SocketEnd` writes the reference's bytes for frames, acks and
  heartbeats, and reads the reference's.
- Same stream, same results: one scripted stream (bootstrap from genesis
  and from a snapshot, a duplicated and reordered wire, a dropped frame,
  a bounded reorder buffer, quorum acks on a fake clock) through a
  reference `Leader` with two `Follower`s and through the port's, single
  tree static and adaptive (2 shards in `test_torch_replication_sharded.py`):
  the followers' `wal.log` bytes,
  `Leader.stats()`, `Follower.stats()` and ``counters`` are equal key for
  key, and every answer is bitwise equal across packages, to the leader
  and to `DictOracle`.
- A mixed fleet over a localhost socket, both ways: a reference leader
  feeds a port follower, and a port leader a reference follower.
- The device: a follower runs on the card unless ``device="cpu"``.

The fault suite's claims, one port case each, are in
`test_torch_replication_faults.py`, which shares the helpers here."""
import dataclasses
import random
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.oracle import DictOracle  # noqa: E402
from repro_torch.engine import SLSM  # noqa: E402
from repro_torch.engine import replication as R  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402
from repro_torch.engine.tape import TapeChunk  # noqa: E402
from test_torch_wal import (KEY_SPACE, apply_ops,  # noqa: E402
                            assert_same_answers, probe_answers,
                            small_params, write_stream)


# --------------------------------------------------------------------------
# one interface over either package
# --------------------------------------------------------------------------

def ref_params(p):
    from repro.core.params import SLSMParams as RefParams
    from repro.core.params import TuningPolicy as RefTuning
    return RefParams(**{**dataclasses.asdict(p),
                        "tuning": RefTuning(**dataclasses.asdict(p.tuning))})


class FakeClock:
    """Injected monotonic time: leases expire when the test says so."""

    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Pkg:
    """The replication pieces of the port (``"port"``, on the CPU) or of
    the reference (``"ref"``, ``backend="jnp"``) behind one interface, so
    one scenario runs unchanged through either."""

    def __init__(self, name: str):
        self.name = name
        if name == "port":
            from repro_torch.engine import ShardedSLSM
            self.R, self.WAL = R, WAL
            self._classes = (SLSM, ShardedSLSM)
            self._kw = {"device": "cpu"}
        else:
            from repro.engine import SLSM as RefSLSM
            from repro.engine import ShardedSLSM as RefSharded
            from repro.engine import replication as RR
            from repro.engine import wal as RWAL
            self.R, self.WAL = RR, RWAL
            self._classes = (RefSLSM, RefSharded)
            self._kw = {}

    def params(self, adaptive: bool = False):
        p = small_params(adaptive)
        return p if self.name == "port" else ref_params(p)

    def engine(self, driver: str = "single", adaptive: bool = False,
               durability=None):
        single, sharded = self._classes
        p = self.params(adaptive)
        if driver == "sharded":
            return sharded(p, n_shards=2, durability=durability, **self._kw)
        return single(p, durability=durability, **self._kw)

    def durability(self, directory, **kw):
        return self.WAL.Durability(directory, fsync=False,
                                   snapshot_every_bytes=1 << 30, **kw)

    def leader(self, directory, driver="single", adaptive=False,
               segment_bytes=None, **leader_kw):
        """A durable engine and its `Leader` (no snapshot threshold)."""
        drv = self.engine(driver, adaptive, self.durability(
            directory, segment_bytes=segment_bytes))
        return drv, self.R.Leader(drv, **leader_kw)

    def follower(self, directory, end=None, **kw):
        return self.R.Follower(directory, end, **self._kw, **kw)

    def restore(self, directory, driver="single"):
        return self._classes[driver == "sharded"].restore(directory,
                                                          **self._kw)


PKGS = {name: Pkg(name) for name in ("port", "ref")}


def oracle_answers(ops, upto=None):
    """`probe_answers`' reads of a `DictOracle` fed `ops[:upto]`."""
    o = DictOracle()
    for kind, keys, vals in (ops if upto is None else ops[:upto]):
        (o.insert(keys, vals) if kind == "insert" else o.delete(keys))
    probe = np.arange(0, KEY_SPACE, 3, dtype=np.int32)
    v, f = o.lookup(probe)
    return v, f, [o.range(lo, hi) for lo, hi in
                  ((0, KEY_SPACE), (123, 456), (1000, 3500))]


def assert_matches_oracle(got, want):
    """Found flags, found values and every range bitwise (the value of a
    missing key is the engine's business)."""
    gv, gf, gr = got
    wv, wf, wr = want
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gv[gf], wv[wf])
    for (gk, gvv), (wk, wvv) in zip(gr, wr):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gvv, wvv)


def acked_prefix_answers(pkg, follower, ops, leader_dir, driver="single",
                         adaptive=False):
    """The failover oracle: a fresh volatile engine of `pkg` fed the
    write ops the leader's log holds up to the follower's applied
    watermark (one write record an op). Returns (answers, j)."""
    wm = follower.last_seqno
    j = sum(1 for r in pkg.WAL.read_wal(leader_dir / "wal.log")[0]
            if r.kind in pkg.WAL.WRITE_KINDS and r.seqno <= wm)
    eng = pkg.engine(driver, adaptive)
    apply_ops(eng, ops, upto=j)
    return probe_answers(eng), j


# --------------------------------------------------------------------------
# the wire
# --------------------------------------------------------------------------

def _raw(send):
    """The bytes `send(end)` puts on a socket, and the end that sent."""
    a, b = socket.socketpair()
    try:
        send(a)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while chunk := b.recv(1 << 16):
            out += chunk
        return out
    finally:
        a.close()
        b.close()


def test_wire_is_the_reference_byte_for_byte():
    """Message and ack structs, type codes, and the bytes a `SocketEnd`
    sends for frames, acks and a heartbeat equal the reference's; each
    package reads the other's messages back."""
    RR = PKGS["ref"].R
    assert (R._MSG.format, R._ACK.format) == (RR._MSG.format, RR._ACK.format)
    assert (R.T_FRAME, R.T_ACK, R.T_CTRL) == (RR.T_FRAME, RR.T_ACK,
                                              RR.T_CTRL)
    frames = [WAL.encode_record(s, WAL.REC_WRITE2,
                                WAL.encode_write([s, 7], [1, 2], [1, -1]), 2)
              for s in range(3)]
    hb = {"epoch": 2, "last_seqno": 9, "lease_s": 2.0, "ack_mode": "quorum",
          "quorum": 1, "roster": [[0, 9], [1, 8]], "you": 1}
    for send in (lambda e: e.send_frames(frames),
                 lambda e: e.send_ack(9, 1234, gap=True, epoch=2),
                 lambda e: e.send_ctrl(hb)):
        port = _raw(lambda s: send(R.SocketEnd(s)))
        assert port == _raw(lambda s: send(RR.SocketEnd(s)))
        assert port[0] in (R.T_FRAME, R.T_ACK, R.T_CTRL)
    for src, dst in ((R, RR), (RR, R)):
        a, b = socket.socketpair()
        tx, rx = src.SocketEnd(a), dst.SocketEnd(b)
        tx.send_frames(frames)
        tx.send_ack(9, 1234, gap=True, epoch=2)
        tx.send_ctrl(hb)
        got = []
        for _ in range(200):
            got += rx.recv_frames()
            if len(got) == len(frames):
                break
        assert got == frames
        assert rx.recv_acks() == [(9, 1234, True, 2)]
        assert rx.recv_ctrl() == [hb]
        tx.close()
        rx.close()


# --------------------------------------------------------------------------
# same stream, same results
# --------------------------------------------------------------------------

CELLS = [("single", False), ("single", True)]


def cell_ids(cells):
    return [f"{d}-{'adaptive' if a else 'static'}" for d, a in cells]


def _stream_cell(pkg, base, driver, adaptive):
    """The scripted stream of one cell through `pkg`: a quorum leader on
    a fake clock, follower 0 bootstrapped from genesis, follower 1 from a
    snapshot with a reorder buffer of 4; the wire duplicated and shuffled
    toward follower 0 and a frame dropped toward follower 1; pumps in
    between; then convergence."""
    clock = FakeClock()
    drv, ld = pkg.leader(base / "leader", driver, adaptive,
                         ack_mode="quorum", quorum=1, clock=clock)
    ops = write_stream(n_ops=12)
    apply_ops(drv, ops, upto=3)
    f0 = ld.add_follower(base / "f0", clock=clock)
    apply_ops(drv, ops[3:6])
    if adaptive:
        probe = np.arange(0, KEY_SPACE, 2, dtype=np.int32)
        for _ in range(12):
            drv.lookup_many(probe)
    drv.snapshot()
    f1 = ld.add_follower(base / "f1", clock=clock, pending_max=4)
    apply_ops(drv, ops[6:9])
    if adaptive:
        k = np.random.default_rng(5).integers(0, KEY_SPACE, 40).astype(
            np.int32)
        drv.run_tape([TapeChunk("write", k[:30], k[:30] * 3),
                      TapeChunk("lookup", k[::2], k[::2]),
                      TapeChunk("write", k[30:], k[30:],
                                np.full(10, -1, np.int32))])
        written = (ops[:9] + [("insert", k[:30], k[:30] * 3),
                              ("delete", k[30:], None)] + ops[9:])
    else:
        written = ops
    ld.ship()
    wire = f0.link.frames
    frames = list(wire) * 2
    random.Random(7).shuffle(frames)
    wire.clear()
    wire.extend(frames)
    del f1.link.frames[1]
    for _ in range(2):
        ld.pump()
        f0.pump()
        f1.pump()
    apply_ops(drv, ops[9:])
    rounds = pkg.R.converge(ld, f0, f1)
    if adaptive:
        assert drv.stats["retunes"] >= 1
    return dict(
        dir=base, written=written, rounds=rounds, leader=ld.stats(),
        followers=[f.stats() for f in (f0, f1)],
        counters=[dict(f.counters) for f in (f0, f1)],
        wal={n: (base / n / "wal.log").read_bytes()
             for n in ("leader", "f0", "f1")},
        snapshot=pkg.WAL.list_snapshots(base / "leader")[-1][0],
        answers={"leader": probe_answers(drv),
                 "f0": probe_answers(f0.drv), "f1": probe_answers(f1.drv)})


def cell_runs(tmp_path_factory):
    """Each cell through the reference and the port, lazily and once."""
    out = {}

    def get(cell):
        if cell not in out:
            base = tmp_path_factory.mktemp("-".join(map(str, cell)))
            out[cell] = {name: _stream_cell(pkg, base / name, *cell)
                         for name, pkg in PKGS.items()}
        return out[cell]

    return get


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return cell_runs(tmp_path_factory)


def check_bytes_stats_and_counters(c):
    """Followers' `wal.log` bytes, `Leader.stats()`, each follower's
    `stats()` and ``counters`` are the reference's key for key; follower
    0's log is the leader's, follower 1's the leader's past the snapshot
    it bootstrapped from; the faults cost retransmits and duplicates."""
    port, ref = c["port"], c["ref"]
    assert port["wal"] == ref["wal"]
    assert port["leader"] == ref["leader"]
    assert port["followers"] == ref["followers"]
    assert port["counters"] == ref["counters"]
    assert port["rounds"] == ref["rounds"]
    wal = port["wal"]
    assert wal["f0"] == wal["leader"]
    start = next(s for r, s, _ in WAL.record_offsets(
        port["dir"] / "leader" / "wal.log") if r.seqno == port["snapshot"] + 1)
    assert wal["f1"] == WAL.MAGIC + wal["leader"][start:]
    st = port["leader"]
    assert st["follower_lag_records"] == 0 and st["followers"] == 2
    assert st["quorum_seqno"] == st["last_seqno"]
    assert sum(p["retransmits"] for p in st["per_follower"]) >= 1
    assert port["counters"][0]["duplicates"] >= 1
    assert port["counters"][1]["gap_signals"] >= 1


def check_answers(c):
    """Leader and both followers answer bitwise alike in each package,
    across packages, and as `DictOracle` fed the stream."""
    want = c["ref"]["answers"]["leader"]
    for name in ("leader", "f0", "f1"):
        assert_same_answers(c["port"]["answers"][name], want)
        assert_same_answers(c["ref"]["answers"][name], want)
    assert_matches_oracle(want, oracle_answers(c["port"]["written"]))


@pytest.mark.parametrize("cell", CELLS, ids=cell_ids(CELLS))
def test_same_stream_same_bytes_stats_and_counters(cells, cell):
    check_bytes_stats_and_counters(cells(cell))


@pytest.mark.parametrize("cell", CELLS, ids=cell_ids(CELLS))
def test_same_stream_same_answers(cells, cell):
    check_answers(cells(cell))


# --------------------------------------------------------------------------
# a mixed fleet over a localhost socket
# --------------------------------------------------------------------------

@pytest.mark.parametrize("leader_pkg,follower_pkg",
                         [("ref", "port"), ("port", "ref")])
def test_mixed_fleet_over_a_socket(tmp_path, leader_pkg, follower_pkg):
    """A leader of one package ships over a localhost socket to a
    follower of the other: heartbeats name the follower, the stream
    converges, the follower's log is the leader's byte for byte, and its
    answers are the leader's bitwise; after a promotion it takes writes
    at epoch 1."""
    lp, fp = PKGS[leader_pkg], PKGS[follower_pkg]
    drv, ld = lp.leader(tmp_path / "leader", ack_mode="quorum", quorum=1)
    ops = write_stream(n_ops=12)
    apply_ops(drv, ops, upto=5)
    cursor = ld.bootstrap(tmp_path / "fol")
    lis = fp.R.SocketListener()
    lend = lp.R.connect(lis.host, lis.port)
    fend = lis.accept()
    lis.close()
    ld.attach(lend, cursor)
    fol = fp.follower(tmp_path / "fol", fend)
    apply_ops(drv, ops[5:])
    for _ in range(200):
        ld.pump()
        fol.pump()
        ld.pump()
        if ld.stats()["follower_lag_records"] == 0:
            break
    st = ld.stats()
    assert st["follower_lag_records"] == 0, st
    assert st["quorum_seqno"] == st["last_seqno"] == fol.last_seqno
    assert fol.fid == 0 and fol.counters["heartbeats_seen"] >= 1
    assert fol.leader_ack_mode == "quorum"
    assert ((tmp_path / "fol" / "wal.log").read_bytes()
            == (tmp_path / "leader" / "wal.log").read_bytes())
    assert_same_answers(probe_answers(fol.drv), probe_answers(drv))
    assert_matches_oracle(probe_answers(fol.drv), oracle_answers(ops))
    prom = fol.promote()
    keys = np.array([11, 12, 13], np.int32)
    prom.insert(keys, keys * 10)
    assert prom.durability.writer.epoch == 1
    v, f = prom.lookup_many(keys)
    assert np.asarray(f).all() and (np.asarray(v) == keys * 10).all()
    lend.close()
    fend.close()


# --------------------------------------------------------------------------
# the device
# --------------------------------------------------------------------------

def test_follower_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    """Without a CUDA device `Follower` raises unless ``device="cpu"``,
    before the directory is opened; `add_follower` follows the leader
    engine's device (here the CPU) and raises for the card before it
    bootstraps anything; a `Server` needs an engine, which raises."""
    from repro_torch.serve import Server
    drv, ld = PKGS["port"].leader(tmp_path / "leader")
    apply_ops(drv, write_stream(n_ops=3))
    ld.bootstrap(tmp_path / "fol")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = (tmp_path / "fol" / "wal.log").read_bytes()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.Follower(tmp_path / "fol")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.Follower(tmp_path / "fol", device="cuda")
    assert (tmp_path / "fol" / "wal.log").read_bytes() == before
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ld.add_follower(tmp_path / "card", device="cuda")
    assert not (tmp_path / "card").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(SLSM(small_params()))
    fol = R.Follower(tmp_path / "fol", device="cpu")
    assert fol.drv.device.type == "cpu"
    f2 = ld.add_follower(tmp_path / "f2")
    assert f2.drv.device == drv.device == torch.device("cpu")
    R.converge(ld, f2)
    assert_same_answers(probe_answers(f2.drv), probe_answers(drv))
