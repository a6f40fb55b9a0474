"""Crash-exact restore of the port's durable engine, and its on-disk
compatibility with the reference, on the CPU at the reference harness's
tiny geometry (R=2, Rn=32, D=2, mu=16).

- Crash points, as `tests/durability/test_crash_points.py` and
  `test_durability_props.py` run them on the reference's single-tree engine:
  a torn tail at every byte of the last two records, cuts at record
  boundaries, inside the records of ops that sealed and spilled, around
  a RETUNE and around a snapshot's watermark, and random streams cut at
  random bytes. Each restore answers exactly as a volatile port engine
  fed the durable op prefix.
- Byte identity: one op stream through the reference and the port
  (tiering and leveling x merge_budget 0/1; adaptive with retunes and
  `run_tape` windows) writes the same `wal.log`, the same snapshot leaf
  files and an equal `meta.json`.
- Cross-restore: each package restores the other's directory, with
  bitwise-equal state leaves and equal answers.
- The small cases: the run occupancy a snapshot's adoption must refresh,
  replicas, promote and demote, a snapshot whose levels do not match
  its meta, and no restore without a card unless ``device="cpu"``."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.engine import SLSM, LevelingPolicy  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402
from repro_torch.engine.read_path import host_occupancy  # noqa: E402
from repro_torch.engine.tape import TapeChunk  # noqa: E402
from test_torch_wal import (apply_ops, assert_same_answers,  # noqa: E402
                            port_engine, probe_answers, small_params,
                            write_stream)

_HDR = WAL._HEADER.size


# --------------------------------------------------------------------------
# the port's crash harness (tests/durability/harness.py, on the port)
# --------------------------------------------------------------------------

def crash_copy(durdir, dst, cut=None):
    """Clone the durability dir, truncate its WAL at byte `cut`, and
    drop any snapshot past the surviving log (a real crash cannot leave
    one: snapshot() syncs the log first)."""
    shutil.copytree(durdir, dst)
    wal_path = os.path.join(dst, "wal.log")
    if cut is not None:
        with open(wal_path, "r+b") as f:
            f.truncate(cut)
    records, _ = WAL.read_wal(wal_path)
    last = records[-1].seqno if records else -1
    for num, spath in WAL.list_snapshots(dst):
        if num > last:
            shutil.rmtree(spath)
    return dst


def durable_write_ops(wal_path) -> int:
    """Write ops in the well-formed WAL prefix (one record an op)."""
    return sum(1 for r in WAL.read_wal(wal_path)[0]
               if r.kind in WAL.WRITE_KINDS)


class Harness:
    """One durable run per (adaptive, n_ops, snapshot_at), the oracle
    answers per durable prefix, and restores of crashed copies."""

    def __init__(self, tmp_factory):
        self.tmp = tmp_factory
        self._runs = {}
        self._oracles = {}

    def run(self, n_ops: int = 12, snapshot_at=None):
        key = (n_ops, snapshot_at)
        if key not in self._runs:
            p = small_params()
            durdir = str(self.tmp.mktemp("run"))
            dur = WAL.Durability(durdir, fsync=False,
                                 snapshot_every_bytes=1 << 30)
            eng = port_engine(p, durability=dur)
            ops = write_stream(n_ops=n_ops)
            deltas = []
            for i, op in enumerate(ops):
                before = dict(eng.stats)
                apply_ops(eng, [op])
                deltas.append({k: eng.stats[k] - before.get(k, 0)
                               for k in ("seals", "spills")})
                if snapshot_at is not None and i == snapshot_at:
                    eng.snapshot()
            dur.close()
            self._runs[key] = dict(
                dir=durdir, ops=ops, deltas=deltas, answers=probe_answers(eng),
                offsets=WAL.record_offsets(os.path.join(durdir, "wal.log")))
        return self._runs[key]

    def oracle(self, ops, j: int, adaptive: bool = False):
        key = (len(ops), j, adaptive)
        if key not in self._oracles:
            eng = port_engine(small_params(adaptive))
            apply_ops(eng, ops, upto=j)
            self._oracles[key] = probe_answers(eng)
        return self._oracles[key]

    def restore_at(self, durdir, cut=None):
        dst = os.path.join(str(self.tmp.mktemp("crash")), "d")
        crash_copy(durdir, dst, cut=cut)
        j = durable_write_ops(os.path.join(dst, "wal.log"))
        return SLSM.restore(dst, device="cpu"), j


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return Harness(tmp_path_factory)


def _writes(offsets):
    return [(r, s, e) for r, s, e in offsets if r.kind in WAL.WRITE_KINDS]


# --------------------------------------------------------------------------
# crash points
# --------------------------------------------------------------------------

def test_torn_tail_every_byte_of_last_two_records(harness, tmp_path):
    """A cut at every byte of the last two write records: the torn
    record is dropped whole, restore lands on the op before it."""
    run = harness.run()
    data = open(os.path.join(run["dir"], "wal.log"), "rb").read()
    writes = _writes(run["offsets"])
    for idx in (len(writes) - 2, len(writes) - 1):
        _, start, end = writes[idx]
        want = harness.oracle(run["ops"], idx)
        for cut in range(start, end):
            d = tmp_path / f"c{cut}"
            d.mkdir()
            (d / "wal.log").write_bytes(data[:cut])
            eng = SLSM.restore(str(d), device="cpu")
            assert eng.stats["replayed_records"] == idx, cut
            assert_same_answers(probe_answers(eng), want)
            shutil.rmtree(d)


def test_chunk_boundary_cuts(harness):
    run = harness.run()
    writes = _writes(run["offsets"])
    for i in (0, len(writes) // 2, len(writes) - 1):
        _, _, end = writes[i]
        eng, j = harness.restore_at(run["dir"], cut=end)
        assert j == i + 1
        assert_same_answers(probe_answers(eng), harness.oracle(run["ops"], j))


def test_mid_seal_and_mid_spill(harness):
    """Cuts inside (and at the end of) the records of ops that sealed
    and spilled: restore lands answer-exact on the op boundary."""
    run = harness.run()
    writes = _writes(run["offsets"])
    seal_ops = [i for i, d in enumerate(run["deltas"]) if d["seals"]]
    spill_ops = [i for i, d in enumerate(run["deltas"]) if d["spills"]]
    assert seal_ops and spill_ops, "stream too small to seal and spill"
    for i in sorted({seal_ops[0], seal_ops[-1], spill_ops[0],
                     spill_ops[-1]}):
        _, start, end = writes[i]
        for cut in (start + _HDR + 3, end):
            eng, j = harness.restore_at(run["dir"], cut=cut)
            assert j == (i if cut < end else i + 1)
            assert_same_answers(probe_answers(eng),
                                harness.oracle(run["ops"], j))


def test_mid_retune(harness, tmp_path):
    """Cuts inside and right after a logged RETUNE record: answers do
    not depend on whether the switch survived."""
    p = small_params(adaptive=True)
    dur = WAL.Durability(tmp_path / "run", fsync=False,
                         snapshot_every_bytes=1 << 30)
    eng = port_engine(p, durability=dur)
    ops = write_stream(n_ops=6)
    apply_ops(eng, ops[:4])
    probe = np.arange(0, 4000, 2, dtype=np.int32)
    for _ in range(12):
        eng.lookup_many(probe)
    apply_ops(eng, ops[4:])
    dur.close()
    assert eng.stats["retunes"] >= 1, "stream failed to provoke a retune"
    offsets = WAL.record_offsets(tmp_path / "run" / "wal.log")
    retunes = [(r, s, e) for r, s, e in offsets if r.kind == WAL.REC_RETUNE]
    assert retunes, "no RETUNE record reached the WAL"
    _, start, end = retunes[-1]
    for cut in (start + 1, start + _HDR, end):
        got, j = harness.restore_at(str(tmp_path / "run"), cut=cut)
        assert got.stats["retunes"] == sum(
            1 for r, s, e in retunes if e <= cut)
        assert_same_answers(probe_answers(got),
                            harness.oracle(ops, j, adaptive=True))


def test_crash_around_snapshot_watermark(harness):
    """Cuts before, at and after a mid-stream snapshot's watermark:
    after it restore replays the tail only; before it the snapshot is
    gone and replay starts at genesis."""
    run = harness.run(snapshot_at=6)
    snaps = WAL.list_snapshots(run["dir"])
    assert len(snaps) == 1
    watermark = snaps[0][0]
    writes = _writes(run["offsets"])
    before = [e for r, s, e in writes if r.seqno < watermark][-2]
    after = [e for r, s, e in writes if r.seqno > watermark]
    for cut in (before, after[0], after[-1], after[-1] - 3):
        eng, j = harness.restore_at(run["dir"], cut=cut)
        assert_same_answers(probe_answers(eng), harness.oracle(run["ops"], j))
    full = SLSM.restore(run["dir"], device="cpu")
    assert full.stats["replayed_records"] < len(writes)
    assert_same_answers(probe_answers(full), run["answers"])


_KEYS = 512


def _ops_strategy():
    op = st.tuples(
        st.sampled_from(["insert", "insert", "insert", "delete"]),
        st.lists(st.integers(0, _KEYS - 1), min_size=1, max_size=40),
        st.integers(0, 1 << 20))
    return st.lists(op, min_size=1, max_size=10)


@settings(max_examples=6, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(ops=_ops_strategy(), crash_frac=st.floats(0.0, 1.0), data=st.data())
def test_random_stream_random_crash_restores_to_oracle(
        tmp_path_factory, ops, crash_frac, data):
    p = small_params()
    base = str(tmp_path_factory.mktemp("prop"))
    durdir = os.path.join(base, "run")
    dur = WAL.Durability(durdir, fsync=False, snapshot_every_bytes=1 << 30)
    eng = port_engine(p, durability=dur)
    stream = []
    for kind, keys, seed in ops:
        k = np.asarray(keys, np.int32)
        v = ((k.astype(np.int64) * 2654435761 + seed)
             % (1 << 20)).astype(np.int32)
        stream.append((kind, k, v if kind == "insert" else None))
    snap_at = data.draw(st.one_of(
        st.none(), st.integers(0, len(stream) - 1)), label="snap_at")
    for i, op in enumerate(stream):
        apply_ops(eng, [op])
        if snap_at is not None and i == snap_at:
            eng.snapshot()
    dur.close()
    cut = int(round(crash_frac * os.path.getsize(
        os.path.join(durdir, "wal.log"))))
    dst = os.path.join(base, "crashed")
    crash_copy(durdir, dst, cut=cut)
    j = durable_write_ops(os.path.join(dst, "wal.log"))
    restored = SLSM.restore(dst, params=p, device="cpu")
    oracle = port_engine(p)
    apply_ops(oracle, stream, upto=j)
    assert_same_answers(probe_answers(restored, key_space=_KEYS),
                        probe_answers(oracle, key_space=_KEYS))
    shutil.rmtree(base, ignore_errors=True)


# --------------------------------------------------------------------------
# byte identity and cross-restore against the reference
# --------------------------------------------------------------------------

CELLS = [("tiering", 0), ("tiering", 1), ("leveling", 0), ("leveling", 1),
         ("adaptive", 1)]


def _ref_params(p):
    from repro.core.params import SLSMParams as RefParams
    from repro.core.params import TuningPolicy as RefTuning
    return RefParams(**{**dataclasses.asdict(p),
                        "tuning": RefTuning(**dataclasses.asdict(p.tuning))})


def _script(adaptive: bool):
    """The op stream of a cell: writes, a snapshot mid-stream, and — for
    the adaptive cell — a read-heavy phase that retunes and two
    `run_tape` windows of writes, lookups and ranges."""
    ops = write_stream(n_ops=12)
    steps = [("op", op) for op in ops[:6]]
    if adaptive:
        probe = np.arange(0, 4000, 2, dtype=np.int32)
        steps += [("lookups", probe)] * 12
    steps += [("op", op) for op in ops[6:9]] + [("snapshot", None)]
    if adaptive:
        rng = np.random.default_rng(5)
        for _ in range(2):
            k = rng.integers(0, 4000, 40).astype(np.int32)
            steps.append(("tape", [
                TapeChunk("write", k[:30], k[:30] * 3),
                TapeChunk("lookup", k[::2], k[::2]),
                TapeChunk("write", k[30:], k[30:],
                          np.full(10, -1, np.int32)),
                TapeChunk("range", np.array([100, 900], np.int32),
                          np.array([700, 1800], np.int32))]))
    steps += [("op", op) for op in ops[9:]]
    return steps


def _drive(eng, steps):
    for kind, arg in steps:
        if kind == "op":
            apply_ops(eng, [arg])
        elif kind == "lookups":
            eng.lookup_many(arg)
        elif kind == "tape":
            eng.run_tape(arg)
        else:
            eng.snapshot()


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """Each cell run durably through the reference and the port, lazily
    and once."""
    from repro.engine import SLSM as RefSLSM
    from repro.engine import LevelingPolicy as RefLeveling
    from repro.engine import wal as RWAL
    out = {}

    def get(cell):
        if cell not in out:
            policy, budget = cell
            adaptive = policy == "adaptive"
            p = small_params(adaptive, merge_budget=budget)
            leveling = policy == "leveling"
            base = tmp_path_factory.mktemp(f"{policy}{budget}")
            steps = _script(adaptive)
            ref = RefSLSM(_ref_params(p), RefLeveling() if leveling else None,
                          durability=RWAL.Durability(base / "ref",
                                                     fsync=False))
            port = port_engine(p, WAL.Durability(base / "port", fsync=False),
                               LevelingPolicy() if leveling else None)
            _drive(ref, steps)
            _drive(port, steps)
            ref.durability.close()
            port.durability.close()
            if adaptive:
                assert port.stats["retunes"] >= 1
            out[cell] = dict(base=base, ref=ref, port=port)
        return out[cell]

    return get


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}{b}" for a, b in CELLS])
def test_same_stream_same_bytes(cells, cell):
    """The reference and the port write byte-identical `wal.log` and
    snapshot leaf files, and an equal `meta.json`."""
    c = cells(cell)
    ref_dir, port_dir = c["base"] / "ref", c["base"] / "port"
    names = _files(ref_dir)
    assert names == _files(port_dir)
    assert "wal.log" in names and any(n.endswith("meta.json") for n in names)
    for n in names:
        a, b = (ref_dir / n).read_bytes(), (port_dir / n).read_bytes()
        if n.endswith("meta.json"):
            assert json.loads(a) == json.loads(b), n
        else:
            assert a == b, n
    kinds = [r.kind for r in WAL.read_wal(port_dir / "wal.log")[0]]
    assert kinds[0] == WAL.REC_META
    assert (WAL.REC_RETUNE in kinds) == (cell[0] == "adaptive")


def _ref_leaves(state):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}{b}" for a, b in CELLS])
def test_cross_restore(cells, cell):
    """The port restores the reference's directory and the reference the
    port's: bitwise-equal state leaves (dtypes included) and answers,
    equal to the engines that wrote them."""
    from repro.engine import SLSM as RefSLSM
    c = cells(cell)
    port = SLSM.restore(str(c["base"] / "ref"), device="cpu")
    ref = RefSLSM.restore(str(c["base"] / "port"))
    assert port.stats["replayed_records"] == ref.stats["replayed_records"] > 0
    want = _ref_leaves(ref.state)
    got = convert.state_to_leaves(port.state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, i
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
    assert port.tuner.active == ref.tuner.active
    answers = probe_answers(port)
    assert_same_answers(answers, probe_answers(ref))
    assert_same_answers(answers, probe_answers(c["port"]))


def test_port_reattaches_to_a_pallas_reference_directory(tmp_path):
    """A directory the reference wrote with ``backend="pallas"``: its
    fingerprint differs only in ``backend``, which the port ignores."""
    from repro.engine import SLSM as RefSLSM
    from repro.engine import wal as RWAL
    p = small_params()
    ref = RefSLSM(dataclasses.replace(_ref_params(p), backend="pallas"),
                  durability=RWAL.Durability(tmp_path, fsync=False))
    keys = np.arange(10, dtype=np.int32)
    ref.insert(keys, keys * 7)             # staged only: no kernel runs
    ref.durability.close()
    eng = SLSM.restore(str(tmp_path), device="cpu")
    assert eng.p == p
    v, f = eng.lookup_many(keys)
    assert f.all() and (v == keys * 7).all()
    eng.insert(keys + 10, keys)            # the reattached log goes on
    eng.durability.close()
    assert durable_write_ops(tmp_path / "wal.log") == 2


# --------------------------------------------------------------------------
# small cases
# --------------------------------------------------------------------------

def test_adopted_snapshot_refreshes_run_occupancy(tmp_path):
    """Under adaptive tuning lookups skip the structures `SLSM.runs`
    marks empty. A restore from a snapshot with no WAL tail must read
    the occupancy from the adopted state: the stale value of a fresh
    engine, no run anywhere, misses every key on the disk levels."""
    p = small_params(adaptive=True)
    eng = port_engine(p, WAL.Durability(tmp_path, fsync=False))
    ops = write_stream(n_ops=12)
    apply_ops(eng, ops)
    eng.snapshot()
    eng.durability.close()
    got = SLSM.restore(str(tmp_path), device="cpu")
    assert got.stats["replayed_records"] == 0
    assert got.runs == host_occupancy(got.state) != (0, ())
    assert sum(got.runs[1]) > 0
    answers = probe_answers(got)
    assert_same_answers(answers, probe_answers(eng))
    got.runs = (0, (0,) * got.n_levels)  # nothing occupied: stale
    _, found = got.lookup_many(np.arange(0, 4000, 3, dtype=np.int32))
    assert found.sum() < answers[1].sum(), "the stale value missed no key"


def test_snapshot_levels_must_match_meta(tmp_path):
    """Adoption takes exactly the meta's disk levels: a meta that names
    another count is refused, not guessed around."""
    eng = port_engine(small_params(), WAL.Durability(tmp_path, fsync=False))
    apply_ops(eng, write_stream(n_ops=12))
    snap = eng.snapshot()
    eng.durability.close()
    meta = json.loads((snap / "meta.json").read_text())
    assert meta["n_levels"] == eng.n_levels >= 1
    meta["n_levels"] += 1
    (snap / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(WAL.SnapshotError, match="disk levels"):
        SLSM.restore(str(tmp_path), device="cpu")


def test_replica_promote_and_demote(tmp_path):
    """A replica refuses writes but applies shipped records; promote()
    bumps the epoch and makes it writable; demote() fences it."""
    p = small_params()
    ops = write_stream(n_ops=6)
    eng = port_engine(p, WAL.Durability(tmp_path, fsync=False))
    apply_ops(eng, ops[:3])
    eng.durability.close()
    rep = SLSM.open_replica(str(tmp_path), device="cpu")
    with pytest.raises(RuntimeError, match="replica"):
        apply_ops(rep, ops[3:4])
    dels = ops[3][1]                       # ops[3] is a delete
    shipped = [WAL.WalRecord(100, WAL.REC_WRITE2,
                             WAL.encode_write(dels, np.zeros_like(dels),
                                              np.full_like(dels, -1)))]
    assert rep.apply_replicated(shipped) == 1
    rep.promote()
    assert rep.durability.writer.epoch == 1
    assert rep.stats["promotions"] == 1
    apply_ops(rep, ops[4:5])
    records = WAL.read_wal(tmp_path / "wal.log")[0]
    assert records[-1].epoch == 1 and records[-2].epoch == 0
    rep.demote()
    assert rep.stats["demotions"] == 1
    with pytest.raises(RuntimeError, match="fenced"):
        apply_ops(rep, ops[5:6])
    with pytest.raises(RuntimeError, match="fenced"):
        rep.run_tape([TapeChunk("write", ops[5][1], ops[5][1])])
    want = port_engine(p)
    apply_ops(want, ops[:5])
    assert_same_answers(probe_answers(rep), probe_answers(want))


def test_restore_and_durable_engine_need_a_card(tmp_path, monkeypatch):
    """Without a CUDA device a durable engine and a restore raise unless
    ``device="cpu"`` is passed, before the directory is touched."""
    eng = port_engine(small_params(), WAL.Durability(tmp_path / "d",
                                                     fsync=False))
    apply_ops(eng, write_stream(n_ops=2))
    eng.durability.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLSM.restore(str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLSM(small_params(), durability=str(tmp_path / "new"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SLSM.restore(str(tmp_path / "none"))
    assert not (tmp_path / "new").exists()
    assert not (tmp_path / "none").exists()
    assert SLSM.restore(str(tmp_path / "d"), device="cpu").stats[
        "replayed_records"] == 2
