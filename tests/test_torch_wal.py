"""The port's durability layer (`repro_torch.engine.wal`) and checkpoint
facade (`repro_torch.checkpoint`), test for test as the reference's
`tests/durability/test_wal.py` covers `repro.engine.wal`: record
framing, torn tails, the writer, epochs, `append_frame`, the tailer
across segment rolls, the snapshot codec (bfloat16 included), the
Durability manager, the engine's restore edge cases and checkpoints.
Then cross-reading: frames, segment chains, snapshots and checkpoints
written by either package are read by the other with equal records,
leaves and dtypes. Everything runs on the CPU (``device="cpu"``).

The engine helpers at the top (tiny geometry, op stream, answers) are
shared with `test_torch_durability.py`."""
import json
import os
import struct
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.params import SLSMParams, TuningPolicy  # noqa: E402
from repro_torch.engine import SLSM  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402

KEY_SPACE = 4000


# --------------------------------------------------------------------------
# engine helpers (the reference harness's, for either package's engine)
# --------------------------------------------------------------------------

def small_params(adaptive: bool = False, **kw) -> SLSMParams:
    """The reference harness's tiny geometry (R=2, Rn=32, D=2, mu=16):
    a short stream seals, flushes, spills and compacts; `adaptive`
    turns the tuner on with a small decision interval."""
    tuning = (TuningPolicy(mode="adaptive", interval=64)
              if adaptive else TuningPolicy())
    base = dict(R=2, Rn=32, eps=1e-2, D=2, m=1.0, mu=16, max_levels=3,
                max_range=2048, merge_budget=1, tuning=tuning)
    base.update(kw)
    return SLSMParams(**base)


def port_engine(p: SLSMParams, durability=None, policy=None) -> SLSM:
    return SLSM(p, policy, device="cpu", durability=durability)


def write_stream(n_ops: int = 12, op_size: int = 48, seed: int = 0):
    """The reference harness's op stream: every 4th op deletes a third
    of its keys, the rest insert over a small key space. One entry is
    one engine call, so one WAL write record."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        keys = rng.integers(0, KEY_SPACE, op_size).astype(np.int32)
        if i % 4 == 3:
            ops.append(("delete", keys[:op_size // 3], None))
        else:
            vals = rng.integers(0, 1 << 20, op_size).astype(np.int32)
            ops.append(("insert", keys, vals))
    return ops


def apply_ops(eng, ops, upto=None):
    """Feed `ops[:upto]` (None = all) through insert/delete."""
    for kind, keys, vals in (ops if upto is None else ops[:upto]):
        if kind == "insert":
            eng.insert(keys, vals)
        else:
            eng.delete(keys)


def probe_answers(eng, key_space: int = KEY_SPACE):
    """A strided lookup over the key space and three range windows, as
    numpy."""
    probe = np.arange(0, key_space, 3, dtype=np.int32)
    v, f = eng.lookup_many(probe)
    rs = []
    for lo, hi in ((0, key_space), (123, 456), (1000, 3500)):
        k, vv = eng.range(lo, hi)
        rs.append((np.asarray(k), np.asarray(vv)))
    return np.asarray(v), np.asarray(f), rs


def assert_same_answers(got, want):
    gv, gf, gr = got
    wv, wf, wr = want
    np.testing.assert_array_equal(gf, wf)
    np.testing.assert_array_equal(gv, wv)
    assert len(gr) == len(wr)
    for (gk, gvv), (wk, wvv) in zip(gr, wr):
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gvv, wvv)


# --------------------------------------------------------------------------
# record framing
# --------------------------------------------------------------------------

def test_write_codec_roundtrip():
    k = np.array([5, -3, 7], np.int32)
    v = np.array([50, -30, 70], np.int32)
    w = np.array([1, -1, 1], np.int8)
    k2, v2, w2 = WAL.decode_write(WAL.encode_write(k, v, w))
    np.testing.assert_array_equal(k, k2)
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(w, w2)
    k3, v3, w3 = WAL.decode_write(WAL.encode_write([], [], []))
    assert k3.size == 0 and v3.size == 0 and w3.size == 0


def test_write_codec_shape_mismatch():
    with pytest.raises(ValueError, match="must match"):
        WAL.encode_write([1, 2], [1], [1, 1])
    with pytest.raises(ValueError, match="must match"):
        WAL.encode_write([1, 2], [1, 2], [1])


def test_legacy_write_record_decodes_as_weighted():
    """A format-1 REC_WRITE payload (TOMBSTONE value = delete) decodes to
    weight -1 and payload 0 on the TOMBSTONE lanes, +1 elsewhere."""
    from repro_torch.core.params import TOMBSTONE
    k = np.array([5, 9, 11], np.int32)
    v = np.array([50, TOMBSTONE, 110], np.int32)
    payload = struct.pack("<I", 3) + k.tobytes() + v.tobytes()
    k2, v2, w2 = WAL.decode_write(payload, WAL.REC_WRITE)
    np.testing.assert_array_equal(k2, k)
    np.testing.assert_array_equal(v2, [50, 0, 110])
    np.testing.assert_array_equal(w2, [1, -1, 1])


def test_read_wal_missing_and_bad_magic(tmp_path):
    assert WAL.read_wal(tmp_path / "nope.log") == ([], 0)
    bad = tmp_path / "bad.log"
    bad.write_bytes(b"NOTAWAL!" + WAL.encode_record(0, WAL.REC_RETUNE, b"x"))
    assert WAL.read_wal(bad) == ([], 0)


def _write_raw(path, recs):
    path.write_bytes(WAL.MAGIC + b"".join(recs))


def test_read_wal_stops_at_crc_break(tmp_path):
    p = tmp_path / "wal.log"
    good = [WAL.encode_record(i, WAL.REC_RETUNE, f"r{i}".encode())
            for i in range(3)]
    blob = WAL.MAGIC + b"".join(good)
    off = len(WAL.MAGIC) + len(good[0]) + WAL._HEADER.size
    blob = blob[:off] + bytes([blob[off] ^ 0xFF]) + blob[off + 1:]
    p.write_bytes(blob)
    records, good_bytes = WAL.read_wal(p)
    assert [r.seqno for r in records] == [0]
    assert good_bytes == len(WAL.MAGIC) + len(good[0])


def test_read_wal_stops_at_seqno_gap(tmp_path):
    p = tmp_path / "wal.log"
    _write_raw(p, [WAL.encode_record(0, WAL.REC_RETUNE, b"a"),
                   WAL.encode_record(1, WAL.REC_RETUNE, b"b"),
                   WAL.encode_record(3, WAL.REC_RETUNE, b"gap")])
    records, _ = WAL.read_wal(p)
    assert [r.seqno for r in records] == [0, 1]


def test_read_wal_drops_short_tail(tmp_path):
    p = tmp_path / "wal.log"
    rec = WAL.encode_record(0, WAL.REC_WRITE2,
                            WAL.encode_write([1], [2], [1]))
    torn = WAL.encode_record(1, WAL.REC_WRITE2,
                             WAL.encode_write([3], [4], [1]))
    for cut in (1, WAL._HEADER.size, len(torn) - 1):
        _write_raw(p, [rec, torn[:cut]])
        records, good = WAL.read_wal(p)
        assert [r.seqno for r in records] == [0]
        assert good == len(WAL.MAGIC) + len(rec)


def test_read_wal_rejects_implausible_length(tmp_path):
    p = tmp_path / "wal.log"
    head = WAL._HEADER.pack(0, WAL._MAX_PAYLOAD + 1, 0, WAL.REC_WRITE2, 0)
    _write_raw(p, [head + b"x" * 64])
    assert WAL.read_wal(p)[0] == []


def test_read_wal_rejects_stale_prior_epoch_tail(tmp_path):
    """Stale frames of an earlier lineage past a record-aligned cut are
    CRC-valid and seqno-consecutive; their older epoch rejects them."""
    p = tmp_path / "wal.log"
    old = [WAL.encode_record(s, WAL.REC_RETUNE, b"old", epoch=0)
           for s in range(10)]
    new = [WAL.encode_record(s, WAL.REC_RETUNE, b"new", epoch=1)
           for s in (6, 7)]
    stale = old[8:]
    _write_raw(p, old[:6] + new + stale)
    records, good = WAL.read_wal(p)
    assert [r.seqno for r in records] == list(range(8))
    assert [r.epoch for r in records] == [0] * 6 + [1, 1]
    assert WAL.check_frame(stale[0]).seqno == 8
    assert good == os.path.getsize(p) - sum(len(f) for f in stale)
    w = WAL.WalWriter(p)
    assert (w.next_seqno, w.epoch) == (8, 1)
    w.close()
    assert os.path.getsize(p) == good


def test_check_frame_total():
    frame = WAL.encode_record(7, WAL.REC_RETUNE, b"x", epoch=3)
    rec = WAL.check_frame(frame)
    assert (rec.seqno, rec.kind, rec.payload, rec.epoch) == (
        7, WAL.REC_RETUNE, b"x", 3)
    assert WAL.check_frame(frame[:-1]) is None
    assert WAL.check_frame(frame + b"y") is None
    bad = bytearray(frame)
    bad[WAL._HEADER.size] ^= 0xFF
    assert WAL.check_frame(bytes(bad)) is None
    assert WAL.check_frame(b"") is None


# --------------------------------------------------------------------------
# WalWriter
# --------------------------------------------------------------------------

def test_writer_resumes_and_truncates_torn_tail(tmp_path):
    p = tmp_path / "wal.log"
    w = WAL.WalWriter(p)
    assert w.append(WAL.REC_RETUNE, b"a") == 0
    assert w.append(WAL.REC_RETUNE, b"b") == 1
    w.sync(fsync=False)
    w.close()
    size = p.stat().st_size
    with open(p, "r+b") as f:
        f.truncate(size - 3)
    w2 = WAL.WalWriter(p)
    assert w2.last_seqno == 0
    assert p.stat().st_size == size - 3 - (WAL._HEADER.size + 1 - 3)
    assert w2.append(WAL.REC_RETUNE, b"c") == 1
    w2.close()
    records, _ = WAL.read_wal(p)
    assert [(r.seqno, r.payload) for r in records] == [(0, b"a"), (1, b"c")]


def test_writer_unreadable_log_starts_over(tmp_path):
    p = tmp_path / "wal.log"
    p.write_bytes(b"garbage that is not a WAL at all")
    w = WAL.WalWriter(p)
    assert w.next_seqno == 0
    w.append(WAL.REC_RETUNE, b"x")
    w.close()
    records, _ = WAL.read_wal(p)
    assert [r.payload for r in records] == [b"x"]


def test_writer_min_next_seqno(tmp_path):
    w = WAL.WalWriter(tmp_path / "wal.log", min_next_seqno=17)
    assert w.append(WAL.REC_RETUNE, b"x") == 17
    w.close()


def test_writer_append_buffers_until_sync(tmp_path):
    p = tmp_path / "wal.log"
    w = WAL.WalWriter(p)
    w.append(WAL.REC_RETUNE, b"x")
    assert WAL.read_wal(p)[0] == []
    w.sync(fsync=False)
    assert len(WAL.read_wal(p)[0]) == 1
    assert w.syncs == 1
    w.sync(fsync=False)
    assert w.syncs == 1
    w.close()


def test_writer_bump_epoch_stamps_and_resumes(tmp_path):
    p = tmp_path / "wal.log"
    w = WAL.WalWriter(p)
    w.append(WAL.REC_RETUNE, b"a")
    assert w.bump_epoch() == 1
    w.append(WAL.REC_RETUNE, b"b")
    w.close()
    records, _ = WAL.read_wal(p)
    assert [(r.seqno, r.epoch) for r in records] == [(0, 0), (1, 1)]
    w2 = WAL.WalWriter(p)
    assert w2.epoch == 1
    w2.append(WAL.REC_RETUNE, b"c")
    w2.close()
    assert WAL.read_wal(p)[0][-1].epoch == 1


def test_append_frame_verbatim_and_validated(tmp_path):
    leader = WAL.WalWriter(tmp_path / "leader.log")
    for i in range(3):
        leader.append(WAL.REC_RETUNE, f"r{i}".encode())
    leader.close()
    frames = [WAL.encode_record(r.seqno, r.kind, r.payload, r.epoch)
              for r in WAL.read_wal(leader.path)[0]]
    f = WAL.WalWriter(tmp_path / "follower.log")
    with pytest.raises(ValueError, match="seqno"):
        f.append_frame(frames[1])
    f.append_frame(frames[0])
    bad = bytearray(frames[1])
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="malformed"):
        f.append_frame(bytes(bad))
    f.append_frame(frames[1])
    f.append_frame(frames[2])
    with pytest.raises(ValueError, match="epoch regressed"):
        f.bump_epoch()
        f.append_frame(WAL.encode_record(3, WAL.REC_RETUNE, b"x", epoch=0))
    f.close()
    assert (tmp_path / "follower.log").read_bytes() == \
        (tmp_path / "leader.log").read_bytes()


def test_wal_tailer_yields_each_frame_once(tmp_path):
    p = tmp_path / "wal.log"
    w = WAL.WalWriter(p)
    t = WAL.WalTailer(p)
    assert t.poll() == []
    w.append(WAL.REC_RETUNE, b"a")
    assert t.poll() == []
    w.sync(fsync=False)
    got = t.poll()
    assert [(r.seqno, r.payload) for r, _ in got] == [(0, b"a")]
    assert t.poll() == []
    w.append(WAL.REC_RETUNE, b"b")
    w.append(WAL.REC_RETUNE, b"c")
    w.sync(fsync=False)
    assert [r.seqno for r, _ in t.poll(max_records=1)] == [1]
    assert [r.seqno for r, _ in t.poll()] == [2]
    frame = WAL.encode_record(3, WAL.REC_RETUNE, b"d", epoch=0)
    with open(p, "ab") as fh:
        fh.write(frame[:7])
    assert t.poll() == []
    with open(p, "ab") as fh:
        fh.write(frame[7:])
    assert [r.seqno for r, _ in t.poll()] == [3]
    t2 = WAL.WalTailer(p)
    assert b"".join(f for _, f in t2.poll()) == p.read_bytes()[len(WAL.MAGIC):]
    w.close()


def test_wal_tailer_rewind_retransmits(tmp_path):
    p = tmp_path / "wal.log"
    w = WAL.WalWriter(p)
    offs = [len(WAL.MAGIC)]
    for i in range(3):
        w.append(WAL.REC_RETUNE, f"r{i}".encode())
        w.sync(fsync=False)
        offs.append(w.size)
    t = WAL.WalTailer(p)
    assert [r.seqno for r, _ in t.poll()] == [0, 1, 2]
    t.rewind(offs[1], 1)
    assert [r.seqno for r, _ in t.poll()] == [1, 2]
    w.close()


def test_wal_tailer_follows_sealing_that_leaves_active_empty(tmp_path):
    """Segments that seal on every sync leave the active file empty
    whenever the tailer looks; a cursor parked at its head still finds
    the frames sealed underneath it."""
    dur = WAL.Durability(tmp_path, fsync=False, segment_bytes=1)
    dur.log_retune("r0")
    dur.sync()
    t = WAL.WalTailer(dur.wal_path)
    assert [r.seqno for r, _ in t.poll()] == [0]
    assert t.poll() == []
    for i in range(1, 4):
        dur.log_retune(f"r{i}")
        dur.sync()
    assert (dur.wal_path.read_bytes() == WAL.MAGIC
            and dur.stats()["wal_segments"] >= 4)
    assert [r.seqno for r, _ in t.poll()] == [1, 2, 3]
    assert t.poll() == []
    dur.log_retune("r4")
    dur.sync()
    assert [r.seqno for r, _ in t.poll()] == [4]
    dur.close()


def test_segment_roll_prune_and_chain(tmp_path):
    """Rolls keep one gapless seqno stream across files; the tailer
    reads it across the rolls; prune drops only sealed segments at or
    below the watermark."""
    dur = WAL.Durability(tmp_path, fsync=False, segment_bytes=200)
    for i in range(12):
        dur.log_write(np.arange(8, dtype=np.int32) + i,
                      np.arange(8, dtype=np.int32),
                      np.ones(8, dtype=np.int8))
        dur.sync()
    segs = WAL.list_segments(tmp_path)
    assert len(segs) >= 3 and dur.stats()["wal_rolls"] == len(segs)
    records, _ = WAL.read_wal_chain(tmp_path)
    assert [r.seqno for r in records] == list(range(12))
    shipped = WAL.WalTailer(dur.wal_path).poll()
    assert [r.seqno for r, _ in shipped] == list(range(12))
    assert [f for _, f in shipped] == WAL.chain_frames(tmp_path, 0)
    cut = segs[1][0]                       # first seqno of segment 2
    assert dur.prune(cut - 1) == 1
    assert [s for s, _ in WAL.list_segments(tmp_path)] == [
        s for s, _ in segs[1:]]
    assert WAL.read_wal_chain(tmp_path)[0][0].seqno == cut
    dur.close()


# --------------------------------------------------------------------------
# snapshot codec
# --------------------------------------------------------------------------

def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _leaves(rng):
    return [torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(16,))).to(torch.bfloat16),
            torch.arange(6, dtype=torch.int32),
            torch.tensor(np.array([1, 2 ** 32 - 1], np.uint32)),
            torch.tensor(7, dtype=torch.int32)]


def test_snapshot_roundtrip_with_bfloat16(tmp_path, rng):
    leaves = _leaves(rng)
    path = WAL.write_snapshot(tmp_path, 3, leaves, {"seqno": 3})
    assert path.name == "snap_3"
    got, meta = WAL.read_snapshot(path)
    assert meta["seqno"] == 3
    assert [e["dtype"] for e in meta["leaves"]] == [
        "float32", "bfloat16", "int32", "uint32", "int32"]
    for a, b in zip(leaves, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bytes(a), _bytes(b))


def test_snapshot_corruption_detected(tmp_path, rng):
    path = WAL.write_snapshot(tmp_path, 1, _leaves(rng), {})
    leaf = path / "leaf_0.npy"
    blob = bytearray(leaf.read_bytes())
    blob[-1] ^= 0xFF
    leaf.write_bytes(bytes(blob))
    with pytest.raises(WAL.SnapshotError, match="corruption"):
        WAL.read_snapshot(path)


def test_list_snapshots_numeric_order_and_keep_last(tmp_path, rng):
    for n in (2, 10, 1):
        WAL.write_snapshot(tmp_path, n, _leaves(rng), {})
    assert [n for n, _ in WAL.list_snapshots(tmp_path)] == [1, 2, 10]
    WAL.write_snapshot(tmp_path, 11, _leaves(rng), {}, keep_last=2)
    assert [n for n, _ in WAL.list_snapshots(tmp_path)] == [10, 11]


def test_gc_tmp_snapshots(tmp_path):
    orphan = tmp_path / "snap_5.tmp-1234"
    orphan.mkdir()
    (orphan / "leaf_0.npy").write_bytes(b"partial")
    WAL.gc_tmp_snapshots(tmp_path)
    assert not orphan.exists()
    assert WAL.list_snapshots(tmp_path) == []


def test_load_latest_falls_back_past_corruption(tmp_path, rng, capsys):
    leaves = _leaves(rng)
    WAL.write_snapshot(tmp_path, 1, leaves, {"tag": "old"})
    bad = WAL.write_snapshot(tmp_path, 2, leaves, {"tag": "new"})
    (bad / "leaf_1.npy").write_bytes(b"smashed")
    num, got, meta = WAL.load_latest_snapshot(tmp_path)
    assert num == 1 and meta["tag"] == "old"
    assert len(got) == len(leaves)
    assert "skipping bad snapshot snap_2" in capsys.readouterr().err


# --------------------------------------------------------------------------
# params fingerprint
# --------------------------------------------------------------------------

def test_params_dict_roundtrip():
    p = SLSMParams(R=3, Rn=64, eps=1e-2, D=2, m=1.0, mu=16, max_levels=2,
                   eps_per_level=(1e-2, 5e-3),
                   tuning=TuningPolicy(mode="adaptive", interval=32))
    d = WAL.params_to_dict(p)
    q = WAL.params_from_dict(json.loads(json.dumps(d)))
    assert q == p
    assert d["backend"] == "jnp"            # the reference's field set


def test_params_dict_matches_reference_field_set_and_order():
    """The fingerprint's params are the reference's `params_to_dict`,
    key for key and in its order, for the reference's default backend."""
    import dataclasses

    from repro.core.params import SLSMParams as RefParams
    from repro.core.params import TuningPolicy as RefTuning
    from repro.engine import wal as RWAL
    p = small_params(adaptive=True, eps_per_level=(1e-2, 5e-3, 1e-3))
    ref = RefParams(**{**dataclasses.asdict(p),
                       "tuning": RefTuning(**dataclasses.asdict(p.tuning))})
    want = RWAL.params_to_dict(ref)
    got = WAL.params_to_dict(p)
    assert list(got) == list(want)
    assert json.dumps(got) == json.dumps(want)
    assert RWAL.params_from_dict(got) == ref
    assert WAL.params_from_dict(RWAL.params_to_dict(
        dataclasses.replace(ref, backend="pallas"))) == p


# --------------------------------------------------------------------------
# Durability manager
# --------------------------------------------------------------------------

def test_ensure_header_rejects_foreign_engine(tmp_path):
    d1 = WAL.Durability(tmp_path, fsync=False)
    d1.ensure_header({"driver": "slsm", "params": {"R": 2}})
    d1.close()
    d2 = WAL.Durability(tmp_path, fsync=False)
    d2.ensure_header({"driver": "slsm", "params": {"R": 2}})
    d2.close()
    d3 = WAL.Durability(tmp_path, fsync=False)
    with pytest.raises(ValueError, match="different engine"):
        d3.ensure_header({"driver": "sharded", "params": {"R": 2}})
    d3.close()


def test_ensure_header_ignores_backend_and_format(tmp_path):
    """A fingerprint the reference wrote with ``backend="pallas"`` (and
    another record format) matches the port's; any other params change
    does not."""
    d1 = WAL.Durability(tmp_path, fsync=False)
    d1.ensure_header({"driver": "slsm", "wal": 1,
                      "params": {"R": 2, "backend": "pallas"}})
    d1.close()
    d2 = WAL.Durability(tmp_path, fsync=False)
    d2.ensure_header({"driver": "slsm", "wal": 2,
                      "params": {"R": 2, "backend": "jnp"}})
    with pytest.raises(ValueError, match="different engine"):
        d2.ensure_header({"driver": "slsm", "params": {"R": 3}})
    d2.close()


def test_should_snapshot_threshold(tmp_path):
    dur = WAL.Durability(tmp_path, fsync=False, snapshot_every_bytes=256)
    assert not dur.should_snapshot()
    while not dur.should_snapshot():
        dur.log_write(np.arange(8, dtype=np.int32),
                      np.arange(8, dtype=np.int32),
                      np.ones(8, dtype=np.int8))
        dur.sync()
    st = dur.stats()
    assert st["bytes_since_snapshot"] >= 256
    assert st["wal_records"] == st["wal_syncs"] > 0
    assert set(st) == {"wal_bytes", "wal_active_bytes", "wal_segments",
                       "wal_rolls", "wal_pruned_bytes",
                       "wal_pruned_segments", "wal_records", "wal_syncs",
                       "replica", "snapshots", "snapshot_ms_last",
                       "bytes_since_snapshot"}
    dur.close()


def test_as_durability_coercions(tmp_path):
    assert WAL.as_durability(None) is None
    dur = WAL.Durability(tmp_path)
    assert WAL.as_durability(dur) is dur
    made = WAL.as_durability(str(tmp_path / "sub"))
    assert isinstance(made, WAL.Durability)
    assert made.dir == Path(tmp_path / "sub")


# --------------------------------------------------------------------------
# engine restore edge cases
# --------------------------------------------------------------------------

def test_restore_without_snapshot_replays_from_genesis(tmp_path):
    p = small_params()
    dur = WAL.Durability(tmp_path, fsync=False,
                         snapshot_every_bytes=1 << 30)
    eng = port_engine(p, durability=dur)
    ops = write_stream(n_ops=6)
    apply_ops(eng, ops)
    dur.close()
    assert WAL.list_snapshots(tmp_path) == []
    got = SLSM.restore(str(tmp_path), device="cpu")
    assert got.p == p
    assert got.stats["replayed_records"] == 6
    assert got.stats["restore_us"] > 0
    assert_same_answers(probe_answers(got), probe_answers(eng))


def test_restore_empty_dir_is_fresh_engine(tmp_path):
    with pytest.raises(ValueError, match="nothing to restore"):
        SLSM.restore(str(tmp_path / "a"), device="cpu")
    eng = SLSM.restore(str(tmp_path), params=small_params(), device="cpu")
    assert eng.stats["replayed_records"] == 0
    vals, found = eng.lookup_many(np.array([1, 2, 3], np.int32))
    assert not np.asarray(found).any()


def test_restore_then_continue_writing(tmp_path):
    """The restored engine's log appends where the crashed one stopped:
    seqnos stay strictly consecutive."""
    p = small_params()
    dur = WAL.Durability(tmp_path, fsync=False)
    eng = port_engine(p, durability=dur)
    ops = write_stream(n_ops=6)
    apply_ops(eng, ops[:4])
    dur.close()
    got = SLSM.restore(str(tmp_path), device="cpu")
    apply_ops(got, ops[4:])
    got.durability.close()
    records, _ = WAL.read_wal(Path(tmp_path) / "wal.log")
    seqs = [r.seqno for r in records]
    assert seqs == list(range(len(seqs)))
    assert sum(1 for r in records if r.kind in WAL.WRITE_KINDS) == 6
    want = port_engine(p)
    apply_ops(want, ops)
    assert_same_answers(probe_answers(got), probe_answers(want))


# --------------------------------------------------------------------------
# repro_torch.checkpoint
# --------------------------------------------------------------------------

def _tree(rng):
    return {"w": torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32),
            "b": torch.tensor(rng.normal(size=(8,))).to(torch.bfloat16)}


def test_checkpoint_roundtrip(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    restored, step = mgr.restore(tree, device="cpu")
    assert step == 1
    assert torch.equal(tree["w"], restored["w"])
    assert restored["b"].dtype == torch.bfloat16
    assert torch.equal(tree["b"].view(torch.int16),
                       restored["b"].view(torch.int16))


def test_checkpoint_keep_last_and_latest(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for step in range(4):
        mgr.save(step, tree)
    assert mgr.latest_step() == 3
    assert sorted(d.name for d in Path(tmp_path).iterdir()) == ["step_2",
                                                                "step_3"]


def test_checkpoint_corruption_detected(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    leaf = next(Path(tmp_path, "step_1").glob("leaf_*.npy"))
    blob = bytearray(leaf.read_bytes())
    blob[-1] ^= 0xFF
    leaf.write_bytes(bytes(blob))
    with pytest.raises(WAL.SnapshotError, match="corruption"):
        mgr.restore(tree, device="cpu")


def test_checkpoint_partial_save_invisible(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager
    orphan = tmp_path / "step_9.tmp-777"
    orphan.mkdir()
    (orphan / "leaf_0.npy").write_bytes(b"torn")
    mgr = CheckpointManager(str(tmp_path))
    assert not orphan.exists()
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree(rng), device="cpu")


def test_checkpoint_async_save(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(7, tree, blocking=False)
    tree["w"].zero_()                     # the save copied it already
    mgr.wait()
    assert Path(path).is_dir()
    restored, step = mgr.restore(tree, device="cpu")
    assert step == 7
    assert restored["w"].abs().sum() > 0


def test_checkpoint_restore_needs_a_card_unless_cpu(tmp_path, rng,
                                                    monkeypatch):
    from repro_torch.checkpoint import CheckpointManager
    tree = _tree(rng)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore(tree)


# --------------------------------------------------------------------------
# cross-reading: what either package writes, the other reads
# --------------------------------------------------------------------------

def _ref():
    from repro.engine import wal as RWAL
    return RWAL


def _chain(wal_mod, directory):
    """A segmented log of writes and retunes through `wal_mod`."""
    dur = wal_mod.Durability(directory, fsync=False, segment_bytes=160)
    dur.ensure_header({"driver": "slsm", "params": {"R": 2}, "wal": 2})
    for i in range(9):
        if i % 3 == 2:
            dur.log_retune(f"read{i}")
        else:
            k = np.arange(5, dtype=np.int32) * (i + 1)
            dur.log_write(k, -k, np.where(k % 2 == 0, 1, -1).astype(np.int8))
        dur.sync()
    dur.close()


def _records(records):
    return [(r.seqno, r.kind, r.payload, r.epoch) for r in records]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cross_read_frames_and_segment_chain(tmp_path, writer):
    RWAL = _ref()
    a = tmp_path / "a"
    b = tmp_path / "b"
    _chain(WAL if writer == "port" else RWAL, a)
    _chain(RWAL if writer == "port" else WAL, b)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert len(WAL.list_segments(a)) >= 2
    for n in names:                     # the same bytes from both
        assert (a / n).read_bytes() == (b / n).read_bytes(), n
    for mod in (WAL, RWAL):
        got = _records(mod.read_wal_chain(a)[0])
        assert got == _records(RWAL.read_wal_chain(b)[0])
        assert [s for s, *_ in got] == list(range(10))
        shipped = mod.WalTailer(a / "wal.log").poll()
        assert [bytes(f) for _, f in shipped] == RWAL.chain_frames(b, 0)
    frame = WAL.encode_record(4, WAL.REC_WRITE2,
                              WAL.encode_write([1, 2], [3, 4], [1, -1]), 2)
    assert frame == RWAL.encode_record(
        4, RWAL.REC_WRITE2, RWAL.encode_write([1, 2], [3, 4], [1, -1]), 2)
    assert RWAL.check_frame(frame) == WAL.check_frame(frame)


def test_cross_read_snapshots(tmp_path, rng):
    """A snapshot of the same leaves is the same files from both (leaf
    bytes, meta.json); each package reads the other's with the same
    dtypes and bits (bfloat16 with no ml_dtypes on the port's side)."""
    import ml_dtypes

    RWAL = _ref()
    leaves = _leaves(rng)
    ref_leaves = [t.numpy() if t.dtype != torch.bfloat16 else
                  t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
                  for t in leaves]
    pp = WAL.write_snapshot(tmp_path / "port", 5, leaves, {"seqno": 5})
    rp = RWAL.write_snapshot(tmp_path / "ref", 5, ref_leaves, {"seqno": 5})
    assert sorted(p.name for p in pp.iterdir()) == sorted(
        p.name for p in rp.iterdir())
    for f in pp.iterdir():
        assert f.read_bytes() == (rp / f.name).read_bytes(), f.name
    got_ref, meta_ref = RWAL.read_snapshot(pp)
    got_port, meta_port = WAL.read_snapshot(rp)
    assert meta_ref == meta_port
    for t, a, g in zip(leaves, got_ref, got_port):
        assert a.dtype.name == str(t.dtype).replace("torch.", "")
        assert g.dtype == t.dtype and tuple(g.shape) == a.shape
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      _bytes(g).numpy())


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cross_read_checkpoints(tmp_path, rng, writer):
    """Checkpoints of the same nested tree: the same leaf order (dict
    keys sorted) and files; each facade restores the other's."""
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager as RefManager
    from repro_torch.checkpoint import CheckpointManager
    tree = {"z": _tree(rng), "a": torch.arange(5, dtype=torch.int32)}
    ref_tree = {"z": {"w": jnp.asarray(tree["z"]["w"].numpy()),
                      "b": jnp.asarray(tree["z"]["b"].float().numpy(),
                                       jnp.bfloat16)},
                "a": jnp.arange(5, dtype=jnp.int32)}
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    CheckpointManager(str(port_dir)).save(3, tree)
    RefManager(str(ref_dir)).save(3, ref_tree)
    for f in (ref_dir / "step_3").iterdir():
        assert f.read_bytes() == (port_dir / "step_3" / f.name).read_bytes()
    src = port_dir if writer == "port" else ref_dir
    got, step = CheckpointManager(str(src)).restore(tree, device="cpu")
    want, rstep = RefManager(str(src)).restore(ref_tree)
    assert step == rstep == 3
    for g, w in ((got["a"], want["a"]), (got["z"]["w"], want["z"]["w"]),
                 (got["z"]["b"], want["z"]["b"])):
        w = np.asarray(w)
        assert str(g.dtype).replace("torch.", "") == w.dtype.name
        np.testing.assert_array_equal(_bytes(g).numpy(),
                                      w.reshape(-1).view(np.uint8))
