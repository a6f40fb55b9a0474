"""Port parity of the sharded engine (`repro_torch.engine.sharded`) on the
CPU: seeded insert/delete/lookup/range/aggregate streams through the
reference `ShardedSLSM` (``backend="jnp"``) and the port, answers, the
whole stacked state and the merge counters bitwise equal after every
call and equal to the dict oracle; the tape; the WAL bytes, snapshot
leaves and restores both ways; and the shard-batched plain versions of
the four engine kernels against the reference's kernels under
`jax.vmap` (Pallas in interpret mode, and `ref.py`) and against S calls
of the single-tree plain version.

Three (params, shard count) cells run against the reference, whose
vmapped programs compile once per cell: SMALL with merge_budget 0 on 4
shards, adaptive SMALL with merge_budget 1 on 3 shards (lockstep
retunes), and SMALL with merge_budget 1 on 1 shard."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bloom as RBL  # noqa: E402
from repro.core.oracle import DictOracle  # noqa: E402
from repro.core.params import SLSMParams, TuningPolicy  # noqa: E402
from repro.engine import ShardedSLSM as RefSharded  # noqa: E402
from repro.engine import backlog_cost as ref_backlog_cost  # noqa: E402
from repro.engine import pad_pow2 as ref_pad_pow2  # noqa: E402
from repro.engine import pending_steps as ref_pending_steps  # noqa: E402
from repro.engine import shard_ids as ref_shard_ids  # noqa: E402
from repro.engine import tape as RTP  # noqa: E402
from repro.engine import wal as RWAL  # noqa: E402
from repro.engine.compaction import TieringPolicy as RefTiering  # noqa: E402
from repro.engine.scheduler import Occupancy as RefOcc  # noqa: E402
from repro.kernels.bloom_probe import (bloom_probe_op,  # noqa: E402
                                       bloom_probe_ref)
from repro.kernels.fence_lookup import (fence_lookup_op,  # noqa: E402
                                        fence_lookup_ref)
from repro.kernels.heap_merge import (heap_merge_op,  # noqa: E402
                                      heap_merge_ref)
from repro.kernels.range_merge import (range_merge_op,  # noqa: E402
                                       range_merge_ref)
from repro_torch import convert  # noqa: E402
from repro_torch.core import bloom as BL  # noqa: E402
from repro_torch.engine import SLSM, ShardedSLSM  # noqa: E402
from repro_torch.engine import TieringPolicy, backlog_cost  # noqa: E402
from repro_torch.engine import pad_pow2, shard_ids  # noqa: E402
from repro_torch.engine import wal as WAL  # noqa: E402
from repro_torch.engine.scheduler import Occupancy  # noqa: E402
from repro_torch.engine.scheduler import pending_steps  # noqa: E402
from repro_torch.engine.tape import TapeChunk  # noqa: E402
from repro_torch.kernels import bloom_probe as TBP  # noqa: E402
from repro_torch.kernels import fence_lookup as TFL  # noqa: E402
from repro_torch.kernels import heap_merge as THM  # noqa: E402
from repro_torch.kernels import range_merge as TRM  # noqa: E402
from test_torch_kernels import (_bloom_case, _fence_case, _runs,  # noqa: E402
                                _segments)

I32 = np.iinfo(np.int32)
SMALL = dict(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=3,
             max_range=512, cand_factor=16)
ADAPTIVE = TuningPolicy(mode="adaptive", interval=64, eps_floor=1e-3)
# the three cells held against the reference: name -> (params, shards)
CELLS = {"s4_budget0": (SLSMParams(**SMALL, merge_budget=0), 4),
         "s3_adaptive_budget1": (SLSMParams(**SMALL, merge_budget=1,
                                            tuning=ADAPTIVE), 3),
         "s1_budget1": (SLSMParams(**SMALL, merge_budget=1), 1)}
KEY_SPACE = 300      # a fixed-fleet test's keys; a cell's: `_space`
COUNTERS = ("seals", "flushes", "spills", "compactions", "retunes",
            "backlog_peak", "rows_merged_in", "rows_merged_out",
            "rows_annihilated", "ghost_payload_bytes_skipped", "writes",
            "reads")


def _port_params(p):
    return convert.params_from_dict(dataclasses.asdict(p))


def _pair(cell, durability=None, port_durability=None):
    p, shards = CELLS[cell]
    return (RefSharded(p, n_shards=shards, durability=durability),
            ShardedSLSM(_port_params(p), n_shards=shards, device="cpu",
                        durability=port_durability))


def _leaves_equal(ref_state, port_state):
    want = jax.tree_util.tree_leaves(ref_state)
    got = convert.state_to_leaves(port_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f"leaf {i}"
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _space(eng) -> int:
    """A cell's key space: ~90 keys a shard, well inside what a shard's
    deepest SMALL level holds (128)."""
    return 90 * eng.S


def _windows(rng, n=6, space=KEY_SPACE):
    lo = rng.integers(-5, space, n)
    return np.stack([lo, lo + rng.integers(0, 120, n)], 1).astype(np.int32)


def _check_reads(ref, port, oracle, rng):
    """Lookups, single and batched scans, aggregates: the port equal to
    the reference, and both to the oracle."""
    qs = np.arange(-3, _space(port) + 3, dtype=np.int32)
    vp, fp = port.lookup_many(qs)
    _same((vp, fp), ref.lookup(qs))
    vo, fo = oracle.lookup(qs)
    np.testing.assert_array_equal(fp, fo)
    np.testing.assert_array_equal(vp[fp], vo[fo])
    wins = _windows(rng, space=_space(port))
    got = port.range_many(wins)
    _same(got, ref.range_many(wins))
    for i, (lo, hi) in enumerate(wins):
        ok_, ov = oracle.range(int(lo), int(hi))
        assert not got[3][i]
        np.testing.assert_array_equal(got[0][i, :got[2][i]], ok_)
        np.testing.assert_array_equal(got[1][i, :got[2][i]], ov)
    agg = port.aggregate_many(wins)
    _same(agg, ref.aggregate_many(wins))
    for i, (lo, hi) in enumerate(wins):
        assert (int(agg[0][i]), int(agg[1][i])) == oracle.aggregate(
            int(lo), int(hi))
    lo, hi = map(int, wins[0])
    _same(port.range(lo, hi, return_truncated=True),
          ref.range(lo, hi, return_truncated=True))
    _same([x.numpy() for x in port.range_device(lo, hi)],
          ref.range_device(lo, hi))
    assert port.count(lo, hi) == ref.count(lo, hi)
    assert port.sum(lo, hi) == ref.sum(lo, hi)


def _stream(ref, port, oracle, rng, rounds, check=True):
    """Inserts (values over all of int32) and deletes; after every call
    the stacked state and the counters equal the reference's."""
    space = _space(port)
    for _ in range(rounds):
        if rng.random() < 0.7:
            n = int(rng.integers(1, 70))
            ks = rng.integers(0, space, n).astype(np.int32)
            vs = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(
                np.int32)
            for t in (ref, port, oracle):
                t.insert(ks, vs)
        else:
            ks = rng.integers(0, space, int(rng.integers(1, 24))).astype(
                np.int32)
            for t in (ref, port, oracle):
                t.delete(ks)
        if check:
            _leaves_equal(ref.state, port.state)
            for name in COUNTERS:
                assert port.stats[name] == ref.stats[name], name


def _record_steps(monkeypatch, eng):
    """Record every masked step the engine applies: (kind, level, the
    masked shards)."""
    steps = []
    real = eng._apply_step

    def recorded(kind, level, mask):
        steps.append((kind, level, tuple(np.flatnonzero(mask))))
        return real(kind, level, mask)

    monkeypatch.setattr(eng, "_apply_step", recorded)
    return steps


# --------------------------------------------------------------------------
# routing, exports, the Bloom-size fault
# --------------------------------------------------------------------------

def test_shard_ids_bitwise():
    rng = np.random.default_rng(0)
    keys = rng.integers(I32.min, I32.max, 5000, dtype=np.int64).astype(
        np.int32)
    keys[:4] = [I32.min, -1, 0, I32.max - 1]
    for s in (1, 2, 3, 4, 7, 64):
        got = shard_ids(keys, s)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, ref_shard_ids(keys, s))
    assert set(shard_ids(np.arange(4096, dtype=np.int32), 4)) == {0, 1, 2, 3}


def test_backlog_cost_and_pad_pow2_equal_reference():
    p = SLSMParams(**SMALL)
    pp = _port_params(p)
    for occ in ((9, 2, (2, 2, 2)), (3, 1, (1, 0, 2)), (0, 0, (0, 0, 0))):
        want = ref_pending_steps(p, RefTiering(), RefOcc(*occ))
        got = pending_steps(pp, TieringPolicy(), Occupancy(*occ))
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
        assert backlog_cost(got) == ref_backlog_cost(want)
    for n in (1, 15, 16, 17, 300):
        qs = np.arange(n, dtype=np.int32)
        got, want = pad_pow2(qs), ref_pad_pow2(qs)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_bloom_filters_of_2_31_bits_raise_in_both_packages():
    """words * 32 >= 2**31 raises OverflowError in the reference (its
    positions are int32; traced here, so nothing is allocated) and in
    the port, before allocating; one word less builds in both."""
    keys = np.arange(100, dtype=np.int32)
    valid = np.ones(100, bool)

    def ref_build(words):
        return jax.eval_shape(lambda: RBL.bloom_build(
            jnp.asarray(keys), jnp.asarray(valid), words, 10))

    with pytest.raises(OverflowError):
        ref_build(2 ** 26)
    with pytest.raises(OverflowError):
        BL.bloom_build(torch.from_numpy(keys), torch.from_numpy(valid),
                       2 ** 26, 10)
    assert ref_build(2 ** 26 - 1).shape == (2 ** 26 - 1,)
    filt = BL.bloom_build(torch.from_numpy(keys), torch.from_numpy(valid),
                          2 ** 26 - 1, 10)
    assert filt.shape == (2 ** 26 - 1,) and filt.dtype == torch.int32
    assert BL.bloom_probe(filt, torch.from_numpy(keys), 10).all()
    with pytest.raises(ValueError, match="bad geometry"):
        TBP.ops._check(filt[None], torch.from_numpy(keys), 10, 2 ** 31)


# --------------------------------------------------------------------------
# seeded streams: answers, stacked state, counters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(CELLS))
def test_stream_parity_state_and_counters(cell):
    rng = np.random.default_rng(len(cell))
    ref, port = _pair(cell)
    oracle = DictOracle()
    for _ in range(3):
        _stream(ref, port, oracle, rng, rounds=8)
        _check_reads(ref, port, oracle, rng)
    port.drain()
    ref.drain()
    _leaves_equal(ref.state, port.state)
    _check_reads(ref, port, oracle, rng)
    for name in COUNTERS:
        assert port.stats[name] == ref.stats[name], name
    assert port.n_live == ref.n_live
    np.testing.assert_array_equal(port.shard_occupancy(),
                                  ref.shard_occupancy())
    assert port.stats["spills"] > 0
    if port.tuner.enabled:
        assert port.stats["retunes"] == ref.stats["retunes"]


def test_deepest_compaction_annihilates_in_two_shards(monkeypatch):
    rng = np.random.default_rng(21)
    ref, port = _pair("s4_budget0")
    steps = _record_steps(monkeypatch, port)
    oracle = DictOracle()
    space = _space(port)
    for _ in range(36):
        ks = rng.integers(0, space, 200).astype(np.int32)
        dels = rng.integers(0, space, 40).astype(np.int32)
        for t in (ref, port, oracle):
            t.insert(ks, ks + 1)
            t.delete(dels)
    _leaves_equal(ref.state, port.state)
    assert port.stats["compactions"] == ref.stats["compactions"] >= 2
    compacted = {s for kind, _, shards in steps if kind == "compact"
                 for s in shards}
    assert len(compacted) >= 2
    assert port.stats["rows_annihilated"] == ref.stats["rows_annihilated"]
    assert port.stats["rows_annihilated"] > 0
    _check_reads(ref, port, oracle, rng)


def test_overflow_raises_with_state_uncommitted():
    """More live keys than a shard's deepest level holds: both raise the
    same RuntimeError, and the port's state is the one before the
    failing call's compaction (equal to the reference's, which never
    commits it either)."""
    def drive(t):
        rng = np.random.default_rng(5)
        for _ in range(80):
            t.insert(rng.integers(0, 3000, 40).astype(np.int32),
                     rng.integers(0, 99, 40).astype(np.int32))

    ref, port = _pair("s4_budget0")
    with pytest.raises(RuntimeError, match="deepest level overflow") as want:
        drive(ref)
    with pytest.raises(RuntimeError, match="deepest level overflow") as got:
        drive(port)
    assert str(got.value) == str(want.value)
    _leaves_equal(ref.state, port.state)
    cap = port.p.level_cap(port.p.max_levels - 1)
    assert (port.state.levels[-1].counts.numpy() <= cap).all()


def test_sharded_range_equals_single_tree():
    """`range_many` of a fleet equals the single tree's on one stream
    (tests/test_range.py's sharded-vs-single case), and per-shard
    truncation flags light up only for the shard over max_range."""
    p, _ = CELLS["s4_budget0"]
    pp = _port_params(p)
    single, fleet = SLSM(pp, device="cpu"), ShardedSLSM(pp, n_shards=4,
                                                        device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(10):
        ks = rng.integers(0, KEY_SPACE, 30).astype(np.int32)
        for t in (single, fleet):
            t.insert(ks, ks * 3)
        dels = rng.integers(0, KEY_SPACE, 6).astype(np.int32)
        for t in (single, fleet):
            t.delete(dels)
    wins = _windows(rng, 8)
    _same(fleet.range_many(wins), single.range_many(wins))
    _same(fleet.aggregate_many(wins), single.aggregate_many(wins))
    narrow = dataclasses.replace(pp, max_range=16)
    fleet = ShardedSLSM(narrow, n_shards=4, device="cpu")
    pool = np.arange(4000, dtype=np.int32)
    hot = pool[shard_ids(pool, 4) == 2][:24]
    fleet.insert(hot, hot)
    keys, _, trunc = fleet.range(0, 4000, return_truncated=True)
    np.testing.assert_array_equal(trunc, [False, False, True, False])
    np.testing.assert_array_equal(keys, hot[:16])


def test_lookup_batch_is_one_probe_call_over_every_shard(monkeypatch):
    """A sharded lookup batch asks `bloom_probe_levels` once, with every
    level of every shard ((S, D, W) stacks, (S, Q) keys), and
    `fence_lookup_many` once a level; a scan batch asks `range_merge`
    once for all S x Q rows; a masked step asks `merge_runs` once for
    every masked shard."""
    from repro_torch.engine import backend as TB
    rng = np.random.default_rng(3)
    ref, port = _pair("s4_budget0")
    _stream(ref, port, DictOracle(), rng, rounds=14, check=False)
    steps = _record_steps(monkeypatch, port)
    calls = {"bloom": [], "fence": [], "range": [], "merge": []}

    def spy(name, real, shape_of):
        def wrapped(*a, **k):
            calls[name].append(shape_of(*a))
            return real(*a, **k)
        monkeypatch.setattr(TB, real.__name__ if name != "merge"
                            else "merge_runs", wrapped)

    spy("bloom", TB.bloom_probe_levels,
        lambda stacks, qs: (len(stacks), tuple(stacks[0][0].shape[:1]),
                            tuple(qs.shape)))
    spy("fence", TB.fence_lookup_many, lambda qs, *a: tuple(qs.shape))
    spy("range", TB.range_merge, lambda k, *a: tuple(k.shape))
    spy("merge", TB.merge_runs, lambda k, *a: tuple(k.shape))
    qs = np.arange(0, 200, dtype=np.int32)
    _same(port.lookup(qs), ref.lookup(qs))
    levels = port.p.max_levels
    assert calls["bloom"] == [(levels, (4,), (4, calls["bloom"][0][2][1]))]
    assert len(calls["fence"]) == levels
    port.range_many(_windows(rng, 5))
    assert calls["range"] == [(4 * 8, port.p.range_cand_eff(levels))]
    ks = rng.integers(0, KEY_SPACE, 160).astype(np.int32)
    port.insert(ks, ks)
    ref.insert(ks, ks)
    _leaves_equal(ref.state, port.state)
    merges = [len(shards) for kind, _, shards in steps if kind != "seal"]
    assert merges and max(merges) >= 2
    assert [shape[0] for shape in calls["merge"]] == merges


# --------------------------------------------------------------------------
# mirrors of the reference's sharded engine tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(2))
def test_sharded_matches_oracle(seed):
    """tests/test_engine.py:152 on the port."""
    p, _ = CELLS["s4_budget0"]
    t, o = ShardedSLSM(_port_params(p), n_shards=4, device="cpu"), \
        DictOracle()
    rng = np.random.default_rng(seed)
    for _ in range(6):
        n = int(rng.integers(1, 120))
        ks = rng.integers(0, 500, n).astype(np.int32)
        vs = rng.integers(-50, 50, n).astype(np.int32)
        t.insert(ks, vs)
        o.insert(ks, vs)
        dels = rng.integers(0, 500, int(rng.integers(1, 16))).astype(np.int32)
        t.delete(dels)
        o.delete(dels)
    qs = np.arange(-4, 504, dtype=np.int32)
    v1, f1 = t.lookup(qs)
    v2, f2 = o.lookup(qs)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(v1[f1], v2[f2])
    _same(t.range(20, 480), o.range(20, 480))


def test_sharded_cascade_reaches_disk_levels():
    """tests/test_engine.py:175 on the port."""
    p, _ = CELLS["s4_budget0"]
    t, o = ShardedSLSM(_port_params(p), n_shards=4, device="cpu"), \
        DictOracle()
    rng = np.random.default_rng(7)
    ks = rng.integers(0, 800, 600).astype(np.int32)
    vs = rng.integers(0, 100, 600).astype(np.int32)
    t.insert(ks, vs)
    o.insert(ks, vs)
    assert (t.shard_occupancy() > 0).all()
    assert sum(int(lv.counts.sum()) for lv in t.state.levels) > 0
    qs = rng.integers(-10, 810, 512).astype(np.int32)
    v1, f1 = t.lookup(qs)
    v2, f2 = o.lookup(qs)
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(v1[f1], v2[f2])


@pytest.mark.parametrize("budget", [1, 2])
def test_budgeted_sharded_matches_sync_and_oracle(budget):
    """tests/test_scheduler.py:119 on the port: a paced fleet answers as
    the synchronous one and the oracle, and equally after drain()."""
    p, _ = CELLS["s4_budget0"]
    pp = _port_params(p)
    sync = ShardedSLSM(pp, n_shards=4, device="cpu")
    paced = ShardedSLSM(dataclasses.replace(pp, merge_budget=budget),
                        n_shards=4, device="cpu")
    o = DictOracle()
    rng = np.random.default_rng(23)
    qs = np.arange(-4, 504, dtype=np.int32)
    for _ in range(6):
        n = int(rng.integers(1, 120))
        ks = rng.integers(0, 500, n).astype(np.int32)
        vs = rng.integers(-50, 50, n).astype(np.int32)
        for t in (sync, paced, o):
            t.insert(ks, vs)
        dels = rng.integers(0, 500, 8).astype(np.int32)
        for t in (sync, paced, o):
            t.delete(dels)
        vp, fp = paced.lookup(qs)
        vo, fo = o.lookup(qs)
        np.testing.assert_array_equal(fp, fo)
        np.testing.assert_array_equal(vp[fp], vo[fo])
    paced.drain()
    _same(sync.lookup(qs), paced.lookup(qs))
    _same(sync.range(0, 500), paced.range(0, 500))
    assert paced.stats["flushes"] > 0
    assert paced.voluntary_steps(3) == 0


def test_adaptive_sharded_oracle_exact_through_retunes():
    """tests/test_tuner.py:263 on the port, against the reference fleet
    too: a write burst, a read burst with a trickle, a write burst —
    every answer equal and exact, the state equal after each phase, and
    at least one lockstep retune in both."""
    ref, port = _pair("s3_adaptive_budget1")
    o = DictOracle()
    rng = np.random.default_rng(29)
    probe = np.arange(0, 600, dtype=np.int32)

    def write(n):
        ks = rng.integers(0, 300, n).astype(np.int32) * 2
        vs = rng.integers(-99, 99, n).astype(np.int32)
        for t in (ref, port, o):
            t.insert(ks, vs)

    for _ in range(6):
        write(80)
    _leaves_equal(ref.state, port.state)
    for r in range(10):
        got = port.lookup_many(probe)
        _same(got, ref.lookup_many(probe))
        ev, ef = o.lookup(probe)
        np.testing.assert_array_equal(got[1], ef)
        np.testing.assert_array_equal(got[0][ef], ev[ef])
        if r % 3 == 2:
            write(8)
    _leaves_equal(ref.state, port.state)
    for _ in range(4):
        write(80)
    assert port.stats["retunes"] == ref.stats["retunes"] >= 1
    assert port.tuner.active == ref.tuner.active
    port.drain()
    ref.drain()
    _leaves_equal(ref.state, port.state)
    got, found = port.lookup(probe)
    ev, ef = o.lookup(probe)
    assert (found == ef).all() and (got[ef] == ev[ef]).all()
    _same(port.range(0, 400), o.range(0, 400))


def test_weighted_interleavings_vs_oracle_sharded():
    """tests/test_zset_props.py:243's sharded case on the port: runs of
    weighted writes (inserts, deletes, re-inserts of deleted keys)
    through a paced 2-shard fleet, every read exact."""
    p = SLSMParams(R=2, Rn=4, eps=0.05, D=2, m=1.0, mu=2, max_levels=3,
                   max_range=256, merge_budget=1)
    t, o = ShardedSLSM(_port_params(p), n_shards=2, device="cpu"), \
        DictOracle()
    rng = np.random.default_rng(243)
    for step in range(40):
        ks = rng.integers(0, 40, int(rng.integers(1, 9))).astype(np.int32)
        if step % 3 == 2:
            t.delete(ks)
            o.delete(ks)
        else:
            vs = rng.integers(-9, 9, ks.size).astype(np.int32)
            t.insert(ks, vs)
            o.insert(ks, vs)
        if step % 5 == 4:
            qs = np.arange(-2, 42, dtype=np.int32)
            v, f = t.lookup(qs)
            ev, ef = o.lookup(qs)
            np.testing.assert_array_equal(f, ef)
            np.testing.assert_array_equal(v[f], ev[ef])
            _same(t.range(0, 40), o.range(0, 40))
            c, s, _ = t.aggregate_many([(0, 40), (5, 20)])
            assert [(int(a), int(b)) for a, b in zip(c, s)] == [
                o.aggregate(0, 40), o.aggregate(5, 20)]


# --------------------------------------------------------------------------
# the tape
# --------------------------------------------------------------------------

def _tape_window(rng, rn, n_chunks):
    out = []
    for _ in range(n_chunks):
        u = rng.random()
        if u < 0.5:
            n = int(rng.integers(1, rn + 1))
            ks = rng.integers(0, KEY_SPACE, n).astype(np.int32)
            ws = np.where(rng.random(n) < 0.1, -1, 1).astype(np.int32)
            vs = np.where(ws > 0, rng.integers(-99, 99, n), 0).astype(
                np.int32)
            out.append(("write", ks, vs, ws))
        elif u < 0.9:
            n = int(rng.integers(1, rn + 1))
            out.append(("lookup", rng.integers(-4, KEY_SPACE + 4, n)
                        .astype(np.int32), np.zeros(n, np.int32), None))
        else:
            n = int(rng.integers(1, 5))
            lo = rng.integers(-4, KEY_SPACE, n).astype(np.int32)
            out.append(("range", lo, (lo + rng.integers(0, 60, n))
                        .astype(np.int32), None))
    return out


def test_run_tape_matches_reference():
    """`run_tape` windows (writes past a shard's stage, split across
    segments) against the reference's sharded `run_tape`: per-chunk
    results, the stacked state and the counters after every window."""
    ref, port = _pair("s4_budget0")
    rng = np.random.default_rng(13)
    for w in range(6):
        chunks = _tape_window(rng, ref.p.Rn, int(rng.integers(4, 14)))
        want = ref.run_tape([RTP.TapeChunk(*c) for c in chunks])
        got = port.run_tape([TapeChunk(*c) for c in chunks])
        assert len(got) == len(want)
        for g, x in zip(got, want):
            if isinstance(x, tuple):
                _same(g, x)
            else:
                assert g == x
        _leaves_equal(ref.state, port.state)
        for name in COUNTERS:
            assert port.stats[name] == ref.stats[name], (w, name)
        assert port.tape_write_capacity() == ref.tape_write_capacity()
        port.voluntary_steps(1)
        ref.voluntary_steps(1)
    assert port.stats["seals"] > 0 and port.stats["flushes"] > 0


def test_reserve_run_slots_raises_like_reference():
    ref, port = _pair("s4_budget0")
    need = np.full(4, port.p.R + 1, np.int64)
    with pytest.raises(ValueError, match="cannot reserve") as want:
        ref._reserve_run_slots(need)
    with pytest.raises(ValueError, match="cannot reserve") as got:
        port._reserve_run_slots(need)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown tape chunk kind"):
        port.run_tape([("delete", np.array([1], np.int32),
                        np.array([0], np.int32))])


# --------------------------------------------------------------------------
# durability: WAL bytes, snapshot leaves, restore both ways, replicas
# --------------------------------------------------------------------------

def _durable_script(rng):
    """Ten calls of 40 keys over 100 (every fourth deletes 12): a single
    SMALL tree holds them too."""
    ops = []
    for i in range(10):
        ks = rng.integers(0, 100, 40).astype(np.int32)
        ops.append(("delete", ks[:12], None) if i % 4 == 3
                   else ("insert", ks, rng.integers(0, 1 << 20, 40)
                         .astype(np.int32)))
    return ops


def _apply(t, ops):
    for kind, ks, vs in ops:
        if kind == "insert":
            t.insert(ks, vs)
        else:
            t.delete(ks)


def _probe(t):
    qs = np.arange(-2, KEY_SPACE + 2, dtype=np.int32)
    return (*t.lookup(qs), *t.range(0, KEY_SPACE))


@pytest.fixture(scope="module")
def durable_pair(tmp_path_factory):
    """One script through a durable reference fleet and a durable port
    fleet: writes, a snapshot, a tape window, more writes."""
    base = tmp_path_factory.mktemp("sharded_durable")
    ref, port = _pair("s4_budget0",
                      RWAL.Durability(base / "ref", fsync=False),
                      WAL.Durability(base / "port", fsync=False))
    rng = np.random.default_rng(17)
    ops = _durable_script(rng)
    tape = [("write", ops[0][1][:8], ops[0][1][:8] * 7, None),
            ("lookup", ops[1][1][:8], ops[1][1][:8], None),
            ("range", np.array([10, 90], np.int32),
             np.array([80, 250], np.int32), None)]
    for t, chunk in ((ref, RTP.TapeChunk), (port, TapeChunk)):
        _apply(t, ops[:5])
        t.snapshot()
        t.run_tape([chunk(*c) for c in tape])
        _apply(t, ops[5:])
        t.durability.close()
    _leaves_equal(ref.state, port.state)
    return dict(base=base, ref=ref, port=port, ops=ops)


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_wal_bytes_and_snapshot_leaves_equal_reference(durable_pair):
    ref_dir = durable_pair["base"] / "ref"
    port_dir = durable_pair["base"] / "port"
    names = _files(ref_dir)
    assert names == _files(port_dir)
    assert "wal.log" in names and any(n.endswith(".npy") for n in names)
    for n in names:
        a, b = (ref_dir / n).read_bytes(), (port_dir / n).read_bytes()
        if n.endswith("meta.json"):
            assert json.loads(a) == json.loads(b), n
        else:
            assert a == b, n
    meta = json.loads(WAL.read_wal(port_dir / "wal.log")[0][0].payload)
    assert meta["driver"] == "sharded" and meta["n_shards"] == 4


def test_cross_restore_both_ways(durable_pair):
    base = durable_pair["base"]
    port = ShardedSLSM.restore(str(base / "ref"), device="cpu")
    ref = RefSharded.restore(str(base / "port"))
    assert port.S == ref.S == 4
    assert port.stats["replayed_records"] == ref.stats["replayed_records"] > 0
    _leaves_equal(ref.state, port.state)
    _same(_probe(port), _probe(durable_pair["port"]))
    _same(_probe(ref), _probe(durable_pair["ref"]))


def test_restore_after_torn_tail_answers_the_durable_prefix(durable_pair,
                                                            tmp_path):
    import shutil
    src = durable_pair["base"] / "port"
    dst = tmp_path / "crashed"
    shutil.copytree(src, dst)
    offsets = WAL.record_offsets(dst / "wal.log")
    _, start, end = offsets[-1]
    with open(dst / "wal.log", "r+b") as f:
        f.truncate(end - 3)
    got = ShardedSLSM.restore(str(dst), device="cpu")
    volatile = ShardedSLSM(got.p, n_shards=4, device="cpu")
    ops = durable_pair["ops"]
    _apply(volatile, ops[:5])
    chunk = [TapeChunk("write", ops[0][1][:8], ops[0][1][:8] * 7)]
    volatile.run_tape(chunk)
    _apply(volatile, ops[5:-1])
    _same(_probe(got), _probe(volatile))


def test_single_and_sharded_log_the_same_records(tmp_path):
    """Writes are logged before routing: a single tree and a fleet fed
    one stream write the same records, META aside."""
    p, _ = CELLS["s4_budget0"]
    pp = _port_params(p)
    ops = _durable_script(np.random.default_rng(2))
    single = SLSM(pp, device="cpu", durability=tmp_path / "single")
    fleet = ShardedSLSM(pp, n_shards=4, device="cpu",
                        durability=tmp_path / "fleet")
    for t in (single, fleet):
        _apply(t, ops)
        t.durability.close()
    a = WAL.read_wal(tmp_path / "single" / "wal.log")[0]
    b = WAL.read_wal(tmp_path / "fleet" / "wal.log")[0]
    assert a[0].kind == b[0].kind == WAL.REC_META
    assert a[0].payload != b[0].payload
    assert [(r.kind, r.payload) for r in a[1:]] == [
        (r.kind, r.payload) for r in b[1:]]


def test_restore_recovers_shard_count_and_rejects_other_engines(tmp_path):
    """tests/durability/test_sharded_recovery.py:92,109 on the port."""
    p, _ = CELLS["s4_budget0"]
    pp = _port_params(p)
    fleet = ShardedSLSM(pp, n_shards=2, device="cpu",
                        durability=tmp_path / "fleet")
    _apply(fleet, _durable_script(np.random.default_rng(4))[:6])
    fleet.durability.close()
    got = ShardedSLSM.restore(str(tmp_path / "fleet"), device="cpu")
    assert got.S == 2
    _same(_probe(got), _probe(fleet))
    with pytest.raises(ValueError, match="different engine"):
        ShardedSLSM(pp, n_shards=4, device="cpu",
                    durability=str(tmp_path / "fleet"))
    single = SLSM(pp, device="cpu", durability=tmp_path / "single")
    single.insert([1, 2], [3, 4])
    single.durability.close()
    with pytest.raises(ValueError, match="different engine"):
        ShardedSLSM.restore(str(tmp_path / "single"), device="cpu")
    with pytest.raises(ValueError, match="different engine"):
        SLSM.restore(str(tmp_path / "fleet"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSLSM(pp)


def test_replica_follows_promotes_and_demotes(tmp_path):
    """open_replica over a leader's directory, apply_replicated of the
    leader's later records, promote (writes accepted, epoch bumped) and
    demote (writes refused)."""
    import shutil
    p, _ = CELLS["s4_budget0"]
    pp = _port_params(p)
    ops = _durable_script(np.random.default_rng(9))
    leader = ShardedSLSM(pp, n_shards=4, device="cpu",
                         durability=WAL.Durability(tmp_path / "lead",
                                                   fsync=False))
    _apply(leader, ops[:4])
    leader.durability.sync()
    shutil.copytree(tmp_path / "lead", tmp_path / "follow")
    replica = ShardedSLSM.open_replica(str(tmp_path / "follow"),
                                       device="cpu")
    with pytest.raises(RuntimeError, match="read-only"):
        replica.insert([1], [1])
    seen = WAL.read_wal(tmp_path / "lead" / "wal.log")[0][-1].seqno
    _apply(leader, ops[4:])
    leader.durability.sync()
    tail = [r for r in WAL.read_wal(tmp_path / "lead" / "wal.log")[0]
            if r.seqno > seen]
    assert replica.apply_replicated(tail) == len(tail)
    _same(_probe(replica), _probe(leader))
    replica.promote()
    replica.insert([5], [6])
    assert replica.lookup([5])[1].tolist() == [True]
    replica.demote()
    with pytest.raises(RuntimeError, match="fenced"):
        replica.delete([5])
    assert replica.stats["promotions"] == replica.stats["demotions"] == 1


# --------------------------------------------------------------------------
# the four engine kernels with a leading shard dimension
# --------------------------------------------------------------------------

def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bloom_probe_shards_match_vmapped_pallas_ref_and_single_calls():
    """(S, D, W) stacks of two levels and (S, Q) keys, each shard's runs
    probing its own key row: against `bloom_probe_op` (Pallas,
    interpret) and `bloom_probe_ref` vmapped over shards and runs, and
    against one single-tree call a shard."""
    geoms = [(3, 80, 32, 6, 1000), (2, 200, 64, 10, None)]
    n_shards = 3
    stacks, qs = [], []
    for i, (d_n, n, words, k, bits) in enumerate(geoms):
        per = [_bloom_case(100 * i + s, d_n, n, words, k, bits, 64)
               for s in range(n_shards)]
        stacks.append((np.stack([b for b, _ in per]), k, bits))
        qs.append(np.stack([q for _, q in per]))
    qs = np.concatenate(qs, axis=1)
    got = TBP.bloom_probe_levels(
        [(_t(b.view(np.int32)), k, bits) for b, k, bits in stacks], _t(qs))
    for out, (blooms, k, bits) in zip(got, stacks):
        assert out.shape == (n_shards, blooms.shape[1], qs.shape[1])
        for fn in (bloom_probe_op, bloom_probe_ref):
            per_run = jax.vmap(lambda w, q, fn=fn, k=k, bits=bits:
                               fn(w, q, k, bits), in_axes=(0, None))
            want = jax.vmap(per_run)(jnp.asarray(blooms), jnp.asarray(qs))
            _eq(out.to(torch.int32), np.asarray(want).astype(np.int32))
        for s in range(n_shards):
            assert torch.equal(out[s], TBP.bloom_probe_many(
                _t(blooms[s].view(np.int32)), _t(qs[s]), k, bits))


def test_fence_lookup_shards_match_vmapped_pallas_ref_and_single_calls():
    n_shards, mu = 3, 8
    cases = [_fence_case(40 + s, 2, 64, mu, 48) for s in range(n_shards)]
    keys, fences, counts, qs = (np.stack([c[i] for c in cases])
                                for i in range(4))
    got = TFL.fence_lookup_many(_t(qs), _t(fences), _t(keys), _t(counts),
                                mu)
    assert got.shape == (n_shards, 2, 48)
    for fn in (fence_lookup_op, fence_lookup_ref):
        per_run = jax.vmap(lambda q, f, k, c, fn=fn: fn(q, f, k, c, mu),
                           in_axes=(None, 0, 0, 0))
        want = jax.vmap(per_run)(*map(jnp.asarray, (qs, fences, keys,
                                                    counts)))
        _eq(got, want)
    for s in range(n_shards):
        assert torch.equal(got[s], TFL.fence_lookup_many(
            _t(qs[s]), _t(fences[s]), _t(keys[s]), _t(counts[s]), mu))


@pytest.mark.parametrize("drop", [False, True])
def test_heap_merge_batch_matches_vmapped_pallas_ref_and_single_calls(drop):
    """A batch of 3 merges of 5 runs each (a masked step of 3 shards)."""
    rng = np.random.default_rng(int(drop))
    per = [_runs(rng, 5, 24, key_space=60) for _ in range(3)]
    lanes = [np.stack([p[i] for p in per]) for i in range(4)]
    got = THM.heap_merge(*map(_t, lanes), drop)
    assert got[0].shape == (3, 5 * 24) and got[4].shape == (3,)
    for fn in (heap_merge_op, heap_merge_ref):
        want = jax.vmap(lambda k, v, w, s, fn=fn: fn(k, v, w, s, drop))(
            *map(jnp.asarray, lanes))
        for g, x in zip(got, want):
            _eq(g, x)
    for b in range(3):
        one = THM.heap_merge(*(_t(a[b]) for a in lanes), drop)
        for g, x in zip(got, one):
            assert torch.equal(g[b], x)


def test_range_merge_shard_rows_match_vmapped_pallas_ref_and_single_calls():
    """S x Q candidate rows in one call equal the reference's kernel
    vmapped over the shards and one call a shard."""
    rng = np.random.default_rng(8)
    per = [_segments(rng, 2, 256, 7) for _ in range(3)]
    lanes = [np.stack([p[i] for p in per]) for i in range(5)]
    got = TRM.range_merge(*(_t(a.reshape(6, -1)) for a in lanes), True)
    for fn in (range_merge_op, range_merge_ref):
        want = jax.vmap(lambda k, v, w, s, o, fn=fn: fn(k, v, w, s, o,
                                                        True))(
            *map(jnp.asarray, lanes))
        for g, x in zip(got, want):
            _eq(g.reshape(x.shape), x)
    for s in range(3):
        one = TRM.range_merge(*(_t(a[s]) for a in lanes), True)
        for g, x in zip(got, one):
            assert torch.equal(g[2 * s:2 * s + 2], x)
