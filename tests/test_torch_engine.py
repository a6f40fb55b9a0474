"""Port parity of the whole engine: seeded insert/delete/lookup/range/
aggregate streams through `repro.engine.SLSM` and `repro_torch` `SLSM`
(on the CPU), answers and full state bitwise equal to each other and to
the dict oracle."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.oracle import DictOracle  # noqa: E402
from repro.core.params import KEY_EMPTY, SLSMParams  # noqa: E402
from repro.engine import SLSM as RefSLSM  # noqa: E402
from repro.engine import LevelingPolicy as RefLeveling  # noqa: E402
from repro.engine import TieringPolicy as RefTiering  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import SLSM  # noqa: E402
from repro_torch.engine import LevelingPolicy, TieringPolicy  # noqa: E402

SMALL = SLSMParams(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=3,
                   max_range=512, cand_factor=16)
KEY_SPACE = 120
MERGE_COUNTERS = ("seals", "flushes", "spills", "compactions",
                  "rows_merged_in", "rows_merged_out", "rows_annihilated",
                  "writes", "reads")


def _pair(params, policy, budget=0, backend="jnp"):
    ref_p = dataclasses.replace(params, merge_budget=budget, backend=backend)
    port_p = convert.params_from_dict(dataclasses.asdict(ref_p))
    ref_pol, port_pol = ((RefLeveling(), LevelingPolicy())
                         if policy == "leveling"
                         else (RefTiering(), TieringPolicy()))
    return (RefSLSM(ref_p, policy=ref_pol),
            SLSM(port_p, policy=port_pol, device="cpu"))


def _leaves_equal(ref_state, port_state):
    want = jax.tree_util.tree_leaves(ref_state)
    got = convert.state_to_leaves(port_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype, f"leaf {i}"
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


def _check_reads(ref, port, oracle, rng):
    qs = np.arange(-4, KEY_SPACE + 4, dtype=np.int32)
    vr, fr = ref.lookup_many(qs)
    vp, fp = port.lookup_many(qs)
    vo, fo = oracle.lookup(qs)
    np.testing.assert_array_equal(fp, fr)
    np.testing.assert_array_equal(vp, vr)
    np.testing.assert_array_equal(fp, fo)
    np.testing.assert_array_equal(vp[fp], vo[fo])
    lo = rng.integers(-5, KEY_SPACE, 9)
    wins = np.stack([lo, lo + rng.integers(0, 60, 9)], axis=1)
    for a, b in zip(port.range_many(wins), ref.range_many(wins)):
        np.testing.assert_array_equal(a, b)
    kp, vp_, cp, tp = port.range_many(wins)
    for i, (l, h) in enumerate(wins):
        ok, ov = oracle.range(int(l), int(h))
        assert not tp[i]
        np.testing.assert_array_equal(kp[i, :cp[i]], ok)
        np.testing.assert_array_equal(vp_[i, :cp[i]], ov)
    for a, b in zip(port.aggregate_many(wins), ref.aggregate_many(wins)):
        np.testing.assert_array_equal(a, b)
    cnt, sums, _ = port.aggregate_many(wins)
    for i, (l, h) in enumerate(wins):
        assert (int(cnt[i]), int(sums[i])) == oracle.aggregate(int(l), int(h))


def _stream(ref, port, oracle, rng, rounds):
    for _ in range(rounds):
        if rng.random() < 0.7:
            n = int(rng.integers(1, 30))
            ks = rng.integers(0, KEY_SPACE, n).astype(np.int32)
            vs = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                              n, dtype=np.int64).astype(np.int32)
            for t in (ref, port, oracle):
                t.insert(ks, vs)
        else:
            ks = rng.integers(0, KEY_SPACE, int(rng.integers(1, 12))).astype(
                np.int32)
            for t in (ref, port, oracle):
                t.delete(ks)


@pytest.mark.parametrize("policy", ["tiering", "leveling"])
@pytest.mark.parametrize("budget", [0, 1])
def test_stream_parity_answers_state_and_stats(policy, budget):
    rng = np.random.default_rng(budget * 10 + len(policy))
    ref, port = _pair(SMALL, policy, budget)
    oracle = DictOracle()
    for _ in range(3):
        _stream(ref, port, oracle, rng, rounds=6)
        _leaves_equal(ref.state, port.state)
    _check_reads(ref, port, oracle, rng)
    port.drain()
    ref.drain()
    _check_reads(ref, port, oracle, rng)
    _leaves_equal(ref.state, port.state)
    assert port.n_levels == ref.n_levels >= 2
    assert port.n_live == ref.n_live
    for name in MERGE_COUNTERS:
        assert port.stats[name] == ref.stats[name], name
    if policy == "tiering" and budget == 0:
        assert port.stats["rows_annihilated"] > 0


def test_stream_parity_with_pallas_reference():
    """The reference with its Pallas kernels (interpret mode) gives the
    same answers and state as the port."""
    rng = np.random.default_rng(7)
    ref, port = _pair(SMALL, "tiering", 1, backend="pallas")
    oracle = DictOracle()
    _stream(ref, port, oracle, rng, rounds=8)
    _check_reads(ref, port, oracle, rng)
    _leaves_equal(ref.state, port.state)


@pytest.mark.parametrize("budget", [0, 1])
def test_port_resumes_from_reference_state(budget):
    """Start the port from the reference's state mid-stream and continue
    both: they stay equal."""
    rng = np.random.default_rng(3 + budget)
    ref, port = _pair(SMALL, "tiering", budget)
    oracle = DictOracle()
    _stream(ref, port, oracle, rng, rounds=8)
    fresh = SLSM(port.p, device="cpu")
    fresh.state = convert.state_from_leaves(
        fresh.p, [np.asarray(x) for x in jax.tree_util.tree_leaves(ref.state)],
        "cpu")
    _leaves_equal(ref.state, fresh.state)
    _stream(ref, fresh, oracle, rng, rounds=8)
    _check_reads(ref, fresh, oracle, rng)
    _leaves_equal(ref.state, fresh.state)


def test_state_from_leaves_keeps_leaf_shapes():
    """Every leaf from `state_from_leaves` has the shape of the same leaf
    of the reference and of the port's `init_state`: the 0-d counters
    (`stage_count`, `run_count`, `next_seq`) stay 0-d."""
    from repro_torch.engine.memtable import init_state
    rng = np.random.default_rng(11)
    ref, port = _pair(SMALL, "tiering")
    _stream(ref, port, DictOracle(), rng, rounds=10)
    assert ref.n_levels >= 1
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref.state)]
    got = convert.state_to_leaves(
        convert.state_from_leaves(port.p, want, "cpu"))
    fresh = convert.state_to_leaves(init_state(port.p, "cpu", ref.n_levels))
    assert len(got) == len(want) == len(fresh)
    for i, (g, w, f) in enumerate(zip(got, want, fresh)):
        assert g.shape == w.shape == f.shape, f"leaf {i}"
    for name in ("stage_count", "run_count", "next_seq"):
        assert convert.state_from_leaves(
            port.p, want, "cpu")._asdict()[name].dim() == 0, name


def test_lookup_batch_probes_every_level_in_one_call(monkeypatch):
    """A lookup batch over two or more disk levels asks
    `bloom_probe_levels` once, with every level's stack, and never the
    one-level `bloom_probe_many`; the answers stay bitwise equal to the
    reference and the oracle."""
    from repro_torch.engine import backend as TB
    rng = np.random.default_rng(12)
    ref, port = _pair(SMALL, "tiering")
    oracle = DictOracle()
    _stream(ref, port, oracle, rng, rounds=24)
    assert port.n_levels == ref.n_levels >= 2
    calls = []
    real = TB.bloom_probe_levels

    def counted(stacks, qs):
        calls.append(len(stacks))
        return real(stacks, qs)

    def refused(*args):
        raise AssertionError("a one-level Bloom probe on the lookup path")

    monkeypatch.setattr(TB, "bloom_probe_levels", counted)
    monkeypatch.setattr(TB, "bloom_probe_many", refused)
    qs = np.arange(-4, KEY_SPACE + 4, dtype=np.int32)
    vp, fp = port.lookup_many(qs)
    assert calls == [port.n_levels]
    vr, fr = ref.lookup_many(qs)
    vo, fo = oracle.lookup(qs)
    np.testing.assert_array_equal(fp, fr)
    np.testing.assert_array_equal(vp, vr)
    np.testing.assert_array_equal(fp, fo)
    np.testing.assert_array_equal(vp[fp], vo[fo])
    port.lookup(qs[:7])
    assert calls == [port.n_levels] * 2


def test_deepest_level_overflow_raises_like_reference():
    """More live keys than the deepest level holds: the port raises the
    reference's RuntimeError at the same write, not an index error."""
    def drive(t):
        rng = np.random.default_rng(5)
        for r in range(60):
            t.insert(rng.integers(0, 400, 12).astype(np.int32),
                     rng.integers(-2 ** 31, 2 ** 31 - 1, 12,
                                  dtype=np.int64).astype(np.int32))
            t.delete(rng.integers(0, 400, 3).astype(np.int32))

    ref, port = _pair(SMALL, "tiering")
    with pytest.raises(RuntimeError, match="deepest level overflow") as want:
        drive(ref)
    with pytest.raises(RuntimeError, match="deepest level overflow") as got:
        drive(port)
    assert str(got.value) == str(want.value)


def test_reserved_sentinels_rejected():
    t = SLSM(SMALL_PORT, device="cpu")
    ok_keys = np.asarray([1, 2], np.int32)
    with pytest.raises(ValueError, match="KEY_EMPTY"):
        t.insert(np.asarray([1, KEY_EMPTY], np.int32), ok_keys)
    with pytest.raises(ValueError, match="KEY_EMPTY"):
        t.delete(np.asarray([KEY_EMPTY], np.int32))
    with pytest.raises(ValueError, match="KEY_EMPTY"):
        t.lookup(np.asarray([KEY_EMPTY], np.int32))
    with pytest.raises(ValueError, match="KEY_EMPTY"):
        t.lookup_many(np.asarray([3, KEY_EMPTY], np.int32))
    t.insert(np.asarray([KEY_EMPTY - 1], np.int32), np.asarray([77], np.int32))
    vals, found = t.lookup(np.asarray([KEY_EMPTY - 1], np.int32))
    assert found.all() and vals[0] == 77


def test_full_int32_value_domain_round_trips():
    t = SLSM(SMALL_PORT, device="cpu")
    lo, hi = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    keys = np.asarray([10, 20, 30, 40], np.int32)
    vals = np.asarray([lo, lo + 1, hi, 0], np.int32)
    t.insert(keys, vals)
    got, found = t.lookup_many(keys)
    assert found.all()
    np.testing.assert_array_equal(got, vals)
    t.delete(keys[:2])
    _, found = t.lookup_many(keys[:2])
    assert not found.any()
    t.insert(keys[:2], vals[2:])
    got, found = t.lookup_many(keys)
    assert found.all()
    np.testing.assert_array_equal(got, np.asarray([hi, 0, hi, 0], np.int32))
    rk, rv = t.range(5, 45)
    np.testing.assert_array_equal(rk, keys)
    np.testing.assert_array_equal(rv, np.asarray([hi, 0, hi, 0], np.int32))
    assert t.sum(5, 45) == np.int32(np.int64(2 * hi) - 2 ** 32)
    assert t.count(5, 45) == 4


def test_out_of_slice_options_raise(tmp_path):
    """Every option of the single-tree engine is ported: durability (the
    WAL and snapshots, static and adaptive), the sparse lookup, the tape
    and adaptive tuning run. What raises is reattaching an engine of
    another configuration to a durability directory."""
    from repro_torch.engine import wal as WAL
    static = SLSM(SMALL_PORT, device="cpu", durability=tmp_path / "s")
    static.insert([1, 2], [3, 4])
    static.durability.close()
    adaptive = dataclasses.replace(
        SMALL_PORT, tuning=type(SMALL_PORT.tuning)(mode="adaptive"))
    with pytest.raises(ValueError, match="different engine"):
        SLSM(adaptive, device="cpu", durability=tmp_path / "s")
    t = SLSM(adaptive, device="cpu", durability=tmp_path / "a")
    assert t.tuner.enabled and t.run_tape([]) == []
    assert t.lookup([1], sparse=True)[1].tolist() == [False]
    t.durability.close()
    assert [r.kind for r in WAL.read_wal(tmp_path / "s" / "wal.log")[0]] \
        == [WAL.REC_META, WAL.REC_WRITE2]


SMALL_PORT = convert.params_from_dict(dataclasses.asdict(SMALL))
