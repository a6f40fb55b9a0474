"""Port parity of the adaptive engine: the tuner's presets and byte model,
the RETUNE filter rebuild, the sparse lookup, probe telemetry and the
`skip_empty` read path, held bitwise against `repro.engine` on the CPU
through streams that shift from write-heavy to read-heavy."""
import dataclasses
import unittest.mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.slsm_paper import paper_params as ref_paper  # noqa: E402
from repro.core.oracle import DictOracle  # noqa: E402
from repro.core.params import SLSMParams, TuningPolicy  # noqa: E402
from repro.engine import SLSM as RefSLSM  # noqa: E402
from repro.engine import LevelingPolicy as RefLeveling  # noqa: E402
from repro.engine import TieringPolicy as RefTiering  # noqa: E402
from repro.engine import read_path as RRP  # noqa: E402
from repro.engine import tuner as RTU  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.engine import SLSM  # noqa: E402
from repro_torch.engine import LevelingPolicy, TieringPolicy  # noqa: E402
from repro_torch.engine import backend as TB  # noqa: E402
from repro_torch.engine import read_path as RP  # noqa: E402
from repro_torch.engine import tuner as TU  # noqa: E402

# the reference tuner tests' geometry (tests/test_tuner.py)
SMALL = dict(R=4, Rn=32, eps=1e-2, D=3, m=1.0, mu=8, max_levels=3,
             max_range=2048, cand_factor=16)
ADAPTIVE = TuningPolicy(mode="adaptive", interval=64, eps_floor=1e-3)
KEY_SPACE = 600
COUNTERS = ("seals", "flushes", "spills", "compactions", "retunes",
            "rows_merged_in", "rows_merged_out", "rows_annihilated",
            "writes", "reads", "backlog_peak")


def _port(ref_p):
    return convert.params_from_dict(dataclasses.asdict(ref_p))


def _pair(ref_p, policy="tiering"):
    ref_pol, port_pol = ((RefLeveling(), LevelingPolicy())
                         if policy == "leveling"
                         else (RefTiering(), TieringPolicy()))
    return (RefSLSM(ref_p, policy=ref_pol),
            SLSM(_port(ref_p), policy=port_pol, device="cpu"))


def _leaves_equal(ref_state, port_state):
    want = jax.tree_util.tree_leaves(ref_state)
    got = convert.state_to_leaves(port_state)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype, f"leaf {i}"
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


def _same_position(ref, port):
    """Tuner position, counters, active parameters and state leaves."""
    rt, pt = ref.tuner, port.tuner
    assert (pt.active, pt.target) == (rt.active, rt.target)
    assert pt.read_frac == rt.read_frac
    np.testing.assert_array_equal(pt.level_candidates, rt.level_candidates)
    np.testing.assert_array_equal(pt.level_hits, rt.level_hits)
    assert (dataclasses.asdict(port.p_active)
            == dataclasses.asdict(_port(ref.p_active)))
    for name in COUNTERS:
        assert port.stats[name] == ref.stats[name], name
    _leaves_equal(ref.state, port.state)
    assert port.runs == RP.host_occupancy(port.state)


def _reads_equal(ref, port, oracle, qs):
    vo, fo = oracle.lookup(qs)
    for sparse in (False, True):
        vr, fr = ref.lookup_many(qs, sparse=sparse)
        vp, fp = port.lookup_many(qs, sparse=sparse)
        np.testing.assert_array_equal(fp, fr)
        np.testing.assert_array_equal(vp, vr)
        np.testing.assert_array_equal(fp, fo)
        np.testing.assert_array_equal(vp[fp], vo[fo])


def _write(engines, rng, n, deletes=0):
    ks = rng.integers(0, KEY_SPACE // 2, n).astype(np.int32) * 2
    vs = rng.integers(-99, 99, n).astype(np.int32)
    for t in engines:
        t.insert(ks, vs)
    if deletes:
        dels = rng.integers(0, KEY_SPACE // 2, deletes).astype(np.int32) * 2
        for t in engines:
            t.delete(dels)


def _shifting(ref, port, oracle, rng):
    """Write burst, read burst with a write trickle, write burst; the
    position checked after every round. Returns the allocations seen."""
    engines = (ref, port, oracle)
    probe = np.arange(0, KEY_SPACE, dtype=np.int32)
    seen = []
    for _ in range(6):
        _write(engines, rng, 80, deletes=4)
        _same_position(ref, port)
        seen.append(port.tuner.active)
    for r in range(12):
        _reads_equal(ref, port, oracle, probe)
        if r % 3 == 2:
            _write(engines, rng, 8)
        _same_position(ref, port)
        seen.append(port.tuner.active)
    for _ in range(4):
        _write(engines, rng, 80, deletes=4)
        _same_position(ref, port)
        seen.append(port.tuner.active)
    _reads_equal(ref, port, oracle, probe)
    return seen


# -- the byte model and the presets -------------------------------------------

@pytest.mark.parametrize("geometry", ["small", "paper", "paper-4-levels"])
def test_presets_byte_model_and_monkey_equal_reference(geometry):
    ref_p = {"small": SLSMParams(**SMALL, tuning=ADAPTIVE),
             "paper": ref_paper(merge_budget=1, range_cand=512,
                                tuning=TuningPolicy(mode="adaptive",
                                                    interval=512,
                                                    eps_floor=1e-4)),
             "paper-4-levels": ref_paper(
                 merge_budget=1, range_cand=512, max_levels=4,
                 tuning=TuningPolicy(mode="adaptive", interval=512,
                                     eps_floor=1e-4))}[geometry]
    p = _port(ref_p)
    want, got = RTU.build_presets(ref_p), TU.build_presets(p)
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name]), name
        assert TU.allocation_bytes(p, got[name]) == RTU.allocation_bytes(
            ref_p, want[name])
        # the applied views: every effective geometry the engine reads
        pa, ra = got[name].apply(p), want[name].apply(ref_p)
        assert (pa.R_eff, pa.runs_merged_eff, pa.mem_eps) == (
            ra.R_eff, ra.runs_merged_eff, ra.mem_eps)
        for lvl in range(p.max_levels):
            cap = p.level_cap(lvl)
            assert pa.level_eps(lvl) == ra.level_eps(lvl)
            assert pa.fence_view(lvl) == ra.fence_view(lvl)
            assert pa.bloom_geometry(cap, pa.level_eps(lvl)) == \
                ra.bloom_geometry(cap, ra.level_eps(lvl))
            assert pa.bloom_words_physical(cap, pa.level_eps(lvl)) == \
                ra.bloom_words_physical(cap, ra.level_eps(lvl))
    floor = min(p.eps, p.tuning.eps_floor)
    for budget in (10 ** 9, RTU.allocation_bytes(ref_p, want["balanced"]),
                   12_345):
        assert TU.monkey_eps_per_level(p, budget, floor) == \
            RTU.monkey_eps_per_level(ref_p, budget, floor)


def test_read_mode_policy_matches_reference():
    ref_p = SLSMParams(**SMALL, tuning=ADAPTIVE)
    p = _port(ref_p)
    ref_pol, pol = RTU.ReadModePolicy(), TU.ReadModePolicy()
    for level in range(3):
        for n in range(p.D + 1):
            assert pol.needs_spill(p, n, level) == ref_pol.needs_spill(
                ref_p, n, level)
            assert pol.runs_to_spill(p, n) == ref_pol.runs_to_spill(ref_p, n)


# -- RETUNE's filter rebuild --------------------------------------------------

def test_retune_filters_bitwise_to_each_preset_and_noop_to_active():
    ref_p = SLSMParams(**SMALL, merge_budget=1, tuning=ADAPTIVE)
    ref, port = _pair(ref_p)
    rng = np.random.default_rng(5)
    for _ in range(8):
        _write((ref, port), rng, 70, deletes=3)
    _leaves_equal(ref.state, port.state)
    assert port.n_levels >= 2 and port.tuner.active == "write"
    before = convert.state_to_leaves(port.state)
    same = TU.retune_filters(port.p_active, port.state)
    for g, w in zip(convert.state_to_leaves(same), before):
        np.testing.assert_array_equal(g, w)
    for name, alloc in RTU.build_presets(ref_p).items():
        want = RTU.retune_filters(
            alloc.apply(ref_p), jax.tree_util.tree_map(jnp.array, ref.state))
        got = TU.retune_filters(TU.build_presets(port.p)[name].apply(port.p),
                                port.state)
        _leaves_equal(want, got)


# -- the adaptive engine end to end -------------------------------------------

@pytest.mark.parametrize("policy", ["tiering", "leveling"])
@pytest.mark.parametrize("budget", [0, 1])
def test_adaptive_stream_bitwise_through_retunes(policy, budget):
    """Answers (dense and sparse), every state leaf, the counters and the
    tuner's position equal the reference's after every round, through at
    least two retunes that reach READ."""
    ref_p = SLSMParams(**SMALL, merge_budget=budget, tuning=ADAPTIVE)
    ref, port = _pair(ref_p, policy)
    oracle = DictOracle()
    seen = _shifting(ref, port, oracle, np.random.default_rng(23 + budget))
    assert port.stats["retunes"] >= 2
    assert "read" in seen and "write" in seen
    port.drain()
    ref.drain()
    _same_position(ref, port)
    _reads_equal(ref, port, oracle, np.arange(-2, KEY_SPACE + 2,
                                              dtype=np.int32))


def test_voluntary_steps_and_drain_retire_a_pending_retune():
    ref_p = SLSMParams(**SMALL, merge_budget=1, tuning=ADAPTIVE)
    ref, port = _pair(ref_p)
    rng = np.random.default_rng(9)
    _write((ref, port), rng, 200)
    assert port.tuner.active == ref.tuner.active == "write"
    qs = np.arange(0, KEY_SPACE, dtype=np.int32)
    for _ in range(4):          # reads decide READ but never apply it
        ref.lookup_many(qs)
        port.lookup_many(qs)
    assert port.tuner.pending and port.tuner.target == "read"
    assert port.voluntary_steps(1) == ref.voluntary_steps(1) == 1
    _same_position(ref, port)
    assert port.tuner.active == "read"
    assert port.voluntary_steps(50) == ref.voluntary_steps(50)
    port.drain()
    ref.drain()
    _same_position(ref, port)


def test_level_probe_stats_equal_reference():
    ref_p = SLSMParams(**SMALL, merge_budget=1, tuning=ADAPTIVE)
    ref, port = _pair(ref_p)
    rng = np.random.default_rng(4)
    for _ in range(10):
        _write((ref, port), rng, 60)
    assert port.n_levels >= 2
    qs = np.concatenate([np.arange(0, 200, dtype=np.int32),
                         rng.integers(-50, KEY_SPACE, 56).astype(np.int32)])
    presets = [a.apply(port.p) for a in TU.build_presets(port.p).values()]
    for pa in [port.p_active] + presets:
        rc, rh = RRP.level_probe_stats(_ref_params(ref_p, pa), ref.state,
                                       jnp.asarray(qs))
        c, h = RP.level_probe_stats(pa, port.state, torch.from_numpy(qs))
        assert c.dtype == h.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), np.asarray(rc))
        np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
        if pa is port.p_active:     # the geometry the filters were built at
            assert int(c.sum()) > int(h.sum()) > 0


def _ref_params(ref_p, port_p):
    """The reference parameter set with the port's effective fields."""
    return dataclasses.replace(
        ref_p, r_eff=port_p.r_eff, eps_mem=port_p.eps_mem,
        eps_per_level=port_p.eps_per_level, fence_stride=port_p.fence_stride)


# -- the sparse lookup --------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_sparse_lookup_bitwise_with_an_overflowing_gate(stride):
    """cand_factor 1 over hot keys every run holds: the gate overflows
    and the port drops the pairs the reference drops (answers that miss
    included), at fence stride 1 and 2."""
    ref_p = SLSMParams(R=2, Rn=8, eps=0.02, D=3, m=1.0, mu=4, max_levels=3,
                       max_range=512, cand_factor=1, fence_stride=stride)
    ref, port = _pair(ref_p)
    rng = np.random.default_rng(31)
    hot = np.arange(0, 16, 2, dtype=np.int32)
    for r in range(14):
        ks = np.concatenate([hot, rng.integers(20, 400, 8).astype(np.int32)])
        vs = rng.integers(-99, 99, ks.size).astype(np.int32) + r
        for t in (ref, port):
            t.insert(ks, vs)
    # cold keys push the hot keys' newest records out of memory, into the
    # newest disk runs: the pairs a row-major cut drops first
    cold = rng.integers(1000, 5000, 40).astype(np.int32)
    for t in (ref, port):
        t.insert(cold, cold)
    _leaves_equal(ref.state, port.state)
    assert port.n_levels >= 2
    qs = np.concatenate([hot, hot + 1, hot]).astype(np.int32)
    want = RRP.lookup_batch(ref.p, ref.state, jnp.asarray(qs), True, False)
    got = RP.lookup_batch(port.p, port.state, torch.from_numpy(qs), True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dense = port.lookup(qs)
    assert any((g.numpy() != d).any() for g, d in zip(got, dense)), \
        "the gate did not overflow"
    vr, fr = ref.lookup_many(qs, sparse=True)
    vp, fp = port.lookup_many(qs, sparse=True)
    np.testing.assert_array_equal(fp, fr)
    np.testing.assert_array_equal(vp, vr)


def test_compact_pairs_is_nonzero_in_row_major_order():
    g = torch.Generator().manual_seed(3)
    gate = torch.rand((5, 13), generator=g) < 0.4
    for cap in (1, 7, gate.numel(), gate.numel() + 9):
        d, q = np.nonzero(gate.numpy())
        want = np.full(cap, -1)
        flat = d * 13 + q
        want[:min(cap, flat.size)] = flat[:cap]
        np.testing.assert_array_equal(RP.compact_pairs(gate, cap).numpy(),
                                      want)


# -- skip_empty ---------------------------------------------------------------

def test_skip_empty_leaves_the_empty_level_out_of_the_probe(monkeypatch):
    """Once the read allocation's policy has emptied level 0, an adaptive
    lookup hands `bloom_probe_levels` only the occupied levels, reads no
    occupancy from the state, and answers as the full pass and the
    reference do."""
    ref_p = SLSMParams(**SMALL, merge_budget=1, tuning=ADAPTIVE)
    ref, port = _pair(ref_p)
    oracle = DictOracle()
    rng = np.random.default_rng(17)
    for _ in range(6):
        _write((ref, port, oracle), rng, 80)
    qs = np.arange(0, KEY_SPACE, dtype=np.int32)
    for _ in range(4):
        ref.lookup_many(qs)
        port.lookup_many(qs)
    _write((ref, port, oracle), rng, 8)      # READ applies, level 0 folds
    assert port.tuner.active == "read"
    run_count, level_runs = RP.host_occupancy(port.state)
    assert port.runs == (run_count, level_runs)
    assert level_runs[0] == 0 and any(level_runs[1:]), level_runs
    stacks = []
    real = TB.bloom_probe_levels

    def counted(st, q):
        stacks.append(len(st))
        return real(st, q)

    monkeypatch.setattr(TB, "bloom_probe_levels", counted)

    def no_read(state):
        raise AssertionError("a lookup read the run occupancy")

    for sparse in (False, True):
        with unittest.mock.patch.object(RP, "host_occupancy", no_read):
            vp, fp = port.lookup_many(qs, sparse=sparse)
        vr, fr = ref.lookup_many(qs, sparse=sparse)
        np.testing.assert_array_equal(fp, fr)
        np.testing.assert_array_equal(vp, vr)
        vf, ff = RP.lookup_batch(port.p_active, port.state,
                                 torch.from_numpy(qs), sparse)
        np.testing.assert_array_equal(fp, ff.numpy())
        np.testing.assert_array_equal(vp, vf.numpy())
    occupied = sum(n > 0 for n in level_runs)
    assert stacks == [occupied, port.n_levels] * 2
    vo, fo = oracle.lookup(qs)
    np.testing.assert_array_equal(fp, fo)


def test_warm_launches_each_read_op_and_changes_nothing():
    """`warm()` runs every read op once at each preset's allocation on
    the live state; state, counters and the tuner stay as they were."""
    ref_p = SLSMParams(**SMALL, merge_budget=1, tuning=ADAPTIVE)
    ref, port = _pair(ref_p)
    _write((ref, port), np.random.default_rng(2), 400)
    assert port.n_levels >= 1
    calls = []
    real = TB.bloom_probe_levels

    def counted(st, q):
        calls.append(len(st))
        return real(st, q)

    with unittest.mock.patch.object(TB, "bloom_probe_levels", counted):
        port.warm()
    # three presets x (dense, sparse lookup + probe telemetry)
    assert len(calls) == 3 * 3 and port.stats["reads"] == 0
    _same_position(ref, port)
