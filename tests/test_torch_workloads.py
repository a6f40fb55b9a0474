"""Port parity of `bench/`'s workloads and scenarios: the same seeds
through `repro.bench.workloads` and `repro_torch.bench.workloads` give
bitwise-equal streams for every family (numpy only); the scenario
registry, its profiles and every scenario's `engine_params()` equal the
reference's but for `backend`, which `Scenario.device()` maps to a
device; and the port's engine on the CPU (the plain versions) answers
exactly as the oracle under each phase family, leveling and the
synchronous cascade, at the scenarios' own parameters and the smoke
profile, with one cell held bitwise against the reference's engine."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.bench import scenarios as RS  # noqa: E402
from repro.bench import workloads as RW  # noqa: E402
from repro_torch.bench import scenarios as PS  # noqa: E402
from repro_torch.bench import workloads as PW  # noqa: E402

FAMILIES = sorted(RW.WORKLOAD_FAMILIES)
SCAN_BATCH = 32            # the reference runner's RANGE_BATCH


def _same_workload(got, want):
    assert type(got).__name__ == type(want).__name__
    assert (got.name, got.kind, got.seed) == (want.name, want.kind,
                                              want.seed)
    assert got.meta == want.meta
    np.testing.assert_array_equal(got.absent, want.absent)
    assert got.absent.dtype == want.absent.dtype
    if isinstance(want, RW.ServingWorkload):
        assert len(got.requests) == len(want.requests)
        for i, (g, w) in enumerate(zip(got.requests, want.requests)):
            assert (g.client, g.kind) == (w.client, w.kind), i
            for a, b in ((g.keys, w.keys), (g.vals, w.vals)):
                assert a.dtype == b.dtype, i
                np.testing.assert_array_equal(a, b, err_msg=str(i))
        assert got.n == want.n
        return
    for f in ("keys", "vals", "lookups", "deletes", "ranges", "absent"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n", [1_000, 7_500])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_streams_bitwise(family, seed, n):
    _same_workload(PW.make_workload(family, n, seed),
                   RW.make_workload(family, n, seed))


@pytest.mark.parametrize("family,kw", [
    ("delete-heavy", dict(n_ranges=8)),
    ("range-scan", dict(n_ranges=8, span=2 ** 12)),
    ("shifting", dict(n_ranges=32, span=65_536)),
    ("zipfian", dict(universe=500, theta=0.8)),
    ("serving", dict(n_clients=3, max_req=5, delete_frac=0.15)),
])
def test_family_knobs_bitwise(family, kw):
    """Scan windows drawn after every other stream, and other knobs."""
    _same_workload(PW.make_workload(family, 3_000, 5, **kw),
                   RW.make_workload(family, 3_000, 5, **kw))


@pytest.mark.parametrize("kind", ["uniform", "normal", "zipf",
                                  "cluster-lookup"])
def test_make_kv_workload_bitwise(kind):
    got = PW.make_kv_workload(kind, 5_000, seed=3, lookup_frac=0.3)
    want = RW.make_kv_workload(kind, 5_000, seed=3, lookup_frac=0.3)
    assert got.name == want.name
    for f in ("keys", "vals", "lookups"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f)
    if kind == "normal":
        assert (got.keys < 0).any()      # keys centred on 0


def test_zipf_helpers_and_data_reexport():
    for universe, theta in ((20_000, 1.1), (1_000, 0.7), (1, 2.0)):
        np.testing.assert_array_equal(PW.zipf_probs(universe, theta),
                                      RW.zipf_probs(universe, theta))
        for frac in (0.01, 0.5):
            assert (PW.zipf_expected_top_mass(universe, theta, frac)
                    == RW.zipf_expected_top_mass(universe, theta, frac))
    import repro_torch.data as D
    from repro_torch.data import pipeline
    assert D.make_kv_workload is pipeline.make_kv_workload \
        is PW.make_kv_workload
    assert D.KVWorkload is PW.KVWorkload


@pytest.mark.parametrize("call", ["family", "kind", "serving_mix"])
def test_value_errors_match(call):
    fns = {"family": lambda m: m.make_workload("no-such-family", 10),
           "kind": lambda m: m.make_kv_workload("no-such-kind", 10),
           "serving_mix": lambda m: m.make_serving(
               100, insert_frac=0.6, lookup_frac=0.5)}
    msgs = []
    for mod in (PW, RW):
        with pytest.raises(ValueError) as e:
            fns[call](mod)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_registry_profiles_and_order():
    assert PS.PROFILES == RS.PROFILES
    assert [s.name for s in PS.CANONICAL] == [s.name for s in RS.CANONICAL]
    assert list(PS.SWEEPS) == list(RS.SWEEPS)
    for k in RS.SWEEPS:
        assert [s.name for s in PS.SWEEPS[k]] == [s.name
                                                  for s in RS.SWEEPS[k]]
    assert list(PS.SCENARIOS) == list(RS.SCENARIOS)
    assert PS.SHIFT_PARAMS == RS.SHIFT_PARAMS
    assert dataclasses.asdict(PS.ADAPTIVE) == dataclasses.asdict(RS.ADAPTIVE)


def _params_equal(got, want):
    """Field by field, the reference's `backend` aside."""
    got_f = {f.name for f in dataclasses.fields(got)}
    want_f = {f.name for f in dataclasses.fields(want)}
    assert want_f - got_f == {"backend"} and got_f <= want_f
    for f in sorted(got_f):
        a, b = getattr(got, f), getattr(want, f)
        if f == "tuning":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b and type(a) is type(b), f


@pytest.mark.parametrize("name", sorted(RS.SCENARIOS))
def test_scenario_engine_params_equal(name):
    got, want = PS.SCENARIOS[name], RS.SCENARIOS[name]
    for f in ("name", "workload", "wargs", "policy", "n_shards", "seed",
              "durability", "replication"):
        assert getattr(got, f) == getattr(want, f), f
    assert set(got.params) == set(want.params)
    _params_equal(got.engine_params(), want.engine_params())
    # an override of the reference's backend names the device; the
    # reference's default ("jnp") is the card's kernels here
    want_dev = ({"jnp": "cpu", "pallas": "cuda"}[want.params["backend"]]
                if "backend" in want.params else "cuda")
    assert got.device() == want_dev


def test_backend_scenarios_map_to_devices():
    assert PS.SCENARIOS["sweep_backend_jnp"].device() == "cpu"
    assert PS.SCENARIOS["sweep_backend_pallas"].device() == "cuda"
    assert PS.SCENARIOS["uniform"].device() == "cuda"
    for name in ("sweep_backend_jnp", "sweep_backend_pallas"):
        assert "backend" in PS.SCENARIOS[name].params
        _params_equal(PS.SCENARIOS[name].engine_params(),
                      RS.bench_params())
    _params_equal(PS.bench_params(R=2, eps=0.1),
                  RS.bench_params(R=2, eps=0.1))


@pytest.mark.parametrize("selector", [
    "all", "sweeps", "sweep-R", "sweep-backend", "uniform",
    "zipfian, sweep-eps ,uniform,all", "sweep_tuner_eps_0p1,sweep-tuner"])
def test_scenarios_for_equal(selector):
    assert ([s.name for s in PS.scenarios_for(selector)]
            == [s.name for s in RS.scenarios_for(selector)])


def test_scenarios_for_unknown_raises():
    for mod in (PS, RS):
        with pytest.raises(ValueError, match="unknown scenario selector"):
            mod.scenarios_for("uniform,no_such_scenario")


# -- the port's engine on the CPU under each scenario -----------------------

def _windows(w, seed: int, n: int = 8, per: int = 48):
    """The workload's own scan windows, or, for a family without them,
    `n` windows each spanning `per` distinct inserted keys (from an rng of
    their own: the workload's streams stay as they are)."""
    if len(w.ranges):
        return w.ranges
    distinct = np.unique(w.keys)
    rng = np.random.default_rng((seed, 99))
    i = rng.integers(0, len(distinct) - per, n)
    return np.stack([distinct[i], distinct[i + per] + 1], 1).astype(
        np.int32)


def _drive(eng, w, p, windows, batch: int, n_lookups: int):
    """The reference runner's order: inserts and deletes in chunks of
    4 * Rn, a drain, lookups in `batch`es, then each window as a scan
    and as an aggregate in batches of 32. Returns every answer."""
    chunk = 4 * p.Rn
    for off in range(0, len(w.keys), chunk):
        eng.insert(w.keys[off:off + chunk], w.vals[off:off + chunk])
    for off in range(0, len(w.deletes), chunk):
        eng.delete(w.deletes[off:off + chunk])
    eng.drain()
    qs = np.concatenate([w.lookups[:n_lookups], w.absent[:256]])
    out = {"lookups": [eng.lookup_many(qs[i:i + batch])
                       for i in range(0, len(qs), batch)], "qs": qs}
    out["scans"] = [eng.range_many(windows[i:i + SCAN_BATCH])
                    for i in range(0, len(windows), SCAN_BATCH)]
    out["aggregates"] = [eng.aggregate_many(windows[i:i + SCAN_BATCH])
                         for i in range(0, len(windows), SCAN_BATCH)]
    return out


def _oracle_of(w):
    from repro_torch.core.oracle import DictOracle
    oracle = DictOracle()
    oracle.insert(w.keys, w.vals)
    oracle.delete(w.deletes)
    return oracle


def _check_against_oracle(out, oracle, windows):
    vals = np.concatenate([v for v, _ in out["lookups"]])
    found = np.concatenate([f for _, f in out["lookups"]])
    vo, fo = oracle.lookup(out["qs"])
    np.testing.assert_array_equal(found, fo)
    np.testing.assert_array_equal(vals[found], vo[fo])
    rows = [r for batch in out["scans"] for r in zip(*batch)]
    aggs = [a for batch in out["aggregates"] for a in zip(*batch)]
    n_trunc = 0
    for (lo, hi), (k, v, c, tr), (ac, asum, atr) in zip(windows, rows,
                                                          aggs):
        ek, ev = oracle.range(int(lo), int(hi))
        c = int(c)
        assert c <= len(ek) and (tr or c == len(ek)), (lo, hi)
        np.testing.assert_array_equal(k[:c], ek[:c])
        np.testing.assert_array_equal(v[:c], ev[:c])
        if not atr:
            assert (int(ac), int(asum)) == oracle.aggregate(int(lo),
                                                            int(hi))
        n_trunc += bool(tr)
    return n_trunc


def _smoke_workload(sc):
    """The reference runner's workload at the smoke profile."""
    prof = PS.PROFILES["smoke"]
    wargs = dict(sc.wargs)
    if sc.workload in ("range-scan", "delete-heavy", "shifting"):
        wargs.setdefault("n_ranges", prof["n_ranges"])
    return PW.make_workload(sc.workload, prof["n"], seed=sc.seed, **wargs)


@pytest.mark.parametrize("name", [
    "uniform", "sequential", "zipfian", "delete_heavy", "range_scan",
    "sweep_policy_leveling", "sweep_merge_budget_0"])
def test_port_engine_exact_under_scenario(name):
    from repro_torch.engine import SLSM, LevelingPolicy, TieringPolicy
    sc = PS.SCENARIOS[name]
    p = sc.engine_params()
    w = _smoke_workload(sc)
    windows = _windows(w, sc.seed)
    prof = PS.PROFILES["smoke"]
    policy = {"tiering": TieringPolicy, "leveling": LevelingPolicy}[sc.policy]
    eng = SLSM(p, policy=policy(), device="cpu")
    out = _drive(eng, w, p, windows, prof["batch"], prof["n_lookups"])
    n_trunc = _check_against_oracle(out, _oracle_of(w), windows)
    assert eng.n_levels >= 1 and eng.stats["flushes"] >= 1
    if name == "range_scan":
        assert n_trunc == 0
    if sc.policy == "leveling":
        assert all(int(lv.n_runs) <= 2 for lv in eng.state.levels)
    if name == "delete_heavy":
        qs = out["qs"][:prof["n_lookups"]]
        dead = np.isin(qs, w.deletes)
        found = np.concatenate([f for _, f in out["lookups"]])
        assert dead.any() and not found[:len(qs)][dead].any()


def test_delete_heavy_leveling_bitwise_against_reference():
    """One cell through both engines: delete_heavy under leveling, the
    reference on its plain jnp ops."""
    from repro.engine import SLSM as RefSLSM
    from repro.engine import LevelingPolicy as RefLeveling
    from repro_torch.engine import SLSM, LevelingPolicy
    sc = PS.SCENARIOS["delete_heavy"]
    p = sc.engine_params()
    ref_p = dataclasses.replace(RS.SCENARIOS["delete_heavy"].engine_params(),
                                backend="jnp")
    w = _smoke_workload(sc)
    windows = _windows(w, sc.seed)
    prof = PS.PROFILES["smoke"]
    got = _drive(SLSM(p, policy=LevelingPolicy(), device="cpu"),
                 w, p, windows, prof["batch"], prof["n_lookups"])
    want = _drive(RefSLSM(ref_p, policy=RefLeveling()),
                  w, ref_p, windows, prof["batch"], prof["n_lookups"])
    _check_against_oracle(got, _oracle_of(w), windows)
    for part in ("lookups", "scans", "aggregates"):
        for g, r in zip(got[part], want[part]):
            for a, b in zip(g, r):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=part)
