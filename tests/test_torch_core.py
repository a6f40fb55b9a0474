"""Port parity: `repro_torch.core` (bloom, runs) bitwise against
`repro.core` on the same seeded numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import bloom as RBL  # noqa: E402
from repro.core import runs as RRU  # noqa: E402
from repro.core.params import KEY_EMPTY  # noqa: E402
from repro_torch.core import bloom as TBL  # noqa: E402
from repro_torch.core import runs as TRU  # noqa: E402

I32 = np.iinfo(np.int32)


def _keys(rng, n):
    """Keys spanning the whole int32 domain: negatives and both extremes
    (KEY_EMPTY excluded — it is the reserved padding key)."""
    edge = np.asarray([I32.min, I32.min + 1, -1, 0, 1, I32.max - 1],
                      np.int32)
    body = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
    return np.concatenate([edge, body])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_fmix32_and_probe_positions_bitwise():
    rng = np.random.default_rng(0)
    keys = _keys(rng, 4000)
    u = np.asarray(RBL.fmix32(jnp.asarray(keys.view(np.uint32))))
    got = TBL.fmix32(TBL.as_u32(_t(keys))).numpy()
    np.testing.assert_array_equal(got, u.astype(np.int64))
    for k, bits in [(1, 64), (7, 1000), (10, 12_345_664), (13, 2 ** 31 + 32)]:
        want = np.asarray(RBL.probe_positions(jnp.asarray(keys), k, bits))
        got = TBL.probe_positions(_t(keys), k, bits).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n,words,k,bits", [
    (100, 64, 5, None), (3000, 2048, 10, None), (500, 300, 7, 4000),
    (64, 8, 2, 200)])
def test_bloom_build_and_probe_bitwise(n, words, k, bits):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n)
    valid = rng.random(keys.size) < 0.8
    want = np.asarray(RBL.bloom_build(jnp.asarray(keys), jnp.asarray(valid),
                                      words, k, bits))
    got = TBL.bloom_build(_t(keys), _t(valid), words, k, bits).numpy()
    np.testing.assert_array_equal(got, want.view(np.int32))
    qs = np.concatenate([keys, _keys(rng, 2000)])
    pw = np.asarray(RBL.bloom_probe(jnp.asarray(want), jnp.asarray(qs), k,
                                    bits))
    pg = TBL.bloom_probe(_t(got), _t(qs), k, bits).numpy()
    np.testing.assert_array_equal(pg, pw)
    assert pg[:keys.size][valid].all()   # no false negatives


@pytest.mark.parametrize("words,k,bits", [(64, 5, None), (300, 7, 4000)])
def test_bloom_insert_bitwise(words, k, bits):
    """`bloom_insert` ORs a second build into a filter bit for bit as the
    reference's (and equals one build over both key sets)."""
    rng = np.random.default_rng(words)
    a, b = _keys(rng, 200), _keys(rng, 150)
    va, vb = rng.random(a.size) < 0.8, rng.random(b.size) < 0.8
    ref = RBL.bloom_build(jnp.asarray(a), jnp.asarray(va), words, k, bits)
    ref = np.asarray(RBL.bloom_insert(ref, jnp.asarray(b), jnp.asarray(vb),
                                      k, bits))
    got = TBL.bloom_build(_t(a), _t(va), words, k, bits)
    got = TBL.bloom_insert(got, _t(b), _t(vb), k, bits)
    np.testing.assert_array_equal(got.numpy(), ref.view(np.int32))
    both = TBL.bloom_build(_t(np.concatenate([a, b])),
                           _t(np.concatenate([va, vb])), words, k, bits)
    assert torch.equal(got, both)

def _runs(rng, k, cap, key_space=300, fill=0.8):
    """k (key, seq)-sorted deduped runs with globally unique seqs and
    mixed weights, KEY_EMPTY-padded — the engine's run layout."""
    K = np.full((k, cap), KEY_EMPTY, np.int32)
    V = np.zeros((k, cap), np.int32)
    W = np.zeros((k, cap), np.int32)
    S = np.zeros((k, cap), np.int32)
    seqs = rng.permutation(k * cap).astype(np.int32)
    for r in range(k):
        n = int(rng.integers(0, int(cap * fill) + 1))
        ks = np.sort(rng.choice(key_space, n, replace=False)).astype(np.int32)
        K[r, :n] = ks - key_space // 2
        V[r, :n] = rng.integers(I32.min, I32.max, n, dtype=np.int64)
        W[r, :n] = rng.choice([-1, 1], n)
        S[r, :n] = seqs[r * cap:r * cap + n]
    return K, V, W, S


def test_sort_survivor_compact_bitwise():
    rng = np.random.default_rng(1)
    n = 700
    k = rng.integers(-50, 50, n).astype(np.int32)
    k[rng.random(n) < 0.2] = KEY_EMPTY
    v = rng.integers(I32.min, I32.max, n, dtype=np.int64).astype(np.int32)
    w = rng.choice([-1, 1], n).astype(np.int32)
    s = rng.permutation(n).astype(np.int32)
    s[k == KEY_EMPTY] = 0
    want = RRU.sort_records(*map(jnp.asarray, (k, v, w, s)))
    got = TRU.sort_records(*map(_t, (k, v, w, s)))
    # padding ties (KEY_EMPTY, seq 0) may order their payload lanes
    # differently; every consumer masks them, so compare keys/seqs fully
    # and the payload lanes on real records
    real = np.asarray(want[0]) != KEY_EMPTY
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a.numpy()[real], np.asarray(b)[real])
    for drop in (False, True):
        mw = RRU.survivor_mask(want[0], want[2], drop)
        mg = TRU.survivor_mask(got[0], got[2], drop)
        np.testing.assert_array_equal(mg.numpy(), np.asarray(mw))
        cw = RRU.compact(*want, mw)
        cg = TRU.compact(*got, mg)
        for a, b in zip(cg, cw):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert cg[4].dtype == torch.int32


@pytest.mark.parametrize("k,cap", [(2, 16), (5, 40), (8, 64)])
@pytest.mark.parametrize("drop", [False, True])
def test_merge_runs_bitwise(k, cap, drop):
    rng = np.random.default_rng(k * 100 + cap)
    lanes = _runs(rng, k, cap)
    want = RRU.merge_runs(*map(jnp.asarray, lanes), drop)
    got = TRU.merge_runs(*map(_t, lanes), drop)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4].dtype == torch.int32


@pytest.mark.parametrize("count", [0, 1, 37, 64])
def test_fences_and_minmax_bitwise(count):
    rng = np.random.default_rng(count)
    keys = np.full(64, KEY_EMPTY, np.int32)
    keys[:count] = np.sort(rng.choice(10_000, count, replace=False)) - 5000
    for mu in (4, 16, 64):
        want = RRU.build_fences(jnp.asarray(keys), mu, 64 // mu)
        got = TRU.build_fences(_t(keys), mu, 64 // mu)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = np.int32(count)
    wmn, wmx = RRU.run_minmax(jnp.asarray(keys), jnp.asarray(c))
    gmn, gmx = TRU.run_minmax(_t(keys), torch.tensor(c))
    assert (int(gmn), int(gmx)) == (int(wmn), int(wmx))
    assert gmn.dtype == torch.int32 and gmx.dtype == torch.int32


# -- the rank-merge: merge_two_ranked, merge_kway_ranked -----------------------

def _collide(lanes, rng):
    """Copy a few real (key, seq) pairs of run 0 into run 1 (each at its
    sorted place, payloads different), so that equal (key, seq) pairs
    meet across the runs as well as their KEY_EMPTY padding lanes."""
    K, V, W, S = (np.array(a) for a in lanes)
    n0 = int((K[0] != KEY_EMPTY).sum())
    n1 = int((K[1] != KEY_EMPTY).sum())
    take = rng.choice(n0, min(3, n0, K.shape[1] - n1), replace=False)
    rows = [(int(K[0, i]), int(S[0, i]), int(rng.integers(-50, 50)),
             int(W[0, i])) for i in take]
    rows += [(int(K[1, i]), int(S[1, i]), int(V[1, i]), int(W[1, i]))
             for i in range(n1)]
    rows.sort(key=lambda r: (r[0], r[1]))
    for j, (k, s, v, w) in enumerate(rows):
        K[1, j], S[1, j], V[1, j], W[1, j] = k, s, v, w
    return K, V, W, S


@pytest.mark.parametrize("k,cap,seed,drop,collide", [
    (2, 16, 0, False, False), (3, 64, 1, True, False),
    (5, 96, 2, False, False), (4, 64, 3, True, False),
    (2, 16, 4, False, True), (3, 64, 5, True, True), (5, 32, 6, False, True),
])
def test_rank_merges_bitwise(k, cap, seed, drop, collide):
    """`tests/test_merge.py`'s grid (its `make_runs`: int8 weights, seqs
    out of key order), plus runs where equal (key, seq) pairs meet: both
    rank to one slot, b's lanes win and the next slot keeps KEY_EMPTY."""
    from test_merge import make_runs
    rng = np.random.default_rng(seed)
    lanes = tuple(np.array(a) for a in make_runs(rng, k, cap))
    if collide:
        lanes = _collide(lanes, rng)
    ref = tuple(map(jnp.asarray, lanes))
    port = tuple(map(_t, lanes))
    want = RRU.merge_two_ranked(*(a[0] for a in ref), *(a[1] for a in ref))
    got = TRU.merge_two_ranked(*(a[0] for a in port), *(a[1] for a in port))
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if collide:                  # a KEY_EMPTY slot before a real key
        keys = np.asarray(want[0])
        last = np.flatnonzero(keys != KEY_EMPTY).max()
        assert (keys[:last] == KEY_EMPTY).any()
    want = RRU.merge_kway_ranked(*ref, drop)
    got = TRU.merge_kway_ranked(*port, drop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4].dtype == torch.int32


# -- the skiplist oracle, geometric levels, the facade -------------------------

def test_skiplist_ref_matches_reference():
    """One op stream (inserts with duplicates, lookups, ranges) through
    both copies from one numpy seed: the same answers, and the same
    level drawn for every node."""
    from repro.core.skiplist_ref import SkipListRef as Ref
    from repro_torch.core.skiplist_ref import MAXLEVEL, SkipListRef, ffs_level
    from repro.core.skiplist_ref import ffs_level as ref_ffs
    rng = np.random.default_rng(9)
    a, b = Ref(seed=5), SkipListRef(seed=5)
    for _ in range(3000):
        key, val = int(rng.integers(0, 1500)), int(rng.integers(-99, 99))
        a.insert(key, val)
        b.insert(key, val)
        q = int(rng.integers(-5, 1505))
        assert a.lookup(q) == b.lookup(q)
    assert a.items() == b.items() and (a.n, a.level) == (b.n, b.level)
    for lo in range(-10, 1510, 97):
        assert a.range(lo, lo + 150) == b.range(lo, lo + 150)
    x, y = a.head.fwd[0], b.head.fwd[0]
    while x is not None:
        assert (x.key, len(x.fwd)) == (y.key, len(y.fwd))
        x, y = x.fwd[0], y.fwd[0]
    assert y is None
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for m in (1, 4, MAXLEVEL):
        assert ([ref_ffs(r1, m) for _ in range(500)]
                == [ffs_level(r2, m) for _ in range(500)])


def test_geometric_distribution():
    """`tests/test_levels_rng.py::test_geometric_distribution` on the
    port (its own generator: the draws are not the reference's)."""
    from repro_torch.core.levels_rng import MAXLEVEL, fast_geometric_levels
    lv = fast_geometric_levels(torch.Generator().manual_seed(0), (100000,),
                               device="cpu")
    assert lv.dtype == torch.int32
    lv = lv.numpy()
    assert lv.min() >= 1 and lv.max() <= MAXLEVEL
    for n, p in ((1, 0.5), (2, 0.25), (3, 0.125), (4, 0.0625)):
        assert abs((lv == n).mean() - p) < 0.01, n


def test_levels_match_paper_ffs_oracle():
    """`tests/test_levels_rng.py::test_matches_paper_ffs_oracle` on the
    port, against the port's own skiplist oracle; and the cap: with
    maxlevel 3 every level lies in [1, 3], r == 0 counted as 3."""
    from repro_torch.core.levels_rng import fast_geometric_levels
    from repro_torch.core.skiplist_ref import ffs_level
    lv = fast_geometric_levels(torch.Generator().manual_seed(1), (100000,),
                               device="cpu").numpy()
    r = np.random.default_rng(0)
    ref = np.array([ffs_level(r) for _ in range(100000)])
    assert abs(lv.mean() - ref.mean()) < 0.02
    assert abs(lv.std() - ref.std()) < 0.05
    small = fast_geometric_levels(torch.Generator().manual_seed(2), (4, 8000),
                                  maxlevel=3, device="cpu").numpy()
    assert small.shape == (4, 8000)
    assert abs((small == 3).mean() - 0.25) < 0.01    # P(3) + P(r == 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fast_geometric_levels(torch.Generator(), (4,))


def test_express_lane_offsets_equal():
    from repro.core.levels_rng import express_lane_offsets as ref
    from repro_torch.core.levels_rng import express_lane_offsets
    for rn in (0, 1, 2, 3, 8, 800, 1024, 40_448):
        assert express_lane_offsets(rn) == ref(rn)


def test_core_facade_exports_match_reference():
    """`core.slsm` exports the reference's names less `OpsBackend` and
    `get_backend` (the port dispatches by device); `core` resolves the
    engine names lazily to the engine's own objects."""
    import repro.core as RC
    import repro.core.slsm as rslsm
    import repro_torch.core as TC
    import repro_torch.core.slsm as tslsm
    from repro_torch import engine
    from repro_torch.engine import compaction, read_path

    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")}
    assert public(tslsm) == public(rslsm) - {"OpsBackend", "get_backend"}
    assert TC._ENGINE_EXPORTS == RC._ENGINE_EXPORTS
    for name in TC._ENGINE_EXPORTS:
        assert name in dir(TC)
        assert getattr(TC, name) is getattr(tslsm, name)
    assert TC.SLSM is engine.SLSM and TC.ShardedSLSM is engine.ShardedSLSM
    assert tslsm.range_query is read_path.range_query
    assert tslsm.merge_level_down is compaction.merge_level_down
    assert TC.slsm is tslsm
    for name in ("KEY_EMPTY", "SEQ_NONE", "TOMBSTONE"):
        assert getattr(TC, name) == getattr(RC, name)
    with pytest.raises(AttributeError):
        TC.OpsBackend


def test_engine_exports_match_reference():
    """`repro_torch.engine` exports every public name of `repro.engine`
    but the backend selector (`OpsBackend`, `get_backend`, `BACKENDS`),
    each the object its port submodule defines."""
    import repro.engine as RE
    from repro_torch import engine as TE
    from repro_torch.engine import batching, scheduler, tuner

    def public(mod):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and not isinstance(v, type(RE))}
    selector = {"OpsBackend", "get_backend", "BACKENDS"}
    missing = public(RE) - selector - public(TE)
    assert not missing, sorted(missing)
    assert not selector & public(TE)
    assert TE.Tuner is tuner.Tuner and TE.pad_to is batching.pad_to
    assert TE.Occupancy is scheduler.Occupancy
    assert TE.ADAPTIVE_BUCKETS == RE.ADAPTIVE_BUCKETS
    assert TE.RANGE_BUCKETS == RE.RANGE_BUCKETS
