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
