"""Port parity of the four kernel packages.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
that version bitwise (tolerance 0, integer lanes) against the reference
Pallas kernel run in interpret mode and against the reference's jnp
`ref.py`. The CUDA kernels themselves are held against the plain
versions in `test_torch_gpu.py`, on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.bloom import bloom_build  # noqa: E402
from repro.core.params import KEY_EMPTY  # noqa: E402
from repro.core.runs import build_fences  # noqa: E402
from repro.kernels.bloom_probe import (bloom_probe_op,  # noqa: E402
                                       bloom_probe_ref)
from repro.kernels.fence_lookup import (fence_lookup_op,  # noqa: E402
                                        fence_lookup_ref)
from repro.kernels.heap_merge import (heap_merge_op,  # noqa: E402
                                      heap_merge_ref)
from repro.kernels.heap_merge.heap_merge import merge_two_pallas  # noqa: E402
from repro.kernels.range_merge import (range_merge_op,  # noqa: E402
                                       range_merge_ref)
from repro.kernels.range_merge.range_merge import (  # noqa: E402
    merge_round_pallas)
from repro_torch.kernels import bloom_probe as TBP  # noqa: E402
from repro_torch.kernels import fence_lookup as TFL  # noqa: E402
from repro_torch.kernels import heap_merge as THM  # noqa: E402
from repro_torch.kernels import range_merge as TRM  # noqa: E402

I32 = np.iinfo(np.int32)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- bloom_probe --------------------------------------------------------------

def _bloom_case(seed, d_n, n, words, k, bits, q_n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(I32.min, I32.max, (d_n, n), dtype=np.int64).astype(
        np.int32)
    blooms = np.stack([np.asarray(bloom_build(
        jnp.asarray(keys[d]), jnp.ones(n, bool), words, k, bits))
        for d in range(d_n)])
    qs = np.concatenate([keys[:, :q_n // 4].reshape(-1)[:q_n // 2],
                         rng.integers(I32.min, I32.max, q_n - q_n // 2,
                                      dtype=np.int64)]).astype(np.int32)
    qs[:3] = [I32.min, -1, I32.max - 1]
    return blooms, qs


@pytest.mark.parametrize("d_n,n,words,k,bits,q_n", [
    (3, 100, 64, 5, None, 300), (2, 400, 300, 7, 5000, 1100),
    (4, 60, 8, 2, 250, 64)])
def test_bloom_probe_plain_matches_pallas_and_ref(d_n, n, words, k, bits,
                                                  q_n):
    blooms, qs = _bloom_case(d_n + n, d_n, n, words, k, bits, q_n)
    got = TBP.bloom_probe_many(_t(blooms.view(np.int32)), _t(qs), k, bits)
    assert got.dtype == torch.bool and got.shape == (d_n, q_n)
    for d in range(d_n):
        _eq(got[d], bloom_probe_op(jnp.asarray(blooms[d]), jnp.asarray(qs),
                                   k, bits))
        _eq(got[d].to(torch.int32),
            bloom_probe_ref(jnp.asarray(blooms[d]), jnp.asarray(qs), k,
                            bits))


@pytest.mark.parametrize("geoms", [
    [(2, 100, 64, 1, None)],
    [(3, 200, 40, 13, 1200), (2, 50, 16, 4, None)],
    [(2, 80, 32, 6, 1000), (3, 300, 128, 10, 4000), (1, 30, 8, 13, 250)]],
    ids=["1 level k=1", "2 levels k=13,4", "3 levels k=6,10,13"])
def test_bloom_probe_levels_plain_matches_pallas_and_ref(geoms):
    """One `bloom_probe_levels` call over 1-3 levels, each its own (D, W,
    k, bits) (bits below 32 W too), against the Pallas kernel and
    `ref.py` level by level and run by run; the INT32 extremes among the
    keys, and keys of every level's runs among them."""
    rng = np.random.default_rng(len(geoms))
    stacks, qs = [], []
    for i, (d_n, n, words, k, bits) in enumerate(geoms):
        blooms, q = _bloom_case(10 * i + d_n, d_n, n, words, k, bits, 200)
        stacks.append((blooms, k, bits))
        qs.append(q[:100])
    qs = rng.permutation(np.concatenate(qs)).astype(np.int32)
    qs[:2] = [I32.min, I32.max]
    got = TBP.bloom_probe_levels(
        [(_t(b.view(np.int32)), k, bits) for b, k, bits in stacks], _t(qs))
    assert len(got) == len(stacks)
    for out, (blooms, k, bits) in zip(got, stacks):
        assert out.dtype == torch.bool and out.shape == (len(blooms),
                                                         len(qs))
        assert out.any() and not out.all()
        for d in range(len(blooms)):
            _eq(out[d], bloom_probe_op(jnp.asarray(blooms[d]),
                                       jnp.asarray(qs), k, bits))
            _eq(out[d].to(torch.int32),
                bloom_probe_ref(jnp.asarray(blooms[d]), jnp.asarray(qs), k,
                                bits))


# -- fence_lookup -------------------------------------------------------------

def _fence_case(seed, d_n, cap, mu, q_n):
    rng = np.random.default_rng(seed)
    keys = np.full((d_n, cap), KEY_EMPTY, np.int32)
    counts = rng.integers(0, cap + 1, d_n).astype(np.int32)
    counts[0] = cap
    for d in range(d_n):
        keys[d, :counts[d]] = np.sort(rng.choice(
            2 ** 20, counts[d], replace=False)) - 2 ** 19
    fences = np.stack([np.asarray(build_fences(jnp.asarray(keys[d]), mu,
                                               cap // mu))
                       for d in range(d_n)])
    qs = np.concatenate([keys[0, :q_n // 2],
                         rng.integers(-2 ** 19 - 5, 2 ** 19 + 5,
                                      q_n - q_n // 2)]).astype(np.int32)
    return keys, fences, counts, qs


@pytest.mark.parametrize("cap,mu,stride", [
    (64, 8, 1), (40, 4, 2), (40, 4, 4), (96, 8, 4), (512, 64, 1)])
def test_fence_lookup_plain_matches_pallas_and_ref(cap, mu, stride):
    """Strided fence views (every stride-th fence, mu*stride-wide pages)
    include partial last pages: 40 slots under 4 x 4 = 16-wide pages."""
    keys, fences, counts, qs = _fence_case(cap * stride, 3, cap, mu, 200)
    fv = np.ascontiguousarray(fences[:, ::stride])
    mu_eff = mu * stride
    got = TFL.fence_lookup_many(_t(qs), _t(fv), _t(keys), _t(counts), mu_eff)
    assert got.dtype == torch.int32
    for d in range(keys.shape[0]):
        args = (jnp.asarray(qs), jnp.asarray(fv[d]), jnp.asarray(keys[d]),
                jnp.asarray(counts[d]), mu_eff)
        _eq(got[d], fence_lookup_op(*args))
        _eq(got[d], fence_lookup_ref(*args))


# -- heap_merge ---------------------------------------------------------------

def _runs(rng, k, cap, key_space=400):
    """k deduped (key, seq)-sorted runs, globally unique seqs, mixed
    weights, KEY_EMPTY padded (seq 0) — the engine's run layout."""
    K = np.full((k, cap), KEY_EMPTY, np.int32)
    V = np.zeros((k, cap), np.int32)
    W = np.zeros((k, cap), np.int32)
    S = np.zeros((k, cap), np.int32)
    seqs = rng.permutation(k * cap).astype(np.int32)
    for r in range(k):
        n = int(rng.integers(0, cap + 1))
        K[r, :n] = np.sort(rng.choice(key_space, n, replace=False)) - 200
        V[r, :n] = rng.integers(I32.min, I32.max, n, dtype=np.int64)
        W[r, :n] = rng.choice([-1, 1], n)
        S[r, :n] = seqs[r * cap:r * cap + n]
    return K, V, W, S


@pytest.mark.parametrize("k", [2, 3, 5, 8])
@pytest.mark.parametrize("drop", [False, True])
def test_heap_merge_plain_matches_pallas_and_ref(k, drop):
    """Odd run counts carry their last run to the next round."""
    rng = np.random.default_rng(k)
    lanes = _runs(rng, k, 96)
    got = THM.heap_merge(*map(_t, lanes), drop)
    want_op = heap_merge_op(*map(jnp.asarray, lanes), drop)
    want_ref = heap_merge_ref(*map(jnp.asarray, lanes), drop)
    for g, a, b in zip(got, want_op, want_ref):
        _eq(g, a)
        _eq(g, b)


def test_heap_merge_round_matches_pallas_on_all_lanes():
    """One two-way round against the Pallas merge, every lane compared —
    including the tie order of the (KEY_EMPTY, seq 0) padding, which
    the source-index lane exposes."""
    rng = np.random.default_rng(11)
    K, _, W, S = _runs(rng, 2, 256)
    ix = np.arange(512, dtype=np.int32)
    flat = [a.reshape(-1) for a in (K, W, S)] + [ix]
    got = THM.merge_round(*map(_t, flat), [(0, 256, 512)])
    want = merge_two_pallas(*(jnp.asarray(a[:256]) for a in flat),
                            *(jnp.asarray(a[256:]) for a in flat))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("k", [2, 3, 5, 8, 20, 50])
def test_kway_merge_plain_matches_tournament_on_all_lanes(k):
    """The one-shot k-way order (a stable sort by (key, seq), ties to the
    higher run, then by position) is the tournament's, lane for lane,
    over partly filled runs whose (KEY_EMPTY, seq 0) padding ties across
    runs — the source-index lane exposes that order."""
    rng = np.random.default_rng(100 + k)
    K, _, W, S = _runs(rng, k, 40, key_space=120)
    flat = [_t(a.reshape(-1)) for a in (K, W, S)]
    ix = torch.arange(k * 40, dtype=torch.int32)
    want = THM.ops.tournament(*flat, ix, 40, k, THM.merge_round_plain)
    got = THM.kway_merge(*flat, ix, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    run, pos = np.divmod(np.arange(k * 40), 40)
    order = np.lexsort((pos, -run, S.reshape(-1), K.reshape(-1)))
    _eq(got[3], order.astype(np.int32))


@pytest.mark.parametrize("k,cap", [(20, 24), (50, 8)])
def test_heap_merge_kway_many_runs_matches_pallas_and_ref(k, cap):
    """The k-way path at the engine's run counts (a spill merges D = 20
    runs, a flush 50) against the reference's tournament and jnp ref."""
    rng = np.random.default_rng(k * cap)
    lanes = _runs(rng, k, cap, key_space=2 * cap)
    got = THM.heap_merge(*map(_t, lanes), True)
    want_op = heap_merge_op(*map(jnp.asarray, lanes), True)
    want_ref = heap_merge_ref(*map(jnp.asarray, lanes), True)
    for g, a, b in zip(got, want_op, want_ref):
        _eq(g, a)
        _eq(g, b)


# -- range_merge --------------------------------------------------------------

def _segments(rng, q_n, c_n, n_seg, empty_every=3, key_space=2000):
    """(Q, C) rows of n_seg sorted segments (some empty) at offsets, the
    unique-seq candidate layout, padded past offsets[:, -1]."""
    K = np.full((q_n, c_n), KEY_EMPTY, np.int32)
    V = np.zeros((q_n, c_n), np.int32)
    W = np.zeros((q_n, c_n), np.int32)
    S = np.zeros((q_n, c_n), np.int32)
    off = np.zeros((q_n, n_seg + 1), np.int32)
    for q in range(q_n):
        sizes = rng.integers(0, c_n // n_seg + 1, n_seg)
        sizes[::empty_every] = 0
        seqs = rng.permutation(c_n * 4)[:sizes.sum()]
        pos = 0
        for p, n in enumerate(sizes):
            ks = np.sort(rng.choice(key_space, n, replace=False)) - 1000
            K[q, pos:pos + n] = ks
            # a budget cut leaves KEY_EMPTY tails inside segments
            if n > 2 and p % 2:
                K[q, pos + n - 1] = KEY_EMPTY
            V[q, pos:pos + n] = rng.integers(I32.min, I32.max, n,
                                             dtype=np.int64)
            W[q, pos:pos + n] = rng.choice([-1, 1], n)
            S[q, pos:pos + n] = seqs[pos:pos + n]
            S[q, pos:pos + n][K[q, pos:pos + n] == KEY_EMPTY] = 0
            W[q, pos:pos + n][K[q, pos:pos + n] == KEY_EMPTY] = 0
            pos += n
            off[q, p + 1] = pos
    return K, V, W, S, off


@pytest.mark.parametrize("n_seg", [2, 3, 5, 7, 8, 91])
@pytest.mark.parametrize("drop", [False, True])
def test_range_merge_plain_matches_pallas_and_ref(n_seg, drop):
    """Non-power-of-two segment counts (91: the main path's scan rows),
    empty segments and KEY_EMPTY tails inside segments, on all five
    returned lanes."""
    rng = np.random.default_rng(n_seg)
    lanes = _segments(rng, 3, 512, n_seg)
    got = TRM.range_merge(*map(_t, lanes), drop)
    want_op = range_merge_op(*map(jnp.asarray, lanes), drop)
    want_ref = range_merge_ref(*map(jnp.asarray, lanes), drop)
    for g, a, b in zip(got, want_op, want_ref):
        _eq(g, a)
        _eq(g, b)


@pytest.mark.parametrize("final", [False, True])
def test_range_merge_round_matches_pallas_on_all_lanes(final):
    rng = np.random.default_rng(5)
    K, _, W, S, off = _segments(rng, 2, 512, 4 if not final else 2)
    ix = np.broadcast_to(np.arange(512, dtype=np.int32), K.shape)
    got = TRM.merge_round(*map(_t, (K, W, S, ix, off)), final, True)
    want = merge_round_pallas(*map(jnp.asarray, (K, W, S, ix, off)),
                              final=final, drop_annihilated=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("n_seg,c_n", [(2, 512), (5, 512), (91, 512),
                                        (128, 2048), (91, 4096)])
def test_range_merge_plain_matches_rounds_on_all_lanes(n_seg, c_n):
    """The one-sort plain version is the rounds' order lane for lane —
    (key, seq), ties to the later segment, then by position — over rows
    whose KEY_EMPTY tails tie across segments; distinct payloads expose
    the order of every lane."""
    rng = np.random.default_rng(n_seg + c_n)
    K, _, W, S, off = _segments(rng, 4, c_n, n_seg, key_space=2 * c_n)
    V = rng.permutation(4 * c_n).reshape(4, c_n).astype(np.int32) + 1
    for drop in (False, True):
        args = (*map(_t, (K, V, W, S, off)), drop)
        want = TRM.ops.range_merge_rounds(*args, TRM.merge_round_plain)
        got = TRM.range_merge_plain(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for q in range(4):
        n = off[q, -1]
        seg = np.repeat(np.arange(n_seg), np.diff(off[q]))
        order = np.lexsort((np.arange(n), -seg, S[q, :n], K[q, :n]))
        _eq(got[1][q, :n], np.where(K[q, order] == KEY_EMPTY, 0,
                                    V[q, order]))


def _tile_sizes(K, S, off, step, group):
    """The lanes of each tile the split kernel bounds in one row: every
    step-th lane of a segment is a sample, and every group-th sample in
    the merged order (key, seq, -segment, lane) starts a tile."""
    n = off[-1]
    seg = np.repeat(np.arange(len(off) - 1), np.diff(off))
    lane = np.arange(n) - off[seg]
    order = np.lexsort((lane, -seg, S[:n], K[:n]))
    rank = np.arange(n)[np.argsort(order)]
    starts = np.sort(rank[lane % step == 0])[::group]
    return np.diff(np.append(starts, n)), starts


@pytest.mark.parametrize("c_n", [512, 513, 16_384])
def test_range_geometry_covers_every_lane(c_n):
    """The wrapper's tiles hold every lane of a row once, none more than
    the tile's lanes, in no more tiles than the launch covers; a row of
    at most RANGE_TILE lanes is one tile (no split launch)."""
    for n_seg in (2, 91, 128):
        tile, step, group, tiles, shared, ctas = TRM.ops.range_geometry(
            c_n, n_seg)
        if c_n <= TRM.ops.RANGE_TILE:
            assert (tile, step, tiles) == (c_n, 0, 1)
            continue
        assert step * (group + n_seg) <= tile == TRM.ops.RANGE_TILE
        assert shared and ctas >= 1
        rng = np.random.default_rng(n_seg)
        K, _, _, S, off = _segments(rng, 3, c_n, n_seg, empty_every=5,
                                    key_space=2 * c_n)
        for q in range(3):
            sizes, starts = _tile_sizes(K[q], S[q], off[q], step, group)
            assert starts[0] == 0 and sizes.sum() == off[q, -1]
            assert sizes.max() <= tile and len(sizes) <= tiles


@pytest.mark.parametrize("f_n", [1580, 632_000])
def test_fence_geometry_covers_every_fence(f_n):
    """Staging every G-th fence covers the run's fences with the least
    power of two G that fits the budget, and the staged search followed
    by log2(G) steps in the bracket finds the full search's page."""
    group, staged = TFL.ops.fence_geometry(f_n)
    assert group & (group - 1) == 0
    assert (staged - 1) * group < f_n <= staged * group
    assert 4 * staged <= TFL.ops.FENCE_SMEM_BYTES
    assert group == 1 or 4 * -(-f_n // (group // 2)) > TFL.ops.FENCE_SMEM_BYTES
    assert group == (1 if f_n == 1580 else 64)
    rng = np.random.default_rng(f_n)
    fences = np.sort(rng.integers(-2 ** 30, 2 ** 30, f_n))
    x = np.concatenate([fences[rng.integers(0, f_n, 500)],
                        rng.integers(-2 ** 30 - 9, 2 ** 30 + 9, 500)])
    u = np.searchsorted(fences[::group], x, side="right")
    lo = np.maximum((u - 1) * group + 1, 0)
    hi = np.minimum(u * group, f_n)
    f = np.array([a + np.searchsorted(fences[a:b], v, side="right")
                  if g > 1 and uu > 0 else uu
                  for a, b, v, uu, g in zip(lo, hi, x, u,
                                             [group] * len(x))])
    np.testing.assert_array_equal(f, np.searchsorted(fences, x,
                                                     side="right"))


# -- the backend helpers around the kernels -----------------------------------

@pytest.mark.parametrize("stride", [1, 2, 4])
def test_backend_helpers_match_reference(stride):
    """`fence_window_idx`, `fence_window_bounds`, `candidate_gate` and
    `lookup_level_many` against `repro.engine.backend`, on strided fence
    views with partial last pages."""
    from repro.engine import backend as RB
    from repro_torch.engine import backend as TB
    cap, mu, d_n = 40, 4, 3
    keys, fences, counts, qs = _fence_case(stride, d_n, cap, mu, 120)
    fv = np.ascontiguousarray(fences[:, ::stride])
    mu_eff = mu * stride
    mins = np.where(counts > 0, keys[:, 0], KEY_EMPTY).astype(np.int32)
    maxs = np.asarray([keys[d, counts[d] - 1] if counts[d] else I32.min
                       for d in range(d_n)], np.int32)
    blooms = np.stack([np.asarray(bloom_build(
        jnp.asarray(keys[d]), jnp.asarray(keys[d] != KEY_EMPTY), 8, 3))
        for d in range(d_n)])
    for d in range(d_n):
        _eq(TB.fence_window_idx(_t(qs), _t(fv[d]), _t(keys[d]),
                                _t(counts[d]), mu_eff),
            RB.fence_window_idx(jnp.asarray(qs), jnp.asarray(fv[d]),
                                jnp.asarray(keys[d]),
                                jnp.asarray(counts[d]), mu_eff))
    lo = np.sort(qs)[::2][:40]
    hi = lo + np.arange(40, dtype=np.int32) * 3000
    st, en = TB.fence_window_bounds(_t(lo), _t(hi), _t(fv), _t(keys),
                                    _t(counts), mu_eff)
    for d in range(d_n):
        want = RB.fence_window_bounds(jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(fv[d]),
                                      jnp.asarray(keys[d]),
                                      jnp.asarray(counts[d]), mu_eff)
        _eq(st[d], want[0])
        _eq(en[d], want[1])
    be = RB.get_backend("jnp")
    _eq(TB.candidate_gate(_t(qs), _t(blooms.view(np.int32)), _t(mins),
                          _t(maxs), 3),
        RB.candidate_gate(be, jnp.asarray(qs), jnp.asarray(blooms),
                          jnp.asarray(mins), jnp.asarray(maxs), 3))
    got = TB.lookup_level_many(_t(qs), _t(blooms.view(np.int32)), _t(mins),
                               _t(maxs), _t(fv), _t(keys), _t(counts), 3,
                               mu_eff)
    want = RB.lookup_level_many(be, jnp.asarray(qs), jnp.asarray(blooms),
                                jnp.asarray(mins), jnp.asarray(maxs),
                                jnp.asarray(fv), jnp.asarray(keys),
                                jnp.asarray(counts), 3, mu_eff)
    for g, w in zip(got, want):
        _eq(g, w)
