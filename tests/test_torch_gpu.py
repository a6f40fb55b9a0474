"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `gpu` and skips where no CUDA device
exists (decided in the fixture, never at import). The file imports only
the port, so it runs on a machine without JAX:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bloom as BL  # noqa: E402
from repro_torch.core import runs as RU  # noqa: E402
from repro_torch.core.params import KEY_EMPTY  # noqa: E402
from repro_torch.kernels import bloom_probe as KBP  # noqa: E402
from repro_torch.kernels import fence_lookup as KFL  # noqa: E402
from repro_torch.kernels import heap_merge as KHM  # noqa: E402
from repro_torch.kernels import range_merge as KRM  # noqa: E402
from repro_torch.kernels.lsm_attention import ops as KLA  # noqa: E402

I32 = np.iinfo(np.int32)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return torch.tensor(np.ascontiguousarray(a), device=device)


def _sorted_runs(rng, d_n, cap, key_space):
    keys = np.full((d_n, cap), KEY_EMPTY, np.int32)
    counts = rng.integers(0, cap + 1, d_n).astype(np.int32)
    counts[0] = cap
    for d in range(d_n):
        keys[d, :counts[d]] = np.sort(rng.choice(
            key_space, counts[d], replace=False)) - key_space // 2
    return keys, counts


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [None, 9000])
def test_bloom_probe_kernel_matches_plain(cuda, bits):
    rng = np.random.default_rng(1)
    keys = rng.integers(I32.min, I32.max, (4, 500), dtype=np.int64).astype(
        np.int32)
    blooms = torch.stack([BL.bloom_build(_t(k), _t(np.ones(500, bool)), 300,
                                         7, bits) for k in keys]).to(cuda)
    qs = np.concatenate([keys.reshape(-1)[:1500],
                         rng.integers(I32.min, I32.max, 1500)])
    q = _t(qs.astype(np.int32), cuda)
    got = KBP.bloom_probe_many(blooms, q, 7, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, KBP.bloom_probe_plain(blooms, q, 7, bits))
    assert got[:, :500].any(dim=0).all()     # no false negatives


def _level(rng, d_n, n, words, k, bits, device):
    """A (d_n, words) stack of filters over n random keys each, and the
    keys (d_n, n)."""
    keys = rng.integers(I32.min, I32.max, (d_n, n), dtype=np.int64).astype(
        np.int32)
    blooms = torch.stack([BL.bloom_build(_t(kr), _t(np.ones(n, bool)),
                                         words, k, bits) for kr in keys])
    return blooms.to(device), keys


def _keys(rng, members, q_n):
    """q_n keys: half drawn from `members`, the rest random, the INT32
    extremes first."""
    qs = np.concatenate([rng.choice(members.reshape(-1), q_n // 2),
                         rng.integers(I32.min, I32.max, q_n - q_n // 2)])
    qs = rng.permutation(qs).astype(np.int32)
    qs[:2] = [I32.min, I32.max][:q_n]
    return qs


def _levels_equal(stacks, q):
    """One launch over `stacks`, bitwise against the plain version of
    each level; returns the verdicts."""
    before = KBP.bloom_probe_levels.launches
    got = KBP.bloom_probe_levels(stacks, q)
    torch.cuda.synchronize()
    assert KBP.bloom_probe_levels.launches == before + 1
    assert len(got) == len(stacks)
    for out, (b, k, bits) in zip(got, stacks):
        assert torch.equal(out, KBP.bloom_probe_plain(b, q, k, bits))
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("below", [False, True], ids=["bits=32W", "bits<32W"])
@pytest.mark.parametrize("k", [1, 2, 3, 6, 10, 13, 16, 32])
def test_bloom_probe_levels_kernel_each_k(cuda, k, below):
    """20 runs, 4,093 keys, every k from a single probe to 32 (past the
    burst and across its chunks), at the full width and below it."""
    rng = np.random.default_rng(k)
    words = 700
    bits = words * 32 - 77 if below else None
    blooms, keys = _level(rng, 20, 600 if k <= 16 else 300, words, k, bits,
                          cuda)
    q = _t(_keys(rng, keys, 4093), cuda)
    out, = _levels_equal([(blooms, k, bits)], q)
    assert out.any() and not out.all()


@pytest.mark.gpu
@pytest.mark.parametrize("q_n", [1, 255, 4093, 4096])
@pytest.mark.parametrize("d_n", [1, 20])
@pytest.mark.parametrize("n_levels", [1, 2, 3])
def test_bloom_probe_levels_kernel_mixed_levels(cuda, n_levels, d_n, q_n):
    """1-3 levels of one launch, each its own (W, k, bits): k 6, 10 and
    13, bits below 32 W in two of them; one or 20 runs a level, and a
    level with a ragged last run group (D = 7)."""
    rng = np.random.default_rng(100 * n_levels + d_n + q_n)
    geoms = [(d_n, 400, 300, 6, 9000), (7, 900, 2000, 10, None),
             (d_n, 300, 500, 13, 15_000)][:n_levels]
    stacks, members = [], []
    for d, n, words, k, bits in geoms:
        blooms, keys = _level(rng, d, n, words, k, bits, cuda)
        stacks.append((blooms, k, bits))
        members.append(keys.reshape(-1))
    q = _t(_keys(rng, np.concatenate(members), q_n), cuda)
    _levels_equal(stacks, q)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zeros", "ones", "all members",
                                  "no members"])
def test_bloom_probe_levels_kernel_extremes(cuda, case):
    """All-zero and all-one filters; a batch whose every (run, key) pair
    is a member (each run built over all the keys); one where no pair
    is (only keys every run's filter rejects)."""
    rng = np.random.default_rng(7)
    q_n = 4096
    keys = rng.integers(I32.min, I32.max, q_n, dtype=np.int64).astype(
        np.int32)
    keys[:2] = [I32.min, I32.max]
    stacks = []
    for d_n, words, k, bits in ((20, 2000, 10, 60_000), (3, 500, 13, None)):
        if case in ("zeros", "ones"):
            blooms = torch.full((d_n, words), 0 if case == "zeros" else -1,
                                dtype=torch.int32, device=cuda)
        elif case == "all members":
            blooms = BL.bloom_build(_t(keys), _t(np.ones(q_n, bool)), words,
                                    k, bits).to(cuda).expand(d_n, -1)
            blooms = blooms.contiguous()
        else:
            blooms, _ = _level(rng, d_n, 300, words, k, bits, cuda)
        stacks.append((blooms, k, bits))
    q = _t(keys, cuda)
    if case == "no members":
        hit = torch.zeros(q_n, dtype=torch.bool, device=cuda)
        for b, k, bits in stacks:
            hit |= KBP.bloom_probe_plain(b, q, k, bits).any(dim=0)
        q = q[~hit].contiguous()
    got = _levels_equal(stacks, q)
    every = torch.cat(got)
    if case in ("ones", "all members"):
        assert every.all()
    else:
        assert not every.any()


@pytest.mark.gpu
def test_bloom_probe_levels_struct_capacity(cuda):
    """As many levels as the launch's parameter struct holds go in one
    launch; one more raises before anything launches."""
    rng = np.random.default_rng(3)
    stacks, members = [], []
    for i in range(KBP.ops.MAX_LEVELS):
        blooms, keys = _level(rng, 1 + i % 5, 50, 16 + i, 1 + i % 13, None,
                              cuda)
        stacks.append((blooms, 1 + i % 13, None))
        members.append(keys.reshape(-1))
    q = _t(_keys(rng, np.concatenate(members), 500), cuda)
    _levels_equal(stacks, q)
    before = KBP.bloom_probe_levels.launches
    with pytest.raises(ValueError, match="at most"):
        KBP.bloom_probe_levels(stacks + stacks[:1], q)
    assert KBP.bloom_probe_levels.launches == before


@pytest.mark.gpu
def test_engine_on_card_one_probe_launch_a_lookup_batch(cuda):
    """The engine on the card through a write/delete stream that fills
    two disk levels or more: every lookup batch is oracle-exact and
    launches bloom_probe once, whatever the number of levels."""
    from repro_torch.core.oracle import DictOracle
    from repro_torch.core.params import SLSMParams
    from repro_torch.engine import SLSM
    p = SLSMParams(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=3,
                   max_range=512, cand_factor=16)
    rng = np.random.default_rng(5)
    eng, oracle = SLSM(p, device=cuda), DictOracle()
    batches = 0
    for _ in range(60):
        ks = rng.integers(0, 120, 12).astype(np.int32)
        vs = rng.integers(I32.min, I32.max, 12, dtype=np.int64).astype(
            np.int32)
        eng.insert(ks, vs)
        oracle.insert(ks, vs)
        dels = rng.integers(0, 120, 3).astype(np.int32)
        eng.delete(dels)
        oracle.delete(dels)
        if eng.n_levels:
            qs = np.arange(-3, 123, dtype=np.int32)
            before = KBP.bloom_probe_levels.launches
            v, f = eng.lookup_many(qs)
            assert KBP.bloom_probe_levels.launches == before + 1
            batches += 1
            vo, fo = oracle.lookup(qs)
            np.testing.assert_array_equal(f, fo)
            np.testing.assert_array_equal(v[f], vo[fo])
    assert eng.n_levels >= 2 and batches > 0


def _adaptive_paper():
    from repro_torch.configs.slsm_paper import paper_params
    from repro_torch.core.params import TuningPolicy
    return paper_params(merge_budget=1, range_cand=512, max_levels=4,
                        tuning=TuningPolicy(mode="adaptive", interval=512,
                                            eps_floor=1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["write", "read"])
def test_bloom_probe_levels_kernel_at_tuner_presets(cuda, preset):
    """Levels 0 and 1 at the paper geometry's WRITE and READ presets
    (effective bits below the words sized at eps_floor, but READ's
    level 0, which is at the floor), 4 runs a level of 4,093 keys; then
    the same batch with level 0 left out."""
    from repro_torch.engine import tuner as TU
    p = _adaptive_paper()
    pa = TU.build_presets(p)[preset].apply(p)
    rng = np.random.default_rng(40 + len(preset))
    stacks, members = [], []
    for level in (0, 1):
        cap, eps = pa.level_cap(level), pa.level_eps(level)
        bits, _, k = pa.bloom_geometry(cap, eps)
        words = pa.bloom_words_physical(cap, eps)
        assert bits < 32 * words or (preset, level) == ("read", 0)
        blooms, keys = _level(rng, 4, 4093, words, k, bits, cuda)
        stacks.append((blooms, k, bits))
        members.append(keys.reshape(-1))
    q = _t(_keys(rng, np.concatenate(members), 4096), cuda)
    both = _levels_equal(stacks, q)
    one, = _levels_equal(stacks[1:], q)
    assert torch.equal(one, both[1])


@pytest.mark.gpu
@pytest.mark.parametrize("sparse", [False, True])
def test_adaptive_stream_on_card_matches_cpu(cuda, sparse):
    """A shifting stream (write burst, reads with a trickle, writes) on
    the card and on the CPU: every answer, state leaf, counter and the
    tuner's position equal after every round, through retunes to WRITE
    and READ; once level 0 is folded empty the lookups leave it out of
    their one bloom_probe launch."""
    from repro_torch import convert
    from repro_torch.core.oracle import DictOracle
    from repro_torch.core.params import SLSMParams, TuningPolicy
    from repro_torch.engine import SLSM
    from repro_torch.engine.read_path import host_occupancy
    p = SLSMParams(R=4, Rn=32, eps=1e-2, D=3, m=1.0, mu=8, max_levels=3,
                   max_range=2048, cand_factor=16, merge_budget=1,
                   tuning=TuningPolicy(mode="adaptive", interval=64,
                                       eps_floor=1e-3))
    card, cpu, oracle = SLSM(p, device=cuda), SLSM(p, device="cpu"), \
        DictOracle()
    rng = np.random.default_rng(8)
    probe = np.arange(0, 600, dtype=np.int32)
    seen, folded = set(), 0

    def same():
        for g, w in zip(convert.state_to_leaves(card.state),
                        convert.state_to_leaves(cpu.state)):
            np.testing.assert_array_equal(g, w)
        assert dict(card.stats) == dict(cpu.stats)
        assert card.runs == cpu.runs == host_occupancy(cpu.state)
        assert (card.tuner.active, card.tuner.read_frac) == (
            cpu.tuner.active, cpu.tuner.read_frac)
        seen.add(card.tuner.active)

    def write(n):
        ks = rng.integers(0, 300, n).astype(np.int32) * 2
        vs = rng.integers(-99, 99, n).astype(np.int32)
        for t in (card, cpu, oracle):
            t.insert(ks, vs)

    for r in range(22):
        if r < 6 or r >= 18:
            write(80)
        else:
            level_runs = card.runs[1]
            before = KBP.bloom_probe_levels.launches
            v, f = card.lookup_many(probe, sparse=sparse)
            assert KBP.bloom_probe_levels.launches == before + bool(
                any(level_runs))
            folded += bool(level_runs) and level_runs[0] == 0
            vc, fc = cpu.lookup_many(probe, sparse=sparse)
            vo, fo = oracle.lookup(probe)
            np.testing.assert_array_equal(f, fc)
            np.testing.assert_array_equal(v, vc)
            np.testing.assert_array_equal(f, fo)
            np.testing.assert_array_equal(v[f], vo[fo])
            if r % 3 == 2:
                write(8)
        same()
    assert {"write", "read"} <= seen and card.stats["retunes"] >= 2
    assert folded


@pytest.mark.gpu
def test_run_tape_on_card_matches_cpu(cuda):
    """Mixed windows through `run_tape` on the card and on the CPU: equal
    per-chunk results and state."""
    from repro_torch import convert
    from repro_torch.core.params import SLSMParams
    from repro_torch.engine import SLSM
    p = SLSMParams(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=3,
                   max_range=512, cand_factor=16, merge_budget=1)
    card, cpu = SLSM(p, device=cuda), SLSM(p, device="cpu")
    rng = np.random.default_rng(13)
    for _ in range(10):
        window = []
        for _ in range(int(rng.integers(4, 17))):
            kind = rng.choice(["write", "lookup", "range"], p=[.5, .4, .1])
            n = int(rng.integers(1, 5 if kind == "range" else 9))
            ks = rng.integers(0, 100, n).astype(np.int32)
            window.append((str(kind), ks, (ks + rng.integers(0, 40, n))
                           .astype(np.int32), None))
        got, want = card.run_tape(window), cpu.run_tape(window)
        for g, w in zip(got, want):
            if isinstance(w, int):
                assert g == w
            else:
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a, b)
        card.voluntary_steps(1)
        cpu.voluntary_steps(1)
    for g, w in zip(convert.state_to_leaves(card.state),
                    convert.state_to_leaves(cpu.state)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("fence_bytes", [None, 64])
@pytest.mark.parametrize("stride", [1, 2, 4])
def test_fence_lookup_kernel_matches_plain(cuda, monkeypatch, stride,
                                           fence_bytes):
    """Stride views over 1000-slot runs leave partial last pages; with a
    64-byte fence budget a CTA stages every G-th fence (G = 8, 4, 2) and
    finishes the search in L2."""
    rng = np.random.default_rng(stride)
    keys, counts = _sorted_runs(rng, 5, 1000, 1 << 20)
    fences = np.ascontiguousarray(keys[:, ::8][:, ::stride])
    if fence_bytes:
        monkeypatch.setattr(KFL.ops, "FENCE_SMEM_BYTES", fence_bytes)
    assert (KFL.ops.fence_geometry(fences.shape[1])[0] > 1) == bool(
        fence_bytes)
    qs = np.concatenate([keys[0, :1000], rng.integers(-2 ** 19, 2 ** 19,
                                                      1000)]).astype(np.int32)
    args = [_t(a, cuda) for a in (qs, fences, keys, counts)]
    before = KFL.fence_lookup_many.launches
    got = KFL.fence_lookup_many(*args, 8 * stride)
    torch.cuda.synchronize()
    assert KFL.fence_lookup_many.launches == before + 1
    assert torch.equal(got, KFL.fence_lookup_plain(*args, 8 * stride))
    assert (got[0, :1000] >= 0).all()


@pytest.mark.gpu
def test_fence_lookup_kernel_at_write_preset_stride(cuda):
    """The WRITE preset's stride-2 view of paper level 0: 40,448-slot
    runs, 79 fences every 512, every 2nd searched with 1,024-wide pages,
    so the 40th page is partial and pinned to cap - 1,024."""
    rng = np.random.default_rng(77)
    keys, counts = _sorted_runs(rng, 4, 40_448, 1 << 24)
    fences = np.ascontiguousarray(keys[:, ::512][:, ::2])
    assert fences.shape[1] * 1024 > 40_448
    qs = np.concatenate([keys[0, :2048], keys[0, -2048:],
                         rng.integers(-2 ** 23, 2 ** 23, 2048)]).astype(
                             np.int32)
    qs = np.where(qs == KEY_EMPTY, 0, qs).astype(np.int32)
    args = [_t(a, cuda) for a in (qs, fences, keys, counts)]
    got = KFL.fence_lookup_many(*args, 1024)
    torch.cuda.synchronize()
    assert torch.equal(got, KFL.fence_lookup_plain(*args, 1024))
    assert (got[0, :4096] >= 0).all()      # the pinned page's keys too


def _runs(rng, k, cap):
    K, counts = _sorted_runs(rng, k, cap, 5000)
    real = K != KEY_EMPTY
    S = np.where(real, rng.permutation(K.size).reshape(K.shape), 0)
    W = np.where(real, rng.choice([-1, 1], K.shape), 0)
    V = np.where(real, rng.integers(I32.min, I32.max, K.shape), 0)
    return [a.astype(np.int32) for a in (K, V, W, S)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 5, 20])
def test_heap_merge_kernel_matches_plain(cuda, k):
    """Every lane of every round, then the whole merge against the
    sort-based `merge_runs`."""
    rng = np.random.default_rng(k)
    K, V, W, S = _runs(rng, k, 700)
    flat = [_t(a.reshape(-1), cuda) for a in (K, W, S)]
    ix = torch.arange(K.size, dtype=torch.int32, device=cuda)
    got = KHM.ops.tournament(*flat, ix, 700, k)
    torch.cuda.synchronize()
    want = KHM.ops.tournament(*flat, ix, 700, k, KHM.merge_round_plain)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for drop in (False, True):
        got = KHM.heap_merge(*(_t(a, cuda) for a in (K, V, W, S)), drop)
        want = RU.merge_runs(*(_t(a) for a in (K, V, W, S)), drop)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2, 3, 20, 50, 600])
def test_kway_merge_kernel_matches_plain(cuda, k):
    """The two-launch k-way merge against its plain version on all four
    lanes, partly filled runs (padding ties across runs)."""
    rng = np.random.default_rng(10 + k)
    K, _, W, S = _runs(rng, k, 3000)
    flat = [_t(a.reshape(-1), cuda) for a in (K, W, S)]
    ix = torch.arange(K.size, dtype=torch.int32, device=cuda)
    before = KHM.kway_merge.launches
    got = KHM.kway_merge(*flat, ix, k)
    torch.cuda.synchronize()
    assert KHM.kway_merge.launches == before + 2
    want = KHM.kway_merge_plain(*flat, ix, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("k,cap,sample_bytes", [(5, 2000, 64),
                                                (300, 200, None)])
def test_kway_merge_in_place_split_matches_plain(cuda, monkeypatch, k, cap,
                                                 sample_bytes):
    """A merge whose samples do not fit a split CTA's shared memory (made
    so with a small sample budget, or by 300 runs) searches them in place:
    still two launches, no round kernel, the plain version's order."""
    rng = np.random.default_rng(7 + k)
    K, _, W, S = _runs(rng, k, cap)
    flat = [_t(a.reshape(-1), cuda) for a in (K, W, S)]
    ix = torch.arange(K.size, dtype=torch.int32, device=cuda)
    if sample_bytes:
        monkeypatch.setattr(KHM.ops, "KWAY_SAMPLE_BYTES", sample_bytes)
    assert not KHM.ops.kway_geometry(k, cap)[-1]
    before = (KHM.kway_merge.launches, KHM.merge_round.launches)
    got = KHM.kway_merge(*flat, ix, k)
    torch.cuda.synchronize()
    assert KHM.kway_merge.launches == before[0] + 2
    assert KHM.merge_round.launches == before[1]
    for g, w in zip(got, KHM.kway_merge_plain(*flat, ix, k)):
        assert torch.equal(g, w)


def _scan_rows(rng, q_n, c_n, n_seg):
    """(Q, C) candidate rows of n_seg sorted segments at offsets, filled
    to a random width, the odd segments ending in KEY_EMPTY lanes (a
    budget cut), payloads distinct."""
    K = np.full((q_n, c_n), KEY_EMPTY, np.int32)
    W = np.zeros((q_n, c_n), np.int32)
    S = np.zeros((q_n, c_n), np.int32)
    off = np.zeros((q_n, n_seg + 1), np.int32)
    for q in range(q_n):
        sizes = rng.multinomial(int(rng.integers(0, c_n + 1)),
                                np.ones(n_seg) / n_seg)
        pos = 0
        for i, size in enumerate(sizes):
            K[q, pos:pos + size] = np.sort(rng.choice(2 * c_n, size,
                                                      replace=False))
            if size > 2 and i % 2:
                K[q, pos + size - 2:pos + size] = KEY_EMPTY
            pos += size
            off[q, i + 1] = pos
        S[q, :pos] = np.where(K[q, :pos] == KEY_EMPTY, 0,
                              rng.permutation(c_n * 4)[:pos])
        W[q, :pos] = np.where(K[q, :pos] == KEY_EMPTY, 0,
                              rng.choice([-1, 1], pos))
    V = (rng.permutation(q_n * c_n).reshape(q_n, c_n) + 1).astype(np.int32)
    return K, V, W, S, off


@pytest.mark.gpu
@pytest.mark.parametrize("n_seg", [2, 3, 91, 128])
@pytest.mark.parametrize("c_n", [512, 4096, 16_384])
def test_range_merge_kernel_matches_plain(cuda, c_n, n_seg):
    """The one-pass merge on all five lanes: one launch where a row is
    one tile (C = 512), a split and a merge launch for wider rows, and
    never the round kernel."""
    rng = np.random.default_rng(c_n + n_seg)
    lanes = [_t(a, cuda) for a in _scan_rows(rng, 8, c_n, n_seg)]
    for drop in (False, True):
        before = (KRM.range_merge.launches, KRM.merge_round.launches)
        got = KRM.range_merge(*lanes, drop)
        torch.cuda.synchronize()
        assert KRM.range_merge.launches == before[0] + (
            1 if c_n <= 512 else 2)
        assert KRM.merge_round.launches == before[1]
        want = KRM.range_merge_plain(*lanes, drop)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_seg", [3, 91])
def test_range_merge_in_place_split_matches_plain(cuda, monkeypatch, n_seg):
    """Rows whose samples miss a split CTA's shared memory (made so with
    a small sample budget) are ranked in place: still two launches."""
    rng = np.random.default_rng(7 + n_seg)
    lanes = [_t(a, cuda) for a in _scan_rows(rng, 4, 8192, n_seg)]
    monkeypatch.setattr(KRM.ops, "RANGE_SAMPLE_BYTES", 64)
    assert not KRM.ops.range_geometry(8192, n_seg)[4]
    before = KRM.range_merge.launches
    got = KRM.range_merge(*lanes, True)
    torch.cuda.synchronize()
    assert KRM.range_merge.launches == before + 2
    for g, w in zip(got, KRM.range_merge_plain(*lanes, True)):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_seg", [2, 3, 91])
def test_range_merge_rounds_kernel_matches_plain(cuda, n_seg):
    """The round kernel (the reference's contract) on every lane of every
    round, and its whole merge against the plain one-sort version."""
    rng = np.random.default_rng(n_seg)
    lanes = [_t(a, cuda) for a in _scan_rows(rng, 8, 512, n_seg)]
    got = KRM.ops.range_merge_rounds(*lanes, True)
    torch.cuda.synchronize()
    want = KRM.ops.range_merge_rounds(*lanes, True, KRM.merge_round_plain)
    for g, w, p in zip(got, want, KRM.range_merge_plain(*lanes, True)):
        assert torch.equal(g, w) and torch.equal(g, p)


# tolerances of the kernel against its plain version: both sum in f32 (in
# another order) and round once, so bf16 may differ by one ulp (2**-7
# relative) plus f32 noise, here a thousandth of the largest output
ATT_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-4),
           torch.bfloat16: dict(atol_of_max=1e-3, rtol=8e-3)}


def _att_tol(want, dtype):
    tol = dict(ATT_TOL[dtype])
    if "atol_of_max" in tol:
        tol["atol"] = tol.pop("atol_of_max") * float(want.abs().max())
    return tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,dh,length", [
    (g, d, 512) for g in (1, 2, 3, 4) for d in (16, 128, 256)]
    + [(3, 128, n) for n in (1, 511, 513, 20480)] + [(8, 64, 700)])
def test_lsm_attention_kernel_matches_plain(cuda, group, dh, length, dtype):
    """Ragged validity, one (batch, kv-head) row with no valid position."""
    gen = torch.Generator(cuda).manual_seed(group * 1000 + dh + length)
    b, kv = 2, 2
    h = group * kv
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, h, dh), (b, length, kv, dh),
                             (b, length, kv, dh)))
    valid = (torch.rand((b, kv, length), generator=gen, device=cuda)
             < 0.7).to(torch.int8)
    valid[1, 0] = 0
    before = KLA.decode_attention.launches
    got = KLA.decode_attention(q, k, v, valid, dh ** -0.5)
    torch.cuda.synchronize()
    assert KLA.decode_attention.launches == before + 1
    want = KLA.decode_attention_plain(q, k, v, valid, dh ** -0.5)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(),
                               **_att_tol(want.float(), dtype))
    assert not got[1, :group].any()
    # the kernel made to skip every 32nd position must fail that check
    skip = valid.clone()
    skip[:, :, ::32] = 0
    if int(skip.sum()) < int(valid.sum()):
        bad = KLA.decode_attention(q, k, v, skip, dh ** -0.5)
        assert not torch.allclose(bad.float(), want.float(),
                                  **_att_tol(want.float(), dtype))


def _fails(bad, want, dtype):
    return not torch.allclose(bad.float(), want.float(),
                              **_att_tol(want.float(), dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("case", ["short", "long"])
def test_lsm_decode_attention_kernel_matches_plain(cuda, case, group, dh,
                                                   dtype):
    """The tiered kernel reading [hot | selected blocks] in place against
    its plain version (gather, concatenate, bitmap). Every row it must not
    read is NaN: hot rows at or past hot_len, and every (block, kv head)
    that is not a selected `ok` block. short: hot_len 1 and W, n_blocks 0
    and 2 < topk; long: n_blocks > topk, so selection skips blocks."""
    gen = torch.Generator(cuda).manual_seed(group * 100 + dh)
    b, kv, w, nb, mu, topk = 2, 2, 128, 12, 64, 4
    h = group * kv

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, hk, hv = rnd(b, h, dh), rnd(b, w, kv, dh), rnd(b, w, kv, dh)
    bk, bv = rnd(b, nb, mu, kv, dh), rnd(b, nb, mu, kv, dh)
    summ = bk.float().mean(dim=2).to(dtype)
    hot_len, n_blocks = {"short": ([1, w], [0, 2]),
                         "long": ([w // 2 + 5, 37], [nb, topk + 3])}[case]
    hot_len = torch.tensor(hot_len, dtype=torch.int32, device=cuda)
    ids, ok = KLA.select_blocks(q, summ, torch.tensor(n_blocks,
                                                      device=cuda), topk)
    read = torch.zeros(b, nb, kv, dtype=torch.bool, device=cuda)
    for r in range(b):
        for x in range(kv):
            read[r, ids[r, x][ok[r, x]], x] = True
        hk[r, int(hot_len[r]):] = float("nan")
        hv[r, int(hot_len[r]):] = float("nan")
    gone = ~read[:, :, None, :, None].expand_as(bk)
    bk[gone] = float("nan")
    bv[gone] = float("nan")
    args = (q, hk, hv, hot_len, bk, bv, ids, ok, dh ** -0.5)
    before = KLA.decode_attention.launches
    before_tiered = KLA.lsm_decode_attention.launches
    got = KLA.lsm_decode_attention(*args)
    torch.cuda.synchronize()
    assert KLA.decode_attention.launches == before + 1
    want = KLA.lsm_decode_attention_plain(*args)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **_att_tol(want.float(), dtype))
    assert KLA.lsm_decode_attention.launches == before_tiered + 1
    # planted faults must fail the check: the plain version with every
    # 32nd position dropped, and (where a block is read) the kernel with
    # the first selected block marked not ok
    if hot_len.max() > 1 or ok.any():
        kk, vv, valid = KLA.tiered_inputs(hk, hv, hot_len, bk, bv, ids, ok)
        valid[:, :, ::32] = 0
        assert _fails(got, KLA.decode_attention_plain(q, kk, vv, valid,
                                                      dh ** -0.5), dtype)
    if ok[:, :, 0].any():
        ok2 = ok.clone()
        ok2[:, :, 0] = False
        bad = KLA.lsm_decode_attention(q, hk, hv, hot_len, bk, bv, ids, ok2,
                                       dh ** -0.5)
        assert _fails(bad, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,dh,length", [(3, 128, 8208), (1, 64, 700),
                                             (8, 256, 513), (4, 16, 33),
                                             (7, 128, 8208), (1, 64, 1500)])
def test_dense_lengths_kernel_matches_plain(cuda, group, dh, length, dtype):
    """The dense path: the kernel reads `lengths` itself (no bitmap);
    rows past a row's length are NaN and must not be read."""
    gen = torch.Generator(cuda).manual_seed(group + dh + length)
    b, kv = 2, 2
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, group * kv, dh), (b, length, kv, dh),
                             (b, length, kv, dh)))
    lens = torch.tensor([max(1, length // 3), length], dtype=torch.int32,
                        device=cuda)
    k[0, int(lens[0]):] = float("nan")
    v[0, int(lens[0]):] = float("nan")
    before = KLA.decode_attention.launches
    got = KLA.decode_attention_op(q, k, v, lens, dh ** -0.5)
    torch.cuda.synchronize()
    assert KLA.decode_attention.launches == before + 1
    valid = (torch.arange(length, device=cuda)[None, :] < lens[:, None])
    valid = valid[:, None, :].expand(b, kv, length).to(torch.int8)
    want = KLA.decode_attention_plain(q, k, v, valid.contiguous(),
                                      dh ** -0.5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **_att_tol(want.float(), dtype))
    # planted fault: the plain version with every 32nd position dropped
    valid = valid.clone()
    valid[:, :, ::32] = 0
    assert _fails(got, KLA.decode_attention_plain(q, k, v, valid,
                                                  dh ** -0.5), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "lsm"])
def test_lm_generate_on_card_matches_cpu(cuda, kind):
    """The smoke-size model through `generate` on the card (kernel) and on
    the CPU (plain version), f32: the same tokens, counters and caches."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import generate
    cfg = get_config("phi4-mini-3.8b").smoke()
    model = lm.init_params(cfg, 0, device="cpu")
    prompt = {"tokens": torch.randint(0, cfg.vocab, (2, 96),
                                      generator=torch.Generator().manual_seed(
                                          1))}
    toks, caches = generate(cfg, model, prompt, 64, kind)
    before = KLA.decode_attention.launches
    toks_c, caches_c = generate(cfg, model.to(cuda), prompt, 64, kind)
    assert KLA.decode_attention.launches - before == 63 * cfg.n_layers
    assert torch.equal(toks_c.cpu(), toks)
    for key, want in caches.items():
        if want.dtype == torch.int32:
            assert torch.equal(caches_c[key].cpu(), want)
        else:
            torch.testing.assert_close(caches_c[key].cpu(), want, atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "lsm"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "qwen3-moe-30b-a3b"])
def test_moe_decode_on_card_matches_cpu(cuda, arch, kind):
    """A smoke-size moe model, f32: one decode step from the same caches
    on the card (kernel, experts as batched products there) and on the
    CPU (plain versions) gives the same logits and caches; then
    `generate` gives the same tokens, counters and caches."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import generate, grow_dense, lsm_from_dense
    cfg = get_config(arch).smoke()
    model = lm.init_params(cfg, 3, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 96),
                           generator=torch.Generator().manual_seed(4))
    _, dense = lm.prefill_step(cfg, model, {"tokens": prompt})
    caches = (lsm_from_dense(cfg, dense, 160) if kind == "lsm"
              else grow_dense(cfg, dense, 160))
    on_card = {k: t.to(cuda) for k, t in caches.items()}
    tok = prompt[:, -1]
    lg, caches = lm.decode_step(cfg, model, tok, caches, kind)
    before = KLA.decode_attention.launches
    lg_c, on_card = lm.decode_step(cfg, card, tok.to(cuda), on_card, kind)
    torch.cuda.synchronize()
    assert KLA.decode_attention.launches - before == cfg.n_layers
    torch.testing.assert_close(lg_c.cpu(), lg, atol=1e-4, rtol=1e-4)
    for key, want in caches.items():
        torch.testing.assert_close(on_card[key].cpu(), want, atol=1e-4,
                                   rtol=1e-4)
    toks, caches = generate(cfg, model, {"tokens": prompt}, 48, kind)
    toks_c, caches_c = generate(cfg, card, {"tokens": prompt}, 48, kind)
    assert torch.equal(toks_c.cpu(), toks)
    for key, want in caches.items():
        torch.testing.assert_close(caches_c[key].cpu(), want, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.gpu
def test_hybrid_tiered_decode_on_card_matches_cpu(cuda):
    """Zamba2 at smoke size, f32: one tiered decode step from the same
    caches on the card (the kernel, once an application of the shared
    block, reading the shared stack in place) and on the CPU (the plain
    version) gives the same logits, ssm and conv states and shared
    caches within the port's cache tolerance (1e-4)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import lsm_from_dense
    cfg = get_config("zamba2-1.2b").smoke()
    model = lm.init_params(cfg, 5, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 96),
                           generator=torch.Generator().manual_seed(6))
    _, dense = lm.prefill_step(cfg, model, {"tokens": prompt})
    caches = lsm_from_dense(cfg, dense, 160)

    def to_card(tree):
        return {k: to_card(t) if isinstance(t, dict) else t.to(cuda)
                for k, t in tree.items()}

    def close(got, want):
        for k, w in want.items():
            if isinstance(w, dict):
                close(got[k], w)
            else:
                torch.testing.assert_close(got[k].cpu(), w, atol=1e-4,
                                           rtol=1e-4)

    on_card = to_card(caches)
    tok = prompt[:, -1]
    lg, caches = lm.decode_step(cfg, model, tok, caches, "lsm")
    before = KLA.lsm_decode_attention.launches
    lg_c, on_card = lm.decode_step(cfg, card, tok.to(cuda), on_card, "lsm")
    torch.cuda.synchronize()
    assert KLA.lsm_decode_attention.launches - before == lm.n_attention(cfg)
    close({"logits": lg_c}, {"logits": lg})
    close(on_card, caches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kind", [("whisper-tiny", "dense"),
                                       ("qwen2-vl-7b", "dense"),
                                       ("qwen2-vl-7b", "lsm")])
def test_encdec_and_vlm_decode_on_card_match_cpu(cuda, arch, kind):
    """Whisper and Qwen2-VL at smoke size, f32: one decode step from the
    same caches on the card (the kernel: a Whisper layer's self- and
    cross-attention, a Qwen2-VL layer's dense or tiered attention) and on
    the CPU (the plain version) gives the same logits and caches, then
    `generate` the same tokens."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import generate, grow_dense, lsm_from_dense
    cfg = get_config(arch).smoke()
    model = lm.init_params(cfg, 7, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    gen = torch.Generator().manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 96), generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                      generator=gen)
    else:
        batch["positions3"] = torch.arange(96).expand(3, 2, 96)
    _, dense = lm.prefill_step(cfg, model, batch)
    caches = (lsm_from_dense(cfg, dense, 160) if kind == "lsm"
              else grow_dense(cfg, dense, 160))
    on_card = {k: t.to(cuda) for k, t in caches.items()}
    tok = batch["tokens"][:, -1]
    lg, caches = lm.decode_step(cfg, model, tok, caches, kind)
    before = KLA.decode_attention.launches
    lg_c, on_card = lm.decode_step(cfg, card, tok.to(cuda), on_card, kind)
    torch.cuda.synchronize()
    per_layer = 2 if cfg.family == "encdec" else 1
    assert KLA.decode_attention.launches - before == per_layer * cfg.n_layers
    torch.testing.assert_close(lg_c.cpu(), lg, atol=1e-4, rtol=1e-4)
    for key, want in caches.items():
        torch.testing.assert_close(on_card[key].cpu(), want, atol=1e-4,
                                   rtol=1e-4)
    card_batch = {k: t.to(cuda) for k, t in batch.items()}
    toks, _ = generate(cfg, model, batch, 48, kind)
    toks_c, _ = generate(cfg, card, card_batch, 48, kind)
    assert torch.equal(toks_c.cpu(), toks)


@pytest.mark.gpu
@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_selection_decode_on_card_matches_ungrouped(cuda, groups):
    """`lsm_dp_groups` G on the card: one tiered decode step of the
    DeepSeek smoke model (topk 2, more sealed blocks than that), f32,
    launches the kernel once a layer with all G * topk candidates and
    gives the ungrouped step's logits within 1e-5, and the CPU's grouped
    step's within the card tests' 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving import lsm_from_dense
    cfg = dataclasses.replace(get_config("deepseek-7b").smoke(), lsm_topk=2)
    grouped = dataclasses.replace(cfg, lsm_dp_groups=groups)
    model = lm.init_params(cfg, 0, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 97),
                           generator=torch.Generator().manual_seed(2))
    _, dense = lm.prefill_step(cfg, model, {"tokens": prompt[:, :96]})
    caches = lsm_from_dense(cfg, dense, 112)
    assert (caches["n_blocks"] > cfg.lsm_topk).all()
    want_cpu, _ = lm.decode_step(grouped, model, prompt[:, 96],
                                 {k: t.clone() for k, t in caches.items()},
                                 "lsm")
    model = model.to(cuda)
    tok = prompt[:, 96].to(cuda)
    one, _ = lm.decode_step(cfg, model, tok,
                            {k: t.to(cuda) for k, t in caches.items()}, "lsm")
    before = KLA.lsm_decode_attention.launches
    got, _ = lm.decode_step(grouped, model, tok,
                            {k: t.to(cuda) for k, t in caches.items()}, "lsm")
    torch.cuda.synchronize()
    assert KLA.lsm_decode_attention.launches - before == cfg.n_layers
    torch.testing.assert_close(got, one, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got.cpu(), want_cpu, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-7b", "granite-moe-1b-a400m"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One `make_train_step` of a smoke model, f32 with TF32 off, on the
    card and on the CPU (plain PyTorch) from the same weights: loss, aux
    and grad norm within 1e-5 relative; every parameter's gradient, from
    `value_and_grad` and from the step's first AdamW moment (from zero
    moments mu = (1 - b1) * clip scale * gradient), within rtol 1e-4 and
    atol 1e-6 times the leaf's largest |gradient| where that exceeds 1,
    the CPU parity tests' rule; every updated parameter within
    2 * lr + 1e-6 (Adam's first step turns each gradient entry into about
    +-1, so an entry that is nearly zero may flip its sign and move its
    parameter by up to 2 * lr; from equal weights no gradient can break
    that bound, which only catches a missing or non-finite update); the
    parameters stay on the card."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models import lm
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.train_step import value_and_grad
    cfg = get_config(arch).smoke()
    host = lm.init_params(cfg, 1, device="cpu")
    card = copy.deepcopy(host).to(cuda)
    batch = next(TokenStream(cfg.vocab, 4, 32, seed=3))
    step = make_train_step(cfg, base_lr=1e-3, warmup=2)

    def grads_close(got, want, what):
        assert set(got) == set(want)
        for n, w in want.items():
            torch.testing.assert_close(
                got[n].cpu(), w, rtol=1e-4,
                atol=1e-6 * max(1.0, float(w.abs().max())),
                msg=f"{what} {n}")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gc = value_and_grad(cfg, card, batch)[3]
        card, sc, mc = step(card, adamw_init(card), batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gh = value_and_grad(cfg, host, batch)[3]
    host, sh, mh = step(host, adamw_init(host), batch)
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        assert mc[k].device.type == "cuda"
        assert abs(float(mc[k]) - float(mh[k])) <= 1e-5 * abs(float(mh[k]))
    grads_close(gc, gh, "value_and_grad")
    scale = 0.1 * min(1.0, 1.0 / float(mh["grad_norm"]))
    grads_close({n: m / scale for n, m in sc.mu.items()},
                {n: m / scale for n, m in sh.mu.items()}, "step")
    bound = 2 * float(mh["lr"]) + 1e-6
    for (n, a), (_, b) in zip(card.named_parameters(),
                              host.named_parameters()):
        assert a.device.type == "cuda"
        assert float((a.cpu() - b).abs().max()) <= bound, n


@pytest.mark.gpu
@pytest.mark.parametrize("adaptive", [False, True])
def test_durable_engine_on_card_restores_on_card_and_cpu(cuda, tmp_path,
                                                         adaptive):
    """A durable engine on the card at the reference harness's tiny
    geometry writes, snapshots and writes a WAL tail past it; the
    directory restores on the card and with ``device="cpu"``: bitwise-
    equal state leaves, the same answers, equal to the engine that wrote
    it, and the card's restore launches the engine's kernels."""
    from repro_torch import convert
    from repro_torch.core.params import SLSMParams, TuningPolicy
    from repro_torch.engine import SLSM
    from repro_torch.engine import wal as WAL
    from repro_torch.engine.tape import TapeChunk
    tuning = (TuningPolicy(mode="adaptive", interval=64) if adaptive
              else TuningPolicy())
    p = SLSMParams(R=2, Rn=32, eps=1e-2, D=2, m=1.0, mu=16, max_levels=3,
                   max_range=2048, merge_budget=1, tuning=tuning)
    eng = SLSM(p, device=cuda, durability=WAL.Durability(tmp_path,
                                                         fsync=False))
    rng = np.random.default_rng(4)
    probe = np.arange(0, 4000, 3, dtype=np.int32)

    def writes(n_calls):
        for i in range(n_calls):
            ks = rng.integers(0, 4000, 48).astype(np.int32)
            if i % 4 == 3:
                eng.delete(ks[:16])
            else:
                eng.insert(ks, rng.integers(0, 1 << 20, 48).astype(np.int32))

    writes(8)
    for _ in range(12 if adaptive else 0):
        eng.lookup_many(probe)
    writes(2)
    snap = eng.snapshot()
    writes(4)
    ks = rng.integers(0, 4000, 30).astype(np.int32)
    eng.run_tape([TapeChunk("write", ks, ks * 5),
                  TapeChunk("lookup", ks, ks)])
    eng.durability.close()
    assert snap.exists() and eng.n_levels >= 1

    def answers(t):
        v, f = t.lookup_many(probe)
        k, vv, c, tr = t.range_many([(0, 4000), (123, 456), (1000, 3500)])
        return [v, f, k, vv, c, tr]

    launches = {f: f.launches for f in (KBP.bloom_probe_levels,
                                        KFL.fence_lookup_many,
                                        KRM.range_merge)}
    on_card = SLSM.restore(str(tmp_path), device=cuda)
    on_cpu = SLSM.restore(str(tmp_path), device="cpu")
    assert on_card.stats["replayed_records"] == \
        on_cpu.stats["replayed_records"] >= 5
    for g, w in zip(convert.state_to_leaves(on_card.state),
                    convert.state_to_leaves(on_cpu.state)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = answers(on_card)
    for a, b, c in zip(got, answers(on_cpu), answers(eng)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert all(f.launches > n for f, n in launches.items())
    if adaptive:
        assert eng.stats["retunes"] >= 1
        assert on_card.tuner.active == on_cpu.tuner.active
        assert on_card.runs == on_cpu.runs


# --------------------------------------------------------------------------
# the sharded engine: the engine kernels with a leading shard dimension
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("q_n", [1, 1000])
def test_bloom_probe_shards_kernel_matches_plain_and_single_launches(cuda,
                                                                     q_n):
    """(S, D, W) stacks of three levels (odd D: a run group never spans
    two shards) and (S, Q) keys in one launch, against the plain version
    and against one single-tree launch a shard."""
    rng = np.random.default_rng(30)
    n_shards, geoms = 3, [(3, 60, 40, 6, 1000), (5, 200, 64, 10, None),
                          (1, 30, 8, 13, 250)]
    stacks, keys = [], []
    for d_n, n, words, k, bits in geoms:
        per = [_level(rng, d_n, n, words, k, bits, cuda)
               for _ in range(n_shards)]
        stacks.append((torch.stack([b for b, _ in per]), k, bits))
        keys.append(np.stack([m for _, m in per]))
    q = torch.stack([_t(_keys(rng, np.concatenate(
        [m[s].reshape(-1) for m in keys]), q_n), cuda)
        for s in range(n_shards)])
    got = _levels_equal(stacks, q)
    for out, (b, k, bits) in zip(got, stacks):
        assert out.shape == (n_shards, b.shape[1], q_n)
        for s in range(n_shards):
            assert torch.equal(out[s], KBP.bloom_probe_many(b[s], q[s], k,
                                                            bits))


@pytest.mark.gpu
@pytest.mark.parametrize("fence_bytes", [None, 64])
def test_fence_lookup_shards_kernel_matches_plain_and_single_launches(
        cuda, monkeypatch, fence_bytes):
    """(S, D) runs searching their own shard's (S, Q) query row in one
    launch, fences staged whole or every G-th."""
    if fence_bytes:
        monkeypatch.setattr(KFL.ops, "FENCE_SMEM_BYTES", fence_bytes)
    rng = np.random.default_rng(31)
    n_shards, d_n, cap, mu = 4, 5, 4096, 16
    runs = [_sorted_runs(rng, d_n, cap, 1 << 20) for _ in range(n_shards)]
    keys = np.stack([k for k, _ in runs])
    counts = np.stack([c for _, c in runs])
    fences = np.ascontiguousarray(keys[:, :, ::mu])
    qs = np.stack([_keys(rng, keys[s][keys[s] != KEY_EMPTY], 777)
                   for s in range(n_shards)])
    args = [_t(a, cuda) for a in (qs, fences, keys, counts)]
    before = KFL.fence_lookup_many.launches
    got = KFL.fence_lookup_many(*args, mu)
    torch.cuda.synchronize()
    assert KFL.fence_lookup_many.launches == before + 1
    assert got.shape == (n_shards, d_n, 777)
    assert torch.equal(got, KFL.fence_lookup_plain(*args, mu))
    assert (got >= 0).any()
    for s in range(n_shards):
        assert torch.equal(got[s], KFL.fence_lookup_many(
            *(a[s] for a in args), mu))


@pytest.mark.gpu
@pytest.mark.parametrize("k,sample_bytes", [(2, None), (20, None),
                                            (20, 64)])
def test_kway_merge_batch_kernel_matches_plain_and_single_launches(
        cuda, monkeypatch, k, sample_bytes):
    """A batch of 3 merges (a masked step of three shards) in the same
    two launches as one merge, samples in shared memory or in place."""
    if sample_bytes:
        monkeypatch.setattr(KHM.ops, "KWAY_SAMPLE_BYTES", sample_bytes)
    rng = np.random.default_rng(32 + k)
    batch = [_runs(rng, k, 3000) for _ in range(3)]
    lanes = [_t(np.stack([b[i].reshape(-1) for b in batch]), cuda)
             for i in (0, 2, 3)]
    ix = torch.arange(k * 3000, dtype=torch.int32,
                      device=cuda).expand(3, -1).contiguous()
    before = KHM.kway_merge.launches
    got = KHM.kway_merge(*lanes, ix, k)
    torch.cuda.synchronize()
    assert KHM.kway_merge.launches == before + 2
    want = KHM.kway_merge_plain(*lanes, ix, k)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for b in range(3):
        one = KHM.kway_merge(*(a[b].contiguous() for a in lanes), ix[b], k)
        for g, w in zip(got, one):
            assert torch.equal(g[b], w)
    for drop in (False, True):
        full = [_t(np.stack([b[i] for b in batch]), cuda) for i in range(4)]
        got = KHM.heap_merge(*full, drop)
        want = KHM.heap_merge(*(a.cpu() for a in full), drop)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _sharded_pair(cuda, n_shards, budget=0):
    from repro_torch.core.params import SLSMParams
    from repro_torch.engine import ShardedSLSM
    p = SLSMParams(R=2, Rn=8, eps=0.02, D=2, m=1.0, mu=4, max_levels=3,
                   max_range=512, cand_factor=16, merge_budget=budget)
    return (ShardedSLSM(p, n_shards, device=cuda),
            ShardedSLSM(p, n_shards, device="cpu"))


def _state_equal(a, b):
    from repro_torch import convert
    for g, w in zip(convert.state_to_leaves(a.state),
                    convert.state_to_leaves(b.state)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards,budget", [(3, 0), (4, 1)])
def test_sharded_engine_on_card_matches_cpu(cuda, n_shards, budget):
    """A small fleet on the card and on the CPU through one stream of
    inserts, deletes, reads and tape windows: the stacked state bitwise
    equal after every call, every answer equal and oracle-exact."""
    from repro_torch.core.oracle import DictOracle
    card, cpu = _sharded_pair(cuda, n_shards, budget)
    oracle = DictOracle()
    rng = np.random.default_rng(40 + n_shards)
    space = 90 * n_shards
    for step in range(40):
        ks = rng.integers(0, space, int(rng.integers(1, 60))).astype(np.int32)
        vs = rng.integers(I32.min, I32.max, ks.size, dtype=np.int64).astype(
            np.int32)
        for t in (card, cpu, oracle):
            t.insert(ks, vs)
        dels = rng.integers(0, space, 6).astype(np.int32)
        for t in (card, cpu, oracle):
            t.delete(dels)
        _state_equal(card, cpu)
        if step % 5 == 4:
            qs = np.arange(-3, space + 3, dtype=np.int32)
            v, f = card.lookup_many(qs)
            vo, fo = oracle.lookup(qs)
            np.testing.assert_array_equal(f, fo)
            np.testing.assert_array_equal(v[f], vo[fo])
            lo = rng.integers(0, space, 5)
            wins = np.stack([lo, lo + 60], 1).astype(np.int32)
            for a, b in zip(card.range_many(wins), cpu.range_many(wins)):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(card.aggregate_many(wins),
                            cpu.aggregate_many(wins)):
                np.testing.assert_array_equal(a, b)
            window = [("write", ks[:8], vs[:8], None),
                      ("lookup", qs[:8], qs[:8], None),
                      ("range", lo[:2].astype(np.int32),
                       (lo[:2] + 40).astype(np.int32), None)]
            got, want = card.run_tape(window), cpu.run_tape(window)
            oracle.insert(ks[:8], vs[:8])
            for g, w in zip(got, want):
                if isinstance(w, int):
                    assert g == w
                else:
                    for a, b in zip(g, w):
                        np.testing.assert_array_equal(a, b)
            _state_equal(card, cpu)
    assert card.stats["spills"] > 0
    for name in ("seals", "flushes", "spills", "compactions",
                 "rows_merged_in", "rows_merged_out", "writes"):
        assert card.stats[name] == cpu.stats[name], name


@pytest.mark.gpu
def test_sharded_launch_counts_of_a_lookup_batch_and_a_masked_spill(cuda):
    """One lookup batch: one bloom_probe launch for every level of every
    shard and at most one fence_lookup launch a level. One masked spill
    of two or more shards: two heap_merge launches."""
    from repro_torch.engine import scheduler as SCH
    card, cpu = _sharded_pair(cuda, 4)
    rng = np.random.default_rng(44)
    p = card.p
    for _ in range(200):
        ks = rng.integers(0, 360, 10).astype(np.int32)
        card.insert(ks, ks)
        cpu.insert(ks, ks)
        n0, n1 = (lv.n_runs.cpu().numpy() for lv in card.state.levels[:2])
        mask = (n0 >= p.disk_runs_merged) & (n1 < p.D)
        if mask.sum() >= 2:
            break
    assert mask.sum() >= 2
    before = KHM.kway_merge.launches
    card._apply_step(SCH.SPILL, 0, mask)
    torch.cuda.synchronize()
    assert KHM.kway_merge.launches == before + 2
    cpu._apply_step(SCH.SPILL, 0, mask)
    _state_equal(card, cpu)
    qs = np.arange(0, 360, dtype=np.int32)
    b0, f0 = KBP.bloom_probe_levels.launches, KFL.fence_lookup_many.launches
    got = card.lookup(qs)
    assert KBP.bloom_probe_levels.launches == b0 + 1
    assert KFL.fence_lookup_many.launches - f0 <= p.max_levels
    for a, b in zip(got, cpu.lookup(qs)):
        np.testing.assert_array_equal(a, b)
    r0 = KRM.range_merge.launches
    card.range_many([(0, 100), (50, 300)])
    assert KRM.range_merge.launches == r0 + 1


def _repl_run(base, device, sharded=False):
    """One replicated stream at the reference harness's tiny geometry:
    a quorum leader on `device`, one follower from `add_follower` (on the
    leader's device), writes and a `Server` window, then `converge`.
    Returns the follower's `wal.log`, the window's ticket results and
    the leader's and follower's answers."""
    from repro_torch.core.params import SLSMParams
    from repro_torch.engine import SLSM, ShardedSLSM
    from repro_torch.engine import replication as R
    from repro_torch.engine import wal as WAL
    from repro_torch.serve import Server
    p = SLSMParams(R=2, Rn=32, eps=1e-2, D=2, m=1.0, mu=16, max_levels=3,
                   max_range=2048, merge_budget=1)
    dur = WAL.Durability(base / "leader", fsync=False,
                         snapshot_every_bytes=1 << 30)
    drv = (ShardedSLSM(p, 2, device=device, durability=dur) if sharded
           else SLSM(p, device=device, durability=dur))
    leader = R.Leader(drv, ack_mode="quorum", quorum=1,
                      clock=lambda: 100.0)
    rng = np.random.default_rng(23)
    ops = []
    for i in range(10):
        ks = rng.integers(0, 4000, 48).astype(np.int32)
        ops.append(("delete", ks[:16], None) if i % 4 == 3
                   else ("insert", ks, rng.integers(0, 1 << 20, 48)
                         .astype(np.int32)))
    for kind, ks, vs in ops[:4]:
        drv.insert(ks, vs) if kind == "insert" else drv.delete(ks)
    fol = leader.add_follower(base / "fol")
    assert fol.drv.device.type == torch.device(device).type
    srv = Server(drv, role="leader")
    tickets = [srv.submit("c", kind, ks, vs) for kind, ks, vs in ops[4:]]
    probe = np.arange(0, 4000, 7, dtype=np.int32)
    tickets.append(srv.submit("c", "lookup", probe))
    tickets.append(srv.submit("c", "range", np.int32([0, 900]),
                              np.int32([500, 3000])))
    srv.pump(force=True)
    fol.pump()
    srv.pump()
    assert all(t.done and t.error is None for t in tickets)
    R.converge(leader, fol)
    wins = [(0, 4000), (123, 456), (1000, 3500)]
    answers = [(e.lookup_many(probe), e.range_many(wins),
                e.aggregate_many(wins)) for e in (drv, fol.drv)]
    return ((base / "fol" / "wal.log").read_bytes(),
            [t.result for t in tickets], answers,
            (base / "leader" / "wal.log").read_bytes())


@pytest.mark.gpu
@pytest.mark.parametrize("sharded", [False, True], ids=["single", "sharded"])
def test_replication_and_server_on_card_match_cpu(cuda, tmp_path, sharded):
    """A quorum leader and its follower on the card, fed writes and a
    `Server` window, converge: the follower's WAL is the leader's and
    byte for byte the follower WAL of the same stream on the CPU; the
    window's results and every answer of leader and follower equal the
    CPU run's."""
    wal, results, answers, leader_wal = _repl_run(tmp_path / "card", cuda,
                                                  sharded)
    cpu_wal, cpu_results, cpu_answers, _ = _repl_run(tmp_path / "cpu", "cpu",
                                                     sharded)
    assert wal == leader_wal == cpu_wal
    for got, want in zip(results, cpu_results):
        if want is None:
            assert got is None
        else:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    for side in (answers[0], answers[1]):
        for got, want in zip(side, cpu_answers[0]):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# distributed/: the mesh branches on a one-rank NCCL group
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1) (data, model) mesh over a one-rank NCCL group (NCCL puts
    no two ranks on one card), or a skip; the group closes after the
    module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_group, make_host_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_process_group("cuda", rank=0, world_size=1,
                       init_method=f"tcp://127.0.0.1:{port}")
    yield make_host_mesh(1, 1, device="cuda")
    dist.destroy_process_group()


class _count:
    """Counts the calls of `owner.name` under the context."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, 0

    def __enter__(self):
        real = self.real = getattr(self.owner, self.name)

        def call(*a, **kw):
            self.calls += 1
            return real(*a, **kw)
        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


@pytest.mark.gpu
def test_moe_mesh_branch_on_card_matches_single_device(nccl_mesh):
    """qwen3-moe smoke on the card: `logits_full` with DTensor parameters
    through `moe_ffn`'s mesh branch (every layer) against the
    single-device path, max abs < 2e-4."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import runtime as RT
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    model = lm.init_params(cfg, 0, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 32),
                                     generator=torch.Generator().manual_seed(
                                         1)).cuda()}
    want = lm.logits_full(cfg, model, batch)
    SH.distribute_model(model, nccl_mesh,
                        SH.param_pspecs(cfg, model, nccl_mesh))
    dbatch = SH.distribute(batch, nccl_mesh,
                           SH.batch_pspecs(cfg, batch, nccl_mesh))
    RT.set_axes(("data",), "model", nccl_mesh)
    try:
        with _count(MOE, "_moe_mesh") as branch:
            got = lm.logits_full(cfg, model, dbatch).full_tensor()
    finally:
        RT.clear()
    assert branch.calls == cfg.n_layers
    assert float((got - want).abs().max()) < 2e-4


@pytest.mark.gpu
def test_lsm_stats_branch_on_card_matches_single_device(nccl_mesh):
    """deepseek-7b smoke with kv 2, heads 4, b 1, a 128-token prompt: one
    tiered decode step through the sharded-stats branch (every layer)
    against the single-device branch (the kernel), < 2e-3."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.distributed import runtime as RT
    from repro_torch.models import attention as ATT
    from repro_torch.models import lm
    from repro_torch.serving import lsm_from_dense
    cfg = replace(get_config("deepseek-7b").smoke(), n_kv=2, n_heads=4)
    model = lm.init_params(cfg, 0, device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 129),
                         generator=torch.Generator().manual_seed(0)).cuda()
    _, dense = lm.prefill_step(cfg, model, {"tokens": toks[:, :128]})
    caches = [lsm_from_dense(cfg, dense, 144) for _ in range(2)]
    n0 = KLA.decode_attention.launches
    want, _ = lm.decode_step(cfg, model, toks[:, 128], caches[0], kind="lsm")
    assert KLA.decode_attention.launches - n0 == cfg.n_layers
    RT.set_axes(("data",), "model", nccl_mesh)
    try:
        with _count(ATT, "_lsm_stats") as branch:
            got, _ = lm.decode_step(cfg, model, toks[:, 128], caches[1],
                                    kind="lsm")
    finally:
        RT.clear()
    assert branch.calls == cfg.n_layers
    assert float((got - want).abs().max()) < 2e-3


def _decode_inputs(device, b=2, h=8, kv=2, dh=64, length=300):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=g).to(device, torch.bfloat16)
               for s in ((b, h, dh), (b, length, kv, dh),
                         (b, length, kv, dh)))
    lens = torch.tensor([length // 2, length], dtype=torch.int32,
                        device=device)
    return q, k, v, lens


@pytest.mark.gpu
def test_real_cuda_tensors_never_take_the_shape_only_path(cuda):
    """Inside a cost counter, real CUDA inputs launch the kernel (one
    launch each entry point) and record no shape-only kernel cost; the
    output is the plain version's, within one bf16 ulp."""
    from repro_torch.launch import cost
    q, k, v, lens = _decode_inputs(cuda)
    n0 = KLA.decode_attention.launches
    with cost.CostCounter() as c:
        got = KLA.decode_attention_op(q, k, v, lens, 0.125)
        torch.cuda.synchronize()
    assert KLA.decode_attention.launches == n0 + 1
    assert c.kernels == {}
    want = KLA.decode_attention_op(q.cpu(), k.cpu(), v.cpu(), lens.cpu(),
                                   0.125)
    assert torch.allclose(got.cpu().float(), want.float(), rtol=8e-3,
                          atol=1e-3 * float(want.float().abs().max()))


@pytest.mark.gpu
def test_dtensor_inputs_launch_the_kernel_per_rank(nccl_mesh):
    """DTensor inputs on the (1, 1) NCCL mesh: the entry point runs the
    kernel on each rank's shards (one launch) and gives the plain
    tensors' result, laid out as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    q, k, v, lens = _decode_inputs(torch.device("cuda"))
    want = KLA.decode_attention_op(q, k, v, lens, 0.125)
    place = [Shard(0), Replicate()]
    dq, dk, dv, dl = (DTensor.from_local(t, nccl_mesh, place,
                                         run_check=False)
                      for t in (q, k, v, lens))
    n0 = KLA.decode_attention.launches
    got = KLA.decode_attention_op(dq, dk, dv, dl, 0.125)
    assert KLA.decode_attention.launches == n0 + 1
    assert isinstance(got, DTensor) and tuple(got.placements) == tuple(place)
    assert torch.equal(got.to_local(), want)
