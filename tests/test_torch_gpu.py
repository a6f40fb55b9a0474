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


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2, 4])
def test_fence_lookup_kernel_matches_plain(cuda, stride):
    """Stride views over 1000-slot runs leave partial last pages."""
    rng = np.random.default_rng(stride)
    keys, counts = _sorted_runs(rng, 5, 1000, 1 << 20)
    fences = np.ascontiguousarray(keys[:, ::8][:, ::stride])
    qs = np.concatenate([keys[0, :1000], rng.integers(-2 ** 19, 2 ** 19,
                                                      1000)]).astype(np.int32)
    args = [_t(a, cuda) for a in (qs, fences, keys, counts)]
    got = KFL.fence_lookup_many(*args, 8 * stride)
    torch.cuda.synchronize()
    assert torch.equal(got, KFL.fence_lookup_plain(*args, 8 * stride))
    assert (got[0, :1000] >= 0).all()


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
@pytest.mark.parametrize("n_seg", [2, 3, 91])
def test_range_merge_kernel_matches_plain(cuda, n_seg):
    rng = np.random.default_rng(n_seg)
    q_n, c_n = 8, 512
    K = np.full((q_n, c_n), KEY_EMPTY, np.int32)
    W = np.zeros((q_n, c_n), np.int32)
    S = np.zeros((q_n, c_n), np.int32)
    off = np.zeros((q_n, n_seg + 1), np.int32)
    for q in range(q_n):
        sizes = rng.multinomial(int(rng.integers(0, c_n + 1)),
                                np.ones(n_seg) / n_seg)
        pos = 0
        for i, size in enumerate(sizes):
            K[q, pos:pos + size] = np.sort(rng.choice(1000, size,
                                                      replace=False))
            pos += size
            off[q, i + 1] = pos
        S[q, :pos] = rng.permutation(c_n * 4)[:pos]
        W[q, :pos] = rng.choice([-1, 1], pos)
    V = rng.integers(I32.min, I32.max, (q_n, c_n)).astype(np.int32)
    got = KRM.range_merge(*(_t(a, cuda) for a in (K, V, W, S, off)), True)
    torch.cuda.synchronize()
    want = KRM.range_merge(*(_t(a) for a in (K, V, W, S, off)), True)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
