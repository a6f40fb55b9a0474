// heap_merge: the k-way run merge of HeapMerge (paper 2.5).
//
// Replaces repro/kernels/heap_merge/heap_merge.py `_merge_kernel`
// (`merge_two_pallas`), which merged one pair of runs per launch, the
// k-way merge being a log2(k) tournament of such launches driven by the
// host. Lanes are (key, weight, seq, source-index); the payload never
// enters the merge. Two entry points:
//
//  * `heap_merge_round_launch` — one tournament round (every pair of
//    the round in one launch). One thread per output element t of pair
//    p: a merge-path binary search on the diagonal finds how many of its
//    first t outputs come from the first run. Ties on (key, seq) go to
//    the second run, as in the TPU kernel. Each round reads and writes
//    every lane again.
//  * `heap_merge_kway_launch` — the whole merge of k runs of `cap` lanes
//    in two launches, each lane read once and written once. The
//    tournament's order is a stable sort by (key, seq) with ties to the
//    higher run, then by position: the total order (key, seq, -run,
//    pos). (1) `kway_split_kernel`: every S-th lane of every run is a
//    sample; every CTA copies all samples into shared memory where they
//    fit (else it reads them in place), and one warp per sample counts,
//    in every run, the samples that precede it (a binary search over
//    the samples), which gives its rank among the samples. Every G-th sample in that order bounds a tile and writes
//    its counts. (2) `kway_merge_kernel`: one CTA per tile first turns
//    its two boundaries' sample counts into lane counts (a search of S
//    lanes per run, a thread each), then loads its k sub-ranges (fewer
//    than S * (G + k) lanes in all) into shared memory as 16-byte
//    records, merges them there in log2(k) rounds of pairwise merge-path
//    merges (`slsm::merge_in_shared`: each thread an equal run of
//    outputs, one diagonal search, then a sequential merge), and writes
//    the tile once at its output rank.
//
//  Both kernels take a batch of B independent merges of one shape (grid
//  y): the sharded engine's masked step merges every masked shard's runs
//  in these two launches, as the reference's kernel runs under
//  `jax.vmap`. One merge is the B = 1 case.
//
// Bound: bytes — 16 bytes read and 16 written per lane. The k-way form
// adds the samples (every split CTA copies all k * cap / S of them from
// L2 into shared memory where they fit), log2(cap / S) probes per
// (sample, run) pair, log2(S) device-memory probes per (boundary, run)
// pair, and the split table (k ints a tile). Both kernels are bound by
// latency — dependent searches and round barriers — not by those bytes.
#include "common.cuh"

namespace {

__global__ void merge_round_kernel(
    const int32_t* __restrict__ k, const int32_t* __restrict__ w,
    const int32_t* __restrict__ s, const int32_t* __restrict__ ix,
    const int64_t* __restrict__ pairs, int32_t* __restrict__ ok,
    int32_t* __restrict__ ow, int32_t* __restrict__ os,
    int32_t* __restrict__ oix) {
  const int64_t p = blockIdx.y;
  const int64_t lo = pairs[3 * p], mid = pairs[3 * p + 1],
                hi = pairs[3 * p + 2];
  const int64_t n = mid - lo, m = hi - mid;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (t >= n + m) return;
  const int32_t *ak = k + lo, *as = s + lo, *bk = k + mid, *bs = s + mid;
  const int64_t i = slsm::merge_path(ak, as, n, bk, bs, m, t);
  const int64_t j = t - i;
  const int64_t src = slsm::take_a(ak, as, n, bk, bs, m, i, j) ? lo + i
                                                               : mid + j;
  ok[lo + t] = k[src];
  ow[lo + t] = w[src];
  os[lo + t] = s[src];
  oix[lo + t] = ix[src];
}

constexpr int kSplitThreads = 1024;
constexpr int kBatch = 8;                 // loads a thread keeps in flight

// Row pitch of a run's samples in shared memory: one more than a
// multiple of 32, so that lanes probing the same index of different
// runs hit different banks.
__host__ __device__ __forceinline__ int sample_pitch(int per_run) {
  return (per_run + 31) / 32 * 32 + 1;
}

// Lanes of run rr that precede boundary sample x (run r, lane i) in
// (key, seq, -run, pos) order, given c samples of rr precede it: they
// lie in [(c - 1) * S + 1, min(c * S, cap)].
__device__ __forceinline__ int lanes_before(
    const int32_t* k, const int32_t* s, int cap, int step, int r, int i,
    int32_t xk, int32_t xs, int rr, int c) {
  if (rr == r) return i;
  if (c == 0) return 0;
  const int lo = (c - 1) * step + 1;
  const int hi = c * step < cap ? c * step : cap;
  const int64_t off = static_cast<int64_t>(rr) * cap + lo;
  return lo + slsm::rank_in(k + off, s + off, hi - lo, xk, xs, rr > r);
}

// Samples are every S-th lane of every run. With kShared a CTA first
// copies all of them into shared memory (keys and seqs apart, a padded
// row per run); without, they are read in place (every S-th lane of the
// runs, from L2), for merges whose samples do not fit. Then one warp per
// sample (run r, lane i = m * S), a lane per run r' (32 runs at a time),
// counts the samples of r' that precede it in (key, seq, -run, pos)
// order — a binary search over the samples — and their sum is its rank
// among the samples. A sample whose rank is a multiple of G bounds a
// tile: it counts again and writes its counts as row rank / G of
// `split`, and itself (q) as who[rank / G]. The merge kernel turns them
// into lane counts.
template <bool kShared>
__global__ void __launch_bounds__(kSplitThreads)
kway_split_kernel(const int32_t* __restrict__ k, const int32_t* __restrict__ s,
                  int32_t* __restrict__ split, int32_t* __restrict__ who,
                  int n_runs, int cap, int step, int per_run, int group,
                  int tiles) {
  extern __shared__ int32_t sk[];          // (n_runs, pitch) keys, seqs
  {                                        // merge blockIdx.y of the batch
    const int64_t b = blockIdx.y;
    k += b * n_runs * cap;
    s += b * n_runs * cap;
    split += b * tiles * n_runs;
    who += b * tiles;
  }
  const int pitch = sample_pitch(per_run);
  int32_t* ss = sk + n_runs * pitch;
  const int n_samp = n_runs * per_run;
  if constexpr (kShared) {
    for (int q0 = threadIdx.x; q0 < n_samp; q0 += kBatch * blockDim.x) {
      int32_t vk[kBatch], vs[kBatch];      // kBatch loads in flight
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * blockDim.x;
        if (q < n_samp) {
          const int64_t at = static_cast<int64_t>(q / per_run) * cap
                             + static_cast<int64_t>(q % per_run) * step;
          vk[u] = k[at];
          vs[u] = s[at];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = q0 + u * blockDim.x;
        if (q < n_samp) {
          const int at = q / per_run * pitch + q % per_run;
          sk[at] = vk[u];
          ss[at] = vs[u];
        }
      }
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int q = blockIdx.x * warps + (threadIdx.x >> 5); q < n_samp;
       q += gridDim.x * warps) {
    const int r = q / per_run, m = q % per_run;
    int32_t xk, xs;
    if constexpr (kShared) {
      xk = sk[r * pitch + m];
      xs = ss[r * pitch + m];
    } else {
      const int64_t at = static_cast<int64_t>(r) * cap
                         + static_cast<int64_t>(m) * step;
      xk = k[at];
      xs = s[at];
    }
    // samples of run rr before this one
    auto count = [&](int rr) {
      if (rr == r) return m;
      if constexpr (kShared)
        return slsm::rank_in(sk + rr * pitch, ss + rr * pitch, per_run, xk,
                             xs, rr > r);
      const int64_t at = static_cast<int64_t>(rr) * cap;
      return slsm::rank_in(k + at, s + at, per_run, xk, xs, rr > r, step);
    };
    int srank = 0;
    for (int rr = lane; rr < n_runs; rr += 32) srank += count(rr);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      srank += __shfl_xor_sync(0xffffffffu, srank, o);
    if (srank % group) continue;
    const int64_t row = srank / group;
    for (int rr = lane; rr < n_runs; rr += 32)
      split[row * n_runs + rr] = count(rr);
    if (lane == 0) who[row] = q;
  }
}

// One CTA per tile j, between boundary samples who[j] and who[j + 1]
// (the last tile ends at cap): a thread per (boundary, run) turns the
// boundary's sample counts into lane counts, a search of S lanes; the
// CTA loads those lanes of every run, merges them in shared memory and
// writes them at the output rank of its first boundary (the sum of its
// lane counts). Shared memory: two buffers of `tile` 16-byte records
// (key, seq, weight, index); the merge is `slsm::merge_in_shared`.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
kway_merge_kernel(const int32_t* __restrict__ k,
                  const int32_t* __restrict__ w,
                  const int32_t* __restrict__ s,
                  const int32_t* __restrict__ ix,
                  const int32_t* __restrict__ split,
                  const int32_t* __restrict__ who, int32_t* __restrict__ ok,
                  int32_t* __restrict__ ow, int32_t* __restrict__ os,
                  int32_t* __restrict__ oix, int n_runs, int cap, int tile,
                  int step, int per_run) {
  extern __shared__ int32_t smem[];         // two buffers of tile records
  int32_t* lo = smem + 8 * tile;            // (n_runs,) first lane taken
  int32_t* hi = lo + n_runs;                // (n_runs,) last lane + 1
  int32_t* bnd = hi + n_runs;               // (n_runs + 1,) run bounds
  __shared__ int base;
  {                                        // merge blockIdx.y of the batch
    const int64_t b = blockIdx.y, lanes = static_cast<int64_t>(n_runs) * cap;
    k += b * lanes;
    w += b * lanes;
    s += b * lanes;
    ix += b * lanes;
    ok += b * lanes;
    ow += b * lanes;
    os += b * lanes;
    oix += b * lanes;
    split += b * gridDim.x * n_runs;
    who += b * gridDim.x;
  }
  const int j = blockIdx.x;
  const bool last = j + 1 == static_cast<int>(gridDim.x);
  // lane counts of this tile's two boundaries, a thread per (bound, run)
  for (int x = threadIdx.x; x < 2 * n_runs; x += blockDim.x) {
    const int r = x % n_runs, row = j + x / n_runs;
    int c = cap;                           // the last tile ends at cap
    if (x < n_runs || !last) {
      const int q = who[row];
      const int qr = q / per_run, i = q % per_run * step;
      c = lanes_before(k, s, cap, step, qr, i,
                       k[static_cast<int64_t>(qr) * cap + i],
                       s[static_cast<int64_t>(qr) * cap + i], r,
                       split[static_cast<int64_t>(row) * n_runs + r]);
    }
    if (x < n_runs) lo[r] = c; else hi[r] = c;
  }
  __syncthreads();
  // run r's end in the tile (a prefix of lengths), and the tile's output
  // offset (lanes before its first boundary)
  for (int x = threadIdx.x; x < n_runs; x += blockDim.x) {
    int pre = 0;
    for (int r = 0; r <= x; ++r) pre += hi[r] - lo[r];
    bnd[x + 1] = pre;
  }
  if (threadIdx.x == 0) {
    int off = 0;
    for (int r = 0; r < n_runs; ++r) off += lo[r];
    bnd[0] = 0;
    base = off;
  }
  __syncthreads();
  const int total = bnd[n_runs];
  const int32_t* src[4] = {k, w, s, ix};
  for (int p0 = threadIdx.x; p0 < total; p0 += kBatch * blockDim.x) {
    int32_t v[kBatch][4];                   // kBatch lanes in flight
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * blockDim.x;
      if (p < total) {
        int a = 0, b = n_runs;              // run r: bnd[r] <= p < bnd[r+1]
        while (b - a > 1) {
          const int mid = (a + b) >> 1;
          if (bnd[mid] <= p) a = mid; else b = mid;
        }
        const int64_t at = static_cast<int64_t>(a) * cap + lo[a]
                           + (p - bnd[a]);
#pragma unroll
        for (int l = 0; l < 4; ++l) v[u][l] = src[l][at];
      }
    }
    int4* rec = reinterpret_cast<int4*>(smem);
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * blockDim.x;
      if (p < total) rec[p] = make_int4(v[u][0], v[u][2], v[u][1], v[u][3]);
    }
  }
  __syncthreads();
  int4* buf = reinterpret_cast<int4*>(smem);
  const int4* out = buf + slsm::merge_in_shared(buf, tile, bnd, n_runs,
                                                total) * tile;
  const int64_t o = base;
  for (int p = threadIdx.x; p < total; p += blockDim.x) {
    const int4 r = out[p];                  // (key, seq, weight, index)
    ok[o + p] = r.x;
    os[o + p] = r.y;
    ow[o + p] = r.z;
    oix[o + p] = r.w;
  }
}

template <int kThreads>
cudaError_t merge_tiles(const void* k, const void* w, const void* s,
                        const void* ix, const void* split, const void* who,
                        void* ok, void* ow, void* os, void* oix,
                        long long n_runs, long long cap, long long step,
                        long long tile, int per_run, unsigned tiles,
                        unsigned batch, cudaStream_t st) {
  const size_t smem = (8 * tile + 3 * n_runs + 1) * sizeof(int32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      kway_merge_kernel<kThreads>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kway_merge_kernel<kThreads><<<dim3(tiles, batch), kThreads, smem, st>>>(
      static_cast<const int32_t*>(k), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(s), static_cast<const int32_t*>(ix),
      static_cast<const int32_t*>(split), static_cast<const int32_t*>(who),
      static_cast<int32_t*>(ok), static_cast<int32_t*>(ow),
      static_cast<int32_t*>(os), static_cast<int32_t*>(oix),
      static_cast<int>(n_runs), static_cast<int>(cap),
      static_cast<int>(tile), static_cast<int>(step), per_run);
  return cudaGetLastError();
}

}  // namespace

// The k-way merge of a batch of `batch` merges: lanes k/w/s/ix and
// outputs (batch, n_runs * cap) int32, each merge's runs back to back,
// each run sorted by (key, seq). `step` = S, `group` = G
// with S * (G + n_runs) <= tile; split (batch, n_tiles, n_runs) and who
// (batch, n_tiles) int32 scratch, n_tiles = ceil(n_runs * ceil(cap / S)
// / G).
// shared != 0: each of the `split_ctas` split CTAs holds all
// n_runs * ceil(cap / S) samples, 8 bytes each of shared memory; else
// the split CTAs search the samples in place.
extern "C" int heap_merge_kway_launch(
    const void* k, const void* w, const void* s, const void* ix, void* split,
    void* who, void* ok, void* ow, void* os, void* oix, long long n_runs,
    long long cap, long long step, long long group, long long tile,
    long long split_ctas, long long shared, long long batch, void* stream) {
  if (n_runs <= 0 || cap <= 0 || batch <= 0)
    return static_cast<int>(cudaGetLastError());
  if (batch > 65535) return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int per_run = static_cast<int>((cap + step - 1) / step);
  const int64_t samples = n_runs * per_run;
  const unsigned tiles = static_cast<unsigned>((samples + group - 1) / group);
  const auto split_kernel =
      shared ? kway_split_kernel<true> : kway_split_kernel<false>;
  const size_t split_smem =
      shared ? 2 * n_runs * sample_pitch(per_run) * sizeof(int32_t) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(split_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  split_kernel<<<dim3(static_cast<unsigned>(split_ctas),
                      static_cast<unsigned>(batch)),
                 kSplitThreads, split_smem, st>>>(
      static_cast<const int32_t*>(k), static_cast<const int32_t*>(s),
      static_cast<int32_t*>(split), static_cast<int32_t*>(who),
      static_cast<int>(n_runs), static_cast<int>(cap),
      static_cast<int>(step), per_run, static_cast<int>(group),
      static_cast<int>(tiles));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // small tiles take more threads: a thread merges ~2-4 lanes a round
  return static_cast<int>(
      tile <= 1024 ? merge_tiles<512>(k, w, s, ix, split, who, ok, ow, os,
                                      oix, n_runs, cap, step, tile, per_run,
                                      tiles, static_cast<unsigned>(batch), st)
                   : merge_tiles<256>(k, w, s, ix, split, who, ok, ow, os,
                                      oix, n_runs, cap, step, tile, per_run,
                                      tiles, static_cast<unsigned>(batch),
                                      st));
}

// Lanes k/w/s/ix and outputs (N,) int32; pairs (P, 3) int64 of
// (lo, mid, hi); longest = the longest pair, hi - lo.
extern "C" int heap_merge_round_launch(const void* k, const void* w,
                                       const void* s, const void* ix,
                                       const void* pairs, void* ok, void* ow,
                                       void* os, void* oix, long long n_pairs,
                                       long long longest, void* stream) {
  if (n_pairs > 0 && longest > 0) {
    constexpr unsigned kBlock = 256;
    dim3 grid(slsm::grid_for(longest, kBlock),
              static_cast<unsigned>(n_pairs));
    merge_round_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(k), static_cast<const int32_t*>(w),
        static_cast<const int32_t*>(s), static_cast<const int32_t*>(ix),
        static_cast<const int64_t*>(pairs), static_cast<int32_t*>(ok),
        static_cast<int32_t*>(ow), static_cast<int32_t*>(os),
        static_cast<int32_t*>(oix));
  }
  return static_cast<int>(cudaGetLastError());
}
