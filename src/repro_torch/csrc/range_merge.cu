// range_merge: the range scan's per-row segment merge-dedup (paper 2.9).
//
// Replaces repro/kernels/range_merge/range_merge.py `_round_kernel`
// (`merge_round_pallas`), which merged adjacent segment pairs of every
// candidate row once per launch, the host driving log2(P) such rounds
// (P padded to a power of two), the last one emitting the keep mask,
// and the payload gathered afterwards through a source-index lane. Each
// of Q rows of width C holds P sorted segments at run-time offsets
// (Q, P+1); lanes at or past offsets[P] are padding. Two entry points:
//
//  * `range_merge_launch` — the whole merge, every row in one pass. Its
//    order is the rounds' exactly: (key, seq) ascending, ties to the
//    later segment, then by position. (1) Only for rows wider than a
//    tile (T lanes), a split: every S-th lane of every segment is a
//    sample, and every G-th sample in merged order bounds a tile
//    (S * (G + P) <= T). `range_split_kernel` merges a row's samples
//    in shared memory (one CTA a row); where they do not fit,
//    `range_rank_kernel` ranks each in place (one warp a sample, a
//    search of every segment's samples). Each boundary turns the
//    samples of every segment that precede it into lane counts (a
//    search of S lanes). (2) `range_tile_kernel`, one CTA per (tile,
//    row): reads its two boundaries' lane counts (for a row of one tile
//    the offsets are the split), loads those lanes of every segment into
//    shared memory as 16-byte records (key, seq, weight, payload), merges
//    them there (`slsm::merge_in_shared`), and writes (key, payload,
//    weight, seq, keep) at the tile's output rank, the payload zeroed on
//    KEY_EMPTY lanes. The payload rides the merge in place of a source
//    index: the lanes are in shared memory anyway, so it costs the
//    index's bytes and saves the gather. keep needs each lane's
//    successor: inside the tile the next merged lane; for the tile's
//    last lane the smallest head key among the segments past the tile.
//    A row that fits one tile (C <= T, the main path's C = 512) is one
//    launch; any wider row is two. The CTAs of a row also write its
//    padding lanes.
//  * `range_merge_round_launch` — one round of the rounds above, kept
//    as the reference contract (`merge_round`); `range_merge` does not
//    launch it.
//
// Bound: bytes — each filled lane read once (16 B), every lane written
// once (17 B). Both kernels are bound by latency: the dependent searches
// and the log2(P) barriers of the shared-memory merge.
#include "common.cuh"

namespace {

__global__ void range_round_kernel(
    const int32_t* __restrict__ k, const int32_t* __restrict__ w,
    const int32_t* __restrict__ s, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ offsets, int32_t* __restrict__ ok,
    int32_t* __restrict__ ow, int32_t* __restrict__ os,
    int32_t* __restrict__ oix, uint8_t* __restrict__ keep, int64_t c_n,
    int64_t s_n, bool drop) {
  const int64_t q = blockIdx.y;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  if (t >= c_n) return;
  const int64_t row = q * c_n;
  const int32_t* off = offsets + q * (s_n + 1);
  const int64_t total = off[s_n];
  if (t >= total) {
    ok[row + t] = slsm::KEY_EMPTY;
    ow[row + t] = 0;
    os[row + t] = 0;
    oix[row + t] = 0;
    if (keep) keep[row + t] = 0;
    return;
  }
  const int64_t half = s_n / 2;
  int64_t p = slsm::upper_bound(off, half + 1, static_cast<int32_t>(t), 2)
              - 1;
  p = p < 0 ? 0 : (p > half - 1 ? half - 1 : p);
  const int64_t a_lo = off[2 * p], a_hi = off[2 * p + 1],
                b_hi = off[2 * p + 2];
  const int64_t n = a_hi - a_lo, m = b_hi - a_hi, tt = t - a_lo;
  const int32_t *ak = k + row + a_lo, *as = s + row + a_lo;
  const int32_t *bk = k + row + a_hi, *bs = s + row + a_hi;
  const int64_t i = slsm::merge_path(ak, as, n, bk, bs, m, tt);
  const int64_t j = tt - i;
  const bool from_a = slsm::take_a(ak, as, n, bk, bs, m, i, j);
  const int64_t src = row + (from_a ? a_lo + i : a_hi + j);
  const int32_t key = k[src];
  ok[row + t] = key;
  ow[row + t] = w[src];
  os[row + t] = s[src];
  oix[row + t] = ix[src];
  if (keep) {
    int32_t next = slsm::KEY_EMPTY;
    if (t + 1 < total) {
      const int64_t i2 = i + (from_a ? 1 : 0), j2 = tt + 1 - i2;
      next = slsm::take_a(ak, as, n, bk, bs, m, i2, j2) ? ak[i2] : bk[j2];
    }
    keep[row + t] = key != slsm::KEY_EMPTY && key != next
                    && (!drop || w[src] > 0);
  }
}

constexpr int kTileThreads = 512;
constexpr int kSplitThreads = 1024;
constexpr int kBatch = 8;                 // loads a thread keeps in flight

// The segment a holding position p: bounds[a] <= p < bounds[a + 1], a in
// [0, n) (the last one when several share a bound: empty ones are
// skipped).
__device__ __forceinline__ int seg_of(const int32_t* bounds, int n, int p) {
  int a = 0, b = n;
  while (b - a > 1) {
    const int mid = (a + b) >> 1;
    if (bounds[mid] <= p) a = mid; else b = mid;
  }
  return a;
}

// Exclusive prefix of len(r) over r in [0, n) into out[0..n] (out[n] is
// the sum). Called by the 32 lanes of one warp.
template <typename F>
__device__ __forceinline__ void warp_prefix(F len, int n, int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int r0 = lane * per < n ? lane * per : n;
  const int r1 = r0 + per < n ? r0 + per : n;
  int sum = 0;
  for (int r = r0; r < r1; ++r) sum += len(r);
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  int run = inc - sum;
  for (int r = r0; r < r1; ++r) {
    out[r] = run;
    run += len(r);
  }
  if (lane == 31) out[n] = inc;
}

// Lanes of segment rr (rk, rs: its keys and seqs, len lanes) that
// precede the boundary sample x (segment r, lane i) in (key, seq,
// -segment, lane) order, given that c samples of rr precede it: they lie
// in [(c - 1) * S + 1, min(c * S, len)].
__device__ __forceinline__ int lanes_before(const int32_t* rk,
                                            const int32_t* rs, int len,
                                            int step, int r, int i,
                                            int32_t xk, int32_t xs, int rr,
                                            int c) {
  if (rr == r) return i;
  if (c == 0) return 0;
  const int lo = (c - 1) * step + 1;
  const int hi = c * step < len ? c * step : len;
  return lo + slsm::rank_in(rk + lo, rs + lo, hi - lo, xk, xs, rr > r);
}

// Tile boundary sample (r, m) — lane m * S of segment r, key xk, seq xs
// — preceded by count(rr) samples of each segment rr: one warp turns
// those counts into lane counts (a search of S lanes a segment) and
// writes them to out (n_seg,), lanes over segments.
template <typename F>
__device__ __forceinline__ void write_bound(
    const int32_t* k, const int32_t* s, int64_t row, const int32_t* off,
    int n_seg, int step, int r, int m, int32_t xk, int32_t xs, F count,
    int32_t* out) {
  for (int rr = threadIdx.x & 31; rr < n_seg; rr += 32) {
    const int64_t at = row + off[rr];
    out[rr] = lanes_before(k + at, s + at, off[rr + 1] - off[rr], step, r,
                           m * step, xk, xs, rr, count(rr));
  }
}

// The row's offsets into off and, in base, where each segment's samples
// start (sample m of segment r, lane m * S, has index base[r] + m);
// returns the row's sample count. Every thread of the block calls it.
__device__ __forceinline__ int row_samples(const int32_t* offsets, int q,
                                           int n_seg, int step,
                                           int32_t* off, int32_t* base) {
  for (int x = threadIdx.x; x <= n_seg; x += blockDim.x)
    off[x] = offsets[static_cast<int64_t>(q) * (n_seg + 1) + x];
  __syncthreads();
  if (threadIdx.x < 32)
    warp_prefix([&](int r) { return (off[r + 1] - off[r] + step - 1) / step; },
                n_seg, base);
  __syncthreads();
  return base[n_seg];
}

// The split of rows whose samples fit shared memory (at most `cap`): one
// CTA per row loads them as records (key, seq, segment, index in the
// segment), merges them there as the tile kernel merges lanes
// (`slsm::merge_in_shared`, so in (key, seq, -segment, lane) order), and
// records each sample's merged rank by its index. A sample at a merged
// rank that is a multiple of G bounds tile rank / G: one warp a boundary
// counts, in every segment, the samples ranked below it — a search of
// their ranks, which rise with the index — and writes the lane counts.
__global__ void __launch_bounds__(kSplitThreads)
range_split_kernel(const int32_t* __restrict__ k,
                   const int32_t* __restrict__ s,
                   const int32_t* __restrict__ offsets,
                   int32_t* __restrict__ split, int c_n, int n_seg,
                   int step, int group, int tiles, int cap) {
  extern __shared__ int32_t sm[];
  int4* buf = reinterpret_cast<int4*>(sm);  // two buffers of cap records
  int32_t* off = sm + 8 * cap;              // (n_seg + 1,) segment bounds
  int32_t* base = off + n_seg + 1;          // (n_seg + 1,) first samples
  const int q = blockIdx.y;
  const int64_t row = static_cast<int64_t>(q) * c_n;
  const int n_samp = row_samples(offsets, q, n_seg, step, off, base);
  for (int x0 = threadIdx.x; x0 < n_samp; x0 += kBatch * blockDim.x) {
    int32_t vk[kBatch], vs[kBatch], vr[kBatch];  // kBatch loads in flight
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x < n_samp) {
        vr[u] = seg_of(base, n_seg, x);
        const int64_t at = row + off[vr[u]]
                           + static_cast<int64_t>(x - base[vr[u]]) * step;
        vk[u] = k[at];
        vs[u] = s[at];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x < n_samp) buf[x] = make_int4(vk[u], vs[u], vr[u], x - base[vr[u]]);
    }
  }
  __syncthreads();
  const int cur = slsm::merge_in_shared(buf, cap, base, n_seg, n_samp);
  const int4* merged = buf + cur * cap;     // (key, seq, segment, index)
  int32_t* rank = reinterpret_cast<int32_t*>(buf + (cur ^ 1) * cap);
  for (int i = threadIdx.x; i < n_samp; i += blockDim.x)
    rank[base[merged[i].z] + merged[i].w] = i;   // merged rank by index
  __syncthreads();
  const int n_tiles = (n_samp + group - 1) / group;
  for (int b = threadIdx.x >> 5; b < n_tiles; b += blockDim.x >> 5) {
    const int i = b * group;
    const int4 x = merged[i];
    const int r = x.z, m = x.w;
    write_bound(k, s, row, off, n_seg, step, r, m, x.x, x.y,
                [&](int rr) {
                  return rr == r ? m : static_cast<int>(slsm::lower_bound(
                      rank + base[rr], base[rr + 1] - base[rr], i));
                },
                split + (static_cast<int64_t>(q) * tiles + b) * n_seg);
  }
}

// The split of rows whose samples miss shared memory, ranked in place:
// one warp per sample x (segment r, lane m * S), a lane per segment r'
// (32 at a time), counts the samples of r' that precede x — a binary
// search over every S-th lane of r', from L2 — and their sum is x's rank
// among the row's samples; a sample whose rank is a multiple of G
// writes its tile's lane counts.
__global__ void __launch_bounds__(kSplitThreads)
range_rank_kernel(const int32_t* __restrict__ k,
                  const int32_t* __restrict__ s,
                  const int32_t* __restrict__ offsets,
                  int32_t* __restrict__ split, int c_n, int n_seg,
                  int step, int group, int tiles) {
  extern __shared__ int32_t sm[];
  int32_t* off = sm;                        // (n_seg + 1,) segment bounds
  int32_t* base = off + n_seg + 1;          // (n_seg + 1,) first samples
  const int q = blockIdx.y;
  const int64_t row = static_cast<int64_t>(q) * c_n;
  const int n_samp = row_samples(offsets, q, n_seg, step, off, base);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int x = blockIdx.x * warps + (threadIdx.x >> 5); x < n_samp;
       x += gridDim.x * warps) {
    const int r = seg_of(base, n_seg, x), m = x - base[r];
    const int64_t at = row + off[r] + static_cast<int64_t>(m) * step;
    const int32_t xk = k[at], xs = s[at];
    // samples of segment rr before this one
    auto count = [&](int rr) {
      if (rr == r) return m;
      const int64_t a = row + off[rr];
      return slsm::rank_in(k + a, s + a, base[rr + 1] - base[rr], xk, xs,
                           rr > r, step);
    };
    int srank = 0;
    for (int rr = lane; rr < n_seg; rr += 32) srank += count(rr);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      srank += __shfl_xor_sync(0xffffffffu, srank, o);
    if (srank % group) continue;
    write_bound(k, s, row, off, n_seg, step, r, m, xk, xs, count,
                split + (static_cast<int64_t>(q) * tiles + srank / group)
                            * n_seg);
  }
}

// One CTA per (tile j, row q). split == nullptr: the row is one tile,
// segments whole. Else tile j takes, of each segment, the lanes between
// boundary j's and boundary j + 1's lane counts (the last ends at the
// segments' ends); CTAs past the row's tile count only write padding.
// Shared memory: two buffers of `tile` 16-byte records (key, seq,
// weight, payload), then the row's offsets and the tile's per-segment
// bounds.
__global__ void __launch_bounds__(kTileThreads)
range_tile_kernel(const int32_t* __restrict__ k,
                  const int32_t* __restrict__ v,
                  const int32_t* __restrict__ w,
                  const int32_t* __restrict__ s,
                  const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ split,
                  int32_t* __restrict__ ok,
                  int32_t* __restrict__ ov, int32_t* __restrict__ ow,
                  int32_t* __restrict__ os, uint8_t* __restrict__ keep,
                  int c_n, int n_seg, int tile, int step, int group,
                  int tiles, bool drop) {
  extern __shared__ int32_t smem[];
  int4* buf = reinterpret_cast<int4*>(smem);  // two buffers of tile records
  int32_t* off = smem + 8 * tile;           // (n_seg + 1,) row bounds
  int32_t* lo = off + n_seg + 1;            // (n_seg,) first lane taken
  int32_t* hi = lo + n_seg;                 // (n_seg,) last lane + 1
  int32_t* bnd = hi + n_seg;                // (n_seg + 1,) tile bounds
  __shared__ int row_tiles, base;
  __shared__ int32_t next_key;
  const int q = blockIdx.y, j = blockIdx.x;
  const int64_t row = static_cast<int64_t>(q) * c_n;
  for (int x = threadIdx.x; x <= n_seg; x += blockDim.x)
    off[x] = offsets[static_cast<int64_t>(q) * (n_seg + 1) + x];
  __syncthreads();
  const int total = off[n_seg];
  auto seg_len = [&](int r) { return off[r + 1] - off[r]; };
  int n_tiles = 1;
  if (split) {                              // the row's tiles
    if (threadIdx.x < 32) {
      int n_samp = 0;
      for (int r = threadIdx.x; r < n_seg; r += 32)
        n_samp += (seg_len(r) + step - 1) / step;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        n_samp += __shfl_xor_sync(0xffffffffu, n_samp, o);
      if (threadIdx.x == 0) row_tiles = (n_samp + group - 1) / group;
    }
    __syncthreads();
    n_tiles = row_tiles;
  }
  if (j < n_tiles) {
    if (!split) {
      // one tile: the row's segments whole, no lane before it and no key
      // after it
      for (int x = threadIdx.x; x <= n_seg; x += blockDim.x)
        bnd[x] = off[x] - off[0];
      if (threadIdx.x == 0) {
        base = 0;
        next_key = slsm::KEY_EMPTY;
      }
    } else {
      // lane counts of the tile's two boundaries, a thread per (bound,
      // segment); past the last boundary, the segment's end
      for (int x = threadIdx.x; x < 2 * n_seg; x += blockDim.x) {
        const int r = x % n_seg, b = j + x / n_seg;
        const int c =
            b < n_tiles
                ? split[(static_cast<int64_t>(q) * tiles + b) * n_seg + r]
                : seg_len(r);
        if (x < n_seg) lo[r] = c; else hi[r] = c;
      }
      __syncthreads();
      // segment bounds in the tile, its output rank (lanes before its
      // first boundary), and the key that follows its last lane
      if (threadIdx.x < 32) {
        warp_prefix([&](int r) { return hi[r] - lo[r]; }, n_seg, bnd);
        int ahead = 0;
        int32_t nk = slsm::KEY_EMPTY;
        for (int r = threadIdx.x; r < n_seg; r += 32) {
          ahead += lo[r];
          if (hi[r] < seg_len(r)) {
            const int32_t head = k[row + off[r] + hi[r]];
            nk = head < nk ? head : nk;
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ahead += __shfl_xor_sync(0xffffffffu, ahead, o);
          const int32_t y = __shfl_xor_sync(0xffffffffu, nk, o);
          nk = y < nk ? y : nk;
        }
        if (threadIdx.x == 0) {
          base = ahead;
          next_key = nk;
        }
      }
    }
    __syncthreads();
    const int n = bnd[n_seg];
    const int32_t* src[4] = {k, w, s, v};
    for (int p0 = threadIdx.x; p0 < n; p0 += kBatch * blockDim.x) {
      int32_t val[kBatch][4];               // kBatch lanes in flight
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * blockDim.x;
        if (p < n) {
          int64_t at = row + off[0] + p;    // one tile: the row in order
          if (split) {
            const int a = seg_of(bnd, n_seg, p);
            at = row + off[a] + lo[a] + (p - bnd[a]);
          }
#pragma unroll
          for (int l = 0; l < 4; ++l) val[u][l] = src[l][at];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * blockDim.x;
        if (p < n)
          buf[p] = make_int4(val[u][0], val[u][2], val[u][1], val[u][3]);
      }
    }
    __syncthreads();
    const int4* out = buf + slsm::merge_in_shared(buf, tile, bnd, n_seg, n)
                            * tile;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int4 r = out[p];                // (key, seq, weight, payload)
      const int32_t nxt = p + 1 < n ? out[p + 1].x : next_key;
      const int64_t o = row + base + p;
      ok[o] = r.x;
      ov[o] = r.x == slsm::KEY_EMPTY ? 0 : r.w;
      ow[o] = r.z;
      os[o] = r.y;
      keep[o] = r.x != slsm::KEY_EMPTY && r.x != nxt && (!drop || r.z > 0);
    }
  }
  // the row's lanes past `total` are padding, shared by its CTAs
  for (int64_t t = total + static_cast<int64_t>(j) * blockDim.x
                   + threadIdx.x;
       t < c_n; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    ok[row + t] = slsm::KEY_EMPTY;
    ov[row + t] = 0;
    ow[row + t] = 0;
    os[row + t] = 0;
    keep[row + t] = 0;
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory, and prefer
// the SM's largest shared-memory carve-out, so that as many CTAs of it
// fit an SM as its shared memory allows.
template <typename K>
cudaError_t set_shared(K kernel, size_t smem) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// Lanes and outputs (Q, C) int32; offsets (Q, S+1) int32; keep (Q, C)
// bool or null (non-final rounds).
extern "C" int range_merge_round_launch(
    const void* k, const void* w, const void* s, const void* ix,
    const void* offsets, void* ok, void* ow, void* os, void* oix, void* keep,
    long long q_n, long long c_n, long long s_n, long long drop,
    void* stream) {
  if (q_n > 0 && c_n > 0) {
    constexpr unsigned kBlock = 256;
    dim3 grid(slsm::grid_for(c_n, kBlock), static_cast<unsigned>(q_n));
    range_round_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(k), static_cast<const int32_t*>(w),
        static_cast<const int32_t*>(s), static_cast<const int32_t*>(ix),
        static_cast<const int32_t*>(offsets), static_cast<int32_t*>(ok),
        static_cast<int32_t*>(ow), static_cast<int32_t*>(os),
        static_cast<int32_t*>(oix), static_cast<uint8_t*>(keep), c_n, s_n,
        drop != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// The whole merge. Lanes k/v/w/s and outputs ok/ov/ow/os (Q, C) int32,
// keep (Q, C) bool; offsets (Q, P+1) int32, non-decreasing from 0 to at
// most C. step == 0: each row is one tile of `tile` = C lanes, one
// launch. Else rows split into tiles of at most `tile` lanes: `step` = S,
// `group` = G with S * (G + P) <= tile, `tiles` >= the most tiles a row
// can have (ceil((ceil(C / S) + P) / G)); split (Q, tiles, P) int32
// scratch (each tile boundary's lane count in each segment). shared !=
// 0: one split CTA a row holds the row's samples (at most ceil(C / S) +
// P, 32 bytes each) in shared memory; else `split_ctas` CTAs a row rank
// them in place.
extern "C" int range_merge_launch(
    const void* k, const void* v, const void* w, const void* s,
    const void* offsets, void* split, void* ok, void* ov,
    void* ow, void* os, void* keep, long long q_n, long long c_n,
    long long n_seg, long long tile, long long step, long long group,
    long long tiles, long long split_ctas, long long shared, long long drop,
    void* stream) {
  if (q_n <= 0 || c_n <= 0) return static_cast<int>(cudaGetLastError());
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 rows_of(1, static_cast<unsigned>(q_n));
  cudaError_t err;
  if (step > 0) {
    const auto* kk = static_cast<const int32_t*>(k);
    const auto* ks = static_cast<const int32_t*>(s);
    const auto* ko = static_cast<const int32_t*>(offsets);
    auto* ksp = static_cast<int32_t*>(split);
    const int c = static_cast<int>(c_n), p = static_cast<int>(n_seg),
              sn = static_cast<int>(step), g = static_cast<int>(group),
              nt = static_cast<int>(tiles);
    if (shared) {
      const int cap = static_cast<int>((c_n + step - 1) / step + n_seg);
      const size_t smem = (8 * cap + 2 * (n_seg + 1)) * sizeof(int32_t);
      err = set_shared(range_split_kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      range_split_kernel<<<rows_of, kSplitThreads, smem, st>>>(
          kk, ks, ko, ksp, c, p, sn, g, nt, cap);
    } else {
      const size_t smem = 2 * (n_seg + 1) * sizeof(int32_t);
      err = set_shared(range_rank_kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      range_rank_kernel<<<dim3(static_cast<unsigned>(split_ctas),
                               rows_of.y),
                          kSplitThreads, smem, st>>>(kk, ks, ko, ksp, c, p,
                                                     sn, g, nt);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = (8 * tile + 4 * n_seg + 2) * sizeof(int32_t);
  err = set_shared(range_tile_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  range_tile_kernel<<<dim3(static_cast<unsigned>(tiles), rows_of.y),
                      kTileThreads, smem, st>>>(
      static_cast<const int32_t*>(k), static_cast<const int32_t*>(v),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(s),
      static_cast<const int32_t*>(offsets),
      step > 0 ? static_cast<const int32_t*>(split) : nullptr,
      static_cast<int32_t*>(ok),
      static_cast<int32_t*>(ov), static_cast<int32_t*>(ow),
      static_cast<int32_t*>(os), static_cast<uint8_t*>(keep),
      static_cast<int>(c_n), static_cast<int>(n_seg),
      static_cast<int>(tile), static_cast<int>(step),
      static_cast<int>(group), static_cast<int>(tiles), drop != 0);
  return static_cast<int>(cudaGetLastError());
}
