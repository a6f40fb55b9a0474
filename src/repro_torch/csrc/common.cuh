// Shared device helpers of the port's kernels.
//
// Replaces repro/kernels/common.py (`lower_bound` / `upper_bound`): there
// the searches were branch-free lockstep loops across TPU vector lanes;
// here each GPU thread runs its own search, so a plain data-dependent
// loop is the natural form. Also the (key, seq) order every merge uses,
// the searches and the shared-memory segment merge of the two merge
// kernels (heap_merge, range_merge), and the sentinels of
// repro_torch/core/params.py.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace slsm {

constexpr int32_t KEY_EMPTY = 0x7fffffff;  // reserved empty-slot key

// First index i in [0, n) with arr[i] >= x (searchsorted side='left').
__device__ __forceinline__ int64_t lower_bound(const int32_t* arr, int64_t n,
                                               int32_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (arr[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First index i in [0, n) with arr[i * stride] > x (side='right').
__device__ __forceinline__ int64_t upper_bound(const int32_t* arr, int64_t n,
                                               int32_t x,
                                               int64_t stride = 1) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (arr[mid * stride] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// (key, seq) lexicographic strict less-than: the order of every run.
__device__ __forceinline__ bool before(int32_t ak, int32_t as, int32_t bk,
                                       int32_t bs) {
  return ak < bk || (ak == bk && as < bs);
}

// Merge-path split (Green et al.): the number i of elements of sorted
// a[0, n) among the first t outputs of the merge of a and b[0, m), ties
// going to b. Every probe stays inside both inputs: lo >= t - m keeps
// t - mid - 1 < m, and hi <= t keeps it >= 0.
__device__ __forceinline__ int64_t merge_path(
    const int32_t* ak, const int32_t* as, int64_t n,
    const int32_t* bk, const int32_t* bs, int64_t m, int64_t t) {
  int64_t lo = t - m > 0 ? t - m : 0;
  int64_t hi = t < n ? t : n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    int64_t bj = t - mid - 1;
    if (before(ak[mid], as[mid], bk[bj], bs[bj])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Does the merge position (i, j) emit a's element (else b's)?
__device__ __forceinline__ bool take_a(
    const int32_t* ak, const int32_t* as, int64_t n,
    const int32_t* bk, const int32_t* bs, int64_t m, int64_t i, int64_t j) {
  if (j >= m) return true;
  if (i >= n) return false;
  return before(ak[i], as[i], bk[j], bs[j]);
}

// First index i in [0, n) of the sorted (key, seq) pairs at rk, rs
// (probed at i * stride) that is not before x (upper: that is after x).
__device__ __forceinline__ int rank_in(const int32_t* rk, const int32_t* rs,
                                       int n, int32_t xk, int32_t xs,
                                       bool upper, int stride = 1) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int64_t at = static_cast<int64_t>(mid) * stride;
    const bool go = upper ? !before(xk, xs, rk[at], rs[at])
                          : before(rk[at], rs[at], xk, xs);
    if (go) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// A record of the shared-memory merges: (key, seq, a, b), 16 bytes; the
// (key, seq) order moves a and b along.
__device__ __forceinline__ bool before(const int4& a, const int4& b) {
  return before(a.x, a.y, b.x, b.y);
}

// The (key, seq) of record r, one 8-byte load.
__device__ __forceinline__ int4 head_of(const int4* r) {
  const int2 h = *reinterpret_cast<const int2*>(r);
  return make_int4(h.x, h.y, 0, 0);
}

// Merge-path split in shared memory: how many of records a[0, n) are
// among the first t outputs of merging a with b[0, m), ties going to b.
__device__ __forceinline__ int path_split(const int4* a, int n,
                                          const int4* b, int m, int t) {
  int lo = t - m > 0 ? t - m : 0;
  int hi = t < n ? t : n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(head_of(a + mid), head_of(b + t - mid - 1))) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge n_seg (key, seq)-sorted segments of records held in shared
// memory, segment r at [bnd[r], bnd[r + 1]), total records in all, from
// buffer 0 (buf[0, tile)) into one sorted run in buffer 0 or 1
// (buf[tile, 2 * tile)): the index of that buffer is returned. Round t
// merges groups 2i and 2i+1 of 2^t segments, ties going to the later
// group (an odd last group is copied), so the result is the stable order
// of (key, seq) with ties to the later segment, then by position. Each
// thread owns an equal run of output positions in every round; in each
// it finds where its run starts by one merge-path search and merges
// sequentially from there, the next record of each side in registers (a
// step is one 16-byte load and one 16-byte store). Group boundaries are
// segment boundaries, so the group holding a position in round t is its
// segment's >> t: one search before the rounds. Every thread of the
// block must call it; it ends on a barrier.
__device__ __forceinline__ int merge_in_shared(int4* buf, int tile,
                                               const int32_t* bnd,
                                               int n_seg, int total) {
  int cur = 0;
  const int per = (total + blockDim.x - 1) / blockDim.x;
  const int p0 = threadIdx.x * per;
  int seg0 = 0, hi0 = n_seg;                // bnd[seg0] <= p0 < bnd[seg0+1]
  while (hi0 - seg0 > 1) {
    const int mid = (seg0 + hi0) >> 1;
    if (bnd[mid] <= p0) seg0 = mid; else hi0 = mid;
  }
  for (int t = 0, n = n_seg; n > 1; ++t, n = (n + 1) >> 1) {
    // group g spans segments [g * 2^t, (g + 1) * 2^t)
    auto edge = [&](int g) {
      return bnd[(g << t) < n_seg ? g << t : n_seg];
    };
    const int4* from = buf + cur * tile;
    int4* to = buf + (cur ^ 1) * tile;
    int p = p0;
    const int end = p + per < total ? p + per : total;
    // group a holds p; after each pair the next pair (empty ones pass)
    for (int a = seg0 >> t; p < end; a = (a & ~1) + 2) {
      const int pa = a & ~1, x0 = edge(pa), x1 = edge(pa + 1),
                x2 = edge(pa + 2);
      const int na = x1 - x0, nb = x2 - x1;
      const int stop = end < x2 ? end : x2;
      if (p >= stop) continue;
      const int4 *ra = from + x0, *rb = from + x1;
      int ia = path_split(ra, na, rb, nb, p - x0);
      int ib = p - x0 - ia;
      int4 ha = ia < na ? ra[ia] : int4{}, hb = ib < nb ? rb[ib] : int4{};
      for (; p < stop; ++p) {
        if (ib >= nb || (ia < na && before(ha, hb))) {
          to[p] = ha;
          if (++ia < na) ha = ra[ia];
        } else {
          to[p] = hb;
          if (++ib < nb) hb = rb[ib];
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

inline unsigned grid_for(int64_t n, unsigned block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

}  // namespace slsm
