// Shared device helpers of the port's kernels.
//
// Replaces repro/kernels/common.py (`lower_bound` / `upper_bound`): there
// the searches were branch-free lockstep loops across TPU vector lanes;
// here each GPU thread runs its own search, so a plain data-dependent
// loop is the natural form. Also the (key, seq) order every merge uses
// and the sentinels of repro_torch/core/params.py.
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

inline unsigned grid_for(int64_t n, unsigned block) {
  return static_cast<unsigned>((n + block - 1) / block);
}

}  // namespace slsm
