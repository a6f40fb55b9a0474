// heap_merge: one round of the HeapMerge tournament (paper 2.5).
//
// Replaces repro/kernels/heap_merge/heap_merge.py `_merge_kernel`
// (`merge_two_pallas`), which merged one pair of runs per launch. The
// paper's serial min-heap becomes a log2(k) tournament of two-way merges
// driven by the host (repro_torch/kernels/heap_merge/ops.py); this kernel
// runs every pair of one round in a single launch. The runs of a round
// lie back to back in one flat buffer and pair p merges
// [lo_p, mid_p) with [mid_p, hi_p) in place (an odd last run is a pair
// with an empty second half, i.e. a copy). Lanes are (key, weight, seq,
// source-index); the payload never enters the merge.
//
// One thread per output element t of pair p (blockIdx.y): a merge-path
// binary search on the diagonal finds how many of its first t outputs
// come from the first run, then the thread takes from one side. Ties on
// (key, seq) go to the second run, as in the TPU kernel.
//
// Bound: bytes — each round reads and writes 16 bytes per element, but
// the per-element search adds ~log2(n) scattered 8-byte probes, served
// mostly from L2. A per-tile split with a shared-memory merge would cut
// those probes; this first kernel keeps the simple per-element form.
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

}  // namespace

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
