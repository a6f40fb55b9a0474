// range_merge: one tournament round of the range-scan merge-dedup
// (paper 2.9).
//
// Replaces repro/kernels/range_merge/range_merge.py `_round_kernel`
// (`merge_round_pallas`). Each of Q candidate rows of width C holds S
// sorted segments at run-time offsets (Q, S+1), S even; a round merges
// segment pairs (2p, 2p+1) in place. One thread per (row, lane): an
// `upper_bound` over the paired boundaries offsets[0::2] finds the lane's
// pair, a merge-path search inside the pair finds the element. Lanes at
// or past offsets[S] are padding and come out (KEY_EMPTY, 0, 0, 0).
//
// The final round (one pair left, so the pair stream is the row's global
// (key, seq) order) also emits the weighted survivor mask: a lane is kept
// iff it is not padding, the next merged element (the split advanced by
// one on the side just taken) has another key, and, when `drop`, its
// weight is positive.
//
// Bound: bytes. A row is 4 lanes x C x 4 B (8 KB at C = 512) read and
// written per round; the searches probe the same row, which stays in L1/L2
// while its block runs. Launch count is log2(S) per batch; keeping a row
// in shared memory across all rounds in one launch is later work.
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
