// fence_lookup: fence-pointer page search over a level's D sorted runs.
//
// Replaces repro/kernels/fence_lookup/fence_lookup.py `_fence_kernel`
// (`fence_lookup_pallas`), launched once per run by the reference. Here
// one launch covers a (D, cap) stack, one thread per (run, query):
// `upper_bound` over the run's fences gives the page, whose start f*mu is
// pinned to cap-mu (a strided fence view can leave a partial last page);
// a binary search inside the mu-wide window finds the key. The TPU kernel
// compared all mu window lanes at once; a GPU thread would pay mu loads
// for that, while the window is sorted, so `lower_bound` gives the same
// index in log2(mu) loads. Output: the element index, or -1 when the key
// is missing or its index is >= the run's count.
//
// Bound: bytes (scattered reads). A query touches ~log2(F) fence words and
// ~log2(mu) key words of one run; the fences of a level are small and stay
// in L2, the window reads are the device-memory traffic. Queries of a
// block share one run (blockIdx.y).
#include "common.cuh"

namespace {

__global__ void fence_lookup_kernel(const int32_t* __restrict__ qs,
                                    const int32_t* __restrict__ fences,
                                    const int32_t* __restrict__ keys,
                                    const int32_t* __restrict__ counts,
                                    int32_t* __restrict__ out, int64_t q_n,
                                    int64_t f_n, int64_t cap, int64_t mu) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  const int64_t d = blockIdx.y;
  if (q >= q_n) return;
  const int32_t x = qs[q];
  int64_t f = slsm::upper_bound(fences + d * f_n, f_n, x) - 1;
  f = f < 0 ? 0 : (f > f_n - 1 ? f_n - 1 : f);
  int64_t start = f * mu;
  if (start > cap - mu) start = cap - mu;
  const int32_t* win = keys + d * cap + start;
  const int64_t off = slsm::lower_bound(win, mu, x);
  const int64_t offc = off < mu - 1 ? off : mu - 1;
  const bool hit = off < mu && win[offc] == x && start + offc < counts[d];
  out[d * q_n + q] = hit ? static_cast<int32_t>(start + offc) : -1;
}

}  // namespace

// qs (Q,), fences (D, F), keys (D, cap), counts (D,) -> out (D, Q) int32.
extern "C" int fence_lookup_launch(const void* qs, const void* fences,
                                   const void* keys, const void* counts,
                                   void* out, long long d_n, long long q_n,
                                   long long f_n, long long cap,
                                   long long mu, void* stream) {
  if (d_n > 0 && q_n > 0) {
    constexpr unsigned kBlock = 256;
    dim3 grid(slsm::grid_for(q_n, kBlock), static_cast<unsigned>(d_n));
    fence_lookup_kernel<<<grid, kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(qs), static_cast<const int32_t*>(fences),
        static_cast<const int32_t*>(keys),
        static_cast<const int32_t*>(counts), static_cast<int32_t*>(out), q_n,
        f_n, cap, mu);
  }
  return static_cast<int>(cudaGetLastError());
}
