// fence_lookup: fence-pointer page search over a level's D sorted runs.
//
// Replaces repro/kernels/fence_lookup/fence_lookup.py `_fence_kernel`
// (`fence_lookup_pallas`), launched once per run by the reference, which
// kept a run's fences in VMEM and searched them in lockstep. Here one
// launch covers a (D, cap) stack: one CTA per (run, tile of queries), a
// thread per (run, query) pair, every pair searched. The CTA first copies
// the run's fences into shared memory in one coalesced pass — or, where
// they do not fit, every G-th fence (G a power of two) — so the
// `upper_bound` over the fences runs in shared memory and only the last
// log2(G) of its steps read L2. Its result gives the page, whose start
// f*mu is pinned to cap-mu (a strided fence view can leave a partial last
// page); a binary search inside the mu-wide window finds the key. The TPU
// kernel compared all mu window lanes at once; a GPU thread would pay mu
// loads for that, while the window is sorted, so `lower_bound` gives the
// same index in log2(mu) loads. Output: the element index, or -1 when
// the key is missing or its index is >= the run's count.
//
// With S shards (the reference vmaps the kernel over them) the stack is
// (S * D, cap) runs, the queries (S, Q), and run d searches query row
// d / D (`d_shard` = D runs a shard): one launch for the whole fleet. One
// tree is the S = 1 case.
//
// Bound: bytes (scattered reads). A query needs ~log2(F) fence words and
// ~log2(mu) key words of one run. With the fences staged, each thread's
// chain of dependent loads is the window search's log2(mu) device-memory
// reads (plus log2(G) L2 reads when only every G-th fence is staged).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;       // fence loads a thread keeps in flight

__global__ void __launch_bounds__(kThreads)
fence_lookup_kernel(const int32_t* __restrict__ qs,
                    const int32_t* __restrict__ fences,
                    const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ counts,
                    int32_t* __restrict__ out, int64_t q_n, int64_t f_n,
                    int64_t cap, int64_t mu, int64_t d_shard, int group,
                    int staged) {
  extern __shared__ int32_t st[];         // fences[d, j * group], j < staged
  const int64_t d = blockIdx.y;
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  const int32_t x = q < q_n ? qs[d / d_shard * q_n + q] : 0;
  const int32_t* fr = fences + d * f_n;
  for (int j0 = threadIdx.x; j0 < staged; j0 += kBatch * blockDim.x) {
    int32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < staged) v[u] = fr[static_cast<int64_t>(j) * group];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j < staged) st[j] = v[u];
    }
  }
  __syncthreads();
  if (q >= q_n) return;
  // upper_bound over the staged fences brackets the one over all of
  // them: fences[(u - 1) * G] <= x < fences[u * G]
  const int64_t u = slsm::upper_bound(st, staged, x);
  int64_t f = u;
  if (group > 1 && u > 0) {
    const int64_t lo = (u - 1) * group + 1;
    const int64_t hi = u * group < f_n ? u * group : f_n;
    f = lo + slsm::upper_bound(fr + lo, hi - lo, x);
  }
  f -= 1;
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

// qs (S, Q), fences (S * D, F), keys (S * D, cap), counts (S * D,) ->
// out (S * D, Q) int32, run d searching query row d / d_shard (D =
// d_shard runs a shard; one tree: S = 1, d_shard = D). `group` G: every G-th fence of a run is staged in shared memory,
// `staged` = ceil(F / G) of them.
extern "C" int fence_lookup_launch(const void* qs, const void* fences,
                                   const void* keys, const void* counts,
                                   void* out, long long d_n, long long q_n,
                                   long long f_n, long long cap,
                                   long long mu, long long d_shard,
                                   long long group, long long staged,
                                   void* stream) {
  if (d_shard < 1) return cudaErrorInvalidValue;
  if (d_n > 0 && q_n > 0) {
    const size_t smem = staged * sizeof(int32_t);
    const cudaError_t err = cudaFuncSetAttribute(
        fence_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(slsm::grid_for(q_n, kThreads), static_cast<unsigned>(d_n));
    fence_lookup_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(qs), static_cast<const int32_t*>(fences),
        static_cast<const int32_t*>(keys),
        static_cast<const int32_t*>(counts), static_cast<int32_t*>(out), q_n,
        f_n, cap, mu, d_shard, static_cast<int>(group),
        static_cast<int>(staged));
  }
  return static_cast<int>(cudaGetLastError());
}
