// bloom_probe: batched Bloom-filter membership over a level's D runs.
//
// Replaces repro/kernels/bloom_probe/bloom_probe.py `_probe_kernel`
// (`bloom_probe_pallas`), which the reference launched once per run.
// One launch here covers a whole (D, W) stack: one thread per (run,
// query). Each thread hashes its key with Murmur3's finalizer in native
// uint32 arithmetic (wraparound is exact, trap T1), then tests up to k
// double-hashed bits, stopping at the first clear bit.
//
// Bound: bytes. The hash is a few dozen integer operations per key, the
// probes are scattered 4-byte reads of the filter words (a level-1 filter
// at the paper geometry is 1.45 MB a run, above a block's shared memory,
// so words come from device memory through the 50 MB L2, which holds a
// level's 20 filters). Queries of a block share one run (blockIdx.y), so
// the block's reads stay within one filter; the early exit makes a miss
// cost ~1-2 reads instead of k.
#include "common.cuh"

namespace {

constexpr uint32_t SEED1 = 0x9E3779B9u;
constexpr uint32_t SEED2 = 0x85EBCA77u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void bloom_probe_kernel(const int32_t* __restrict__ keys,
                                   const uint32_t* __restrict__ blooms,
                                   uint8_t* __restrict__ out, int64_t q_n,
                                   int64_t words, int k, uint32_t bits) {
  const int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x)
                    + threadIdx.x;
  const int64_t d = blockIdx.y;
  if (q >= q_n) return;
  const uint32_t u = static_cast<uint32_t>(keys[q]);
  const uint32_t h1 = fmix32(u ^ SEED1);
  const uint32_t h2 = fmix32(u ^ SEED2) | 1u;
  const uint32_t* w = blooms + d * words;
  uint8_t hit = 1;
  for (int i = 0; i < k; ++i) {
    const uint32_t pos = (h1 + static_cast<uint32_t>(i) * h2) % bits;
    if (!((__ldg(w + (pos >> 5)) >> (pos & 31u)) & 1u)) {
      hit = 0;
      break;
    }
  }
  out[d * q_n + q] = hit;
}

}  // namespace

// keys (Q,) int32, blooms (D, W) words, out (D, Q) bool.
extern "C" int bloom_probe_launch(const void* keys, const void* blooms,
                                  void* out, long long d_n, long long q_n,
                                  long long words, long long k,
                                  long long bits, void* stream) {
  if (d_n > 0 && q_n > 0) {
    constexpr unsigned kBlock = 256;
    dim3 grid(slsm::grid_for(q_n, kBlock), static_cast<unsigned>(d_n));
    bloom_probe_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys),
        static_cast<const uint32_t*>(blooms), static_cast<uint8_t*>(out),
        q_n, words, static_cast<int>(k), static_cast<uint32_t>(bits));
  }
  return static_cast<int>(cudaGetLastError());
}
