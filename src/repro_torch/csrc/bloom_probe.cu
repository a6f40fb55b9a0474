// bloom_probe: Bloom-filter membership of one lookup batch in every run of
// every disk level, in one launch — of one tree, or of S trees at once
// (the sharded engine's leading shard dimension).
//
// Replaces repro/kernels/bloom_probe/bloom_probe.py `_probe_kernel`
// (`bloom_probe_pallas`), which the reference launched once per run. Its
// function is kept: for level l, a (D_l, W_l) stack of filters with its
// own k_l and bits_l, out[row0_l + d, q] is set iff all k_l bits
// (h1 + i * h2) mod 2^32 mod bits_l (i < k_l) are set in filter d, h1/h2
// Murmur3's finalizer of key ^ SEED1 / key ^ SEED2 (| 1 on h2) in native
// uint32 arithmetic (wraparound is exact, trap T1). Each level's base
// pointer and geometry come by value in `Levels`; no filter is copied.
// With S shards (the reference vmaps the kernel over them) a level is an
// (S, D_l, W_l) stack, the keys an (S, Q) array, and shard s's runs read
// key row s: out[row0_l + s * D_l + d, q]. One tree is the S = 1 case.
//
// Bound: bytes, and under them latency. A probe is a scattered 4-byte read
// that moves a 32-byte sector (a level-1 filter at the paper geometry is
// 1.45 MB a run, above a block's shared memory; a level's filters sit in
// the 50 MB L2). The words a main-path batch needs take under 0.5 us at
// the memory rate, so a launch costs its start-up, its longest chain of
// dependent loads (a member's k probes) and the sectors' trips through
// L2. The design works on the first two:
//  * one launch a lookup batch, over every level, so the start-up and
//    the longest chain are paid once, not once a level;
//  * a thread takes one query and a group of kGroup runs of one level;
//    it reads and hashes its key once (h1, h2 and, within a level, every
//    probe position are the same for every run) and advances the group's
//    chains together: step i loads word i of every chain still alive,
//    so up to kGroup independent loads are in flight, and a chain stops
//    at its first clear bit, reading exactly the words an early-exit
//    chain reads;
//  * a chain that survives kBurst probes loads its remaining probes at
//    once, kChunk steps of its group a batch: a member's chain is then
//    kBurst + ceil((k - kBurst) / kChunk) dependent loads, not k. The
//    extra words are read only by chains that would have stopped after
//    kBurst (about 2^-kBurst of non-members at half-full filters).
//    kBurst >= 32 turns it off.
// CTAs tile (level, shard, run group) x kBlock queries — a group never
// spans two shards, so its runs share one key; stores are bytes,
// coalesced along q. The schedule (kGroup 2, kBurst 4, kChunk 8, kBlock
// 128) was chosen on an H100 by tools/bloom_probe_schedules.py, which
// builds this file with other -DBLOOM_* values: more runs a thread or
// larger CTAs leave too few warps (or too few CTAs for 132 SMs) to hide
// the loads' latency; a burst after 3 probes reads too many extra words
// where the filters are cold in device memory.
#include "common.cuh"

#ifndef BLOOM_GROUP
#define BLOOM_GROUP 2
#endif
#ifndef BLOOM_BURST
#define BLOOM_BURST 4
#endif
#ifndef BLOOM_CHUNK
#define BLOOM_CHUNK 8
#endif
#ifndef BLOOM_BLOCK
#define BLOOM_BLOCK 128
#endif

namespace {

constexpr uint32_t SEED1 = 0x9E3779B9u;
constexpr uint32_t SEED2 = 0x85EBCA77u;
constexpr int kMaxLevels = 16;      // kernels/bloom_probe/ops.py MAX_LEVELS
constexpr int kGroup = BLOOM_GROUP;
constexpr int kBurst = BLOOM_BURST;
constexpr int kChunk = BLOOM_CHUNK;
constexpr unsigned kBlock = BLOOM_BLOCK;
static_assert(kGroup >= 1 && kGroup <= 32, "a group's chains fit a mask");

struct Level {
  const uint32_t* blooms;  // (n_shards, d_n, words) filters
  long long words;
  uint32_t bits;           // effective width, <= 32 * words
  int k;
  int d_n;                 // runs a shard
  int groups;              // run groups a shard, ceil(d_n / kGroup)
  int row0;                // first output row
  int group0;              // first run group (blockIdx.y)
};

struct Levels {
  Level level[kMaxLevels];
  int n;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(kBlock)
bloom_probe_levels_kernel(const int32_t* __restrict__ keys,
                          uint8_t* __restrict__ out, long long q_n,
                          const __grid_constant__ Levels lv) {
  const int g = blockIdx.y;
  int l = 0;
  while (l + 1 < lv.n && lv.level[l + 1].group0 <= g) ++l;
  const long long q = blockIdx.x * static_cast<long long>(kBlock)
                      + threadIdx.x;
  if (q >= q_n) return;
  const Level& L = lv.level[l];
  const long long words = L.words;
  const uint32_t bits = L.bits;
  const int k = L.k;
  const int s = (g - L.group0) / L.groups;
  const int d0 = (g - L.group0) % L.groups * kGroup;
  const int nr = min(kGroup, L.d_n - d0);
  const long long run0 = static_cast<long long>(s) * L.d_n + d0;
  const uint32_t* w = L.blooms + run0 * words;
  const uint32_t u = static_cast<uint32_t>(keys[s * q_n + q]);
  const uint32_t h1 = fmix32(u ^ SEED1);
  const uint32_t h2 = fmix32(u ^ SEED2) | 1u;

  uint32_t alive = nr >= 32 ? ~0u : (1u << nr) - 1u;
  int i = 0;
  // the chains in step: one load per live chain, all in flight at once
  for (; i < k && i < kBurst && alive; ++i) {
    const uint32_t pos = (h1 + static_cast<uint32_t>(i) * h2) % bits;
    uint32_t v[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      v[r] = (alive >> r) & 1u ? __ldg(w + r * words + (pos >> 5)) : ~0u;
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
      if (!((v[r] >> (pos & 31u)) & 1u)) alive &= ~(1u << r);
  }
  // the survivors' remaining probes, kChunk steps a batch: which chains
  // load is fixed at entry, so no load waits on another's bit
  if (alive && i < k) {
    const uint32_t live = alive;
    for (; i < k; i += kChunk) {
      uint32_t v[kChunk][kGroup];
      uint32_t sh[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const uint32_t pos =
            (h1 + static_cast<uint32_t>(i + c) * h2) % bits;
        sh[c] = pos & 31u;
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          v[c][r] = i + c < k && ((live >> r) & 1u)
                        ? __ldg(w + r * words + (pos >> 5)) : ~0u;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          if (!((v[c][r] >> sh[c]) & 1u)) alive &= ~(1u << r);
    }
  }
  uint8_t* o = out + (L.row0 + run0) * q_n + q;
#pragma unroll
  for (int r = 0; r < kGroup; ++r)
    if (r < nr) o[r * q_n] = (alive >> r) & 1u;
}

}  // namespace

// keys (S, Q) int32; desc: n_levels rows of five int64 (filters' device
// address, D, W, k, bits), level l's filters (S, D_l, W_l); out
// (S * sum D, Q) bool, level l's (S, D_l) rows after those of the levels
// before it.
extern "C" int bloom_probe_shards_launch(const void* keys, void* out,
                                         const void* desc,
                                         long long n_levels, long long q_n,
                                         long long n_shards, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_shards < 1)
    return cudaErrorInvalidValue;
  Levels lv{};
  lv.n = static_cast<int>(n_levels);
  const long long* row = static_cast<const long long*>(desc);
  long long rows = 0, groups = 0;
  for (int l = 0; l < lv.n; ++l, row += 5) {
    Level& L = lv.level[l];
    L.blooms = reinterpret_cast<const uint32_t*>(row[0]);
    L.d_n = static_cast<int>(row[1]);
    L.words = row[2];
    L.k = static_cast<int>(row[3]);
    L.bits = static_cast<uint32_t>(row[4]);
    L.groups = (L.d_n + kGroup - 1) / kGroup;
    L.row0 = static_cast<int>(rows);
    L.group0 = static_cast<int>(groups);
    rows += n_shards * L.d_n;
    groups += n_shards * L.groups;
  }
  if (groups > 65535 || rows > INT32_MAX) return cudaErrorInvalidValue;
  if (groups > 0 && q_n > 0) {
    dim3 grid(slsm::grid_for(q_n, kBlock), static_cast<unsigned>(groups));
    bloom_probe_levels_kernel<<<grid, kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(keys), static_cast<uint8_t*>(out), q_n,
        lv);
  }
  return static_cast<int>(cudaGetLastError());
}

// One tree: keys (Q,), level l's filters (D_l, W_l), out (sum D, Q).
extern "C" int bloom_probe_levels_launch(const void* keys, void* out,
                                         const void* desc,
                                         long long n_levels, long long q_n,
                                         void* stream) {
  return bloom_probe_shards_launch(keys, out, desc, n_levels, q_n, 1, stream);
}

// The compile-time schedule, for tools that build variants of this file.
extern "C" int bloom_probe_schedule(int* group, int* burst, int* chunk,
                                    int* block) {
  *group = kGroup;
  *burst = kBurst;
  *chunk = kChunk;
  *block = static_cast<int>(kBlock);
  return kMaxLevels;
}
