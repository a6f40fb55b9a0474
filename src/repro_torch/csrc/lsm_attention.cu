// lsm_attention: single-token GQA decode attention over a KV cache: the
// sLSM-tiered cache's `[hot window | selected cold blocks]` read in
// place, a dense cache's prefix, or any K/V under a validity bitmap.
//
// Replaces repro/kernels/lsm_attention/lsm_attention.py
// `_decode_attn_kernel` (`decode_attention_pallas`). There the grid ran
// (batch, q-head, 512-position tiles) in order on one core, carrying the
// online softmax (m, l, acc) in VMEM scratch from tile to tile, over a
// K/V tensor that the caller had gathered and padded. Here:
//
//  * one CTA per (chunk of positions, kv head x head pass, batch); every
//    K/V row it reads serves all P query heads of the pass (P is the
//    group H/KV when it is at most 4), so each byte is read once;
//  * a CTA's chunk lies in one segment, and the CTA resolves its own
//    rows: in the tiered mode a hot chunk reads hot rows below
//    hot_len[b], a block chunk reads rows of block ids[b, kv, t] when
//    ok[b, kv, t] — hot and block rows share the row stride KV * dh, so
//    a CTA streams rows at one base and one stride; the dense mode reads
//    rows below lengths[b]; the bitmap mode reads rows whose byte is
//    set. No row, tile or block that is invalid is fetched: the copy of
//    an invalid row reads 0 bytes and fills zeros;
//  * rows stream through shared memory in tiles of 32, in a ring of 2-3
//    stages of `cp.async` copies, so the next tiles' loads are in
//    flight while the CTA computes on this one;
//  * scores: eight threads per row (eight warps), each every eighth of
//    the row's 16-byte chunks (rows padded by 64 bytes in shared memory,
//    so a warp's chunk reads hit distinct banks), three shuffles to
//    finish a dot product; every warp then takes the tile's 32 scores
//    (one a lane) to one max and one sum per head, the same in every
//    warp, and adds its 4 rows of V times exp(s - m) into its own
//    accumulator (each lane a run of DH/32 dims);
//  * the warps' accumulators share (m, l), so they add in shared
//    memory; each chunk's partial goes to scratch and a second kernel
//    merges the partials of each (b, h) — the flash-decode schedule.
//
// Bound: bytes. A decode step reads K and V once for each valid row (2 *
// rows * dh elements) and does ~4 operations per element, far below
// Hopper's ratio of operations to bytes. Math is f32 (q, k, v upcast);
// the output is cast to q's dtype; a row with no valid position gives 0
// (the denominator is clamped at 1e-30, as in the reference).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32;                 // rows a tile
constexpr int kTpr = kThreads / kRows;    // scoring threads a row
constexpr int kCombineThreads = 512;
constexpr float kNegInf = -1e30f;

enum Mode { kBitmap = 0, kLengths = 1, kTiered = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N consecutive elements, loaded as one access of up to 16 bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> load_pack(const void* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

__device__ __forceinline__ void copy16(void* dst, const void* src, bool on) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = on ? 16 : 0;             // 0 bytes read: zeros land
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Shared-memory geometry of one (dtype, head dim).
template <typename T, int DH>
struct Geo {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;   // 16-byte chunks a row
  static constexpr int kEpc = 16 / static_cast<int>(sizeof(T));
  static constexpr int kQuarter = (kChunks + kTpr - 1) / kTpr;  // a thread
  static constexpr int kStride = kRowBytes + 64;   // padded row
  static constexpr int kStageBytes = 2 * kRows * kStride;   // K and V
  static constexpr int kStages = kStageBytes <= 24 * 1024 ? 3 : 2;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kDpl = DH >= 32 ? DH / 32 : 1;  // V dims a lane
  static constexpr int kPack =
      kDpl * static_cast<int>(sizeof(T)) <= 16 ? kDpl : kEpc;
};

struct Args {
  const void *q, *k, *v, *blk_k, *blk_v;
  const int8_t* valid;                     // bitmap mode (B, KV, L)
  const int32_t* lens;                     // lengths (B,) or hot_len (B,)
  const int64_t* ids;                      // tiered (B, KV, topk)
  const bool* ok;                          // tiered (B, KV, topk)
  void* out;
  float *m, *l, *acc;                      // chunk partials (scratch)
  int B, H, KV, mode;
  int64_t L;                               // cache length, or W (tiered)
  int64_t nb, mu, topk, splits, chunk;
  float scale;
  cudaStream_t stream;
};

// Partial attention of P query heads over one chunk of positions. The
// partial (m, l, acc) of (b, h, chunk) lies at (b * H + h) * splits +
// chunk.
template <typename T, int DH, int P>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const Args a) {
  using G = Geo<T, DH>;
  constexpr bool kQReg = P * G::kQuarter * G::kEpc <= 48;
  static_assert(kWarps * P * DH * 4 <= G::kSmem, "sums fit the stages");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float sc[P][kRows];
  __shared__ int8_t flag[G::kStages][kRows];
  __shared__ float qs[kQReg ? 1 : P][kQReg ? 1 : DH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int passes = (a.H / a.KV) / P;
  const int kvh = blockIdx.y / passes;
  const int h0 = kvh * (a.H / a.KV) + (blockIdx.y % passes) * P;
  const int64_t b = blockIdx.z;
  const int64_t row_stride = static_cast<int64_t>(a.KV) * DH;

  // this CTA's rows: [0, n) at kb / vb with stride row_stride
  const T* kb = static_cast<const T*>(a.k);
  const T* vb = static_cast<const T*>(a.v);
  const int8_t* bitmap = nullptr;
  int64_t n;
  if (a.mode != kTiered) {
    const int64_t start = split * a.chunk;
    int64_t end = start + a.chunk < a.L ? start + a.chunk : a.L;
    if (a.mode == kLengths && a.lens[b] < end) end = a.lens[b];
    n = end > start ? end - start : 0;
    kb += ((b * a.L + start) * a.KV + kvh) * DH;
    vb += ((b * a.L + start) * a.KV + kvh) * DH;
    if (a.mode == kBitmap) bitmap = a.valid + (b * a.KV + kvh) * a.L + start;
  } else if (split < a.L / a.chunk) {      // hot window
    const int64_t start = split * a.chunk;
    const int64_t end = start + a.chunk < a.lens[b] ? start + a.chunk
                                                    : a.lens[b];
    n = end > start ? end - start : 0;
    kb += ((b * a.L + start) * a.KV + kvh) * DH;
    vb += ((b * a.L + start) * a.KV + kvh) * DH;
  } else {                                 // a selected cold block
    const int64_t u = split - a.L / a.chunk, per = a.mu / a.chunk;
    const int64_t t = u / per, r0 = (u % per) * a.chunk;
    const int64_t sel = (b * a.KV + kvh) * a.topk + t;
    n = a.ok[sel] ? a.chunk : 0;
    if (n) {
      const int64_t at = (((b * a.nb + a.ids[sel]) * a.mu + r0) * a.KV + kvh)
                         * DH;
      kb = static_cast<const T*>(a.blk_k) + at;
      vb = static_cast<const T*>(a.blk_v) + at;
    }
  }
  const int ntiles = static_cast<int>((n + kRows - 1) / kRows);

  auto load_tile = [&](int tile) {
    unsigned char* ks = smem + (tile % G::kStages) * G::kStageBytes;
    unsigned char* vs = ks + kRows * G::kStride;
    for (int i = tid; i < kRows * G::kChunks; i += kThreads) {
      const int r = i / G::kChunks, c = i % G::kChunks;
      const int64_t row = static_cast<int64_t>(tile) * kRows + r;
      bool on = row < n;
      if (on && bitmap) on = bitmap[row] != 0;
      const int64_t at = on ? row * row_stride + c * G::kEpc : 0;
      copy16(ks + r * G::kStride + c * 16, kb + at, on);
      copy16(vs + r * G::kStride + c * 16, vb + at, on);
      if (c == 0) flag[tile % G::kStages][r] = on;
    }
  };
#pragma unroll
  for (int t = 0; t < G::kStages - 1; ++t) {
    if (t < ntiles) load_tile(t);
    copy_commit();
  }

  // q: a scoring thread (row tid / kTpr, j = tid % kTpr) uses chunks j,
  // j + kTpr, ...
  const int j = tid % kTpr, srow = tid / kTpr;
  float qr[kQReg ? P : 1][kQReg ? G::kQuarter * G::kEpc : 1];
  const T* qg = static_cast<const T*>(a.q) + (b * a.H + h0) * DH;
  if constexpr (kQReg) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < G::kQuarter; ++i)
#pragma unroll
        for (int e = 0; e < G::kEpc; ++e) {
          const int c = j + kTpr * i;
          qr[p][i * G::kEpc + e] =
              c < G::kChunks ? to_f32(qg[p * DH + c * G::kEpc + e]) : 0.f;
        }
  } else {
    for (int i = tid; i < P * DH; i += kThreads)
      qs[i / DH][i % DH] = to_f32(qg[i]);
  }

  float m[P], l[P], acc[P][G::kDpl];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    m[p] = kNegInf;
    l[p] = 0.f;
#pragma unroll
    for (int i = 0; i < G::kDpl; ++i) acc[p][i] = 0.f;
  }
  const bool lane_on = lane * G::kDpl < DH;

  for (int t = 0; t < ntiles; ++t) {
    copy_wait<G::kStages - 2>();
    __syncthreads();                       // tile t landed; t-1 consumed
    if (t + G::kStages - 1 < ntiles) load_tile(t + G::kStages - 1);
    copy_commit();
    const int st = t % G::kStages;
    const unsigned char* ks = smem + st * G::kStageBytes;
    const unsigned char* vs = ks + kRows * G::kStride;

    {  // scores of the tile's 32 rows
      float d[P];
#pragma unroll
      for (int p = 0; p < P; ++p) d[p] = 0.f;
#pragma unroll
      for (int i = 0; i < G::kQuarter; ++i) {
        const int c = j + kTpr * i;
        if (c < G::kChunks) {
          const Pack<T, G::kEpc> kp = load_pack<T, G::kEpc>(
              ks + srow * G::kStride + c * 16);
#pragma unroll
          for (int e = 0; e < G::kEpc; ++e) {
            const float kf = to_f32(kp.v[e]);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              if constexpr (kQReg)
                d[p] += qr[p][i * G::kEpc + e] * kf;
              else
                d[p] += qs[p][c * G::kEpc + e] * kf;
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int o = 1; o < kTpr; o <<= 1)
          d[p] += __shfl_xor_sync(0xffffffffu, d[p], o);
        if (j == 0) sc[p][srow] = d[p] * a.scale;
      }
    }
    __syncthreads();

    {  // online softmax over the tile; this warp's 8 rows into acc
      const bool on = flag[st][lane] != 0;
      float ep[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float s = on ? sc[p][lane] : kNegInf;
        const float mx = fmaxf(m[p], warp_max(s));
        ep[p] = on ? expf(s - mx) : 0.f;
        const float corr = expf(m[p] - mx);
        l[p] = l[p] * corr + warp_sum(ep[p]);
        m[p] = mx;
#pragma unroll
        for (int i = 0; i < G::kDpl; ++i) acc[p][i] *= corr;
      }
#pragma unroll
      for (int rr = 0; rr < kRows / kWarps; ++rr) {
        const int r = warp * (kRows / kWarps) + rr;
        float er[P];
#pragma unroll
        for (int p = 0; p < P; ++p)
          er[p] = __shfl_sync(0xffffffffu, ep[p], r);
        if (lane_on) {
#pragma unroll
          for (int x = 0; x < G::kDpl / G::kPack; ++x) {
            const Pack<T, G::kPack> vp = load_pack<T, G::kPack>(
                vs + r * G::kStride
                + (lane * G::kDpl + x * G::kPack) * sizeof(T));
#pragma unroll
            for (int e = 0; e < G::kPack; ++e) {
              const float vf = to_f32(vp.v[e]);
#pragma unroll
              for (int p = 0; p < P; ++p)
                acc[p][x * G::kPack + e] += er[p] * vf;
            }
          }
        }
      }
    }
  }
  copy_wait<0>();
  __syncthreads();                         // stages free: reuse as sums

  // every warp holds the same (m, l); the accumulators add
  float* red = reinterpret_cast<float*>(smem);   // (kWarps, P, DH)
  if (lane_on) {
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int i = 0; i < G::kDpl; ++i)
        red[(warp * P + p) * DH + lane * G::kDpl + i] = acc[p][i];
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int64_t part = (b * a.H + h0 + p) * gridDim.x + split;
    for (int d = tid; d < DH; d += kThreads) {
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) num += red[(w * P + p) * DH + d];
      a.acc[part * DH + d] = num;
    }
    if (tid == 0) {
      a.m[part] = m[p];
      a.l[part] = l[p];
    }
  }
}

__device__ __forceinline__ float block_reduce(float x, bool is_max,
                                              float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = is_max ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                        // red may hold an earlier result
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = is_max ? kNegInf : 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Merge the chunk partials of each (b, h): one CTA per (b, h). The
// rescale factors exp(m_i - max) go to shared memory once; then thread
// t sums dim t % DH over every (threads / DH)-th partial, so many loads
// are in flight, and the slices add in shared memory.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ acc_in, T* __restrict__ out,
               int n_part, int DH) {
  extern __shared__ float fac[];          // (n_part,), then (slices, DH)
  __shared__ float red[kCombineThreads / 32];
  const int64_t bh = blockIdx.x;
  const float* mp = m_in + bh * n_part;
  const float* lp = l_in + bh * n_part;
  float mx = kNegInf;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x)
    mx = fmaxf(mx, mp[i]);
  mx = block_reduce(mx, true, red);
  float den = 0.f;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x) {
    const float c = expf(mp[i] - mx);
    fac[i] = c;
    den += lp[i] * c;
  }
  den = block_reduce(den, false, red);    // also orders the fac writes
  const float* ap = acc_in + bh * n_part * DH;
  const int slices = blockDim.x >= DH ? blockDim.x / DH : 1;
  float* part = fac + n_part;
  if (static_cast<int>(threadIdx.x) < slices * DH) {
    const int slice = threadIdx.x / DH;
    for (int d = threadIdx.x % DH; d < DH; d += blockDim.x) {
      float num = 0.f;
#pragma unroll 8
      for (int i = slice; i < n_part; i += slices)
        num += ap[static_cast<int64_t>(i) * DH + d] * fac[i];
      part[slice * DH + d] = num;
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float num = 0.f;
    for (int x = 0; x < slices; ++x) num += part[x * DH + d];
    out[bh * DH + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int DH, int P>
cudaError_t launch(const Args& a) {
  static bool sized = false;              // opt in to > 48 KB once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        partial_kernel<T, DH, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Geo<T, DH>::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid(static_cast<unsigned>(a.splits),
            static_cast<unsigned>(a.KV * ((a.H / a.KV) / P)),
            static_cast<unsigned>(a.B));
  partial_kernel<T, DH, P><<<grid, kThreads, Geo<T, DH>::kSmem, a.stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int slices = kCombineThreads >= DH ? kCombineThreads / DH : 1;
  combine_kernel<T><<<static_cast<unsigned>(a.B * a.H), kCombineThreads,
                      (a.splits + slices * DH) * sizeof(float), a.stream>>>(
      a.m, a.l, a.acc, static_cast<T*>(a.out), static_cast<int>(a.splits),
      DH);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t by_pass(int per_pass, const Args& a) {
  switch (per_pass) {
    case 1: return launch<T, DH, 1>(a);
    case 2: return launch<T, DH, 2>(a);
    case 3: return launch<T, DH, 3>(a);
    case 4: return launch<T, DH, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(int dh, int per_pass, const Args& a) {
  switch (dh) {
    case 16: return by_pass<T, 16>(per_pass, a);
    case 64: return by_pass<T, 64>(per_pass, a);
    case 128: return by_pass<T, 128>(per_pass, a);
    case 256: return by_pass<T, 256>(per_pass, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out (B, H, dh). mode 0 (bitmap): k, v (B, L, KV, dh), valid
// (B, KV, L) int8. mode 1 (lengths): k, v as mode 0, lens (B,) int32.
// mode 2 (tiered): k, v the hot window (B, L = W, KV, dh), lens hot_len
// (B,) int32, blk_k, blk_v (B, nb, mu, KV, dh), ids (B, KV, topk) int64,
// ok (B, KV, topk) bool; `chunk` divides W and mu and splits = W / chunk
// + topk * mu / chunk. Scratch m, l (B * H * splits) and acc (that
// times dh) f32, splits <= 1024. bf16 != 0 means q, k, v and out are
// bf16, else f32. `per_pass` query heads of a kv group share a CTA (it
// divides H / KV and is at most 4).
extern "C" int lsm_attention_launch(
    const void* q, const void* k, const void* v, const void* blk_k,
    const void* blk_v, const void* valid, const void* lens, const void* ids,
    const void* ok, void* out, void* m, void* l, void* acc, long long mode,
    long long b, long long h, long long kv, long long len, long long dh,
    long long bf16, long long nb, long long mu, long long topk,
    long long splits, long long chunk, long long per_pass, float scale,
    void* stream) {
  if (b <= 0 || splits <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, blk_k, blk_v,
               static_cast<const int8_t*>(valid),
               static_cast<const int32_t*>(lens),
               static_cast<const int64_t*>(ids),
               static_cast<const bool*>(ok), out, static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(acc),
               static_cast<int>(b), static_cast<int>(h), static_cast<int>(kv),
               static_cast<int>(mode), len, nb, mu, topk, splits, chunk,
               scale, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      bf16 ? by_dim<__nv_bfloat16>(static_cast<int>(dh),
                                   static_cast<int>(per_pass), a)
           : by_dim<float>(static_cast<int>(dh), static_cast<int>(per_pass),
                           a);
  return static_cast<int>(err);
}
