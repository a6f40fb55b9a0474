// lsm_attention: single-token GQA decode attention over a KV cache with a
// validity bitmap (the sLSM-tiered cache's `[hot | selected blocks]`, or
// a dense cache's prefix).
//
// Replaces repro/kernels/lsm_attention/lsm_attention.py
// `_decode_attn_kernel` (`decode_attention_pallas`). There the grid ran
// (batch, q-head, 512-position tiles) in order on one core, carrying the
// online softmax (m, l, acc) in VMEM scratch from tile to tile, and each
// q head read its kv head's K/V tiles again. Here:
//
//  * one CTA per (L-split, kv head x head pass, batch): the CTA's four
//    warps walk its chunk of positions, each warp one position at a time
//    (UNROLL positions per iteration, so several rows are in flight;
//    rows stay packed in registers until used),
//    and every K/V row read serves all P query heads of the pass — P is
//    the group H/KV when it is at most 4, so each K/V byte is read once
//    per kv head;
//  * a warp holds the P query vectors and its own (m, l, acc) in
//    registers, each lane a few packs of consecutive dims (up to 16
//    bytes a load), so that one load instruction of a warp reads a
//    contiguous stretch of one K or V row;
//  * the four warps merge their (m, l, acc) in shared memory; CTAs run
//    in parallel in no order, so each split's partial goes to a scratch
//    buffer and a second kernel merges them per (b, h) — the
//    flash-decode schedule.
//
// Bound: bytes. A decode step reads K and V once (2 * L * KV * dh
// elements) and does ~4 operations per element, far below Hopper's
// ratio of operations to bytes. Math is f32 (q, k, v upcast); the output
// is cast to q's dtype; a row with no valid position gives 0 (the
// denominator is clamped at 1e-30, as in the reference).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kCombineThreads = 256;
constexpr float kNegInf = -1e30f;

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
__device__ __forceinline__ Pack<T, N> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, N>*>(p);
}

template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zero_pack() {
  Pack<T, N> z;
#pragma unroll
  for (int e = 0; e < N; ++e) z.v[e] = from_f32<T>(0.f);
  return z;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Partial attention of P query heads over one chunk of positions.
// q (B, H, DH); k, v (B, L, KV, DH); valid (B, KV, L) int8.
// The partial (m, l, acc) of (b, h, split) lies at index
// (b * H + h) * splits + split.
template <typename T, int DH, int P>
__global__ void __launch_bounds__(kWarps * 32)
partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int8_t* __restrict__ valid,
               float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ acc_out, int H, int KV, int64_t L,
               int64_t chunk, float scale) {
  constexpr int DPL = DH >= 32 ? DH / 32 : 1;     // dims per lane
  // a lane's dims come in packs of up to 16 bytes: pack j of lane holds
  // dims (j * 32 + lane) * PACK + [0, PACK)
  constexpr int PACK = DPL * sizeof(T) <= 16 ? DPL : 16 / sizeof(T);
  constexpr int NPK = DPL / PACK;
  // rows in flight per warp: K and V rows stay packed (raw) in registers
  // until used, so more of them fit
  constexpr int UNROLL = DPL * sizeof(T) >= 16 ? 4 : 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int split = blockIdx.x;
  const int passes = (H / KV) / P;
  const int kvh = blockIdx.y / passes;
  const int h0 = kvh * (H / KV) + (blockIdx.y % passes) * P;
  const int64_t b = blockIdx.z;
  const bool lane_on = DH >= 32 || lane < DH;

  float qr[P][DPL], acc[P][DPL], m[P], l[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    m[p] = kNegInf;
    l[p] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) qr[p][i] = acc[p][i] = 0.f;
    if (lane_on) {
#pragma unroll
      for (int j = 0; j < NPK; ++j) {
        const Pack<T, PACK> qp = load_pack<T, PACK>(
            q + (b * H + h0 + p) * DH + (j * 32 + lane) * PACK);
#pragma unroll
        for (int e = 0; e < PACK; ++e) qr[p][j * PACK + e] = to_f32(qp.v[e]);
      }
    }
  }

  const int64_t start = split * chunk;
  const int64_t end = start + chunk < L ? start + chunk : L;
  const int8_t* vrow = valid + (b * KV + kvh) * L;
  const int64_t row_stride = static_cast<int64_t>(KV) * DH;
  const T* kb = k + (b * L * KV + kvh) * DH;
  const T* vb = v + (b * L * KV + kvh) * DH;

  for (int64_t base = start + warp * UNROLL; base < end;
       base += kWarps * UNROLL) {
    bool ok[UNROLL];
    Pack<T, PACK> kr[UNROLL][NPK], vr[UNROLL][NPK];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t pos = base + u;
      ok[u] = pos < end && vrow[pos] != 0;          // uniform over the warp
#pragma unroll
      for (int j = 0; j < NPK; ++j) {
        const int64_t at = pos * row_stride + (j * 32 + lane) * PACK;
        const bool on = ok[u] && lane_on;
        kr[u][j] = on ? load_pack<T, PACK>(kb + at) : zero_pack<T, PACK>();
        vr[u][j] = on ? load_pack<T, PACK>(vb + at) : zero_pack<T, PACK>();
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float s[UNROLL];
      float mx = m[p];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < NPK; ++j)
#pragma unroll
          for (int e = 0; e < PACK; ++e)
            d += qr[p][j * PACK + e] * to_f32(kr[u][j].v[e]);
        s[u] = warp_sum(d) * scale;
        if (ok[u]) mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[p] - mx);
      l[p] *= corr;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[p][i] *= corr;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const float e = ok[u] ? expf(s[u] - mx) : 0.f;
        l[p] += e;
#pragma unroll
        for (int j = 0; j < NPK; ++j)
#pragma unroll
          for (int x = 0; x < PACK; ++x)
            acc[p][j * PACK + x] += e * to_f32(vr[u][j].v[x]);
      }
      m[p] = mx;
    }
  }

  // merge the four warps' (m, l, acc) in shared memory: one partial per
  // (b, h, split)
  __shared__ float sm_m[kWarps][P], sm_l[kWarps][P];
  __shared__ float sm_acc[kWarps][P][DH];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (lane == 0) {
      sm_m[warp][p] = m[p];
      sm_l[warp][p] = l[p];
    }
    if (lane_on) {
#pragma unroll
      for (int j = 0; j < NPK; ++j)
#pragma unroll
        for (int e = 0; e < PACK; ++e)
          sm_acc[warp][p][(j * 32 + lane) * PACK + e] = acc[p][j * PACK + e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < P * DH; idx += kWarps * 32) {
    const int p = idx / DH, d = idx % DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][p]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][p] - mx);
      den += sm_l[w][p] * c;
      num += sm_acc[w][p][d] * c;
    }
    const int64_t part = (b * H + h0 + p) * gridDim.x + split;
    acc_out[part * DH + d] = num;
    if (d == 0) {
      m_out[part] = mx;
      l_out[part] = den;
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

// Merge the split partials of each (b, h): one CTA per (b, h). The
// rescale factors exp(m_i - max) go to shared memory once; then each
// thread sums its dims over the partials with independent loads.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ acc_in, T* __restrict__ out,
               int n_part, int DH) {
  extern __shared__ float fac[];
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
  for (int d = threadIdx.x; d < DH; d += blockDim.x) {
    float num = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_part; ++i)
      num += ap[static_cast<int64_t>(i) * DH + d] * fac[i];
    out[bh * DH + d] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v, *valid;
  void* out;
  float *m, *l, *acc;                      // split partials (scratch)
  int B, H, KV;
  int64_t L, splits, chunk;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DH, int P>
cudaError_t launch(const Args& a) {
  dim3 grid(static_cast<unsigned>(a.splits),
            static_cast<unsigned>(a.KV * ((a.H / a.KV) / P)),
            static_cast<unsigned>(a.B));
  partial_kernel<T, DH, P><<<grid, kWarps * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int8_t*>(a.valid), a.m,
      a.l, a.acc, a.H, a.KV, a.L, a.chunk, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<T><<<static_cast<unsigned>(a.B * a.H), kCombineThreads,
                      a.splits * sizeof(float), a.stream>>>(
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

// q, out (B, H, dh); k, v (B, L, KV, dh); valid (B, KV, L) int8; scratch
// m, l (B * H * splits) and acc (that times dh) f32, splits <= 1024.
// bf16 != 0 means q, k, v and out are bf16, else f32. `per_pass` query
// heads of a kv group share a CTA (it divides H / KV and is at most 4).
extern "C" int lsm_attention_launch(
    const void* q, const void* k, const void* v, const void* valid,
    void* out, void* m, void* l, void* acc, long long b, long long h,
    long long kv, long long len, long long dh, long long bf16,
    long long splits, long long chunk, long long per_pass, float scale,
    void* stream) {
  if (b <= 0 || len <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{q, k, v, valid, out, static_cast<float*>(m),
               static_cast<float*>(l), static_cast<float*>(acc),
               static_cast<int>(b), static_cast<int>(h), static_cast<int>(kv),
               len, splits, chunk, scale, static_cast<cudaStream_t>(stream)};
  const cudaError_t err =
      bf16 ? by_dim<__nv_bfloat16>(static_cast<int>(dh),
                                   static_cast<int>(per_pass), a)
           : by_dim<float>(static_cast<int>(dh), static_cast<int>(per_pass),
                           a);
  return static_cast<int>(err);
}
