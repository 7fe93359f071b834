// Split-KV flash-decode attention over a dense per-slot KV cache for
// Hopper (sm_90a), float32 or bfloat16, head dim 64 or 128.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// `_decode_kernel` (called through `decode_attention`).
//
// Computes, for every slot b and KV head kh, the attention of the G query
// rows of that head group (q (B, KH, G, D)) over the slot's first
// kv_len[b] cached tokens (k, v (B, KH, T, D), any strides with the head
// dim contiguous: the engine passes its (B, T, KH, D) cache transposed,
// without a copy).  Output (B, KH, G, D) in q's type.  Any T: the TPU
// kernel's T % block_k rule does not apply.
//
// What bounds it on the H100: bytes.  Each query row does 4*D flops per
// cached token against 2*D*sizeof(cache) bytes of K and V, one flop per
// byte or less.  At serving's sizes (a few MB of live cache) the time is
// latency: how many of the live bytes are in flight at once.  The design:
//   * the KV axis is split into small fixed ranges (`chunk`, 64 tokens
//     unless the grid would pass ~16 CTAs per SM), one CTA per (range, b,
//     kh): the live ranges alone spread over hundreds of CTAs, and a range
//     at or past its slot's kv_len exits at once;
//   * a CTA walks its range in 32-token tiles through a two-stage ring in
//     shared memory, K and V copied in their own dtype by 16-byte cp.async
//     (element loads where a stride is not a 16-byte multiple), the next
//     tile's copy in flight during this tile's products;
//   * the G query rows of a KV head share every tile; each warp owns 8 of
//     a tile's tokens, 4 at a time: 8 lanes run across D with vector
//     loads and three shuffles finish each dot product; the online softmax
//     gives one lane per token; each thread then owns 4 columns of up to
//     4 query rows of the output;
//   * a slot whose row fits one range is finished by its CTA.  Otherwise
//     each CTA writes float32 partials (m, l, acc) and the last CTA of the
//     (b, kh), found by an atomic ticket that it resets for the next call,
//     combines the ranges with the usual rescaling by exp(m_i - max m),
//     divided by max(l, 1e-30) (one launch: a second combine launch
//     measured slower at every serving shape).
// Masked positions never enter the sums (the reference masks them with
// -1e30); a slot with kv_len 0 gets zeros, as the TPU kernel gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;     // tokens per stage of the ring
constexpr int kStages = 2;
constexpr int kRows = 4;      // query rows per thread in P V: G * D <= 2048
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

// four consecutive elements as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// tokens t0 .. t0 + n - 1 of a (T, D) slab with row stride st into a
// (kTile, D) stage; rows past n are zero (their probability is 0, and 0
// times an unset value could be NaN)
template <typename T, int D, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long st, int t0, int n) {
  constexpr int EPC = 16 / sizeof(T);       // elements per 16-byte chunk
  constexpr int CPR = D / EPC;              // chunks per row
  for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
    const int t = i / CPR, c = i % CPR;
    const bool ok = t < n;
    const T* s = src + (t0 + t) * st + c * EPC;
    if (VEC) {
      cp_async16(dst + t * D + c * EPC, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) dst[t * D + c * EPC + e] = ok ? s[e] : T(0.f);
    }
  }
}

// floats of one range's partials: acc (G x D), then m and l (G each),
// padded to whole float4s
__host__ __device__ __forceinline__ int part_stride(int G, int D) {
  return G * D + (2 * G + 3) / 4 * 4;
}

// out of one (b, kh) from its `live` partials, 4 columns a thread: one
// pass of online merging over the ranges, 8 ranges' loads in flight at once
template <typename T>
__device__ void combine(const float* __restrict__ part, T* __restrict__ out,
                        int G, int D, int live) {
  constexpr int U = 8;
  const int stride = part_stride(G, D), GD = G * D;
  for (int j = threadIdx.x * 4; j < GD; j += kThreads * 4) {
    const int g = j / D;
    float M = -INFINITY, L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < live; i0 += U) {
      float mv[U], lv[U];
      float4 av[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = i0 + u < live;
        const float* p = part + static_cast<size_t>(i0 + u) * stride;
        mv[u] = ok ? __ldcg(p + GD + g) : -INFINITY;
        lv[u] = ok ? __ldcg(p + GD + G + g) : 0.f;
        av[u] = ok ? __ldcg(reinterpret_cast<const float4*>(p + j))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mx = M;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, mv[u]);
      const float r = exp2f(M - mx);      // every live range has a finite m
      L *= r;
      A.x *= r; A.y *= r; A.z *= r; A.w *= r;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float w = exp2f(mv[u] - mx);
        L = fmaf(lv[u], w, L);
        A.x = fmaf(av[u].x, w, A.x);
        A.y = fmaf(av[u].y, w, A.y);
        A.z = fmaf(av[u].z, w, A.z);
        A.w = fmaf(av[u].w, w, A.w);
      }
      M = mx;
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    from_f(A.x * inv, out + j);
    from_f(A.y * inv, out + j + 1);
    from_f(A.z * inv, out + j + 2);
    from_f(A.w * inv, out + j + 3);
  }
}

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ kv_len, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int KH, int G,
    int Tk, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int chunk, int splits, float scale_log2) {
  constexpr int NC = D / 32;                // 4-column chunks a lane in Q K^T
  constexpr int DQ = D / 4;                 // threads per row in P V
  constexpr int NGS = kThreads / DQ;        // rows in flight in P V
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / KH, kh = bh % KH;
  const int len = min(max(kv_len[b], 0), Tk);
  const int live = (len + chunk - 1) / chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* ob = out + static_cast<size_t>(bh) * G * D;
  if (split >= live) {                      // a dead range: nothing to do,
    if (len == 0 && split == 0)             // but an empty row is zeros
      for (int j = tid; j < G * D; j += kThreads) from_f(0.f, ob + j);
    return;
  }
  const int start = split * chunk, end = min(len, start + chunk);
  const int n_tiles = (end - start + kTile - 1) / kTile;

  extern __shared__ float4 smem4[];
  T* kv_s = reinterpret_cast<T*>(smem4);    // kStages x (K, V) x kTile x D
  float* q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTile * D);
  float* p_s = q_s + G * D;                 // G x kTile
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  __shared__ int last;

  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
#pragma unroll
  for (int s = 0; s < kStages; ++s) {       // prologue: fill the ring
    const int t0 = start + s * kTile;
    if (s < n_tiles) {
      T* st = kv_s + s * 2 * kTile * D;
      load_tile<T, D, VEC>(st, kb, kst, t0, min(kTile, end - t0));
      load_tile<T, D, VEC>(st + kTile * D, vb, vst, t0, min(kTile, end - t0));
    }
    cp_async_commit();
  }
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_f(q[static_cast<size_t>(bh) * G * D + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  const int dq = tid % DQ, gs = tid / DQ;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, t0 = start + it * kTile;
    const int n = min(kTile, end - t0);
    const T* k_t = kv_s + s * 2 * kTile * D;
    const T* v_t = k_t + kTile * D;
    cp_async_wait<kStages - 1>();
    __syncthreads();

    // scores: warp w takes tokens 8w .. 8w + 7, four at a time, one per
    // group of 8 lanes; lane s of a group holds the 4-column chunks s + 8c
    // (c rotated by the group, so the groups read different banks) and
    // three shuffles finish each dot product
#pragma unroll
    for (int pass = 0; pass < kTile / kWarps / 4; ++pass) {
      const int grp = lane / 8, sub = lane % 8;
      const int t = warp * (kTile / kWarps) + pass * 4 + grp;
      float4 kr[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kr[c] = load4(k_t + t * D + 4 * (sub + 8 * ((c + grp) % NC)));
      for (int g = 0; g < G; ++g) {
        const float* qr = q_s + g * D + 4 * sub;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(qr + 32 * ((c + grp) % NC));
          d = fmaf(x.x, kr[c].x, d);
          d = fmaf(x.y, kr[c].y, d);
          d = fmaf(x.z, kr[c].z, d);
          d = fmaf(x.w, kr[c].w, d);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (sub == 0) p_s[g * kTile + t] = t < n ? d * scale_log2 : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax in log2 units: one warp per query row, a lane per token
    for (int g = warp; g < G; g += kWarps) {
      const float x = p_s[g * kTile + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = exp2f(x - m_new);
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P V: this thread's 4 columns of rows gs, gs + NGS, ...
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int g = gs + r * NGS;
      if (g < G) {
        const float alpha = a_s[g];
        float a0 = acc[r][0] * alpha, a1 = acc[r][1] * alpha;
        float a2 = acc[r][2] * alpha, a3 = acc[r][3] * alpha;
        const float* pr = p_s + g * kTile;
        for (int t = 0; t < n; ++t) {
          const float p = pr[t];
          const float4 x = load4(v_t + t * D + dq * 4);
          a0 = fmaf(p, x.x, a0);
          a1 = fmaf(p, x.y, a1);
          a2 = fmaf(p, x.z, a2);
          a3 = fmaf(p, x.w, a3);
        }
        acc[r][0] = a0; acc[r][1] = a1; acc[r][2] = a2; acc[r][3] = a3;
      }
    }
    __syncthreads();                        // stage s and p_s are free

    if (it + kStages < n_tiles) {
      const int tn = t0 + kStages * kTile;
      T* st = kv_s + s * 2 * kTile * D;
      load_tile<T, D, VEC>(st, kb, kst, tn, min(kTile, end - tn));
      load_tile<T, D, VEC>(st + kTile * D, vb, vst, tn, min(kTile, end - tn));
    }
    cp_async_commit();                      // (empty groups keep the count)
  }

  if (live == 1) {                          // the whole row: finish here
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int g = gs + r * NGS;
      if (g < G) {
        const float inv = 1.f / fmaxf(l_s[g], 1e-30f);
#pragma unroll
        for (int e = 0; e < 4; ++e) from_f(acc[r][e] * inv, ob + g * D + dq * 4 + e);
      }
    }
    return;
  }
  const int stride = part_stride(G, D);
  float* pb = part + static_cast<size_t>(bh) * splits * stride;
  float* pp = pb + static_cast<size_t>(split) * stride;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int g = gs + r * NGS;
    if (g < G)
      *reinterpret_cast<float4*>(pp + g * D + dq * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  for (int g = tid; g < G; g += kThreads) {
    pp[G * D + g] = m_s[g];
    pp[G * D + G + g] = l_s[g];
  }
  __threadfence();                          // partials visible, then ticket
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine<T>(pb, ob, G, D, live);
  if (tid == 0) tickets[bh] = 0;            // ready for the next call
}

template <typename T, int D, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* part, void* tickets,
                   int B, int KH, int G, int Tk, long long ksb, long long ksh,
                   long long kst, long long vsb, long long vsh, long long vst,
                   int chunk, int splits, cudaStream_t stream) {
  const int smem = static_cast<int>(kStages * 2 * kTile * D * sizeof(T) +
                                    sizeof(float) * (G * D + G * kTile + 3 * G));
  auto kernel = decode_split_kernel<T, D, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, B * KH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), KH, G, Tk, ksb, ksh, kst, vsb, vsh, vst,
      chunk, splits, kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch(bool vec, const void* q, const void* k, const void* v,
                     const void* kv_len, void* out, void* part, void* tickets,
                     int B, int KH, int G, int Tk, long long ksb,
                     long long ksh, long long kst, long long vsb,
                     long long vsh, long long vst, int chunk, int splits,
                     cudaStream_t s) {
#define ARGS q, k, v, kv_len, out, part, tickets, B, KH, G, Tk, ksb, ksh, kst, vsb, vsh, vst, chunk, splits, s
  return vec ? launch<T, D, true>(ARGS) : launch<T, D, false>(ARGS);
#undef ARGS
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out alike).  Strides are
// in elements.  `part` holds B*KH*splits*(G*D + 4*ceil(2G/4)) floats
// (16-byte aligned); `tickets` B*KH ints, zero before the first call (the
// kernel leaves them zero).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* part, void* tickets, int B, int KH, int G, int D, int Tk,
    long long ksb, long long ksh, long long kst, long long vsb, long long vsh,
    long long vst, int chunk, int splits, int dtype, void* stream) {
  if (G < 1 || G * D > 2048 || (D != 64 && D != 128) || chunk < 1 ||
      chunk % kTile != 0 || splits < 1 ||
      static_cast<long long>(chunk) * splits < Tk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = dtype == 0 ? 4 : 2;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const bool vec = (bases % 16) == 0 &&
                   ((ksb | ksh | kst | vsb | vsh | vst) * esize) % 16 == 0;
#define ARGS vec, q, k, v, kv_len, out, part, tickets, B, KH, G, Tk, ksb, ksh, kst, vsb, vsh, vst, chunk, splits, s
  if (dtype == 0 && D == 64) return dispatch<float, 64>(ARGS);
  if (dtype == 0 && D == 128) return dispatch<float, 128>(ARGS);
  if (dtype == 1 && D == 64) return dispatch<__nv_bfloat16, 64>(ARGS);
  if (dtype == 1 && D == 128) return dispatch<__nv_bfloat16, 128>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}
