// Split-KV flash-decode for Hopper (sm_90a): the kernel body shared by
// decode_attention.cu (a dense per-slot cache) and
// paged_decode_attention.cu (a paged pool, fp or int8).  The two differ
// only in where token t of a row lives and in how an int8 row is scaled;
// a source policy (`Src`) supplies both.
//
// Computes, for every slot b and KV head kh, the attention of the G query
// rows of that head group (q (B, KH, G, D), D 64 or 128, G * D <= 2048)
// over the slot's first kv_len[b] cached tokens.  Output (B, KH, G, D) in
// q's type.
//
// What bounds it on the H100: bytes.  Each query row does 4*D flops per
// cached token against 2*D*sizeof(cache) bytes of K and V, one flop per
// byte or less (four in int8).  At serving's sizes (a few MB of live
// cache) the time is latency: how many of the live bytes are in flight at
// once.  The design:
//   * the KV axis is split into small fixed ranges (`chunk`, 64 tokens
//     unless the grid would pass ~16 CTAs per SM), one CTA per (range, b,
//     kh): the live ranges alone spread over hundreds of CTAs, and a range
//     at or past its slot's kv_len exits at once;
//   * a CTA walks its range in 32-token tiles through a two-stage ring in
//     shared memory, K and V copied in their own dtype by 16-byte cp.async
//     (an int8 row is a quarter of a float32 row, in device memory and in
//     shared memory alike; its per-token scales ride beside it), the next
//     tile's copy in flight during this tile's products;
//   * int8 is never widened in shared memory: the scales fold into the
//     arithmetic, score = (q . k_i8) * k_scale / sqrt(D), and each P V
//     weight is p * v_scale, applied when the softmax writes p;
//   * the G query rows of a KV head share every tile; each warp owns 8 of
//     a tile's tokens, 4 at a time: 8 lanes run across D with vector
//     loads and three shuffles finish each dot product; the online softmax
//     in float32 gives one lane per token; each thread then owns 4 columns
//     of up to 4 query rows of the output;
//   * a slot whose row fits one range is finished by its CTA.  Otherwise
//     each CTA writes float32 partials (m, l, acc) and the last CTA of the
//     (b, kh), found by an atomic ticket that it resets for the next call,
//     combines the ranges with the usual rescaling by exp(m_i - max m),
//     divided by max(l, 1e-30) (one launch: a second combine launch
//     measured slower at every serving shape).
// Masked positions never enter the sums (the reference masks them with
// -1e30); a slot with kv_len 0 gets zeros, as the TPU kernels give.
//
// A source policy Src provides:
//   using KT;                       the cache's element type
//   static constexpr bool kQuant;   int8 rows with float32 per-token scales
//   int length(int kv_len) const;   the row's live length, clamped
//   void begin(int b, int kh, int start, int end, void* scratch);
//       this CTA's row and range [start, end); `scratch` is the source's
//       own shared memory, after the body's (body_smem); whatever begin
//       writes there must be visible to every thread when it returns
//   void load(KT* k, KT* v, float* k_scale, float* v_scale, int t0,
//             int n) const;
//       issue the cp.async copies of tokens t0 .. t0 + n - 1 (n <= kTile)
//       into a stage, zero-filling rows n .. kTile - 1 (their probability
//       is 0, and 0 times an unset value could be NaN)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace decode_common {

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

// four signed bytes of a word as float32
__device__ __forceinline__ float4 i8x4(uint32_t w) {
  return make_float4(static_cast<float>(static_cast<int8_t>(w)),
                     static_cast<float>(static_cast<int8_t>(w >> 8)),
                     static_cast<float>(static_cast<int8_t>(w >> 16)),
                     static_cast<float>(static_cast<int8_t>(w >> 24)));
}

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
__device__ __forceinline__ float4 load4(const int8_t* p) {
  return i8x4(*reinterpret_cast<const uint32_t*>(p));
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

// floats of one range's partials: acc (G x D), then m and l (G each),
// padded to whole float4s
__host__ __device__ __forceinline__ int part_stride(int G, int D) {
  return G * D + (2 * G + 3) / 4 * 4;
}

// dynamic shared memory of the body (the source's scratch comes on top):
// the ring, then q, p, m, l, alpha and, for int8, the ring's scales
__host__ __device__ __forceinline__ int body_smem(int elem, int D, int G,
                                                  bool quant) {
  return kStages * 2 * kTile * D * elem +
         static_cast<int>(sizeof(float)) *
             (G * D + G * kTile + 3 * G + (quant ? kStages * 2 * kTile : 0));
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

// Column layout of the dot products.  Lane `sub` of an 8-lane group holds
// NC = D / 32 four-column chunks of a K row.  fp rows: chunk c is columns
// 32 * c' + 4 * sub, c' = (c + grp) % NC rotated by the group so that the
// four groups of a warp read different banks.  int8 rows: the lane's
// chunks are one contiguous run of 4 * NC bytes (one 8- or 16-byte load),
// columns 4 * (sub * NC + c); q is stored permuted (q_col) so that chunk c
// of lane sub sits at 32 * c + 4 * sub, as in the fp layout.
template <int D, bool QUANT>
__device__ __forceinline__ int q_col(int j) {      // q_s slot j <- q column
  if (!QUANT) return j;
  constexpr int NC = D / 32;
  const int c = j / 32, sub = (j % 32) / 4;
  return 4 * (sub * NC + c) + j % 4;
}

template <typename KT, int D>
struct KRow {                       // fp: NC float4 loads, rotated
  static __device__ __forceinline__ void load(float4 (&kr)[D / 32],
                                              const KT* row, int sub,
                                              int grp) {
    constexpr int NC = D / 32;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      kr[c] = load4(row + 4 * (sub + 8 * ((c + grp) % NC)));
  }
  static __device__ __forceinline__ int q_off(int c, int sub, int grp) {
    return 4 * sub + 32 * ((c + grp) % (D / 32));
  }
};

template <int D>
struct KRow<int8_t, D> {            // int8: one contiguous 4 * NC bytes
  static __device__ __forceinline__ void load(float4 (&kr)[D / 32],
                                              const int8_t* row, int sub,
                                              int) {
    constexpr int NC = D / 32;
    const int8_t* p = row + sub * NC * 4;
    if constexpr (NC == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      kr[0] = i8x4(u.x);
      kr[1] = i8x4(u.y);
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      kr[0] = i8x4(u.x);
      kr[1] = i8x4(u.y);
      kr[2] = i8x4(u.z);
      kr[3] = i8x4(u.w);
    }
  }
  static __device__ __forceinline__ int q_off(int c, int sub, int) {
    return 4 * sub + 32 * c;
  }
};

// The body of one CTA: range blockIdx.x of row blockIdx.y = b * KH + kh.
template <typename QT, int D, class Src>
__device__ __forceinline__ void split_decode(
    Src src, const QT* __restrict__ q, const int32_t* __restrict__ kv_len,
    QT* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
    int KH, int G, int chunk, int splits, float scale_log2) {
  using KT = typename Src::KT;
  constexpr bool QUANT = Src::kQuant;
  constexpr int NC = D / 32;                // 4-column chunks a lane in Q K^T
  constexpr int DQ = D / 4;                 // threads per row in P V
  constexpr int NGS = kThreads / DQ;        // rows in flight in P V
  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / KH, kh = bh % KH;
  const int len = src.length(kv_len[b]);
  const int live = (len + chunk - 1) / chunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  QT* ob = out + static_cast<size_t>(bh) * G * D;
  if (split >= live) {                      // a dead range: nothing to do,
    if (len == 0 && split == 0)             // but an empty row is zeros
      for (int j = tid; j < G * D; j += kThreads) from_f(0.f, ob + j);
    return;
  }
  const int start = split * chunk, end = min(len, start + chunk);
  const int n_tiles = (end - start + kTile - 1) / kTile;

  extern __shared__ float4 smem4[];
  KT* kv_s = reinterpret_cast<KT*>(smem4);  // kStages x (K, V) x kTile x D
  float* q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTile * D);
  float* p_s = q_s + G * D;                 // G x kTile
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* sc_s = a_s + G;                    // int8: kStages x (K, V) x kTile
  __shared__ int last;

  src.begin(b, kh, start, end, sc_s + (QUANT ? kStages * 2 * kTile : 0));
#pragma unroll
  for (int s = 0; s < kStages; ++s) {       // prologue: fill the ring
    const int t0 = start + s * kTile;
    if (s < n_tiles) {
      KT* st = kv_s + s * 2 * kTile * D;
      float* sc = sc_s + s * 2 * kTile;
      src.load(st, st + kTile * D, sc, sc + kTile, t0, min(kTile, end - t0));
    }
    cp_async_commit();
  }
  const QT* qb = q + static_cast<size_t>(bh) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_f(qb[i - i % D + q_col<D, QUANT>(i % D)]);
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
    const KT* k_t = kv_s + s * 2 * kTile * D;
    const KT* v_t = k_t + kTile * D;
    const float* ks_t = sc_s + s * 2 * kTile;
    const float* vs_t = ks_t + kTile;
    cp_async_wait<kStages - 1>();
    __syncthreads();

    // scores: warp w takes tokens 8w .. 8w + 7, four at a time, one per
    // group of 8 lanes; three shuffles finish each dot product
#pragma unroll
    for (int pass = 0; pass < kTile / kWarps / 4; ++pass) {
      const int grp = lane / 8, sub = lane % 8;
      const int t = warp * (kTile / kWarps) + pass * 4 + grp;
      float4 kr[NC];
      KRow<KT, D>::load(kr, k_t + t * D, sub, grp);
      const float ts = QUANT ? ks_t[t] * scale_log2 : scale_log2;
      for (int g = 0; g < G; ++g) {
        const float* qr = q_s + g * D;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(
              qr + KRow<KT, D>::q_off(c, sub, grp));
          d = fmaf(x.x, kr[c].x, d);
          d = fmaf(x.y, kr[c].y, d);
          d = fmaf(x.z, kr[c].z, d);
          d = fmaf(x.w, kr[c].w, d);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        if (sub == 0) p_s[g * kTile + t] = t < n ? d * ts : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax in log2 units: one warp per query row, a lane per
    // token; an int8 row's V scale folds into the weight p written back
    for (int g = warp; g < G; g += kWarps) {
      const float x = p_s[g * kTile + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float p = exp2f(x - m_new);
      const float sum = warp_sum(p);
      p_s[g * kTile + lane] = QUANT ? p * vs_t[lane] : p;
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
      KT* st = kv_s + s * 2 * kTile * D;
      float* sc = sc_s + s * 2 * kTile;
      src.load(st, st + kTile * D, sc, sc + kTile, tn, min(kTile, end - tn));
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
  combine<QT>(pb, ob, G, D, live);
  if (tid == 0) tickets[bh] = 0;            // ready for the next call
}

}  // namespace decode_common
