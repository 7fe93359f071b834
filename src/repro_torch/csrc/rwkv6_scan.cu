// WKV6 recurrence (RWKV6 "Finch" time mix), stateless forward, for Hopper
// (sm_90a): r/k/v float32 or bfloat16, w and u float32, head size 32 or 64,
// any sequence length T.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py `_wkv6_kernel`
// (called through `wkv6`).
//
// r, k, v, w (B, H, T, N); u (H, N); out (B, H, T, N) in r's type.  Per
// (b, h) an N x N float32 state S starts at zero, and for t = 0 .. T-1:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// computed as o_t[j] = sum_i r_t[i] * S[i][j] + v_t[j] * a_t with
// a_t = sum_i r_t[i] * u[i] * k_t[i]: the same sum in another order.  All
// arithmetic is float32.
//
// What bounds it on the H100: the float32 pipe and shared-memory traffic,
// about as much as bytes.  Each of r, k, v, w is read once and out written
// once (5 N-vectors a step), and a step makes 3 N^2 float32 instructions
// (k*v, the state's FMA, the output's FMA): ~0.024 ms at (8, 32, 256, 64)
// against 0.025 ms of bytes.  The state never leaves the registers.
// The design:
//   * one CTA per (b, h) walks the whole sequence (the recurrence is
//     sequential).  A thread keeps a kRows x kCols block of S: the kLanes
//     lanes of a group share kCols columns, each lane kRows = N / kLanes of
//     their rows (8 x 4, 128 threads at N 64).  A 16-byte shared load costs
//     four wavefronts whatever the lanes share, so a float loaded costs
//     about what an FMA does: a thread loads 3 kRows + kCols floats a step
//     for 3 kRows kCols FMAs.  One column a thread took 0.131 ms at the
//     shape above; 64-thread blocks (8 x 8, 4 x 4) leave one warp a
//     scheduler at two CTAs an SM and lose to 128 threads (tools/moe_ab.py
//     --kernel wkv6 on an H100 SXM, 700 W);
//   * inside the step loop a step depends on the last only through
//     S[i][j] = fma(w_t[i], S[i][j], k_t[i] * v_t[j]): each lane stores its
//     partial sums of o_t to shared memory (rows padded so a quarter-warp's
//     float4 stores hit 8 bank groups), and after the tile the lanes'
//     partials and v_t[j] * a_t are summed and written out with coalesced
//     stores.  Summing in the loop with xor shuffles put their latency on
//     every step (~0.075 ms whatever the block);
//   * a_t, the u-term, is summed before the tile's step loop by
//     NT / kTc threads a step, off the chain;
//   * the sequence is staged in tiles of kTc = 16 steps, two stages: one
//     thread copies tile c + 1's rows of r, k, v, w with four TMA bulk
//     copies on an mbarrier while tile c computes, three barriers a tile.
//     (16-byte cp.async by every thread cost 0.008 ms more; 32-step tiles
//     do not fit twice an SM with their partial sums.)  bfloat16 r, k, v
//     are widened to float32 in shared memory once a tile, so the step loop
//     is the same for both types.
// Inputs whose address is not 16-byte aligned (a contiguous view at an odd
// offset) are staged by plain loads instead of TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kTc = 16;       // steps a staged tile

template <typename T, int N>
struct Cfg {
  static constexpr int kLanes = 8;
  static constexpr int kCols = 4;
  static constexpr int kRows = N / kLanes;
  static constexpr int kQuads = kRows / 4;       // the rows, as float4s
  static constexpr int kThreads = kLanes * N / kCols;
  static_assert(kRows % 4 == 0 && kCols % 4 == 0, "whole float4s");
  static constexpr int kTile = kTc * N;          // elements of a tile
  static constexpr bool kWiden = sizeof(T) == 2; // bf16 -> f32 copies
  // a stage: r, k, v in T, then w in float32
  static constexpr int kStage = 3 * kTile * sizeof(T) + kTile * 4;
  static constexpr int kWork = kWiden ? 3 * kTile * 4 : 0;
  // partial sums [step][lane][column], rows padded by 4 floats so that the
  // 8 lanes of a quarter-warp store to 8 distinct bank groups
  static constexpr int kPad = N + 4;
  static constexpr int kPart = kTc * kLanes * kPad;
  // + a_t, u and the two stages' mbarriers
  static constexpr int kSmem = 2 * kStage + kWork + (kPart + kTc + N) * 4 + 16;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
// element e of an array of float4s held in registers (e a constant after
// unrolling, so no local memory)
template <int M>
__device__ __forceinline__ float at(const float4 (&a)[M], int e) {
  const float4& f = a[e / 4];
  return e % 4 == 0 ? f.x : e % 4 == 1 ? f.y : e % 4 == 2 ? f.z : f.w;
}

// rows [0, nv) of one array's tile (nv * N elements from src) into dst:
// one TMA bulk copy issued by the calling thread, or, for an input that is
// not 16-byte aligned, plain loads by every thread of the CTA
template <typename E, int N, int NT>
__device__ __forceinline__ void stage_array(unsigned char* dst, const E* src,
                                            int nv, bool aligned, int tid,
                                            uint64_t* bar) {
  static_assert((N * sizeof(E)) % 16 == 0, "a step's row is whole 16-byte units");
  if (aligned) {
    hopper::bulk_load(dst, src, nv * N * sizeof(E), bar);
  } else {
    E* d = reinterpret_cast<E*>(dst);
    for (int i = tid; i < nv * N; i += NT) d[i] = src[i];
  }
}

__device__ __forceinline__ void put4(float* o, float4 x) {
  *reinterpret_cast<float4*>(o) = x;
}
__device__ __forceinline__ void put4(__nv_bfloat16* o, float4 x) {
  __nv_bfloat162 p[2] = {__floats2bfloat162_rn(x.x, x.y),
                         __floats2bfloat162_rn(x.z, x.w)};
  *reinterpret_cast<uint2*>(o) = *reinterpret_cast<const uint2*>(p);
}

template <typename T, int N>
__global__ void __launch_bounds__(Cfg<T, N>::kThreads, 2) wkv6_fwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    T* __restrict__ out, int H, int Tlen, int aligned) {
  using K = Cfg<T, N>;
  constexpr int NT = K::kThreads, L = K::kLanes, C = K::kCols;
  extern __shared__ __align__(16) unsigned char smem[];
  float* work = reinterpret_cast<float*>(smem + 2 * K::kStage);  // bf16 only
  float* part = reinterpret_cast<float*>(smem + 2 * K::kStage + K::kWork);
  float* as = part + K::kPart;        // a_t of the tile's steps
  float* us = as + kTc;               // u[h]
  uint64_t* bar = reinterpret_cast<uint64_t*>(us + N);  // a stage's copies landed

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, h = bh % H;
  const size_t slab = static_cast<size_t>(bh) * Tlen * N;
  const int tiles = (Tlen + kTc - 1) / kTc;

  auto stage = [&](int c) -> unsigned char* {
    return smem + (c & 1) * K::kStage;
  };
  // tile c's rows of r, k, v, w into its stage.  Past T (the last tile)
  // the stage keeps what it held: those steps' state and outputs are never
  // used, as the recurrence runs forward
  auto load = [&](int c) {
    const int t0 = c * kTc, nv = min(kTc, Tlen - t0);
    if (aligned && tid != 0) return;
    const size_t off = slab + static_cast<size_t>(t0) * N;
    unsigned char* st = stage(c);
    uint64_t* b = bar + (c & 1);
    if (aligned) hopper::mbar_expect_tx(b, nv * N * (3 * sizeof(T) + 4));
    stage_array<T, N, NT>(st, r + off, nv, aligned, tid, b);
    stage_array<T, N, NT>(st + K::kTile * sizeof(T), k + off, nv, aligned, tid, b);
    stage_array<T, N, NT>(st + 2 * K::kTile * sizeof(T), v + off, nv, aligned, tid, b);
    stage_array<float, N, NT>(st + 3 * K::kTile * sizeof(T), w + off, nv,
                              aligned, tid, b);
  };

  for (int i = tid; i < N; i += NT) us[i] = u[h * N + i];
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_init(bar + 1, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  load(0);

  const int l = tid % L;              // lane within the column group
  const int j0 = tid / L * C;         // the group's first column
  // S[e][c]: row 4 L (e / 4) + 4 l + e % 4, column j0 + c
  float S[K::kRows][C];
#pragma unroll
  for (int e = 0; e < K::kRows; ++e)
#pragma unroll
    for (int c = 0; c < C; ++c) S[e][c] = 0.f;

  for (int c = 0; c < tiles; ++c) {
    if (aligned) hopper::mbar_wait(bar + (c & 1), (c >> 1) & 1);
    // tile c is in shared memory for every thread, and tile c - 1 is done
    // with: its stage may take tile c + 1
    __syncthreads();
    if (c + 1 < tiles) load(c + 1);

    const unsigned char* st = stage(c);
    const T* rt = reinterpret_cast<const T*>(st);
    const T* kt = rt + K::kTile;
    const T* vt = kt + K::kTile;
    const float* ws = reinterpret_cast<const float*>(st + 3 * K::kTile * sizeof(T));
    if constexpr (K::kWiden) {
      // r, k, v are contiguous in the stage and in work: 8 values a unit
      const uint4* src = reinterpret_cast<const uint4*>(st);
      float4* dst = reinterpret_cast<float4*>(work);
      for (int i = tid; i < 3 * K::kTile / 8; i += NT) {
        const uint4 x = src[i];
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&x);
        const float2 f0 = __bfloat1622float2(b[0]), f1 = __bfloat1622float2(b[1]);
        const float2 f2 = __bfloat1622float2(b[2]), f3 = __bfloat1622float2(b[3]);
        dst[2 * i] = make_float4(f0.x, f0.y, f1.x, f1.y);
        dst[2 * i + 1] = make_float4(f2.x, f2.y, f3.x, f3.y);
      }
    }
    // a_t = sum_i r_t[i] u[i] k_t[i]: P threads a step, each every P-th
    // term, summed with xor shuffles
    {
      constexpr int P = NT / kTc, E = N / P;
      const int s = tid / P, q = tid % P;
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e)
        p = fmaf(to_f(rt[s * N + q + P * e]) * us[q + P * e],
                 to_f(kt[s * N + q + P * e]), p);
#pragma unroll
      for (int m = P / 2; m > 0; m >>= 1) p += __shfl_xor_sync(0xffffffffu, p, m);
      if (q == 0) as[s] = p;
    }
    __syncthreads();

    const float* rs = K::kWiden ? work : reinterpret_cast<const float*>(rt);
    const float* ks = K::kWiden ? work + K::kTile : reinterpret_cast<const float*>(kt);
    const float* vs = K::kWiden ? work + 2 * K::kTile : reinterpret_cast<const float*>(vt);
    // a step's operands: this lane's rows of r, k, w (float4s that the
    // group's lanes take from consecutive 16-byte units) and the group's
    // columns of v
    struct Ops {
      float4 r[K::kQuads], k[K::kQuads], w[K::kQuads], v[C / 4];
    };
    auto fetch = [&](int s) {
      Ops o;
#pragma unroll
      for (int g = 0; g < K::kQuads; ++g) {
        const int i = s * N + 4 * L * g + 4 * l;
        o.r[g] = *reinterpret_cast<const float4*>(rs + i);
        o.k[g] = *reinterpret_cast<const float4*>(ks + i);
        o.w[g] = *reinterpret_cast<const float4*>(ws + i);
      }
#pragma unroll
      for (int g = 0; g < C / 4; ++g)
        o.v[g] = *reinterpret_cast<const float4*>(vs + s * N + j0 + 4 * g);
      return o;
    };
    // every step of the tile (past T the stage holds stale rows: those
    // steps' state and partial sums are never used)
    Ops cur = fetch(0);
#pragma unroll 2
    for (int s = 0; s < kTc; ++s) {
      const Ops nxt = fetch(min(s + 1, kTc - 1));    // in flight meanwhile
      float o[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) o[cc] = cur.r[0].x * S[0][cc];
#pragma unroll
      for (int e = 1; e < K::kRows; ++e)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          o[cc] = fmaf(at(cur.r, e), S[e][cc], o[cc]);
#pragma unroll
      for (int e = 0; e < K::kRows; ++e)
#pragma unroll
        for (int cc = 0; cc < C; ++cc)
          S[e][cc] = fmaf(at(cur.w, e), S[e][cc], at(cur.k, e) * at(cur.v, cc));
      float* pp = part + (s * L + l) * K::kPad + j0;
#pragma unroll
      for (int g = 0; g < C / 4; ++g)
        *reinterpret_cast<float4*>(pp + 4 * g) =
            make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
      cur = nxt;
    }
    __syncthreads();

    // out_t[j..j+3] = the L lanes' partials + v_t[j..j+3] * a_t
    const int t0 = c * kTc, nv = min(kTc, Tlen - t0);
    T* o = out + slab + static_cast<size_t>(t0) * N;
#pragma unroll
    for (int q0 = 0; q0 < K::kTile / 4 / NT; ++q0) {
      const int i = tid + q0 * NT;
      if (i >= nv * N / 4) break;
      const int s = i / (N / 4), j = 4 * (i % (N / 4));
      const float a = as[s];
      float4 x = *reinterpret_cast<const float4*>(vs + s * N + j);
      x = make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
#pragma unroll
      for (int q = 0; q < L; ++q) {
        const float4 y =
            *reinterpret_cast<const float4*>(part + (s * L + q) * K::kPad + j);
        x.x += y.x;
        x.y += y.y;
        x.z += y.z;
        x.w += y.w;
      }
      put4(o + s * N + j, x);
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, int B, int H, int Tlen,
                   cudaStream_t stream) {
  using K = Cfg<T, N>;
  auto kernel = wkv6_fwd_kernel<T, N>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (e != cudaSuccess) return e;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(w);
  kernel<<<B * H, K::kThreads, K::kSmem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(out), H, Tlen,
      addr % 16 == 0);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (of r, k, v and out): 0 float32, 1 bfloat16.  out must be
// 16-byte aligned (the wrapper allocates it).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* out, int B,
                            int H, int T, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
  if (dtype == 0 && N == 64) return launch<float, 64>(r, k, v, w, u, out, B, H, T, s);
  if (dtype == 0 && N == 32) return launch<float, 32>(r, k, v, w, u, out, B, H, T, s);
  if (dtype == 1 && N == 64)
    return launch<__nv_bfloat16, 64>(r, k, v, w, u, out, B, H, T, s);
  if (dtype == 1 && N == 32)
    return launch<__nv_bfloat16, 32>(r, k, v, w, u, out, B, H, T, s);
  return cudaErrorInvalidValue;
}
