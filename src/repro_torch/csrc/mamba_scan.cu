// Mamba-1 selective scan, forward, for Hopper (sm_90a): dt, B, C and x in
// float32 or bfloat16, A and D float32, state size N up to 16, any sequence
// length S, with an optional float32 initial state in and the float32 final
// state out.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py `_mamba_kernel`
// (called through `mamba_scan_pallas`), which takes the stateless form only;
// this one also takes the carried state of the serving path.
//
// dt, x (B, S, di); Bm, Cm (B, S, N); A (di, N) (negative); D (di,);
// h0, hN (B, di, N); y (B, S, di) in x's type.  Per (b, channel d) N float32
// states start at h0 (or zero), and for t = 0 .. S-1:
//     h[n] <- exp(dt_t[d] * A[d][n]) * h[n] + (dt_t[d] * x_t[d]) * B_t[n]
//     y_t[d] = sum_n h[n] * C_t[n] + D[d] * x_t[d]
// All arithmetic is float32; bfloat16 inputs are widened on load.  A row or
// step with dt = 0 leaves its states bitwise unchanged (2^0 = 1 exactly,
// a zero input).
//
// What bounds it on the H100: by its arithmetic, the exponentials and the
// bytes about equally.  dt and x are read once and y written once (3 values
// of di a step), the state loaded and stored once; each step makes di * N
// exponentials, which only the SFUs compute (16 a clock an SM).  At
// jamba's chunk, (1, 256, 16384, 16) in float32, either takes ~0.016 ms.
// What the kernel reaches is set by latency: at B = 1 an SM holds 128
// channels, eight warps, and a step costs a scheduler ~190 cycles against
// the SFU's 128 (~163 with no exponential at all, the SFU ~67% busy).
// The design, each choice timed by tools/moe_ab.py --kernel scan on an
// H100 SXM at 700 W (readings in PERF.md):
//   * one exponential a state and step: A is scaled by log2(e) once, when
//     a thread loads its states, and each step takes 2^(dt * A2) with one
//     SFU instruction (`hopper::ex2`);
//   * grid (di / 64, B), 128 threads a CTA, kLanes = 2 lanes a channel,
//     each keeping 8 contiguous states in registers, so h0, hN and A move
//     as 16-byte vectors.  One lane a channel (one warp a scheduler at
//     B = 1) took ~1.5x as long, four lanes ~1.15x, two channels a thread
//     (each B, C value loaded once for both) 1.05-1.3x;
//   * a step depends on the last only through h's FMA: each lane sums its
//     part of y in registers, holds a sub-block of kSub steps' parts in
//     registers and stores them after its last step (a shared store
//     between steps made the compiler order the next step's loads after
//     it, one step at a time), and the two lanes' parts (D x in lane 0's)
//     are summed once a tile and written out as 4-vectors (summing them
//     while the next tile runs, on a second buffer, was slower);
//   * time comes in tiles of kSteps = 32: every thread copies its share of
//     a tile's dt and x rows (64 contiguous values each) and B and C rows
//     into shared memory with 16-byte cp.async, kStages = 3 tiles in
//     flight, two barriers a tile (three in bfloat16, whose B and C are
//     widened once a tile).  Steps past S and states past N are
//     zero-filled, so they leave h as it is.  16-step tiles were slower;
//   * the step loop runs kSub = 8 steps unrolled, with no branch and no
//     shuffle inside (16 or 32 made no difference);
//   * instances of their own for S = 1 (a decode step: no staging, a
//     thread reads its dt, x and its part of B and C straight from
//     memory) and for N <= 8 (half the exponentials): both faster than
//     going through the general instance.
// Inputs whose addresses, strides or rows are not whole 16-byte units
// (`vec` = 0, decided by the wrapper) take scalar loads instead: the same
// kernel, tiles and arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;   // a CTA
constexpr int kLanes = 2;       // lanes sharing a channel's states
constexpr int kSteps = 32;      // time steps a staged tile
constexpr int kSub = 8;         // steps the compute loop unrolls
constexpr float kLog2e = 1.4426950408889634f;

// TS: steps a tile (1: the decode instance, no staging)
template <typename T, int NS, int TS>
struct Cfg {
  static constexpr int kCh = kThreads / kLanes;   // channels a CTA
  static constexpr int kPer = NS / kLanes;        // states a lane keeps
  static_assert(kPer % 4 == 0, "a lane's states are whole 4-vectors");
  static constexpr int kEl = sizeof(T);
  static constexpr int kEpc = 16 / kEl;           // elements a 16-byte unit
  static constexpr int kStages = 3;
  static constexpr int kSeq = TS * kCh * kEl;     // bytes of a dt or x tile
  static constexpr int kBC = TS * NS * kEl;       // bytes of a B or C tile
  static constexpr int kStage = 2 * kSeq + 2 * kBC;
  static constexpr bool kWiden = kEl == 2;        // B, C widened once a tile
  static constexpr int kWide = kWiden ? 2 * TS * NS * 4 : 0;
  // the lanes' parts of y [step][lane][channel], rows padded so that the
  // lanes of a warp store to distinct banks
  static constexpr int kPad = kCh + 32 / kLanes;
  static_assert(kCh % 32 == 0, "rows of whole bank sweeps");
  static constexpr int kPart = TS * kLanes * kPad * 4;
  static constexpr int kSmem = TS == 1 ? 0 : kStages * kStage + kWide + kPart;
  static constexpr int kMinBlocks = TS == 1 ? 4 : 1;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive values: 16 bytes of float32, 8 of bfloat16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 q[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(q);
}
__device__ __forceinline__ float get(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// P values of a row, n = n0 .. n0 + P - 1, from src (indexed by n); those
// with n >= N, or all when !live, are 0.  vec: as 4-vectors (src 16-byte
// aligned in float32, 8 in bfloat16, and N a multiple of 4, so a 4-vector
// is live or dead as a whole)
template <int P, typename E>
__device__ __forceinline__ void load_row(float (&v)[P], const E* src, int n0,
                                         int N, bool live, bool vec) {
  if (vec) {
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      const int n = n0 + 4 * g;
      const float4 q = live && n < N ? load4(src + n) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * g] = q.x;
      v[4 * g + 1] = q.y;
      v[4 * g + 2] = q.z;
      v[4 * g + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      v[i] = live && n0 + i < N ? to_f(src[n0 + i]) : 0.f;
  }
}

// the P values of a row at n0 .. n0 + P - 1 to dst (indexed by n), those
// with n < N; vec: as 4-vectors, as load_row reads them
template <int P>
__device__ __forceinline__ void store_row(float* dst, const float (&v)[P],
                                          int n0, int N, bool vec) {
  if (vec) {
#pragma unroll
    for (int g = 0; g < P / 4; ++g)
      if (n0 + 4 * g < N)
        store4(dst + n0 + 4 * g,
               make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]));
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (n0 + i < N) dst[n0 + i] = v[i];
  }
}

struct Args {
  const void* dt;
  const void* bm;
  const void* cm;
  const void* x;
  const float* A;
  const float* D;
  const float* h0;   // may be null
  float* hN;         // may be null
  void* y;
  int B, S, di, N, vec;
  // element strides of the batch and time axes (the last axis is contiguous)
  long long dt_sb, dt_st, b_sb, b_st, c_sb, c_st, x_sb, x_st;
};

// tile [t0, t0 + TS) of dt, x (channels c0 .. c0 + kCh) and B, C (states
// 0 .. NS) into a stage; what lies past S, di or N is zero-filled
template <typename T, int NS, int TS>
__device__ __forceinline__ void stage_tile(unsigned char* st, const Args& a,
                                           const T* dt, const T* xs,
                                           const T* bm, const T* cm, int c0,
                                           int t0, int tid) {
  using K = Cfg<T, NS, TS>;
  T* sdt = reinterpret_cast<T*>(st);
  T* sx = reinterpret_cast<T*>(st + K::kSeq);
  T* sb = reinterpret_cast<T*>(st + 2 * K::kSeq);
  T* sc = reinterpret_cast<T*>(st + 2 * K::kSeq + K::kBC);
  if (a.vec) {
    constexpr int cpr = K::kCh / K::kEpc;         // units a dt / x row
    static_assert(TS * cpr % kThreads == 0, "whole rounds of units");
#pragma unroll
    for (int k = 0; k < TS * cpr / kThreads; ++k) {
      const int j = tid + k * kThreads, r = j / cpr, e = j % cpr * K::kEpc;
      const int t = t0 + r, c = c0 + e;
      const bool ok = t < a.S && c < a.di;
      hopper::cp_async16(sdt + r * K::kCh + e, ok ? dt + t * a.dt_st + c : dt, ok);
      hopper::cp_async16(sx + r * K::kCh + e, ok ? xs + t * a.x_st + c : xs, ok);
    }
    constexpr int upr = NS / K::kEpc;             // units a B / C row
    for (int j = tid; j < TS * upr; j += kThreads) {
      const int r = j / upr, n = j % upr * K::kEpc, t = t0 + r;
      const bool ok = t < a.S && n < a.N;
      hopper::cp_async16(sb + r * NS + n, ok ? bm + t * a.b_st + n : bm, ok);
      hopper::cp_async16(sc + r * NS + n, ok ? cm + t * a.c_st + n : cm, ok);
    }
  } else {
    const T zero = from_f<T>(0.f);
#pragma unroll 4
    for (int k = 0; k < TS * K::kCh / kThreads; ++k) {
      const int j = tid + k * kThreads, r = j / K::kCh, c = c0 + j % K::kCh;
      const int t = t0 + r;
      const bool ok = t < a.S && c < a.di;
      sdt[j] = ok ? dt[t * a.dt_st + c] : zero;
      sx[j] = ok ? xs[t * a.x_st + c] : zero;
    }
    for (int j = tid; j < TS * NS; j += kThreads) {
      const int r = j / NS, n = j % NS, t = t0 + r;
      const bool ok = t < a.S && n < a.N;
      sb[j] = ok ? bm[t * a.b_st + n] : zero;
      sc[j] = ok ? cm[t * a.c_st + n] : zero;
    }
  }
}

template <typename T, int NS, int TS>
__global__ void __launch_bounds__(kThreads, (Cfg<T, NS, TS>::kMinBlocks))
    mamba_scan_kernel(Args a) {
  using K = Cfg<T, NS, TS>;
  constexpr int P = K::kPer;
  extern __shared__ __align__(16) unsigned char smem[];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * K::kCh;
  const int tid = threadIdx.x;
  const int l = tid % kLanes;          // lane within the channel's kLanes
  const int ch = tid / kLanes;         // channel within the CTA
  const int c = c0 + ch;
  const bool live = c < a.di;
  const int S = a.S, di = a.di, N = a.N, n0 = l * P;
  const bool vec = a.vec;

  const T* dt = static_cast<const T*>(a.dt) + b * a.dt_sb;
  const T* xs = static_cast<const T*>(a.x) + b * a.x_sb;
  const T* bm = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cm = static_cast<const T*>(a.cm) + b * a.c_sb;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * S * di;

  // this lane's states n = n0 .. n0 + P - 1; n >= N keeps A = 0, h = 0 and
  // B = 0, so it stays 0 and adds nothing to y
  float A2[P], h[P];
  load_row(A2, a.A + static_cast<long long>(c) * N, n0, N, live, vec);
#pragma unroll
  for (int i = 0; i < P; ++i) A2[i] *= kLog2e;
  // row b's states: h0 (or zero) in, hN out
  const long long hrow = (static_cast<long long>(b) * di + c) * N;
  load_row(h, a.h0 + hrow, n0, N, live && a.h0 != nullptr, vec);
  // D * x enters y's sum once, on lane 0
  const float Dl = live && l == 0 ? a.D[c] : 0.f;

  // one step: h's update, and this lane's part of y; bq, cq hold this
  // lane's B_t, C_t
  auto step = [&](float dtv, float xv, const float4 (&bq)[P / 4],
                  const float4 (&cq)[P / 4]) {
    const float dx = dtv * xv;
    float y0 = Dl * xv, y1 = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      h[i] = fmaf(hopper::ex2(dtv * A2[i]), h[i], dx * get(bq[i / 4], i % 4));
      if (i % 2 == 0)
        y0 = fmaf(h[i], get(cq[i / 4], i % 4), y0);
      else
        y1 = fmaf(h[i], get(cq[i / 4], i % 4), y1);
    }
    return y0 + y1;
  };

  if constexpr (TS == 1) {
    // a decode step: this thread's dt, x and its part of the row's B, C
    // straight from memory
    float bs[P], cs[P];
    load_row(bs, bm, n0, N, true, vec);
    load_row(cs, cm, n0, N, true, vec);
    float4 bq[P / 4], cq[P / 4];
#pragma unroll
    for (int g = 0; g < P / 4; ++g) {
      bq[g] = make_float4(bs[4 * g], bs[4 * g + 1], bs[4 * g + 2], bs[4 * g + 3]);
      cq[g] = make_float4(cs[4 * g], cs[4 * g + 1], cs[4 * g + 2], cs[4 * g + 3]);
    }
    float v = step(live ? to_f(dt[c]) : 0.f, live ? to_f(xs[c]) : 0.f, bq, cq);
#pragma unroll
    for (int m = 1; m < kLanes; m <<= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (live && l == 0) y[c] = from_f<T>(v);
  } else {
    auto stage = [&](int k) { return smem + (k % K::kStages) * K::kStage; };
    float* wide = reinterpret_cast<float*>(smem + K::kStages * K::kStage);
    float* part = reinterpret_cast<float*>(smem + K::kStages * K::kStage + K::kWide);
    const int tiles = (S + TS - 1) / TS;

#pragma unroll
    for (int p = 0; p < K::kStages - 1; ++p) {
      if (p < tiles) stage_tile<T, NS, TS>(stage(p), a, dt, xs, bm, cm, c0, p * TS, tid);
      hopper::cp_async_commit();
    }
    for (int k = 0; k < tiles; ++k) {
      // tile k has landed for every thread, and every thread is done with
      // tile k - 1: its stage (and the parts of y, the widened B, C) are free
      hopper::cp_async_wait<K::kStages - 2>();
      __syncthreads();
      if (k + K::kStages - 1 < tiles)
        stage_tile<T, NS, TS>(stage(k + K::kStages - 1), a, dt, xs, bm, cm, c0,
                              (k + K::kStages - 1) * TS, tid);
      hopper::cp_async_commit();

      const unsigned char* st = stage(k);
      const T* sdt = reinterpret_cast<const T*>(st);
      const T* sx = reinterpret_cast<const T*>(st + K::kSeq);
      const float* sbc;                       // B rows, then C rows, float32
      if constexpr (K::kWiden) {
        const __nv_bfloat162* src =
            reinterpret_cast<const __nv_bfloat162*>(st + 2 * K::kSeq);
        for (int j = tid; j < TS * NS; j += kThreads)
          reinterpret_cast<float2*>(wide)[j] = __bfloat1622float2(src[j]);
        __syncthreads();
        sbc = wide;
      } else {
        sbc = reinterpret_cast<const float*>(st + 2 * K::kSeq);
      }

      const int t0 = k * TS, steps = min(TS, S - t0);
      for (int s0 = 0; s0 < steps; s0 += kSub) {
        // the sub-block's parts of y stay in registers until its last
        // step: a store to shared memory between steps would order the
        // next step's loads after it, and so every step after the last
        float v[kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u) {
          const int s = s0 + u;
          float4 bq[P / 4], cq[P / 4];
#pragma unroll
          for (int g = 0; g < P / 4; ++g) {
            bq[g] = *reinterpret_cast<const float4*>(sbc + s * NS + n0 + 4 * g);
            cq[g] = *reinterpret_cast<const float4*>(sbc + (TS + s) * NS + n0 + 4 * g);
          }
          v[u] = step(to_f(sdt[s * K::kCh + ch]), to_f(sx[s * K::kCh + ch]), bq, cq);
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) part[((s0 + u) * kLanes + l) * K::kPad + ch] = v[u];
      }

      // y_t = the lanes' parts, 4 channels an item, as 16-byte (float32)
      // or 8-byte (bfloat16) stores
      __syncthreads();
      constexpr int q4 = K::kCh / 4;
      static_assert(TS * q4 % kThreads == 0, "whole rounds of items");
#pragma unroll
      for (int r = 0; r < TS * q4 / kThreads; ++r) {
        const int j = tid + r * kThreads, s = j / q4, e = 4 * (j % q4);
        if (s >= steps) continue;
        float4 v = *reinterpret_cast<const float4*>(part + s * kLanes * K::kPad + e);
#pragma unroll
        for (int q = 1; q < kLanes; ++q) {
          const float4 w =
              *reinterpret_cast<const float4*>(part + (s * kLanes + q) * K::kPad + e);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        T* o = y + static_cast<long long>(t0 + s) * di + c0 + e;
        if (vec) {
          if (c0 + e < di) store4(o, v);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c0 + e + q < di) o[q] = from_f<T>(get(v, q));
        }
      }
    }
  }
  if (a.hN != nullptr && live) store_row(a.hN + hrow, h, n0, N, vec);
}

template <typename T, int NS, int TS>
cudaError_t launch(const Args& a, cudaStream_t s) {
  using K = Cfg<T, NS, TS>;
  auto kernel = mamba_scan_kernel<T, NS, TS>;
  if (K::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.di + K::kCh - 1) / K::kCh, a.B);
  kernel<<<grid, kThreads, K::kSmem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.S == 1)
    return a.N <= 8 ? launch<T, 8, 1>(a, s) : launch<T, 16, 1>(a, s);
  return a.N <= 8 ? launch<T, 8, kSteps>(a, s) : launch<T, 16, kSteps>(a, s);
}

}  // namespace

// dtype codes (of dt, Bm, Cm, x and y): 0 float32, 1 bfloat16.  h0 and hN
// may be null.  vec: every address, row and stride of dt, Bm, Cm, x, A and
// h0 is whole 16-byte units (the wrapper decides); else scalar loads.
// Strides are in elements: the batch and time strides of dt, Bm, Cm and x
// (their last axis contiguous).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mamba_scan_forward(
    const void* dt, const void* bm, const void* cm, const void* x,
    const void* A, const void* D, const void* h0, void* hN, void* y, int B,
    int S, int di, int N, int dtype, int vec, long long dt_sb,
    long long dt_st, long long b_sb, long long b_st, long long c_sb,
    long long c_st, long long x_sb, long long x_st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > 16 || B > 65535)
    return cudaErrorInvalidValue;
  Args a{dt, bm, cm, x, static_cast<const float*>(A),
         static_cast<const float*>(D), static_cast<const float*>(h0),
         static_cast<float*>(hN), y, B, S, di, N, vec != 0, dt_sb, dt_st,
         b_sb, b_st, c_sb, c_st, x_sb, x_st};
  if (dtype == 0) return dispatch<float>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, s);
  return cudaErrorInvalidValue;
}
