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
// All arithmetic is float32; bfloat16 inputs are widened on load.  A row
// with dt = 0 leaves its states bitwise unchanged (exp(0) = 1, zero input).
//
// What bounds it on the H100: bytes, and the exponentials about as much.
// dt and x are read once and y written once (3 values of di per step), the
// state loaded and stored once; each step also makes di * N exponentials
// (the SFUs' 16 a clock per SM).  The state never leaves the chip.  Design:
//   * grid (di / 32, B): CTAs are independent; each walks its rows' whole
//     sequence in a loop, which takes the place of the sequential chunk grid;
//   * 128 threads, 32 channels a CTA: four lanes share one channel, each
//     keeping states n = lane, lane + 4, lane + 8, lane + 12 in registers,
//     and two shuffles sum y.  One thread per channel would leave a chunk
//     pass at B = 1 (16,384 channels) with about four warps an SM; four
//     lanes a channel give it four times as many, and each thread makes a
//     quarter of the exponentials of a step;
//   * time is staged in tiles of 32 steps: dt and x (32 contiguous channels
//     a row, coalesced) and B_t, C_t (shared by every channel of the row)
//     go through shared memory once a CTA; the next tile's loads are issued
//     into registers before the current tile's arithmetic, so they are in
//     flight while it runs;
//   * y goes out through shared memory, a tile at a time, coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                  // per CTA
constexpr int kLanes = 4;                      // lanes sharing one channel
constexpr int kPerLane = 4;                    // states a lane keeps
constexpr int kMaxN = kLanes * kPerLane;       // 16
constexpr int kChannels = kThreads / kLanes;   // 32 channels a CTA
constexpr int kSteps = 32;                     // time steps a staged tile
constexpr int kRowsPerPass = kThreads / kChannels;        // 4
constexpr int kRowLoads = kSteps / kRowsPerPass;          // 8 a thread
constexpr int kBCRowsPerPass = kThreads / kMaxN;          // 8
constexpr int kBCLoads = kSteps / kBCRowsPerPass;         // 4 a thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

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
  int S, di, N;
  // element strides of the batch and time axes (the last axis is contiguous)
  long long dt_sb, dt_st, b_sb, b_st, c_sb, c_st, x_sb, x_st;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba_scan_kernel(Args a) {
  __shared__ float s_dt[kSteps][kChannels];
  __shared__ float s_x[kSteps][kChannels];
  __shared__ float s_y[kSteps][kChannels];
  __shared__ float s_b[kSteps][kMaxN];
  __shared__ float s_c[kSteps][kMaxN];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;       // lane within the channel's four
  const int ch = tid / kLanes;         // channel within the CTA
  const int c = c0 + ch;
  const bool live = c < a.di;
  const int S = a.S, di = a.di, N = a.N;

  const T* dt = static_cast<const T*>(a.dt) + b * a.dt_sb;
  const T* xs = static_cast<const T*>(a.x) + b * a.x_sb;
  const T* bm = static_cast<const T*>(a.bm) + b * a.b_sb;
  const T* cm = static_cast<const T*>(a.cm) + b * a.c_sb;
  T* y = static_cast<T*>(a.y) + static_cast<long long>(b) * S * di;

  // this thread's states n = lane + kLanes * i; n >= N keeps A = 0, h = 0
  // and B = 0, so it stays 0 and adds nothing to y
  const long long hrow = (static_cast<long long>(b) * di + c) * N;
  float h[kPerLane], Av[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int n = lane + kLanes * i;
    const bool ok = live && n < N;
    Av[i] = ok ? a.A[static_cast<long long>(c) * N + n] : 0.f;
    h[i] = (ok && a.h0 != nullptr) ? a.h0[hrow + n] : 0.f;
  }
  const float Dv = live ? a.D[c] : 0.f;

  // tile loads: dt/x element (row lr + kRowsPerPass * k, column lc);
  // B/C element (row br + kBCRowsPerPass * k, state bn)
  const int lc = tid % kChannels, lr = tid / kChannels;
  const int bn = tid % kMaxN, br = tid / kMaxN;
  const bool col_ok = c0 + lc < di;
  float r_dt[kRowLoads], r_x[kRowLoads], r_b[kBCLoads], r_c[kBCLoads];

  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int t = t0 + lr + kRowsPerPass * k;
      const bool ok = col_ok && t < S;
      r_dt[k] = ok ? to_f(dt[t * a.dt_st + c0 + lc]) : 0.f;
      r_x[k] = ok ? to_f(xs[t * a.x_st + c0 + lc]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBCLoads; ++k) {
      const int t = t0 + br + kBCRowsPerPass * k;
      const bool ok = bn < N && t < S;
      r_b[k] = ok ? to_f(bm[t * a.b_st + bn]) : 0.f;
      r_c[k] = ok ? to_f(cm[t * a.c_st + bn]) : 0.f;
    }
  };

  const int tiles = (S + kSteps - 1) / kSteps;
  load(0);
  for (int tile = 0; tile < tiles; ++tile) {
    const int t0 = tile * kSteps;
    __syncthreads();               // the previous tile is read and written out
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      s_dt[lr + kRowsPerPass * k][lc] = r_dt[k];
      s_x[lr + kRowsPerPass * k][lc] = r_x[k];
    }
#pragma unroll
    for (int k = 0; k < kBCLoads; ++k) {
      s_b[br + kBCRowsPerPass * k][bn] = r_b[k];
      s_c[br + kBCRowsPerPass * k][bn] = r_c[k];
    }
    __syncthreads();
    if (tile + 1 < tiles) load(t0 + kSteps);   // in flight during the loop

    const int steps = min(kSteps, S - t0);
    for (int t = 0; t < steps; ++t) {
      const float dtv = s_dt[t][ch], xv = s_x[t][ch];
      const float dx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int n = lane + kLanes * i;
        const float dA = expf(dtv * Av[i]);
        h[i] = fmaf(dA, h[i], dx * s_b[t][n]);
        acc = fmaf(h[i], s_c[t][n], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (lane == 0) s_y[t][ch] = acc + Dv * xv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kRowLoads; ++k) {
      const int r = lr + kRowsPerPass * k;
      if (col_ok && t0 + r < S)
        from_f(s_y[r][lc], y + static_cast<long long>(t0 + r) * di + c0 + lc);
    }
  }

  if (a.hN != nullptr) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int n = lane + kLanes * i;
      if (live && n < N) a.hN[hrow + n] = h[i];
    }
  }
}

}  // namespace

// dtype codes (of dt, Bm, Cm, x and y): 0 float32, 1 bfloat16.  h0 and hN
// may be null.  Strides are in elements: the
// batch and time strides of dt, Bm, Cm and x (their last axis contiguous).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mamba_scan_forward(
    const void* dt, const void* bm, const void* cm, const void* x,
    const void* A, const void* D, const void* h0, void* hN, void* y, int B,
    int S, int di, int N, int dtype, long long dt_sb, long long dt_st,
    long long b_sb, long long b_st, long long c_sb, long long c_st,
    long long x_sb, long long x_st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || di <= 0 || N <= 0 || N > kMaxN || B > 65535)
    return cudaErrorInvalidValue;
  Args a{dt, bm, cm, x, static_cast<const float*>(A),
         static_cast<const float*>(D), static_cast<const float*>(h0),
         static_cast<float*>(hN), y, S, di, N, dt_sb, dt_st, b_sb, b_st,
         c_sb, c_st, x_sb, x_st};
  const dim3 grid((di + kChannels - 1) / kChannels, B);
  if (dtype == 0)
    mamba_scan_kernel<float><<<grid, kThreads, 0, s>>>(a);
  else if (dtype == 1)
    mamba_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
