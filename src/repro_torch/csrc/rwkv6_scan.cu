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
// All arithmetic is float32.
//
// What bounds it on the H100: bytes.  Each of r, k, v, w is read once and
// out written once (5 N-vectors per step against ~5 N^2 flops, about
// 13 flops a byte in float32 at N = 64, under the card's balance), and the
// state never leaves the chip.  The design:
//   * one CTA per (b, h), N threads; thread j owns column j of S in N
//     registers, so the state is neither stored nor shared;
//   * each step stages r_t, k_t and w_t (N floats each) in shared memory,
//     read by every thread as a broadcast; thread j reads v_t[j] itself;
//   * the next step's four values are loaded into registers while the
//     current step computes, so the global loads overlap the arithmetic.
// The sequence is walked in order inside one CTA (the recurrence is
// sequential), so B * H CTAs of N threads run at once: 256 CTAs of 64
// threads at (8, 32, 256, 64) leave most of each SM idle, and the per-step
// latency, not the bytes, sets the time.  A chunked form that splits T
// across CTAs (and a backward kernel) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_fwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    T* __restrict__ out, int H, int Tlen) {
  __shared__ float r_s[N], k_s[N], w_s[N], u_s[N];
  const int bh = blockIdx.x, h = bh % H, j = threadIdx.x;
  const size_t base = static_cast<size_t>(bh) * Tlen * N + j;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = 0.f;
  u_s[j] = u[h * N + j];

  float rn = to_f(r[base]), kn = to_f(k[base]), vn = to_f(v[base]);
  float wn = w[base];
  for (int t = 0; t < Tlen; ++t) {
    __syncthreads();             // every thread is done with step t - 1
    r_s[j] = rn;
    k_s[j] = kn;
    w_s[j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < Tlen) {          // prefetch step t + 1
      const size_t nx = base + static_cast<size_t>(t + 1) * N;
      rn = to_f(r[nx]);
      kn = to_f(k[nx]);
      vn = to_f(v[nx]);
      wn = w[nx];
    }
    float o = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = k_s[i] * vj;
      o = fmaf(r_s[i], fmaf(u_s[i], kv, S[i]), o);
      S[i] = fmaf(w_s[i], S[i], kv);
    }
    from_f(o, out + base + static_cast<size_t>(t) * N);
  }
}

template <typename T, int N>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, int B, int H, int Tlen,
                   cudaStream_t stream) {
  wkv6_fwd_kernel<T, N><<<B * H, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<T*>(out), H, Tlen);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (of r, k, v and out): 0 float32, 1 bfloat16.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int wkv6_forward(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* out, int B,
                            int H, int T, int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || T <= 0) return cudaErrorInvalidValue;
  if (dtype == 0 && N == 64) return launch<float, 64>(r, k, v, w, u, out, B, H, T, s);
  if (dtype == 0 && N == 32) return launch<float, 32>(r, k, v, w, u, out, B, H, T, s);
  if (dtype == 1 && N == 64)
    return launch<__nv_bfloat16, 64>(r, k, v, w, u, out, B, H, T, s);
  if (dtype == 1 && N == 32)
    return launch<__nv_bfloat16, 32>(r, k, v, w, u, out, B, H, T, s);
  return cudaErrorInvalidValue;
}
