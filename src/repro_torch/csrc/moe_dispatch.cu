// MoE capacity dispatch (GShard) for Hopper (sm_90a): the scatter of
// tokens into per-expert capacity slots and the gate-weighted gather of
// the expert outputs back to tokens, float32 or bfloat16.
//
// Replaces the TPU kernels src/repro/kernels/moe_kernels.py
// `_scatter_kernel` and `_gather_kernel` (called in `_moe_pallas_impl`).
// The expert SwiGLU FFN between them, and the slot assignment before them
// (a one-hot cumsum), stay plain PyTorch, as they stay XLA outside the
// Pallas calls in the reference.
//
// scatter: lin (B, S, K) int32 flat slot indices (n_slots = E*C is the
//   trash slot of dropped assignments) and x (B, S, D) -> buf
//   (B, n_slots + 1, D): row lin[b, s, k] := x[b, s].  The caller zeroes
//   buf first (every slot feeds the expert FFN); dropped assignments are
//   skipped, so the trash row stays zero.
// gather: lin, out (B, n_slots, D) and gates (B, S, K) float32 (zero for
//   dropped assignments) -> y (B, S, D): y[b, s] = sum_k
//   out[b, min(lin, n_slots - 1)] * gates[b, s, k], accumulated in
//   float32.  Terms with a zero gate are skipped, so a row that holds NaN
//   (an unused slot of uninitialised memory) never reaches the output.
//
// What bounds them on the H100: bytes.  Both are pure data movement (the
// gather does 2 flops per element it reads).  The TPU kernels walk the
// S*K assignments in order with a read-modify-write into a VMEM buffer;
// here kept slots are unique, so the scatter is a parallel row copy with
// no atomics: one CTA per token (b, s) reads x[b, s] once, with 16-byte
// loads where rows allow it, and writes its K kept rows.  The gather is
// one CTA per token too, threads over D, 16-byte loads.  The TPU path
// runs only where the (E*C + 1, D) buffer fits a 4 MiB VMEM budget
// (`_supports_pallas`); these kernels have no such limit and take every
// shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ---- scatter: a row copy in units of U (16 bytes, or one element) ----
template <typename U>
__global__ void __launch_bounds__(kThreads) scatter_kernel(
    const int32_t* __restrict__ lin, const U* __restrict__ x,
    U* __restrict__ buf, int S, int K, int n_slots, int units) {
  const int bs = blockIdx.x, b = bs / S;
  const U* src = x + static_cast<size_t>(bs) * units;
  const int32_t* l = lin + static_cast<size_t>(bs) * K;
  for (int i = threadIdx.x; i < units; i += kThreads) {
    const U val = src[i];
    for (int k = 0; k < K; ++k) {
      const int slot = l[k];
      if (slot < n_slots)
        buf[(static_cast<size_t>(b) * (n_slots + 1) + slot) * units + i] = val;
    }
  }
}

// ---- gather: VEC elements at a time, float32 accumulation ----
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using U = float4;
  __device__ static void to_f(const U& u, float* f) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ static U from_f(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};
template <>
struct Vec<float, 1> {
  using U = float;
  __device__ static void to_f(const U& u, float* f) { f[0] = u; }
  __device__ static U from_f(const float* f) { return f[0]; }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  using U = uint4;
  __device__ static void to_f(const U& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static U from_f(const float* f) {
    U u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
};
template <>
struct Vec<__nv_bfloat16, 1> {
  using U = __nv_bfloat16;
  __device__ static void to_f(const U& u, float* f) { f[0] = __bfloat162float(u); }
  __device__ static U from_f(const float* f) { return __float2bfloat16(f[0]); }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const int32_t* __restrict__ lin, const T* __restrict__ out,
    const float* __restrict__ gates, T* __restrict__ y, int S, int K,
    int n_slots, int D) {
  using V = Vec<T, VEC>;
  using U = typename V::U;
  const int bs = blockIdx.x, b = bs / S;
  const int units = D / VEC;
  const int32_t* l = lin + static_cast<size_t>(bs) * K;
  const float* g = gates + static_cast<size_t>(bs) * K;
  const U* rows = reinterpret_cast<const U*>(out) +
                  static_cast<size_t>(b) * n_slots * units;
  U* dst = reinterpret_cast<U*>(y) + static_cast<size_t>(bs) * units;
  for (int i = threadIdx.x; i < units; i += kThreads) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float gate = g[k];
      if (gate == 0.f) continue;             // a dropped assignment
      const int slot = min(l[k], n_slots - 1);
      float f[VEC];
      V::to_f(rows[static_cast<size_t>(slot) * units + i], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = fmaf(f[j], gate, acc[j]);
    }
    dst[i] = V::from_f(acc);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Return the cudaError_t of the
// launch (0 on success).
extern "C" int moe_scatter(const void* lin, const void* x, void* buf, int B,
                           int S, int K, int n_slots, int D, int dtype,
                           void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = D * (dtype == 0 ? 4 : 2);
  const int32_t* l = static_cast<const int32_t*>(lin);
  if (row_bytes % 16 == 0 && aligned16(x) && aligned16(buf)) {
    scatter_kernel<uint4><<<B * S, kThreads, 0, s>>>(
        l, static_cast<const uint4*>(x), static_cast<uint4*>(buf), S, K,
        n_slots, row_bytes / 16);
  } else if (dtype == 0) {
    scatter_kernel<float><<<B * S, kThreads, 0, s>>>(
        l, static_cast<const float*>(x), static_cast<float*>(buf), S, K,
        n_slots, D);
  } else {
    scatter_kernel<uint16_t><<<B * S, kThreads, 0, s>>>(
        l, static_cast<const uint16_t*>(x), static_cast<uint16_t*>(buf), S,
        K, n_slots, D);
  }
  return cudaGetLastError();
}

extern "C" int moe_gather(const void* lin, const void* out,
                          const void* gates, void* y, int B, int S, int K,
                          int n_slots, int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(lin);
  const float* g = static_cast<const float*>(gates);
  const bool vec = aligned16(out) && aligned16(y);
  if (dtype == 0) {
    const float* o = static_cast<const float*>(out);
    float* dst = static_cast<float*>(y);
    if (vec && D % 4 == 0)
      gather_kernel<float, 4><<<B * S, kThreads, 0, s>>>(l, o, g, dst, S, K, n_slots, D);
    else
      gather_kernel<float, 1><<<B * S, kThreads, 0, s>>>(l, o, g, dst, S, K, n_slots, D);
  } else if (dtype == 1) {
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(out);
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(y);
    if (vec && D % 8 == 0)
      gather_kernel<__nv_bfloat16, 8><<<B * S, kThreads, 0, s>>>(l, o, g, dst, S, K, n_slots, D);
    else
      gather_kernel<__nv_bfloat16, 1><<<B * S, kThreads, 0, s>>>(l, o, g, dst, S, K, n_slots, D);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
