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
// The body, what bounds it and its design are decode_common.cuh's: this
// file supplies the source of token t (row b, head kh, token t at
// k + b*ksb + kh*ksh + t*kst), copied by 16-byte cp.async, or element by
// element where a base or stride is not a 16-byte multiple.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// tokens t0 .. t0 + n - 1 of a (T, D) slab with row stride st into a
// (kTile, D) stage; rows past n are zero
template <typename T, int D, bool VEC>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
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

template <typename T, int D, bool VEC>
struct DenseRows {
  using KT = T;
  static constexpr bool kQuant = false;
  const T* k;
  const T* v;
  long long ksb, ksh, kst, vsb, vsh, vst;
  int Tk;
  const T* kb = nullptr;
  const T* vb = nullptr;

  __device__ int length(int n) const { return min(max(n, 0), Tk); }
  __device__ void begin(int b, int kh, int, int, void*) {
    kb = k + b * ksb + kh * ksh;
    vb = v + b * vsb + kh * vsh;
  }
  __device__ void load(T* k_dst, T* v_dst, float*, float*, int t0,
                       int n) const {
    load_rows<T, D, VEC>(k_dst, kb, kst, t0, n);
    load_rows<T, D, VEC>(v_dst, vb, vst, t0, n);
  }
};

template <typename T, int D, bool VEC>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ kv_len, T* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int KH, int G,
    int Tk, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int chunk, int splits, float scale_log2) {
  DenseRows<T, D, VEC> src{k, v, ksb, ksh, kst, vsb, vsh, vst, Tk};
  split_decode<T, D>(src, q, kv_len, out, part, tickets, KH, G, chunk,
                     splits, scale_log2);
}

template <typename T, int D, bool VEC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* part, void* tickets,
                   int B, int KH, int G, int Tk, long long ksb, long long ksh,
                   long long kst, long long vsb, long long vsh, long long vst,
                   int chunk, int splits, cudaStream_t stream) {
  const int smem = body_smem(sizeof(T), D, G, false);
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
