// Split-KV flash-decode attention over a paged KV pool for Hopper
// (sm_90a): float32 / bfloat16 pools, and int8 pools with per-token
// float32 scales, head dim 64 or 128.
//
// Replaces the TPU kernels src/repro/kernels/paged_decode_attention.py
// `_paged_kernel` (fp pools) and `_paged_kernel_quant` (int8 pools).
//
// Computes, for every slot b and KV head kh, the attention of the G query
// rows of that head group (q (B, KH, G, D)) over the slot's first
// kv_len[b] cached tokens, which live in pool blocks (NB, bs, KH, D)
// named by block_tables[b, page]: token pos of slot b is pool row
// (block_tables[b, pos / bs] * bs + pos % bs) * KH + kh.  Output
// (B, KH, G, D) in q's type; q float32 or bfloat16, fp pools in q's type,
// or int8 pools with (NB, bs, KH) float32 scales.  Any block size.
//
// The body, what bounds it and its design are decode_common.cuh's, the
// same as dense decode's; this file supplies the source of token t, read
// through the block table:
//   * a CTA reads the table entries its range touches once, into shared
//     memory; it never reads an entry at or past ceil(kv_len / bs), so the
//     trash block 0 that unused entries name is never touched.  A range
//     may span several pages and a page several ranges;
//   * K and V rows go by 16-byte cp.async in the pool's dtype (an int8
//     row is 64 or 128 bytes), an int8 row's two scales by 4-byte
//     cp.async beside them; the body folds the scales into its products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "decode_common.cuh"

namespace {

using namespace decode_common;

// 4 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

template <typename T, int D>
struct PagedRows {
  using KT = T;
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const T* k_pool;
  const T* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  int KH, bs, pages;
  int kh = 0, p0 = 0;
  const int* tab = nullptr;           // entries p0 .. of this CTA's row

  // table entries a range of `chunk` tokens can touch
  static int scratch_entries(int chunk, int bs) { return (chunk - 1) / bs + 2; }

  __device__ int length(int n) const { return min(max(n, 0), pages * bs); }
  __device__ void begin(int b, int kh_, int start, int end, void* scratch) {
    kh = kh_;
    p0 = start / bs;
    int* t = static_cast<int*>(scratch);
    const int32_t* row = tables + static_cast<size_t>(b) * pages + p0;
    for (int i = threadIdx.x; i < (end - 1) / bs - p0 + 1; i += kThreads)
      t[i] = row[i];
    tab = t;
    __syncthreads();
  }
  __device__ size_t row_of(int pos) const {     // pool row of token pos
    return (static_cast<size_t>(tab[pos / bs - p0]) * bs + pos % bs) * KH + kh;
  }
  __device__ void load(T* k_dst, T* v_dst, float* ks_dst, float* vs_dst,
                       int t0, int n) const {
    constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte chunk
    constexpr int CPR = D / EPC;            // chunks per row
    for (int i = threadIdx.x; i < kTile * CPR; i += kThreads) {
      const int t = i / CPR, c = i % CPR;
      const bool ok = t < n;
      const size_t row = ok ? row_of(t0 + t) : 0;
      cp_async16(k_dst + t * D + c * EPC, k_pool + row * D + c * EPC, ok);
      cp_async16(v_dst + t * D + c * EPC, v_pool + row * D + c * EPC, ok);
    }
    if constexpr (kQuant) {
      for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const bool ok = t < n;
        const size_t row = ok ? row_of(t0 + t) : 0;
        cp_async4(ks_dst + t, k_scale + row, ok);
        cp_async4(vs_dst + t, v_scale + row, ok);
      }
    }
  }
};

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ kv_len, QT* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int KH, int G,
    int bs, int pages, int chunk, int splits, float scale_log2) {
  PagedRows<KT, D> src{k_pool, v_pool, k_scale, v_scale, tables, KH, bs,
                       pages};
  split_decode<QT, D>(src, q, kv_len, out, part, tickets, KH, G, chunk,
                      splits, scale_log2);
}

template <typename QT, typename KT, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* kv_len, void* out,
                   void* part, void* tickets, int B, int KH, int G, int bs,
                   int pages, int chunk, int splits, cudaStream_t stream) {
  using Src = PagedRows<KT, D>;
  const int smem = body_smem(sizeof(KT), D, G, Src::kQuant) +
                   static_cast<int>(sizeof(int)) *
                       Src::scratch_entries(chunk, bs);
  auto kernel = paged_split_kernel<QT, KT, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(splits, B * KH), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(kv_len), static_cast<QT*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), KH, G, bs,
      pages, chunk, splits, kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch(int D, const void* q, const void* k_pool,
                     const void* v_pool, const void* k_scale,
                     const void* v_scale, const void* tables,
                     const void* kv_len, void* out, void* part,
                     void* tickets, int B, int KH, int G, int bs, int pages,
                     int chunk, int splits, cudaStream_t s) {
#define ARGS q, k_pool, v_pool, k_scale, v_scale, tables, kv_len, out, part, tickets, B, KH, G, bs, pages, chunk, splits, s
  return D == 64 ? launch<QT, KT, 64>(ARGS) : launch<QT, KT, 128>(ARGS);
#undef ARGS
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, out, fp pools), 2 int8 (pools
// only; needs the scales).  Pools 16-byte aligned.  `part` holds
// B*KH*splits*(G*D + 4*ceil(2G/4)) floats (16-byte aligned); `tickets`
// B*KH ints, zero before the first call (the kernel leaves them zero).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_len, void* out, void* part, void* tickets, int B, int KH,
    int G, int D, int bs, int pages, int chunk, int splits, int q_dtype,
    int kv_dtype, void* stream) {
  if (G < 1 || G * D > 2048 || (D != 64 && D != 128) || bs < 1 ||
      pages < 1 || chunk < 1 || chunk % kTile != 0 || splits < 1 ||
      static_cast<long long>(chunk) * splits < static_cast<long long>(pages) * bs)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS D, q, k_pool, v_pool, k_scale, v_scale, tables, kv_len, out, part, tickets, B, KH, G, bs, pages, chunk, splits, s
  if (q_dtype == 0 && kv_dtype == 0) return dispatch<float, float>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return dispatch<float, int8_t>(ARGS);
  if (q_dtype == 1 && kv_dtype == 2) return dispatch<__nv_bfloat16, int8_t>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}
