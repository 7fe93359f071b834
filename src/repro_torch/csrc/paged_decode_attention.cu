// Paged flash-decode attention for Hopper (sm_90a), float32 / bfloat16
// pools and int8 pools with per-(slot, head) float32 scales.
//
// Replaces the TPU kernels src/repro/kernels/paged_decode_attention.py
// `_paged_kernel` (fp pools) and `_paged_kernel_quant` (int8 pools).
//
// Computes, for every slot b and KV head kh, the attention of the G query
// rows of that head group (q (B, KH, G, D)) over the slot's first
// kv_len[b] cached tokens, which live in pool blocks (NB, bs, KH, D)
// named by block_tables[b, page].  Output (B, KH, G, D) in q's type.
//
// What bounds it on the H100: bytes.  Each query row does 4*D flops per
// cached token against 2*D*sizeof(pool) bytes of K and V, about one flop
// per byte in float32 - far below the ~20 flops/byte at which float32
// compute, let alone the tensor cores, would be the limit.  So the design
// reads every live K/V byte once and nothing else:
//   * one CTA per (b, kh): the G query rows of a KV head share each K/V
//     tile, which is read from device memory once for all G rows;
//   * the CTA reads its own block-table row and kv_len (there is no
//     scalar prefetch on this card) and walks only the pages below
//     ceil(kv_len / bs); unused table entries (the trash block 0) are
//     never read;
//   * int8 pools halve (bf16) or quarter (f32) the bytes and are
//     dequantized by the slot's scale in shared memory before the dot;
//   * an online softmax keeps (m, l) per row in shared memory and the
//     accumulator in registers, all float32.
// With B*KH CTAs (64 at the engine's 8 slots x 8 KV heads) fewer than the
// 132 SMs are busy; a split-KV variant with a combine pass, which spreads
// one slot's pages over several CTAs, is later work (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;    // cached tokens per shared-memory tile
constexpr int kMaxAcc = 8;   // accumulators per thread: G * D <= 2048
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

// Copy one tile of n cached tokens (K or V) into smem as float32, rows
// padded to D + 1 floats so the per-token dot products hit distinct banks.
template <typename KT, bool QUANT>
__device__ __forceinline__ void load_tile(
    float* dst, const KT* __restrict__ pool, const float* __restrict__ scale,
    const int32_t* __restrict__ table, int t0, int n, int KH, int kh, int D,
    int bs) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int t = i / D, d = i - t * D;
    float x = 0.f;
    if (t < n) {
      const int pos = t0 + t;
      const size_t row =
          (static_cast<size_t>(table[pos / bs]) * bs + pos % bs) * KH + kh;
      x = to_f(pool[row * D + d]);
      if (QUANT) x *= scale[row];
    }
    dst[t * Dp + d] = x;
  }
}

template <typename QT, typename KT, bool QUANT>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ kv_len, QT* __restrict__ out, int KH, int G,
    int D, int bs, int pages, float scale) {
  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* q_s = smem;                 // G * D
  float* kv_s = q_s + G * D;         // kTile * (D + 1): K, then V
  float* p_s = kv_s + kTile * Dp;    // G * kTile: scores, then probabilities
  float* m_s = p_s + G * kTile;      // G running maxima
  float* l_s = m_s + G;              // G running sums
  float* a_s = l_s + G;              // G rescale factors of this tile

  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t* table = tables + static_cast<size_t>(b) * pages;
  const int len = min(kv_len[b], pages * bs);
  const size_t head = (static_cast<size_t>(b) * KH + kh) * G * D;

  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f(q[head + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
    __syncthreads();  // the previous tile's V reads are done
    load_tile<KT, QUANT>(kv_s, k_pool, k_scale, table, t0, n, KH, kh, D, bs);
    __syncthreads();

    // scores s[g][t] = q[g] . k[t] * scale
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, t = i - g * kTile;
      float s = kNegInf;
      if (t < n) {
        const float* qr = q_s + g * D;
        const float* kr = kv_s + t * Dp;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* pr = p_s + g * kTile;
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = t < n ? expf(pr[t] - m_new) : 0.f;
        pr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    load_tile<KT, QUANT>(kv_s, v_pool, v_scale, table, t0, n, KH, kh, D, bs);
    __syncthreads();

    // acc[g][d] = acc * alpha[g] + sum_t p[g][t] * v[t][d]
#pragma unroll
    for (int r = 0; r < kMaxAcc; ++r) {
      const int j = tid + r * kThreads;
      if (j < G * D) {
        const int g = j / D, d = j - g * D;
        const float* pr = p_s + g * kTile;
        float a = acc[r] * a_s[g];
        for (int t = 0; t < n; ++t) a = fmaf(pr[t], kv_s[t * Dp + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int j = tid + r * kThreads;
    if (j < G * D) {
      const int g = j / D;
      from_f(acc[r] / fmaxf(l_s[g], 1e-30f), out + head + j);
    }
  }
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* kv_len, void* out, int B,
                   int KH, int G, int D, int bs, int pages,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (G * D + kTile * (D + 1) + G * kTile + 3 * G);
  auto kernel = paged_decode_kernel<QT, KT, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * KH, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(kv_len), static_cast<QT*>(out), KH, G, D,
      bs, pages, 1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (pools only; needs scales).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* kv_len, void* out, int B, int KH, int G, int D, int bs,
    int pages, int q_dtype, int kv_dtype, void* stream) {
  if (G * D > kThreads * kMaxAcc || D > 256) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k_pool, v_pool, k_scale, v_scale, tables, kv_len, out, B, KH, G, D, bs, pages, s
  if (q_dtype == 0 && kv_dtype == 0) return launch<float, float, false>(ARGS);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(ARGS);
  if (q_dtype == 0 && kv_dtype == 2) return launch<float, int8_t, true>(ARGS);
  if (q_dtype == 1 && kv_dtype == 2)
    return launch<__nv_bfloat16, int8_t, true>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}
