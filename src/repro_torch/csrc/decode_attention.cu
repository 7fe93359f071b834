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
// byte or less; the card needs ~20 (float32 cores) before compute binds.
// What the design does about it:
//   * the KV axis is split across CTAs: grid (B*KH, splits), each CTA
//     walks one range of `chunk` tokens, so 8 slots x 16 KV heads fill the
//     132 SMs several times over (B*KH alone is 128 CTAs for olmoe, 64 for
//     llama3.2).  A CTA whose range starts at or past its slot's kv_len
//     exits at once, so only live bytes are read;
//   * the G query rows of a KV head share each K/V tile in shared memory;
//   * each CTA writes float32 partials (m, l, acc) of its range; a second
//     launch combines the live ranges of each (b, kh) with the usual
//     rescaling by exp(m_i - max m) and divides by max(l, 1e-30).
// Masked positions never enter the sums (the reference masks them with
// -1e30); a slot with kv_len 0 gets zeros, as the TPU kernel gives.

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
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

// One tile of n tokens (rows t0.. of a (T, D) slab with row stride st)
// into smem as float32, rows padded to D + 1 floats.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long st, int t0, int n, int D) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int t = i / D, d = i - t * D;
    dst[t * Dp + d] = t < n ? to_f(src[(t0 + t) * st + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ kv_len, float* __restrict__ m_ws,
    float* __restrict__ l_ws, float* __restrict__ acc_ws, int KH, int G,
    int D, int Tk, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int chunk, int splits, float scale) {
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / KH, kh = bh % KH;
  const int len = min(max(kv_len[b], 0), Tk);
  const int start = split * chunk;
  if (start >= len) return;                     // a dead range: nothing to do
  const int end = min(len, start + chunk);

  extern __shared__ float smem[];
  const int Dp = D + 1;
  float* q_s = smem;                 // G * D
  float* kv_s = q_s + G * D;         // kTile * (D + 1): K, then V
  float* p_s = kv_s + kTile * Dp;    // G * kTile: scores, then probabilities
  float* m_s = p_s + G * kTile;      // G running maxima
  float* l_s = m_s + G;              // G running sums
  float* a_s = l_s + G;              // G rescale factors of this tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;
  const size_t head = static_cast<size_t>(bh) * G * D;

  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f(q[head + i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) acc[r] = 0.f;

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();  // q staged / the previous tile's V reads are done
    load_tile<T>(kv_s, kb, kst, t0, n, D);
    __syncthreads();

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

    for (int g = warp; g < G; g += kWarps) {    // one warp per query row
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
    load_tile<T>(kv_s, vb, vst, t0, n, D);
    __syncthreads();

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

  const size_t part = static_cast<size_t>(bh) * splits + split;
#pragma unroll
  for (int r = 0; r < kMaxAcc; ++r) {
    const int j = tid + r * kThreads;
    if (j < G * D) acc_ws[part * G * D + j] = acc[r];
  }
  for (int g = tid; g < G; g += kThreads) {
    m_ws[part * G + g] = m_s[g];
    l_ws[part * G + g] = l_s[g];
  }
}

// out[b, kh, g, d] = sum_i acc_i * exp(m_i - M) / max(sum_i l_i * exp(m_i - M), 1e-30)
// over the live ranges i of (b, kh); M = max_i m_i.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const int32_t* __restrict__ kv_len, const float* __restrict__ m_ws,
    const float* __restrict__ l_ws, const float* __restrict__ acc_ws,
    T* __restrict__ out, int KH, int G, int D, int Tk, int chunk, int splits) {
  const int bh = blockIdx.x, b = bh / KH;
  const int len = min(max(kv_len[b], 0), Tk);
  const int live = min(splits, (len + chunk - 1) / chunk);
  const size_t part0 = static_cast<size_t>(bh) * splits;
  for (int j = threadIdx.x; j < G * D; j += kThreads) {
    const int g = j / D;
    float mx = kNegInf;
    for (int i = 0; i < live; ++i) mx = fmaxf(mx, m_ws[(part0 + i) * G + g]);
    float l = 0.f, a = 0.f;
    for (int i = 0; i < live; ++i) {
      const float w = expf(m_ws[(part0 + i) * G + g] - mx);
      l = fmaf(l_ws[(part0 + i) * G + g], w, l);
      a = fmaf(acc_ws[(part0 + i) * G * D + j], w, a);
    }
    from_f(a / fmaxf(l, 1e-30f), out + static_cast<size_t>(bh) * G * D + j);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* m_ws, void* l_ws,
                   void* acc_ws, int B, int KH, int G, int D, int Tk,
                   long long ksb, long long ksh, long long kst, long long vsb,
                   long long vsh, long long vst, int chunk, int splits,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (G * D + kTile * (D + 1) + G * kTile + 3 * G);
  auto split_kernel = decode_split_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  split_kernel<<<dim3(B * KH, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),
      static_cast<float*>(m_ws), static_cast<float*>(l_ws),
      static_cast<float*>(acc_ws), KH, G, D, Tk, ksb, ksh, kst, vsb, vsh, vst,
      chunk, splits, 1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine_kernel<T><<<B * KH, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(kv_len), static_cast<const float*>(m_ws),
      static_cast<const float*>(l_ws), static_cast<const float*>(acc_ws),
      static_cast<T*>(out), KH, G, D, Tk, chunk, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16 (q, k, v and out alike).  Strides are
// in elements.  m_ws / l_ws hold B*KH*splits*G floats, acc_ws
// B*KH*splits*G*D.  Returns the cudaError_t of the launches (0 on success).
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* m_ws, void* l_ws, void* acc_ws, int B, int KH, int G,
    int D, int Tk, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int chunk, int splits, int dtype,
    void* stream) {
  if (G * D > kThreads * kMaxAcc || (D != 64 && D != 128) || chunk < 1 ||
      splits < 1 || static_cast<long long>(chunk) * splits < Tk)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARGS q, k, v, kv_len, out, m_ws, l_ws, acc_ws, B, KH, G, D, Tk, ksb, ksh, kst, vsb, vsh, vst, chunk, splits, s
  if (dtype == 0) return launch<float>(ARGS);
  if (dtype == 1) return launch<__nv_bfloat16>(ARGS);
#undef ARGS
  return cudaErrorInvalidValue;
}
