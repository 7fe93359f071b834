// Blockwise flash attention forward for Hopper (sm_90a): causal or full,
// GQA, float32 or bfloat16, head dim 64 or 128, any S and any T >= S.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `_flash_kernel` (called through `flash_attention`).
//
// q (B, H, S, D); k, v (B, KH, T, D); query head h reads KV head
// h / (H / KH).  Causal masks key t for query s when t > s, both counted
// from 0 (so a query row attends a cache row's leading positions).  Output
// (B, H, S, D) in q's type.
//
// What bounds it on the H100: operations.  Prefill attention does 4*D
// flops per (query, key) pair on 2*D input elements per key tile shared by
// a whole 64-row query tile, far above the card's flops-per-byte balance.
// The design keeps everything a tile needs on chip and skips work that
// the mask would throw away:
//   * one CTA per (64-query tile, b, h); K and V stream through shared
//     memory in 64-key tiles, read once per query tile;
//   * tiles wholly above the diagonal are never loaded (causal), and the
//     ragged edges (S and T not multiples of 64) are masked in the kernel
//     rather than padded or sent elsewhere;
//   * an online softmax keeps (m, l) and the output accumulator in
//     registers, float32 throughout; 256 threads each own a 4 x 4 block of
//     the 64 x 64 score tile and a 4 x (D / 16) block of the output.
// The products run on the float32 CUDA cores, not the tensor cores
// (mma.sync / wgmma with TMA-fed tiles is the fast form, later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // 16 x 16 threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) { *dst = __float2bfloat16(x); }

// rows x D tile of a (len, D) matrix starting at row r0 -> smem with rows
// padded to D + 1 floats; rows past len are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int rows, int len) {
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D, d = i - r * D;
    dst[r * (D + 1) + d] =
        r0 + r < len ? to_f(src[static_cast<size_t>(r0 + r) * D + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int KH, int S, int Tk, int causal,
    float scale) {
  constexpr int Dp = D + 1;
  constexpr int DJ = D / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // BQ * (D + 1)
  float* kv_s = q_s + BQ * Dp;         // BK * (D + 1): K, then V
  float* p_s = kv_s + BK * Dp;         // BQ * (BK + 1)

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / (H / KH);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + static_cast<size_t>(bh) * S * D;
  const T* kb = k + (static_cast<size_t>(b) * KH + kh) * Tk * D;
  const T* vb = v + (static_cast<size_t>(b) * KH + kh) * Tk * D;

  load_rows<T, D>(q_s, qb, q0, BQ, S);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;   // skip tiles above
  for (int k0 = 0; k0 < k_end; k0 += BK) {               // the diagonal
    __syncthreads();   // q loaded / the previous tile's V reads are done
    load_rows<T, D>(kv_s, kb, k0, BK, Tk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * Dp + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * Dp + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each of this thread's rows;
    // a row's 64 scores are spread over the 16 threads sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < Tk && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();   // K reads done, p_s complete
    load_rows<T, D>(kv_s, vb, k0, BK, Tk);
    __syncthreads();

    const int n = min(BK, Tk - k0);
    for (int c = 0; c < n; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = kv_s[c * Dp + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + static_cast<size_t>(bh) * S * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r < S) {
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        from_f(acc[i][j] * inv, ob + static_cast<size_t>(r) * D + tx + 16 * j);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KH, int S, int Tk, int causal,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (D + 1) + BK * (D + 1) +
                                       BQ * (BK + 1));
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KH, S, Tk, causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KH, int S, int T,
                               int D, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < S || H % KH != 0) return cudaErrorInvalidValue;
  if (dtype == 0 && D == 64) return launch<float, 64>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, H, KH, S, T, causal, s);
  return cudaErrorInvalidValue;
}
