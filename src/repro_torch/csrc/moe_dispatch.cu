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
//   (B, n_slots + 1, D): row lin[b, s, k] := x[b, s]; every other row,
//   the trash row included, := 0.  The kernel writes every row of buf
//   exactly once, so buf may come from an uninitialised allocation (the
//   TPU kernel zeroes its VMEM buffer inside the kernel too).
// gather: lin, out (B, n_slots, D) and gates (B, S, K) float32 (zero for
//   dropped assignments) -> y (B, S, D): y[b, s] = sum_k
//   out[b, min(lin, n_slots - 1)] * gates[b, s, k], accumulated in
//   float32 in k order.  A row whose gate is zero is never loaded, so a row
//   that holds NaN (an unused slot of uninitialised memory) never reaches
//   the output.
//
// What bounds them on the H100: bytes.  The scatter writes the whole
// (n_slots + 1, D) buffer, mostly zeros (olmoe's decode step: 33.6 MB for
// 64 live rows); the gather reads the K live rows of each token and writes
// one.  The TPU kernels walk the S*K assignments in order with a
// read-modify-write into VMEM, one grid step a batch row.  Here:
//   * scatter: one pass over the buffer.  The grid runs over the buffer,
//     not the tokens: (tiles of 16 slot rows, chunks of 64 16-byte units
//     of a row, B), a thousand or more CTAs at the decode shapes.  Each
//     CTA learns which token fills each of its 16 rows (slot -> token, -1
//     for none) into shared memory, then each thread loads the x units of
//     its 4 rows (zero for an empty row) before it stores any, so the
//     loads are in flight together.  Kept slots are unique: no atomics,
//     and the copy is exact.  Where S*K is small each CTA scans lin[b]
//     itself, four loads in flight a thread: one launch.  But all CTAs
//     then read ~0.31 (S*K)^2 * chunks lin bytes, which grows past the
//     buffer's own bytes as S*K passes ~1,000; so from the wrapper's
//     SCATTER_MAP_MIN up, a first launch writes slot_map[b, lin] = i for
//     each kept assignment into an uninitialised workspace, and a CTA
//     reads its 16 entries and trusts one only where lin[b, i] names the
//     slot back.  The map's launch costs ~0.002-0.004 ms at S*K 16-2,048
//     and breaks even at S*K 5,600-8,192; at olmoe's prefill S 4096 f32
//     (S*K 32,768) the scatter takes 0.146 ms with it, 0.280 without and
//     0.220 as the old memset and copy (tools/moe_ab.py on the H100);
//   * gather: grid (tokens, chunks of D), one 16-byte unit a thread.  A
//     thread reads its token's K slots and gates, then issues its row
//     loads (each predicated on its gate) before the first FMA: one DRAM
//     round trip, not K in series.  CTAs are one warp while that grid
//     fits on the card at once, so 8 decode tokens launch 64-512 CTAs;
//     past that, four warps, as one-warp CTAs cap an SM at 32 warps (at
//     jamba's prefill S 4096 f32 they read 0.164 ms against 0.142).  K 8
//     (olmoe) loads in one batch without bounds tests, any other K in
//     predicated batches of 4: at olmoe's decode in f32 the exact batch
//     took 0.0026 ms of device time against 0.0030 predicated, and
//     batches of 8 for jamba's K 2 held enough registers live to lose to
//     the old kernel in bf16 at prefill S 700 (0.0212 against 0.0202 ms;
//     batches of 4: 0.0195).  A thread a token looping over D (the old
//     grid) and CTAs ordered chunk-major were slower (tools/moe_ab.py,
//     PERF.md).
// The scatter's tile (16 slot rows x 64 units, 256 threads) was picked by
// a sweep on the H100 at olmoe's and jamba's decode and chunk shapes
// (16-64 rows, 32-128 units).
// Rows that are not 16-byte aligned (odd D, misaligned views) take the
// same kernels one element a unit.  The TPU path runs only where the
// (E*C + 1, D) buffer fits a 4 MiB VMEM budget (`_supports_pallas`); these
// kernels have no such limit.  CUDA rather than Triton: the two kernels
// share this file and one ctypes binding, and the scatter's shared-memory
// inverse map is a scalar scatter that Triton's block model does not
// express directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- scatter ----
constexpr int kScatterThreads = 256;
constexpr int kScatterCols = 64;                  // units of a row a CTA
constexpr int kScatterRows = 16;                  // slot rows a CTA
constexpr int kRowGroups = kScatterThreads / kScatterCols;
constexpr int kRowsPerThread = kScatterRows / kRowGroups;
constexpr int kMapLoads = 4;                      // lin loads in flight

// many assignments: a first launch writes slot_map[b, lin[b, i]] = i for
// every kept i; entries of unfilled slots stay as the allocation left them
__global__ void moe_scatter_map_kernel(const int32_t* __restrict__ lin,
                                       int32_t* __restrict__ slot_map,
                                       int SK, int n_slots, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = i / SK, slot = lin[i];
  if (static_cast<unsigned>(slot) < static_cast<unsigned>(n_slots))
    slot_map[static_cast<size_t>(b) * n_slots + slot] = i - b * SK;
}

// U: a 16-byte unit (uint4), or one element (float, uint16_t); U{} is 0.
// slot_map null: each CTA scans lin[b] for its rows; else it reads its
// rows' entries and keeps one only where lin agrees (kept slots are unique)
template <typename U>
__global__ void __launch_bounds__(kScatterThreads) moe_scatter_kernel(
    const int32_t* __restrict__ lin, const int32_t* __restrict__ slot_map,
    const U* __restrict__ x, U* __restrict__ buf, int S, int K, int n_slots,
    int units) {
  __shared__ int tok[kScatterRows];               // slot row -> token or -1
  const int b = blockIdx.z, r0 = blockIdx.x * kScatterRows;
  const int tid = threadIdx.x;
  const int SK = S * K;
  const int32_t* l = lin + static_cast<size_t>(b) * SK;
  if (slot_map) {
    if (tid < kScatterRows) {
      const int r = r0 + tid;
      int t = -1;
      if (r < n_slots) {
        const unsigned i = static_cast<unsigned>(
            slot_map[static_cast<size_t>(b) * n_slots + r]);
        if (i < static_cast<unsigned>(SK) && l[i] == r) t = i / K;
      }
      tok[tid] = t;
    }
  } else {
    if (tid < kScatterRows) tok[tid] = -1;
    __syncthreads();
    for (int i0 = tid; i0 < SK; i0 += kMapLoads * kScatterThreads) {
      int slot[kMapLoads];
#pragma unroll
      for (int j = 0; j < kMapLoads; ++j) {
        const int i = i0 + j * kScatterThreads;
        slot[j] = i < SK ? l[i] : -1;
      }
#pragma unroll
      for (int j = 0; j < kMapLoads; ++j) {
        const int r = slot[j] - r0;           // the trash slot is never kept
        if (slot[j] < n_slots && r >= 0 && r < kScatterRows)
          tok[r] = (i0 + j * kScatterThreads) / K;
      }
    }
  }
  __syncthreads();
  const int u = blockIdx.y * kScatterCols + tid % kScatterCols;
  if (u >= units) return;
  const int rg = tid / kScatterCols;
  const U* src = x + static_cast<size_t>(b) * S * units + u;
  U* dst = buf + static_cast<size_t>(b) * (n_slots + 1) * units + u;
  U val[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = tok[rg + i * kRowGroups];
    val[i] = t >= 0 ? src[static_cast<size_t>(t) * units] : U{};
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = r0 + rg + i * kRowGroups;
    if (r <= n_slots) dst[static_cast<size_t>(r) * units] = val[i];
  }
}

// ---- gather: VEC elements a unit, float32 accumulation ----
// CTAs of one warp while that grid fits on the card at once (32 resident
// CTAs on each of the H100's 132 SMs): 8 decode tokens then launch 64-512
// CTAs.  Past that, four warps, since one-warp CTAs would cap an SM at 32.
constexpr int kGatherWarpCtas = 132 * 32;
constexpr int kGatherWide = 128;

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  using U = float4;
  __device__ static U zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void to_f(const U& u, float* f) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  __device__ static U from_f(const float* f) { return make_float4(f[0], f[1], f[2], f[3]); }
};
template <>
struct Vec<float, 1> {
  using U = float;
  __device__ static U zero() { return 0.f; }
  __device__ static void to_f(const U& u, float* f) { f[0] = u; }
  __device__ static U from_f(const float* f) { return f[0]; }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  using U = uint4;
  __device__ static U zero() { return make_uint4(0u, 0u, 0u, 0u); }
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
  __device__ static U zero() { return __float2bfloat16(0.f); }
  __device__ static void to_f(const U& u, float* f) { f[0] = __bfloat162float(u); }
  __device__ static U from_f(const float* f) { return __float2bfloat16(f[0]); }
};

// one unit a thread.  Its K row loads go out together, KB at a time:
// K 8 (olmoe) in one batch without bounds tests (EXACT), any other K in
// predicated batches of 4, which keep fewer registers live for K 2
template <typename T, int VEC, int THREADS, int KB, bool EXACT>
__global__ void __launch_bounds__(THREADS) moe_gather_kernel(
    const int32_t* __restrict__ lin, const T* __restrict__ out,
    const float* __restrict__ gates, T* __restrict__ y, int S, int K,
    int n_slots, int units) {
  using V = Vec<T, VEC>;
  using U = typename V::U;
  const int bs = blockIdx.x, b = bs / S;
  const int u = blockIdx.y * THREADS + threadIdx.x;
  if (u >= units) return;
  const int32_t* l = lin + static_cast<size_t>(bs) * K;
  const float* g = gates + static_cast<size_t>(bs) * K;
  const U* rows = reinterpret_cast<const U*>(out) +
                  static_cast<size_t>(b) * n_slots * units + u;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KB) {
    float gk[KB];
    int slot[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const bool in = EXACT || k0 + j < K;
      gk[j] = in ? g[k0 + j] : 0.f;
      slot[j] = in ? min(l[k0 + j], n_slots - 1) : 0;
    }
    U v[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) {  // a zero gate: no load
      v[j] = V::zero();
      if (gk[j] != 0.f) v[j] = rows[static_cast<size_t>(slot[j]) * units];
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float f[VEC];
      V::to_f(v[j], f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(f[i], gk[j], acc[i]);
    }
  }
  reinterpret_cast<U*>(y)[static_cast<size_t>(bs) * units + u] = V::from_f(acc);
}

template <typename T, int VEC, int THREADS>
void launch_gather_as(const int32_t* lin, const T* out, const float* gates,
                      T* y, int B, int S, int K, int n_slots, int units,
                      cudaStream_t s) {
  const dim3 grid(B * S, (units + THREADS - 1) / THREADS);
  if (K == 8)
    moe_gather_kernel<T, VEC, THREADS, 8, true><<<grid, THREADS, 0, s>>>(
        lin, out, gates, y, S, K, n_slots, units);
  else
    moe_gather_kernel<T, VEC, THREADS, 4, false><<<grid, THREADS, 0, s>>>(
        lin, out, gates, y, S, K, n_slots, units);
}

template <typename T, int VEC>
void launch_gather(const int32_t* lin, const T* out, const float* gates,
                   T* y, int B, int S, int K, int n_slots, int D,
                   cudaStream_t s) {
  const int units = D / VEC;
  if (static_cast<int64_t>(B) * S * ((units + 31) / 32) > kGatherWarpCtas)
    launch_gather_as<T, VEC, kGatherWide>(lin, out, gates, y, B, S, K,
                                          n_slots, units, s);
  else
    launch_gather_as<T, VEC, 32>(lin, out, gates, y, B, S, K, n_slots,
                                 units, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  Return the cudaError_t of the
// launch (0 on success).
extern "C" int moe_scatter(const void* lin, const void* x, void* buf,
                           void* slot_map, int B, int S, int K, int n_slots,
                           int D, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(lin);
  int32_t* m = static_cast<int32_t*>(slot_map);
  const int tiles = (n_slots + 1 + kScatterRows - 1) / kScatterRows;
  if (tiles > 65535 || B > 65535) return cudaErrorInvalidValue;
  if (m) {
    const int n = B * S * K, threads = 256;
    if (n > 0)
      moe_scatter_map_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
          l, m, S * K, n_slots, n);
  }
  const int row_bytes = D * (dtype == 0 ? 4 : 2);
  const bool vec = row_bytes % 16 == 0 && aligned16(x) && aligned16(buf);
  const int units = vec ? row_bytes / 16 : D;
  const dim3 grid(tiles, (units + kScatterCols - 1) / kScatterCols, B);
  if (vec)
    moe_scatter_kernel<uint4><<<grid, kScatterThreads, 0, s>>>(
        l, m, static_cast<const uint4*>(x), static_cast<uint4*>(buf), S, K,
        n_slots, units);
  else if (dtype == 0)
    moe_scatter_kernel<float><<<grid, kScatterThreads, 0, s>>>(
        l, m, static_cast<const float*>(x), static_cast<float*>(buf), S, K,
        n_slots, units);
  else
    moe_scatter_kernel<uint16_t><<<grid, kScatterThreads, 0, s>>>(
        l, m, static_cast<const uint16_t*>(x), static_cast<uint16_t*>(buf),
        S, K, n_slots, units);
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
      launch_gather<float, 4>(l, o, g, dst, B, S, K, n_slots, D, s);
    else
      launch_gather<float, 1>(l, o, g, dst, B, S, K, n_slots, D, s);
  } else if (dtype == 1) {
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(out);
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(y);
    if (vec && D % 8 == 0)
      launch_gather<__nv_bfloat16, 8>(l, o, g, dst, B, S, K, n_slots, D, s);
    else
      launch_gather<__nv_bfloat16, 1>(l, o, g, dst, B, S, K, n_slots, D, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
