// Flash attention forward for Hopper (sm_90a): causal or full, GQA,
// float32 or bfloat16, head dim 64 or 128, any S and any T >= S.
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
// a whole query tile, far above the card's flops-per-byte balance.  Both
// forms keep a query tile's scores, probabilities and output on chip,
// stream K and V through shared memory in 64-key tiles with the next
// copy in flight during the products, never load a tile wholly above the
// diagonal (causal), mask only the diagonal and ragged tiles, and launch
// the longest (causal) query tiles first so the short ones fill the tail.
//
// bfloat16 runs on the tensor cores (`flash_tc_kernel`): a CTA holds one
// producer warp and one or two consumer warpgroups of 64 query rows (two:
// the same rows of two query heads of one KV group, which share every K/V
// tile).  The producer issues TMA loads (128-byte swizzle) of Q once and
// of K/V tiles into a ring of stages, each guarded by a full and an empty
// mbarrier.  Each consumer computes S = Q K^T with wgmma m64n64k16 (A and
// B from shared memory), runs the online softmax on the f32 accumulator
// fragment in registers, converts P to bf16 in registers (the accumulator
// layout of two n8 blocks is the A-operand layout of one k16 step) and
// adds P V with wgmma m64nDk16, V read MN-major from shared memory.  S_j
// and P_{j-1} V_{j-1} are issued together, so tile j's softmax runs while
// P_{j-1} V_{j-1} is on the tensor cores.  The kernel is persistent: as
// many CTAs as fit on the card walk the query tiles, longest first, and
// the producer loads the next tile's Q and K/V while the consumers finish
// the current one.  Few tiles (a grid that would leave most SMs one CTA)
// are latency-bound and take one-warpgroup CTAs with a five-stage ring;
// many take two warpgroups and three stages (one warpgroup, two stages,
// two CTAs an SM, where the query heads of a KV group are odd).
//
// float32 runs on the tensor cores too, as three TF32 products per product
// (`flash_f32_kernel`): each operand x splits into hi = tf32(x) and lo =
// tf32(x - hi), and hi*hi + hi*lo + lo*hi keeps ~2^-22 of relative error,
// float32's own order (one TF32 product would keep 2^-11).  A CTA holds 64
// query rows in eight warps (mma.sync m16n8k8): four row blocks of 16,
// each split over the two key halves of every tile; Q, K and V sit in
// padded shared memory (rows of D + 4 floats: fragment loads hit 32
// distinct banks), filled by 16-byte cp.async, V's copy overlapping
// Q K^T and the next K's overlapping the softmax and P V.  P stays in
// registers: the keys of each 8-key block are renumbered (k-index c holds
// key 2c, c + 4 holds 2c + 1) so the accumulator fragment is the A
// fragment, and V's B fragment reads the same renumbered rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSMs = 132;     // H100 SXM

// 2^x on the SFU alone (relative error ~2^-22; results below 2^-126
// flush to 0): exp2f wraps the same instruction in range fix-ups that
// cost the softmax three more instructions a probability
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------- //
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------- //
__device__ __forceinline__ void wgmma_m64n64k16_ss(
    float (&d)[32], uint64_t da, uint64_t db,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(
    float (&d)[32], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(
    float (&d)[64], const uint32_t (&a)[4],
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// NWG consumer warpgroups, each the same 64 query rows of its own head
// (NWG heads of one KV group, so they share every K/V tile), one producer
// warp, a ring of ST stages of K and V
template <int D, int NWG, int ST>
struct Tc {
  static constexpr int BQ = 64;              // query rows per warpgroup
  static constexpr int BK = 64;              // keys per tile
  static constexpr int STAGES = ST;
  static constexpr int DC = D / 64;          // 64-column (128-byte) boxes
  static constexpr int Q_BOX = BQ * 128;     // one box of Q, bytes
  static constexpr int KV_BOX = BK * 128;    // one box of K or V
  static constexpr int Q_BYTES = NWG * DC * Q_BOX;
  static constexpr int KV_BYTES = DC * KV_BOX;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int SMEM =   // + alignment slack, two Q buffers, barriers
      1024 + 2 * Q_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 4);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2],
                                        const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_step<64>(float (&o)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_m64n64k16_rs(o, a, db, 1);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&o)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_m64n128k16_rs(o, a, db, 1);
}

// Persistent: the grid holds as many CTAs as fit on the card at once, and
// each walks work items (a query tile of NWG heads), longest (causal)
// first: item i is query tile nq - 1 - i / P of head group i % P, and CTA
// c takes items c, then one a round in snake order.  The producer runs
// ahead across items: the next item's Q (two buffers) and K/V tiles land
// while the consumers finish the current one, so no CTA starts cold.
template <int D, int NWG, int STAGES>
__global__ void __launch_bounds__(Tc<D, NWG, STAGES>::THREADS, 1) flash_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int H, int KH, int S, int Tk, int causal, int nq, int P,
    float scale_log2) {
  using C = Tc<D, NWG, STAGES>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;                               // two Q buffers
  uint8_t* kv_s = smem + 2 * C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv_s + ST * C::STAGE_BYTES);
  uint64_t* empty = full + ST;
  uint64_t* qfull = empty + ST;
  uint64_t* qempty = qfull + 2;

  const int n_items = nq * P, G = gridDim.x, cta = blockIdx.x;
  auto item = [&](int r) { return r * G + ((r & 1) ? G - 1 - cta : cta); };
  auto first_row = [&](int i) { return (nq - 1 - i / P) * BQ; };
  auto tiles = [&](int q0) {
    return causal ? (min(q0 + BQ, S) + BK - 1) / BK : (Tk + BK - 1) / BK;
  };
  // warp-uniform by construction (a shuffle), so whatever derives from it
  // (the warpgroup's addresses, the wgmma descriptors) stays uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);    // one arrival per consumer warp
    }
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(&qfull[qb], 1);
      mbar_init(&qempty[qb], 4 * NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {          // the producer
    if (lane == 0) {
      int g = 0;                  // K/V tiles issued so far
      for (int r = 0; item(r) < n_items; ++r) {
        const int i = item(r), q0 = first_row(i), bh0 = (i % P) * NWG;
        const int bkh = bh0 / H * KH + (bh0 % H) / (H / KH), qb = r & 1;
        if (r >= 2) mbar_wait(&qempty[qb], ((r >> 1) - 1) & 1);
        mbar_expect_tx(&qfull[qb], C::Q_BYTES);
        for (int w = 0; w < NWG; ++w)
          for (int dc = 0; dc < C::DC; ++dc)
            tma_load_3d(q_s + qb * C::Q_BYTES + (w * C::DC + dc) * C::Q_BOX,
                        &tq, &qfull[qb], dc * 64, q0, bh0 + w);
        const int n = tiles(q0);
        for (int j = 0; j < n; ++j, ++g) {
          const int s = g % ST;
          if (g >= ST) mbar_wait(&empty[s], ((g / ST) - 1) & 1);
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          uint8_t* ks = kv_s + s * C::STAGE_BYTES;
          for (int dc = 0; dc < C::DC; ++dc) {
            tma_load_3d(ks + dc * C::KV_BOX, &tk, &full[s], dc * 64, j * BK,
                        bkh);
            tma_load_3d(ks + C::KV_BYTES + dc * C::KV_BOX, &tv, &full[s],
                        dc * 64, j * BK, bkh);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 .. q0 + 63 of head bh0 + wg; in
  // the accumulator fragment this thread holds rows ra and ra + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1} of each n8 block j
  const int wg = warp / 4;
  const int cq = 2 * (lane % 4);
  float o[D / 2];
  float sc[32];          // S, then P, of one tile
  uint32_t pa[4][4];     // P in bf16: blocks 2kk, 2kk + 1 = A of k-step kk
  float m_a, m_b, l_a, l_b;
  int g = 0;             // K/V tiles consumed so far: stage g % ST

  auto fence_o = [&]() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_reg(o[i]);
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) fence_reg(pa[kk][i]);
  };
  auto stage = [&](int t) { return smem_u32(kv_s + (t % ST) * C::STAGE_BYTES); };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[t % ST]);
  };
  // P in bf16 into pa, once no wgmma reads it
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  for (int r = 0; item(r) < n_items; ++r) {
    const int i = item(r), q0 = first_row(i), bh = (i % P) * NWG + wg;
    const int ra = q0 + (warp % 4) * 16 + lane / 4, rb = ra + 8;
    const int n = tiles(q0), qb = r & 1;
    const uint32_t q_addr =
        smem_u32(q_s + qb * C::Q_BYTES) + wg * C::DC * C::Q_BOX;
#pragma unroll
    for (int k = 0; k < D / 2; ++k) o[k] = 0.f;
    fence_o();
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;

    // S = Q K_j^T (D / 16 steps of k16, 32 bytes, K-major A and B), then,
    // with `pv`, O += P V_{j-1}: V is the MN-major B operand (keys are rows
    // of 128 B, 8-key groups 1024 B apart, D's 64-column boxes KV_BOX
    // apart).  Issued, not waited for.  The descriptors come from
    // warp-uniform addresses, so they live in uniform registers: a
    // descriptor moved in from an ordinary register inside a wgmma batch
    // serializes the batch.
    auto issue = [&](int j, bool pv) {
      const int t = g + j;
      mbar_wait(&full[t % ST], (t / ST) & 1);
      const uint32_t k_addr = stage(t), v_addr = stage(t + ST - 1) + C::KV_BYTES;
#pragma unroll
      for (int k = 0; k < 32; ++k) fence_reg(sc[k]);
      fence_o();
      fence_p();
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_m64n64k16_ss(
            sc, smem_desc_sw128(q_addr + (ks / 4) * C::Q_BOX + off, 16, 1024),
            smem_desc_sw128(k_addr + (ks / 4) * C::KV_BOX + off, 16, 1024),
            ks > 0);
      }
      wgmma_commit();
      if (pv) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          pv_step<D>(o, pa[kk],
                     smem_desc_sw128(v_addr + kk * 16 * 128, C::KV_BOX, 1024));
        wgmma_commit();
      }
    };
    // the last tile's O += P V_j
    auto issue_pv = [&](int j) {
      const uint32_t v_addr = stage(g + j) + C::KV_BYTES;
      fence_o();
      fence_p();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        pv_step<D>(o, pa[kk],
                   smem_desc_sw128(v_addr + kk * 16 * 128, C::KV_BOX, 1024));
      wgmma_commit();
    };
    // mask the diagonal and ragged tiles, then the online softmax of tile
    // j in log2 units, in place: P (float32) in sc, the rescale of the
    // older terms into al_*.  It runs while P_{j-1} V_{j-1} may still read
    // pa and o, so it defines neither: an operand register defined under
    // an in-flight wgmma makes ptxas serialize every wgmma of the kernel.
    auto softmax = [&](int j, float& al_a, float& al_b) {
#pragma unroll
      for (int k = 0; k < 32; ++k) fence_reg(sc[k]);
      const int k0 = j * BK;
      if ((causal && k0 + BK - 1 > q0) || k0 + BK > Tk) {
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * jb + cq + e;
            if (key >= Tk || (causal && key > ra)) sc[4 * jb + e] = -INFINITY;
            if (key >= Tk || (causal && key > rb)) sc[4 * jb + 2 + e] = -INFINITY;
          }
        }
      }
      // the row maxima of the raw scores (the scale is positive)
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * jb], sc[4 * jb + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * jb + 2], sc[4 * jb + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      al_a = fast_exp2(m_a - mn_a);
      al_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * jb + e] = fast_exp2(fmaf(sc[4 * jb + e], scale_log2, -mn_a));
          sc[4 * jb + 2 + e] = fast_exp2(fmaf(sc[4 * jb + 2 + e], scale_log2, -mn_b));
          sum_a += sc[4 * jb + e];
          sum_b += sc[4 * jb + 2 + e];
        }
      }
      // this thread's share of each row sum; the quad adds up at the end
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
    };

    // tile j's softmax runs while P_{j-1} V_{j-1} is on the tensor cores
    mbar_wait(&qfull[qb], (r >> 1) & 1);
    {
      float al_a, al_b;    // O is still zero: nothing to rescale
      issue(0, false);
      wgmma_wait<0>();
      softmax(0, al_a, al_b);
      pack();
      fence_p();
    }
    for (int j = 1; j < n; ++j) {
      issue(j, true);
      wgmma_wait<1>();     // S_j is done; P_{j-1} V_{j-1} may still run
      float al_a, al_b;
      softmax(j, al_a, al_b);
      wgmma_wait<0>();
      fence_o();
      release(g + j - 1);
      if (__any_sync(0xffffffffu, al_a != 1.f || al_b != 1.f)) {
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb) {
          o[4 * jb] *= al_a;
          o[4 * jb + 1] *= al_a;
          o[4 * jb + 2] *= al_b;
          o[4 * jb + 3] *= al_b;
        }
      }
      pack();
      // O and P are final here: keep their definitions ahead of the next
      // tile's wgmma (a definition inside its pipeline stage serializes it)
      fence_o();
      fence_p();
    }
    issue_pv(n - 1);
    wgmma_wait<0>();
    fence_o();
    release(g + n - 1);
    if (lane == 0) mbar_arrive(&qempty[qb]);  // no wgmma reads this Q now
    g += n;

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
    __nv_bfloat16* ob = out + static_cast<size_t>(bh) * S * D + cq;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      if (ra < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(ra) * D +
                                           8 * jb) =
            __floats2bfloat162_rn(o[4 * jb] * inv_a, o[4 * jb + 1] * inv_a);
      if (rb < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(rb) * D +
                                           8 * jb) =
            __floats2bfloat162_rn(o[4 * jb + 2] * inv_b, o[4 * jb + 3] * inv_b);
    }
  }
}

// ---------------------------------------------------------------------- //
// float32: 3xTF32 mma.sync
// ---------------------------------------------------------------------- //
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b to ~float32 accuracy: the small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split_tf32(b[0], bh[0], bl[0]);
  split_tf32(b[1], bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

constexpr int F_BQ = 64, F_BK = 64, F_THREADS = 256;

// rows r0 .. r0 + 63 of a (len, D) float32 matrix into shared memory rows
// of D + 4 floats; rows past len are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int len) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < 64 * C4; i += F_THREADS) {
    const int r = i / C4, c = i % C4;
    const bool ok = r0 + r < len;
    cp_async16(dst + r * (D + 4) + 4 * c,
               ok ? src + static_cast<size_t>(r0 + r) * D + 4 * c : src, ok);
  }
}

// Eight warps: warp w owns query rows 16 (w % 4) .. + 15 of the tile and
// keys 32 (w / 4) .. + 31 of every key tile, with an online softmax of its
// own; the two key halves of each row merge at the end.  Twice the warps
// of one warp per row block, on the same tiles: the products of a causal
// prefill's longest query tile finish in about half the time.
template <int D>
__global__ void __launch_bounds__(F_THREADS, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int H, int KH,
    int S, int Tk, int causal, float scale_log2) {
  constexpr int DP = D + 4, NB = D / 8;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + F_BQ * DP;
  float* v_s = k_s + F_BK * DP;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * F_BQ;  // longest tiles first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t kv_off =
      (static_cast<size_t>(b) * KH + h / (H / KH)) * Tk * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;
  const int n_tiles = causal ? (min(q0 + F_BQ, S) + F_BK - 1) / F_BK
                             : (Tk + F_BK - 1) / F_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, kq = warp / 4;
  const int g = lane / 4, c = lane % 4;
  const int ra = q0 + rg * 16 + g, rb = ra + 8;

  load_tile_f32<D>(q_s, q + static_cast<size_t>(bh) * S * D, q0, S);
  load_tile_f32<D>(k_s, kb, 0, Tk);
  cp_async_commit();

  float o[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F_BK, kw = k0 + kq * 32;   // this warp's first key
    load_tile_f32<D>(v_s, vb, k0, Tk);       // V_j lands during Q K_j^T
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* qr = q_s + (rg * 16 + g) * DP + kk * 8 + c;
      uint32_t ah[4], al[4];
      split_tf32(qr[0], ah[0], al[0]);
      split_tf32(qr[8 * DP], ah[1], al[1]);
      split_tf32(qr[4], ah[2], al[2]);
      split_tf32(qr[8 * DP + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* kr = k_s + (kq * 32 + nt * 8 + g) * DP + kk * 8 + c;
        const float bv[2] = {kr[0], kr[4]};
        mma_3xtf32(sc[nt], ah, al, bv);
      }
    }
    __syncthreads();                          // K_j's reads are done
    if (j + 1 < n_tiles) {                    // K_{j+1} lands during the
      load_tile_f32<D>(k_s, kb, k0 + F_BK, Tk);  // softmax and P V_j
      cp_async_commit();
    }

    if ((causal && kw + 31 > q0 + rg * 16) || kw + 32 > Tk) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kw + nt * 8 + 2 * c + e;
          if (key >= Tk || (causal && key > ra)) sc[nt][e] = -INFINITY;
          if (key >= Tk || (causal && key > rb)) sc[nt][2 + e] = -INFINITY;
        }
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      mx_a = fmaxf(mx_a, fmaxf(sc[nt][0], sc[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
    }
    // a key half can be wholly masked for a row so far (m stays -inf):
    // its probabilities are then 0, not exp(-inf + inf)
    const float mn_a = fmaxf(m_a, mx_a * scale_log2);
    const float mn_b = fmaxf(m_b, mx_b * scale_log2);
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float al_a = fast_exp2(m_a - base_a), al_b = fast_exp2(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = fast_exp2(fmaf(sc[nt][e], scale_log2, -base_a));
        sc[nt][2 + e] = fast_exp2(fmaf(sc[nt][2 + e], scale_log2, -base_b));
        sum_a += sc[nt][e];
        sum_b += sc[nt][2 + e];
      }
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
#pragma unroll
    for (int nd = 0; nd < NB; ++nd) {
      o[nd][0] *= al_a;
      o[nd][1] *= al_a;
      o[nd][2] *= al_b;
      o[nd][3] *= al_b;
    }

    if (j + 1 < n_tiles) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                          // V_j has landed
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      uint32_t ph[4], pl[4];                  // k-index c: key 2c, c + 4: 2c + 1
      split_tf32(sc[kt][0], ph[0], pl[0]);
      split_tf32(sc[kt][2], ph[1], pl[1]);
      split_tf32(sc[kt][1], ph[2], pl[2]);
      split_tf32(sc[kt][3], ph[3], pl[3]);
      const float* vr = v_s + (kq * 32 + kt * 8 + 2 * c) * DP + g;
#pragma unroll
      for (int nd = 0; nd < NB; ++nd) {
        const float bv[2] = {vr[nd * 8], vr[DP + nd * 8]};
        mma_3xtf32(o[nd], ph, pl, bv);
      }
    }
    __syncthreads();                          // V_j's reads are done
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  // merge the key halves: warps 4..7 hand (m, l, O) over through shared
  // memory (the K/V tiles are free now) to warps 0..3, which write out
  constexpr int XS = NB * 4 + 4;
  float* x_s = k_s + (rg * 32 + lane) * XS;
  if (kq == 1) {
#pragma unroll
    for (int nd = 0; nd < NB; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) x_s[nd * 4 + e] = o[nd][e];
    x_s[NB * 4] = m_a;
    x_s[NB * 4 + 1] = m_b;
    x_s[NB * 4 + 2] = l_a;
    x_s[NB * 4 + 3] = l_b;
  }
  __syncthreads();
  if (kq == 1) return;
  const float m1_a = x_s[NB * 4], m1_b = x_s[NB * 4 + 1];
  const float M_a = fmaxf(m_a, m1_a), M_b = fmaxf(m_b, m1_b);  // m_* finite
  const float w0_a = fast_exp2(m_a - M_a), w0_b = fast_exp2(m_b - M_b);
  const float w1_a = m1_a == -INFINITY ? 0.f : fast_exp2(m1_a - M_a);
  const float w1_b = m1_b == -INFINITY ? 0.f : fast_exp2(m1_b - M_b);
  const float inv_a = 1.f / fmaxf(l_a * w0_a + x_s[NB * 4 + 2] * w1_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b * w0_b + x_s[NB * 4 + 3] * w1_b, 1e-30f);
  float* ob = out + static_cast<size_t>(bh) * S * D + 2 * c;
#pragma unroll
  for (int nd = 0; nd < NB; ++nd) {
    if (ra < S)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(ra) * D + nd * 8) =
          make_float2((o[nd][0] * w0_a + x_s[nd * 4] * w1_a) * inv_a,
                      (o[nd][1] * w0_a + x_s[nd * 4 + 1] * w1_a) * inv_a);
    if (rb < S)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(rb) * D + nd * 8) =
          make_float2((o[nd][2] * w0_b + x_s[nd * 4 + 2] * w1_b) * inv_b,
                      (o[nd][3] * w0_b + x_s[nd * 4 + 3] * w1_b) * inv_b);
  }
}

// ---------------------------------------------------------------------- //
// host side
// ---------------------------------------------------------------------- //
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime so
// the library links nothing
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (heads, rows, D) bfloat16 tensor as 3-D (D, rows, heads): a box that
// runs past `rows` is zero-filled and never reads the next head's rows
bool make_map(CUtensorMap* map, const void* ptr, int D, int rows, int heads,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG, int ST>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int KH, int S, int Tk, int causal,
                      cudaStream_t stream) {
  using C = Tc<D, NWG, ST>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, S, B * H, C::BQ) ||
      !make_map(&tk, k, D, Tk, B * KH, C::BK) ||
      !make_map(&tv, v, D, Tk, B * KH, C::BK))
    return cudaErrorInvalidValue;
  auto kernel = flash_tc_kernel<D, NWG, ST>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, C::THREADS, C::SMEM)) != cudaSuccess)
    return e;
  const int nq = (S + C::BQ - 1) / C::BQ, P = B * H / NWG;
  const int grid = min(nq * P, max(1, sms * per_sm));
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), H, KH, S, Tk, causal, nq,
      P, kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int H, int KH, int S, int Tk, int causal,
                       cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * 3 * 64 * (D + 4);
  auto kernel = flash_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + F_BQ - 1) / F_BQ);
  kernel<<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KH, S, Tk,
      causal, kLog2e / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16.  q, k and v start on 16-byte
// boundaries (TMA, cp.async).  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int H, int KH, int S, int T,
                               int D, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < S || S < 1 || H % KH != 0) return cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v)) & 15) != 0)
    return cudaErrorMisalignedAddress;
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, out, B, H, KH, S, T, causal, s);
  // bfloat16: few query tiles are latency-bound, so they take
  // one-warpgroup CTAs with a deep ring; many take two warpgroups a CTA
  // (two heads of one KV group, sharing each K/V tile)
  if (dtype == 1 && D == 64) return launch_tc<64, 1, 5>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 1 && D == 128 && B * H * ((S + 63) / 64) <= 2 * kSMs)
    return launch_tc<128, 1, 5>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 1 && D == 128 && (H / KH) % 2 == 0)
    return launch_tc<128, 2, 3>(q, k, v, out, B, H, KH, S, T, causal, s);
  if (dtype == 1 && D == 128) return launch_tc<128, 1, 2>(q, k, v, out, B, H, KH, S, T, causal, s);
  return cudaErrorInvalidValue;
}
