// Hopper GEMMs of the Swin half-blocks, forward and backward: TMA loads
// into a ring of shared-memory stages, wgmma.mma_async from two consumer
// warpgroups, the LayerNorm prologue and the fused epilogues kept.
//
// Serves K1 (swin_block.cu: qkv with the LN1 prologue, proj with the
// residual epilogue; K1b's qkv recompute calls the same code) and K2
// (swin_mlp.cu: fc1 with the LN2 prologue and GELU, fc2 with the residual;
// K2b's fc1 recompute, swin_mlp_bwd.cu, keeps GELU' of the pre-activation
// too),
// the TPU kernels preworld_tpu/ops/swin_block_pallas.py::fused_swin_attn_block
// and preworld_tpu/ops/swin_mlp_pallas.py::fused_swin_mlp; and every
// product of their backward chains K1b (swin_block_bwd.cu) and K2b
// (swin_mlp_bwd.cu), the TPU kernels _fused_swin_attn_block_bwd and
// _fused_swin_mlp_bwd_call of the same files.
//
//   out[m, n] = epilogue( sum_k prologue(A)[m, k] * W[n, k] )
// A (M, K) and W (N, K) row-major bf16 (the PyTorch Linear layout: both
// operands K-major); N and K multiples of 128, M any. Accumulation in f32,
// each output summed by one block in a fixed k order (no split-K, no
// atomics: two runs give identical bits).
//
// Prologue PRO_LN: y = bf16((x - mu) rstd w + b), from per-row (mu, rstd)
// that ln_stats (gemm.cuh) wrote once per row -- the statistics K1b / K2b
// use too -- and rstd = 0 marks a pad token, whose LN output is exactly 0.
// The raw x tile arrives by TMA; each consumer warp loads its A fragments
// with ldmatrix, normalises them in registers and feeds wgmma with A from
// registers, so the LN output never reaches memory. PRO_NONE: A from
// shared memory.
// Epilogues, on the accumulator registers: EPI_BIAS (+bias), EPI_BIAS_GELU
// (+bias, exact-erf GELU), EPI_BIAS_GELU_SAVE (as EPI_BIAS_GELU, and
// GELU' of the pre-activation in f32 to out_f32: the factor K2b's dhpre
// takes, from the same erf), EPI_RESID (bf16(resid + row_scale[m /
// rs_div] (acc + bias)), the residual tile brought in by TMA). The bf16
// result goes through a swizzled shared tile and leaves by TMA store,
// which clips the ragged last row tile.
//
// Input gradients (BT, dX = dY . W of a Linear): W (K, N) as stored, N
// contiguous, is an MN-major B operand: TMA brings boxes of 64 K rows x 64
// N columns and the wgmma descriptor carries the transpose bit, so no
// transposed copy of W exists. Their epilogues: EPI_BIAS with a null bias
// (dO), EPI_F32 (f32 out straight from the accumulators: dyln, dn), and
// EPI_MUL_AUX (acc * aux with aux an f32 (M, N) factor read a tile
// ahead into registers, bf16 out, and f32 column sums for the bias
// gradient: dhpre = (dY W2) * GELU'(hpre) and db1). Its blocks each keep
// one column tile and add their rows' sums in tile order, one partial row
// per block and warpgroup.
//
// Layout: a persistent grid (one block per SM) walks 128 x BN output tiles
// (BN 128 or 256), N fastest so that the blocks in flight share rows of A.
// One thread of a producer warpgroup keeps STAGES K steps of 64 in flight
// (A 128 x 64 and W BN x 64 per stage, 128-byte swizzle, mbarrier full /
// empty pairs); the producer gives its registers to two consumer
// warpgroups (setmaxnreg), which each own 64 rows of the tile and run
// m64n128k16 wgmma, keeping one group in flight while the next stage is
// prepared.
// The producer runs ahead into the next tile while the consumers finish
// the epilogue of this one.
//
// Bound on H100 (3.35 TB/s, 989 TFLOP/s bf16): per output row the product
// does 2 N K FLOP and moves 2 (K + N) bytes (+ 2 N for a residual), so at
// Swin-B's K = C = 128 / 256 (stages 0-1) qkv, proj and fc1 sit below the
// card's ~295 FLOP a byte and bytes bind; at C = 512 / 1024 (stages 2-3)
// and for fc2 (K = 4C) the operations bind. The design answers both: TMA
// and the persistent walk keep loads in flight through the epilogue for
// the byte-bound shapes, and wgmma from two warpgroups with the LN folded
// into the A fragments keeps the tensor cores fed for the rest. The 4C
// hidden of K2 still goes through device memory between fc1 and fc2.
//
// Weight gradients (gemm_dw_sm90): out (N, K) f32 = A^T . prologue(B) with
// A (M, N) and B (M, K), the sum over M rows. Both operands are row-major
// in M, so both are MN-major to wgmma; TMA brings 64-row boxes of 64
// columns (128-byte swizzle) and both descriptors carry the transpose bit.
// The output is small (C x 4C at most) against M, so the grid walks
// (output tile, split of M) items on a persistent grid, each split's f32
// partial summed over the splits in a fixed order (reduce_splits, or the
// output itself when there is one split): identical bits run to run.
// PRO_LN (dWqkv, dW1) swaps the roles -- dW^T = LN(B)^T . A -- so the LN
// lands on the register operand: each warp ldmatrix.trans-es the raw x
// tile, normalises it from the per-row statistics (rstd 0 = a pad row,
// output exactly 0; a second producer warp copies each step's 64 rows of
// them into the stage) and feeds wgmma with A from registers; the
// epilogue stores the tile transposed. Tiles are 128 x 256 where the
// columns allow, so each normalised A fragment serves two n128 products.
//
// Bound on H100 of the backward products: 2 M N K FLOP against 2 M (N +
// K) bytes plus 4 M N for an f32 output, so at Swin-B's C = 128 / 256 the
// input gradients and weight gradients sit at or below the card's ~295
// FLOP a byte and bytes bind (dhpre most: it reads the f32 GELU' factor,
// 4 bytes per output), at C = 512 / 1024 the operations. The design
// answers the bytes with TMA, a persistent grid and no transposed or
// normalised copy of any operand (MN-major descriptors, the LN in
// registers), and the operations with wgmma from two warpgroups; the
// weight gradients' split over M fills the card when the output is one
// or a few tiles (Swin-B stage 0's dWproj is one 128 x 128 tile over
// 285,120 rows).
#pragma once

#include <cuda.h>

#include <functional>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "gemm.cuh"

namespace pw {

constexpr int SM_BM = 128, SM_BK = 64;
constexpr int SM_CONSUMERS = 256;               // two warpgroups of 64 rows
constexpr int SM_THREADS = SM_CONSUMERS + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: 40 in the producer, 232 in the
// consumers (128 x 40 + 256 x 232 <= 65536; the launch gives 168 each)
constexpr int SM_PRODUCER_REGS = 40, SM_CONSUMER_REGS = 232;
constexpr int SM_LN_KMAX = 1536;                // widest LN prologue (Swin-L)

enum Prologue { PRO_NONE = 0, PRO_LN = 1 };
enum Sm90Epilogue {
  EPI_BIAS = 0,
  EPI_BIAS_GELU = 1,
  EPI_BIAS_GELU_SAVE = 2,
  EPI_RESID = 3,
  EPI_F32 = 4,
  EPI_MUL_AUX = 5
};

struct Sm90Args {
  int M, N, K;
  const float* bias;       // (N,) or null
  const float* stats;      // PRO_LN: (M, 2) mu, rstd
  const float* ln_w;       // PRO_LN: (K,)
  const float* ln_b;
  const float* row_scale;  // EPI_RESID: indexed by m / rs_div, or null (= 1)
  int rs_div;
  float* out_f32;          // EPI_BIAS_GELU_SAVE: (M, N) f32 GELU'; EPI_F32: out
  const float* aux;        // EPI_MUL_AUX: (M, N) f32 factor
  float* col_part;         // EPI_MUL_AUX: (mul_aux_rows(M, N), N) column sums
};

template <int BN>
struct Sm90Cfg {
  static constexpr int STAGES = BN == 256 ? 3 : 5;
  static constexpr int A_BYTES = SM_BM * SM_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BN * SM_BK * 2;
  static constexpr int EPI_BYTES = 64 * BN * 2;  // per consumer warpgroup
  static constexpr int EPI_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = EPI_OFF + 2 * EPI_BYTES;
  static constexpr int LN_OFF = BAR_OFF + 8 * (2 * STAGES + 2);
  // dynamic shared bytes, with room to align the base to 1024; the last
  // 8 ln_k bytes hold ln_w / ln_b (PRO_LN) or the column sums (EPI_MUL_AUX)
  static constexpr size_t smem(int ln_k) { return 1024 + LN_OFF + 8 * (size_t)ln_k; }
};

// shared bytes past the stages and barriers that a build needs
constexpr int sm90_extra_k(int PRO, int EPI, int ln_k) {
  return PRO == PRO_LN ? ln_k : EPI == EPI_MUL_AUX ? 512 : 0;
}

// ------------------------------------------------------------ PTX pieces

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA tile load (coordinates: column, row) completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the shared source of every committed TMA store has been read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// generic-proxy writes to shared memory made visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
__device__ __forceinline__ void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma descriptor of a K-major tile with 128-byte swizzle: rows of 128
// bytes (64 bf16 of K), 8-row groups 1024 bytes apart; the next k16 step
// is +32 bytes on the start address
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// the same for an MN-major tile: 64-row boxes of 128-byte rows (64 bf16 of
// M or N), 128-byte swizzle; 8-row K groups 1024 bytes apart (SBO), the
// next 64 M or N columns one box (8192 bytes) on (LBO); the next k16 step
// is +2048 bytes (16 rows) on the start address
__device__ __forceinline__ uint64_t wgmma_desc_mn(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(8192 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define PW_D64                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define PW_D64_ARGS(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),  \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),    \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),    \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),    \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),    \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),    \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (64 x 128 f32) += A (64 x 16, shared) . B (16 x 128, shared); TA / TB:
// the operand is MN-major (the transpose bit), else K-major
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PW_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : PW_D64_ARGS(d)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the same with A from registers (the m16n8k16 A fragment of each warp's
// 16 rows)
template <int TB = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PW_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : PW_D64_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

#undef PW_D64
#undef PW_D64_ARGS

// ---------------------------------------------------------------- kernel

template <int PRO, int EPI, int BN, bool BT>
__global__ void __launch_bounds__(SM_THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
                 const __grid_constant__ CUtensorMap tm_out,
                 const __grid_constant__ CUtensorMap tm_res, const Sm90Args p) {
  using Cfg = Sm90Cfg<BN>;
  constexpr int STAGES = Cfg::STAGES, NH = BN / 128;
  extern __shared__ uint8_t smem_dyn[];
  const uint32_t raw = smem_u32(smem_dyn);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_dyn + (base - raw);
  const uint32_t bars = base + Cfg::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto epi_bar = [&](int g) { return bars + 8 * (2 * STAGES + g); };
  float* s_lnw = reinterpret_cast<float*>(gbase + Cfg::LN_OFF);
  float* s_lnb = s_lnw + p.K;
  float* s_col = s_lnw;  // EPI_MUL_AUX: (2 warpgroups, 4 warps, BN)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = p.N / BN, tiles_m = (p.M + SM_BM - 1) / SM_BM;
  const int KT = p.K / SM_BK;
  // the k-th output tile of this block, false past the last: N fastest
  // over the grid; EPI_MUL_AUX keeps one column tile per block (the grid
  // a multiple of the column tiles) so that the block adds its column sums
  // up itself
  auto tile_at = [&](int k, int& m0, int& n0) {
    int mt;
    if constexpr (EPI == EPI_MUL_AUX) {
      mt = blockIdx.x / tiles_n + k * (gridDim.x / tiles_n);
      n0 = blockIdx.x % tiles_n * BN;
    } else {
      const int t = blockIdx.x + k * gridDim.x;
      mt = t / tiles_n;
      n0 = t % tiles_n * BN;
    }
    m0 = mt * SM_BM;
    return mt < tiles_m;
  };

  if (PRO == PRO_LN)
    for (int k = tid; k < p.K; k += SM_THREADS) {
      s_lnw[k] = p.ln_w[k];
      s_lnb[k] = p.ln_b[k];
    }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), SM_CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init(epi_bar(0), 1);
    mbar_init(epi_bar(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= SM_CONSUMERS) {
    // producer: one thread keeps the ring of stages full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SM_PRODUCER_REGS));
    if (tid == SM_CONSUMERS) {
      int s = 0, m0, n0;
      uint32_t ph = 0;
      for (int tk = 0; tile_at(tk, m0, n0); ++tk) {
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty(s), ph ^ 1);
          const uint32_t sa = base + s * Cfg::STAGE_BYTES;
          mbar_expect_tx(full(s), Cfg::STAGE_BYTES);
          tma_load(sa, &tm_a, full(s), kt * SM_BK, m0);
          if constexpr (BT) {  // W (K, N): 64-column boxes of this step's 64 rows
            for (int q = 0; q < BN / 64; ++q)
              tma_load(sa + Cfg::A_BYTES + q * 8192, &tm_w, full(s), n0 + 64 * q, kt * SM_BK);
          } else {
            tma_load(sa + Cfg::A_BYTES, &tm_w, full(s), kt * SM_BK, n0);
          }
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows [64 g, 64 g + 64) of each tile; a
  // thread holds rows r_lo and r_lo + 8 of them, columns 8 j + cq, + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SM_CONSUMER_REGS));
  const int g = tid >> 7, tg = tid & 127, wq = warp & 3;
  const int r_lo = wq * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const uint32_t epi = base + Cfg::EPI_OFF + g * Cfg::EPI_BYTES;
  uint8_t* epi_gen = gbase + Cfg::EPI_OFF + g * Cfg::EPI_BYTES;
  float acc[NH][64];
  uint32_t afr[2][4][4];  // PRO_LN: A fragments of two K steps (k16 step, register)
  int s = 0, prev = 0, m0, n0;
  uint32_t ph = 0, epi_ph = 0;
  // EPI_MUL_AUX: the aux values of this thread's accumulators, loaded a
  // tile ahead, and its column's sum over the block's tiles
  [[maybe_unused]] float2 zr[16][2];
  [[maybe_unused]] float col_total = 0.f;
  auto load_aux = [&](int mt0, int nt0) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = mt0 + 64 * g + r_lo + 8 * i;
        zr[j][i] = m < p.M ? __ldg(reinterpret_cast<const float2*>(p.aux + (size_t)m * p.N +
                                                                   nt0 + 8 * j + cq))
                           : make_float2(0.f, 0.f);
      }
  };
  if constexpr (EPI == EPI_MUL_AUX) {
    static_assert(BN == 128, "EPI_MUL_AUX takes 128-column tiles");
    if (tile_at(0, m0, n0)) load_aux(m0, n0);
  }

  for (int tk = 0; tile_at(tk, m0, n0); ++tk) {
    const int mw = m0 + 64 * g;
    if (EPI == EPI_RESID && tg == 0) {
      // the residual tile into the staging tile, once the last store left it
      bulk_wait_read();
      mbar_expect_tx(epi_bar(g), Cfg::EPI_BYTES);
      for (int h = 0; h < BN / 64; ++h)
        tma_load(epi + h * 8192, &tm_res, epi_bar(g), n0 + 64 * h, mw);
    }
    float mu[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
    if (PRO == PRO_LN) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = mw + r_lo + 8 * i;
        if (m < p.M) {
          const float2 st = __ldg(reinterpret_cast<const float2*>(p.stats) + m);
          mu[i] = st.x;
          rstd[i] = st.y;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    // one K step of 64 on stage s, A fragments (PRO_LN) in buffer B
    auto step = [&](auto buf, int kt) {
      [[maybe_unused]] constexpr int B = decltype(buf)::value;
      mbar_wait(full(s), ph);
      const uint32_t sa = base + s * Cfg::STAGE_BYTES, sb = sa + Cfg::A_BYTES;
      if constexpr (PRO == PRO_LN) {
        // rows 64 g + 16 wq + (lane & 15), 16-byte chunk 2 kk + lane / 16
        const uint32_t row = sa + (64 * g + 16 * wq + (lane & 15)) * 128;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t x[4];
          ldsm4(x, row + (((2 * kk + (lane >> 4)) ^ (lane & 7)) << 4));
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // r: row half r & 1, column half r >> 1
            const int i = r & 1, k = kt * SM_BK + kk * 16 + (r >> 1) * 8 + cq;
            const float2 w = *reinterpret_cast<const float2*>(s_lnw + k);
            const float2 b = *reinterpret_cast<const float2*>(s_lnb + k);
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&x[r]);
            float y0 = (__low2float(xv) - mu[i]) * rstd[i] * w.x + b.x;
            float y1 = (__high2float(xv) - mu[i]) * rstd[i] * w.y + b.y;
            if (rstd[i] == 0.f) y0 = y1 = 0.f;
            afr[B][kk][r] = pack_bf16(y0, y1);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t db = BT ? wgmma_desc_mn(sb + h * 128 * 128 + kk * 2048)
                                 : wgmma_desc(sb + h * 128 * 128 + kk * 32);
          if constexpr (PRO == PRO_LN)
            wgmma_rs<BT>(acc[h], afr[B][kk], db);
          else
            wgmma_ss<0, BT>(acc[h], wgmma_desc(sa + g * 8192 + kk * 32), db);
        }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    };
    for (int kt = 0; kt < KT; kt += 2) {  // K % 128 == 0: KT is even
      step(std::integral_constant<int, 0>{}, kt);
      step(std::integral_constant<int, 1>{}, kt + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
    if (lane == 0) mbar_arrive(empty(prev));

    if constexpr (EPI == EPI_F32) {
      // f32 out straight from the accumulators
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int m = mw + r_lo + 8 * i;
            if (m < p.M)
              *reinterpret_cast<float2*>(p.out_f32 + (size_t)m * p.N + n0 + h * 128 + 8 * j +
                                         cq) =
                  make_float2(acc[h][4 * j + 2 * i], acc[h][4 * j + 2 * i + 1]);
          }
      continue;
    }

    // epilogue into the warpgroup's swizzled staging tile: 64 rows x BN,
    // as BN / 64 sub-tiles of 64 x 64 bf16 (128-byte rows)
    if (EPI == EPI_RESID) {
      mbar_wait(epi_bar(g), epi_ph);
      epi_ph ^= 1;
    } else {
      if (tg == 0) bulk_wait_read();
      named_sync(1 + g, 128);
    }
    float rs[2] = {1.f, 1.f};
    if (EPI == EPI_RESID && p.row_scale) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = mw + r_lo + 8 * i;
        rs[i] = m < p.M ? p.row_scale[m / p.rs_div] : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = h * 128 + 8 * j + cq;
        float2 cs = make_float2(0.f, 0.f);  // EPI_MUL_AUX: this thread's two rows
        float2 bb = make_float2(0.f, 0.f);
        if (p.bias) bb = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + c));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = r_lo + 8 * i;
          float v0 = acc[h][4 * j + 2 * i] + bb.x, v1 = acc[h][4 * j + 2 * i + 1] + bb.y;
          if (EPI == EPI_BIAS_GELU) {
            v0 = pw_gelu(v0);
            v1 = pw_gelu(v1);
          }
          if (EPI == EPI_BIAS_GELU_SAVE) {
            const float2 a = pw_gelu_and_grad(v0), b = pw_gelu_and_grad(v1);
            if (mw + rl < p.M)
              *reinterpret_cast<float2*>(p.out_f32 + (size_t)(mw + rl) * p.N + n0 + c) =
                  make_float2(a.y, b.y);
            v0 = a.x;
            v1 = b.x;
          }
          if constexpr (EPI == EPI_MUL_AUX) {  // rows past M hold 0 (A loads zeros there)
            v0 *= zr[j][i].x;
            v1 *= zr[j][i].y;
            cs.x += v0;
            cs.y += v1;
          }
          const uint32_t off =
              (c >> 6) * 8192 + rl * 128 + ((((c & 63) >> 3) ^ (rl & 7)) << 4) + cq * 2;
          uint32_t* dst = reinterpret_cast<uint32_t*>(epi_gen + off);
          if (EPI == EPI_RESID) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(dst);
            v0 = __low2float(r) + rs[i] * v0;
            v1 = __high2float(r) + rs[i] * v1;
          }
          *dst = pack_bf16(v0, v1);
        }
        if (EPI == EPI_MUL_AUX) {
          // the warp's 16 rows, lanes of one column pair summed in a fixed
          // butterfly; lanes 0-3 keep the sums
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            cs.x += __shfl_xor_sync(0xffffffffu, cs.x, o);
            cs.y += __shfl_xor_sync(0xffffffffu, cs.y, o);
          }
          if (lane < 4)
            *reinterpret_cast<float2*>(s_col + (4 * g + wq) * BN + c) = cs;
        }
      }
    if constexpr (EPI == EPI_MUL_AUX) {
      int m1, n1;
      if (tile_at(tk + 1, m1, n1)) load_aux(m1, n1);
    }
    fence_proxy_async();
    named_sync(1 + g, 128);
    if constexpr (EPI == EPI_MUL_AUX) {
      // the warpgroup's 64 rows: its four warps in order, tiles in order
      const float* sc = s_col + 4 * g * BN + tg;
      col_total += ((sc[0] + sc[BN]) + sc[2 * BN]) + sc[3 * BN];
    }
    if (tg == 0 && mw < p.M) {
      for (int h = 0; h < BN / 64; ++h) tma_store(&tm_out, epi + h * 8192, n0 + 64 * h, mw);
      bulk_commit();
    }
  }
  if constexpr (EPI == EPI_MUL_AUX)  // row (block's row group, warpgroup)
    p.col_part[(size_t)(blockIdx.x / tiles_n * 2 + g) * p.N + blockIdx.x % tiles_n * BN + tg] =
        col_total;
  if (tg == 0) bulk_wait();
}

// ------------------------------------------------------ weight gradients

// Per tile width BN (128 or 256 columns of Q): stages of P (two 64 x 64
// boxes) and Q (BN / 64 boxes), ~192 KB of them, then PRO_LN's per-stage
// row statistics (64 rows of mu, rstd) and the barriers.
template <int BN>
struct DwCfg {
  static constexpr int STAGES = BN == 256 ? 4 : 6;
  static constexpr int STAGE_BYTES = 16384 + BN * 128;
  static constexpr int STATS_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = STATS_OFF + STAGES * 512;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 16 * STAGES;
};

struct DwKernelArgs {
  int M, I, J;         // P (M, I) and Q (M, J); tiles of 128 x BN over (I, J)
  int splits, chunk;   // M in `splits` chunks of `chunk` rows (a multiple of 64)
  float* dst;          // per split (I, J), or (J, I) for PRO_LN
  const float* stats;  // PRO_LN: (M, 2) mu, rstd of P's rows
  const float* ln_w;   // (I,)
  const float* ln_b;
};

// dst[s] = prologue(P)^T Q over the rows of split s: PRO_NONE stores (I,
// J), PRO_LN (the LN on P, A from registers) stores the tile transposed,
// (J, I). Item order: splits outermost, then I tiles, then J tiles, so the
// blocks in flight read the same rows. PRO_LN: a second producer warp
// copies each step's 64 rows of statistics into the stage's slot, and the
// stage's full barrier waits for it as well as for the TMA bytes.
template <int PRO, int BN>
__global__ void __launch_bounds__(SM_THREADS, 1)
gemm_dw_sm90_kernel(const __grid_constant__ CUtensorMap tm_p,
                    const __grid_constant__ CUtensorMap tm_q, const DwKernelArgs p) {
  using Cfg = DwCfg<BN>;
  constexpr int STAGES = Cfg::STAGES, NH = BN / 128;
  extern __shared__ uint8_t smem_dyn[];
  const uint32_t raw = smem_u32(smem_dyn);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float2* s_stats = reinterpret_cast<const float2*>(smem_dyn + (base - raw) + Cfg::STATS_OFF);
  const uint32_t bars = base + Cfg::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_j = p.J / BN;
  const int tiles = p.I / 128 * tiles_j;
  const int items = tiles * p.splits;
  // item -> tile origin (i0, j0), first row m0 and its 64-row steps
  auto item = [&](int it, int& i0, int& j0, int& m0, int& steps) {
    const int t = it % tiles;
    i0 = t / tiles_j * 128;
    j0 = t % tiles_j * BN;
    m0 = it / tiles * p.chunk;
    steps = (min(p.M, m0 + p.chunk) - m0 + 63) / 64;
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), PRO == PRO_LN ? 2 : 1);
      mbar_init(empty(s), SM_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= SM_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(SM_PRODUCER_REGS));
    const int pw_warp = warp - SM_CONSUMERS / 32;  // 0: TMA, 1: statistics (PRO_LN)
    if (pw_warp == 0 && lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int i0, j0, m0, steps;
        item(it, i0, j0, m0, steps);
        for (int kt = 0; kt < steps; ++kt) {
          mbar_wait(empty(s), ph ^ 1);
          const uint32_t sa = base + s * Cfg::STAGE_BYTES;
          const int m = m0 + 64 * kt;
          mbar_expect_tx(full(s), Cfg::STAGE_BYTES);
          tma_load(sa, &tm_p, full(s), i0, m);
          tma_load(sa + 8192, &tm_p, full(s), i0 + 64, m);
          for (int q = 0; q < BN / 64; ++q)
            tma_load(sa + 16384 + q * 8192, &tm_q, full(s), j0 + 64 * q, m);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (PRO == PRO_LN && pw_warp == 1) {
      // rows past M read (0, 0): rstd 0, an LN output of exactly 0
      float2* st = reinterpret_cast<float2*>(smem_dyn + (base - raw) + Cfg::STATS_OFF);
      int s = 0;
      uint32_t ph = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        int i0, j0, m0, steps;
        item(it, i0, j0, m0, steps);
        for (int kt = 0; kt < steps; ++kt) {
          mbar_wait(empty(s), ph ^ 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 32 * h + lane, m = m0 + 64 * kt + r;
            st[64 * s + r] = m < p.M ? __ldg(reinterpret_cast<const float2*>(p.stats) + m)
                                     : make_float2(0.f, 0.f);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(full(s));
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns output rows [i0 + 64 g, + 64), P's box g;
  // a thread holds rows r_lo, r_lo + 8 and columns 128 h + 8 j + cq, + 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(SM_CONSUMER_REGS));
  const int g = tid >> 7, wq = warp & 3;
  const int r_lo = wq * 16 + (lane >> 2), cq = 2 * (lane & 3);
  float acc[NH][64];
  uint32_t afr[2][4][4];  // PRO_LN: A fragments of two steps (k16 step, register)
  int s = 0, prev = 0;
  uint32_t ph = 0;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int i0, j0, m0, steps;
    item(it, i0, j0, m0, steps);
    float lw[2] = {0.f, 0.f}, lb[2] = {0.f, 0.f};
    if constexpr (PRO == PRO_LN) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        lw[i] = __ldg(p.ln_w + i0 + 64 * g + r_lo + 8 * i);
        lb[i] = __ldg(p.ln_b + i0 + 64 * g + r_lo + 8 * i);
      }
    }
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;

    // one step of 64 rows on stage s, A fragments (PRO_LN) in buffer B
    auto step = [&](auto buf, int kt) {
      [[maybe_unused]] constexpr int B = decltype(buf)::value;
      mbar_wait(full(s), ph);
      const uint32_t sa = base + s * Cfg::STAGE_BYTES, sq = sa + 16384;
      if constexpr (PRO == PRO_LN) {
        // ldmatrix.trans of P's box g: matrix q = lane / 8 holds columns
        // 16 wq + 8 (q & 1) + [0, 8) of rows 16 kk + 8 (q >> 1) + [0, 8), so
        // register q is the A fragment (rows = columns of P, k = rows);
        // its elements are rows 16 kk + 8 (q >> 1) + cq, + 1
        const int q = lane >> 3, rr = lane & 7;
        const uint32_t box = sa + g * 8192 + (((2 * wq + (q & 1)) ^ rr) << 4);
        const float2* st = s_stats + 64 * s + cq;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t x[4];
          ldsm4t(x, box + (16 * kk + 8 * (q >> 1) + rr) * 128);
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // r: column half r & 1, row half r >> 1
            const int i = r & 1, h = r >> 1;
            const float2 s0 = st[16 * kk + 8 * h], s1 = st[16 * kk + 8 * h + 1];
            const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&x[r]);
            float y0 = (__low2float(xv) - s0.x) * s0.y * lw[i] + lb[i];
            float y1 = (__high2float(xv) - s1.x) * s1.y * lw[i] + lb[i];
            if (s0.y == 0.f) y0 = 0.f;
            if (s1.y == 0.f) y1 = 0.f;
            afr[B][kk][r] = pack_bf16(y0, y1);
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t dq = wgmma_desc_mn(sq + h * 16384 + kk * 2048);
          if constexpr (PRO == PRO_LN)
            wgmma_rs<1>(acc[h], afr[B][kk], dq);
          else
            wgmma_ss<1, 1>(acc[h], wgmma_desc_mn(sa + g * 8192 + kk * 2048), dq);
        }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty(prev));
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    };
    int kt = 0;
    for (; kt + 1 < steps; kt += 2) {  // pairs, so buffer 0 always follows buffer 1
      step(std::integral_constant<int, 0>{}, kt);
      step(std::integral_constant<int, 1>{}, kt + 1);
    }
    if (kt < steps) step(std::integral_constant<int, 0>{}, kt);
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
    if (lane == 0) mbar_arrive(empty(prev));

    float* dst = p.dst + (size_t)(it / tiles) * p.I * p.J;
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i0 + 64 * g + r_lo + 8 * i, col = j0 + 128 * h + 8 * j + cq;
          const float v0 = acc[h][4 * j + 2 * i], v1 = acc[h][4 * j + 2 * i + 1];
          if constexpr (PRO == PRO_LN) {
            dst[(size_t)col * p.I + row] = v0;
            dst[(size_t)(col + 1) * p.I + row] = v1;
          } else {
            *reinterpret_cast<float2*>(dst + (size_t)row * p.J + col) = make_float2(v0, v1);
          }
        }
  }
}

// ------------------------------------------------------------------ host

using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library links without -lcuda
inline TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<TensorMapEncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// tensor maps encoded so far (each cache miss), for the launch counts a
// caller prints
inline long long& tensor_map_encodes() {
  static long long n = 0;
  return n;
}

// map of a row-major (rows, cols) bf16 matrix in boxes of box_rows x 64
// columns with 128-byte swizzle; out-of-range rows load as zeros
inline bool tensor_map(CUtensorMap* m, const void* ptr, int rows, int cols, int box_rows) {
  const TensorMapEncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  ++tensor_map_encodes();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map through a cache keyed by (pointer, shape, box): a forward
// request encodes ~400 maps and a train step several thousand, most of
// them on addresses the allocator hands out again. A map depends on
// nothing else, so a hit is the map the encoder would return. A hash map
// of up to 8192 entries (a train step's distinct keys, with room), emptied
// when full.
inline bool tensor_map_cached(CUtensorMap* m, const void* ptr, int rows, int cols,
                              int box_rows) {
  struct Key {
    const void* ptr;
    int rows, cols, box_rows;
    bool operator==(const Key& o) const {
      return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows;
    }
  };
  struct Hash {
    size_t operator()(const Key& k) const {
      size_t h = std::hash<const void*>()(k.ptr);
      for (int v : {k.rows, k.cols, k.box_rows}) h = h * 1000003u ^ (size_t)(unsigned)v;
      return h;
    }
  };
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  const Key key{ptr, rows, cols, box_rows};
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *m = hit->second;
    return true;
  }
  if (!tensor_map(m, ptr, rows, cols, box_rows)) return false;
  if (cache.size() >= 8192) cache.clear();
  cache.emplace(key, *m);
  return true;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// blocks per column tile of an EPI_MUL_AUX launch (its grid is this
// times N / 128); col_part holds two rows per block of a column
inline int mul_aux_groups(int M, int N) {
  const int tiles_m = (M + SM_BM - 1) / SM_BM;
  const int g = sm_count() / (N / 128);
  return g < 1 ? 1 : g < tiles_m ? g : tiles_m;
}

inline int mul_aux_rows(int M, int N) { return 2 * mul_aux_groups(M, N); }

template <int PRO, int EPI, int BN, bool BT>
inline cudaError_t gemm_sm90_launch(const CUtensorMap& a, const CUtensorMap& w,
                                    const CUtensorMap& out, const CUtensorMap& res,
                                    const Sm90Args& p, int tiles, cudaStream_t stream) {
  auto kernel = gemm_sm90_kernel<PRO, EPI, BN, BT>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)Sm90Cfg<BN>::smem(sm90_extra_k(PRO, EPI, SM_LN_KMAX)));
  if (attr != cudaSuccess) return attr;
  const int grid = EPI == EPI_MUL_AUX ? mul_aux_groups(p.M, p.N) * (p.N / BN)
                   : tiles < sm_count() ? tiles
                                        : sm_count();
  kernel<<<grid, SM_THREADS, Sm90Cfg<BN>::smem(sm90_extra_k(PRO, EPI, p.K)), stream>>>(
      a, w, out, res, p);
  return cudaGetLastError();
}

// out (M, N) bf16 = epilogue(prologue(A) . W^T), W (N, K); with BT, W is
// (K, N) as stored and out = epilogue(A . W) (an input gradient). `resid`
// (M, N) for EPI_RESID; EPI_F32 writes p.out_f32 instead of `out`. Tiles
// of 128 x 256 for the LN prologue where N allows (its A fragments,
// normalised in registers, then serve twice the columns), else 128 x 128:
// the split that read fastest at every Swin-B stage on the card
// (PERF.md). Returns cudaErrorInvalidValue for a shape it does not take.
template <int PRO, int EPI, bool BT = false>
inline cudaError_t gemm_sm90(const bf16* A, const bf16* W, bf16* out, const bf16* resid,
                             const Sm90Args& p, cudaStream_t stream) {
  if (p.M < 1 || p.N % 128 || p.K % 128 || (PRO == PRO_LN && p.K > SM_LN_KMAX))
    return cudaErrorInvalidValue;
  const long long t128 = (long long)((p.M + SM_BM - 1) / SM_BM) * (p.N / 128);
  const bool wide = PRO == PRO_LN && !BT && p.N % 256 == 0;
  CUtensorMap ta, tw, to, tr;
  if (!tensor_map_cached(&ta, A, p.M, p.K, SM_BM) ||
      !(BT ? tensor_map_cached(&tw, W, p.K, p.N, 64)
           : tensor_map_cached(&tw, W, p.N, p.K, wide ? 256 : 128)))
    return cudaErrorInvalidValue;
  if (EPI == EPI_F32) {
    to = tr = ta;  // no bf16 output
  } else {
    if (!tensor_map_cached(&to, out, p.M, p.N, 64) ||
        (EPI == EPI_RESID && !tensor_map_cached(&tr, resid, p.M, p.N, 64)))
      return cudaErrorInvalidValue;
    if (EPI != EPI_RESID) tr = to;
  }
  if constexpr (PRO == PRO_LN && !BT)
    if (wide)
      return gemm_sm90_launch<PRO, EPI, 256, BT>(ta, tw, to, tr, p, (int)(t128 / 2), stream);
  return gemm_sm90_launch<PRO, EPI, 128, BT>(ta, tw, to, tr, p, (int)t128, stream);
}

inline Sm90Args sm90_args(int M, int N, int K, const float* bias) {
  Sm90Args p{};
  p.M = M; p.N = N; p.K = K;
  p.bias = bias;
  p.rs_div = 1;
  return p;
}

// ---------------------------------------------------- weight-gradient host

struct DwArgs {
  const bf16* A;        // (M, N): rows of the weight gradient
  const bf16* B;        // (M, K): its columns, through the prologue
  float* part;          // dw_part_elems(M, N, K) f32 of scratch
  int M, N, K;
  const float* stats;   // PRO_LN on B: (M, 2) mu, rstd
  const float* ln_w;    // (K,)
  const float* ln_b;
};

// The weight gradient's tile width: 256 columns of Q where they divide
// (Q = B for PRO_NONE, A for PRO_LN), else 128.
inline int dw_bn(int N, int K, bool ln) { return (ln ? N : K) % 256 == 0 ? 256 : 128; }

// Splits of M for an (N, K) weight gradient on the persistent grid: the
// split count whose waves of (tile, split) items, each carrying ~4 steps
// of fill and epilogue, plus the partials' round trip (~8 N K bytes a
// split, counted in steps of 64 rows), cost least. Chunks are whole 64-row
// steps.
struct DwPlan {
  int splits, chunk;
};

inline DwPlan dw_plan(int M, int N, int K, bool ln) {
  const int bn = dw_bn(N, K, ln);
  const long long tiles = (long long)(N * K) / (128 * bn);
  const double step = bn / 128.0;  // a step's time, in 128-column steps
  const int steps = (M + 63) / 64, sms = sm_count();
  int best = 1;
  double best_cost = 1e300;
  for (int s = 1; s <= steps && s <= 4 * sms; ++s) {
    const int per = (steps + s - 1) / s;
    if ((steps + per - 1) / per != s) continue;  // another s gives the same chunks
    const double waves = (double)((tiles * s + sms - 1) / sms);
    const double cost =
        waves * (per + 4) * step + (s > 1 ? (double)s * N * K / 100000.0 : 0.0);
    if (cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return {best, (steps + best - 1) / best * 64};
}

inline long long dw_part_elems(int M, int N, int K, bool ln) {
  const DwPlan p = dw_plan(M, N, K, ln);
  return p.splits > 1 ? (long long)p.splits * N * K : 0;
}

template <int PRO, int BN>
inline cudaError_t gemm_dw_sm90_launch(const CUtensorMap& tp, const CUtensorMap& tq,
                                       const DwKernelArgs& k, cudaStream_t stream) {
  auto kernel = gemm_dw_sm90_kernel<PRO, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DwCfg<BN>::SMEM);
  if (attr != cudaSuccess) return attr;
  const long long items = (long long)(k.I / 128) * (k.J / BN) * k.splits;
  const int grid = items < sm_count() ? (int)items : sm_count();
  kernel<<<grid, SM_THREADS, DwCfg<BN>::SMEM, stream>>>(tp, tq, k);
  return cudaGetLastError();
}

// Weight gradient out (N, K) f32 = A^T . prologue(B), through the split
// partials in a.part when M is split. N and K multiples of 128.
template <int PRO>
inline cudaError_t gemm_dw_sm90(const DwArgs& a, float* out, cudaStream_t stream) {
  if (a.M < 1 || a.N % 128 || a.K % 128) return cudaErrorInvalidValue;
  constexpr bool ln = PRO == PRO_LN;
  // PRO_NONE: P = A, Q = B; PRO_LN: P = B (the LN'd register operand), Q = A
  DwKernelArgs k{};
  k.M = a.M;
  k.I = ln ? a.K : a.N;
  k.J = ln ? a.N : a.K;
  const DwPlan plan = dw_plan(a.M, a.N, a.K, ln);
  const int bn = dw_bn(a.N, a.K, ln);
  k.splits = plan.splits;
  k.chunk = plan.chunk;
  k.dst = plan.splits > 1 ? a.part : out;
  k.stats = a.stats;
  k.ln_w = a.ln_w;
  k.ln_b = a.ln_b;
  CUtensorMap tp, tq;
  if (!tensor_map_cached(&tp, ln ? a.B : a.A, a.M, k.I, 64) ||
      !tensor_map_cached(&tq, ln ? a.A : a.B, a.M, k.J, 64))
    return cudaErrorInvalidValue;
  const cudaError_t err = bn == 256 ? gemm_dw_sm90_launch<PRO, 256>(tp, tq, k, stream)
                                    : gemm_dw_sm90_launch<PRO, 128>(tp, tq, k, stream);
  if (err != cudaSuccess) return err;
  if (plan.splits > 1) reduce_splits(a.part, out, plan.splits, (long long)a.N * a.K, stream);
  return cudaGetLastError();
}

}  // namespace pw
