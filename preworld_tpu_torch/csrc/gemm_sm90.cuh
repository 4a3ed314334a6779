// Hopper GEMM of the Swin half-blocks' forward products: TMA loads into a
// ring of shared-memory stages, wgmma.mma_async from two consumer
// warpgroups, the LayerNorm prologue and the fused epilogues kept.
//
// Serves K1 (swin_block.cu: qkv with the LN1 prologue, proj with the
// residual epilogue; K1b's qkv recompute calls the same code) and K2
// (swin_mlp.cu: fc1 with the LN2 prologue and GELU, fc2 with the residual;
// K2b's fc1 recompute, swin_mlp_bwd.cu, keeps the f32 pre-activation too),
// the TPU kernels preworld_tpu/ops/swin_block_pallas.py::fused_swin_attn_block
// and preworld_tpu/ops/swin_mlp_pallas.py::fused_swin_mlp.
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
// (+bias, exact-erf GELU), EPI_BIAS_GELU_SAVE (as EPI_BIAS_GELU, and the
// f32 pre-activation to out_f32), EPI_RESID (bf16(resid + row_scale[m /
// rs_div] (acc + bias)), the residual tile brought in by TMA). The bf16
// result goes through a swizzled shared tile and leaves by TMA store,
// which clips the ragged last row tile.
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
#pragma once

#include <cuda.h>

#include <mutex>
#include <type_traits>

#include "gemm.cuh"

namespace pw {

constexpr int SM_BM = 128, SM_BK = 64;
constexpr int SM_CONSUMERS = 256;               // two warpgroups of 64 rows
constexpr int SM_THREADS = SM_CONSUMERS + 128;  // and a producer warpgroup
// registers a thread after setmaxnreg: 40 in the producer, 232 in the
// consumers (128 x 40 + 256 x 232 <= 65536; the launch gives 168 each)
constexpr int SM_PRODUCER_REGS = 40, SM_CONSUMER_REGS = 232;
constexpr int SM_LN_KMAX = 1536;                // widest LN prologue (Swin-L)

enum Sm90Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_BIAS_GELU_SAVE = 2, EPI_RESID = 3 };

struct Sm90Args {
  int M, N, K;
  const float* bias;       // (N,) or null
  const float* stats;      // PRO_LN: (M, 2) mu, rstd
  const float* ln_w;       // PRO_LN: (K,)
  const float* ln_b;
  const float* row_scale;  // EPI_RESID: indexed by m / rs_div, or null (= 1)
  int rs_div;
  float* out_f32;          // EPI_BIAS_GELU_SAVE: (M, N) f32 pre-activation
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
  // dynamic shared bytes, with room to align the base to 1024
  static constexpr size_t smem(int ln_k) { return 1024 + LN_OFF + 8 * (size_t)ln_k; }
};

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

// d (64 x 128 f32) += A (64 x 16, shared) . B (16 x 128, shared), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PW_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PW_D64_ARGS(d)
      : "l"(da), "l"(db), "r"(1));
}

// the same with A from registers (the m16n8k16 A fragment of each warp's
// 16 rows)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PW_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : PW_D64_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef PW_D64
#undef PW_D64_ARGS

// ---------------------------------------------------------------- kernel

template <int PRO, int EPI, int BN>
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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = p.N / BN;
  const int tiles = (p.M + SM_BM - 1) / SM_BM * tiles_n;
  const int KT = p.K / SM_BK;

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
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * SM_BM, n0 = t % tiles_n * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(empty(s), ph ^ 1);
          const uint32_t sa = base + s * Cfg::STAGE_BYTES;
          mbar_expect_tx(full(s), Cfg::STAGE_BYTES);
          tma_load(sa, &tm_a, full(s), kt * SM_BK, m0);
          tma_load(sa + Cfg::A_BYTES, &tm_w, full(s), kt * SM_BK, n0);
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
  int s = 0, prev = 0;
  uint32_t ph = 0, epi_ph = 0;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / tiles_n * SM_BM, n0 = t % tiles_n * BN;
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
          const uint64_t db = wgmma_desc(sb + h * 128 * 128 + kk * 32);
          if constexpr (PRO == PRO_LN)
            wgmma_rs(acc[h], afr[B][kk], db);
          else
            wgmma_ss(acc[h], wgmma_desc(sa + g * 8192 + kk * 32), db);
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
        float2 bb = make_float2(0.f, 0.f);
        if (p.bias) bb = __ldg(reinterpret_cast<const float2*>(p.bias + n0 + c));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rl = r_lo + 8 * i;
          float v0 = acc[h][4 * j + 2 * i] + bb.x, v1 = acc[h][4 * j + 2 * i + 1] + bb.y;
          if (EPI == EPI_BIAS_GELU_SAVE && mw + rl < p.M)
            *reinterpret_cast<float2*>(p.out_f32 + (size_t)(mw + rl) * p.N + n0 + c) =
                make_float2(v0, v1);
          if (EPI == EPI_BIAS_GELU || EPI == EPI_BIAS_GELU_SAVE) {
            v0 = pw_gelu(v0);
            v1 = pw_gelu(v1);
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
      }
    fence_proxy_async();
    named_sync(1 + g, 128);
    if (tg == 0 && mw < p.M) {
      for (int h = 0; h < BN / 64; ++h) tma_store(&tm_out, epi + h * 8192, n0 + 64 * h, mw);
      bulk_commit();
    }
  }
  if (tg == 0) bulk_wait();
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

// map of a row-major (rows, cols) bf16 matrix in boxes of box_rows x 64
// columns with 128-byte swizzle; out-of-range rows load as zeros
inline bool tensor_map(CUtensorMap* m, const void* ptr, int rows, int cols, int box_rows) {
  const TensorMapEncodeTiled fn = tensor_map_encoder();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// tensor_map through a small cache keyed by (pointer, shape, box): a
// forward request encodes ~400 maps, most of them on addresses the
// allocator hands out again. A map depends on nothing else, so a hit is
// the map the encoder would return.
inline bool tensor_map_cached(CUtensorMap* m, const void* ptr, int rows, int cols,
                              int box_rows) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    int rows, cols, box_rows;
  };
  constexpr int N = 64;
  static Entry cache[N] = {};
  static int next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *m = e.map;
      return true;
    }
  if (!tensor_map(m, ptr, rows, cols, box_rows)) return false;
  cache[next] = {*m, ptr, rows, cols, box_rows};
  next = (next + 1) % N;
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

template <int PRO, int EPI, int BN>
inline cudaError_t gemm_sm90_launch(const CUtensorMap& a, const CUtensorMap& w,
                                    const CUtensorMap& out, const CUtensorMap& res,
                                    const Sm90Args& p, int tiles, cudaStream_t stream) {
  auto kernel = gemm_sm90_kernel<PRO, EPI, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Sm90Cfg<BN>::smem(PRO == PRO_LN ? SM_LN_KMAX : 0));
  if (attr != cudaSuccess) return attr;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, SM_THREADS, Sm90Cfg<BN>::smem(PRO == PRO_LN ? p.K : 0), stream>>>(a, w, out,
                                                                                   res, p);
  return cudaGetLastError();
}

// out (M, N) bf16 = epilogue(prologue(A) . W^T); `resid` (M, N) for
// EPI_RESID. Tiles of 128 x 256 for the LN prologue where N allows (its A
// fragments, normalised in registers, then serve twice the columns), else
// 128 x 128: the split that read fastest at every Swin-B stage on the card
// (PERF.md). Returns cudaErrorInvalidValue for a shape it does not
// take.
template <int PRO, int EPI>
inline cudaError_t gemm_sm90(const bf16* A, const bf16* W, bf16* out, const bf16* resid,
                             const Sm90Args& p, cudaStream_t stream) {
  if (p.M < 1 || p.N % 128 || p.K % 128 || (PRO == PRO_LN && p.K > SM_LN_KMAX))
    return cudaErrorInvalidValue;
  const long long t128 = (long long)((p.M + SM_BM - 1) / SM_BM) * (p.N / 128);
  const bool wide = PRO == PRO_LN && p.N % 256 == 0;
  CUtensorMap ta, tw, to, tr;
  if (!tensor_map_cached(&ta, A, p.M, p.K, SM_BM) ||
      !tensor_map_cached(&tw, W, p.N, p.K, wide ? 256 : 128) ||
      !tensor_map_cached(&to, out, p.M, p.N, 64) ||
      !tensor_map_cached(&tr, EPI == EPI_RESID ? resid : out, p.M, p.N, 64))
    return cudaErrorInvalidValue;
  if constexpr (PRO == PRO_LN)
    if (wide) return gemm_sm90_launch<PRO, EPI, 256>(ta, tw, to, tr, p, (int)(t128 / 2), stream);
  return gemm_sm90_launch<PRO, EPI, 128>(ta, tw, to, tr, p, (int)t128, stream);
}

inline Sm90Args sm90_args(int M, int N, int K, const float* bias) {
  Sm90Args p{};
  p.M = M; p.N = N; p.K = K;
  p.bias = bias;
  p.rs_div = 1;
  return p;
}

}  // namespace pw
