// Shared tiled bf16 GEMM for the Swin half-block kernels (K1, K2).
//
//   out[m, n] = epilogue( sum_k prologue(A)[m, k] * W[n, k] )
//
// A is (M, K) row-major bf16; W is (N, K) row-major bf16 (the PyTorch
// Linear layout), so B = W^T is read as a column-major (K, N) operand.
// Tensor-core products through nvcuda::wmma 16x16x16 bf16 fragments with
// f32 accumulation; one 128x128 output tile per 256-thread block, 4x2 warps
// of 32x64, K in steps of 32 with the next step's tiles prefetched into
// registers while the current step multiplies. The epilogue goes through a
// 16x16 f32 scratch tile per warp, one accumulator fragment at a time.
//
// Prologue PRO_LN: LayerNorm over the K channels of each A row (two-pass
// mean / variance in f32, eps), affine, optionally zeroing rows that are
// pad tokens of the padded (B, Hp, Wp, C) Swin layout (row >= H or column
// >= W), then rounding to bf16 -- the LN output never reaches device
// memory.
// Epilogues: +bias; +bias then exact-erf GELU; or
// resid + row_scale * (acc + bias) (the residual add of a half-block).
//
// Bound on H100: at the Swin-B widths these products are compute-bound
// (K = 128..4096), but this synchronous-tile version reaches about a tenth
// of the bf16 tensor-core peak: every warp loads its own wmma fragments
// from shared memory and each K step waits at two barriers. wgmma / TMA
// pipelines are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace pw {

using bf16 = __nv_bfloat16;

constexpr int GBM = 128, GBN = 128, GBK = 32, GTHREADS = 256;
constexpr int GWARPS = GTHREADS / 32;
constexpr int GLDS = GBK + 8;   // smem row stride of A / W tiles (bf16)
constexpr int GLDE = 16 + 4;    // smem row stride of a warp's f32 epilogue tile

enum Prologue { PRO_NONE = 0, PRO_LN = 1 };
enum Epilogue { EPI_BIAS = 0, EPI_BIAS_GELU = 1, EPI_RESID = 2 };

struct GemmArgs {
  const bf16* A;        // (M, K)
  const bf16* W;        // (N, K)
  const float* bias;    // (N,) or null
  bf16* out;            // (M, N)
  int M, N, K;
  // PRO_LN
  const float* ln_w;    // (K,)
  const float* ln_b;    // (K,)
  float eps;
  int pad_mask;         // 1: zero the LN output of pad tokens
  int Hp, Wp, Hv, Wv;   // padded and valid (real) extents
  // EPI_RESID
  const bf16* resid;    // (M, N)
  const float* row_scale;  // indexed by m / rs_div, or null (= 1)
  int rs_div;
};

// True where row m of the padded (B, Hp, Wp) layout holds a real token.
__device__ __forceinline__ bool pw_token_valid(int m, const GemmArgs& a) {
  int c = m % a.Wp;
  int r = (m / a.Wp) % a.Hp;
  return r < a.Hv && c < a.Wv;
}

__device__ __forceinline__ float pw_gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

template <int PRO, int EPI>
__global__ void __launch_bounds__(GTHREADS)
gemm_bf16_kernel(GemmArgs a) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[GBM][GLDS];
  __shared__ __align__(128) bf16 Ws[GBN][GLDS];
  __shared__ __align__(128) float Es[GWARPS][16][GLDE];
  __shared__ float s_mu[GBM];
  __shared__ float s_rstd[GBM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * GBN;
  const int m0 = blockIdx.y * GBM;
  const int K = a.K;

  if (PRO == PRO_LN) {
    // per-row LayerNorm statistics: each warp owns GBM / GWARPS rows
    for (int rr = warp; rr < GBM; rr += GWARPS) {
      int m = m0 + rr;
      float mu = 0.f, rstd = 0.f;
      if (m < a.M) {
        const bf16* row = a.A + (size_t)m * K;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += __bfloat162float(row[k]);
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        mu = s / (float)K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          float d = __bfloat162float(row[k]) - mu;
          v += d * d;
        }
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        rstd = rsqrtf(v / (float)K + a.eps);
        if (a.pad_mask && !pw_token_valid(m, a)) rstd = 0.f;  // zero row
      }
      if (lane == 0) {
        s_mu[rr] = mu;
        s_rstd[rr] = rstd;
      }
    }
    __syncthreads();
  }

  // each thread moves 2 chunks of 8 bf16 for A and for W per K step
  uint4 ra[2], rw[2];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GTHREADS;       // 0..511: row chunk / 4, col 8 * (chunk % 4)
      int r = chunk >> 2, kc = (chunk & 3) * 8;
      int m = m0 + r;
      if (m < a.M) {
        ra[i] = *reinterpret_cast<const uint4*>(a.A + (size_t)m * K + k0 + kc);
      } else {
        ra[i] = make_uint4(0, 0, 0, 0);
      }
      int n = n0 + r;
      rw[i] = *reinterpret_cast<const uint4*>(a.W + (size_t)n * K + k0 + kc);
    }
  };
  auto store_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GTHREADS;
      int r = chunk >> 2, kc = (chunk & 3) * 8;
      uint4 va = ra[i];
      if (PRO == PRO_LN) {
        const bf16* xv = reinterpret_cast<const bf16*>(&va);
        float mu = s_mu[r], rstd = s_rstd[r];
        bool zero = (rstd == 0.f);
        __align__(16) bf16 y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int k = k0 + kc + j;
          float t = (__bfloat162float(xv[j]) - mu) * rstd * a.ln_w[k] + a.ln_b[k];
          y[j] = __float2bfloat16(zero ? 0.f : t);
        }
        va = *reinterpret_cast<const uint4*>(y);
      }
      *reinterpret_cast<uint4*>(&As[r][kc]) = va;
      *reinterpret_cast<uint4*>(&Ws[r][kc]) = rw[i];
    }
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_tiles(0);
  for (int k0 = 0; k0 < K; k0 += GBK) {
    store_tiles(k0);
    __syncthreads();
    if (k0 + GBK < K) load_tiles(k0 + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm + i * 16][kk], GLDS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[wn + j * 16][kk], GLDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through the warp's scratch tile:
  // lane -> row lane / 2, 8 columns from 8 * (lane % 2)
  float (*E)[GLDE] = Es[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&E[0][0], acc[i][j], GLDE, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm + i * 16 + er;
      const int n = n0 + wn + j * 16 + ec;
      if (m < a.M) {
        float rs = 1.f;
        if (EPI == EPI_RESID && a.row_scale) rs = a.row_scale[m / a.rs_div];
        __align__(16) bf16 o[8];
        __align__(16) bf16 res[8];
        if (EPI == EPI_RESID)
          *reinterpret_cast<uint4*>(res) =
              *reinterpret_cast<const uint4*>(a.resid + (size_t)m * a.N + n);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          float v = E[er][ec + t] + (a.bias ? a.bias[n + t] : 0.f);
          if (EPI == EPI_BIAS_GELU) v = pw_gelu(v);
          if (EPI == EPI_RESID) v = __bfloat162float(res[t]) + rs * v;
          o[t] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(a.out + (size_t)m * a.N + n) =
            *reinterpret_cast<const uint4*>(o);
      }
      __syncwarp();
    }
  }
}

// Host-side launch; the caller checks cudaGetLastError().
template <int PRO, int EPI>
inline void gemm_bf16(const GemmArgs& a, cudaStream_t stream) {
  dim3 grid(a.N / GBN, (a.M + GBM - 1) / GBM);
  gemm_bf16_kernel<PRO, EPI><<<grid, GTHREADS, 0, stream>>>(a);
}

inline GemmArgs gemm_args(const bf16* A, const bf16* W, const float* bias,
                          bf16* out, int M, int N, int K) {
  GemmArgs a{};
  a.A = A; a.W = W; a.bias = bias; a.out = out;
  a.M = M; a.N = N; a.K = K;
  a.eps = 1e-5f;
  a.rs_div = 1;
  return a;
}

}  // namespace pw
