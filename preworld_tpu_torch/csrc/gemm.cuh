// Shared bf16 GEMMs of the Swin half-blocks' backward chains (K1b, K2b),
// the LayerNorm statistics every K1 / K2 chain starts from, and small
// helpers the Hopper kernels share. The forward products (K1's qkv and
// proj, K2's fc1 and fc2, and the recomputes of K1b / K2b) run on the
// TMA + wgmma pipeline of gemm_sm90.cuh.
//
// Input gradient (gemm_bf16, layout NN):
//   out[m, n] = epilogue( sum_k A[m, k] * W[k, n] )
// A (M, K) and W (K, N) row-major bf16 -- dX = dY . W of a Linear.
// Tensor-core products through nvcuda::wmma 16x16x16 bf16 fragments with
// f32 accumulation; one 128x128 output tile per 256-thread block, 4x2 warps
// of 32x64, K in steps of 32 with the next step's tiles prefetched into
// registers while the current step multiplies. The epilogue goes through a
// 16x16 f32 scratch tile per warp, one accumulator fragment at a time.
// Epilogues: plain bf16; plain f32 to `out_f32`; times GELU'(aux) with
// per-block f32 column sums into `col_part` (K2b's dhpre and db1).
//
// Weight gradient (gemm_dw, split over M):
//   part[s, n, k] = sum_{m in chunk s} A[m, n] * prologue(B)[m, k]
// over M chunks of `chunk` rows, grid (K/128, N/128, splits); the splits are
// summed by reduce_parts in a fixed order, so two runs give identical bits
// (no float atomics). PRO_LN on B applies the LayerNorm from per-row (mu,
// rstd) statistics (ln_stats_kernel, the ones the forward's prologue reads;
// rstd = 0 marks a zeroed pad row).
//
// Bound on H100: at the Swin-B widths these products are compute-bound
// (K = 128..4096), but the synchronous wmma tiles reach about a tenth of
// the bf16 tensor-core peak: every warp loads its own wmma fragments from
// shared memory and each K step waits at two barriers. Moving them onto
// gemm_sm90.cuh's mainloop is later work.
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
constexpr int GLDN = GBN + 8;   // smem row stride of a (32, 128) tile (bf16)
constexpr int GLDS = GBK + 8;   // smem row stride of a (128, 32) tile (bf16)
constexpr int GLDE = 16 + 4;    // smem row stride of a warp's f32 epilogue tile

enum Prologue { PRO_NONE = 0, PRO_LN = 1 };
enum Epilogue { EPI_NONE = 0, EPI_F32 = 1, EPI_GELU_GRAD = 2 };

struct GemmArgs {
  const bf16* A;        // (M, K)
  const bf16* W;        // (K, N)
  bf16* out;            // (M, N)
  int M, N, K;
  // EPI_F32 / EPI_GELU_GRAD
  float* out_f32;       // (M, N)
  const float* aux;     // (M, N) f32: the GELU pre-activation
  float* col_part;      // (gridDim.y, N) f32 column sums per row tile
};

// True where row m of the padded (B, Hp, Wp) layout holds a real token.
__device__ __forceinline__ bool pw_valid(int m, int Hp, int Wp, int Hv, int Wv) {
  int c = m % Wp;
  int r = (m / Wp) % Hp;
  return r < Hv && c < Wv;
}

__device__ __forceinline__ float pw_gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// d/dz GELU(z) = Phi(z) + z phi(z), exact erf form
__device__ __forceinline__ float pw_gelu_grad(float z) {
  return 0.5f * (1.0f + erff(z * 0.70710678118654752f))
         + z * 0.3989422804014327f * expf(-0.5f * z * z);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Per-row LayerNorm statistics of a (M, K) bf16 matrix, one warp per row:
// two-pass mean / variance in f32.
__device__ __forceinline__ void pw_row_stats(const bf16* row, int K, int lane, float eps,
                                             float* mu_out, float* rstd_out) {
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += __bfloat162float(row[k]);
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    float d = __bfloat162float(row[k]) - mu;
    v += d * d;
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  *mu_out = mu;
  *rstd_out = rsqrtf(v / (float)K + eps);
}

template <int EPI>
__global__ void __launch_bounds__(GTHREADS)
gemm_bf16_kernel(GemmArgs a) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[GBM][GLDS];
  __shared__ __align__(128) bf16 Ws[GBK * GLDN];
  __shared__ __align__(128) float Es[GWARPS][16][GLDE];
  __shared__ float s_col[4][GBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * GBN;
  const int m0 = blockIdx.y * GBM;
  const int K = a.K;

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
      // W: (32 k rows) x (16 chunks of 8 n)
      int kr = chunk >> 4, nc = (chunk & 15) * 8;
      rw[i] = *reinterpret_cast<const uint4*>(a.W + (size_t)(k0 + kr) * a.N + n0 + nc);
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GTHREADS;
      int r = chunk >> 2, kc = (chunk & 3) * 8;
      *reinterpret_cast<uint4*>(&As[r][kc]) = ra[i];
      int kr = chunk >> 4, nc = (chunk & 15) * 8;
      *reinterpret_cast<uint4*>(&Ws[kr * GLDN + nc]) = rw[i];
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
    store_tiles();
    __syncthreads();
    if (k0 + GBK < K) load_tiles(k0 + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &As[wm + i * 16][kk], GLDS);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], &Ws[kk * GLDN + wn + j * 16], GLDN);
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
  float csum[4] = {0.f, 0.f, 0.f, 0.f};  // EPI_GELU_GRAD: column lane of fragment j
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&E[0][0], acc[i][j], GLDE, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm + i * 16 + er;
      const int n = n0 + wn + j * 16 + ec;
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = E[er][ec + t];
      if (m < a.M) {
        __align__(16) bf16 o[8];
        const size_t off = (size_t)m * a.N + n;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (EPI == EPI_F32) a.out_f32[off + t] = v[t];
          if (EPI == EPI_GELU_GRAD) v[t] *= pw_gelu_grad(a.aux[off + t]);
          o[t] = __float2bfloat16(v[t]);
        }
        if (EPI != EPI_F32)
          *reinterpret_cast<uint4*>(a.out + off) = *reinterpret_cast<const uint4*>(o);
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) v[t] = 0.f;
      }
      if (EPI == EPI_GELU_GRAD) {
        // the tile's f32 values back into the scratch, then 16 lanes sum
        // one column each over the 16 rows, in row order
        __syncwarp();
#pragma unroll
        for (int t = 0; t < 8; ++t) E[er][ec + t] = v[t];
        __syncwarp();
        if (lane < 16) {
          float s = 0.f;
          for (int r = 0; r < 16; ++r) s += E[r][lane];
          csum[j] += s;
        }
      }
      __syncwarp();
    }
  }
  if (EPI == EPI_GELU_GRAD) {
    if (lane < 16)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_col[warp >> 1][wn + j * 16 + lane] = csum[j];
    __syncthreads();
    if (tid < GBN)
      a.col_part[(size_t)blockIdx.y * a.N + n0 + tid] =
          ((s_col[0][tid] + s_col[1][tid]) + s_col[2][tid]) + s_col[3][tid];
  }
}

// Host-side launch; the caller checks cudaGetLastError().
template <int EPI>
inline void gemm_bf16(const GemmArgs& a, cudaStream_t stream) {
  dim3 grid(a.N / GBN, (a.M + GBM - 1) / GBM);
  gemm_bf16_kernel<EPI><<<grid, GTHREADS, 0, stream>>>(a);
}

inline GemmArgs gemm_args(const bf16* A, const bf16* W, bf16* out, int M, int N, int K) {
  GemmArgs a{};
  a.A = A; a.W = W; a.out = out;
  a.M = M; a.N = N; a.K = K;
  return a;
}

// Per-row (mu, rstd) of x (M, K); rstd = 0 for pad tokens when pad_mask.
// The first launch of every K1 / K2 chain and of their backward chains.
static __global__ void ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ stats,
                                int M, int K, float eps, int pad_mask,
                                int Hp, int Wp, int Hv, int Wv) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= M) return;
  float mu, rstd;
  pw_row_stats(x + (size_t)warp * K, K, lane, eps, &mu, &rstd);
  if (pad_mask && !pw_valid(warp, Hp, Wp, Hv, Wv)) rstd = 0.f;
  if (lane == 0) {
    stats[2 * (size_t)warp] = mu;
    stats[2 * (size_t)warp + 1] = rstd;
  }
}

// Returns the launch's error.
inline cudaError_t ln_stats(const bf16* x, float* stats, int M, int K, int pad_mask, int Hp,
                            int Wp, int Hv, int Wv, cudaStream_t stream) {
  const int blocks = (M + 7) / 8;  // 8 warps of 32 per block
  ln_stats_kernel<<<blocks, 256, 0, stream>>>(x, stats, M, K, 1e-5f, pad_mask, Hp, Wp, Hv,
                                              Wv);
  return cudaGetLastError();
}

struct DwArgs {
  const bf16* A;        // (M, N): rows of the weight gradient
  const bf16* B;        // (M, K): columns of the weight gradient
  float* part;          // (splits, N, K)
  int M, N, K, chunk;   // rows per split
  // PRO_LN on B
  const float* stats;   // (M, 2) mu, rstd
  const float* ln_w;
  const float* ln_b;
};

template <int PRO>
__global__ void __launch_bounds__(GTHREADS)
gemm_dw_kernel(DwArgs a) {
  using namespace nvcuda;
  __shared__ __align__(128) bf16 As[GBK][GLDN];  // m x n
  __shared__ __align__(128) bf16 Bs[GBK][GLDN];  // m x k
  __shared__ __align__(128) float Es[GWARPS][16][GLDE];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * GBN;   // output columns (B's K)
  const int n0 = blockIdx.y * GBM;   // output rows (A's N)
  const int s = blockIdx.z;
  const int mbeg = s * a.chunk;
  const int mend = min(a.M, mbeg + a.chunk);

  uint4 ra[2], rb[2];
  auto load_tiles = [&](int mstep) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GTHREADS;   // (32 m rows) x (16 chunks of 8)
      int r = chunk >> 4, c = (chunk & 15) * 8;
      int m = mstep + r;
      if (m < mend) {
        ra[i] = *reinterpret_cast<const uint4*>(a.A + (size_t)m * a.N + n0 + c);
        rb[i] = *reinterpret_cast<const uint4*>(a.B + (size_t)m * a.K + k0 + c);
      } else {
        ra[i] = make_uint4(0, 0, 0, 0);
        rb[i] = make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_tiles = [&](int mstep) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int chunk = tid + i * GTHREADS;
      int r = chunk >> 4, c = (chunk & 15) * 8;
      uint4 vb = rb[i];
      int m = mstep + r;
      if (PRO == PRO_LN && m < mend) {
        const bf16* xv = reinterpret_cast<const bf16*>(&vb);
        float mu = a.stats[2 * (size_t)m], rstd = a.stats[2 * (size_t)m + 1];
        bool zero = (rstd == 0.f);
        __align__(16) bf16 y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          int k = k0 + c + j;
          float t = (__bfloat162float(xv[j]) - mu) * rstd * a.ln_w[k] + a.ln_b[k];
          y[j] = __float2bfloat16(zero ? 0.f : t);
        }
        vb = *reinterpret_cast<const uint4*>(y);
      }
      *reinterpret_cast<uint4*>(&As[r][c]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[r][c]) = vb;
    }
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  if (mbeg < mend) load_tiles(mbeg);
  for (int ms = mbeg; ms < mend; ms += GBK) {
    store_tiles(ms);
    __syncthreads();
    if (ms + GBK < mend) load_tiles(ms + GBK);
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      // A^T: element (n, m) of the fragment at As[m][n] -> column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &As[kk][wm + i * 16], GLDN);
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &Bs[kk][wn + j * 16], GLDN);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  float (*E)[GLDE] = Es[warp];
  const int er = lane >> 1, ec = (lane & 1) * 8;
  float* dst = a.part + (size_t)s * a.N * a.K;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(&E[0][0], acc[i][j], GLDE, wmma::mem_row_major);
      __syncwarp();
      const int n = n0 + wm + i * 16 + er;
      const int k = k0 + wn + j * 16 + ec;
      float4* d4 = reinterpret_cast<float4*>(dst + (size_t)n * a.K + k);
      d4[0] = make_float4(E[er][ec], E[er][ec + 1], E[er][ec + 2], E[er][ec + 3]);
      d4[1] = make_float4(E[er][ec + 4], E[er][ec + 5], E[er][ec + 6], E[er][ec + 7]);
      __syncwarp();
    }
  }
}

// out[i] = sum_{s < S} part[s * L + i], in order of s.
static __global__ void reduce_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int S, long long L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += part[(size_t)s * L + i];
  out[i] = acc;
}

inline void reduce_parts(const float* part, float* out, int S, long long L,
                         cudaStream_t stream) {
  reduce_parts_kernel<<<(unsigned)((L + 255) / 256), 256, 0, stream>>>(part, out, S, L);
}

// Splits of a weight-gradient GEMM over M: enough blocks for ~4 per SM,
// chunks a multiple of the 32-row step.
struct DwPlan {
  int splits, chunk;
};

inline DwPlan dw_plan(int M, int N, int K) {
  const int tiles = (N / GBM) * (K / GBN);
  int s = (528 + tiles - 1) / tiles;
  const int smax = (M + 255) / 256;
  if (s > smax) s = smax;
  if (s < 1) s = 1;
  int chunk = (M + s - 1) / s;
  chunk = (chunk + GBK - 1) / GBK * GBK;
  return {(M + chunk - 1) / chunk, chunk};
}

inline long long dw_part_elems(int M, int N, int K) {
  return (long long)dw_plan(M, N, K).splits * N * K;
}

// Weight gradient out (N, K) f32 = A^T . prologue(B) through the split
// partials in `part`.
template <int PRO>
inline void gemm_dw(DwArgs a, float* out, cudaStream_t stream) {
  const DwPlan p = dw_plan(a.M, a.N, a.K);
  a.chunk = p.chunk;
  dim3 grid(a.K / GBN, a.N / GBM, p.splits);
  gemm_dw_kernel<PRO><<<grid, GTHREADS, 0, stream>>>(a);
  reduce_parts(a.part, out, p.splits, (long long)a.N * a.K, stream);
}

// dyb[m, c] = bf16(dy[m, c] * row_scale[m / rs_div]) (row_scale null = 1).
static __global__ void scale_rows_kernel(const bf16* __restrict__ dy, const float* __restrict__ rs,
                                  int rs_div, bf16* __restrict__ out, long long M, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // chunk of 8
  if (i * 8 >= M * C) return;
  const long long m = i * 8 / C;
  const float s = rs ? rs[m / rs_div] : 1.f;
  uint4 v = reinterpret_cast<const uint4*>(dy)[i];
  const bf16* xv = reinterpret_cast<const bf16*>(&v);
  __align__(16) bf16 o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(__bfloat162float(xv[j]) * s);
  reinterpret_cast<uint4*>(out)[i] = *reinterpret_cast<const uint4*>(o);
}

inline void scale_rows(const bf16* dy, const float* rs, int rs_div, bf16* out, int M, int C,
                       cudaStream_t stream) {
  const long long chunks = (long long)M * C / 8;
  scale_rows_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(dy, rs, rs_div, out,
                                                                           M, C);
}

// Column sums of A (M, N) bf16, times row_scale[m / rs_div], in f32:
// part[s, n] over row chunk s, rows in order.
static __global__ void colsum_kernel(const bf16* __restrict__ A, const float* __restrict__ rs,
                              int rs_div, float* __restrict__ part, int M, int N, int rows) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (n >= N) return;
  const int m1 = min(M, (s + 1) * rows);
  float acc = 0.f;
  for (int m = s * rows; m < m1; ++m) {
    float v = __bfloat162float(A[(size_t)m * N + n]);
    acc += rs ? v * rs[m / rs_div] : v;
  }
  part[(size_t)s * N + n] = acc;
}

inline int colsum_splits(int M) {
  int s = (M + 2047) / 2048;
  return s < 1 ? 1 : s;
}

inline void colsum(const bf16* A, const float* rs, int rs_div, float* part, float* out, int M,
                   int N, cudaStream_t stream) {
  const int S = colsum_splits(M);
  const int rows = (M + S - 1) / S;
  colsum_kernel<<<dim3((N + 127) / 128, S), 128, 0, stream>>>(A, rs, rs_div, part, M, N, rows);
  reduce_parts(part, out, S, N, stream);
}

// LayerNorm backward with the residual, one warp per row (4 warps):
//   dy = dyln * ok (pad tokens masked when pad_mask), xhat = (x - mu) rstd,
//   dx = dres + rstd (dy w - mean(dy w) - xhat mean(dy w xhat)),
// and per-block partials of d ln_w = sum dy xhat, d ln_b = sum dy into
// part[block, 2, C], warps summed in a fixed order.
template <int CPL>
__global__ void __launch_bounds__(128)
ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ stats,
              const float* __restrict__ ln_w, const float* __restrict__ dyln,
              const bf16* __restrict__ dres, bf16* __restrict__ dx, float* __restrict__ part,
              int M, int rows, int pad_mask, int Hp, int Wp, int Hv, int Wv) {
  constexpr int C = CPL * 32;
  __shared__ float red[4][2][C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gacc[CPL], bacc[CPL], w[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    gacc[u] = 0.f;
    bacc[u] = 0.f;
    w[u] = ln_w[lane + 32 * u];
  }
  const int r0 = blockIdx.x * rows, r1 = min(M, r0 + rows);
  for (int m = r0 + warp; m < r1; m += 4) {
    const float mu = stats[2 * (size_t)m], rstd = stats[2 * (size_t)m + 1];
    const float ok = (!pad_mask || pw_valid(m, Hp, Wp, Hv, Wv)) ? 1.f : 0.f;
    float dy[CPL], xh[CPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const size_t off = (size_t)m * C + lane + 32 * u;
      dy[u] = dyln[off] * ok;
      xh[u] = (__bfloat162float(x[off]) - mu) * rstd;
      const float dxh = dy[u] * w[u];
      s1 += dxh;
      s2 += dxh * xh[u];
    }
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float m1 = s1 / (float)C, m2 = s2 / (float)C;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const size_t off = (size_t)m * C + lane + 32 * u;
      const float dxl = rstd * (dy[u] * w[u] - m1 - xh[u] * m2);
      dx[off] = __float2bfloat16(__bfloat162float(dres[off]) + dxl);
      gacc[u] += dy[u] * xh[u];
      bacc[u] += dy[u];
    }
  }
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    red[warp][0][lane + 32 * u] = gacc[u];
    red[warp][1][lane + 32 * u] = bacc[u];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * C; t += 128) {
    const int which = t / C, c = t % C;
    part[((size_t)blockIdx.x * 2 + which) * C + c] =
        ((red[0][which][c] + red[1][which][c]) + red[2][which][c]) + red[3][which][c];
  }
}

inline int ln_bwd_splits(int M) {
  int s = (M + 63) / 64;
  return s > 1024 ? 1024 : (s < 1 ? 1 : s);
}

// Built for every width C = 128 k up to 1536 (the Swin-T/S/B/L stages that
// take K1 / K2: 128 ... 1536); returns cudaErrorInvalidValue for another.
inline cudaError_t ln_bwd(const bf16* x, const float* stats, const float* ln_w,
                          const float* dyln, const bf16* dres, bf16* dx, float* part,
                          float* dln, int M, int C, int pad_mask, int Hp, int Wp, int Hv,
                          int Wv, cudaStream_t stream) {
  const int S = ln_bwd_splits(M);
  const int rows = (M + S - 1) / S;
#define PW_LN_BWD(CPL)                                                                 \
  ln_bwd_kernel<CPL><<<S, 128, 0, stream>>>(x, stats, ln_w, dyln, dres, dx, part, M, \
                                            rows, pad_mask, Hp, Wp, Hv, Wv)
  switch (C) {
    case 128: PW_LN_BWD(4); break;
    case 256: PW_LN_BWD(8); break;
    case 384: PW_LN_BWD(12); break;
    case 512: PW_LN_BWD(16); break;
    case 640: PW_LN_BWD(20); break;
    case 768: PW_LN_BWD(24); break;
    case 896: PW_LN_BWD(28); break;
    case 1024: PW_LN_BWD(32); break;
    case 1152: PW_LN_BWD(36); break;
    case 1280: PW_LN_BWD(40); break;
    case 1408: PW_LN_BWD(44); break;
    case 1536: PW_LN_BWD(48); break;
    default: return cudaErrorInvalidValue;
  }
#undef PW_LN_BWD
  reduce_parts(part, dln, S, 2LL * C, stream);
  return cudaSuccess;
}

}  // namespace pw
