// Helpers the Hopper kernels share, the LayerNorm statistics every K1 /
// K2 chain starts from, and the bandwidth passes of the Swin half-blocks'
// backward chains (K1b, K2b): column sums, the fixed-order reduction of
// split partials, and the LayerNorm backward. The products of all four
// chains (K1, K2, K1b, K2b) run on the TMA + wgmma pipeline of
// gemm_sm90.cuh.
//
// Every sum over rows is split into fixed chunks and reduced in a fixed
// order (no float atomics), so two runs give identical bits.
//
// Bound on H100 (3.35 TB/s): these passes move a few bytes per FLOP, so
// bytes bind. colsum_rows reads 16 bytes a thread, rows spread over a
// block's ~512 threads and blocks over ~4 per SM; the bias gradients of the
// proj and fc2 products (dbproj, db2) are taken in the pass that already
// reads dY to write bf16(rs dY) (K1b / K2b step 3), so dY is read once.
// reduce_splits sums split partials with a warp per run of splits and 16
// bytes a lane.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pw {

using bf16 = __nv_bfloat16;

// True where row m of the padded (B, Hp, Wp) layout holds a real token.
__device__ __forceinline__ bool pw_valid(int m, int Hp, int Wp, int Hv, int Wv) {
  int c = m % Wp;
  int r = (m / Wp) % Hp;
  return r < Hv && c < Wv;
}

__device__ __forceinline__ float pw_gelu(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// (GELU(z), d/dz GELU(z) = Phi(z) + z phi(z)) from one exact erf: the
// first is pw_gelu's value
__device__ __forceinline__ float2 pw_gelu_and_grad(float z) {
  const float c = 1.0f + erff(z * 0.70710678118654752f);
  return make_float2(0.5f * z * c, 0.5f * c + z * 0.3989422804014327f * expf(-0.5f * z * z));
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

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// Column sums of rs[m / rs_div] * A[m, n] over the rows of A (M, N) bf16
// (rs null = 1), in f32: part[s, n] over the s-th chunk of `rows` rows.
// With `scaled`, also scaled[m, n] = bf16(A[m, n] * rs[m / rs_div]), the
// pass that reads dY once for dyb and the bias gradient. A block of R x
// N / 8 threads: thread (r, c) reads 16 bytes (8 columns) of rows r, r +
// R, ... of its chunk and sums each column in row order; the R row sums
// are then added in order of r.
static __global__ void __launch_bounds__(1024)
colsum_rows_kernel(const bf16* __restrict__ A, const float* __restrict__ rs, int rs_div,
                   bf16* __restrict__ scaled, float* __restrict__ part, int M, int N,
                   int rows) {
  extern __shared__ float red[];  // (R, N)
  const int chunks = N / 8, R = blockDim.x / chunks;
  const int c8 = threadIdx.x % chunks, rl = threadIdx.x / chunks;
  const int m0 = blockIdx.x * rows, m1 = min(M, m0 + rows);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int m = m0 + rl; m < m1; m += R) {
    const size_t off = (size_t)m * N + 8 * c8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(A + off));
    const float s = rs ? __ldg(rs + m / rs_div) : 1.f;
    const bf16* xv = reinterpret_cast<const bf16*>(&v);
    __align__(16) bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(xv[j]) * s;
      acc[j] += f;
      o[j] = __float2bfloat16(f);
    }
    if (scaled) *reinterpret_cast<uint4*>(scaled + off) = *reinterpret_cast<const uint4*>(o);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[rl * N + 8 * c8 + j] = acc[j];
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float t = 0.f;
    for (int r = 0; r < R; ++r) t += red[r * N + n];
    part[(size_t)blockIdx.x * N + n] = t;
  }
}

// Chunks of colsum_rows over M rows of N columns: ~64 KB a block, at most
// four blocks per SM.
inline int colsum_splits(int M, int N, int sms) {
  long long s = (long long)M * N * 2 / 65536;
  if (s > 4LL * sms) s = 4LL * sms;
  if (s < 1) s = 1;
  const int rows = (int)((M + s - 1) / s);
  return (M + rows - 1) / rows;
}

// out[i] = sum over s < S of part[s * L + i] in a fixed order, L % 4 ==
// 0: a block of W warps covers 128 (W / G) outputs, each lane four of
// them; G runs over s (G the largest power of two <= min(S, W); run q sums
// s = q, q + G, ... in order) are added in order of q.
static __global__ void __launch_bounds__(1024)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out, int S, long long L,
                     int G) {
  __shared__ float4 run[32][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int q = w % G, grp = w / G;
  const long long i = ((long long)blockIdx.x * (W / G) + grp) * 128 + 4 * lane;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < L) {
#pragma unroll 4
    for (int s = q; s < S; s += G) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(part + (size_t)s * L + i));
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  run[w][lane] = acc;
  __syncthreads();
  if (q == 0 && i < L) {
    float4 t = run[w][lane];
    for (int r = 1; r < G; ++r) {
      const float4 v = run[w + r][lane];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    *reinterpret_cast<float4*>(out + i) = t;
  }
}

// W = 32 warps a block for up to 32 K outputs (few outputs over many
// splits: more runs in flight), else 8.
inline void reduce_splits(const float* part, float* out, int S, long long L,
                          cudaStream_t stream) {
  const int W = L <= 32768 ? 32 : 8;
  int G = 1;
  while (2 * G <= S && G < W) G *= 2;
  const long long per_block = 128LL * (W / G);
  reduce_splits_kernel<<<(unsigned)((L + per_block - 1) / per_block), 32 * W, 0, stream>>>(
      part, out, S, L, G);
}

// Column sums (see colsum_rows_kernel) reduced to out (N,) through `part`
// (colsum_splits(M, N, sms) x N f32). N % 8 == 0, N <= 8192.
inline void colsum_rows(const bf16* A, const float* rs, int rs_div, bf16* scaled, float* part,
                        float* out, int M, int N, int sms, cudaStream_t stream) {
  const int S = colsum_splits(M, N, sms);
  const int rows = (M + S - 1) / S;
  const int chunks = N / 8;
  const int threads = chunks >= 512 ? chunks : 512 / chunks * chunks;
  colsum_rows_kernel<<<S, threads, sizeof(float) * (threads / chunks) * N, stream>>>(
      A, rs, rs_div, scaled, part, M, N, rows);
  reduce_splits(part, out, S, N, stream);
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
