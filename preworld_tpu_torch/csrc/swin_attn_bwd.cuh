// Window-attention backward core shared by K1b (swin_block_bwd.cu) and
// K5b / K6b (window_attn_bwd.cu), on the index maps and mask sources of
// the forward core (swin_attn.cuh).
//
// One block per (head, group of windows); per window it gathers q, k, v
// and dO of its N tokens through the map, recomputes S and P per 16-row
// strip (mask, bias, P rounded to bf16 as in the forward), then
//   D_i = rowsum(dO o O) with O = P V,  dS = P o (dO V^T - D),
//   dQ = dS K d^-1/2 (row strips), dV = P^T dO, dK = dS^T Q d^-1/2
// (column strips after a barrier), written to dqkv through the map. dS is
// added into the block's own (N, N) slice of a (heads, groups, N, N) f32
// partial buffer, each element always by the same thread, then reduced
// over groups in a fixed order: no float atomics, identical bits run to
// run. q, k, v, dO, P and dS of one window fill 229 KB of shared memory
// (one block per SM); the kernel is latency-bound on its per-warp strips.
#pragma once

#include "swin_attn.cuh"

namespace pw {

constexpr int AB_LDT = 32 + 4;  // f32 stride of a warp's 16 x 32 tile

struct AttnBwdSmem {
  int N, ldS, ldP;
  size_t q, k, v, dout, P, dS, strip, tile, D, reg, total;
  __host__ __device__ AttnBwdSmem(int n) : N(n) {
    ldS = n + 4;  // f32 strip: scores, then probabilities
    ldP = n + 8;  // bf16 full P and dS
    q = 0;
    k = q + (size_t)n * AT_LDQ * 2;
    v = k + (size_t)n * AT_LDQ * 2;
    dout = v + (size_t)n * AT_LDQ * 2;
    P = (dout + (size_t)n * AT_LDQ * 2 + 127) / 128 * 128;
    dS = P + (size_t)n * ldP * 2;
    strip = (dS + (size_t)n * ldP * 2 + 127) / 128 * 128;
    tile = strip + (size_t)AT_WARPS * 16 * ldS * 4;
    D = tile + (size_t)AT_WARPS * 16 * AB_LDT * 4;
    reg = D + (size_t)n * 4;
    total = reg + (size_t)n * 4;
  }
};

struct AttnBwdPlan {
  int groups, per;
};

// windows per block: enough (head, group) blocks for two per SM
inline AttnBwdPlan attn_bwd_plan(int windows, int heads) {
  int g = (264 + heads - 1) / heads;
  if (g > windows) g = windows;
  if (g < 1) g = 1;
  const int per = (windows + g - 1) / g;
  return {(windows + per - 1) / per, per};
}

// f32 elements of the d rel-bias partial buffer
inline long long attn_bwd_part_elems(int windows, int heads, int N) {
  return (long long)heads * attn_bwd_plan(windows, heads).groups * N * N;
}

// 16 tokens x 32 channels of a warp's f32 tile (scaled, rounded to bf16)
// into `dst` (rows of ldd) at column `col0`, through the index map.
template <class Map>
__device__ __forceinline__ void store_strip(const float* T, float s, bf16* dst, size_t ldd,
                                            int col0, int st, const Map& map, int win,
                                            int lane) {
  for (int idx = lane; idx < 64; idx += 32) {
    const int rr = idx >> 2, part = idx & 3;
    const int t = st * 16 + rr;
    __align__(16) bf16 o8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o8[j] = __float2bfloat16(s * T[rr * AB_LDT + part * 8 + j]);
    *reinterpret_cast<uint4*>(dst + map.row(win, t) * ldd + col0 + part * 8) =
        *reinterpret_cast<const uint4*>(o8);
  }
}

template <class Map, int MASK>
__global__ void __launch_bounds__(AT_THREADS, 1)
window_attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       const float* __restrict__ rel_bias, const void* __restrict__ mask,
                       bf16* __restrict__ dqkv, float* __restrict__ dbias_part, Map map,
                       int windows, int C, int N, float scale, int groups, int per) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdSmem L(N);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* Pf = reinterpret_cast<bf16*>(smem + L.P);
  bf16* dSf = reinterpret_cast<bf16*>(smem + L.dS);
  float* Dsm = reinterpret_cast<float*>(smem + L.D);
  int* reg = reinterpret_cast<int*>(smem + L.reg);

  const int g = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = N / 16;
  const bool masked = mask != nullptr;
  const size_t C3 = 3 * (size_t)C;
  const int ldS = L.ldS, ldP = L.ldP;
  float* S = reinterpret_cast<float*>(smem + L.strip) + (size_t)warp * 16 * ldS;
  float* T = reinterpret_cast<float*>(smem + L.tile) + (size_t)warp * 16 * AB_LDT;
  const float* bh = rel_bias + (size_t)h * N * N;
  float* dbp = dbias_part + ((size_t)h * groups + g) * N * N;

  for (int i = tid; i < N * N; i += AT_THREADS) dbp[i] = 0.f;
  __syncthreads();

  const int w1 = min(windows, (g + 1) * per);
  for (int win = g * per; win < w1; ++win) {
    // gather q, k, v and dO of this head for the window's N tokens
    for (int idx = tid; idx < N * 16; idx += AT_THREADS) {
      const int t = idx >> 4, which = (idx >> 2) & 3, part = idx & 3;
      const size_t tok = map.row(win, t);
      const bf16* src = which < 3 ? qkv + tok * C3 + which * C + h * AT_D + part * 8
                                  : dout + tok * C + h * AT_D + part * 8;
      bf16* dst = (which == 0 ? Qs : which == 1 ? Ks : which == 2 ? Vs : dOs) + t * AT_LDQ +
                  part * 8;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    }
    const float* mw = nullptr;
    if (MASK == MASK_DENSE && masked)
      mw = static_cast<const float*>(mask) + (size_t)map.mask_win(win) * N * N;
    if (MASK == MASK_REGION && masked)
      for (int t = tid; t < N; t += AT_THREADS)
        reg[t] = static_cast<const int*>(mask)[(size_t)map.mask_win(win) * N + t];
    __syncthreads();

    // phase 1: 16-row strips of S, P, D, dS and dQ
    for (int st = warp; st < nt; st += AT_WARPS) {
      for (int j = 0; j < nt; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < AT_D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + st * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::load_matrix_sync(fb, Ks + j * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(S + j * 16, acc, ldS, wmma::mem_row_major);
      }
      __syncwarp();
      // softmax as in the forward: f32 P over the strip, bf16 P into Pf
      for (int rr = 0; rr < 16; ++rr) {
        const int r = st * 16 + rr;
        float* srow = S + rr * ldS;
        float e[AT_CPL];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < AT_CPL; ++u) {
          const int c = lane + 32 * u;
          float sc = -INFINITY;
          if (c < N) {
            sc = srow[c] * scale;
            if (masked) {
              if (MASK == MASK_REGION) {
                if (reg[r] != reg[c]) sc += -100.f;
              } else {
                sc += mw[(size_t)r * N + c];
              }
            }
            sc += bh[(size_t)r * N + c];
          }
          e[u] = sc;
          mx = fmaxf(mx, sc);
        }
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < AT_CPL; ++u) {
          e[u] = (lane + 32 * u < N) ? expf(e[u] - mx) : 0.f;
          sum += e[u];
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float inv = 1.f / sum;
#pragma unroll
        for (int u = 0; u < AT_CPL; ++u) {
          const int c = lane + 32 * u;
          if (c < N) {
            const float p = e[u] * inv;
            srow[c] = p;
            Pf[r * ldP + c] = __float2bfloat16(p);
          }
        }
      }
      __syncwarp();

      // O = P V for the strip, then D = rowsum(dO o O)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o2[2];
      wmma::fill_fragment(o2[0], 0.f);
      wmma::fill_fragment(o2[1], 0.f);
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Pf + st * 16 * ldP + kk, ldP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * AT_LDQ + j * 16, AT_LDQ);
          wmma::mma_sync(o2[j], fa, fb, o2[j]);
        }
      }
      wmma::store_matrix_sync(T, o2[0], AB_LDT, wmma::mem_row_major);
      wmma::store_matrix_sync(T + 16, o2[1], AB_LDT, wmma::mem_row_major);
      __syncwarp();
      {
        const int rr = lane >> 1, half = lane & 1;
        const bf16* dorow = dOs + (st * 16 + rr) * AT_LDQ + half * 16;
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) d += __bfloat162float(dorow[k]) * T[rr * AB_LDT + half * 16 + k];
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (!half) Dsm[st * 16 + rr] = d;
      }
      __syncwarp();

      // dS tile by tile: dP = dO V^T, dS = P (dP - D); into the bias
      // gradient partial (same thread for each element in every window)
      for (int j = 0; j < nt; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < AT_D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dOs + st * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::load_matrix_sync(fb, Vs + j * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(T, acc, AB_LDT, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4, cc = e & 15;
          const int r = st * 16 + rr, c = j * 16 + cc;
          const float ds = S[rr * ldS + c] * (T[rr * AB_LDT + cc] - Dsm[r]);
          dbp[(size_t)r * N + c] += ds;
          dSf[r * ldP + c] = __float2bfloat16(ds);
        }
        __syncwarp();
      }

      // dQ = dS K * scale
      wmma::fill_fragment(o2[0], 0.f);
      wmma::fill_fragment(o2[1], 0.f);
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, dSf + st * 16 * ldP + kk, ldP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Ks + kk * AT_LDQ + j * 16, AT_LDQ);
          wmma::mma_sync(o2[j], fa, fb, o2[j]);
        }
      }
      wmma::store_matrix_sync(T, o2[0], AB_LDT, wmma::mem_row_major);
      wmma::store_matrix_sync(T + 16, o2[1], AB_LDT, wmma::mem_row_major);
      __syncwarp();
      store_strip(T, scale, dqkv, C3, h * AT_D, st, map, win, lane);
      __syncwarp();
    }
    __syncthreads();

    // phase 2: 16-column strips of dV = P^T dO and dK = dS^T Q * scale
    for (int sj = warp; sj < nt; sj += AT_WARPS) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const bf16* Am = which == 0 ? Pf : dSf;
        const bf16* Bm = which == 0 ? dOs : Qs;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o2[2];
        wmma::fill_fragment(o2[0], 0.f);
        wmma::fill_fragment(o2[1], 0.f);
        for (int kk = 0; kk < N; kk += 16) {
          // element (j, i) of the transposed operand at Am[i][j]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::load_matrix_sync(fa, Am + kk * ldP + sj * 16, ldP);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, Bm + kk * AT_LDQ + j * 16, AT_LDQ);
            wmma::mma_sync(o2[j], fa, fb, o2[j]);
          }
        }
        wmma::store_matrix_sync(T, o2[0], AB_LDT, wmma::mem_row_major);
        wmma::store_matrix_sync(T + 16, o2[1], AB_LDT, wmma::mem_row_major);
        __syncwarp();
        if (which == 0)
          store_strip(T, 1.f, dqkv, C3, 2 * C + h * AT_D, sj, map, win, lane);
        else
          store_strip(T, scale, dqkv, C3, C + h * AT_D, sj, map, win, lane);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

// Launch the backward core over `windows` windows of N tokens, then reduce
// the partial into drel (heads, N, N) head by head. `part` holds
// attn_bwd_part_elems(windows, heads, N) floats. Returns the first CUDA
// error.
template <class Map, int MASK>
inline cudaError_t window_attn_bwd(const bf16* qkv, const bf16* dout, const float* rel_bias,
                                   const void* mask, bf16* dqkv, float* drel, float* part,
                                   Map map, int windows, int heads, int C, int N, float scale,
                                   cudaStream_t stream) {
  const AttnBwdSmem L(N);
  void (*kern)(const bf16*, const bf16*, const float*, const void*, bf16*, float*, Map, int, int,
               int, float, int, int) = window_attn_bwd_kernel<Map, MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const AttnBwdPlan plan = attn_bwd_plan(windows, heads);
  kern<<<dim3(plan.groups, heads), AT_THREADS, L.total, stream>>>(
      qkv, dout, rel_bias, mask, dqkv, part, map, windows, C, N, scale, plan.groups, plan.per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the partial layout is (heads, groups, N, N): reduce head by head
  for (int h = 0; h < heads; ++h)
    reduce_parts(part + (size_t)h * plan.groups * N * N, drel + (size_t)h * N * N, plan.groups,
                 (long long)N * N, stream);
  return cudaGetLastError();
}

}  // namespace pw
