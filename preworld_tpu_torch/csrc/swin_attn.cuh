// Window-attention core shared by K1 (swin_block.cu) and K5 / K6
// (window_attn.cu); their backward passes share swin_attn_bwd.cuh.
//
// One kernel computes softmax(q k^T d^-1/2 + mask + rel-bias) v per
// (window, head), templated on two things the callers differ in:
//   * an index map from (window, token) to the token's row in qkv (3C
//     wide) and in the output (C wide): ImageMap for the (B, Hp, Wp, .)
//     image layout, windows of the layout rolled by (-shift, -shift) (K1
//     reads its roll through the map; K6 takes qkv already rolled, shift
//     0), or PackedMap for windows packed as (Bn, N, .) (K5);
//   * a mask source: MASK_REGION, an (nW, N) region-id table (mask -100
//     where two tokens' ids differ, K1), or MASK_DENSE, an additive
//     (nW, N, N) f32 mask (K5, K6); a null pointer means no mask.
// Built for head dim AT_D = 32 (every Swin-T/S/B/L stage) and windows of
// N <= AT_MAXN tokens with N % 16 == 0; the wrappers raise on anything else.
#pragma once

#include "gemm.cuh"

namespace pw {

constexpr int AT_THREADS = 256;
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr int AT_D = 32;          // head dim of every Swin stage
constexpr int AT_LDQ = AT_D + 8;  // bf16 stride of q / k / v tiles
constexpr int AT_MAXN = 144;      // tokens per window, at most
constexpr int AT_CPL = (AT_MAXN + 31) / 32;  // score columns per lane

enum { MASK_REGION = 0, MASK_DENSE = 1 };

// Window win = b nH nW + wr nW + wc of the rolled image layout; token
// t = i ws + j sits at image position ((wr ws + i + shift) mod Hp,
// (wc ws + j + shift) mod Wp). Its mask is that of window wr nW + wc.
struct ImageMap {
  int Hp, Wp, ws, shift, nH, nW;
  __device__ __forceinline__ size_t row(int win, int t) const {
    const int b = win / (nH * nW);
    const int wr = (win / nW) % nH, wc = win % nW;
    const int r = (wr * ws + t / ws + shift) % Hp;
    const int c = (wc * ws + t % ws + shift) % Wp;
    return ((size_t)b * Hp + r) * Wp + c;
  }
  __device__ __forceinline__ int mask_win(int win) const { return win % (nH * nW); }
};

inline ImageMap image_map(int Hp, int Wp, int ws, int shift) {
  return {Hp, Wp, ws, shift, Hp / ws, Wp / ws};
}

// Token t of window win at row win N + t; its mask is mask[win mod nWm].
struct PackedMap {
  int N, nWm;
  __device__ __forceinline__ size_t row(int win, int t) const { return (size_t)win * N + t; }
  __device__ __forceinline__ int mask_win(int win) const { return win % nWm; }
};

// K1's first two kernels (swin_block.cu): the LN1 + pad-zeroing + qkv
// product into qkv (M, 3C), then window attention into o (M, C), both bf16
// in image order. Returns the first launch error.
cudaError_t attn_qkv_o(const bf16* x, const float* ln_w, const float* ln_b,
                       const bf16* wqkv, const float* bqkv, const float* rel_bias,
                       const int* region, bf16* qkv, bf16* o, int B, int Hp, int Wp, int C,
                       int heads, int ws, int H, int W, int shift, float scale,
                       cudaStream_t stream);

struct AttnSmem {
  int N, ldS;
  size_t q, k, v, strip, reg, total;
  __host__ __device__ AttnSmem(int n) : N(n) {
    // f32 stride of a warp's 16-row strip: N scores, later the bf16
    // probabilities in place (stride 2 * ldS), then the 16 x AT_D output
    ldS = (n > AT_D ? n : AT_D) + 4;
    q = 0;
    k = q + (size_t)n * AT_LDQ * 2;
    v = k + (size_t)n * AT_LDQ * 2;
    strip = (v + (size_t)n * AT_LDQ * 2 + 127) / 128 * 128;
    reg = strip + (size_t)AT_WARPS * 16 * ldS * 4;
    total = reg + (size_t)n * 4;
  }
};

// One block per (window, head) with q, k, v of the window's N tokens in
// shared memory; each warp takes 16-row strips of the window: scores q.k^T
// on tensor cores (wmma) into the warp's own f32 strip, the softmax of
// scale q.k^T + mask + relative-position bias in f32, the probabilities
// rounded to bf16 (like the TPU kernels) in place over the strip, then p.v
// on tensor cores; reads qkv and writes out through the index map, so no
// window partition / reverse copies exist.
template <class Map, int MASK>
__global__ void __launch_bounds__(AT_THREADS, 2)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel_bias,
                   const void* __restrict__ mask, bf16* __restrict__ out, Map map, int C,
                   int N, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem L(N);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  int* reg = reinterpret_cast<int*>(smem + L.reg);

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = N / 16;
  const bool masked = mask != nullptr;
  const float* mw = nullptr;
  if (MASK == MASK_DENSE && masked)
    mw = static_cast<const float*>(mask) + (size_t)map.mask_win(win) * N * N;

  // gather this head's q, k, v for the window's N tokens (4 x 16 B each)
  for (int idx = tid; idx < N * 3 * 4; idx += AT_THREADS) {
    int t = idx / 12, rem = idx % 12, which = rem / 4, part = rem % 4;
    const bf16* src = qkv + map.row(win, t) * (3 * C) + which * C + h * AT_D + part * 8;
    bf16* dst = (which == 0 ? Qs : which == 1 ? Ks : Vs) + t * AT_LDQ + part * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
  if (MASK == MASK_REGION && masked)
    for (int t = tid; t < N; t += AT_THREADS)
      reg[t] = static_cast<const int*>(mask)[(size_t)map.mask_win(win) * N + t];
  __syncthreads();

  float* S = reinterpret_cast<float*>(smem + L.strip) + (size_t)warp * 16 * L.ldS;
  bf16* P = reinterpret_cast<bf16*>(S);
  const int ldP = 2 * L.ldS;
  const float* bh = rel_bias + (size_t)h * N * N;
  for (int st = warp; st < nt; st += AT_WARPS) {
    // scores of rows [16 st, 16 st + 16): q . k^T
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
      wmma::store_matrix_sync(S + j * 16, acc, L.ldS, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax per row in f32: s*scale + mask, + bias, max, exp, normalise;
    // the bf16 probabilities overwrite the row's first 2N bytes once every
    // lane holds its scores in registers
    for (int rr = 0; rr < 16; ++rr) {
      const int r = st * 16 + rr;
      const float* srow = S + rr * L.ldS;
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
      __syncwarp();
      bf16* prow = P + rr * ldP;
#pragma unroll
      for (int u = 0; u < AT_CPL; ++u) {
        const int c = lane + 32 * u;
        if (c < N) prow[c] = __float2bfloat16(e[u] * inv);
      }
    }
    __syncwarp();

    // o = p . v for the strip (16 x AT_D), then into the strip as f32
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[2];
    wmma::fill_fragment(o[0], 0.f);
    wmma::fill_fragment(o[1], 0.f);
    for (int kk = 0; kk < N; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, P + kk, ldP);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Vs + kk * AT_LDQ + j * 16, AT_LDQ);
        wmma::mma_sync(o[j], fa, fb, o[j]);
      }
    }
    __syncwarp();
    wmma::store_matrix_sync(S, o[0], L.ldS, wmma::mem_row_major);
    wmma::store_matrix_sync(S + 16, o[1], L.ldS, wmma::mem_row_major);
    __syncwarp();

    // 16 tokens x 4 chunks of 8 channels, through the index map
    for (int idx = lane; idx < 64; idx += 32) {
      const int rr = idx >> 2, part = idx & 3;
      const int t = st * 16 + rr;
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o8[j] = __float2bfloat16(S[rr * L.ldS + part * 8 + j]);
      *reinterpret_cast<uint4*>(out + map.row(win, t) * C + h * AT_D + part * 8) =
          *reinterpret_cast<const uint4*>(o8);
    }
    __syncwarp();
  }
}

// Launch the forward core over `windows` windows and `heads` heads of
// N tokens; `mask` is an int region table (MASK_REGION), an f32 (nW, N, N)
// mask (MASK_DENSE) or null. Returns the first CUDA error.
template <class Map, int MASK>
inline cudaError_t window_attn(const bf16* qkv, const float* rel_bias, const void* mask,
                               bf16* out, Map map, int windows, int heads, int C, int N,
                               float scale, cudaStream_t stream) {
  const AttnSmem L(N);
  void (*kern)(const bf16*, const float*, const void*, bf16*, Map, int, int, float) =
      window_attn_kernel<Map, MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kern<<<dim3(windows, heads), AT_THREADS, L.total, stream>>>(qkv, rel_bias, mask, out, map, C,
                                                               N, scale);
  return cudaGetLastError();
}

}  // namespace pw
