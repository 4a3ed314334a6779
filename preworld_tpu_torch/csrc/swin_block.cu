// K1: Swin attention half-block on the padded (B, Hp, Wp, C) layout.
//
// Replaces preworld_tpu/ops/swin_block_pallas.py::fused_swin_attn_block
// (the forward pallas_call), which computes
//     out = x + rs * proj(WMSA(zeropad(LN1(x))))
// on the padded layout, rolled by (-shift, -shift) for a shifted block. Here
// x and out stay in image order and the roll lives in the window kernel's
// indexing, so a shifted block needs no roll copies. A chain of three
// kernels:
//   1. LN1 + pad-zeroing + qkv product (gemm.cuh, PRO_LN / EPI_BIAS):
//      (M, C) -> qkv (M, 3C) bf16, M = B*Hp*Wp in image order;
//   2. window attention: one block per (image, window, head) with q, k, v
//      of the window's N tokens in shared memory (window (wr, wc) of the
//      rolled layout: token (i, j) at image position
//      ((wr ws + i + shift) mod Hp, (wc ws + j + shift) mod Wp)); each warp
//      takes 16-row
//      strips of the window: scores q.k^T on tensor cores (wmma) into the
//      warp's own f32 strip, the softmax of scale*q.k^T + shift mask +
//      relative-position bias in f32, the probabilities rounded to bf16
//      (like the TPU kernel) in place over the strip, then p.v on tensor
//      cores; reads qkv and writes o (M, C) straight in image order, so no
//      window partition / reverse copies exist;
//   3. proj product with a bias + row-scale + residual epilogue
//      (gemm.cuh, EPI_RESID).
// The shift mask is rebuilt in-kernel from the (nH*nW, N) region-id table
// (mask = -100 where ids differ), instead of reading an (nW, N, N) f32 mask.
//
// Bound on H100: the two products are compute-bound; the attention step
// is latency-bound (N = 144 tokens per window, d = 32): per-warp strips
// keep it free of block-wide barriers after the q/k/v gather, and at
// 111 KB of shared memory two blocks share an SM. qkv and o round-trip
// device memory between the kernels, about 5x the read-x / write-out
// floor. Folding the chain into one kernel is later work.
#include "swin_attn.cuh"

namespace pw {

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

__global__ void __launch_bounds__(AT_THREADS, 2)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel_bias,
                   const int* __restrict__ region, bf16* __restrict__ out,
                   int Hp, int Wp, int C, int ws, int shift, float scale) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = ws * ws;
  const AttnSmem L(N);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  int* reg = reinterpret_cast<int*>(smem + L.reg);

  const int nW = Wp / ws, nH = Hp / ws;
  const int win = blockIdx.x;           // b * nH * nW + wr * nW + wc
  const int h = blockIdx.y;             // head
  const int b = win / (nH * nW);
  const int wr = (win / nW) % nH, wc = win % nW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = N / 16;
  const bool masked = region != nullptr;

  // gather this head's q, k, v for the window's N tokens (4 x 16 B each)
  for (int idx = tid; idx < N * 3 * 4; idx += AT_THREADS) {
    int t = idx / 12, rem = idx % 12, which = rem / 4, part = rem % 4;
    int row = (wr * ws + t / ws + shift) % Hp, col = (wc * ws + t % ws + shift) % Wp;
    const bf16* src = qkv + (((size_t)b * Hp + row) * Wp + col) * (3 * C)
                      + which * C + h * AT_D + part * 8;
    bf16* dst = (which == 0 ? Qs : which == 1 ? Ks : Vs) + t * AT_LDQ + part * 8;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  }
  if (masked)
    for (int t = tid; t < N; t += AT_THREADS) reg[t] = region[(size_t)(win % (nH * nW)) * N + t];
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
          if (masked && reg[r] != reg[c]) sc += -100.f;
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

    // 16 tokens x 4 chunks of 8 channels, in image order
    for (int idx = lane; idx < 64; idx += 32) {
      const int rr = idx >> 2, part = idx & 3;
      const int t = st * 16 + rr;
      const int row = (wr * ws + t / ws + shift) % Hp;
      const int col = (wc * ws + t % ws + shift) % Wp;
      __align__(16) bf16 o8[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o8[j] = __float2bfloat16(S[rr * L.ldS + part * 8 + j]);
      *reinterpret_cast<uint4*>(out + (((size_t)b * Hp + row) * Wp + col) * C + h * AT_D + part * 8) =
          *reinterpret_cast<const uint4*>(o8);
    }
    __syncwarp();
  }
}

cudaError_t attn_qkv_o(const bf16* x, const float* ln_w, const float* ln_b,
                       const bf16* wqkv, const float* bqkv, const float* rel_bias,
                       const int* region, bf16* qkv, bf16* o, int B, int Hp, int Wp, int C,
                       int heads, int ws, int H, int W, int shift, float scale,
                       cudaStream_t stream) {
  const int M = B * Hp * Wp;
  cudaError_t err;
  GemmArgs a = gemm_args(x, wqkv, bqkv, qkv, M, 3 * C, C);
  a.ln_w = ln_w; a.ln_b = ln_b;
  a.pad_mask = 1; a.Hp = Hp; a.Wp = Wp; a.Hv = H; a.Wv = W;
  gemm_bf16<PRO_LN, EPI_BIAS>(a, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const AttnSmem L(ws * ws);
  err = cudaFuncSetAttribute(window_attn_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(window_attn_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 blocks(B * (Hp / ws) * (Wp / ws), heads);
  window_attn_kernel<<<blocks, AT_THREADS, L.total, stream>>>(
      qkv, rel_bias, region, o, Hp, Wp, C, ws, shift, scale);
  return cudaGetLastError();
}

}  // namespace pw

using pw::bf16;

// All pointers are device pointers on `stream`. qkv_buf (M, 3C) and
// o_buf (M, C) are scratch from the caller. Returns the first
// cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int pw_swin_attn_block(
    const void* x, const float* ln_w, const float* ln_b,
    const void* wqkv, const float* bqkv, const void* wproj, const float* bproj,
    const float* rel_bias, const int* region, const float* row_scale,
    void* qkv_buf, void* o_buf, void* out,
    int B, int Hp, int Wp, int C, int heads, int ws, int H, int W, int shift,
    float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = B * Hp * Wp;
  cudaError_t err = pw::attn_qkv_o(
      static_cast<const bf16*>(x), ln_w, ln_b, static_cast<const bf16*>(wqkv), bqkv,
      rel_bias, region, static_cast<bf16*>(qkv_buf), static_cast<bf16*>(o_buf), B, Hp, Wp,
      C, heads, ws, H, W, shift, scale, stream);
  if (err != cudaSuccess) return (int)err;

  pw::GemmArgs p = pw::gemm_args(static_cast<const bf16*>(o_buf), static_cast<const bf16*>(wproj),
                                 bproj, static_cast<bf16*>(out), M, C, C);
  p.resid = static_cast<const bf16*>(x);
  p.row_scale = row_scale;
  p.rs_div = Hp * Wp;
  pw::gemm_bf16<pw::PRO_NONE, pw::EPI_RESID>(p, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
