// K1: Swin attention half-block on the padded (B, Hp, Wp, C) layout.
//
// Replaces preworld_tpu/ops/swin_block_pallas.py::fused_swin_attn_block
// (the forward pallas_call), which computes
//     out = x + rs * proj(WMSA(zeropad(LN1(x))))
// on the padded layout, rolled by (-shift, -shift) for a shifted block. Here
// x and out stay in image order and the roll lives in the window kernel's
// indexing, so a shifted block needs no roll copies. A chain of four
// kernels:
//   1. per-row LN1 statistics (gemm.cuh, ln_stats: one warp a row, 8 bytes
//      a row out; rstd = 0 marks a pad token), computed once per row
//      rather than once per output column tile;
//   2. LN1 + pad-zeroing + qkv product (gemm_sm90.cuh, PRO_LN / EPI_BIAS):
//      the raw x tile by TMA, normalised in the wgmma A fragments,
//      (M, C) -> qkv (M, 3C) bf16, M = B*Hp*Wp in image order;
//   3. window attention, the forward core of swin_attn.cuh on the
//      image-layout map with the roll (window (wr, wc) of the rolled
//      layout: token (i, j) at image position ((wr ws + i + shift) mod Hp,
//      (wc ws + j + shift) mod Wp)) and the region-id mask (MASK_NONE at
//      shift 0): one block per (head, group of windows), one warp per
//      16-row query strip, scores and probabilities in mma.sync registers,
//      the next window's q, k, v fetched with cp.async; it reads qkv and
//      writes o (M, C) straight in image order, so no window partition /
//      reverse copies exist;
//   4. proj product with a bias + row-scale + residual epilogue
//      (gemm_sm90.cuh, EPI_RESID; the residual tile comes in by TMA).
// The shift mask is rebuilt in-kernel from the (nH*nW, N) region-id table
// (mask = -100 where ids differ), instead of reading an (nW, N, N) f32 mask.
//
// Bound on H100: at Swin-B's C = 128 / 256 (stages 0-1) the two products
// are bound by bytes (2 (C + 3C) and 2 (3 C) bytes a row against 8 C^2
// FLOP), at C = 512 / 1024 by operations; both run on the TMA + wgmma
// pipeline. The attention step is bound by the bytes of qkv and o (4 N d
// bf16 per window and head against 4 N^2 d FLOP). qkv and o round-trip
// device memory between the kernels, about 5x the read-x / write-out
// floor. Folding the chain into one kernel is later work.
#include "gemm_sm90.cuh"
#include "swin_attn.cuh"

namespace pw {

cudaError_t attn_qkv_o(const bf16* x, const float* stats, const float* ln_w, const float* ln_b,
                       const bf16* wqkv, const float* bqkv, const float* rel_bias,
                       const int* region, bf16* qkv, bf16* o, int B, int Hp, int Wp, int C,
                       int heads, int ws, int H, int W, int shift, float scale,
                       cudaStream_t stream) {
  const int M = B * Hp * Wp;
  Sm90Args a = sm90_args(M, 3 * C, C, bqkv);
  a.stats = stats; a.ln_w = ln_w; a.ln_b = ln_b;
  cudaError_t err = gemm_sm90<PRO_LN, EPI_BIAS>(x, wqkv, qkv, nullptr, a, stream);
  if (err != cudaSuccess) return err;

  return window_attn<ImageMap, MASK_REGION>(qkv, rel_bias, region, o,
                                            image_map(Hp, Wp, ws, shift),
                                            B * (Hp / ws) * (Wp / ws), heads, C, ws * ws,
                                            scale, stream);
}

}  // namespace pw

using pw::bf16;

// All pointers are device pointers on `stream`. stats (M, 2) f32,
// qkv_buf (M, 3C) and o_buf (M, C) bf16 are scratch from the caller.
// Returns the first CUDA error that is not cudaSuccess, else 0.
extern "C" int pw_swin_attn_block(
    const void* x, const float* ln_w, const float* ln_b,
    const void* wqkv, const float* bqkv, const void* wproj, const float* bproj,
    const float* rel_bias, const int* region, const float* row_scale,
    float* stats, void* qkv_buf, void* o_buf, void* out,
    int B, int Hp, int Wp, int C, int heads, int ws, int H, int W, int shift,
    float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = B * Hp * Wp;
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err = pw::ln_stats(xb, stats, M, C, 1, Hp, Wp, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  err = pw::attn_qkv_o(xb, stats, ln_w, ln_b, static_cast<const bf16*>(wqkv), bqkv, rel_bias,
                       region, static_cast<bf16*>(qkv_buf), static_cast<bf16*>(o_buf), B, Hp,
                       Wp, C, heads, ws, H, W, shift, scale, stream);
  if (err != cudaSuccess) return (int)err;

  pw::Sm90Args p = pw::sm90_args(M, C, C, bproj);
  p.row_scale = row_scale;
  p.rs_div = Hp * Wp;
  err = pw::gemm_sm90<pw::PRO_NONE, pw::EPI_RESID>(static_cast<const bf16*>(o_buf),
                                                   static_cast<const bf16*>(wproj),
                                                   static_cast<bf16*>(out), xb, p, stream);
  return (int)err;
}
