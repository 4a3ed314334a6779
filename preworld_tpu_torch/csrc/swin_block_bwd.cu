// K1b: backward of the Swin attention half-block (K1, swin_block.cu).
//
// Replaces preworld_tpu/ops/swin_block_pallas.py::_fused_swin_attn_block_bwd
// (the pallas_call of _blk_bwd_kernel, tied to the forward by
// fused_swin_attn_block_vjp). For out = x + rs * proj(WMSA(zeropad(LN1(x))))
// and a cotangent dY it gives dx (bf16) and, in f32, d ln (2, C), dWqkv
// (3C, C), dbqkv, dWproj (C, C), dbproj and d rel-bias (heads, N, N). The
// TPU kernel walks bands in an ordered grid and carries every weight
// gradient in VMEM from step to step; on Hopper the blocks run unordered,
// so the backward is a chain of launches, each sum over tokens split into
// fixed chunks and reduced in a fixed order (no float atomics: two runs
// give identical bits):
//   1. per-row LN1 statistics (rstd 0 marks a zeroed pad token), as K1's
//      forward computes them;
//   2. recompute qkv and the attention output o with K1's own kernels
//      (attn_qkv_o: the qkv product on the TMA + wgmma pipeline of
//      gemm_sm90.cuh from the step-1 statistics, so qkv has the
//      forward's bits, then the window-attention forward core);
//   3. dyb = bf16(rs * dY) and dbproj = column sums of rs * dY, one pass
//      over dY (colsum_rows);
//   4. dWproj = dyb^T o (gemm_dw_sm90: split-M weight gradient, both
//      operands MN-major);
//   5. dO = dyb . Wproj (gemm_sm90 with Wproj as stored, an MN-major B)
//      into o's buffer;
//   6. window-attention backward, the core of swin_attn_bwd.cuh on the
//      forward's image-layout map with the roll and the region-id mask:
//      dq, dk, dv to dqkv (M, 3C) in image order, and d rel-bias reduced
//      over groups of windows in a fixed order;
//   7. dbqkv = column sums of dqkv (colsum_rows); dWqkv = dqkv^T LN1(x)
//      (gemm_dw_sm90, LN on the register operand from the step-1
//      statistics);
//   8. dyln = dqkv . Wqkv (gemm_sm90, MN-major B, f32 out) into qkv's
//      buffer;
//   9. LN1 backward with the pad-token mask, plus the residual:
//      dx = dY + LN^T(dyln * ok), and d ln by per-block partials.
// The shift stays in indexing, as in the forward: no rolled copy exists.
//
// Bound on H100: the products (2 x 4 C^2 + 2 x 2 C^2 FLOP per token, the
// qkv recompute included) against 2 C to 8 C bytes a row each: bound by
// bytes at Swin-B's C = 128 / 256, by operations at C >= 512. All five run
// on the TMA + wgmma pipeline of gemm_sm90.cuh (persistent grid, the
// weight gradients split over M on it); the column sums read dY and dqkv
// once each at 16 bytes a thread. The attention backward (step 6) is the
// Hopper core of swin_attn_bwd.cuh, bound by the bytes of qkv, dO and dqkv: mma.sync
// products, one warp per 16-row strip, the next window's loads in flight,
// the d-bias partial on chip for the block's windows.
#include "gemm_sm90.cuh"
#include "swin_attn_bwd.cuh"

namespace pw {

inline long long block_bwd_part_elems(int B, int Hp, int Wp, int C, int heads, int ws) {
  const int M = B * Hp * Wp;
  const long long cand[6] = {attn_bwd_part_elems(B * (Hp / ws) * (Wp / ws), heads, ws * ws),
                             (long long)colsum_splits(M, C, sm_count()) * C,
                             (long long)colsum_splits(M, 3 * C, sm_count()) * 3 * C,
                             dw_part_elems(M, C, C, false), dw_part_elems(M, 3 * C, C, true),
                             (long long)ln_bwd_splits(M) * 2 * C};
  long long n = 0;
  for (long long c : cand) n = c > n ? c : n;
  return n;
}

}  // namespace pw

using pw::bf16;

// f32 elements of the `part` scratch that pw_swin_attn_block_bwd needs.
extern "C" long long pw_swin_attn_block_bwd_part_elems(int B, int Hp, int Wp, int C,
                                                       int heads, int ws) {
  return pw::block_bwd_part_elems(B, Hp, Wp, C, heads, ws);
}

// All pointers are device pointers on `stream`. Scratch from the caller:
// qkv_buf (M, 3C) and dqkv_buf (M, 3C) bf16, o_buf and dyb_buf (M, C)
// bf16, stats (M, 2) f32, part (pw_swin_attn_block_bwd_part_elems) f32.
// Outputs: dx (M, C) bf16; dln (2, C), dwqkv (3C, C), dbqkv (3C), dwproj
// (C, C), dbproj (C), drel (heads, N, N) f32. Returns the first CUDA
// error, else 0.
extern "C" int pw_swin_attn_block_bwd(
    const void* x, const float* ln_w, const float* ln_b, const void* wqkv, const float* bqkv,
    const void* wproj, const float* rel_bias, const int* region, const float* row_scale,
    const void* dy, void* dx, float* dln, float* dwqkv, float* dbqkv, float* dwproj,
    float* dbproj, float* drel, void* qkv_buf, void* o_buf, void* dyb_buf, void* dqkv_buf,
    float* stats, float* part, int B, int Hp, int Wp, int C, int heads, int ws, int H, int W,
    int shift, float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = B * Hp * Wp, N = ws * ws;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyv = static_cast<const bf16*>(dy);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* o = static_cast<bf16*>(o_buf);
  bf16* dyb = static_cast<bf16*>(dyb_buf);
  bf16* dqkv = static_cast<bf16*>(dqkv_buf);
  cudaError_t err;
#define PW_CHECK()                                             \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  if ((err = pw::ln_stats(xb, stats, M, C, 1, Hp, Wp, H, W, stream)) != cudaSuccess)
    return (int)err;
  err = pw::attn_qkv_o(xb, stats, ln_w, ln_b, static_cast<const bf16*>(wqkv), bqkv, rel_bias,
                       region, qkv, o, B, Hp, Wp, C, heads, ws, H, W, shift, scale, stream);
  if (err != cudaSuccess) return (int)err;

  // proj: dyb and dbproj in one pass over dY, dWproj, then dO into o's
  // buffer
  const int sms = pw::sm_count();
  pw::colsum_rows(dyv, row_scale, Hp * Wp, dyb, part, dbproj, M, C, sms, stream);
  PW_CHECK();
  pw::DwArgs d{};
  d.A = dyb; d.B = o; d.part = part; d.M = M; d.N = C; d.K = C;
  if ((err = pw::gemm_dw_sm90<pw::PRO_NONE>(d, dwproj, stream)) != cudaSuccess) return (int)err;
  const pw::Sm90Args g = pw::sm90_args(M, C, C, nullptr);
  err = pw::gemm_sm90<pw::PRO_NONE, pw::EPI_BIAS, true>(dyb, static_cast<const bf16*>(wproj), o,
                                                        nullptr, g, stream);
  if (err != cudaSuccess) return (int)err;

  // window attention backward -> dqkv, d rel-bias
  err = pw::window_attn_bwd<pw::ImageMap, pw::MASK_REGION>(
      qkv, o, rel_bias, region, dqkv, drel, part, pw::image_map(Hp, Wp, ws, shift),
      B * (Hp / ws) * (Wp / ws), heads, C, N, scale, stream);
  if (err != cudaSuccess) return (int)err;

  // qkv: dbqkv, dWqkv (LN1 on the fly), dyln = dqkv . Wqkv into qkv's buffer
  pw::colsum_rows(dqkv, nullptr, 1, nullptr, part, dbqkv, M, 3 * C, sms, stream);
  PW_CHECK();
  pw::DwArgs q{};
  q.A = dqkv; q.B = xb; q.part = part; q.M = M; q.N = 3 * C; q.K = C;
  q.stats = stats; q.ln_w = ln_w; q.ln_b = ln_b;
  if ((err = pw::gemm_dw_sm90<pw::PRO_LN>(q, dwqkv, stream)) != cudaSuccess) return (int)err;
  float* dyln = reinterpret_cast<float*>(qkv_buf);
  pw::Sm90Args y = pw::sm90_args(M, C, 3 * C, nullptr);
  y.out_f32 = dyln;
  err = pw::gemm_sm90<pw::PRO_NONE, pw::EPI_F32, true>(dqkv, static_cast<const bf16*>(wqkv),
                                                       nullptr, nullptr, y, stream);
  if (err != cudaSuccess) return (int)err;

  // LN1 backward (pad tokens masked) + residual
  err = pw::ln_bwd(xb, stats, ln_w, dyln, dyv, static_cast<bf16*>(dx), part, dln, M, C, 1, Hp,
                   Wp, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  PW_CHECK();
#undef PW_CHECK
  return 0;
}
