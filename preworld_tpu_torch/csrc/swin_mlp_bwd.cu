// K2b: backward of the Swin MLP half-block (K2, swin_mlp.cu).
//
// Replaces preworld_tpu/ops/swin_mlp_pallas.py::_fused_swin_mlp_bwd_call
// (the pallas_call of _mlp_bwd_kernel, tied to the forward by
// fused_swin_mlp_vjp). For out = x + rs * (fc2(GELU(fc1(LN2(x)))) + b2) and
// a cotangent dY: dx (bf16) and, in f32, d ln (2, C), dW1 (4C, C), db1,
// dW2 (C, 4C), db2. The TPU kernel recomputes per row block in VMEM and
// carries the weight gradients across its ordered grid; here a chain of
// launches on the shared GEMMs, every sum over rows split into fixed
// chunks and reduced in a fixed order (identical bits run to run):
//   1. per-row LN2 statistics (ln_stats, as K2's forward);
//   2. recompute hpre = LN2(x) W1^T + b1 and h = GELU(hpre) (bf16, as the
//      forward rounds it): K2's fc1 on the TMA + wgmma pipeline of
//      gemm_sm90.cuh (EPI_BIAS_GELU_SAVE), so h has the forward's bits;
//      its epilogue also keeps GELU'(hpre) in f32, where the erf is at
//      hand;
//   3. dyb = bf16(rs * dY) and db2 = column sums of rs * dY, one pass over
//      dY (colsum_rows);
//   4. dW2 = dyb^T h (gemm_dw_sm90: split-M weight gradient, both operands
//      MN-major);
//   5. dhpre = (dyb . W2) o GELU'(hpre) (gemm_sm90 with W2 as stored, an
//      MN-major B, EPI_MUL_AUX), bf16 into h's buffer, with db1 from the
//      epilogue's f32 column sums (one partial row per block and
//      warpgroup);
//   6. dW1 = dhpre^T LN2(x) (gemm_dw_sm90, LN on the register operand from
//      the step-1 statistics);
//   7. dn = dhpre . W1 (gemm_sm90, MN-major B, f32 out) into hpre's buffer;
//   8. LN2 backward plus the residual: dx = dY + LN^T(dn) -- the residual
//      takes the raw dY, the branch rs * dY (swin_mlp_pallas.py:170-172).
//
// Bound on H100: five products of 2 C 4C FLOP per row (the fc1 recompute
// included), bound by operations at Swin-B's C >= 512 and near the line
// below; all five run on the TMA + wgmma pipeline of gemm_sm90.cuh, and
// dhpre's epilogue reads the f32 GELU'(hpre) (16 C bytes a row, its
// largest stream) that the recompute wrote beside h. The 4C hidden goes
// through device memory three times (h and GELU'(hpre) written, read
// back), where the TPU kernel kept it in VMEM.
#include "gemm_sm90.cuh"

using pw::bf16;

extern "C" long long pw_swin_mlp_bwd_part_elems(int M, int C, int Hd) {
  const long long cand[5] = {
      (long long)pw::colsum_splits(M, C, pw::sm_count()) * C,
      (long long)pw::mul_aux_rows(M, Hd) * Hd, pw::dw_part_elems(M, C, Hd, false),
      pw::dw_part_elems(M, Hd, C, true), (long long)pw::ln_bwd_splits(M) * 2 * C};
  long long n = 0;
  for (long long c : cand) n = c > n ? c : n;
  return n;
}

// All pointers are device pointers on `stream`. Scratch from the caller:
// h_buf (M, Hd) bf16, hpre_buf (M, Hd) f32 (GELU'(hpre), then dn), dyb_buf
// (M, C) bf16, stats (M, 2) f32, part (pw_swin_mlp_bwd_part_elems) f32.
// Outputs: dx (M, C) bf16; dln (2, C), dw1 (Hd, C), db1 (Hd), dw2 (C, Hd), db2 (C) f32.
// Returns the first CUDA error, else 0.
extern "C" int pw_swin_mlp_bwd(
    const void* x, const float* ln_w, const float* ln_b, const void* w1, const float* b1,
    const void* w2, const float* row_scale, const void* dy, void* dx, float* dln, float* dw1,
    float* db1, float* dw2, float* db2, void* h_buf, float* hpre_buf, void* dyb_buf,
    float* stats, float* part, int M, int C, int Hd, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyv = static_cast<const bf16*>(dy);
  bf16* h = static_cast<bf16*>(h_buf);
  bf16* dyb = static_cast<bf16*>(dyb_buf);
  cudaError_t err;
#define PW_CHECK()                                             \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  if ((err = pw::ln_stats(xb, stats, M, C, 0, 1, 1, 1, 1, stream)) != cudaSuccess)
    return (int)err;
  pw::Sm90Args f = pw::sm90_args(M, Hd, C, b1);
  f.stats = stats; f.ln_w = ln_w; f.ln_b = ln_b; f.out_f32 = hpre_buf;
  err = pw::gemm_sm90<pw::PRO_LN, pw::EPI_BIAS_GELU_SAVE>(xb, static_cast<const bf16*>(w1), h,
                                                          nullptr, f, stream);
  if (err != cudaSuccess) return (int)err;

  pw::colsum_rows(dyv, row_scale, 1, dyb, part, db2, M, C, pw::sm_count(), stream);
  PW_CHECK();
  pw::DwArgs d2{};
  d2.A = dyb; d2.B = h; d2.part = part; d2.M = M; d2.N = C; d2.K = Hd;
  if ((err = pw::gemm_dw_sm90<pw::PRO_NONE>(d2, dw2, stream)) != cudaSuccess) return (int)err;

  // dhpre over h's buffer (h is read by nothing after dW2)
  pw::Sm90Args g = pw::sm90_args(M, Hd, C, nullptr);
  g.aux = hpre_buf;
  g.col_part = part;
  err = pw::gemm_sm90<pw::PRO_NONE, pw::EPI_MUL_AUX, true>(dyb, static_cast<const bf16*>(w2),
                                                             h, nullptr, g, stream);
  if (err != cudaSuccess) return (int)err;
  pw::reduce_splits(part, db1, pw::mul_aux_rows(M, Hd), Hd, stream);
  PW_CHECK();

  pw::DwArgs d1{};
  d1.A = h; d1.B = xb; d1.part = part; d1.M = M; d1.N = Hd; d1.K = C;
  d1.stats = stats; d1.ln_w = ln_w; d1.ln_b = ln_b;
  if ((err = pw::gemm_dw_sm90<pw::PRO_LN>(d1, dw1, stream)) != cudaSuccess) return (int)err;

  // dn over hpre's buffer (M x C f32 fits in M x Hd f32)
  pw::Sm90Args n = pw::sm90_args(M, C, Hd, nullptr);
  n.out_f32 = hpre_buf;
  err = pw::gemm_sm90<pw::PRO_NONE, pw::EPI_F32, true>(h, static_cast<const bf16*>(w1), nullptr,
                                                       nullptr, n, stream);
  if (err != cudaSuccess) return (int)err;

  err = pw::ln_bwd(xb, stats, ln_w, hpre_buf, dyv, static_cast<bf16*>(dx), part, dln, M, C, 0,
                   1, 1, 1, 1, stream);
  if (err != cudaSuccess) return (int)err;
  PW_CHECK();
#undef PW_CHECK
  return 0;
}
