// K2: Swin MLP half-block, out = x + rs * (fc2(GELU(fc1(LN2(x)))) + b2).
//
// Replaces preworld_tpu/ops/swin_mlp_pallas.py::fused_swin_mlp (the
// forward pallas_call). Three launches:
//   1. per-row LN2 statistics (gemm.cuh, ln_stats), once per row;
//   2. LN2 prologue + fc1 + bias + exact-erf GELU (gemm_sm90.cuh, PRO_LN /
//      EPI_BIAS_GELU; erff: the Pallas kernel's polynomial erf was a TPU
//      lowering workaround) -> hidden (M, 4C) bf16;
//   3. fc2 + bias, times the per-row scale, plus the residual x
//      (gemm_sm90.cuh, EPI_RESID).
// The LN output stays on chip, in the wgmma A fragments; the 4C hidden
// goes through a device scratch buffer from the caller (the TPU kernel
// kept it in VMEM).
//
// Bound on H100: 2 * 4C^2 FLOP a row for each product against 2 (C + 4C)
// bytes a row (fc1) and 2 (4C + 2C) (fc2): bound by bytes at Swin-B's C =
// 128 / 256, by operations at C = 512 / 1024. Both products run on the TMA
// + wgmma pipeline; the hidden's round trip (16 C bytes a row) is what a
// fused fc1 -> fc2 with the hidden on chip would save, later work.
#include "gemm_sm90.cuh"

using pw::bf16;

// stats (M, 2) f32 and hidden_buf (M, Hd) bf16 are scratch from the
// caller. Returns the first CUDA error that is not cudaSuccess, else 0.
extern "C" int pw_swin_mlp(
    const void* x, const float* ln_w, const float* ln_b,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const float* row_scale, float* stats, void* hidden_buf, void* out,
    int M, int C, int Hd, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hidden = static_cast<bf16*>(hidden_buf);
  cudaError_t err = pw::ln_stats(xb, stats, M, C, 0, 1, 1, 1, 1, stream);
  if (err != cudaSuccess) return (int)err;

  pw::Sm90Args a = pw::sm90_args(M, Hd, C, b1);
  a.stats = stats; a.ln_w = ln_w; a.ln_b = ln_b;
  err = pw::gemm_sm90<pw::PRO_LN, pw::EPI_BIAS_GELU>(xb, static_cast<const bf16*>(w1), hidden,
                                                     nullptr, a, stream);
  if (err != cudaSuccess) return (int)err;

  pw::Sm90Args f = pw::sm90_args(M, C, Hd, b2);
  f.row_scale = row_scale;
  f.rs_div = 1;
  err = pw::gemm_sm90<pw::PRO_NONE, pw::EPI_RESID>(hidden, static_cast<const bf16*>(w2),
                                                   static_cast<bf16*>(out), xb, f, stream);
  return (int)err;
}
