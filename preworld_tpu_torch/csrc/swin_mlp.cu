// K2: Swin MLP half-block, out = x + rs * (fc2(GELU(fc1(LN2(x)))) + b2).
//
// Replaces preworld_tpu/ops/swin_mlp_pallas.py::fused_swin_mlp (the
// forward pallas_call). Two launches of the shared GEMM (gemm.cuh):
//   1. LN2 prologue + fc1 + bias + exact-erf GELU (erff; the Pallas kernel's
//      polynomial erf was a TPU lowering workaround) -> hidden (M, 4C) bf16;
//   2. fc2 + bias, times the per-row scale, plus the residual x.
// The LN output stays on chip; the 4C hidden goes through a device scratch
// buffer from the caller (the TPU kernel kept it in VMEM).
//
// Bound on H100: compute-bound products (2 * 4C^2 FLOP per row) plus the
// hidden round trip (16 C bytes per row); keeping the hidden on chip and
// a wgmma pipeline are later work.
#include "gemm.cuh"

using pw::bf16;

// Returns the first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int pw_swin_mlp(
    const void* x, const float* ln_w, const float* ln_b,
    const void* w1, const float* b1, const void* w2, const float* b2,
    const float* row_scale, void* hidden_buf, void* out,
    int M, int C, int Hd, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;

  pw::GemmArgs a = pw::gemm_args(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                                 b1, static_cast<bf16*>(hidden_buf), M, Hd, C);
  a.ln_w = ln_w; a.ln_b = ln_b;
  pw::gemm_bf16<pw::PRO_LN, pw::EPI_BIAS_GELU>(a, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  pw::GemmArgs f = pw::gemm_args(static_cast<const bf16*>(hidden_buf),
                                 static_cast<const bf16*>(w2), b2, static_cast<bf16*>(out),
                                 M, C, Hd);
  f.resid = static_cast<const bf16*>(x);
  f.row_scale = row_scale;
  f.rs_div = 1;
  pw::gemm_bf16<pw::PRO_NONE, pw::EPI_RESID>(f, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
