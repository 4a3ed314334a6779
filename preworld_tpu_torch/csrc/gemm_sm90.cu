// C entry points of the Hopper GEMM (gemm_sm90.cuh) outside the kernel
// chains: the standalone backward products that chip_smoke.py holds
// against torch.matmul on the card (the MN-major operands of the weight
// and input gradients, checked alone), the weight gradient's split plan,
// and the count of tensor maps encoded.
#include "gemm_sm90.cuh"

using pw::bf16;

// Tensor maps encoded since the library loaded (the cache's misses).
extern "C" long long pw_tensor_map_encodes() { return pw::tensor_map_encodes(); }

// Splits of M that gemm_dw_sm90 takes for an (N, K) weight gradient over
// M rows, with the LN prologue or without (1: no partials, no reduction
// launch).
extern "C" int pw_dw_splits(int M, int N, int K, int ln) {
  return pw::dw_plan(M, N, K, ln != 0).splits;
}

// f32 elements of the `part` scratch of pw_gemm_dw.
extern "C" long long pw_gemm_dw_part_elems(int M, int N, int K, int ln) {
  return pw::dw_part_elems(M, N, K, ln != 0);
}

// out (N, K) f32 = A^T . B over M rows, A (M, N) and B (M, K) bf16; with
// `stats` (M, 2) the LayerNorm (mu, rstd, ln_w, ln_b) on B first. Returns
// the first CUDA error, else 0.
extern "C" int pw_gemm_dw(const void* A, const void* B, float* out, float* part,
                          const float* stats, const float* ln_w, const float* ln_b, int M,
                          int N, int K, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  pw::DwArgs a{};
  a.A = static_cast<const bf16*>(A);
  a.B = static_cast<const bf16*>(B);
  a.part = part;
  a.M = M; a.N = N; a.K = K;
  a.stats = stats; a.ln_w = ln_w; a.ln_b = ln_b;
  const cudaError_t err = stats ? pw::gemm_dw_sm90<pw::PRO_LN>(a, out, stream)
                                : pw::gemm_dw_sm90<pw::PRO_NONE>(a, out, stream);
  return (int)err;
}

// out (M, N) f32 = A . W, A (M, K) and W (K, N) bf16 as stored (the input
// gradient's layout). Returns the first CUDA error, else 0.
extern "C" int pw_gemm_dx(const void* A, const void* W, float* out, int M, int N, int K,
                          void* stream_ptr) {
  pw::Sm90Args p = pw::sm90_args(M, N, K, nullptr);
  p.out_f32 = out;
  return (int)pw::gemm_sm90<pw::PRO_NONE, pw::EPI_F32, true>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(W), nullptr, nullptr, p,
      reinterpret_cast<cudaStream_t>(stream_ptr));
}
