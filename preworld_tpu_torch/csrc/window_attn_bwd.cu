// K5b and K6b: backward of the window attention K5 / K6 (window_attn.cu).
//
// Replace preworld_tpu/ops/window_attn_pallas.py::_fused_window_attention_bwd
// (K5b, packed windows) and ::_band_window_attention_bwd (K6b, image
// layout), the backward kernels of the flash-style custom VJPs: from qkv,
// the cotangent dO and the same bias and mask they give dqkv in qkv's
// layout (bf16) and the relative-position-bias gradient (heads, N, N) f32,
// recomputing each window's softmax instead of saving probabilities. The
// TPU kernels carry the bias gradient in one VMEM block across their
// ordered grid; on Hopper the blocks run unordered, so this is the
// backward core of swin_attn_bwd.cuh: one block of N / 16 warps per
// (head, group of windows) on mma.sync products, the next window's q, k,
// v and dO fetched with cp.async while this one computes, the (N, N)
// d-bias partial in the registers of the threads that own its elements,
// written once per block and reduced over groups in one launch in a fixed
// order: no float atomics, identical bits run to run.
//
// Bound on H100: the bytes of qkv and dO read and dqkv written, N (3d + d)
// + 3 N d bf16 per window and head, against 10 N^2 d tensor-core FLOP (S
// recomputed, dV, dP, dQ, dK; the kernel forms dP twice rather than hold
// it in registers): at d = 32 and N = 144 the byte bound is about three
// times the operation bound.
#include "swin_attn_bwd.cuh"

using pw::bf16;

// f32 elements of the `part` scratch of one backward call.
extern "C" long long pw_window_attn_bwd_part_elems(int windows, int heads, int N) {
  return pw::attn_bwd_part_elems(windows, heads, N);
}

// All pointers are device pointers on `stream`; mask may be null. Outputs
// dqkv (qkv's layout, bf16) and drel (heads, N, N) f32. Returns the first
// CUDA error, else 0.
extern "C" int pw_window_attn_packed_bwd(const void* qkv, const float* rel_bias,
                                         const float* mask, const void* dout, void* dqkv,
                                         float* drel, float* part, int Bn, int N, int nWm,
                                         int C, int heads, float scale, void* stream_ptr) {
  return (int)pw::window_attn_bwd<pw::PackedMap, pw::MASK_DENSE>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), rel_bias, mask,
      static_cast<bf16*>(dqkv), drel, part, pw::PackedMap{N, nWm}, Bn, heads, C, N, scale,
      reinterpret_cast<cudaStream_t>(stream_ptr));
}

extern "C" int pw_window_attn_band_bwd(const void* qkv, const float* rel_bias,
                                       const float* mask, const void* dout, void* dqkv,
                                       float* drel, float* part, int B, int Hp, int Wp, int ws,
                                       int C, int heads, float scale, void* stream_ptr) {
  return (int)pw::window_attn_bwd<pw::ImageMap, pw::MASK_DENSE>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), rel_bias, mask,
      static_cast<bf16*>(dqkv), drel, part, pw::image_map(Hp, Wp, ws, 0),
      B * (Hp / ws) * (Wp / ws), heads, C, ws * ws, scale,
      reinterpret_cast<cudaStream_t>(stream_ptr));
}
