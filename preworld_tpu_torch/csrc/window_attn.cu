// K5 and K6: window multi-head self-attention on a precomputed qkv,
//     out = softmax(q k^T d^-1/2 + bias + mask) v   per window and head.
//
// Replace preworld_tpu/ops/window_attn_pallas.py::fused_window_attention
// (K5, packed windows: qkv (Bn, N, 3C) -> (Bn, N, C), window i masked by
// mask[i mod nW]) and ::band_window_attention (K6, the padded image layout
// already rolled: qkv (B, Hp, Wp, 3C) -> (B, Hp, Wp, C), windows row-major,
// mask (nH nW, N, N)). Both are the forward core of swin_attn.cuh with a
// dense additive f32 mask (a null mask takes its MASK_NONE build): K5
// through the packed map, K6 through the image map at shift 0 (the caller
// rolls). The TPU kernels stage windows through VMEM (K6 collapses each
// ws x ws slab of a band into scratch rows) and read the mask once per
// window for all heads; here one block takes one head of a group of
// windows and cp.async-gathers each window's q, k, v rows straight from
// device memory into shared memory while the window before computes, and
// the blocks of all heads of a group run side by side, so the mask and the
// token rows come from L2 after the first head.
//
// Bound on H100: per window and head 4 N^2 d FLOP on tensor cores against
// N (3d + d) bf16 of qkv and output, about 144 FLOP per byte at N = 144:
// device memory binds the ideal (every qkv row read once, every output
// written once). A dense mask adds N^2 f32 per window and head from L2,
// read straight into registers a few tiles ahead of its use; scores and
// probabilities stay in registers (mma.sync fragments, N / 16 warps).
#include "swin_attn.cuh"

using pw::bf16;

// All pointers are device pointers on `stream`; mask may be null.
// Returns the first CUDA error, else 0.
extern "C" int pw_window_attn_packed(const void* qkv, const float* rel_bias, const float* mask,
                                     void* out, int Bn, int N, int nWm, int C, int heads,
                                     float scale, void* stream_ptr) {
  return (int)pw::window_attn<pw::PackedMap, pw::MASK_DENSE>(
      static_cast<const bf16*>(qkv), rel_bias, mask, static_cast<bf16*>(out),
      pw::PackedMap{N, nWm}, Bn, heads, C, N, scale, reinterpret_cast<cudaStream_t>(stream_ptr));
}

extern "C" int pw_window_attn_band(const void* qkv, const float* rel_bias, const float* mask,
                                   void* out, int B, int Hp, int Wp, int ws, int C, int heads,
                                   float scale, void* stream_ptr) {
  return (int)pw::window_attn<pw::ImageMap, pw::MASK_DENSE>(
      static_cast<const bf16*>(qkv), rel_bias, mask, static_cast<bf16*>(out),
      pw::image_map(Hp, Wp, ws, 0), B * (Hp / ws) * (Wp / ws), heads, C, ws * ws, scale,
      reinterpret_cast<cudaStream_t>(stream_ptr));
}
