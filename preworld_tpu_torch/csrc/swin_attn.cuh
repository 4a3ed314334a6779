// Window-attention constants shared by K1 (swin_block.cu) and its
// backward K1b (swin_block_bwd.cu), and K1's qkv + attention recompute.
#pragma once

#include "gemm.cuh"

namespace pw {

constexpr int AT_THREADS = 256;
constexpr int AT_WARPS = AT_THREADS / 32;
constexpr int AT_D = 32;          // head dim of every Swin-B stage
constexpr int AT_LDQ = AT_D + 8;  // bf16 stride of q / k / v tiles
constexpr int AT_MAXN = 144;      // tokens per window, at most
constexpr int AT_CPL = (AT_MAXN + 31) / 32;  // score columns per lane

// K1's first two kernels (swin_block.cu): the LN1 + pad-zeroing + qkv
// product into qkv (M, 3C), then window attention into o (M, C), both bf16
// in image order. Returns the first launch error.
cudaError_t attn_qkv_o(const bf16* x, const float* ln_w, const float* ln_b,
                       const bf16* wqkv, const float* bqkv, const float* rel_bias,
                       const int* region, bf16* qkv, bf16* o, int B, int Hp, int Wp, int C,
                       int heads, int ws, int H, int W, int shift, float scale,
                       cudaStream_t stream);

}  // namespace pw
