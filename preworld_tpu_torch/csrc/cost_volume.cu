// K3: homography plane-sweep stereo cost volume.
//
// Replaces preworld_tpu/ops/cost_volume_pallas.py::plane_sweep_cost_hom
// (the pallas_call of _cv_kernel_hom):
//   cost[bn, d, y, x] = sum_c |curr[bn, y, x, c] - bilinear(prev[bn], H_d (x, y, 1))[c]|
//                       + bias * [sample[C-4] == 0]
// with align-corners bilinear sampling and zeros padding; a plane whose
// homogeneous z is below 1e-3 is behind the camera and samples nothing.
// Every sample is exact: the TPU kernel's y-band window and 224-pixel
// x sub-window approximations (an MXU one-hot contraction) are not carried
// over -- on this card a bilinear gather is four coalesced row reads.
//
// Layout: one warp per output pixel (bn, y, x) with the C = 128 channels
// spread over the lanes (CPL = 4 contiguous channels each); the warp keeps its
// curr row in registers and walks all D planes, computing the sample
// coordinates from the plane's 9 homography scalars. The coordinate and
// interpolation arithmetic uses explicitly rounded operations (no FMA
// contraction) in the same order as the plain PyTorch version, so both
// land on the same sample positions and the same "sampled nothing" flags.
//
// Bound on H100: gathers -- per (pixel, plane) four C-wide bf16 rows from
// the previous frame's feature map (one camera's map, 11.5 MB at the
// flagship 128 x 352 x 128, stays in L2), i.e. L2 bandwidth.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pw {

using bf16 = __nv_bfloat16;

constexpr int CPL = 4;  // channels per lane
constexpr int C = CPL * 32;

__global__ void plane_sweep_hom_kernel(const bf16* __restrict__ prev,
                                       const bf16* __restrict__ curr,
                                       const float* __restrict__ hom,
                                       float* __restrict__ out, int BN, int D,
                                       int H, int W, float bias) {
  const int lane = threadIdx.x & 31;
  const long long pix = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (pix >= (long long)BN * H * W) return;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const int bn = (int)(pix / ((long long)W * H));

  float cur[CPL];
  const bf16* crow = curr + (size_t)pix * C + lane * CPL;
#pragma unroll
  for (int i = 0; i < CPL; ++i) cur[i] = __bfloat162float(crow[i]);
  const bf16* pimg = prev + (size_t)bn * H * W * C + lane * CPL;
  const int ci = C - 4;  // the "sampled nothing" channel
  const int ci_lane = ci / CPL, ci_off = ci % CPL;
  const float xf = (float)x, yf = (float)y;

  for (int d = 0; d < D; ++d) {
    const float* h = hom + ((size_t)bn * D + d) * 9;
    float den = __fadd_rn(__fmul_rn(h[6], xf), __fadd_rn(__fmul_rn(h[7], yf), h[8]));
    float s[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) s[i] = 0.f;
    if (!(den < 1e-3f)) {
      float inv = __fdiv_rn(1.0f, den);
      float gx = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[0], xf), __fmul_rn(h[1], yf)), h[2]), inv);
      float gy = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[3], xf), __fmul_rn(h[4], yf)), h[5]), inv);
      if (gx > -1.f && gx < (float)W && gy > -1.f && gy < (float)H) {
        float x0f = floorf(gx), y0f = floorf(gy);
        float wx1 = __fsub_rn(gx, x0f), wy1 = __fsub_rn(gy, y0f);
        float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
        int x0 = (int)x0f, y0 = (int)y0f;
        bool vx0 = x0 >= 0, vx1 = x0 + 1 < W, vy0 = y0 >= 0, vy1 = y0 + 1 < H;
        float v00[CPL], v01[CPL], v10[CPL], v11[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) v00[i] = v01[i] = v10[i] = v11[i] = 0.f;
        // corner rows; only the in-range corners are read
        const bf16* r0 = pimg + ((long long)y0 * W + x0) * C;
        const bf16* r1 = r0 + (long long)W * C;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          if (vy0 && vx0) v00[i] = __bfloat162float(r0[i]);
          if (vy0 && vx1) v01[i] = __bfloat162float(r0[C + i]);
          if (vy1 && vx0) v10[i] = __bfloat162float(r1[i]);
          if (vy1 && vx1) v11[i] = __bfloat162float(r1[C + i]);
        }
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          float top = __fadd_rn(__fmul_rn(v00[i], wx0), __fmul_rn(v01[i], wx1));
          float bot = __fadd_rn(__fmul_rn(v10[i], wx0), __fmul_rn(v11[i], wx1));
          s[i] = __fadd_rn(__fmul_rn(top, wy0), __fmul_rn(bot, wy1));
        }
      }
    }
    float acc = 0.f, sci = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      acc += fabsf(cur[i] - s[i]);
      if (i == ci_off) sci = s[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    sci = __shfl_sync(0xffffffffu, sci, ci_lane);
    if (lane == 0)
      out[(((size_t)bn * D + d) * H + y) * W + x] = acc + (sci == 0.f ? bias : 0.f);
  }
}

}  // namespace pw

// prev, curr: (BN, H, W, C) bf16; hom: (BN, D, 3, 3) f32; out: (BN, D, H, W) f32.
// C must be 128 (Swin-B stage 0). Returns cudaGetLastError() (0 on success).
extern "C" int pw_plane_sweep_cost_hom(const void* prev, const void* curr, const float* hom,
                                       float* out, int BN, int D, int H, int W, int C,
                                       float bias, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int warps_per_block = 8;
  const long long pixels = (long long)BN * H * W;
  const unsigned blocks = (unsigned)((pixels + warps_per_block - 1) / warps_per_block);
  const auto* p = static_cast<const pw::bf16*>(prev);
  const auto* c = static_cast<const pw::bf16*>(curr);
  if (C != pw::C) return (int)cudaErrorInvalidValue;
  pw::plane_sweep_hom_kernel<<<blocks, 256, 0, stream>>>(p, c, hom, out, BN, D, H, W, bias);
  return (int)cudaGetLastError();
}
