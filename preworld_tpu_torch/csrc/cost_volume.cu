// K3 and K7: the plane-sweep stereo cost volume, from homographies (K3) or
// from a precomputed sampling grid (K7).
//
// Replace preworld_tpu/ops/cost_volume_pallas.py::plane_sweep_cost_hom (K3,
// the pallas_call of _cv_kernel_hom) and ::plane_sweep_cost (K7, the
// pallas_call of _cv_kernel):
//   cost[bn, d, y, x] = sum_c |curr[bn, y, x, c] - bilinear(prev[bn], (gx, gy))[c]|
//                       + bias * [sample[C-4] == 0]
// with align-corners bilinear sampling and zeros padding. The two differ
// only in where the sample position (gx, gy) of output pixel (x, y) on plane
// d comes from, a template parameter of the one kernel:
//   HomCoords   K3: the plane's 3x3 homography applied to (x, y, 1); a
//               homogeneous z below 1e-3 is behind the camera and samples
//               nothing.
//   GridCoords  K7: grid[bn, d*H + y, x] (f32, normalised to [-1, 1], from
//               gen_stereo_grid) unnormalised as ((g + 1) * 0.5) * (size - 1).
// A position samples only when -1 < gx < W and -1 < gy < H (the JAX
// kernel's test); gen_stereo_grid's -2 behind-camera sentinel lies outside.
// Every sample is exact: the TPU kernels' y-band window and 224-pixel x
// sub-window approximations (an MXU one-hot contraction) are not carried
// over -- on this card a bilinear gather is four coalesced row reads.
//
// Layout: one warp per output pixel (bn, y, x); the C channels go over the
// lanes in NCH chunks of 128, CPL = 4 contiguous channels of each chunk per
// lane. The warp keeps its curr row in registers and walks all D planes.
// The coordinate and interpolation arithmetic uses explicitly rounded
// operations (no FMA contraction) in the same order as the plain PyTorch
// version, so both land on the same sample positions and the same "sampled
// nothing" flags. Built for C = 128 k, k = 1 ... 12: every stereo width the
// route admits (a multiple of 128) up to 1536, past every Swin stage-0
// width (96 ... 192).
//
// Bound on H100: gathers -- per (pixel, plane) four C-wide bf16 rows from
// the previous frame's feature map (one camera's map, 11.5 MB at the
// flagship 128 x 352 x 128, stays in L2), i.e. L2 bandwidth. K7 streams the
// grid besides (8 bytes per pixel and plane, read once, 190 MB at the bench
// shape).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pw {

using bf16 = __nv_bfloat16;

constexpr int CPL = 4;         // channels per lane in one chunk
constexpr int CHUNK = CPL * 32;  // channels per chunk
constexpr int MAX_NCH = 12;      // C up to 1536

// K3: (BN, D, 3, 3) f32 homographies
struct HomCoords {
  const float* hom;
  int D;
  __device__ bool operator()(int bn, int d, int x, int y, float& gx, float& gy) const {
    const float* h = hom + ((size_t)bn * D + d) * 9;
    const float xf = (float)x, yf = (float)y;
    float den = __fadd_rn(__fmul_rn(h[6], xf), __fadd_rn(__fmul_rn(h[7], yf), h[8]));
    if (den < 1e-3f) return false;
    float inv = __fdiv_rn(1.0f, den);
    gx = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[0], xf), __fmul_rn(h[1], yf)), h[2]), inv);
    gy = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(h[3], xf), __fmul_rn(h[4], yf)), h[5]), inv);
    return true;
  }
};

// K7: (BN, D*H, W, 2) f32 normalised sampling grid
struct GridCoords {
  const float* grid;
  int D, H, W;
  __device__ bool operator()(int bn, int d, int x, int y, float& gx, float& gy) const {
    const float2 g =
        reinterpret_cast<const float2*>(grid)[(((size_t)bn * D + d) * H + y) * W + x];
    gx = __fmul_rn(__fmul_rn(__fadd_rn(g.x, 1.f), 0.5f), (float)(W - 1));
    gy = __fmul_rn(__fmul_rn(__fadd_rn(g.y, 1.f), 0.5f), (float)(H - 1));
    return true;
  }
};

template <int NCH, class Coords>
__global__ void plane_sweep_kernel(const bf16* __restrict__ prev, const bf16* __restrict__ curr,
                                   Coords coords, float* __restrict__ out, int BN, int D,
                                   int H, int W, float bias) {
  constexpr int C = NCH * CHUNK;
  const int lane = threadIdx.x & 31;
  const long long pix = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (pix >= (long long)BN * H * W) return;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const int bn = (int)(pix / ((long long)W * H));

  float cur[NCH][CPL];
  const bf16* crow = curr + (size_t)pix * C + lane * CPL;
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int i = 0; i < CPL; ++i) cur[k][i] = __bfloat162float(crow[k * CHUNK + i]);
  const bf16* pimg = prev + (size_t)bn * H * W * C + lane * CPL;

  for (int d = 0; d < D; ++d) {
    float s[NCH][CPL];
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < CPL; ++i) s[k][i] = 0.f;
    float gx, gy;
    if (coords(bn, d, x, y, gx, gy) && gx > -1.f && gx < (float)W && gy > -1.f &&
        gy < (float)H) {
      float x0f = floorf(gx), y0f = floorf(gy);
      float wx1 = __fsub_rn(gx, x0f), wy1 = __fsub_rn(gy, y0f);
      float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
      int x0 = (int)x0f, y0 = (int)y0f;
      bool vx0 = x0 >= 0, vx1 = x0 + 1 < W, vy0 = y0 >= 0, vy1 = y0 + 1 < H;
      // corner rows; only the in-range corners are read
      const bf16* r0 = pimg + ((long long)y0 * W + x0) * C;
      const bf16* r1 = r0 + (long long)W * C;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c0 = k * CHUNK;
        float v00[CPL], v01[CPL], v10[CPL], v11[CPL];
#pragma unroll
        for (int i = 0; i < CPL; ++i) v00[i] = v01[i] = v10[i] = v11[i] = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          if (vy0 && vx0) v00[i] = __bfloat162float(r0[c0 + i]);
          if (vy0 && vx1) v01[i] = __bfloat162float(r0[C + c0 + i]);
          if (vy1 && vx0) v10[i] = __bfloat162float(r1[c0 + i]);
          if (vy1 && vx1) v11[i] = __bfloat162float(r1[C + c0 + i]);
        }
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          float top = __fadd_rn(__fmul_rn(v00[i], wx0), __fmul_rn(v01[i], wx1));
          float bot = __fadd_rn(__fmul_rn(v10[i], wx0), __fmul_rn(v11[i], wx1));
          s[k][i] = __fadd_rn(__fmul_rn(top, wy0), __fmul_rn(bot, wy1));
        }
      }
    }
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k)
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc += fabsf(cur[k][i] - s[k][i]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    // the "sampled nothing" channel C - 4: the last chunk's lane 31, slot 0
    const float sci = __shfl_sync(0xffffffffu, s[NCH - 1][0], 31);
    if (lane == 0)
      out[(((size_t)bn * D + d) * H + y) * W + x] = acc + (sci == 0.f ? bias : 0.f);
  }
}

template <int NCH, class Coords>
int launch_plane_sweep(const bf16* prev, const bf16* curr, Coords coords, float* out, int BN,
                       int D, int H, int W, int C, float bias, cudaStream_t stream) {
  if (C == NCH * CHUNK) {
    const int warps_per_block = 8;
    const long long pixels = (long long)BN * H * W;
    const unsigned blocks = (unsigned)((pixels + warps_per_block - 1) / warps_per_block);
    plane_sweep_kernel<NCH, Coords><<<blocks, 32 * warps_per_block, 0, stream>>>(
        prev, curr, coords, out, BN, D, H, W, bias);
    return (int)cudaGetLastError();
  }
  if constexpr (NCH < MAX_NCH)
    return launch_plane_sweep<NCH + 1>(prev, curr, coords, out, BN, D, H, W, C, bias, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pw

// prev, curr: (BN, H, W, C) bf16; hom: (BN, D, 3, 3) f32; out: (BN, D, H, W) f32.
// C = 128 k, k = 1 ... 12. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for another C.
extern "C" int pw_plane_sweep_cost_hom(const void* prev, const void* curr, const float* hom,
                                       float* out, int BN, int D, int H, int W, int C,
                                       float bias, void* stream_ptr) {
  return pw::launch_plane_sweep<1>(static_cast<const pw::bf16*>(prev),
                                   static_cast<const pw::bf16*>(curr), pw::HomCoords{hom, D},
                                   out, BN, D, H, W, C, bias,
                                   reinterpret_cast<cudaStream_t>(stream_ptr));
}

// prev, curr: (BN, H, W, C) bf16; grid: (BN, D*H, W, 2) f32; out: (BN, D, H, W)
// f32. C as for K3.
extern "C" int pw_plane_sweep_cost_grid(const void* prev, const void* curr, const float* grid,
                                        float* out, int BN, int D, int H, int W, int C,
                                        float bias, void* stream_ptr) {
  return pw::launch_plane_sweep<1>(static_cast<const pw::bf16*>(prev),
                                   static_cast<const pw::bf16*>(curr),
                                   pw::GridCoords{grid, D, H, W}, out, BN, D, H, W, C, bias,
                                   reinterpret_cast<cudaStream_t>(stream_ptr));
}
