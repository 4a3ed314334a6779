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
// Bound on H100: read afresh for every (pixel, plane), the four C-wide
// bf16 corner rows from the previous frame's map (11.5 MB a camera at the
// flagship 128 x 352 x 128, resident in L2) come to ~24 GB a call, and the
// first port of this kernel sat on L2's bandwidth at ~5 ms. With the
// corners reused this design is bound by instruction issue (~5 FP32
// instructions per channel and sample, plus the per-plane and reload
// overhead): a measurement build that skipped the corner loads was no
// faster.
//
// Layout: a block takes a row tile of PX output pixels (bn, y, x ... x +
// PX - 1) and walks all D planes. LPP lanes own a pixel: in each
// 128-channel chunk, lane g holds VPL 16-byte vectors, channels 8 (v LPP +
// g) ... + 7, so each load instruction reads whole 128-byte lines. The
// planes go in batches of LPP: lane g computes the sample position of plane
// d0 + g and the group reads it by shuffle. What the design does about the
// bound:
//   * corners reused across planes: each lane keeps its pixel's four corner
//     vectors in registers, converted to f32, and reloads them only when
//     floor(gx), floor(gy) or the in-range state change (75 % of the
//     flagship's samples keep the corners of the plane before);
//   * one FMA chain per channel, t = cur - w00 v00 - w01 v01 - w10 v10 -
//     w11 v11, acc += |t|, with the weights formed once per (pixel, plane);
//   * each plane's partial cost is summed over the group by shuffles, and
//     lane g keeps plane d0 + g's (chunks of a C > 128 add to it); the block
//     stages a batch's costs in shared memory and stores them coalesced
//     along x.
// Kept exactly as in the plain version (`_sample_cost`): the sample
// position, floor, the in-range and behind-camera tests and the "sampled
// nothing" flag, whose channel C - 4 is sampled in the plain version's order
// of operations (explicitly rounded, no contraction). Only the channel sum
// differs in order and rounding. No atomics: bit-identical run to run.
// Built for C = 128 k, k = 1 ... 12: every stereo width the route admits (a
// multiple of 128) up to 1536.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace pw {

using bf16 = __nv_bfloat16;

constexpr int CHUNK = 128;                  // channels per chunk
constexpr int MAX_NCH = 12;                 // C up to 1536
constexpr int LPP = 8;                      // lanes per pixel, planes per batch
constexpr int VPL = CHUNK / 8 / LPP;        // 16-byte vectors per lane and chunk
constexpr int CPL = VPL * 8;                // channels per lane and chunk
constexpr int THREADS = 256;
constexpr int PX = THREADS / LPP;           // pixels per block (row tile)
constexpr unsigned FULL = 0xffffffffu;
// channel C - 4 is chunk channel 124: vector 15, element 4
constexpr int FLAG_LANE = 15 % LPP;
constexpr int FLAG_SLOT = (15 / LPP) * 8 + 4;
// sample state of a (pixel, plane): (y0 + 1) << 16 | (x0 + 1) in range,
// else KEY_NONE; KEY_STALE marks corner registers that hold nothing yet
constexpr int KEY_NONE = -1;
constexpr int KEY_STALE = -2;

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

// 8 bf16 (one 16-byte vector) to f32
__device__ __forceinline__ void unpack8(const uint4 r, float* f) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// this lane's channels of one 128-channel chunk of a feature row
__device__ __forceinline__ void load_row(const bf16* row, float (&f)[CPL]) {
#pragma unroll
  for (int v = 0; v < VPL; ++v) unpack8(ldg16(row + v * LPP * 8), f + v * 8);
}

// this lane's channels of the four corners of sample state `key`, zero where
// a corner lies outside the map (or the position samples nothing); `base`
// points at the lane's channels of the chunk in pixel (0, 0)
template <int C>
__device__ __forceinline__ void load_corners(const bf16* base, int key, int W, int H,
                                             float (&cv)[4][CPL]) {
  const int x0 = (key & 0xffff) - 1, y0 = (key >> 16) - 1;
  const bool in = key >= 0;
  const bool ok[4] = {in && y0 >= 0 && x0 >= 0, in && y0 >= 0 && x0 + 1 < W,
                      in && y0 + 1 < H && x0 >= 0, in && y0 + 1 < H && x0 + 1 < W};
  const bf16* r0 = base + ((long long)y0 * W + x0) * C;
  const bf16* rows[4] = {r0, r0 + C, r0 + (long long)W * C, r0 + (long long)W * C + C};
  uint4 raw[4][VPL];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      raw[c][v] = ok[c] ? ldg16(rows[c] + v * LPP * 8) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int v = 0; v < VPL; ++v) unpack8(raw[c][v], cv[c] + v * 8);
}

// the sample state of pixel (x, y) on plane d (d >= D: none): key, and the
// weights wx1, wy1 of the corners x0 + 1, y0 + 1
template <class Coords>
__device__ __forceinline__ void sample_state(const Coords& coords, int bn, int d, int x, int y,
                                             int D, int H, int W, int& key, float& wx1,
                                             float& wy1) {
  key = KEY_NONE;
  wx1 = wy1 = 0.f;
  float gx, gy;
  if (d < D && coords(bn, d, x, y, gx, gy) && gx > -1.f && gx < (float)W && gy > -1.f &&
      gy < (float)H) {
    const float x0f = floorf(gx), y0f = floorf(gy);
    wx1 = __fsub_rn(gx, x0f);
    wy1 = __fsub_rn(gy, y0f);
    key = ((int)y0f + 1) << 16 | ((int)x0f + 1);
  }
}

template <int NCH, class Coords>
__global__ void __launch_bounds__(THREADS, 2)
    plane_sweep_kernel(const bf16* __restrict__ prev, const bf16* __restrict__ curr,
                       Coords coords, float* __restrict__ out, int D, int H, int W,
                       float bias) {
  constexpr int C = NCH * CHUNK;
  __shared__ float stage[LPP][PX + 1];
  const int tid = threadIdx.x;
  const int g = tid % LPP;  // lane within the pixel's group
  const int p = tid / LPP;  // pixel within the tile
  const int tiles = (W + PX - 1) / PX;
  const int tile = blockIdx.x % tiles;
  const int y = (blockIdx.x / tiles) % H;
  const int bn = blockIdx.x / (tiles * H);
  // a ragged last tile's spare pixels repeat the row's last pixel, unstored
  const int x = min(tile * PX + p, W - 1);
  const bf16* pimg = prev + (size_t)bn * H * W * C + g * 8;
  const bf16* crow = curr + (((size_t)bn * H + y) * W + x) * C + g * 8;

  float cur[CPL];
  float cv[4][CPL];
  int key = KEY_STALE;
  if constexpr (NCH == 1) load_row(crow, cur);

  // the sample state of plane d0 + g, computed by lane g a batch ahead
  int nx_key;
  float nx_wx, nx_wy;
  sample_state(coords, bn, g, x, y, D, H, W, nx_key, nx_wx, nx_wy);
  for (int d0 = 0; d0 < D; d0 += LPP) {
    const int my_key = nx_key;
    const float my_wx = nx_wx, my_wy = nx_wy;
    sample_state(coords, bn, d0 + LPP + g, x, y, D, H, W, nx_key, nx_wx, nx_wy);
    float mine = 0.f;  // lane g: plane d0 + g's cost
    unsigned empty = 0;  // bit j: plane d0 + j sampled nothing (FLAG_LANE's)
    for (int k = 0; k < NCH; ++k) {
      if constexpr (NCH > 1) {
        load_row(crow + k * CHUNK, cur);
        key = KEY_STALE;
      }
#pragma unroll 1
      for (int j = 0; j < LPP; ++j) {
        const int kj = __shfl_sync(FULL, my_key, j, LPP);
        const float wx1 = __shfl_sync(FULL, my_wx, j, LPP);
        const float wy1 = __shfl_sync(FULL, my_wy, j, LPP);
        if (kj != key) {
          key = kj;
          load_corners<C>(pimg + k * CHUNK, kj, W, H, cv);
        }
        const float wx0 = __fsub_rn(1.f, wx1), wy0 = __fsub_rn(1.f, wy1);
        const float w00 = wx0 * wy0, w01 = wx1 * wy0, w10 = wx0 * wy1, w11 = wx1 * wy1;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          float t;
          if (i == FLAG_SLOT) {
            // the plain version's bilinear, operation for operation
            const float top = __fadd_rn(__fmul_rn(cv[0][i], wx0), __fmul_rn(cv[1][i], wx1));
            const float bot = __fadd_rn(__fmul_rn(cv[2][i], wx0), __fmul_rn(cv[3][i], wx1));
            const float s = __fadd_rn(__fmul_rn(top, wy0), __fmul_rn(bot, wy1));
            if (k == NCH - 1 && s == 0.f) empty |= 1u << j;
            t = cur[i] - s;
          } else {
            t = fmaf(-w00, cv[0][i], cur[i]);
            t = fmaf(-w01, cv[1][i], t);
            t = fmaf(-w10, cv[2][i], t);
            t = fmaf(-w11, cv[3][i], t);
          }
          if (i & 1)
            a1 += fabsf(t);
          else
            a0 += fabsf(t);
        }
        // the group's sum, the same bits in every lane (each level adds a
        // commutative pair)
        float tot = a0 + a1;
#pragma unroll
        for (int o = 1; o < LPP; o <<= 1) tot += __shfl_xor_sync(FULL, tot, o);
        if (g == j) mine += tot;
      }
    }
    const unsigned emp = __shfl_sync(FULL, empty, FLAG_LANE, LPP);
    stage[g][p] = mine + ((emp >> g & 1u) ? bias : 0.f);
    __syncthreads();
    const int j = tid / PX, xo = tile * PX + tid % PX;
    if (d0 + j < D && xo < W)
      out[(((size_t)bn * D + d0 + j) * H + y) * W + xo] = stage[j][tid % PX];
    __syncthreads();
  }
}

template <int NCH, class Coords>
int launch_plane_sweep(const bf16* prev, const bf16* curr, Coords coords, float* out, int BN,
                       int D, int H, int W, int C, float bias, cudaStream_t stream) {
  if (C == NCH * CHUNK) {
    if (W > 65534 || H > 32766) return (int)cudaErrorInvalidValue;  // sample-state packing
    const long long blocks = (long long)BN * H * ((W + PX - 1) / PX);
    plane_sweep_kernel<NCH, Coords><<<(unsigned)blocks, THREADS, 0, stream>>>(
        prev, curr, coords, out, D, H, W, bias);
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
