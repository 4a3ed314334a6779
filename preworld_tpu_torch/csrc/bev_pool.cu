// K4: lift-splat voxel pooling over voxel-sorted frustum points.
//
// Replaces preworld_tpu/ops/bev_pool_pallas.py::bev_pool_pallas_sorted
// (the pallas_call of _pool_kernel, reached through bev_pool_fused):
//   out[v, c] = sum_{p : vox(p) = v} depth[p] * feat[pix(p), c].
// The caller sorts the points by voxel id (carrying depth and pixel index)
// and gives every voxel its interval [starts[v], starts[v+1]) of the sorted
// points; points with the sentinel id num_voxels lie past starts[num_voxels]
// and are never read. As in the CUDA original (bev_pool_cuda.cu), one
// thread owns one (voxel, channel) and walks its interval, gathering
// feat[pix] * depth itself, so the (P, C) products never reach device
// memory. Every voxel is written -- zeros where the interval is empty --
// with no atomics, so the result is deterministic. The TPU kernel's one-hot
// MXU contraction and lane packing are not carried over.
//
// Bound on H100: gathers of C-wide feature rows (64 B at C = 32 in bf16,
// one warp per voxel reads one row per point) plus the 4-byte depth and
// pixel index per point: memory latency over ~1.5 M points per frame.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pw {

using bf16 = __nv_bfloat16;

__global__ void bev_pool_intervals_kernel(const bf16* __restrict__ depth,
                                          const int* __restrict__ pix,
                                          const int* __restrict__ starts,
                                          const bf16* __restrict__ feat,
                                          bf16* __restrict__ out, int num_voxels, int C) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)num_voxels * C) return;
  const int v = (int)(idx / C), c = (int)(idx % C);
  const int s = starts[v], e = starts[v + 1];
  float acc = 0.f;
  for (int p = s; p < e; ++p)
    acc += __bfloat162float(depth[p]) * __bfloat162float(feat[(size_t)pix[p] * C + c]);
  out[idx] = __float2bfloat16(acc);
}

}  // namespace pw

// depth, pix: (P,) sorted by voxel id; starts: (num_voxels + 1,) int32;
// feat: (num_pixels, C) bf16; out: (num_voxels, C) bf16.
// Returns cudaGetLastError() (0 on success).
extern "C" int pw_bev_pool_intervals(const void* depth, const int* pix, const int* starts,
                                     const void* feat, void* out, int num_voxels, int C,
                                     void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const long long n = (long long)num_voxels * C;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  pw::bev_pool_intervals_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const pw::bf16*>(depth), pix, starts, static_cast<const pw::bf16*>(feat),
      static_cast<pw::bf16*>(out), num_voxels, C);
  return (int)cudaGetLastError();
}
