// K4: lift-splat voxel pooling over voxel-sorted frustum points.
//
// Replaces preworld_tpu/ops/bev_pool_pallas.py::bev_pool_pallas_sorted
// (the pallas_call of _pool_kernel, reached through bev_pool_fused):
//   out[v, c] = sum_{p : vox(p) = v} depth[p] * feat[pix(p), c].
// The caller sorts the voxel ids (torch.sort, stable, as the JAX package
// sorts in XLA outside its kernel) and passes the sorted ids and the sort's
// order; this file does the rest in three launches:
//   1. bev_pool_starts_kernel, the boundary pass, one thread a sorted point:
//      point i starts the voxels (u[i-1], u[i]] (u = the sorted ids clipped
//      to [-1, num_voxels]), so starts[v] = the first sorted point of voxel
//      v for every v in [0, num_voxels], in O(P + V); a warp writes its
//      lanes' spans together, 32 entries a store, so a run of empty voxels
//      does not hold one thread. Sentinel points (id >= num_voxels) lie past
//      starts[num_voxels], points with a negative id before starts[0]: both
//      are dropped, as searchsorted's bounds drop them. The same pass reads each
//      in-grid point's depth and pixel through the sort's order and writes
//      them packed in sorted order (8 bytes a point, one coalesced read
//      later). The plain twin of the starts is torch.searchsorted
//      (ops/bev_pool_pallas.py).
//   2. bev_pool_slices_kernel, the long intervals (more than LONG points;
//      at the flagship the points per non-empty voxel average 2.5 with a
//      tail to 828, which one walker would take in 828 dependent steps):
//      one warp per slice of SL sorted points sums each long voxel's points
//      in the slice, the warp's 8 groups of 4 lanes taking every 8th point
//      and their partial sums combined by a fixed xor tree. A long voxel
//      inside one slice is written out; otherwise the slice keeps its
//      partial sum, as the slice's first (voxel begun in an earlier slice)
//      or last (voxel going on past it).
//   3. bev_pool_kernel, every voxel: 4 lanes own a voxel (lane q holds the
//      16-byte channel vectors q, q + 4, ...: 8 channels each), 8 voxels a
//      warp. A short interval is walked by its group, STEP points a step,
//      each point's packed depth and pixel loaded once for the group and
//      shuffled, the feature loads of a step independent. A long voxel that
//      spans slices sums its slices' partials in slice order. f32
//      accumulation, one rounding to bf16, 16-byte stores; an empty voxel
//      writes zeros.
// Every sum runs in a fixed order, with no atomics: bit-identical run to
// run. The TPU kernel's one-hot MXU contraction and lane packing are not
// carried over.
//
// Bound on H100: bytes -- the bf16 output (41 MB at the flagship's 640,000
// voxels x 32 channels), and per in-grid point its order, depth and pixel;
// the feature rows (64 B at C = 32) are 1 MB and stay in L2. What costs
// time is latency: each step is a chain of dependent loads (interval,
// point, feature row), so the design keeps every chain short and many in
// flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace pw {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL = 0xffffffffu;
constexpr int LONG = 16;  // longer intervals are summed by slices
constexpr int SL = 64;    // sorted points per slice

__global__ void bev_pool_starts_kernel(const int* __restrict__ ids,
                                       const long long* __restrict__ order,
                                       const bf16* __restrict__ depth,
                                       const int* __restrict__ pix, int P, int V,
                                       int* __restrict__ starts, int2* __restrict__ pts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = -1;  // the voxels [lo, hi] whose first point is i
  if (i <= P) {
    const int id = i == P ? V : max(min(ids[i], V), -1);
    lo = (i == 0 ? -1 : max(min(ids[i - 1], V), -1)) + 1;
    hi = id;
    if (id >= 0 && id < V) {
      const long long o = order[i];
      pts[i] = make_int2(pix[o], (int)__bfloat16_as_ushort(depth[o]));
    }
  }
  unsigned todo = __ballot_sync(FULL, hi >= lo);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int a = __shfl_sync(FULL, lo, src), b = __shfl_sync(FULL, hi, src);
    const int first = __shfl_sync(FULL, (int)i, src);
    for (int v = a + lane; v <= b; v += 32) starts[v] = first;
  }
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float depth_of(const int2 pt) {
  return __uint_as_float((unsigned)pt.y << 16);
}

// acc[8] += d * (8 bf16 of r)
__device__ __forceinline__ void fma8(float* acc, float d, const uint4 r) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(d, __uint_as_float(w[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(d, __uint_as_float(w[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

// this lane's channel vectors of feature row px, zero where invalid
template <int VPL>
__device__ __forceinline__ void load_feat(const bf16* feat, int px, bool valid, int q, int C,
                                          uint4 (&f)[VPL]) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (4 * k + q) * 8;
    f[k] = valid && c < C ? ldg16(feat + (size_t)px * C + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

template <int VPL>
__device__ __forceinline__ void store_bf16(bf16* row, const float (&acc)[VPL][8], int q, int C) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (4 * k + q) * 8;
    if (c < C) {
      uint4 w;
      unsigned* u = reinterpret_cast<unsigned*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(acc[k][2 * i], acc[k][2 * i + 1]);
        u[i] = *reinterpret_cast<const unsigned*>(&h);
      }
      *reinterpret_cast<uint4*>(row + c) = w;
    }
  }
}

template <int VPL>
__device__ __forceinline__ void store_f32(float* row, const float (&acc)[VPL][8], int q, int C) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (4 * k + q) * 8;
    if (c < C) {
      float4* d = reinterpret_cast<float4*>(row + c);
      d[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      d[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
}

template <int VPL>
__device__ __forceinline__ void add_f32(float (&acc)[VPL][8], const float* row, int q, int C) {
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (4 * k + q) * 8;
    if (c < C) {
      const float4* s = reinterpret_cast<const float4*>(row + c);
      const float4 a = __ldg(s), b = __ldg(s + 1);
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[k][i] += x[i];
    }
  }
}

// one warp per slice of SL sorted points: the long voxels' sums in it.
// first / last: (slices, C) f32 partial sums
template <int VPL>
__global__ void __launch_bounds__(256)
    bev_pool_slices_kernel(const int* __restrict__ ids, const int2* __restrict__ pts,
                           const int* __restrict__ starts, const bf16* __restrict__ feat,
                           bf16* __restrict__ out, float* __restrict__ first,
                           float* __restrict__ last, int V, int C) {
  const int lane = threadIdx.x & 31;
  const int q = lane & 3, r = lane >> 2;
  const long long k = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int pin = starts[V];
  const long long A = k * SL;
  if (A >= pin) return;
  // lane l holds the slice's points A + l and A + 32 + l
  int2 pt[2];
  int sv[2], se[2], vid[2];
  unsigned heads[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const long long p = A + 32 * m + lane;
    vid[m] = p < pin ? ids[p] : V;
    pt[m] = p < pin ? pts[p] : make_int2(0, 0);
    sv[m] = se[m] = 0;
    if (vid[m] >= 0 && vid[m] < V) {
      sv[m] = starts[vid[m]];
      se[m] = starts[vid[m] + 1];
    }
    // the first point in this slice of a long voxel
    heads[m] = __ballot_sync(FULL, se[m] - sv[m] > LONG && (p == A || p == sv[m]));
  }
  unsigned long long todo = heads[0] | (unsigned long long)heads[1] << 32;
  while (todo) {
    const int j = __ffsll(todo) - 1;
    todo &= todo - 1;
    const int hi = j >> 5;
    const int v = __shfl_sync(FULL, hi ? vid[1] : vid[0], j & 31);
    const int s = __shfl_sync(FULL, hi ? sv[1] : sv[0], j & 31);
    const int e = __shfl_sync(FULL, hi ? se[1] : se[0], j & 31);
    const int b = (int)min((long long)e, A + SL) - (int)A;  // run [j, b) of the slice
    float part[VPL][8];
#pragma unroll
    for (int kk = 0; kk < VPL; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i) part[kk][i] = 0.f;
#pragma unroll
    for (int i0 = 0; i0 < SL / 8; i0 += 4) {
      uint4 f[4][VPL];
      float dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = j + r + 8 * (i0 + i);
        const int px0 = __shfl_sync(FULL, pt[0].x, jj & 31);
        const int px1 = __shfl_sync(FULL, pt[1].x, jj & 31);
        const int dy0 = __shfl_sync(FULL, pt[0].y, jj & 31);
        const int dy1 = __shfl_sync(FULL, pt[1].y, jj & 31);
        const int2 t = jj >> 5 ? make_int2(px1, dy1) : make_int2(px0, dy0);
        dd[i] = jj < b ? depth_of(t) : 0.f;
        load_feat<VPL>(feat, t.x, jj < b, q, C, f[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int kk = 0; kk < VPL; ++kk) fma8(part[kk], dd[i], f[i][kk]);
    }
    // the groups' partial sums in a fixed tree (each level adds a
    // commutative pair, so every lane holds the same bits)
#pragma unroll
    for (int kk = 0; kk < VPL; ++kk)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) part[kk][i] += __shfl_xor_sync(FULL, part[kk][i], o);
    if (r == 0) {
      if (s >= A && e <= A + SL)
        store_bf16<VPL>(out + (size_t)v * C, part, q, C);
      else
        store_f32<VPL>((s < A ? first : last) + (size_t)k * C, part, q, C);
    }
  }
}

// STEP points a step of a short interval (mean 2.5 at the flagship); at C
// <= 32 a block caps its registers so that four fit an SM
template <int VPL>
__global__ void __launch_bounds__(256, VPL == 1 ? 4 : 1)
    bev_pool_kernel(const int2* __restrict__ pts, const int* __restrict__ starts,
                    const bf16* __restrict__ feat, const float* __restrict__ first,
                    const float* __restrict__ last, bf16* __restrict__ out, int V, int C) {
  constexpr int STEP = 4;
  const int lane = threadIdx.x & 31;
  const int q = lane & 3, r = lane >> 2;  // lane in the voxel's group, group in the warp
  const unsigned gmask = 0xfu << (4 * r);
  const long long v = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 8 + r;
  if (v >= V) return;  // whole groups leave; the shuffles below stay in a group
  const int s = starts[v], e = starts[v + 1];
  float acc[VPL][8];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[k][i] = 0.f;

  if (e - s <= LONG) {
    for (int p0 = s; p0 < e; p0 += STEP) {
      int2 t[STEP / 4];
#pragma unroll
      for (int u = 0; u < STEP / 4; ++u) {
        const int p = p0 + 4 * u + q;
        t[u] = p < e ? pts[p] : make_int2(0, 0);
      }
      uint4 f[STEP][VPL];
      float dd[STEP];
#pragma unroll
      for (int j = 0; j < STEP; ++j) {
        const int px = __shfl_sync(gmask, t[j / 4].x, j % 4, 4);
        dd[j] = depth_of(make_int2(0, __shfl_sync(gmask, t[j / 4].y, j % 4, 4)));
        load_feat<VPL>(feat, px, p0 + j < e, q, C, f[j]);
      }
#pragma unroll
      for (int j = 0; j < STEP; ++j)
#pragma unroll
        for (int k = 0; k < VPL; ++k) fma8(acc[k], dd[j], f[j][k]);
    }
  } else {
    const int k0 = s / SL, k1 = (e - 1) / SL;
    if (k0 == k1) return;  // the slice pass wrote it
    add_f32<VPL>(acc, last + (size_t)k0 * C, q, C);
    for (int k = k0 + 1; k <= k1; ++k) add_f32<VPL>(acc, first + (size_t)k * C, q, C);
  }
  store_bf16<VPL>(out + (size_t)v * C, acc, q, C);
}

template <int VPL>
void launch_pool(const int* ids, const int2* pts, const int* starts, const bf16* feat,
                 float* first, float* last, bf16* out, int P, int V, int C,
                 cudaStream_t stream) {
  // no points: no slices; no voxels: nothing to write
  const long long slice_threads = ((long long)P + SL - 1) / SL * 32;
  if (slice_threads > 0)
    bev_pool_slices_kernel<VPL><<<(unsigned)((slice_threads + 255) / 256), 256, 0, stream>>>(
        ids, pts, starts, feat, out, first, last, V, C);
  const long long threads = ((long long)V + 7) / 8 * 32;
  if (threads > 0)
    bev_pool_kernel<VPL><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        pts, starts, feat, first, last, out, V, C);
}

}  // namespace pw

// Slices of the long-interval pass for P points (the partial-sum scratch
// holds 2 x this x C f32).
extern "C" int pw_bev_pool_slices(int P) { return (P + pw::SL - 1) / pw::SL; }

// ids: (P,) int32 voxel ids sorted ascending; order: (P,) int64, the sort's
// permutation of the points; depth (P,) bf16 and pix (P,) int32 in the
// points' original order; feat: (num_pixels, C) bf16. Written: starts
// (V + 1,) int32, the interval starts; pts (P, 2) int32 scratch (packed
// pixel and depth in sorted order); parts (2, pw_bev_pool_slices(P), C) f32
// scratch; out (V, C) bf16. C % 8 == 0, C <= 256. Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for another C.
extern "C" int pw_bev_pool_intervals(const int* ids, const long long* order, const void* depth,
                                     const int* pix, const void* feat, int* starts, int* pts,
                                     float* parts, void* out, int P, int V, int C,
                                     void* stream_ptr) {
  if (C % 8 || C <= 0 || C > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  auto* packed = reinterpret_cast<int2*>(pts);
  pw::bev_pool_starts_kernel<<<(unsigned)(((long long)P + 256) / 256), 256, 0, stream>>>(
      ids, order, static_cast<const pw::bf16*>(depth), pix, P, V, starts, packed);
  const auto* f = static_cast<const pw::bf16*>(feat);
  auto* o = static_cast<pw::bf16*>(out);
  float* first = parts;
  float* last = parts + (size_t)pw_bev_pool_slices(P) * C;
  if (C <= 32)
    pw::launch_pool<1>(ids, packed, starts, f, first, last, o, P, V, C, stream);
  else if (C <= 64)
    pw::launch_pool<2>(ids, packed, starts, f, first, last, o, P, V, C, stream);
  else if (C <= 128)
    pw::launch_pool<4>(ids, packed, starts, f, first, last, o, P, V, C, stream);
  else
    pw::launch_pool<8>(ids, packed, starts, f, first, last, o, P, V, C, stream);
  return (int)cudaGetLastError();
}
