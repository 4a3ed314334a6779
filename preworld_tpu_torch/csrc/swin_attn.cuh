// Window-attention forward core shared by K1 (swin_block.cu) and K5 / K6
// (window_attn.cu), and the building blocks it shares with the backward
// core (swin_attn_bwd.cuh: K1b, K5b, K6b).
//
// One kernel computes softmax(q k^T d^-1/2 + mask + rel-bias) v per
// (window, head), templated on two things the callers differ in:
//   * an index map from (window, token) to the token's row in qkv (3C
//     wide) and in the output (C wide): ImageMap for the (B, Hp, Wp, .)
//     image layout, windows of the layout rolled by (-shift, -shift) (K1
//     reads its roll through the map; K6 takes qkv already rolled, shift
//     0), or PackedMap for windows packed as (Bn, N, .) (K5);
//   * a mask source: MASK_REGION, an (nW, N) region-id table (mask -100
//     where two tokens' ids differ, K1), MASK_DENSE, an additive (nW, N, N)
//     f32 mask (K5, K6), or MASK_NONE, a build without mask code that the
//     launchers take for a null mask.
// Built for head dim AT_D = 32 (every Swin-T/S/B/L stage) and windows of
// N <= AT_MAXN tokens with N % 16 == 0; the wrappers raise on anything else.
//
// Replaces the forward of preworld_tpu/ops/window_attn_pallas.py
// (_attn_kernel of fused_window_attention and band_window_attention) and
// the attention stage of swin_block_pallas.py::fused_swin_attn_block. The
// TPU kernels walk windows in an ordered grid with every head of a window
// in VMEM; on Hopper a block takes one head of a contiguous group of
// windows (the blocks of all heads of a group run side by side, so a
// window's token rows and dense mask come from L2 after the first head).
// One warp per 16-row query strip, N / 16 warps (nine at N = 144), so
// every warp is busy in one round. Per window, with mma.sync m16n8k16
// bf16 products (f32 sums) on ldmatrix fragments:
//   S = q k^T into registers (N / 8 n8 tiles, 72 f32 a thread at N =
//   144); scale, the head's bias (staged once per block in shared memory
//   in fragment order) and the mask added in registers; the row max and
//   sum by quad shuffles, expf in natural base as the plain version
//   computes it (a base-2 build moved chip_smoke.py's train-reference
//   gradient norm past its gate; PERF.md §6); each probability normalised
//   and rounded to bf16 where the TPU kernel rounds it, then repacked from
//   the accumulator pairs into A fragments of O = P v, with v read through
//   ldmatrix.trans: P never touches shared memory. O leaves through the
//   index map in 16-byte stores. q, k and v of window w + 1 are fetched
//   with cp.async into a second stage while window w computes.
//
// Bound on H100: the bytes of qkv read and the output written, 4 N d bf16
// per window and head, against 4 N^2 d tensor-core FLOP: at d = 32 and
// N = 144 about 144 FLOP a byte, under the card's ~295, so device memory
// binds. At N = 144 a block holds 139 KB of shared memory (the f32 bias,
// 83 KB, and two stages of q, k, v), so one block of nine warps runs per
// SM, which allows a thread up to 224 registers.
#pragma once

#include "gemm.cuh"

namespace pw {

constexpr int AT_D = 32;               // head dim of every Swin stage
constexpr int AT_MAXN = 144;           // tokens per window, at most
constexpr int AT_MAXW = AT_MAXN / 16;  // warps per block, at most
constexpr int AT_NT8 = AT_MAXN / 8;    // n8 score tiles per strip, at most
constexpr int AT_MPF = 4;              // dense-mask tiles loaded ahead of use

enum { MASK_REGION = 0, MASK_DENSE = 1, MASK_NONE = 2 };

// Window win = b nH nW + wr nW + wc of the rolled image layout; token
// t = i ws + j sits at image position ((wr ws + i + shift) mod Hp,
// (wc ws + j + shift) mod Wp). Its mask is that of window wr nW + wc.
struct ImageMap {
  int Hp, Wp, ws, shift, nH, nW;
  __device__ __forceinline__ int mask_win(int win) const { return win % (nH * nW); }
};

inline ImageMap image_map(int Hp, int Wp, int ws, int shift) {
  return {Hp, Wp, ws, shift, Hp / ws, Wp / ws};
}

// Token t of window win at row win N + t; its mask is mask[win mod nWm].
struct PackedMap {
  int N, nWm;
  __device__ __forceinline__ int mask_win(int win) const { return win % nWm; }
};

// Rows of a window's tokens with no division per token: the window's
// origin once, then each token's row from its place in the window.
struct WinOrigin {
  size_t base;
  int r, c;
};

__device__ __forceinline__ WinOrigin window_origin(const ImageMap& m, int win) {
  const int per_img = m.nH * m.nW;
  const int b = win / per_img, wi = win - b * per_img;
  const int wr = wi / m.nW, wc = wi - wr * m.nW;
  return {(size_t)b * m.Hp, wr * m.ws + m.shift, wc * m.ws + m.shift};
}

// the image row of token t: t / ws in f32 (exact for t < 2^16), the roll's
// wrap as one subtraction
__device__ __forceinline__ size_t token_row(const ImageMap& m, const WinOrigin& o, int t) {
  const int i = __float2int_rz(((float)t + 0.5f) * __frcp_rn((float)m.ws));
  int r = o.r + i, c = o.c + t - i * m.ws;
  if (r >= m.Hp) r -= m.Hp;
  if (c >= m.Wp) c -= m.Wp;
  return (o.base + r) * m.Wp + c;
}

__device__ __forceinline__ WinOrigin window_origin(const PackedMap& m, int win) {
  return {(size_t)win * m.N, 0, 0};
}

__device__ __forceinline__ size_t token_row(const PackedMap&, const WinOrigin& o, int t) {
  return o.base + t;
}

// K1's qkv and attention kernels (swin_block.cu): the LN1 + pad-zeroing +
// qkv product (gemm_sm90.cuh) from the per-row `stats` that ln_stats wrote,
// into qkv (M, 3C), then window attention into o (M, C), both bf16 in image
// order. Returns the first launch error.
cudaError_t attn_qkv_o(const bf16* x, const float* stats, const float* ln_w, const float* ln_b,
                       const bf16* wqkv, const float* bqkv, const float* rel_bias,
                       const int* region, bf16* qkv, bf16* o, int B, int Hp, int Wp, int C,
                       int heads, int ws, int H, int W, int shift, float scale,
                       cudaStream_t stream);

struct AttnPlan {
  int groups, per;
};

// windows per block: about 264 (head, group) blocks, two waves of one
// block per SM at N = 144
inline AttnPlan attn_plan(int windows, int heads) {
  int g = (264 + heads - 1) / heads;
  if (g > windows) g = windows;
  if (g < 1) g = 1;
  const int per = (windows + g - 1) / g;
  return {(windows + per - 1) / per, per};
}

// byte offset of 16-byte chunk c of row t in a swizzled 64-byte-row tile
__device__ __forceinline__ uint32_t swz(int t, int c) {
  return (uint32_t)(t * 64 + ((c ^ ((t >> 1) & 3)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c += a b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments (16 rows x 32 channels, two k16 steps) of rows [r0, r0 + 16)
// of a swizzled tile
__device__ __forceinline__ void load_a32(uint32_t (&a)[2][4], uint32_t tile, int r0, int lane) {
  const int t = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) ldsm4(a[kc], tile + swz(t, kc * 2 + (lane >> 4)));
}

// B fragments of an n8 tile whose columns are rows [n0, n0 + 8) of a
// swizzled tile (B = tile^T): {b0, b1} of k16 step 0, then of step 1
__device__ __forceinline__ void load_bt32(uint32_t (&b)[4], uint32_t tile, int n0, int lane) {
  ldsm4(b, tile + swz(n0 + (lane & 7), lane >> 3));
}

// B fragments for the k16 step of rows [k0, k0 + 16) of a swizzled tile
// read as (k, n): b[2 nd + 0/1] for n8 tile nd of its 32 channels
__device__ __forceinline__ void load_bk16(uint32_t (&b)[8], uint32_t tile, int k0, int lane) {
  const int t = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t r[4];
    ldsm4t(r, tile + swz(t, half * 2 + (lane >> 4)));
    b[half * 4 + 0] = r[0];
    b[half * 4 + 1] = r[1];
    b[half * 4 + 2] = r[2];
    b[half * 4 + 3] = r[3];
  }
}

// A 16 x 32 f32 accumulator tile (four n8 tiles), times s, rounded to bf16,
// to rows rows[0] (the thread's first row) and rows[1] (8 below it) of
// `dst` (rows of ldd) at column col0: the quad swaps its words so that each
// thread stores 16 bytes.
__device__ __forceinline__ void store_tile(const float (&acc)[4][4], float s, bf16* dst,
                                           size_t ldd, int col0, const size_t (&rows)[2],
                                           int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t w[4], o[4];
#pragma unroll
    for (int nd = 0; nd < 4; ++nd)
      w[nd] = pack_bf16(s * acc[nd][2 * half], s * acc[nd][2 * half + 1]);
    // thread tig gathers word tig of each quad lane: channels 8 tig..8 tig+7
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int give = (tig - k) & 3, from = (tig + k) & 3;
      const uint32_t send = give == 0 ? w[0] : give == 1 ? w[1] : give == 2 ? w[2] : w[3];
      const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | from);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (m == from) o[m] = got;
    }
    *reinterpret_cast<uint4*>(dst + rows[half] * ldd + col0 + tig * 8) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Shared-memory layout of the forward block for windows of N tokens: the
// head's f32 bias in fragment order (float4 f of warp w, n8
// tile j, lane l at (w nt8 + j) 32 + l holds the thread's four elements of
// that tile), then two stages each of the q, k and v tiles (N rows of 64
// bytes whose four 16-byte chunks are XOR-swizzled by row, for ldmatrix
// without bank conflicts) and of the region ids.
struct AttnSmem {
  uint32_t tile, bias, q, k, v, reg, total;
  __host__ __device__ AttnSmem(int n) {
    tile = (uint32_t)n * AT_D * 2;
    bias = 0;
    q = bias + (uint32_t)n * n * 4;  // each of q, k, v: two stages
    k = q + 2 * tile;
    v = k + 2 * tile;
    reg = v + 2 * tile;  // two stages of n ints
    total = reg + (uint32_t)n * 8;
  }
};

template <class Map, int MASK>
__global__ void __launch_bounds__(AT_MAXW * 32, 1)
window_attn_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel_bias,
                   const void* __restrict__ mask, bf16* __restrict__ out, Map map, int windows,
                   int C, int N, float scale, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnSmem L(N);
  const float4* biasF = reinterpret_cast<const float4*>(smem + L.bias);
  const uint32_t sbase = smem_u32(smem);

  const int h = blockIdx.x, g = blockIdx.y;
  const int nt = N / 16, nt8 = N / 8, threads = nt * 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;  // the warp's query rows
  constexpr bool dense = MASK == MASK_DENSE;
  const size_t C3 = 3 * (size_t)C;
  const int w0 = g * per, w1 = min(windows, w0 + per);

  // q, k, v (and region ids) of window `win` into stage b
  auto load = [&](int win, int b) {
    const WinOrigin o = window_origin(map, win);
    for (int idx = tid; idx < N * 4; idx += threads) {
      const int t = idx >> 2, c = idx & 3;
      const bf16* src = qkv + token_row(map, o, t) * C3 + h * AT_D + c * 8;
      const uint32_t dst = sbase + b * L.tile + swz(t, c);
      cp_async16(dst + L.q, src);
      cp_async16(dst + L.k, src + C);
      cp_async16(dst + L.v, src + 2 * C);
    }
    if (MASK == MASK_REGION)
      for (int t = tid; t < N; t += threads)
        cp_async4(sbase + L.reg + (b * N + t) * 4,
                  static_cast<const int*>(mask) + (size_t)map.mask_win(win) * N + t);
  };

  if (w0 < w1) load(w0, 0);
  cp_async_commit();
  {
    // element (r, c) to word 4 ((w nt8 + j) 32 + 4 gq + tig) + 2 hi + lo
    // for r = 16 w + 8 hi + gq, c = 8 j + 2 tig + lo
    const float* bh = rel_bias + (size_t)h * N * N;
    float* bs = reinterpret_cast<float*>(smem + L.bias);
    for (int r = warp; r < N; r += nt) {
      const int rb = (r >> 4) * nt8 * 128 + (r & 7) * 16 + ((r >> 3) & 1) * 2;
      for (int c = lane; c < N; c += 32)
        bs[rb + (c >> 3) * 128 + ((c & 7) >> 1) * 4 + (c & 1)] = bh[(size_t)r * N + c];
    }
  }

  for (int win = w0; win < w1; ++win) {
    const int b = (win - w0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (win + 1 < w1) load(win + 1, b ^ 1);
    cp_async_commit();

    const uint32_t Qt = sbase + L.q + b * L.tile, Kt = sbase + L.k + b * L.tile;
    const uint32_t Vt = sbase + L.v + b * L.tile;
    // a dense mask's pairs of the thread's two rows, AT_MPF tiles ahead of
    // their use (registers cycle through mq[j % AT_MPF])
    const float* mw = nullptr;
    float2 mq[AT_MPF][2];
    if (dense) {
      mw = static_cast<const float*>(mask) + (size_t)map.mask_win(win) * N * N +
           (size_t)(r0 + gq) * N + 2 * tig;
#pragma unroll
      for (int j = 0; j < AT_MPF; ++j)
        if (j < nt8)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mq[j][i] = *reinterpret_cast<const float2*>(mw + (size_t)8 * i * N + 8 * j);
    }
    int rg[2] = {0, 0};
    const int* reg = reinterpret_cast<const int*>(smem + L.reg) + b * N;
    if (MASK == MASK_REGION) {
      rg[0] = reg[r0 + gq];
      rg[1] = reg[r0 + gq + 8];
    }

    // logits l = scale q.k^T + bias + mask in registers: s[j][e] at row
    // r0 + gq + 8 (e >> 1), column 8 j + 2 tig + (e & 1)
    float s[AT_NT8][4];
    float mx[2] = {-INFINITY, -INFINITY};
    {
      uint32_t qa[2][4];
      load_a32(qa, Qt, r0, lane);
#pragma unroll
      for (int j = 0; j < AT_NT8; ++j) {
        if (j < nt8) {
          uint32_t kb[4];
          load_bt32(kb, Kt, j * 8, lane);
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(acc, qa[0], kb[0], kb[1]);
          mma16816(acc, qa[1], kb[2], kb[3]);
          const float4 bv = biasF[(warp * nt8 + j) * 32 + lane];
          float l[4] = {fmaf(acc[0], scale, bv.x), fmaf(acc[1], scale, bv.y),
                        fmaf(acc[2], scale, bv.z), fmaf(acc[3], scale, bv.w)};
          if (dense) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              l[2 * i] += mq[j % AT_MPF][i].x;
              l[2 * i + 1] += mq[j % AT_MPF][i].y;
            }
            if (j + AT_MPF < nt8)
#pragma unroll
              for (int i = 0; i < 2; ++i)
                mq[j % AT_MPF][i] =
                    *reinterpret_cast<const float2*>(mw + (size_t)8 * i * N + 8 * (j + AT_MPF));
          }
          if (MASK == MASK_REGION) {
            const int2 rc = *reinterpret_cast<const int2*>(reg + j * 8 + 2 * tig);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              if (rg[i] != rc.x) l[2 * i] += -100.f;
              if (rg[i] != rc.y) l[2 * i + 1] += -100.f;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = l[e];
          mx[0] = fmaxf(mx[0], fmaxf(l[0], l[1]));
          mx[1] = fmaxf(mx[1], fmaxf(l[2], l[3]));
        }
      }
    }
    // row maxima and sums over the quad that shares a row
    float inv[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < AT_NT8; ++j) {
      if (j < nt8) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - mx[e >> 1]);
          inv[e >> 1] += s[j][e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], 1);
      inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], 2);
      inv[i] = 1.f / inv[i];
    }

    // O = P v: P normalised, rounded to bf16 and repacked from the score
    // tiles 2 kk, 2 kk + 1 into the A fragment of k16 step kk
    float o[4][4];
#pragma unroll
    for (int nd = 0; nd < 4; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < AT_MAXW; ++kk) {
      if (kk < nt) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]),
                               pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]),
                               pack_bf16(s[2 * kk + 1][0] * inv[0], s[2 * kk + 1][1] * inv[0]),
                               pack_bf16(s[2 * kk + 1][2] * inv[1], s[2 * kk + 1][3] * inv[1])};
        uint32_t vb[8];
        load_bk16(vb, Vt, kk * 16, lane);
#pragma unroll
        for (int nd = 0; nd < 4; ++nd) mma16816(o[nd], a, vb[2 * nd], vb[2 * nd + 1]);
      }
    }
    size_t rows[2];
    {
      const WinOrigin wo = window_origin(map, win);
      rows[0] = token_row(map, wo, r0 + gq);
      rows[1] = token_row(map, wo, r0 + gq + 8);
    }
    store_tile(o, 1.f, out, C, h * AT_D, rows, lane);
  }
  cp_async_wait_all();
}

// Launch the forward core over `windows` windows and `heads` heads of N
// tokens; `mask` is an int region table (MASK_REGION), an f32 (nW, N, N)
// mask (MASK_DENSE) or null (the MASK_NONE build). Returns the first CUDA
// error.
template <class Map, int MASK>
inline cudaError_t window_attn(const bf16* qkv, const float* rel_bias, const void* mask,
                               bf16* out, Map map, int windows, int heads, int C, int N,
                               float scale, cudaStream_t stream) {
  if constexpr (MASK != MASK_NONE)
    if (mask == nullptr)
      return window_attn<Map, MASK_NONE>(qkv, rel_bias, mask, out, map, windows, heads, C, N,
                                         scale, stream);
  const AttnSmem L(N);
  void (*kern)(const bf16*, const float*, const void*, bf16*, Map, int, int, int, float, int) =
      window_attn_kernel<Map, MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const AttnPlan plan = attn_plan(windows, heads);
  kern<<<dim3(heads, plan.groups), N / 16 * 32, L.total, stream>>>(qkv, rel_bias, mask, out, map,
                                                                   windows, C, N, scale, plan.per);
  return cudaGetLastError();
}

}  // namespace pw
