// Window-attention backward core shared by K1b (swin_block_bwd.cu) and
// K5b / K6b (window_attn_bwd.cu), on the index maps and mask sources of
// the forward core (swin_attn.cuh).
//
// One block per (head, contiguous group of windows), one warp per 16-row
// strip of the window: N / 16 warps (nine at N = 144), so each phase runs
// in one round with every warp busy. The blocks of all heads of a group
// run side by side, so a window's mask and token rows come from L2 after
// the first head. Per window, with mma.sync m16n8k16 bf16 products (f32
// sums) on ldmatrix fragments:
//   row pass (warp = 16 query rows): S = q k^T d^-1/2 + mask + rel-bias
//     in f32 (base 2), its row maxima by quad shuffles; one sweep of
//     dP = dO v^T for the row sums of P and D = rowsum(P o dP) (as the TPU
//     kernel: no O = P V recompute); a second for dS = P o (dP - D), added
//     to the thread's own registers of the d rel-bias partial, with P
//     (rounded to bf16 as the forward rounds it) and dS staged in shared
//     memory; then dQ = dS K d^-1/2 from the warp's own rows of dS;
//   column pass (warp = 16 keys): dV = P^T dO and dK = dS^T Q d^-1/2 from
//     the staged P and dS (ldmatrix.trans).
// Between the sweeps the f32 logits wait in the warp's own rows of the P /
// dS staging, each in a word that only its thread reads and overwrites, so
// the registers hold the d-bias partial and no score strip. q and dO of
// window w + 1 are fetched with cp.async into a second stage while window
// w computes, k and v of w + 1 during w's column pass. The head's relative
// bias is read once per block into shared memory; a dense mask once per
// window and head, by the threads that add it, four tiles ahead of use.
// Each element of the (N, N) d-bias partial stays with the same thread for
// the whole window range, summed in window order, and is written once at
// the end to a (groups, heads, N, N) f32 buffer; one reduce_parts launch
// sums it over groups in a fixed order. No float atomics, identical bits
// run to run. A null mask runs a build without mask code (MASK_NONE).
//
// Bound on H100: the bytes of qkv, dO and dqkv (7 N d bf16 per window and
// head, against 10 N^2 d tensor-core FLOP: about three times the operation
// bound at every Swin shape). At N = 144 a block holds 226 KB of shared
// memory (the bias, the P / dS staging, two stages of q and dO, k and v),
// so one block of nine warps runs per SM; three of them share one of the
// SM's four schedulers, which caps a thread at 168 registers (72 of them
// the d-bias partial). A dense mask adds N^2 f32 per window and head, read
// from L2: the largest stream of a masked call.
#pragma once

#include "swin_attn.cuh"

namespace pw {

constexpr float AT_LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared-memory layout of the backward block for windows of N tokens.
// q / k / v / dO tiles are N rows of 64 bytes whose four 16-byte chunks
// are XOR-swizzled by row (ldmatrix without bank conflicts); the rows of
// the f32 bias and of the bf16 P / dS are ld = n + 8 elements apart for the
// same reason.
struct AttnBwdSmem {
  int ld;
  uint32_t tile, bias, P, dS, q, dout, k, v, reg, total;
  __host__ __device__ AttnBwdSmem(int n) {
    ld = n + 8;
    tile = (uint32_t)n * AT_D * 2;
    bias = 0;
    P = bias + (uint32_t)n * ld * 4;
    dS = P + (uint32_t)n * ld * 2;
    q = dS + (uint32_t)n * ld * 2;  // two stages
    dout = q + 2 * tile;             // two stages
    k = dout + 2 * tile;
    v = k + tile;
    reg = v + tile;  // two stages of n ints
    total = reg + (uint32_t)n * 8;
  }
};

// f32 elements of the d rel-bias partial buffer
inline long long attn_bwd_part_elems(int windows, int heads, int N) {
  return (long long)heads * attn_plan(windows, heads).groups * N * N;
}

// A fragment of a 16 x 16 block of a padded bf16 matrix (rows [r0, r0 +
// 16), columns [c0, c0 + 16), row stride ld elements)
__device__ __forceinline__ void load_a16(uint32_t (&a)[4], const bf16* m, int ld, int r0, int c0,
                                         int lane) {
  const int r = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = c0 + (lane >> 4) * 8;
  ldsm4(a, smem_u32(m + (size_t)r * ld + c));
}

// A fragment of the transpose of a 16 x 16 block of a padded bf16 matrix
// (rows [r0, r0 + 16), columns [c0, c0 + 16), row stride ld elements)
__device__ __forceinline__ void load_at16(uint32_t (&a)[4], const bf16* m, int ld, int r0, int c0,
                                          int lane) {
  const int r = r0 + (lane & 7) + (lane >> 4) * 8;
  const int c = c0 + ((lane >> 3) & 1) * 8;
  ldsm4t(a, smem_u32(m + (size_t)r * ld + c));
}

template <class Map, int MASK>
__global__ void __launch_bounds__(AT_MAXW * 32, 1)
window_attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       const float* __restrict__ rel_bias, const void* __restrict__ mask,
                       bf16* __restrict__ dqkv, float* __restrict__ dbias_part, Map map,
                       int windows, int heads, int C, int N, float scale, int per) {
  extern __shared__ __align__(128) unsigned char smem[];
  const AttnBwdSmem L(N);
  const float* biasS = reinterpret_cast<const float*>(smem + L.bias);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L.P);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L.dS);
  const uint32_t sbase = smem_u32(smem);

  // all heads of one group of windows run side by side: their masks and
  // token rows are read once from device memory, then from L2
  const int h = blockIdx.x, g = blockIdx.y;
  const int nt = N / 16, nt8 = N / 8, threads = nt * 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tig = lane & 3;
  const int r0 = warp * 16;  // the warp's query rows (row pass), keys (column pass)
  constexpr bool dense = MASK == MASK_DENSE;
  const size_t C3 = 3 * (size_t)C;
  const int w0 = g * per, w1 = min(windows, w0 + per);
  // the f32 logits of a row wait in the warp's own rows of the P / dS
  // staging, where its bf16 P and dS go later: (r, 8 j + 2 tig) in word
  // 4 j + tig of P's row r, (r, 8 j + 2 tig + 1) in that word of dS's, so
  // each thread overwrites only words it has read itself
  uint32_t* Pw = reinterpret_cast<uint32_t*>(Ps);
  uint32_t* Dw = reinterpret_cast<uint32_t*>(dSs);
  const int H = L.ld / 2;                   // words of a staging row
  const int slot = (r0 + gq) * H + tig;     // (row r0 + gq, tile 0); row + 8 at 8 H

  // q and dO (and region ids) of window `win` into stage b; k and v
  auto load_qdo = [&](int win, int b) {
    const WinOrigin o = window_origin(map, win);
    for (int idx = tid; idx < N * 8; idx += threads) {
      const int t = idx >> 3, which = (idx >> 2) & 1, c = idx & 3;
      const size_t tok = token_row(map, o, t);
      const bf16* src = which == 0 ? qkv + tok * C3 + h * AT_D + c * 8
                                   : dout + tok * C + h * AT_D + c * 8;
      cp_async16(sbase + (which == 0 ? L.q : L.dout) + b * L.tile + swz(t, c), src);
    }
    if (MASK == MASK_REGION)
      for (int t = tid; t < N; t += threads)
        cp_async4(sbase + L.reg + (b * N + t) * 4,
                  static_cast<const int*>(mask) + (size_t)map.mask_win(win) * N + t);
  };
  auto load_kv = [&](int win) {
    const WinOrigin o = window_origin(map, win);
    for (int idx = tid; idx < N * 8; idx += threads) {
      const int t = idx >> 3, which = (idx >> 2) & 1, c = idx & 3;
      const bf16* src = qkv + token_row(map, o, t) * C3 + (1 + which) * C + h * AT_D + c * 8;
      cp_async16(sbase + (which == 0 ? L.k : L.v) + swz(t, c), src);
    }
  };

  if (w0 < w1) {
    load_qdo(w0, 0);
    load_kv(w0);
  }
  cp_async_commit();
  {
    const float* bh = rel_bias + (size_t)h * N * N;
    float* bs = reinterpret_cast<float*>(smem + L.bias);
    for (int i = tid; i < N * N; i += threads) bs[(i / N) * L.ld + i % N] = bh[i];
  }

  // d rel-bias partial: element (r0 + gq + 8 (e >> 1), 8 j + 2 tig + (e & 1))
  float dbias[AT_NT8][4];
#pragma unroll
  for (int j = 0; j < AT_NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbias[j][e] = 0.f;

  for (int win = w0; win < w1; ++win) {
    const int b = (win - w0) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (win + 1 < w1) load_qdo(win + 1, b ^ 1);
    cp_async_commit();

    // ---- row pass: query rows [r0, r0 + 16)
    const uint32_t Qt = sbase + L.q + b * L.tile, Dt = sbase + L.dout + b * L.tile;
    const uint32_t Kt = sbase + L.k, Vt = sbase + L.v;
    // logits l = (scale q.k^T + mask + bias) log2(e) tile by tile into the
    // staging, and their row maxima; rows r0 + gq (i = 0), r0 + gq + 8 (1)
    float mx[2] = {-INFINITY, -INFINITY};
    {
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
      uint32_t qa[2][4];
      load_a32(qa, Qt, r0, lane);
#pragma unroll
      for (int j = 0; j < AT_NT8; ++j) {
        if (j < nt8) {
          uint32_t kb[4];
          load_bt32(kb, Kt, j * 8, lane);
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(s, qa[0], kb[0], kb[1]);
          mma16816(s, qa[1], kb[2], kb[3]);
          const int c = j * 8 + 2 * tig;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = r0 + gq + 8 * i;
            float l0 = s[2 * i] * scale, l1 = s[2 * i + 1] * scale;
            if (dense) {
              l0 += mq[j % AT_MPF][i].x;
              l1 += mq[j % AT_MPF][i].y;
            }
            if (MASK == MASK_REGION) {
              const int2 rc = *reinterpret_cast<const int2*>(reg + c);
              if (rg[i] != rc.x) l0 += -100.f;
              if (rg[i] != rc.y) l1 += -100.f;
            }
            const float2 bv = *reinterpret_cast<const float2*>(biasS + r * L.ld + c);
            l0 = (l0 + bv.x) * AT_LOG2E;
            l1 = (l1 + bv.y) * AT_LOG2E;
            Pw[slot + 8 * i * H + 4 * j] = __float_as_uint(l0);
            Dw[slot + 8 * i * H + 4 * j] = __float_as_uint(l1);
            mx[i] = fmaxf(mx[i], fmaxf(l0, l1));
          }
          if (dense && j + AT_MPF < nt8)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              mq[j % AT_MPF][i] =
                  *reinterpret_cast<const float2*>(mw + (size_t)8 * i * N + 8 * (j + AT_MPF));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      }
    }

    // one sweep over dP = dO v^T: the row sums of e = 2^(l - max) and of
    // e o dP; normalised, 1 / sum and D = rowsum(P o dP)
    uint32_t da[2][4];
    load_a32(da, Dt, r0, lane);
    float inv[2] = {0.f, 0.f}, Drow[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < AT_NT8; ++j) {
      if (j < nt8) {
        uint32_t vb[4];
        load_bt32(vb, Vt, j * 8, lane);
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(dp, da[0], vb[0], vb[1]);
        mma16816(dp, da[1], vb[2], vb[3]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float e0 = fast_exp2(__uint_as_float(Pw[slot + 8 * i * H + 4 * j]) - mx[i]);
          const float e1 = fast_exp2(__uint_as_float(Dw[slot + 8 * i * H + 4 * j]) - mx[i]);
          inv[i] += e0 + e1;
          Drow[i] += e0 * dp[2 * i] + e1 * dp[2 * i + 1];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], 1);
      inv[i] += __shfl_xor_sync(0xffffffffu, inv[i], 2);
      Drow[i] += __shfl_xor_sync(0xffffffffu, Drow[i], 1);
      Drow[i] += __shfl_xor_sync(0xffffffffu, Drow[i], 2);
      inv[i] = 1.f / inv[i];
      Drow[i] *= inv[i];
    }

    // dS = P o (dP - D), P and dP formed again: into the d-bias partial;
    // P (rounded to bf16 as the forward rounds it) and dS over the logits
#pragma unroll
    for (int j = 0; j < AT_NT8; ++j) {
      if (j < nt8) {
        uint32_t vb[4];
        load_bt32(vb, Vt, j * 8, lane);
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(dp, da[0], vb[0], vb[1]);
        mma16816(dp, da[1], vb[2], vb[3]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int w = slot + 8 * i * H + 4 * j;
          const float p0 = fast_exp2(__uint_as_float(Pw[w]) - mx[i]) * inv[i];
          const float p1 = fast_exp2(__uint_as_float(Dw[w]) - mx[i]) * inv[i];
          const float ds0 = p0 * (dp[2 * i] - Drow[i]), ds1 = p1 * (dp[2 * i + 1] - Drow[i]);
          dbias[j][2 * i] += ds0;
          dbias[j][2 * i + 1] += ds1;
          Pw[w] = pack_bf16(p0, p1);
          Dw[w] = pack_bf16(ds0, ds1);
        }
      }
    }
    __syncwarp();

    // the rows of the warp's 16 tokens: queries here, keys in the column pass
    size_t rows[2];
    {
      const WinOrigin o = window_origin(map, win);
      rows[0] = token_row(map, o, r0 + gq);
      rows[1] = token_row(map, o, r0 + gq + 8);
    }

    // dQ = dS K d^-1/2 from the warp's own rows of the staged dS
    {
      float dq[4][4];
#pragma unroll
      for (int nd = 0; nd < 4; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < AT_MAXW; ++kk) {
        if (kk < nt) {
          uint32_t a[4], kb[8];
          load_a16(a, dSs, L.ld, r0, kk * 16, lane);
          load_bk16(kb, Kt, kk * 16, lane);
#pragma unroll
          for (int nd = 0; nd < 4; ++nd) mma16816(dq[nd], a, kb[2 * nd], kb[2 * nd + 1]);
        }
      }
      store_tile(dq, scale, dqkv, C3, h * AT_D, rows, lane);
    }
    __syncthreads();
    if (win + 1 < w1) load_kv(win + 1);
    cp_async_commit();

    // ---- column pass: keys [r0, r0 + 16); dV = P^T dO, dK = dS^T Q
    {
      float dv[4][4], dk[4][4];
#pragma unroll
      for (int nd = 0; nd < 4; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[nd][e] = dk[nd][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < AT_MAXW; ++kk) {
        if (kk < nt) {
          uint32_t a[4], bb[8];
          load_at16(a, Ps, L.ld, kk * 16, r0, lane);
          load_bk16(bb, Dt, kk * 16, lane);
#pragma unroll
          for (int nd = 0; nd < 4; ++nd) mma16816(dv[nd], a, bb[2 * nd], bb[2 * nd + 1]);
          load_at16(a, dSs, L.ld, kk * 16, r0, lane);
          load_bk16(bb, Qt, kk * 16, lane);
#pragma unroll
          for (int nd = 0; nd < 4; ++nd) mma16816(dk[nd], a, bb[2 * nd], bb[2 * nd + 1]);
        }
      }
      store_tile(dv, 1.f, dqkv, C3, 2 * C + h * AT_D, rows, lane);
      store_tile(dk, scale, dqkv, C3, C + h * AT_D, rows, lane);
    }
  }
  cp_async_wait_all();

  float* dbp = dbias_part + ((size_t)g * heads + h) * N * N;
#pragma unroll
  for (int j = 0; j < AT_NT8; ++j) {
    if (j < nt8) {
      const int c = j * 8 + 2 * tig;
#pragma unroll
      for (int e = 0; e < 4; ++e) dbp[(size_t)(r0 + gq + 8 * (e >> 1)) * N + c + (e & 1)] =
          dbias[j][e];
    }
  }
}

// Launch the backward core over `windows` windows of N tokens, then reduce
// the (groups, heads, N, N) partial into drel (heads, N, N) in one launch.
// `part` holds attn_bwd_part_elems(windows, heads, N) floats; a null mask
// runs the MASK_NONE build. Returns the first CUDA error.
template <class Map, int MASK>
inline cudaError_t window_attn_bwd(const bf16* qkv, const bf16* dout, const float* rel_bias,
                                   const void* mask, bf16* dqkv, float* drel, float* part,
                                   Map map, int windows, int heads, int C, int N, float scale,
                                   cudaStream_t stream) {
  if constexpr (MASK != MASK_NONE)
    if (mask == nullptr)
      return window_attn_bwd<Map, MASK_NONE>(qkv, dout, rel_bias, mask, dqkv, drel, part, map,
                                             windows, heads, C, N, scale, stream);
  const AttnBwdSmem L(N);
  void (*kern)(const bf16*, const bf16*, const float*, const void*, bf16*, float*, Map, int, int,
               int, int, float, int) = window_attn_bwd_kernel<Map, MASK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  const AttnPlan plan = attn_plan(windows, heads);
  kern<<<dim3(heads, plan.groups), N / 16 * 32, L.total, stream>>>(
      qkv, dout, rel_bias, mask, dqkv, part, map, windows, heads, C, N, scale, plan.per);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_parts(part, drel, plan.groups, (long long)heads * N * N, stream);
  return cudaGetLastError();
}

}  // namespace pw
