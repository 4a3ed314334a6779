// K1b: backward of the Swin attention half-block (K1, swin_block.cu).
//
// Replaces preworld_tpu/ops/swin_block_pallas.py::_fused_swin_attn_block_bwd
// (the pallas_call of _blk_bwd_kernel, tied to the forward by
// fused_swin_attn_block_vjp). For out = x + rs * proj(WMSA(zeropad(LN1(x))))
// and a cotangent dY it gives dx (bf16) and, in f32, d ln (2, C), dWqkv
// (3C, C), dbqkv, dWproj (C, C), dbproj and d rel-bias (heads, N, N). The
// TPU kernel walks bands in an ordered grid and carries every weight
// gradient in VMEM from step to step; on Hopper the blocks run unordered,
// so the backward is a chain of launches, each sum over tokens split into
// fixed chunks and reduced in a fixed order (no float atomics: two runs
// give identical bits):
//   1. per-row LN1 statistics (rstd 0 marks a zeroed pad token);
//   2. recompute qkv and the attention output o with K1's own kernels;
//   3. dyb = bf16(rs * dY); dbproj = column sums of rs * dY;
//   4. dWproj = dyb^T o (split-M GEMM, gemm.cuh);
//   5. dO = dyb . Wproj (NN GEMM) into o's buffer;
//   6. window-attention backward: one block per (head, group of windows);
//      per window it gathers q, k, v, dO of its N tokens with the forward's
//      shift indexing, recomputes S and P per 16-row strip (region-id mask,
//      bias, P rounded to bf16 as in the forward), then
//        D_i = rowsum(dO o O) with O = P V,  dS = P o (dO V^T - D),
//        dQ = dS K d^-1/2 (row strips), dV = P^T dO, dK = dS^T Q d^-1/2
//      (column strips after a barrier), written to dqkv (M, 3C) in image
//      order. dS is added into the block's own (N, N) slice of a (heads,
//      groups, N, N) f32 partial buffer, each element always by the same
//      thread, then reduced over groups;
//   7. dbqkv = column sums of dqkv; dWqkv = dqkv^T LN1(x) (LN on the fly
//      from the step-1 statistics);
//   8. dyln = dqkv . Wqkv (NN GEMM, f32) into qkv's buffer;
//   9. LN1 backward with the pad-token mask, plus the residual:
//      dx = dY + LN^T(dyln * ok), and d ln by per-block partials.
// The shift stays in indexing, as in the forward: no rolled copy exists.
//
// Bound on H100: the four GEMMs (2 x 4 C^2 + 2 x 2 C^2 FLOP per token, the
// qkv recompute included) are compute-bound on the same synchronous wmma
// tiles as the forward; the attention backward holds q, k, v, dO, P and dS
// of one window in 229 KB of shared memory (one block per SM) and is
// latency-bound on its per-warp strips.
#include "swin_attn.cuh"

namespace pw {

constexpr int AB_LDT = 32 + 4;  // f32 stride of a warp's 16 x 32 tile

struct AttnBwdSmem {
  int N, ldS, ldP;
  size_t q, k, v, dout, P, dS, strip, tile, D, reg, total;
  __host__ __device__ AttnBwdSmem(int n) : N(n) {
    ldS = n + 4;  // f32 strip: scores, then probabilities
    ldP = n + 8;  // bf16 full P and dS
    q = 0;
    k = q + (size_t)n * AT_LDQ * 2;
    v = k + (size_t)n * AT_LDQ * 2;
    dout = v + (size_t)n * AT_LDQ * 2;
    P = (dout + (size_t)n * AT_LDQ * 2 + 127) / 128 * 128;
    dS = P + (size_t)n * ldP * 2;
    strip = (dS + (size_t)n * ldP * 2 + 127) / 128 * 128;
    tile = strip + (size_t)AT_WARPS * 16 * ldS * 4;
    D = tile + (size_t)AT_WARPS * 16 * AB_LDT * 4;
    reg = D + (size_t)n * 4;
    total = reg + (size_t)n * 4;
  }
};

struct AttnBwdPlan {
  int groups, per;
};

// windows per block: enough (head, group) blocks for two per SM
inline AttnBwdPlan attn_bwd_plan(int windows, int heads) {
  int g = (264 + heads - 1) / heads;
  if (g > windows) g = windows;
  if (g < 1) g = 1;
  const int per = (windows + g - 1) / g;
  return {(windows + per - 1) / per, per};
}

// 16 tokens x 32 channels of a warp's f32 tile (scaled, rounded to bf16)
// into `dst` (M, ldd) at column `col0`, in image order.
__device__ __forceinline__ void store_strip(const float* T, float s, bf16* dst, size_t ldd,
                                            int col0, int st, int b, int wr, int wc, int ws,
                                            int shift, int Hp, int Wp, int lane) {
  for (int idx = lane; idx < 64; idx += 32) {
    const int rr = idx >> 2, part = idx & 3;
    const int t = st * 16 + rr;
    const int row = (wr * ws + t / ws + shift) % Hp;
    const int col = (wc * ws + t % ws + shift) % Wp;
    __align__(16) bf16 o8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o8[j] = __float2bfloat16(s * T[rr * AB_LDT + part * 8 + j]);
    *reinterpret_cast<uint4*>(dst + (((size_t)b * Hp + row) * Wp + col) * ldd + col0 +
                              part * 8) = *reinterpret_cast<const uint4*>(o8);
  }
}

__global__ void __launch_bounds__(AT_THREADS, 1)
window_attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                       const float* __restrict__ rel_bias, const int* __restrict__ region,
                       bf16* __restrict__ dqkv, float* __restrict__ dbias_part, int B, int Hp,
                       int Wp, int C, int ws, int shift, float scale, int groups, int per) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = ws * ws;
  const AttnBwdSmem L(N);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dout);
  bf16* Pf = reinterpret_cast<bf16*>(smem + L.P);
  bf16* dSf = reinterpret_cast<bf16*>(smem + L.dS);
  float* Dsm = reinterpret_cast<float*>(smem + L.D);
  int* reg = reinterpret_cast<int*>(smem + L.reg);

  const int nW = Wp / ws, nH = Hp / ws, nWin = nH * nW;
  const int windows = B * nWin;
  const int g = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = N / 16;
  const bool masked = region != nullptr;
  const size_t C3 = 3 * (size_t)C;
  const int ldS = L.ldS, ldP = L.ldP;
  float* S = reinterpret_cast<float*>(smem + L.strip) + (size_t)warp * 16 * ldS;
  float* T = reinterpret_cast<float*>(smem + L.tile) + (size_t)warp * 16 * AB_LDT;
  const float* bh = rel_bias + (size_t)h * N * N;
  float* dbp = dbias_part + ((size_t)h * groups + g) * N * N;

  for (int i = tid; i < N * N; i += AT_THREADS) dbp[i] = 0.f;
  __syncthreads();

  const int w1 = min(windows, (g + 1) * per);
  for (int win = g * per; win < w1; ++win) {
    const int b = win / nWin;
    const int wr = (win / nW) % nH, wc = win % nW;
    // gather q, k, v and dO of this head for the window's N tokens
    for (int idx = tid; idx < N * 16; idx += AT_THREADS) {
      const int t = idx >> 4, which = (idx >> 2) & 3, part = idx & 3;
      const int row = (wr * ws + t / ws + shift) % Hp, col = (wc * ws + t % ws + shift) % Wp;
      const size_t tok = ((size_t)b * Hp + row) * Wp + col;
      const bf16* src = which < 3 ? qkv + tok * C3 + which * C + h * AT_D + part * 8
                                  : dout + tok * C + h * AT_D + part * 8;
      bf16* dst = (which == 0 ? Qs : which == 1 ? Ks : which == 2 ? Vs : dOs) + t * AT_LDQ +
                  part * 8;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    }
    if (masked)
      for (int t = tid; t < N; t += AT_THREADS) reg[t] = region[(size_t)(win % nWin) * N + t];
    __syncthreads();

    // phase 1: 16-row strips of S, P, D, dS and dQ
    for (int st = warp; st < nt; st += AT_WARPS) {
      for (int j = 0; j < nt; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < AT_D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + st * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::load_matrix_sync(fb, Ks + j * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(S + j * 16, acc, ldS, wmma::mem_row_major);
      }
      __syncwarp();
      // softmax as in the forward: f32 P over the strip, bf16 P into Pf
      for (int rr = 0; rr < 16; ++rr) {
        const int r = st * 16 + rr;
        float* srow = S + rr * ldS;
        float e[AT_CPL];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < AT_CPL; ++u) {
          const int c = lane + 32 * u;
          float sc = -INFINITY;
          if (c < N) {
            sc = srow[c] * scale;
            if (masked && reg[r] != reg[c]) sc += -100.f;
            sc += bh[(size_t)r * N + c];
          }
          e[u] = sc;
          mx = fmaxf(mx, sc);
        }
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < AT_CPL; ++u) {
          e[u] = (lane + 32 * u < N) ? expf(e[u] - mx) : 0.f;
          sum += e[u];
        }
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float inv = 1.f / sum;
#pragma unroll
        for (int u = 0; u < AT_CPL; ++u) {
          const int c = lane + 32 * u;
          if (c < N) {
            const float p = e[u] * inv;
            srow[c] = p;
            Pf[r * ldP + c] = __float2bfloat16(p);
          }
        }
      }
      __syncwarp();

      // O = P V for the strip, then D = rowsum(dO o O)
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o2[2];
      wmma::fill_fragment(o2[0], 0.f);
      wmma::fill_fragment(o2[1], 0.f);
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Pf + st * 16 * ldP + kk, ldP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Vs + kk * AT_LDQ + j * 16, AT_LDQ);
          wmma::mma_sync(o2[j], fa, fb, o2[j]);
        }
      }
      wmma::store_matrix_sync(T, o2[0], AB_LDT, wmma::mem_row_major);
      wmma::store_matrix_sync(T + 16, o2[1], AB_LDT, wmma::mem_row_major);
      __syncwarp();
      {
        const int rr = lane >> 1, half = lane & 1;
        const bf16* dorow = dOs + (st * 16 + rr) * AT_LDQ + half * 16;
        float d = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) d += __bfloat162float(dorow[k]) * T[rr * AB_LDT + half * 16 + k];
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        if (!half) Dsm[st * 16 + rr] = d;
      }
      __syncwarp();

      // dS tile by tile: dP = dO V^T, dS = P (dP - D); into the bias
      // gradient partial (same thread for each element in every window)
      for (int j = 0; j < nt; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < AT_D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, dOs + st * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::load_matrix_sync(fb, Vs + j * 16 * AT_LDQ + kk, AT_LDQ);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(T, acc, AB_LDT, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int rr = e >> 4, cc = e & 15;
          const int r = st * 16 + rr, c = j * 16 + cc;
          const float ds = S[rr * ldS + c] * (T[rr * AB_LDT + cc] - Dsm[r]);
          dbp[(size_t)r * N + c] += ds;
          dSf[r * ldP + c] = __float2bfloat16(ds);
        }
        __syncwarp();
      }

      // dQ = dS K * scale
      wmma::fill_fragment(o2[0], 0.f);
      wmma::fill_fragment(o2[1], 0.f);
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, dSf + st * 16 * ldP + kk, ldP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Ks + kk * AT_LDQ + j * 16, AT_LDQ);
          wmma::mma_sync(o2[j], fa, fb, o2[j]);
        }
      }
      wmma::store_matrix_sync(T, o2[0], AB_LDT, wmma::mem_row_major);
      wmma::store_matrix_sync(T + 16, o2[1], AB_LDT, wmma::mem_row_major);
      __syncwarp();
      store_strip(T, scale, dqkv, C3, h * AT_D, st, b, wr, wc, ws, shift, Hp, Wp, lane);
      __syncwarp();
    }
    __syncthreads();

    // phase 2: 16-column strips of dV = P^T dO and dK = dS^T Q * scale
    for (int sj = warp; sj < nt; sj += AT_WARPS) {
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const bf16* Am = which == 0 ? Pf : dSf;
        const bf16* Bm = which == 0 ? dOs : Qs;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o2[2];
        wmma::fill_fragment(o2[0], 0.f);
        wmma::fill_fragment(o2[1], 0.f);
        for (int kk = 0; kk < N; kk += 16) {
          // element (j, i) of the transposed operand at Am[i][j]
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
          wmma::load_matrix_sync(fa, Am + kk * ldP + sj * 16, ldP);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, Bm + kk * AT_LDQ + j * 16, AT_LDQ);
            wmma::mma_sync(o2[j], fa, fb, o2[j]);
          }
        }
        wmma::store_matrix_sync(T, o2[0], AB_LDT, wmma::mem_row_major);
        wmma::store_matrix_sync(T + 16, o2[1], AB_LDT, wmma::mem_row_major);
        __syncwarp();
        if (which == 0)
          store_strip(T, 1.f, dqkv, C3, 2 * C + h * AT_D, sj, b, wr, wc, ws, shift, Hp, Wp,
                      lane);
        else
          store_strip(T, scale, dqkv, C3, C + h * AT_D, sj, b, wr, wc, ws, shift, Hp, Wp,
                      lane);
        __syncwarp();
      }
    }
    __syncthreads();
  }
}

inline long long attn_bwd_part_elems(int B, int Hp, int Wp, int C, int heads, int ws) {
  const int M = B * Hp * Wp, N = ws * ws;
  const AttnBwdPlan p = attn_bwd_plan(B * (Hp / ws) * (Wp / ws), heads);
  const long long cand[5] = {(long long)heads * p.groups * N * N,
                             (long long)colsum_splits(M) * 3 * C, dw_part_elems(M, C, C),
                             dw_part_elems(M, 3 * C, C), (long long)ln_bwd_splits(M) * 2 * C};
  long long n = 0;
  for (long long c : cand) n = c > n ? c : n;
  return n;
}

}  // namespace pw

using pw::bf16;

// f32 elements of the `part` scratch that pw_swin_attn_block_bwd needs.
extern "C" long long pw_swin_attn_block_bwd_part_elems(int B, int Hp, int Wp, int C,
                                                       int heads, int ws) {
  return pw::attn_bwd_part_elems(B, Hp, Wp, C, heads, ws);
}

// All pointers are device pointers on `stream`. Scratch from the caller:
// qkv_buf (M, 3C) and dqkv_buf (M, 3C) bf16, o_buf and dyb_buf (M, C)
// bf16, stats (M, 2) f32, part (pw_swin_attn_block_bwd_part_elems) f32.
// Outputs: dx (M, C) bf16; dln (2, C), dwqkv (3C, C), dbqkv (3C), dwproj
// (C, C), dbproj (C), drel (heads, N, N) f32. Returns the first CUDA
// error, else 0.
extern "C" int pw_swin_attn_block_bwd(
    const void* x, const float* ln_w, const float* ln_b, const void* wqkv, const float* bqkv,
    const void* wproj, const float* rel_bias, const int* region, const float* row_scale,
    const void* dy, void* dx, float* dln, float* dwqkv, float* dbqkv, float* dwproj,
    float* dbproj, float* drel, void* qkv_buf, void* o_buf, void* dyb_buf, void* dqkv_buf,
    float* stats, float* part, int B, int Hp, int Wp, int C, int heads, int ws, int H, int W,
    int shift, float scale, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  const int M = B * Hp * Wp, N = ws * ws;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyv = static_cast<const bf16*>(dy);
  bf16* qkv = static_cast<bf16*>(qkv_buf);
  bf16* o = static_cast<bf16*>(o_buf);
  bf16* dyb = static_cast<bf16*>(dyb_buf);
  bf16* dqkv = static_cast<bf16*>(dqkv_buf);
  cudaError_t err;
#define PW_CHECK()                                             \
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err

  pw::ln_stats(xb, stats, M, C, 1, Hp, Wp, H, W, stream);
  PW_CHECK();
  err = pw::attn_qkv_o(xb, ln_w, ln_b, static_cast<const bf16*>(wqkv), bqkv, rel_bias, region,
                       qkv, o, B, Hp, Wp, C, heads, ws, H, W, shift, scale, stream);
  if (err != cudaSuccess) return (int)err;

  // proj: dbproj, dWproj, then dO into o's buffer
  pw::scale_rows(dyv, row_scale, Hp * Wp, dyb, M, C, stream);
  pw::colsum(dyv, row_scale, Hp * Wp, part, dbproj, M, C, stream);
  PW_CHECK();
  pw::DwArgs d{};
  d.A = dyb; d.B = o; d.part = part; d.M = M; d.N = C; d.K = C;
  pw::gemm_dw<pw::PRO_NONE>(d, dwproj, stream);
  PW_CHECK();
  pw::GemmArgs g = pw::gemm_args(dyb, static_cast<const bf16*>(wproj), nullptr, o, M, C, C);
  pw::gemm_bf16<pw::PRO_NONE, pw::EPI_NONE, pw::LAYOUT_NN>(g, stream);
  PW_CHECK();

  // window attention backward -> dqkv, d rel-bias
  const pw::AttnBwdSmem L(N);
  err = cudaFuncSetAttribute(pw::window_attn_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  const pw::AttnBwdPlan plan = pw::attn_bwd_plan(B * (Hp / ws) * (Wp / ws), heads);
  pw::window_attn_bwd_kernel<<<dim3(plan.groups, heads), pw::AT_THREADS, L.total, stream>>>(
      qkv, o, rel_bias, region, dqkv, part, B, Hp, Wp, C, ws, shift, scale, plan.groups,
      plan.per);
  PW_CHECK();
  // the partial layout is (heads, groups, N, N): reduce head by head
  for (int h = 0; h < heads; ++h)
    pw::reduce_parts(part + (size_t)h * plan.groups * N * N, drel + (size_t)h * N * N,
                     plan.groups, (long long)N * N, stream);
  PW_CHECK();

  // qkv: dbqkv, dWqkv (LN1 on the fly), dyln = dqkv . Wqkv into qkv's buffer
  pw::colsum(dqkv, nullptr, 1, part, dbqkv, M, 3 * C, stream);
  PW_CHECK();
  pw::DwArgs q{};
  q.A = dqkv; q.B = xb; q.part = part; q.M = M; q.N = 3 * C; q.K = C;
  q.stats = stats; q.ln_w = ln_w; q.ln_b = ln_b;
  pw::gemm_dw<pw::PRO_LN>(q, dwqkv, stream);
  PW_CHECK();
  float* dyln = reinterpret_cast<float*>(qkv_buf);
  pw::GemmArgs y = pw::gemm_args(dqkv, static_cast<const bf16*>(wqkv), nullptr, nullptr, M, C,
                                 3 * C);
  y.out_f32 = dyln;
  pw::gemm_bf16<pw::PRO_NONE, pw::EPI_F32, pw::LAYOUT_NN>(y, stream);
  PW_CHECK();

  // LN1 backward (pad tokens masked) + residual
  err = pw::ln_bwd(xb, stats, ln_w, dyln, dyv, static_cast<bf16*>(dx), part, dln, M, C, 1, Hp,
                   Wp, H, W, stream);
  if (err != cudaSuccess) return (int)err;
  PW_CHECK();
#undef PW_CHECK
  return 0;
}
