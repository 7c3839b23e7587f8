// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// The gradient of the forward in flash_attention.cu, which replaces the
// Pallas TPU kernel `_attn_kernel` (`flash_attention_bhsd` in
// src/repro/kernels/flash_attention/kernel.py).  That kernel has no
// gradient of its own: the JAX package trains through autodiff of its
// plain attention (`repro/models/layers.py` `attention`), which keeps every
// (S, S) probability block for the backward.  This one keeps only the row
// log-sum-exp that the forward writes (`lse`, (B, H, S) float32) and
// recomputes the probabilities tile by tile, in the FA-2 order:
//
//   P  = exp(scale * q k^T - lse)          (masked entries 0)
//   dV = P^T dO          dP = dO V^T       D = rowsum(dO * O)
//   dS = P * (dP - D)    dK = scale dS^T Q    dQ = scale dS K
//
// Three launches, on PyTorch's stream:
//  (a) `flash_bwd_dot`: D, one warp per (b, s, h) row, float32.
//  (b) `flash_bwd_dkdv`: one block per (key tile, b * KH).  It holds its
//      K and V tiles and the dK, dV accumulators, and walks the G query
//      heads of its KV head and, for each, the query tiles that can see its
//      keys.  GQA and MQA sum over the group inside the block: no atomics,
//      and the result does not depend on the order blocks run in.
//  (c) `flash_bwd_dq`: one block per (query tile, b * H), walking the key
//      tiles its rows can see (the forward's loop), dQ in registers.
// (b) and (c) both form P and dS; the products are computed twice (seven
// S^2 Dh products in all, against five for one pass with atomics on dQ).
//
// What bounds it on the H100: five products of S^2 Dh over the visible
// (query, key) pairs against reading q, k, v, o, dO and writing dq, dk,
// dv once; at the training shapes (S 1e3-4e3) that is the products.  Two
// routes, by dtype (a dispatch, not a fallback):
//  * bf16 (`_wmma` kernels): the products on tensor cores, WMMA fragments
//    of 16 x 16 x 16 (mma.sync) over bf16 tiles of 64 queries and 64 keys
//    in shared memory, float32 accumulators; S and dP go through shared
//    memory in float32, where P and dS are formed, and are rounded to bf16
//    for the three products that take them (as FA-2 does).  Synchronous
//    loads and one product at a time: far from `wgmma`'s rate, which is
//    later work.
//  * float32 (scalar kernels): scalar FMAs out of float32 tiles, so that
//    a float32 model's gradients keep float32's digits (no TF32).
//
// Masks exactly as the forward's: causal (q >= k) and window (q - k <
// window); rows and keys past S are zero and masked, any S >= 1 works, and
// only tiles that can hold a visible pair are visited.  Dh is a template
// parameter (64, 120, 128, 256); the tiles are padded with zeros to a
// multiple of 32 columns (scalar) or 16 (WMMA).  Inputs are float32 (the
// scalar kernels) or bf16 (the WMMA kernels; D reads both), read in their
// (B, S, heads, Dh) layout by stride; dq, dk, dv are written in the input
// type (bf16 rounded to nearest even), accumulated in float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int NT = 256;  // threads of a block of (b) and (c)
constexpr int RPT = 4;   // tile rows per thread

// Tiles of one head dim.  A tile is T rows (queries or keys) by DHP
// columns; T is 64 up to Dh 128 and 32 at Dh 256, so that four tiles fit
// in shared memory (140 KB at Dh 256, 165 KB at Dh 120 and 128).
// Thread layout, for a T x T score tile and for a T x DHP accumulator
// alike: row group rg = tid / LN owns rows 4 rg .. 4 rg + 3, lane cl = tid
// % LN owns score columns cl + LN j and head-dim columns cl + LN n.  Row
// strides are odd (DHP + 1, T + 1), so that lanes reading down a column
// hit distinct banks.
template <int DH>
struct BwdTiles {
  static constexpr int T = DH > 128 ? 32 : 64;
  static constexpr int DHP = (DH + 31) / 32 * 32;
  static constexpr int LN = NT * RPT / T;  // 16 or 32
  static constexpr int CPT = T / LN;       // score columns per thread
  static constexpr int NC = DHP / LN;      // head-dim columns per thread
  static constexpr int RS = DHP + 1;
  static constexpr int PS = T + 1;
  static_assert(NT / LN * RPT == T, "row groups must cover the tile");
  static_assert(DHP % LN == 0, "head-dim columns must split over lanes");
  // K, V, Q, dO tiles, then P and dS
  static constexpr size_t bytes = sizeof(float) * (4 * T * RS + 2 * T * PS);
};

// dst[r][d] <- src[(s0 + r) * stride + d], zero past S and Dh
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int s0, int S) {
  using L = BwdTiles<DH>;
  for (int i = threadIdx.x; i < L::T * L::DHP; i += NT) {
    const int r = i / L::DHP, d = i % L::DHP;
    const int s = s0 + r;
    dst[r * L::RS + d] = (s < S && d < DH) ? src[s * stride + d] : 0.f;
  }
}

// acc[i][j] <- A row (4 rg + i) . B row (cl + LN j), over DHP columns
template <int DH>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         float (&acc)[RPT][BwdTiles<DH>::CPT],
                                         int rg, int cl) {
  using L = BwdTiles<DH>;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < L::CPT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < L::DHP; ++d) {
    float a[RPT], b[L::CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = A[(rg * RPT + i) * L::RS + d];
#pragma unroll
    for (int j = 0; j < L::CPT; ++j) b[j] = Bt[(cl + L::LN * j) * L::RS + d];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < L::CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal,
                                        int window) {
  return qp < S && kp < S && (!causal || kp <= qp) &&
         (window <= 0 || qp - kp < window);
}

// P and dS of the query tile at q0 and the key tile at k0 (Q, dO, K, V in
// shared memory; the rows' lse and D in lse_s, d_s) into Ps and dSs
template <int DH>
__device__ __forceinline__ void probs_and_dscores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const float* lse_s, const float* d_s, float* Ps, float* dSs, int q0,
    int k0, int S, int causal, int window, float scale, int rg, int cl) {
  using L = BwdTiles<DH>;
  float sc[RPT][L::CPT], dp[RPT][L::CPT];
  tile_dot<DH>(Qs, Ks, sc, rg, cl);
  tile_dot<DH>(dOs, Vs, dp, rg, cl);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
#pragma unroll
    for (int j = 0; j < L::CPT; ++j) {
      const int c = cl + L::LN * j;
      const float p = visible(q0 + r, k0 + c, S, causal, window)
                          ? expf(fmaf(sc[i][j], scale, -lse_s[r]))
                          : 0.f;
      Ps[r * L::PS + c] = p;
      dSs[r * L::PS + c] = p * (dp[i][j] - d_s[r]);
    }
  }
}

// (a) D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], one warp a row
template <typename TI>
__global__ void __launch_bounds__(256)
flash_bwd_dot(const TI* __restrict__ o, const TI* __restrict__ dout,
              float* __restrict__ dsum, int S, int H, int Dh,
              long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: row is warp-uniform
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32)
    acc = fmaf(ld(o + row * Dh + d), ld(dout + row * Dh + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / ((long long)S * H);
    const int s = (int)((row / H) % S), h = (int)(row % H);
    dsum[(b * H + h) * S + s] = acc;
  }
}

// (b) dK and dV of one key tile of one (b, KV head), float32
template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               float* __restrict__ dk, float* __restrict__ dv, int S, int H,
               int KH, int causal, int window, float scale) {
  using L = BwdTiles<DH>;
  constexpr int T = L::T, NC = L::NC, LN = L::LN;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + T * L::RS;
  float* Qs = Vs + T * L::RS;
  float* dOs = Qs + T * L::RS;
  float* Ps = dOs + T * L::RS;
  float* dSs = Ps + T * L::PS;
  __shared__ float lse_s[T], d_s[T];

  const int tid = threadIdx.x, rg = tid / LN, cl = tid % LN;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int G = H / KH;
  // under a causal mask the first key tiles see the most queries: blocks
  // start in the order of blockIdx.x, so those start first
  const int k0 = blockIdx.x * T;
  const long long q_stride = (long long)H * DH, kv_stride = (long long)KH * DH;
  const long long kv_off = (long long)b * S * kv_stride + (long long)kh * DH;
  load_tile<DH>(Ks, k + kv_off, kv_stride, k0, S);
  load_tile<DH>(Vs, v + kv_off, kv_stride, k0, S);

  float dk_acc[RPT][NC], dv_acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dk_acc[i][n] = dv_acc[i][n] = 0.f;

  // query tiles that can see a key of this tile: from the tile's own
  // start when causal, up to the last key's window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + T - 1 + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long q_off = (long long)b * S * q_stride + (long long)h * DH;
    const long long row_off = ((long long)b * H + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += T) {
      __syncthreads();  // the previous tiles are consumed
      load_tile<DH>(Qs, q + q_off, q_stride, q0, S);
      load_tile<DH>(dOs, dout + q_off, q_stride, q0, S);
      if (tid < T) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[row_off + s] : 0.f;
        d_s[tid] = s < S ? dsum[row_off + s] : 0.f;
      }
      __syncthreads();
      probs_and_dscores<DH>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, q0, k0, S,
                            causal, window, scale, rg, cl);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this thread's keys are rows 4 rg + i
#pragma unroll 2
      for (int r = 0; r < T; ++r) {
        float pv[RPT], dsv[RPT], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = Ps[r * L::PS + rg * RPT + i];
          dsv[i] = dSs[r * L::PS + rg * RPT + i];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          dov[n] = dOs[r * L::RS + cl + LN * n];
          qv[n] = Qs[r * L::RS + cl + LN * n];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            dv_acc[i][n] = fmaf(pv[i], dov[n], dv_acc[i][n]);
            dk_acc[i][n] = fmaf(dsv[i], qv[n], dk_acc[i][n]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = k0 + rg * RPT + i;
    if (s >= S) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = cl + LN * n;
      if (d < DH) {
        dk[kv_off + s * kv_stride + d] = dk_acc[i][n] * scale;
        dv[kv_off + s * kv_stride + d] = dv_acc[i][n];
      }
    }
  }
}

// (c) dQ of one query tile of one (b, head), float32
template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             float* __restrict__ dq, int S, int H, int KH, int causal,
             int window, float scale) {
  using L = BwdTiles<DH>;
  constexpr int T = L::T, NC = L::NC, LN = L::LN;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + T * L::RS;
  float* Qs = Vs + T * L::RS;
  float* dOs = Qs + T * L::RS;
  float* Ps = dOs + T * L::RS;
  float* dSs = Ps + T * L::PS;
  __shared__ float lse_s[T], d_s[T];

  const int tid = threadIdx.x, rg = tid / LN, cl = tid % LN;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);
  // the last query tiles see the most keys under a causal mask: start them
  // first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T;
  const long long q_stride = (long long)H * DH, kv_stride = (long long)KH * DH;
  const long long q_off = (long long)b * S * q_stride + (long long)h * DH;
  const long long kv_off = (long long)b * S * kv_stride + (long long)kh * DH;
  const long long row_off = ((long long)b * H + h) * S;
  load_tile<DH>(Qs, q + q_off, q_stride, q0, S);
  load_tile<DH>(dOs, dout + q_off, q_stride, q0, S);
  if (tid < T) {
    const int s = q0 + tid;
    lse_s[tid] = s < S ? lse[row_off + s] : 0.f;
    d_s[tid] = s < S ? dsum[row_off + s] : 0.f;
  }

  float dq_acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int n = 0; n < NC; ++n) dq_acc[i][n] = 0.f;

  // key tiles that can hold a visible key for some row of this tile
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / T * T : 0;
  const int k_hi = causal ? min(S, q0 + T) : S;

  for (int k0 = k_lo; k0 < k_hi; k0 += T) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<DH>(Ks, k + kv_off, kv_stride, k0, S);
    load_tile<DH>(Vs, v + kv_off, kv_stride, k0, S);
    __syncthreads();
    probs_and_dscores<DH>(Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs, q0, k0, S,
                          causal, window, scale, rg, cl);
    __syncthreads();
    // dQ += dS K: this thread's queries are rows 4 rg + i
#pragma unroll 2
    for (int c = 0; c < T; ++c) {
      float dsv[RPT], kv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(rg * RPT + i) * L::PS + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) kv[n] = Ks[c * L::RS + cl + LN * n];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) dq_acc[i][n] = fmaf(dsv[i], kv[n],
                                                         dq_acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + rg * RPT + i;
    if (s >= S) continue;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int d = cl + LN * n;
      if (d < DH) dq[q_off + s * q_stride + d] = dq_acc[i][n] * scale;
    }
  }
}

// ------------------------------------------------------------------------
// bf16 route: WMMA fragments
//
// A block of 8 warps holds four bf16 tiles of 64 rows (Q, dO, K, V; row
// stride DHP + 8, a multiple of 16 bytes off the banks' period), S and dP
// of one tile pair in float32, and P and dS in bf16.  Warp w computes the
// 16-row block w / 2 of S and dP at the key blocks 2 (w % 2) and
// 2 (w % 2) + 1, and owns the output rows 16 (w / 2) .. + 15 at the
// head-dim blocks of parity w % 2.  Past the loop, the accumulators go to
// global memory through a float32 staging tile that aliases two of the
// bf16 tiles no longer read.  Shared memory: 90 KB at Dh 64, 123 KB at
// 120 and 128, 188 KB at 256.
// ------------------------------------------------------------------------

template <int DH>
struct WmmaTiles {
  static constexpr int T = 64;                     // queries or keys a tile
  static constexpr int DHP = (DH + 15) / 16 * 16;  // 120 -> 128, zero-filled
  static constexpr int LD = DHP + 8;   // bf16 row stride of Q, dO, K, V
  static constexpr int LF = T + 4;     // float row stride of S, dP
  static constexpr int LP = T + 8;     // bf16 row stride of P, dS
  static constexpr int LO = DHP + 4;   // float row stride of the staging
  static constexpr int NCB = DHP / 32;  // head-dim blocks a warp owns
  static constexpr size_t TILE = (size_t)T * LD * 2;
  static constexpr size_t bytes =
      4 * TILE + 2 * (size_t)T * LF * 4 + 2 * (size_t)T * LP * 2;
  static_assert((size_t)T * LO * 4 <= 2 * TILE,
                "the output staging fits in two bf16 tiles");
};

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                   float>;

// dst[r][d] <- src[(s0 + r) * stride + d], 16 bytes at a time, zero past S
// and Dh (src and stride on 16-byte boundaries, Dh a multiple of 8)
template <int DH>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long stride, int s0,
                                               int S) {
  using W = WmmaTiles<DH>;
  constexpr int CH = W::DHP / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < W::T * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S && c * 8 < DH)
      val = *reinterpret_cast<const uint4*>(src + s * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * W::LD + c * 8) = val;
  }
}

// S = Q K^T and dP = dO V^T of this warp's blocks, stored to Ss and dPs
template <int DH>
__device__ __forceinline__ void scores_wmma(
    const __nv_bfloat16* Qs, const __nv_bfloat16* dOs,
    const __nv_bfloat16* Ks, const __nv_bfloat16* Vs, float* Ss, float* dPs,
    int warp) {
  using namespace nvcuda;
  using W = WmmaTiles<DH>;
  const int rb = warp / 2, cb0 = 2 * (warp % 2);
  Acc sc[2], dp[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::fill_fragment(sc[j], 0.f);
    wmma::fill_fragment(dp[j], 0.f);
  }
#pragma unroll 2
  for (int kk = 0; kk < W::DHP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> qa, da;
    wmma::load_matrix_sync(qa, Qs + rb * 16 * W::LD + kk, W::LD);
    wmma::load_matrix_sync(da, dOs + rb * 16 * W::LD + kk, W::LD);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // K^T and V^T: the tiles' rows read as columns
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> kb, vb;
      wmma::load_matrix_sync(kb, Ks + (cb0 + j) * 16 * W::LD + kk, W::LD);
      wmma::load_matrix_sync(vb, Vs + (cb0 + j) * 16 * W::LD + kk, W::LD);
      wmma::mma_sync(sc[j], qa, kb, sc[j]);
      wmma::mma_sync(dp[j], da, vb, dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int off = rb * 16 * W::LF + (cb0 + j) * 16;
    wmma::store_matrix_sync(Ss + off, sc[j], W::LF, wmma::mem_row_major);
    wmma::store_matrix_sync(dPs + off, dp[j], W::LF, wmma::mem_row_major);
  }
}

// P and dS in bf16 from S and dP in float32, masked
template <int DH>
__device__ __forceinline__ void probs_wmma(
    const float* Ss, const float* dPs, const float* lse_s, const float* d_s,
    __nv_bfloat16* Ps, __nv_bfloat16* dSs, int q0, int k0, int S, int causal,
    int window, float scale) {
  using W = WmmaTiles<DH>;
  for (int i = threadIdx.x; i < W::T * W::T; i += NT) {
    const int r = i / W::T, c = i % W::T;
    const float p = visible(q0 + r, k0 + c, S, causal, window)
                        ? expf(fmaf(Ss[r * W::LF + c], scale, -lse_s[r]))
                        : 0.f;
    st(Ps + r * W::LP + c, p);
    st(dSs + r * W::LP + c, p * (dPs[r * W::LF + c] - d_s[r]));
  }
}

// the warp's accumulators times `mul` into rows s0 .. s0 + 63 of dst, by
// way of the staging tile; every thread of the block calls it
template <int DH>
__device__ __forceinline__ void store_rows_wmma(
    Acc (&acc)[WmmaTiles<DH>::NCB], float mul, float* stage,
    __nv_bfloat16* dst, long long stride, int s0, int S, int warp) {
  using namespace nvcuda;
  using W = WmmaTiles<DH>;
  const int rb = warp / 2, par = warp % 2;
#pragma unroll
  for (int j = 0; j < W::NCB; ++j) {
#pragma unroll
    for (int t = 0; t < acc[j].num_elements; ++t) acc[j].x[t] *= mul;
    wmma::store_matrix_sync(stage + rb * 16 * W::LO + (2 * j + par) * 16,
                            acc[j], W::LO, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W::T * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    if (s0 + r < S) st(dst + (s0 + r) * stride + d, stage[r * W::LO + d]);
  }
  __syncthreads();  // the staging tile is read before it is reused
}

// (b), bf16: dK and dV of one key tile of one (b, KV head)
template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_wmma(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int S, int H, int KH,
                    int causal, int window, float scale) {
  using namespace nvcuda;
  using W = WmmaTiles<DH>;
  constexpr int T = W::T, NCB = W::NCB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + T * W::LD;
  __nv_bfloat16* Qs = Vs + T * W::LD;
  __nv_bfloat16* dOs = Qs + T * W::LD;
  float* Ss = reinterpret_cast<float*>(dOs + T * W::LD);
  float* dPs = Ss + T * W::LF;
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(dPs + T * W::LF);
  __nv_bfloat16* dSs = Ps + T * W::LP;
  float* stage = reinterpret_cast<float*>(Qs);  // Q and dO, past the loop
  __shared__ float lse_s[T], d_s[T];

  const int tid = threadIdx.x, warp = tid / 32;
  const int rb = warp / 2, par = warp % 2;
  const int b = blockIdx.y / KH, kh = blockIdx.y % KH;
  const int G = H / KH;
  const int k0 = blockIdx.x * T;
  const long long q_stride = (long long)H * DH, kv_stride = (long long)KH * DH;
  const long long kv_off = (long long)b * S * kv_stride + (long long)kh * DH;
  load_tile_bf16<DH>(Ks, k + kv_off, kv_stride, k0, S);
  load_tile_bf16<DH>(Vs, v + kv_off, kv_stride, k0, S);

  Acc dk_acc[NCB], dv_acc[NCB];
#pragma unroll
  for (int j = 0; j < NCB; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S, k0 + T - 1 + window) : S;

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long q_off = (long long)b * S * q_stride + (long long)h * DH;
    const long long row_off = ((long long)b * H + h) * S;
    for (int q0 = q_lo; q0 < q_hi; q0 += T) {
      __syncthreads();  // the previous tiles are consumed
      load_tile_bf16<DH>(Qs, q + q_off, q_stride, q0, S);
      load_tile_bf16<DH>(dOs, dout + q_off, q_stride, q0, S);
      if (tid < T) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[row_off + s] : 0.f;
        d_s[tid] = s < S ? dsum[row_off + s] : 0.f;
      }
      __syncthreads();
      scores_wmma<DH>(Qs, dOs, Ks, Vs, Ss, dPs, warp);
      __syncthreads();
      probs_wmma<DH>(Ss, dPs, lse_s, d_s, Ps, dSs, q0, k0, S, causal,
                     window, scale);
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q over the tile's 64 queries: P^T and
      // dS^T are P and dS read column-major
#pragma unroll
      for (int kk = 0; kk < T; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> pa, sa;
        wmma::load_matrix_sync(pa, Ps + kk * W::LP + rb * 16, W::LP);
        wmma::load_matrix_sync(sa, dSs + kk * W::LP + rb * 16, W::LP);
#pragma unroll
        for (int j = 0; j < NCB; ++j) {
          const int col = (2 * j + par) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> ob, qb;
          wmma::load_matrix_sync(ob, dOs + kk * W::LD + col, W::LD);
          wmma::load_matrix_sync(qb, Qs + kk * W::LD + col, W::LD);
          wmma::mma_sync(dv_acc[j], pa, ob, dv_acc[j]);
          wmma::mma_sync(dk_acc[j], sa, qb, dk_acc[j]);
        }
      }
    }
  }
  __syncthreads();  // Q and dO are consumed: the staging tile takes them
  store_rows_wmma<DH>(dv_acc, 1.f, stage, dv + kv_off, kv_stride, k0, S,
                      warp);
  store_rows_wmma<DH>(dk_acc, scale, stage, dk + kv_off, kv_stride, k0, S,
                      warp);
}

// (c), bf16: dQ of one query tile of one (b, head)
template <int DH>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_wmma(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dq, int S, int H, int KH,
                  int causal, int window, float scale) {
  using namespace nvcuda;
  using W = WmmaTiles<DH>;
  constexpr int T = W::T, NCB = W::NCB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + T * W::LD;
  __nv_bfloat16* Qs = Vs + T * W::LD;
  __nv_bfloat16* dOs = Qs + T * W::LD;
  float* Ss = reinterpret_cast<float*>(dOs + T * W::LD);
  float* dPs = Ss + T * W::LF;
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(dPs + T * W::LF);
  __nv_bfloat16* dSs = Ps + T * W::LP;
  float* stage = reinterpret_cast<float*>(Ks);  // K and V, past the loop
  __shared__ float lse_s[T], d_s[T];

  const int tid = threadIdx.x, warp = tid / 32;
  const int rb = warp / 2, par = warp % 2;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T;
  const long long q_stride = (long long)H * DH, kv_stride = (long long)KH * DH;
  const long long q_off = (long long)b * S * q_stride + (long long)h * DH;
  const long long kv_off = (long long)b * S * kv_stride + (long long)kh * DH;
  const long long row_off = ((long long)b * H + h) * S;
  load_tile_bf16<DH>(Qs, q + q_off, q_stride, q0, S);
  load_tile_bf16<DH>(dOs, dout + q_off, q_stride, q0, S);
  if (tid < T) {
    const int s = q0 + tid;
    lse_s[tid] = s < S ? lse[row_off + s] : 0.f;
    d_s[tid] = s < S ? dsum[row_off + s] : 0.f;
  }

  Acc dq_acc[NCB];
#pragma unroll
  for (int j = 0; j < NCB; ++j) wmma::fill_fragment(dq_acc[j], 0.f);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / T * T : 0;
  const int k_hi = causal ? min(S, q0 + T) : S;

  for (int k0 = k_lo; k0 < k_hi; k0 += T) {
    __syncthreads();  // the previous tiles are consumed
    load_tile_bf16<DH>(Ks, k + kv_off, kv_stride, k0, S);
    load_tile_bf16<DH>(Vs, v + kv_off, kv_stride, k0, S);
    __syncthreads();
    scores_wmma<DH>(Qs, dOs, Ks, Vs, Ss, dPs, warp);
    __syncthreads();
    probs_wmma<DH>(Ss, dPs, lse_s, d_s, Ps, dSs, q0, k0, S, causal, window,
                   scale);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> sa;
      wmma::load_matrix_sync(sa, dSs + rb * 16 * W::LP + kk, W::LP);
#pragma unroll
      for (int j = 0; j < NCB; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> kb;
        wmma::load_matrix_sync(kb, Ks + kk * W::LD + (2 * j + par) * 16,
                               W::LD);
        wmma::mma_sync(dq_acc[j], sa, kb, dq_acc[j]);
      }
    }
  }
  __syncthreads();  // K and V are consumed: the staging tile takes them
  store_rows_wmma<DH>(dq_acc, scale, stage, dq + q_off, q_stride, q0, S,
                      warp);
}

// passes (b) and (c) of one route
template <typename TI, typename KernelKV, typename KernelQ>
cudaError_t launch_passes(KernelKV dkdv, KernelQ dqk, size_t bytes, int tile,
                          const TI* q, const TI* k, const TI* v,
                          const TI* dout, const float* lse,
                          const float* dsum, TI* dq, TI* dk, TI* dv, int B,
                          int S, int H, int KH, int causal, int window,
                          float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tiles = (S + tile - 1) / tile;
  dkdv<<<dim3(tiles, B * KH), NT, bytes, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, S, H, KH, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3(tiles, B * H), NT, bytes, stream>>>(
      q, k, v, dout, lse, dsum, dq, S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

template <int DH, typename TI>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dsum, void* dq, void* dk, void* dv, int B,
                       int S, int H, int KH, int causal, int window,
                       float scale, cudaStream_t stream) {
  const TI* q_ = static_cast<const TI*>(q);
  const TI* k_ = static_cast<const TI*>(k);
  const TI* v_ = static_cast<const TI*>(v);
  const TI* do_ = static_cast<const TI*>(dout);
  const long long rows = (long long)B * S * H;
  flash_bwd_dot<TI><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const TI*>(o), do_, dsum, S, H, DH, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  TI* dq_ = static_cast<TI*>(dq);
  TI* dk_ = static_cast<TI*>(dk);
  TI* dv_ = static_cast<TI*>(dv);
  if constexpr (std::is_same<TI, __nv_bfloat16>::value) {
    // the WMMA route's 16-byte loads
    for (const void* p : {q, k, v, dout})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return cudaErrorMisalignedAddress;
    return launch_passes(flash_bwd_dkdv_wmma<DH>, flash_bwd_dq_wmma<DH>,
                         WmmaTiles<DH>::bytes, WmmaTiles<DH>::T, q_, k_, v_,
                         do_, lse, dsum, dq_, dk_, dv_, B, S, H, KH, causal,
                         window, scale, stream);
  } else {
    return launch_passes(flash_bwd_dkdv<DH>, flash_bwd_dq<DH>,
                         BwdTiles<DH>::bytes, BwdTiles<DH>::T, q_, k_, v_,
                         do_, lse, dsum, dq_, dk_, dv_, B, S, H, KH, causal,
                         window, scale, stream);
  }
}

template <typename TI>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* dsum, void* dq, void* dk, void* dv, int B, int S,
                     int H, int KH, int causal, int window, float scale,
                     cudaStream_t st) {
  switch (Dh) {
    case 64:
      return launch_bwd<64, TI>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                S, H, KH, causal, window, scale, st);
    case 120:
      return launch_bwd<120, TI>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                 S, H, KH, causal, window, scale, st);
    case 128:
      return launch_bwd<128, TI>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                 S, H, KH, causal, window, scale, st);
    case 256:
      return launch_bwd<256, TI>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                 S, H, KH, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block of passes (b) and (c) of a route (0:
// Dh unsupported).  dtype: 0 float32 (scalar route), 1 bf16 (WMMA route).
extern "C" int repro_flash_attention_bwd_smem_bytes(int Dh, int dtype) {
  switch (Dh) {
    case 64: return (int)(dtype ? WmmaTiles<64>::bytes : BwdTiles<64>::bytes);
    case 120:
      return (int)(dtype ? WmmaTiles<120>::bytes : BwdTiles<120>::bytes);
    case 128:
      return (int)(dtype ? WmmaTiles<128>::bytes : BwdTiles<128>::bytes);
    case 256:
      return (int)(dtype ? WmmaTiles<256>::bytes : BwdTiles<256>::bytes);
    default: return 0;
  }
}

// q, o, dout, dq: (B, S, H, Dh); k, v, dk, dv: (B, S, KH, Dh), all
// contiguous and of one type, on the current device; lse (the forward's)
// and dsum (a workspace the launch fills with D): (B, H, S) float32.
// dtype: 0 float32, 1 bf16.  Launches the three passes on `stream` and
// returns cudaGetLastError() after them (0 on success), or the error that
// refused one.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dsum, void* dq, void* dk,
                                         void* dv, int B, int S, int H,
                                         int KH, int Dh, int causal,
                                         int window, int dtype, float scale,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H <= 0 || H % KH != 0 ||
      (long long)B * H > 65535 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  return (int)(dtype == 1
                   ? dispatch<__nv_bfloat16>(Dh, q, k, v, o, dout, l, ds, dq,
                                             dk, dv, B, S, H, KH, causal,
                                             window, scale, st)
                   : dispatch<float>(Dh, q, k, v, o, dout, l, ds, dq, dk, dv,
                                     B, S, H, KH, causal, window, scale, st));
}
