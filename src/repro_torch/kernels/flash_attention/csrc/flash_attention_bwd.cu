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
// Three passes, on PyTorch's stream:
//  (a) D per (b, s, h) row, float32: `flash_bwd_dot_bf16` with 16-byte
//      loads, a row over 8-32 lanes; `flash_bwd_dot` one warp a row.
//  (b) dK and dV: one block per key tile (and, on the bf16 route, per
//      share of the query heads of its KV head).  It holds its K and V
//      tiles and the dK, dV accumulators, and walks its query heads and,
//      for each, the query tiles that can see its keys.  GQA and MQA sum
//      over the group inside the block.
//  (c) dQ: one block per (query tile, b * H), walking the key tiles its
//      rows can see (the forward's loop), dQ in registers.
// (b) and (c) both form P and dS; the products are computed twice (seven
// S^2 Dh products in all, against five for one pass with atomics on dQ),
// so that no pass needs atomics and the result does not depend on the
// order blocks run in.
//
// What bounds it on the H100: five products of S^2 Dh over the visible
// (query, key) pairs against reading q, k, v, o, dO and writing dq, dk,
// dv once; at the training shapes (S 1e3-4e3) that is the products.  Two
// routes, by dtype (a dispatch, not a fallback):
//  * bf16 (`_bf16` kernels): `wgmma` on tiles that TMA brings into shared
//    memory under mbarriers, P and dS formed in registers (see the section
//    below).  Tensor cores are the only way to the bf16 rate.
//  * float32 (scalar kernels): scalar FMAs out of float32 tiles, so that
//    a float32 model's gradients keep float32's digits (no TF32).
//
// Masks exactly as the forward's: causal (q >= k) and window (q - k <
// window); rows and keys past S are zero and masked, any S >= 1 works, and
// only tiles that can hold a visible pair are visited.  Dh is a template
// parameter (64, 120, 128, 256); the tiles are padded with zeros to a
// multiple of 32 columns (scalar) or 64 (bf16).  Inputs are float32 (the
// scalar kernels) or bf16 (the wgmma kernels; D reads both), read in their
// (B, S, heads, Dh) layout by stride; dq, dk, dv are written in the input
// type (bf16 rounded to nearest even), accumulated in float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// Hopper primitives (inline PTX for wgmma, TMA, mbarriers) and the tensor-map
// encoder, shared with the other kernels
#include "../../csrc/hopper.cuh"

namespace {

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

// (a) D[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], float32, one warp
// a row
__global__ void __launch_bounds__(256)
flash_bwd_dot(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ dsum, int S, int H, int Dh,
              long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp: row is warp-uniform
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int d = lane; d < Dh; d += 32)
    acc = fmaf(o[row * Dh + d], dout[row * Dh + d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long b = row / ((long long)S * H);
    const int s = (int)((row / H) % S), h = (int)(row % H);
    dsum[(b * H + h) * S + s] = acc;
  }
}

// the two bf16 halves of a packed pair as float32
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// (a) D on bf16 o and dO: `lanes` (8, 16 or 32, at least Dh / 8) threads a
// row, each loading 16 bytes of o and of dO at a time (rows on 16-byte
// boundaries), summed by xor-shuffles within the row's lanes
__global__ void __launch_bounds__(256)
flash_bwd_dot_bf16(const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   float* __restrict__ dsum, int S, int H, int Dh, int lanes,
                   long long rows) {
  const long long t = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long row = t / lanes;
  const int part = (int)(t % lanes);
  float acc = 0.f;
  if (row < rows) {
    const uint4* po = reinterpret_cast<const uint4*>(o + row * Dh);
    const uint4* pd = reinterpret_cast<const uint4*>(dout + row * Dh);
    for (int c = part; c < Dh / 8; c += lanes) {
      const uint4 a = po[c], d = pd[c];
      const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc = fmaf(bf16_lo(x[j]), bf16_lo(y[j]), acc);
        acc = fmaf(bf16_hi(x[j]), bf16_hi(y[j]), acc);
      }
    }
  }
  // every lane shuffles: the rows past the end add zeros
  for (int off = lanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) {
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
// bf16 route: `wgmma` tiles fed by TMA
//
// Both kernels have the forward's shape: one producer warpgroup, of which
// one warp issues the TMA loads into a ring of stages under mbarriers, and
// consumer warpgroups that run `wgmma` on what has arrived; `setmaxnreg`
// moves registers from the producer (24) to them (240 beside two, 160
// beside three).  Tiles lie in shared memory as panels of 64 columns (128
// bytes a row) with the 128-byte swizzle, one TMA box each; a tile is read
// K-major (its rows are M or N, Dh innermost) or MN-major (its rows are
// the product's K) through two descriptors over the same bytes.  Every
// score tile's accumulator layout is already the A operand layout of the
// product that follows, so P and dS go from registers to `wgmma` in bf16
// and never touch shared memory.  Each warpgroup runs a stage's products
// in order and waits for the last before the next stage: letting it run on
// into the next stage cost registers that serialised the `wgmma`s (C7512),
// measured slower by tools/flash_bwd_variants.py.
//
// (b) `flash_bwd_dkdv_bf16`: one CTA per (key tile, b * KH * splits).  The
//     producer loads K and V once, then a (Q, dO) tile of 64 queries with
//     those rows' lse (times log2 e) and D per stage, over the CTA's query
//     heads and, for each, the query tiles that can see its keys.  Each
//     consumer warpgroup owns 64 keys (three a CTA at Dh 64, two above)
//     and, per stage:
//       S^T = K Q^T and dP^T = V dO^T   (`wgmma_ss`, both K-major),
//       P^T = exp2(S^T scale log2 e - lse log2 e), masked by column,
//       dV += P^T dO                    (`wgmma_rs`, dO MN-major),
//       dS^T = P^T (dP^T - D),
//       dK += dS^T Q                    (`wgmma_rs`, Q MN-major),
//     dV's product overlapping the forming of dS, which takes P^T as that
//     product does, rounded to bf16, so that S^T's registers are free.  At
//     Dh 256 a thread cannot hold dK and dV over all 256 columns (2 x 128
//     floats), so the two consumer warpgroups share 64 keys and each owns
//     128 columns of dK and dV, both forming S^T and dP^T over the whole
//     head dim.  Under a causal mask the first key tiles see the most
//     queries: the grid's y is the key tile, so they start first for every
//     head.  MQA and GQA: where B * KH * key tiles would not fill the card,
//     the wrapper splits each KV head's G query heads over `splits` CTAs
//     (recurrentgemma has G 16, KH 1: 64 CTAs at B 1, S 4096 unsplit).
//     Each split writes its float32 partial dK (times scale) and dV to a
//     workspace, and `flash_bwd_reduce` sums the partials in split order
//     and rounds them; unsplit, the CTA writes dk and dv in bf16 itself.
// (c) `flash_bwd_dq_bf16`: one CTA per (64 query rows per consumer, b * H),
//     Q and dO loaded once, K and V tiles of 64 keys through the ring:
//       S = Q K^T and dP = dO V^T       (`wgmma_ss`, both K-major),
//       P and dS in registers, masked by row as in the forward,
//       dQ += dS K                      (`wgmma_rs`, K MN-major).
//     Three consumers at Dh 64, two at 120 and 128, one at 256, where the
//     shared memory holds Q and dO of 64 rows and two (K, V) stages.
// ------------------------------------------------------------------------

constexpr int WG = 128;         // threads of a warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr float LOG2E = 1.4426950408889634f;

template <int DH>
struct DkdvTiles {
  static constexpr int DHP = (DH + PANEL - 1) / PANEL * PANEL;  // 120 -> 128
  static constexpr int NP = DHP / PANEL;       // panels of a row
  // three consumers at Dh 64, where a thread's peak (dK, dV, S^T, dP^T: 128
  // floats) fits in 160 registers (tools/flash_bwd_variants.py times two)
  static constexpr int CONSUMERS = DHP == 64 ? 3 : 2;
  // registers a consumer thread gets from `setmaxnreg`: the producer's
  // warpgroup keeps 24 and the rest of the SM's 65,536 are shared out
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 240;
  static constexpr int DSPLIT = DHP > 128 ? 2 : 1;  // warpgroups a key block
  static constexpr int DN = DHP / DSPLIT;      // dK, dV columns a warpgroup
  static constexpr int BKEYS = 64 * CONSUMERS / DSPLIT;   // keys per CTA
  static constexpr int QT = 64;                // queries of a (Q, dO) stage
  static constexpr int STAGES = DHP > 128 ? 2 : DHP > 64 ? 3 : 4;
  static constexpr int KV_PANEL = BKEYS * ROW_BYTES;
  static constexpr int KV_BYTES = NP * KV_PANEL;   // K or V
  static constexpr int Q_PANEL = QT * ROW_BYTES;
  static constexpr int Q_BYTES = NP * Q_PANEL;     // Q or dO of a stage
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;
  static constexpr int ROWS_OFFSET = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = ROWS_OFFSET + STAGES * 2 * QT * 4;
  static_assert(QT == 64 || QT == 128, "S^T is 64 x 64 or 64 x 128");
  static constexpr int N_BARS = 1 + 2 * STAGES;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
  static constexpr int NT = (CONSUMERS + 1) * WG;
};

template <int DH>
struct DqTiles {
  static constexpr int DHP = (DH + PANEL - 1) / PANEL * PANEL;
  static constexpr int NP = DHP / PANEL;
  // three consumers at Dh 64, where a thread's tiles fit in 160 registers
  // (tools/flash_bwd_variants.py times two), one at Dh 256
  static constexpr int CONSUMERS = DHP > 128 ? 1 : DHP == 64 ? 3 : 2;
  static constexpr int CONSUMER_REGS = CONSUMERS == 3 ? 160 : 240;
  static constexpr int BQ = 64 * CONSUMERS;      // query rows per CTA
  static constexpr int BKEYS = 64;               // keys of a (K, V) stage
  static constexpr int STAGES = DHP > 128 ? 2 : 3;
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int Q_BYTES = NP * Q_PANEL;     // Q or dO
  static constexpr int KV_PANEL = BKEYS * ROW_BYTES;
  static constexpr int KV_BYTES = NP * KV_PANEL;   // one K or V stage
  static constexpr int BAR_OFFSET = 2 * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
  static constexpr int NT = (CONSUMERS + 1) * WG;
  static_assert(BKEYS == 64 || BKEYS == 128, "S is 64 x 64 or 64 x 128");
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// S (or S^T) of one 64-row block into acc (64 x N, N = 64 or 128): A (64
// rows) and B (N rows) K-major over NP panels, issued and committed
template <int NP, int NH>
__device__ __forceinline__ void issue_scores(float (&acc)[NH],
                                             const uint8_t* A, int a_panel,
                                             const uint8_t* Bt,
                                             int b_panel) {
#pragma unroll
  for (int kk = 0; kk < NP * 4; ++kk) {
    const int off = (kk % 4) * 32;  // 16 columns = 32 bytes
    wgmma_ss(acc, sw128_desc(A + (kk / 4) * a_panel + off, 16),
             sw128_desc(Bt + (kk / 4) * b_panel + off, 16), kk > 0);
  }
  wgmma_commit();
}

// acc (64 x N) += A (64 x 4 KF, bf16 fragments in registers) * B (4 KF
// rows of the product's K, MN-major from shared memory, panels `panel`
// apart), issued and committed
template <int N, int KF>
__device__ __forceinline__ void issue_rs(float (&acc)[N], uint32_t (&a)[KF],
                                         const uint8_t* Bt, int panel) {
  reg_fence(acc);
  reg_fence(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KF / 4; ++kk) {
    const uint32_t f[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3]};
    wgmma_rs(acc, f, sw128_desc(Bt + kk * 16 * ROW_BYTES, panel));
  }
  wgmma_commit();
}

// a 64-row float32 accumulator tile as the bf16 A fragments of a product
// over its columns
template <int NH>
__device__ __forceinline__ void to_frags(const float (&x)[NH],
                                         uint32_t (&a)[NH / 2]) {
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// (b) dK and dV of one key tile over one share of a KV head's query heads
template <int DH>
__global__ void __launch_bounds__(DkdvTiles<DH>::NT, 1)
flash_bwd_dkdv_bf16(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ dsum,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv,
                    float* __restrict__ part, long long part_stride, int S,
                    int H, int KH, int splits, int causal, int window,
                    float scale) {
  using T = DkdvTiles<DH>;
  constexpr int NP = T::NP, DN = T::DN, STAGES = T::STAGES, QT = T::QT;
  constexpr int CONSUMERS = T::CONSUMERS, BKEYS = T::BKEYS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = Ks + T::KV_BYTES;
  uint8_t* stages = Vs + T::KV_BYTES;
  float* rows_all = reinterpret_cast<float*>(smem + T::ROWS_OFFSET);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int split = blockIdx.x % splits;
  const int bkh = blockIdx.x / splits;
  const int b = bkh / KH, kh = bkh % KH;
  const int G = H / KH;
  const int per = (G + splits - 1) / splits;
  const int g_lo = min(G, split * per), g_hi = min(G, g_lo + per);
  const int k0 = blockIdx.y * BKEYS;
  // query tiles that can see a key of this tile: from the tile's own start
  // when causal, up to the last key's window
  const int q_lo_t = causal ? k0 / QT : 0;
  const int k_last = min(S - 1, k0 + BKEYS - 1);
  const int q_hi = window > 0 ? min(S, k_last + window) : S;
  const int q_hi_t = (q_hi + QT - 1) / QT;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 32);                    // every producer lane
      mbar_init(empty + s, CONSUMERS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: its first warp keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < CONSUMERS * WG + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(Ks + p * T::KV_PANEL, &tk, kv_full, p * PANEL, kh, k0,
                      b);
          tma_load_4d(Vs + p * T::KV_PANEL, &tv, kv_full, p * PANEL, kh, k0,
                      b);
        }
      }
      int it = 0;
      for (int g = g_lo; g < g_hi; ++g) {
        const int h = kh * G + g;
        const long long row_off = ((long long)b * H + h) * S;
        for (int qt = q_lo_t; qt < q_hi_t; ++qt, ++it) {
          const int s = it % STAGES;
          const int q0 = qt * QT;
          // the consumers have released this stage's previous tiles
          mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
          float* rows = rows_all + s * 2 * QT;   // lse log2 e, then D
          for (int r = lane; r < QT; r += 32) {
            const int qp = q0 + r;
            rows[r] = qp < S ? lse[row_off + qp] * LOG2E : 0.f;
            rows[QT + r] = qp < S ? dsum[row_off + qp] : 0.f;
          }
          if (lane == 0) {
            uint8_t* Qt = stages + s * T::STAGE_BYTES;
            mbar_expect_tx(full + s, T::STAGE_BYTES);
            for (int p = 0; p < NP; ++p) {
              tma_load_4d(Qt + p * T::Q_PANEL, &tq, full + s, p * PANEL, h,
                          q0, b);
              tma_load_4d(Qt + T::Q_BYTES + p * T::Q_PANEL, &tdo, full + s,
                          p * PANEL, h, q0, b);
            }
          } else {
            mbar_arrive(full + s);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;
    const int kblk = wg / T::DSPLIT;           // this warpgroup's 64 keys
    const int cpart = wg % T::DSPLIT;          // and dK, dV columns
    const int kw0 = k0 + 64 * kblk;
    const int my_key = kw0 + warp * 16 + lane / 4;  // and my_key + 8
    const int my_col = 2 * (lane % 4);              // within each 8 columns
    const float scale_log2 = scale * LOG2E;
    const uint8_t* Kw = Ks + kblk * 64 * ROW_BYTES;
    const uint8_t* Vw = Vs + kblk * 64 * ROW_BYTES;

    float dkacc[DN / 2], dvacc[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dkacc[i] = dvacc[i] = 0.f;
    float st[QT / 2], dpt[QT / 2];  // S^T then P^T; dP^T then dS^T
    uint32_t pfrag[QT / 4], dfrag[QT / 4];  // P^T and dS^T in bf16

    // the query tiles [w_lo, w_hi) hold a query that sees one of this
    // warpgroup's keys; the CTA's other stages are waited for and released
    int w_lo = q_hi_t, w_hi = q_hi_t;
    if (kw0 < S) {
      const int lo = causal ? kw0 / QT : 0;
      const int w_last = min(S - 1, kw0 + 63);   // the warpgroup's last key
      const int hi =
          window > 0 ? (min(S, w_last + window) + QT - 1) / QT : q_hi_t;
      w_lo = max(q_lo_t, min(lo, q_hi_t));
      w_hi = max(w_lo, min(hi, q_hi_t));
    }

    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + it % STAGES);
    };
    auto skip = [&](int it) {
      mbar_wait(full + it % STAGES, (it / STAGES) & 1);
      release(it);
    };
    auto process = [&](int it, int q0) {
      const int s = it % STAGES;
      const uint8_t* Qt = stages + s * T::STAGE_BYTES;
      const uint8_t* dOt = Qt + T::Q_BYTES;
      const float* rows = rows_all + s * 2 * QT;
      mbar_wait(full + s, (it / STAGES) & 1);
      wgmma_fence();
      issue_scores<NP>(st, Kw, T::KV_PANEL, Qt, T::Q_PANEL);
      issue_scores<NP>(dpt, Vw, T::KV_PANEL, dOt, T::Q_PANEL);
      wgmma_wait1();
      reg_fence(st);
      // the tile crosses S, the causal diagonal or the window's edge
      const bool partial = q0 + QT > S || kw0 + 64 > S ||
                           (causal && q0 < kw0 + 63) ||
                           (window > 0 && q0 + QT - 1 - kw0 >= window);
      // masked entries to -inf before the exponent, as in the forward:
      // only tiles that cross an edge pay for the mask (a select after the
      // exponent, on every tile, is 30-45% slower on the card:
      // tools/flash_bwd_variants.py)
      if (partial) {
#pragma unroll
        for (int i = 0; i < QT / 2; ++i)
          if (!visible(q0 + 8 * (i / 4) + my_col + i % 2,
                       my_key + 8 * ((i / 2) % 2), S, causal, window))
            st[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < QT / 2; ++i)
        st[i] = exp2f(fmaf(st[i], scale_log2,
                           -rows[8 * (i / 4) + my_col + i % 2]));
      to_frags(st, pfrag);
      issue_rs(dvacc, pfrag, dOt + cpart * (DN / PANEL) * T::Q_PANEL,
               T::Q_PANEL);
      wgmma_wait1();  // dP^T has completed; dV's product runs on
      reg_fence(dpt);
      // dS^T from P^T as dV's product takes it, rounded to bf16: S^T's
      // registers are free from the rounding on, and a dK/dV thread's peak
      // is its accumulators with S^T and dP^T
#pragma unroll
      for (int i = 0; i < QT / 2; ++i) {
        const int c = 8 * (i / 4) + my_col + i % 2;
        const uint32_t pp = pfrag[i / 2];
        dpt[i] = (i % 2 ? bf16_hi(pp) : bf16_lo(pp)) * (dpt[i] - rows[QT + c]);
      }
      to_frags(dpt, dfrag);
      wgmma_wait0();  // dV's product has read P^T's fragments
      reg_fence(dvacc);
      issue_rs(dkacc, dfrag, Qt + cpart * (DN / PANEL) * T::Q_PANEL,
               T::Q_PANEL);
      wgmma_wait0();
      reg_fence(dkacc);
      release(it);
    };

    mbar_wait(kv_full, 0);
    int it = 0;
    for (int g = g_lo; g < g_hi; ++g) {
      for (int qt = q_lo_t; qt < w_lo; ++qt) skip(it++);
      for (int qt = w_lo; qt < w_hi; ++qt) process(it++, qt * QT);
      for (int qt = w_hi; qt < q_hi_t; ++qt) skip(it++);
    }

    // this warpgroup's keys and columns: dK (times scale) and dV in bf16,
    // or a split's float32 partials
#pragma unroll
    for (int i = 0; i < DN / 2; i += 2) {
      const int key = my_key + 8 * ((i / 2) % 2);
      const int c = cpart * DN + 8 * (i / 4) + my_col;
      if (key < S && c < DH) {
        const long long off =
            (((long long)b * S + key) * KH + kh) * DH + c;
        if (part != nullptr) {
          float* pk = part + split * part_stride + off;
          float* pv = pk + splits * part_stride;
          *reinterpret_cast<float2*>(pk) =
              make_float2(dkacc[i] * scale, dkacc[i + 1] * scale);
          *reinterpret_cast<float2*>(pv) = make_float2(dvacc[i], dvacc[i + 1]);
        } else {
          *reinterpret_cast<uint32_t*>(dk + off) =
              pack_bf16(dkacc[i] * scale, dkacc[i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off) =
              pack_bf16(dvacc[i], dvacc[i + 1]);
        }
      }
    }
  }
}

// dk and dv (n elements each) <- the sum of their `splits` float32 partials
// (dk's, then dv's, `part_stride` apart), in split order, rounded to bf16;
// four elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_reduce(const float* __restrict__ part,
                 __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, long long part_stride,
                 int splits) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= part_stride) return;
  const int which = blockIdx.y;     // 0: dk, 1: dv
  const float* src = part + (long long)which * splits * part_stride + i;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int j = 1; j < splits; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(src + j * part_stride);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat16* dst = (which ? dv : dk) + i;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
}

// (c) dQ of one tile of query rows of one (b, head)
template <int DH>
__global__ void __launch_bounds__(DqTiles<DH>::NT, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dq, int S, int H, int KH,
                  int causal, int window, float scale) {
  using T = DqTiles<DH>;
  constexpr int NP = T::NP, DHP = T::DHP, BKEYS = T::BKEYS;
  constexpr int STAGES = T::STAGES, CONSUMERS = T::CONSUMERS, BQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* dOs = Qs + T::Q_BYTES;
  uint8_t* Ks = dOs + T::Q_BYTES;
  uint8_t* Vs = Ks + STAGES * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  // the last q-tiles have the most keys under a causal mask: start them
  // first, for every head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BKEYS * BKEYS : 0;
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_hi - k_lo + BKEYS - 1) / BKEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // beside one consumer (Dh 256) the launch already gives every thread
    // 255 registers: only two consumers move registers from the producer
    if constexpr (CONSUMERS > 1) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(Qs + p * T::Q_PANEL, &tq, q_full, p * PANEL, h, q0, b);
        tma_load_4d(dOs + p * T::Q_PANEL, &tdo, q_full, p * PANEL, h, q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const int k0 = k_lo + it * BKEYS;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, T::KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(Ks + s * T::KV_BYTES + p * T::KV_PANEL, &tk, k_full + s,
                      p * PANEL, kh, k0, b);
        mbar_expect_tx(v_full + s, T::KV_BYTES);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(Vs + s * T::KV_BYTES + p * T::KV_PANEL, &tv, v_full + s,
                      p * PANEL, kh, k0, b);
      }
    }
  } else {
    if constexpr (CONSUMERS > 1) setmaxnreg_inc<T::CONSUMER_REGS>();
    const int t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + wg * 64;
    const int my_row = row0 + warp * 16 + lane / 4;  // and my_row + 8
    const int my_col = 2 * (lane % 4);
    const float scale_log2 = scale * LOG2E;
    const uint8_t* Qw = Qs + wg * 64 * ROW_BYTES;
    const uint8_t* dOw = dOs + wg * 64 * ROW_BYTES;
    const long long row_off = ((long long)b * H + h) * S;
    float lse2[2], dd[2];   // this thread's rows' lse log2 e and D
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = my_row + 8 * hr;
      lse2[hr] = row < S ? lse[row_off + row] * LOG2E : 0.f;
      dd[hr] = row < S ? dsum[row_off + row] : 0.f;
    }

    float dqacc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) dqacc[i] = 0.f;
    float sc[BKEYS / 2], dp[BKEYS / 2];   // S then P; dP then dS
    uint32_t frag[BKEYS / 4];             // dS in bf16

    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + it % STAGES);
    };
    auto skip = [&](int it) {
      mbar_wait(k_full + it % STAGES, (it / STAGES) & 1);
      mbar_wait(v_full + it % STAGES, (it / STAGES) & 1);
      release(it);
    };
    auto process = [&](int it) {
      const int s = it % STAGES, par = (it / STAGES) & 1;
      const int k0 = k_lo + it * BKEYS;
      const uint8_t* Kt = Ks + s * T::KV_BYTES;
      const uint8_t* Vt = Vs + s * T::KV_BYTES;
      mbar_wait(k_full + s, par);
      wgmma_fence();
      issue_scores<NP>(sc, Qw, T::Q_PANEL, Kt, T::KV_PANEL);
      mbar_wait(v_full + s, par);
      issue_scores<NP>(dp, dOw, T::Q_PANEL, Vt, T::KV_PANEL);
      wgmma_wait1();
      reg_fence(sc);
      const bool partial = k0 + BKEYS > S ||
                           (causal && k0 + BKEYS - 1 > row0) ||
                           (window > 0 && row0 + 63 - k0 >= window);
      if (partial) {
#pragma unroll
        for (int i = 0; i < BKEYS / 2; ++i)
          if (!visible(my_row + 8 * ((i / 2) % 2),
                       k0 + 8 * (i / 4) + my_col + i % 2, S, causal, window))
            sc[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < BKEYS / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse2[(i / 2) % 2]));
      wgmma_wait0();
      reg_fence(dp);
#pragma unroll
      for (int i = 0; i < BKEYS / 2; ++i)
        dp[i] = sc[i] * (dp[i] - dd[(i / 2) % 2]);
      to_frags(dp, frag);
      issue_rs(dqacc, frag, Kt, T::KV_PANEL);
      wgmma_wait0();
      reg_fence(dqacc);
      release(it);
    };

    // as in the forward: the tiles [it_lo, it_hi) hold a visible key for
    // some row of this warpgroup
    int it_lo = 0, it_hi = row0 < S ? n_tiles : 0;
    if (causal) it_hi = min(it_hi, (row0 + 63 - k_lo) / BKEYS + 1);
    if (window > 0) it_lo = max(0, row0 - window + 1 - k_lo) / BKEYS;
    it_lo = min(it_lo, it_hi);

    mbar_wait(q_full, 0);
    for (int it = 0; it < it_lo; ++it) skip(it);
    for (int it = it_lo; it < it_hi; ++it) process(it);
    for (int it = max(it_lo, it_hi); it < n_tiles; ++it) skip(it);

#pragma unroll
    for (int i = 0; i < DHP / 2; i += 2) {
      const int row = my_row + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + my_col;
      if (row < S && c < DH)
        *reinterpret_cast<uint32_t*>(
            dq + (((long long)b * S + row) * H + h) * DH + c) =
            pack_bf16(dqacc[i] * scale, dqacc[i + 1] * scale);
    }
  }
}

// the f32 route's passes (b) and (c)
template <int DH>
cudaError_t launch_f32_passes(const float* q, const float* k, const float* v,
                              const float* dout, const float* lse,
                              const float* dsum, float* dq, float* dk,
                              float* dv, int B, int S, int H, int KH,
                              int causal, int window, float scale,
                              cudaStream_t stream) {
  using L = BwdTiles<DH>;
  for (const void* fn : {(const void*)flash_bwd_dkdv<DH>,
                         (const void*)flash_bwd_dq<DH>}) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (S + L::T - 1) / L::T;
  flash_bwd_dkdv<DH><<<dim3(tiles, B * KH), NT, L::bytes, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, S, H, KH, causal, window, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<DH><<<dim3(tiles, B * H), NT, L::bytes, stream>>>(
      q, k, v, dout, lse, dsum, dq, S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

// the bf16 route's passes (b), the reduce where the heads are split, and (c)
template <int DH>
cudaError_t launch_bf16_passes(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* dsum, void* dq, void* dk,
                               void* dv, float* part, int B, int S, int H,
                               int KH, int splits, int causal, int window,
                               float scale, cudaStream_t stream) {
  using TB = DkdvTiles<DH>;
  using TC = DqTiles<DH>;
  for (const void* p : {q, k, v, dout})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  if (splits < 1 || splits > H / KH || (splits > 1) != (part != nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tq_b, tdo_b, tk_b, tv_b, tq_c, tdo_c, tk_c, tv_c;
  if (!make_bshd_map(&tq_b, q, B, S, H, DH, TB::QT) ||
      !make_bshd_map(&tdo_b, dout, B, S, H, DH, TB::QT) ||
      !make_bshd_map(&tk_b, k, B, S, KH, DH, TB::BKEYS) ||
      !make_bshd_map(&tv_b, v, B, S, KH, DH, TB::BKEYS) ||
      !make_bshd_map(&tq_c, q, B, S, H, DH, TC::BQ) ||
      !make_bshd_map(&tdo_c, dout, B, S, H, DH, TC::BQ) ||
      !make_bshd_map(&tk_c, k, B, S, KH, DH, TC::BKEYS) ||
      !make_bshd_map(&tv_c, v, B, S, KH, DH, TC::BKEYS))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TB::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TC::bytes);
  if (err != cudaSuccess) return err;
  __nv_bfloat16* dk_ = static_cast<__nv_bfloat16*>(dk);
  __nv_bfloat16* dv_ = static_cast<__nv_bfloat16*>(dv);
  const long long part_stride = (long long)B * S * KH * DH;
  flash_bwd_dkdv_bf16<DH>
      <<<dim3(B * KH * splits, (S + TB::BKEYS - 1) / TB::BKEYS), TB::NT,
         TB::bytes, stream>>>(tq_b, tk_b, tv_b, tdo_b, lse, dsum, dk_, dv_,
                              part, part_stride, S, H, KH, splits, causal,
                              window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (splits > 1) {
    const long long blocks = (part_stride / 4 + 255) / 256;
    flash_bwd_reduce<<<dim3((unsigned)blocks, 2), 256, 0, stream>>>(
        part, dk_, dv_, part_stride, splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_bwd_dq_bf16<DH>
      <<<dim3(B * H, (S + TC::BQ - 1) / TC::BQ), TC::NT, TC::bytes,
         stream>>>(tq_c, tk_c, tv_c, tdo_c, lse, dsum,
                   static_cast<__nv_bfloat16*>(dq), S, H, KH, causal, window,
                   scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dsum, void* dq, void* dk, void* dv, float* part,
                       int B, int S, int H, int KH, int splits, int causal,
                       int window, int bf16, float scale,
                       cudaStream_t stream) {
  const long long rows = (long long)B * S * H;
  if (bf16) {
    if (reinterpret_cast<uintptr_t>(o) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dout) % 16 != 0)
      return cudaErrorMisalignedAddress;
    const int lanes = DH > 128 ? 32 : DH > 64 ? 16 : 8;
    flash_bwd_dot_bf16<<<(unsigned)((rows * lanes + 255) / 256), 256, 0,
                         stream>>>(static_cast<const __nv_bfloat16*>(o),
                                   static_cast<const __nv_bfloat16*>(dout),
                                   dsum, S, H, DH, lanes, rows);
  } else {
    flash_bwd_dot<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dsum,
        S, H, DH, rows);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (bf16)
    return launch_bf16_passes<DH>(q, k, v, dout, lse, dsum, dq, dk, dv, part,
                                  B, S, H, KH, splits, causal, window, scale,
                                  stream);
  if (splits != 1 || part != nullptr) return cudaErrorInvalidValue;
  return launch_f32_passes<DH>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      dsum, static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), B, S, H, KH, causal, window, scale, stream);
}

template <int DH>
int smem_bytes(int bf16) {
  return (int)(bf16 ? (DkdvTiles<DH>::bytes > DqTiles<DH>::bytes
                           ? DkdvTiles<DH>::bytes
                           : DqTiles<DH>::bytes)
                    : BwdTiles<DH>::bytes);
}

}  // namespace

// The larger dynamic shared memory of one block of passes (b) and (c) of a
// route (0: Dh unsupported).  dtype: 0 float32 (scalar route), 1 bf16
// (wgmma route).
extern "C" int repro_flash_attention_bwd_smem_bytes(int Dh, int dtype) {
  switch (Dh) {
    case 64: return smem_bytes<64>(dtype);
    case 120: return smem_bytes<120>(dtype);
    case 128: return smem_bytes<128>(dtype);
    case 256: return smem_bytes<256>(dtype);
    default: return 0;
  }
}

// q, o, dout, dq: (B, S, H, Dh); k, v, dk, dv: (B, S, KH, Dh), all
// contiguous and of one type, on the current device; lse (the forward's)
// and dsum (a workspace the launch fills with D): (B, H, S) float32.
// dtype: 0 float32, 1 bf16 (q, k, v, dout on 16-byte boundaries).
// splits: the shares of each KV head's query heads in the bf16 dK/dV pass
// (1 on the float32 route); above 1, `part` is a float32 workspace of
// 2 * splits * B * S * KH * Dh elements, else null.  Launches the passes on
// `stream` and returns cudaGetLastError() after them (0 on success), or
// the error that refused one.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dsum, void* dq, void* dk,
                                         void* dv, void* part, int B, int S,
                                         int H, int KH, int Dh, int causal,
                                         int window, int dtype, int splits,
                                         float scale, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H <= 0 || H % KH != 0 ||
      (long long)B * H > 65535 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* pt = static_cast<float*>(part);
  switch (Dh) {
    case 64:
      return (int)launch_bwd<64>(q, k, v, o, dout, l, ds, dq, dk, dv, pt, B,
                                 S, H, KH, splits, causal, window, dtype,
                                 scale, st);
    case 120:
      return (int)launch_bwd<120>(q, k, v, o, dout, l, ds, dq, dk, dv, pt, B,
                                  S, H, KH, splits, causal, window, dtype,
                                  scale, st);
    case 128:
      return (int)launch_bwd<128>(q, k, v, o, dout, l, ds, dq, dk, dv, pt, B,
                                  S, H, KH, splits, causal, window, dtype,
                                  scale, st);
    case 256:
      return (int)launch_bwd<256>(q, k, v, o, dout, l, ds, dq, dk, dv, pt, B,
                                  S, H, KH, splits, causal, window, dtype,
                                  scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
