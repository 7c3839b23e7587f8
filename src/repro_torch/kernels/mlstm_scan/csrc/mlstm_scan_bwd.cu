// Chunkwise mLSTM backward for Hopper (sm_90a), hand-written CUDA C++.
//
// The gradient of the forward in mlstm_scan.cu.  The TPU kernel it stands
// beside, `_mlstm_kernel` (`mlstm_chunkwise_pallas` in
// src/repro/kernels/mlstm_scan/kernel.py), has no backward of its own: the
// reference trains through jax.grad of its plain chunkwise function.  Here
// it is the plain backward of ref.py (`reference_mlstm_bwd`) as kernels,
// to q, k, v and the per-step terms of ig and fg.  h does not depend on the
// stabilisers in exact arithmetic, so every m is a constant: with
// q~ = q / sqrt(Dh), F_t = sum_{s<=t} logsigmoid(fg_s), the forward's row
// statistics m_t and den_t (the denominator before its clamp), N_t =
// max(|den_t|, exp(-m_t)) and w_ts = exp(F_t - F_s + ig_s - m_t), s <= t:
//
//   dnum_t = dh_t / N_t,  dden_t = -(dh_t . h_t) / den_t  where the clamp is
//            not active (|den_t| > exp(-m_t)), else 0
//   dS_ts  = w_ts (dnum_t . v_s + dden_t)
//   dq~_t  = sum_s dS_ts k_s,   dk_s = sum_t dS_ts q~_t,
//   dv_s   = sum_t w_ts (q~_t . k_s) dnum_t,
//   dig_s  = sum_t dS_ts (q~_t . k_s)  (inside a chunk as column sums,
//            across chunks as k_s . dk_s, which cancels more),
//   row_t  = sum_s dS_ts (q~_t . k_s) = (dh_t . h_t) where the clamp is
//            active, else 0
//
// and the wrapper finishes the gates in PyTorch: dF = row - dig, its reverse
// cumsum, times sigmoid(-fg).  Pairs inside a chunk of T steps are summed as
// they stand; pairs across a boundary go through states, the chunk's
// boundary stabiliser being the row stabiliser of the step before it (so
// the backward takes any chunk, whatever the forward's route used):
//   forwards:  C, n entering each chunk (as the forward carries them) give
//              dq~_t += w_out_t (C dnum_t + dden_t n);
//   backwards: D = sum over later t of exp(F_t - F_e + m_e - m_t) q~_t
//              dnum_t^T (and Dn with dden_t q~_t) gives dk_s += g_s (D v_s +
//              Dn) and dv_s += g_s D^T k_s,
// with w_out_t = exp(F_t - F_e + m_e - m_t), g_s = exp(ig_s + F_end - F_s -
// m_end) and the decay over a chunk f = exp(F_end - F_e + m_e - m_end), all
// at most 1: no stabiliser of its own is needed.
//
// What bounds it on the H100: its operations.  Per (b, h) and chunk the
// state products are five of T Dh^2 multiply-adds (C's update, C dnum, D's
// update, D v, D^T k) and the chunk's own pairs five of T^2 Dh: at
// xlstm-1.3b's training shape (B 1, S 4096, H 4, Dh 1024) 182.5 GFLOP, 2.7
// ms on float32 CUDA cores (0.18 ms at the bf16 tensor-core rate), against
// 0.07 ms for its bytes.
//
// Three routes, the forward's, each taken by the backward of a forward on
// it (ops.py picks it by dtype and shape; a route refuses what it cannot
// take, nothing falls back):
//  * wgmma_bf16: bf16 q, k, v that TMA can address.  The state and pair
//    products on bf16 tensor cores with the float32 factors split into bf16
//    halves, C^T and D^T materialised per chunk of 128 (see its section).
//  * scalar_bf16 (bf16 that TMA cannot address) and scalar_f32: scalar
//    float32 FMAs, described here.  They compute D's update twice (passes 3
//    and 4), six state products where five would do.
//
// Scalar routes: q, k, v read as bf16 or float32, five launches:
//  1. prep,  grid (B*H*chunks): per row dh . h (a warp a row), the chunk's
//            float64 cumsum of logsigmoid(fg) and from them w_out, g, dden,
//            1/N, row; per chunk f.
//  2-4. slab passes, grid (B*H * Dh/32): each block keeps a 32-row slab of
//            a (Dh, Dh) state in shared memory (128 KiB at Dh 1024; past Dh
//            1536 in device memory, its own slab, through L2) and walks the
//            chunks, per chunk first the output rows of its 32 slab rows
//            from the state as it stands (lane = slab row, a warp 8 steps),
//            then the state's update (a warp 4 slab rows, a lane 2 of 64
//            columns of a staged tile):
//            2. forwards, the state C (rows: keys) from the initial one:
//               dq~ (the inter-chunk part);
//            3. backwards, D (rows: keys): dk (the inter-chunk part);
//            4. backwards, D^T (rows: values): dv (the inter-chunk part).
//            The slab owns whole rows of the products it outputs, so no
//            block's partial sum meets another's: no atomics, no reduction.
//  5. intra, grid (B*H*chunks): the chunk's q~ k^T and dnum v^T (T x T),
//            then dS and w o (q~ k^T), then per 64-column tile dq~, dk, dv
//            of the chunk's own pairs, plus the slab passes' parts: dq, dk,
//            dv written in the input dtype, and dig.
// Their workspace holds the per-row scalars and the three inter-chunk parts
// (float32, B*S*H*Dh each): nothing grows with the number of chunks.
//
// The Hopper primitives (inline PTX) are in ../../csrc/hopper.cuh; the
// forward's gate, q k^T and state passes, which the wgmma route runs too,
// in mlstm_wgmma.cuh.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "mlstm_wgmma.cuh"

namespace {

// ===========================================================================
// Scalar routes (scalar_f32, scalar_bf16)
// ===========================================================================

constexpr int T = 64;        // steps per chunk
constexpr int KS = 32;       // state rows of a slab block: one per lane
constexpr int BT = 64;       // columns of a staged tile
constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;
constexpr int TS = BT + 4;   // row stride of a staged tile (float4 rows)
constexpr int US = KS + 4;   // row stride of the staged u A rows
constexpr int PS = T + 1;    // row stride of the intra pass's matrices
constexpr int PER = T * BT / NT;   // elements of a staged tile a thread
                                   // loads: all issued before any is used
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use
static_assert(NW * 8 == T && NW * 4 == KS && BT == 64, "8 warps");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T_>
__device__ __forceinline__ T_ from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// row stride of a slab's state: whole tiles, then 4 floats so that the
// float4 rows of a warp's 8-lane phases fall on distinct banks
__host__ __device__ inline int x_stride(int Dh) {
  return (int)round_up(Dh, BT) + 4;
}

// floats of a slab block's dynamic shared memory
__host__ inline long long slab_smem_floats(int Dh, bool smem_x) {
  return (smem_x ? (long long)KS * x_stride(Dh) : 0) + T * TS + T * US +
         5 * T + KS;
}

constexpr long long INTRA_SMEM_BYTES =
    6LL * T * PS * 4 + T * 8 + 5LL * T * 4;

// Byte offsets of the workspace's parts (each 256-byte aligned).
struct BwdWs {
  long long b, wout, g, dden, invn, f, dqi, dki, dvi, x, bytes;
};

__host__ inline BwdWs bwd_ws(int B, int S, int H, int Dh) {
  const long long rows = (long long)B * S * H, BH = (long long)B * H;
  const long long n_chunks = (S + T - 1) / T, n_slabs = (Dh + KS - 1) / KS;
  const bool smem_x = 4 * slab_smem_floats(Dh, true) <= SMEM_LIMIT;
  BwdWs w;
  w.b = 0;                                   // in-chunk cumsum, float64
  w.wout = up256(w.b + 8 * rows);
  w.g = up256(w.wout + 4 * rows);
  w.dden = up256(w.g + 4 * rows);
  w.invn = up256(w.dden + 4 * rows);
  w.f = up256(w.invn + 4 * rows);            // per (b, h, chunk)
  w.dqi = up256(w.f + 4 * BH * n_chunks);    // the slab passes' parts
  w.dki = up256(w.dqi + 4 * rows * Dh);
  w.dvi = up256(w.dki + 4 * rows * Dh);
  w.x = up256(w.dvi + 4 * rows * Dh);        // slabs in device memory
  w.bytes = w.x + (smem_x ? 0 : 4LL * BH * n_slabs * KS * x_stride(Dh));
  return w;
}

// (b, h) of a block and the rows of one chunk
struct ChunkRows {
  long long bh, gbase;   // gbase: row of (b, t0, h) in (B, S, H)
  int t0, L;
};

__device__ __forceinline__ ChunkRows chunk_rows(long long bh, int c, int S,
                                                int H) {
  ChunkRows r;
  r.bh = bh;
  r.t0 = c * T;
  r.L = min(T, S - r.t0);
  r.gbase = (bh / H * S + r.t0) * H + bh % H;
  return r;
}

// ---------------------------------------------------------------------------
// Pass 1: the per-row scalars of one chunk
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
mlstm_bwd_prep_kernel(const float* __restrict__ ig,
                      const float* __restrict__ fg,
                      const float* __restrict__ m0,
                      const float* __restrict__ h,
                      const float* __restrict__ dh,
                      const float* __restrict__ mstat,
                      const float* __restrict__ dstat, double* __restrict__ wb,
                      float* __restrict__ wout, float* __restrict__ wg,
                      float* __restrict__ wdden, float* __restrict__ winvn,
                      float* __restrict__ wf, float* __restrict__ row_out,
                      int S, int H, int Dh, int n_chunks) {
  __shared__ double sb[T];
  __shared__ float sdhh[T];
  const int c = blockIdx.x % n_chunks;
  const ChunkRows cr = chunk_rows(blockIdx.x / n_chunks, c, S, H);
  const int L = cr.L;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < L; r += NW) {   // dh . h, a warp a row
    const long long base = (cr.gbase + (long long)r * H) * Dh;
    float acc = 0.f;
    for (int j = lane; j < Dh; j += 32)
      acc = fmaf(dh[base + j], h[base + j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) sdhh[r] = acc;
  }
  if (tid == 0) {   // the chunk's cumulative log-forget, in order
    double acc = 0.0;
    for (int t = 0; t < L; ++t) {
      acc += log_sigmoid(fg[cr.gbase + (long long)t * H]);
      sb[t] = acc;
    }
  }
  __syncthreads();
  // the boundaries' stabilisers: the row stabilisers of the steps before
  const float me = cr.t0 == 0 ? (m0 != nullptr ? m0[cr.bh] : NEG_INF)
                              : mstat[cr.gbase - H];
  const float mend = mstat[cr.gbase + (long long)(L - 1) * H];
  const double bT = sb[L - 1];
  if (tid < L) {
    const long long row = cr.gbase + (long long)tid * H;
    const float mt = mstat[row], den = dstat[row], floor = expf(-mt);
    const bool active = fabsf(den) > floor;
    const float dhh = sdhh[tid];
    wb[row] = sb[tid];
    wout[row] = expf(((float)sb[tid] + me) - mt);
    wg[row] = expf((ig[row] + (float)(bT - sb[tid])) - mend);
    wdden[row] = active ? -dhh / den : 0.f;
    winvn[row] = 1.f / fmaxf(fabsf(den), floor);
    row_out[row] = active ? 0.f : dhh;
  }
  if (tid == 0)
    wf[cr.bh * n_chunks + c] = expf(((float)bT + me) - mend);
}

// ---------------------------------------------------------------------------
// Passes 2-4: a 32-row slab of a state, walked over the chunks
// ---------------------------------------------------------------------------
// Sources: 0 q (times 1/sqrt(Dh)), 1 k, 2 v, 3 dh (times 1/N_t).  Per
// mode: Y, dotted with the slab's rows for the output; A, the slab's rows of
// the update u_t A_t B_t^T; Bv, its columns.
template <int MODE>
struct SlabMode;
template <>
struct SlabMode<0> {   // C (keys x values), forwards: dq~ += w_out (C dnum
                       // + dden n); C += g k v^T, n += g k
  static constexpr int Y = 3, A = 1, Bv = 2;
  static constexpr bool forward = true, vec = true;
};
template <>
struct SlabMode<1> {   // D (keys x values), backwards: dk += g (D v + Dn);
                       // D += w_out q~ dnum^T, Dn += w_out dden q~
  static constexpr int Y = 2, A = 0, Bv = 3;
  static constexpr bool forward = false, vec = true;
};
template <>
struct SlabMode<2> {   // D^T (values x keys), backwards: dv += g D^T k;
                       // D^T += w_out dnum q~^T
  static constexpr int Y = 1, A = 3, Bv = 0;
  static constexpr bool forward = false, vec = false;
};

template <typename TQ>
struct Sources {
  const TQ* q;
  const TQ* k;
  const TQ* v;
  const float* dh;
  __device__ __forceinline__ float load(int src, long long i) const {
    switch (src) {
      case 0: return to_f32(q[i]);
      case 1: return to_f32(k[i]);
      case 2: return to_f32(v[i]);
      default: return dh[i];
    }
  }
};

template <typename TQ, int MODE, bool SMEM_X>
__global__ void __launch_bounds__(NT)
mlstm_bwd_slab_kernel(Sources<TQ> src, const float* __restrict__ C0,
                      const float* __restrict__ n0,
                      const float* __restrict__ wout,
                      const float* __restrict__ wg,
                      const float* __restrict__ wdden,
                      const float* __restrict__ winvn,
                      const float* __restrict__ wf, float* __restrict__ out,
                      float* __restrict__ xg, int S, int H, int Dh,
                      int n_chunks, int n_slabs, float inv_sqrt_dh) {
  using M = SlabMode<MODE>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int XS = x_stride(Dh);
  float* X = SMEM_X ? smem : xg + (long long)blockIdx.x * KS * XS;
  float* tile = smem + (SMEM_X ? KS * XS : 0);   // T x TS
  float* uA = tile + T * TS;                     // T x US: u_t A_t[a]
  float* s_o = uA + T * US;                      // output coefficient
  float* s_z = s_o + T;                          // its n term's weight
  float* s_y = s_z + T;                          // n update's weight
  float* s_u = s_y + T;                          // state update's weight
  float* s_iv = s_u + T;                         // 1 / N_t
  float* nv = s_iv + T;                          // KS: n or Dn of the slab

  const long long bh = blockIdx.x / n_slabs;
  const int a0 = (int)(blockIdx.x % n_slabs) * KS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long DD = (long long)Dh * Dh;

  // ---- the initial state: C0's slab going forwards, else zero -----------
  for (int e = tid; e < KS * XS; e += NT) {
    const int a = e / XS, j = e % XS;
    float x = 0.f;
    if (M::forward && C0 != nullptr && a0 + a < Dh && j < Dh)
      x = C0[bh * DD + (long long)(a0 + a) * Dh + j];
    X[e] = x;
  }
  if (tid < KS)
    nv[tid] = (M::forward && n0 != nullptr && a0 + tid < Dh)
                  ? n0[bh * Dh + a0 + tid]
                  : 0.f;
  __syncthreads();

  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c = M::forward ? ci : n_chunks - 1 - ci;
    const ChunkRows cr = chunk_rows(bh, c, S, H);
    const int L = cr.L;
    auto elem = [&](int t) {   // element index of (t, 0) of this head
      return (cr.gbase + (long long)t * H) * Dh;
    };
    auto scale = [&](int s, int t) {
      return s == 0 ? inv_sqrt_dh : s == 3 ? s_iv[t] : 1.f;
    };
    // columns [b0, b0 + BT) of source s for the chunk's steps into v (this
    // thread's PER elements, zero past L and Dh), and v into the tile
    auto fetch = [&](float (&v)[PER], int s, int b0) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = tid + u * NT, t = e / BT, j = e % BT;
        v[u] = (t < L && b0 + j < Dh)
                   ? scale(s, t) * src.load(s, elem(t) + b0 + j)
                   : 0.f;
      }
    };
    auto put = [&](const float (&v)[PER]) {
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int e = tid + u * NT;
        tile[(e / BT) * TS + e % BT] = v[u];
      }
    };
    if (tid < T) {
      const int t = tid;
      float o = 0.f, z = 0.f, y = 0.f, u = 0.f, iv = 0.f;
      if (t < L) {
        const long long row = cr.gbase + (long long)t * H;
        const float wo = wout[row], g = wg[row], dd = wdden[row];
        iv = winvn[row];
        if (MODE == 0) {
          o = wo; u = g; z = dd; y = 1.f;
        } else if (MODE == 1) {
          o = g; u = wo; z = 1.f; y = dd;
        } else {
          o = g; u = wo;
        }
      }
      s_o[t] = o;
      s_z[t] = z;
      s_y[t] = y;
      s_u[t] = u;
      s_iv[t] = iv;
    }
    const float f = wf[bh * n_chunks + c];
    __syncthreads();
    // u_t A_t over the slab's rows, zero past L and past Dh
    {
      constexpr int N = T * KS / NT;
      float v[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int e = tid + u * NT, t = e / KS, a = e % KS;
        v[u] = (t < L && a0 + a < Dh)
                   ? s_u[t] * scale(M::A, t) *
                         src.load(M::A, elem(t) + a0 + a)
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const int e = tid + u * NT;
        uA[(e / KS) * US + e % KS] = v[u];
      }
    }

    // ---- outputs from the state as it stands: lane = slab row, a warp 8
    // steps.  Each tile's loads are in flight while the one before is
    // summed; the last one's fetch the update's first tile.
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
    float pre[PER];
    fetch(pre, M::Y, 0);
    for (int b0 = 0; b0 < Dh; b0 += BT) {
      put(pre);
      __syncthreads();
      if (b0 + BT < Dh)
        fetch(pre, M::Y, b0 + BT);
      else
        fetch(pre, M::Bv, 0);
      const float* xr = X + lane * XS + b0;
      for (int j = 0; j < BT; j += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(xr + j);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 y4 = *reinterpret_cast<const float4*>(
              tile + (8 * warp + r) * TS + j);
          acc[r] = fmaf(x4.x, y4.x, acc[r]);
          acc[r] = fmaf(x4.y, y4.y, acc[r]);
          acc[r] = fmaf(x4.z, y4.z, acc[r]);
          acc[r] = fmaf(x4.w, y4.w, acc[r]);
        }
      }
      __syncthreads();
    }
    if (a0 + lane < Dh) {
      const float nl = nv[lane];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int t = 8 * warp + r;
        if (t < L)
          out[elem(t) + a0 + lane] = s_o[t] * (acc[r] + s_z[t] * nl);
      }
    }

    // ---- the state's update: a warp 4 slab rows, a lane columns j and
    // j + 32 of each tile
    for (int b0 = 0; b0 < Dh; b0 += BT) {
      put(pre);
      __syncthreads();
      if (b0 + BT < Dh) fetch(pre, M::Bv, b0 + BT);
      float up[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) up[i][0] = up[i][1] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float4 u4 =
            *reinterpret_cast<const float4*>(uA + t * US + 4 * warp);
        const float bv0 = tile[t * TS + lane], bv1 = tile[t * TS + lane + 32];
        up[0][0] = fmaf(u4.x, bv0, up[0][0]);
        up[0][1] = fmaf(u4.x, bv1, up[0][1]);
        up[1][0] = fmaf(u4.y, bv0, up[1][0]);
        up[1][1] = fmaf(u4.y, bv1, up[1][1]);
        up[2][0] = fmaf(u4.z, bv0, up[2][0]);
        up[2][1] = fmaf(u4.z, bv1, up[2][1]);
        up[3][0] = fmaf(u4.w, bv0, up[3][0]);
        up[3][1] = fmaf(u4.w, bv1, up[3][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* xa = X + (4 * warp + i) * XS + b0 + lane;
        xa[0] = fmaf(f, xa[0], up[i][0]);
        xa[32] = fmaf(f, xa[32], up[i][1]);
      }
      __syncthreads();
    }
    if (M::vec && tid < KS) {
      float sum = 0.f;
      for (int t = 0; t < L; ++t) sum = fmaf(uA[t * US + tid], s_y[t], sum);
      nv[tid] = fmaf(f, nv[tid], sum);
    }
    __syncthreads();   // before the next chunk restages the coefficients
  }
}

// ---------------------------------------------------------------------------
// Pass 5: the chunk's own pairs, and the sums of all parts
// ---------------------------------------------------------------------------
template <typename TQ>
__global__ void __launch_bounds__(NT)
mlstm_bwd_intra_kernel(Sources<TQ> src, const float* __restrict__ ig,
                       const float* __restrict__ mstat,
                       const double* __restrict__ wb,
                       const float* __restrict__ wdden,
                       const float* __restrict__ winvn,
                       const float* __restrict__ dqi,
                       const float* __restrict__ dki,
                       const float* __restrict__ dvi, TQ* __restrict__ dq,
                       TQ* __restrict__ dk, TQ* __restrict__ dv,
                       float* __restrict__ dig, int S, int H, int Dh,
                       int n_chunks, float inv_sqrt_dh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* tq = smem;               // T x PS: q~ of a column tile
  float* tk = tq + T * PS;        // k
  float* tn = tk + T * PS;        // dnum
  float* tv = tn + T * PS;        // v
  float* dS = tv + T * PS;        // T x PS
  float* W = dS + T * PS;         // T x PS: w o (q~ k^T)
  double* s_b = reinterpret_cast<double*>(W + T * PS);
  float* s_ig = reinterpret_cast<float*>(s_b + T);
  float* s_m = s_ig + T;
  float* s_dd = s_m + T;
  float* s_iv = s_dd + T;
  float* s_dig = s_iv + T;        // dig of the chunk's own pairs

  const int c = blockIdx.x % n_chunks;
  const ChunkRows cr = chunk_rows(blockIdx.x / n_chunks, c, S, H);
  const int L = cr.L;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (tid < T) {
    const bool ok = tid < L;
    const long long row = cr.gbase + (long long)tid * H;
    s_b[tid] = ok ? wb[row] : 0.0;
    s_ig[tid] = ok ? ig[row] : 0.f;
    s_m[tid] = ok ? mstat[row] : 0.f;
    s_dd[tid] = ok ? wdden[row] : 0.f;
    s_iv[tid] = ok ? winvn[row] : 0.f;
  }
  __syncthreads();
  auto elem = [&](int t) { return (cr.gbase + (long long)t * H) * Dh; };
  // stage columns [j0, j0 + 64) of q~, k, dnum (and v), zero past L and
  // Dh, every load issued before any is stored
  auto stage = [&](int j0, bool with_v) {
    constexpr int N = T * T / NT;
    float vq[N], vk[N], vn[N], vv[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = tid + u * NT, t = e / T, j = e % T;
      const bool ok = t < L && j0 + j < Dh;
      const long long i = elem(t) + j0 + j;
      vq[u] = ok ? src.load(0, i) * inv_sqrt_dh : 0.f;
      vk[u] = ok ? src.load(1, i) : 0.f;
      vn[u] = ok ? src.load(3, i) * s_iv[t] : 0.f;
      vv[u] = ok && with_v ? src.load(2, i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = tid + u * NT, o = (e / T) * PS + e % T;
      tq[o] = vq[u];
      tk[o] = vk[u];
      tn[o] = vn[u];
      if (with_v) tv[o] = vv[u];
    }
  };

  // ---- q~ k^T and dnum v^T of the chunk (rows ty + 16 r, cols tx + 16 u)
  float sacc[4][4], pacc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) sacc[r][u] = pacc[r][u] = 0.f;
  for (int j0 = 0; j0 < Dh; j0 += T) {
    stage(j0, true);
    __syncthreads();
    for (int i = 0; i < T; ++i) {
      float qa[4], na[4], kb[4], vb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[r] = tq[(ty + 16 * r) * PS + i];
        na[r] = tn[(ty + 16 * r) * PS + i];
        kb[r] = tk[(tx + 16 * r) * PS + i];
        vb[r] = tv[(tx + 16 * r) * PS + i];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sacc[r][u] = fmaf(qa[r], kb[u], sacc[r][u]);
          pacc[r][u] = fmaf(na[r], vb[u], pacc[r][u]);
        }
    }
    __syncthreads();
  }
  // ---- dS = w (dnum . v + dden) and W = w (q~ . k), causal, rows below L;
  // the column sums of dS o (q~ . k), this thread's rows, into tv's first
  // 16 rows (tv is free now), then over them
  float colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = ty + 16 * r, s = tx + 16 * u;
      float w = 0.f;
      if (s <= t && t < L)
        w = expf(((float)(s_b[t] - s_b[s]) + s_ig[s]) - s_m[t]);
      const float ds = w * (pacc[r][u] + s_dd[t]);
      dS[t * PS + s] = ds;
      W[t * PS + s] = w * sacc[r][u];
      colp[u] = fmaf(ds, sacc[r][u], colp[u]);
    }
#pragma unroll
  for (int u = 0; u < 4; ++u) tv[ty * PS + tx + 16 * u] = colp[u];
  __syncthreads();
  if (tid < T) {
    float d = 0.f;
    for (int y = 0; y < NT / 16; ++y) d += tv[y * PS + tid];
    s_dig[tid] = d;
  }

  // ---- per column tile: dq~ = dS k, dk = dS^T q~, dv = W^T dnum, plus the
  // slab passes' parts; k . dk's part across chunks summed over the tiles
  float dig_acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = 0; j0 < Dh; j0 += T) {
    stage(j0, false);
    __syncthreads();
    float aq[4][4], ak[4][4], av[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) aq[r][u] = ak[r][u] = av[r][u] = 0.f;
    for (int x = 0; x < L; ++x) {
      float sr[4], st[4], wt[4], kx[4], qx[4], nx[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sr[r] = dS[(ty + 16 * r) * PS + x];
        st[r] = dS[x * PS + ty + 16 * r];
        wt[r] = W[x * PS + ty + 16 * r];
        kx[r] = tk[x * PS + tx + 16 * r];
        qx[r] = tq[x * PS + tx + 16 * r];
        nx[r] = tn[x * PS + tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          aq[r][u] = fmaf(sr[r], kx[u], aq[r][u]);
          ak[r][u] = fmaf(st[r], qx[u], ak[r][u]);
          av[r][u] = fmaf(wt[r], nx[u], av[r][u]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = ty + 16 * r;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + tx + 16 * u;
        if (t < L && j < Dh) {
          const long long i = elem(t) + j;
          const float dk_inter = dki[i];
          dq[i] = from_f32<TQ>((aq[r][u] + dqi[i]) * inv_sqrt_dh);
          dk[i] = from_f32<TQ>(ak[r][u] + dk_inter);
          dv[i] = from_f32<TQ>(av[r][u] + dvi[i]);
          dig_acc[r] = fmaf(tk[t * PS + tx + 16 * u], dk_inter, dig_acc[r]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float d = dig_acc[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      d += __shfl_xor_sync(0xffffffffu, d, off);
    const int t = ty + 16 * r;
    if (tx == 0 && t < L) dig[cr.gbase + (long long)t * H] = s_dig[t] + d;
  }
}

template <typename TQ, int MODE, bool SMEM_X>
cudaError_t launch_slab(const Sources<TQ>& src, const float* C0,
                        const float* n0, const float* wout, const float* wg,
                        const float* wdden, const float* winvn,
                        const float* wf, float* out, float* xg, int grid,
                        int S, int H, int Dh, int n_chunks, int n_slabs,
                        float inv_sqrt_dh, cudaStream_t st) {
  const size_t smem = sizeof(float) * slab_smem_floats(Dh, SMEM_X);
  auto kern = mlstm_bwd_slab_kernel<TQ, MODE, SMEM_X>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, smem, st>>>(src, C0, n0, wout, wg, wdden, winvn, wf, out,
                               xg, S, H, Dh, n_chunks, n_slabs, inv_sqrt_dh);
  return cudaGetLastError();
}

template <typename TQ, bool SMEM_X>
cudaError_t launch_slabs(const Sources<TQ>& src, const float* C0,
                         const float* n0, const float* wout, const float* wg,
                         const float* wdden, const float* winvn,
                         const float* wf, float* dqi, float* dki, float* dvi,
                         float* xg, int grid, int S, int H, int Dh,
                         int n_chunks, int n_slabs, float inv_sqrt_dh,
                         cudaStream_t st) {
  cudaError_t err = launch_slab<TQ, 0, SMEM_X>(
      src, C0, n0, wout, wg, wdden, winvn, wf, dqi, xg, grid, S, H, Dh,
      n_chunks, n_slabs, inv_sqrt_dh, st);
  if (err != cudaSuccess) return err;
  err = launch_slab<TQ, 1, SMEM_X>(src, C0, n0, wout, wg, wdden, winvn, wf,
                                   dki, xg, grid, S, H, Dh, n_chunks,
                                   n_slabs, inv_sqrt_dh, st);
  if (err != cudaSuccess) return err;
  return launch_slab<TQ, 2, SMEM_X>(src, C0, n0, wout, wg, wdden, winvn, wf,
                                    dvi, xg, grid, S, H, Dh, n_chunks,
                                    n_slabs, inv_sqrt_dh, st);
}

template <typename TQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const float* ig, const float* fg, const float* C0,
                       const float* n0, const float* m0, const float* h,
                       const float* dh, const float* mstat,
                       const float* dstat, void* ws, void* dq, void* dk,
                       void* dv, float* dig, float* row_out, int B, int S,
                       int H, int Dh, float sqrt_dh, cudaStream_t st) {
  const int n_chunks = (S + T - 1) / T;
  const int n_slabs = (Dh + KS - 1) / KS;
  const long long BH = (long long)B * H;
  if (BH * n_chunks > INT_MAX || BH * n_slabs > INT_MAX)
    return cudaErrorInvalidValue;
  const BwdWs w = bwd_ws(B, S, H, Dh);
  uint8_t* base = static_cast<uint8_t*>(ws);
  double* wb = reinterpret_cast<double*>(base + w.b);
  float* wout = reinterpret_cast<float*>(base + w.wout);
  float* wg = reinterpret_cast<float*>(base + w.g);
  float* wdden = reinterpret_cast<float*>(base + w.dden);
  float* winvn = reinterpret_cast<float*>(base + w.invn);
  float* wf = reinterpret_cast<float*>(base + w.f);
  float* dqi = reinterpret_cast<float*>(base + w.dqi);
  float* dki = reinterpret_cast<float*>(base + w.dki);
  float* dvi = reinterpret_cast<float*>(base + w.dvi);
  float* xg = reinterpret_cast<float*>(base + w.x);
  const float inv = 1.f / sqrt_dh;
  const Sources<TQ> src{static_cast<const TQ*>(q), static_cast<const TQ*>(k),
                        static_cast<const TQ*>(v), dh};

  mlstm_bwd_prep_kernel<<<(int)(BH * n_chunks), NT, 0, st>>>(
      ig, fg, m0, h, dh, mstat, dstat, wb, wout, wg, wdden, winvn, wf,
      row_out, S, H, Dh, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = (int)(BH * n_slabs);
  const bool smem_x = 4 * slab_smem_floats(Dh, true) <= SMEM_LIMIT;
  err = smem_x ? launch_slabs<TQ, true>(src, C0, n0, wout, wg, wdden, winvn,
                                        wf, dqi, dki, dvi, xg, grid, S, H,
                                        Dh, n_chunks, n_slabs, inv, st)
               : launch_slabs<TQ, false>(src, C0, n0, wout, wg, wdden,
                                         winvn, wf, dqi, dki, dvi, xg, grid,
                                         S, H, Dh, n_chunks, n_slabs, inv,
                                         st);
  if (err != cudaSuccess) return err;
  auto intra = mlstm_bwd_intra_kernel<TQ>;
  err = cudaFuncSetAttribute(intra,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)INTRA_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  intra<<<(int)(BH * n_chunks), NT, INTRA_SMEM_BYTES, st>>>(
      src, ig, mstat, wb, wdden, winvn, dqi, dki, dvi, static_cast<TQ*>(dq),
      static_cast<TQ*>(dk), static_cast<TQ*>(dv), dig, S, H, Dh, n_chunks,
      inv);
  return cudaGetLastError();
}


// ===========================================================================
// wgmma_bf16 route
//
// The forward's wgmma route computes q k^T, C's update, q C and W v on bf16
// tensor cores with every float32 factor split as hi + lo (mlstm_scan.cu).
// The backward takes the same structure: the states are materialised per
// chunk of CT = 128 steps, then every (chunk, column tile) runs in parallel.
// Every per-row scalar stays on one factor of its product (or outside it):
//   dq~ = diag(w_out) (dnum C^T + dden n) + dS k
//   dk  = diag(g) (v D^T + Dn) + (dS^T / sqrt(Dh)) q
//   dv  = diag(g) (k D) + W^T dnum
// with dnum = dh / N, dS = w o (dnum v^T + dden) and W = w o (q k^T) /
// sqrt(Dh) (w_ts = exp(b_t - b_s + ig_s - m_t), s <= t), and the state
// gradient D (keys x values), carried backwards from the last chunk: D^T +=
// (s o dnum)^T q with s_t = w_out_t / sqrt(Dh).  q, k and v are exact bf16;
// dnum, s o dnum, C^T, D^T, dS and W are float32, split as hi + lo.
//
// The stabilisers: every state (C entering, D leaving a chunk) is scaled by
// the forward state pass's chain m_new = max(b_T + m_prev, max_s gm_s),
// which the forward's output pass also used for w_out; the forward's row
// statistics give m_t and den_t.  (At a chunk's last row m_t is the same
// float expression as the chain's m_new, so the two agree bit for bit.)
//
// Passes, per segment of the sequence (as the forward's, at most
// STATE_BUDGET of C^T and as much of D^T):
//  1. gates: the forward's gate pass (b, ig, gm and per chunk (b_T, max gm)).
//  2. rows, a warp a row: per row w_out, g, dden, m_t and the row sums
//     (dh . h where the clamp is active), per chunk f; dnum split into bf16
//     hi and lo, written once in q's layout for TMA.
//  3. C states: the forward's state pass, C^T and n entering each chunk.
//  4. D states, grid (B*H * Dp/128 * Dp/128): each CTA holds a 128 x 128
//     tile of D^T (values x keys) as wgmma accumulators and walks the chunks
//     from the last.  Per chunk it scales the tile by f and adds (s o
//     dnum)^T q in two passes, A built in registers from the staged dnum
//     halves and split again, B = q MN-major; then stores the tile (D^T
//     leaving the chunk before) as bf16 hi and lo by TMA, staged in the
//     warpgroup's own dnum panels of the stage just consumed, before it
//     releases the stage.  The first key tile's CTAs carry Dn on CUDA
//     cores.
//  5. scores, grid (B*H*chunks): the forward's q k^T pass, and the same
//     kernel for dnum v^T (A = dnum hi and lo, two products), float32.
//  6. outputs, grid (B*H*chunks * Dp/128) for each of dq, dk, dv: the part
//     across chunks over every 64-column panel of Dh (a fresh accumulator a
//     panel, summed in float32: the tensor cores' float32 accumulation
//     truncates), its per-row scale, then the chunk's own pairs from dS, dS^T
//     or W^T formed in registers from the scores (float64 gate differences)
//     and split, B from a staged tile.  dk's CTAs also write k . (dk's part
//     across chunks) over their columns, and the first column tile's the
//     column sums of dS o (q~ k^T), for dig.
//  7. dig, grid over the rows: those parts summed in a fixed order (no
//     atomics: the same result for any order of the blocks).
// Without an initial state C entering chunk 0 is zero, and D leaving the
// last chunk always is: neither is stored, and the outputs skip them.  Past
// one segment, the C chain first runs over the segments to keep the state
// entering each (float32), then the segments run from the last, D carried
// between them in float32.
//
// What bounds this route: the states' bytes, not the function's.  C^T and
// D^T (bf16 hi and lo) are written once, C^T read once and D^T twice (dk
// reads it MN-major, dv K-major): 2.5 GiB at xlstm-1.3b's train shape,
// 0.8 ms at 3.35 TB/s, against the function's 0.18 ms bound by operations.
// ===========================================================================

constexpr int OUT_DQ = 0, OUT_DK = 1, OUT_DV = 2;
constexpr int HALF_BOX = 64 * ROW_BYTES;   // 64 rows of a state tile's panel

// Byte offsets of the wgmma route's workspace (each 256-byte aligned).
struct WgWs {
  long long b, ig, mi, gm, ch;     // the forward's gate pass, one segment
  long long wo, g, dd, mt, f;      // per-row scalars by slab, f per slab
  long long s, p;                  // q k^T and dnum v^T per slab, float32
  long long n, dn;                 // n entering, Dn leaving each chunk
  long long dgi, dgp;              // dig's column sums; k . dk parts
  long long c, d;                  // C^T entering, D^T leaving each chunk
  long long dnh, dnl;              // dnum hi and lo, (B, S, H, Dh) bf16
  long long bc, bn, bm;            // C, n, m entering segments 1.. (and the
                                   // final state)
  long long dc, dcn;               // D, Dn carried between segments
  long long bytes;
  int seg, n_seg;
};

__host__ inline WgWs wg_ws(int B, int S, int H, int Dh) {
  const long long BH = (long long)B * H, Dp = pad_dh(Dh), nt = Dp / CTILE;
  const int n_chunks = (S + CT - 1) / CT;
  WgWs w;
  w.seg = segment_chunks(BH, n_chunks, Dh);
  w.n_seg = (n_chunks + w.seg - 1) / w.seg;
  const long long slabs = BH * w.seg, rows = slabs * CT;
  const long long all = (long long)B * S * H * Dh, DD = (long long)Dh * Dh;
  w.b = 0;
  w.ig = up256(w.b + 8 * rows);
  w.mi = up256(w.ig + 4 * rows);
  w.gm = up256(w.mi + 4 * rows);
  w.ch = up256(w.gm + 4 * rows);
  w.wo = up256(w.ch + 8 * slabs);
  w.g = up256(w.wo + 4 * rows);
  w.dd = up256(w.g + 4 * rows);
  w.mt = up256(w.dd + 4 * rows);
  w.f = up256(w.mt + 4 * rows);
  w.s = up256(w.f + 4 * slabs);
  w.p = up256(w.s + 4 * rows * CT);
  w.n = up256(w.p + 4 * rows * CT);
  w.dn = up256(w.n + 4 * slabs * Dp);
  w.dgi = up256(w.dn + 4 * slabs * Dp);
  w.dgp = up256(w.dgi + 4 * rows);
  w.c = up256(w.dgp + 4 * rows * nt);
  w.d = up256(w.c + 2 * slabs * 2 * Dp * Dp);
  w.dnh = up256(w.d + 2 * slabs * 2 * Dp * Dp);
  w.dnl = up256(w.dnh + 2 * all);
  w.bc = up256(w.dnl + 2 * all);
  w.bn = up256(w.bc + 4 * w.n_seg * BH * DD);
  w.bm = up256(w.bn + 4 * w.n_seg * BH * Dh);
  w.dc = up256(w.bm + 4 * w.n_seg * BH);
  w.dcn = up256(w.dc + 4 * BH * DD);
  w.bytes = w.dcn + 4 * BH * Dh;
  return w;
}

// ---------------------------------------------------------------------------
// Pass 2: the per-row scalars, and dnum split into bf16 halves; a warp a row
// of the segment's chunks (rows past S included, whose scalars are zero)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
mlstm_bwd_rows_kernel(const double* __restrict__ gb,
                      const float* __restrict__ ggm,
                      const float* __restrict__ gch,
                      const float* __restrict__ m_in,
                      const float* __restrict__ h,
                      const float* __restrict__ dh,
                      const float* __restrict__ mstat,
                      const float* __restrict__ dstat,
                      float* __restrict__ wo, float* __restrict__ wg,
                      float* __restrict__ wdd, float* __restrict__ wmt,
                      float* __restrict__ wf, __nv_bfloat16* __restrict__ dnh,
                      __nv_bfloat16* __restrict__ dnl,
                      float* __restrict__ row_out, int S, int S_stride,
                      int H, int Dh, int n_chunks) {
  const long long r = (long long)blockIdx.x * NW + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long slab = r / CT, bh = slab / n_chunks;
  const int t = (int)(r % CT), c = (int)(slab % n_chunks);
  const int t0 = c * CT, L = min(CT, S - t0);
  const long long row = ((bh / H) * S_stride + t0 + t) * H + bh % H;
  float mt = 0.f, den = 0.f, dhh = 0.f;
  if (t < L) {   // dh . h and dnum = dh / N_t
    mt = mstat[row];
    den = dstat[row];
    const float iv = 1.f / fmaxf(fabsf(den), expf(-mt));
    const float* dr = dh + row * Dh;
    const float* hr = h + row * Dh;
    for (int j = 4 * lane; j < Dh; j += 128) {
      const float4 d4 = *reinterpret_cast<const float4*>(dr + j);
      const float4 h4 = *reinterpret_cast<const float4*>(hr + j);
      dhh = fmaf(d4.x, h4.x, dhh);
      dhh = fmaf(d4.y, h4.y, dhh);
      dhh = fmaf(d4.z, h4.z, dhh);
      dhh = fmaf(d4.w, h4.w, dhh);
      uint32_t hi0, lo0, hi1, lo1;
      split_bf16(d4.x * iv, d4.y * iv, hi0, lo0);
      split_bf16(d4.z * iv, d4.w * iv, hi1, lo1);
      *reinterpret_cast<uint2*>(dnh + row * Dh + j) = make_uint2(hi0, hi1);
      *reinterpret_cast<uint2*>(dnl + row * Dh + j) = make_uint2(lo0, lo1);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dhh += __shfl_xor_sync(0xffffffffu, dhh, off);
  }
  if (lane == 0) {
    // the chain of m, as the forward's state pass walks it
    const float m_prev = entry_m(gch, bh, c, n_chunks,
                                 m_in != nullptr ? m_in[bh] : NEG_INF);
    const float bT = gch[2 * slab], lmax = gch[2 * slab + 1];
    const float m_new = fmaxf(bT + m_prev, lmax);
    float o = 0.f, dd = 0.f;
    if (t < L) {
      const bool active = fabsf(den) > expf(-mt);
      o = expf(((float)gb[r] + m_prev) - mt);
      dd = active ? -dhh / den : 0.f;
      row_out[row] = active ? 0.f : dhh;
    }
    wo[r] = o;
    wg[r] = expf(ggm[r] - m_new);   // 0 past L, where gm = -inf
    wdd[r] = dd;
    wmt[r] = mt;
    if (t == 0) wf[slab] = expf((bT + m_prev) - m_new);
  }
}

// ---------------------------------------------------------------------------
// Pass 4: D^T leaving each chunk, one 128 x 128 tile a CTA, backwards
// ---------------------------------------------------------------------------
// Dynamic shared memory: two stages of (q, dnum hi, dnum lo) tiles (two
// panels each), s and s o dden of two chunks, barriers.
struct DStatesSmem {
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = 6 * PANEL_BYTES;
  static constexpr int S_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = S_OFFSET + 2 * 2 * CT * 4;
  static constexpr int N_BARS = 2 * STAGES;
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
};

__global__ void __launch_bounds__(NTW, 1)
mlstm_bwd_dstates_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdh,
                         const __grid_constant__ CUtensorMap tdl,
                         const __grid_constant__ CUtensorMap tws,
                         const float* __restrict__ wo,
                         const float* __restrict__ wdd,
                         const float* __restrict__ wf,
                         const float* __restrict__ D_in,
                         const float* __restrict__ Dn_in,
                         __nv_bfloat16* __restrict__ dws,
                         float* __restrict__ dn_ws, float* __restrict__ D_out,
                         float* __restrict__ Dn_out, int H, int Dh,
                         int n_chunks, int last_zero, float inv_sqrt_dh) {
  using M = DStatesSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* stages = smem;
  float* ssm = reinterpret_cast<float*>(smem + M::S_OFFSET);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::BAR_OFFSET);
  uint64_t* empty = full + M::STAGES;

  const int Dp = pad_dh(Dh), nt = Dp / CTILE;
  const long long bh = blockIdx.x / (nt * nt);
  const int jt = blockIdx.x / nt % nt, it = blockIdx.x % nt;
  const int b = (int)(bh / H), hh = (int)(bh % H);
  const int i0 = it * CTILE, j0 = jt * CTILE;
  // panels of the tile that hold a column below Dh; TMA fills only these
  const int npi = min(2, (Dh - i0 + PANEL - 1) / PANEL);
  const int npj = min(2, (Dh - j0 + PANEL - 1) / PANEL);
  const int wg = threadIdx.x / WG;

  for (int s = 0; s < M::STAGES; ++s) {
    uint8_t* st = stages + s * M::STAGE_BYTES;
    for (int p = npi; p < 2; ++p) zero_smem(st + p * PANEL_BYTES, PANEL_BYTES);
    for (int p = npj; p < 2; ++p) {
      zero_smem(st + (2 + p) * PANEL_BYTES, PANEL_BYTES);
      zero_smem(st + (4 + p) * PANEL_BYTES, PANEL_BYTES);
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < M::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  fence_proxy_async();   // the zeroed panels, before wgmma reads them
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the q and dnum tiles of the chunks before
    // coming
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      for (int ci = 0; ci < n_chunks; ++ci) {
        const int c = n_chunks - 1 - ci, s = ci % M::STAGES;
        uint8_t* st = stages + s * M::STAGE_BYTES;
        mbar_wait(empty + s, ((ci / M::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, (npi + 2 * npj) * PANEL_BYTES);
        for (int p = 0; p < npi; ++p)
          tma_load_4d(st + p * PANEL_BYTES, &tq, full + s, i0 + p * PANEL, hh,
                      c * CT, b);
        for (int p = 0; p < npj; ++p) {
          tma_load_4d(st + (2 + p) * PANEL_BYTES, &tdh, full + s,
                      j0 + p * PANEL, hh, c * CT, b);
          tma_load_4d(st + (4 + p) * PANEL_BYTES, &tdl, full + s,
                      j0 + p * PANEL, hh, c * CT, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, ct = threadIdx.x;
    const int warp = t / 32, lane = t % 32;
    const int rw = 16 * warp + lane / 4;   // row of acc[0] within the 64
    const int cq = 2 * (lane % 4);         // column within each 8
    const long long DD = (long long)Dh * Dh;
    // acc[e]: D^T[j][i] at j = j0 + 64 wg + rw + 8 ((e/2) % 2),
    // i = i0 + 8 (e/4) + cq + e % 2
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int j = j0 + 64 * wg + rw + 8 * ((e / 2) % 2);
      const int i = i0 + 8 * (e / 4) + cq + e % 2;
      acc[e] = (D_in != nullptr && i < Dh && j < Dh)
                   ? D_in[bh * DD + (long long)i * Dh + j]
                   : 0.f;
    }
    // Dn of key i0 + ni (first value tile only): two threads a key, each
    // summing half of the chunk's steps
    const int ni = ct / 2, nh = ct % 2;
    float nreg = (jt == 0 && Dn_in != nullptr && i0 + ni < Dh)
                     ? Dn_in[bh * Dh + i0 + ni] : 0.f;

    for (int ci = 0; ci < n_chunks; ++ci) {
      const int c = n_chunks - 1 - ci, s = ci % M::STAGES;
      const long long slab = bh * n_chunks + c;
      const float f = wf[slab];
      // s_t and s_t dden_t of two chunks: one barrier a chunk
      float* sv = ssm + (ci & 1) * 2 * CT;
      if (ct < CT) {
        const float o = wo[slab * CT + ct] * inv_sqrt_dh;
        sv[ct] = o;
        sv[CT + ct] = o * wdd[slab * CT + ct];
      }
      // ---- D^T leaving the segment's last chunk, where it is not the zero
      // state (the one carried in), as bf16 hi and lo to the workspace,
      // stored directly: no stage is free yet.  Every other chunk's goes
      // through a stage, below.
      if (ci == 0 && !last_zero) {
        __nv_bfloat16* tile0 =
            dws + ((slab * nt + jt) * 2 * nt + 2 * it) * (2LL * CTILE * PANEL);
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int row = 64 * wg + rw + 8 * ((e / 2) % 2);
          const int col = 8 * (e / 4) + cq;
          uint32_t hi, lo;
          split_bf16(acc[e], acc[e + 1], hi, lo);
          __nv_bfloat16* q0 = tile0 + (col / PANEL) * (2LL * CTILE * PANEL) +
                              row * PANEL + col % PANEL;
          *reinterpret_cast<uint32_t*>(q0) = hi;
          *reinterpret_cast<uint32_t*>(q0 + CTILE * PANEL) = lo;
        }
      }
      if (jt == 0 && nh == 0) dn_ws[slab * Dp + i0 + ni] = nreg;
      named_barrier(3, CONSUMERS * WG);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] *= f;

      // ---- D^T += (s o dnum)^T q in two passes, hi and lo
      mbar_wait(full + s, (ci / M::STAGES) & 1);
      uint8_t* qt = stages + s * M::STAGE_BYTES;
      uint8_t* dht = qt + 2 * PANEL_BYTES;
      uint8_t* dlt = qt + 4 * PANEL_BYTES;
      uint32_t ahi[CT / 16][4], alo[CT / 16][4];
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 64 * wg + rw + 8 * (r % 2);   // value column
          const int sx = 16 * kk + 8 * (r / 2) + cq;  // step
          const int po = (j / PANEL) * PANEL_BYTES, col = j % PANEL;
          const float x0 = ld_bf16(dht + po + sw_off(sx, col)) +
                           ld_bf16(dlt + po + sw_off(sx, col));
          const float x1 = ld_bf16(dht + po + sw_off(sx + 1, col)) +
                           ld_bf16(dlt + po + sw_off(sx + 1, col));
          split_bf16(sv[sx] * x0, sv[sx + 1] * x1, ahi[kk][r], alo[kk][r]);
        }
      }
      reg_fence(acc);
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk) {
        reg_fence(ahi[kk]);
        reg_fence(alo[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk) {
        const uint64_t db = sw128_desc(qt + kk * 16 * ROW_BYTES, PANEL_BYTES);
        wgmma_rs(acc, ahi[kk], db);
        wgmma_rs(acc, alo[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);

      // ---- Dn = f Dn + sum_t s_t dden_t q_t
      if (jt == 0) {
        const uint8_t* kp = qt + (ni / PANEL) * PANEL_BYTES;
        float sum = 0.f;
        for (int u = 0; u < CT / 2; ++u) {
          const int sx = nh * (CT / 2) + u;
          sum = fmaf(sv[CT + sx], ld_bf16(kp + sw_off(sx, ni % PANEL)), sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        nreg = f * nreg + sum;
      }
      // ---- D^T leaving chunk c - 1 (the tile as it now stands), as bf16 hi
      // and lo, staged in this warpgroup's own dnum panels of the stage (no
      // other warpgroup reads them) and stored by TMA
      if (c > 0) {
        uint8_t* hs = dht + wg * PANEL_BYTES;
        uint8_t* ls = dlt + wg * PANEL_BYTES;
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int row = rw + 8 * ((e / 2) % 2);
          const int col = 8 * (e / 4) + cq;
          uint32_t hi, lo;
          split_bf16(acc[e], acc[e + 1], hi, lo);
          const int off = (col / PANEL) * HALF_BOX + sw_off(row, col % PANEL);
          *reinterpret_cast<uint32_t*>(hs + off) = hi;
          *reinterpret_cast<uint32_t*>(ls + off) = lo;
        }
        fence_proxy_async();
        named_barrier(1 + wg, WG);
        if (t == 0) {
          const int tile = (int)(((slab - 1) * nt + jt) * 2 * nt + 2 * it);
          for (int p = 0; p < 2; ++p) {
            tma_store_4d(&tws, hs + p * HALF_BOX, 0, 64 * wg, 0, tile + p);
            tma_store_4d(&tws, ls + p * HALF_BOX, 0, 64 * wg, 1, tile + p);
          }
          tma_store_wait();   // the stores have read the staging
        }
        named_barrier(1 + wg, WG);
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // ---- D and Dn entering the segment, for the segment before
    if (D_out != nullptr) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int j = j0 + 64 * wg + rw + 8 * ((e / 2) % 2);
        const int i = i0 + 8 * (e / 4) + cq + e % 2;
        if (i < Dh && j < Dh) D_out[bh * DD + (long long)i * Dh + j] = acc[e];
      }
    }
    if (Dn_out != nullptr && jt == 0 && nh == 0 && i0 + ni < Dh)
      Dn_out[bh * Dh + i0 + ni] = nreg;
  }
}

// ---------------------------------------------------------------------------
// Pass 6: dq, dk or dv of one chunk, 128 columns a CTA
// ---------------------------------------------------------------------------
// Dynamic shared memory: the tile B of the chunk's own pairs (k for dq, q
// for dk, dnum hi and lo for dv: two panels each), the stages of the part
// across chunks (per 64-column panel of Dh: A, then B hi and lo), the
// chunk's per-row scalars, barriers.
template <int KIND>
struct OutSmem {
  static constexpr int INTRA_BYTES = (KIND == OUT_DV ? 4 : 2) * PANEL_BYTES;
  static constexpr int A_BYTES = (KIND == OUT_DQ ? 2 : 1) * PANEL_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * PANEL_BYTES;
  static constexpr int STAGES = KIND == OUT_DQ ? 2 : 3;
  static constexpr int SC_OFFSET = INTRA_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFFSET = SC_OFFSET + CT * (8 + 4 * 4);
  static constexpr int N_BARS = 1 + 2 * STAGES;
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
  static_assert(bytes <= 232448, "a block's shared memory");
};

// ta, ta2: the A panels across chunks (dnum hi and lo for dq; v for dk; k
// for dv); tws: the state's workspace (C^T for dq, D^T for dk and dv), in
// 64-row boxes for dq and dk (B MN-major), whole 128-row boxes for dv (B
// K-major); ti, ti2: the tile of the chunk's own pairs (k for dq, q for dk,
// dnum hi and lo for dv).
template <int KIND>
__global__ void __launch_bounds__(NTW, 1)
mlstm_bwd_out_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap ta2,
                     const __grid_constant__ CUtensorMap tws,
                     const __grid_constant__ CUtensorMap ti,
                     const __grid_constant__ CUtensorMap ti2,
                     const float* __restrict__ sraw,
                     const float* __restrict__ pws,
                     const double* __restrict__ gb,
                     const float* __restrict__ gig,
                     const float* __restrict__ wmt,
                     const float* __restrict__ wdd,
                     const float* __restrict__ wscale,
                     const float* __restrict__ nvec,
                     const __nv_bfloat16* __restrict__ kin,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ dgi, float* __restrict__ dgp,
                     int S, int S_stride, int H, int Dh, int n_chunks,
                     int skip_chunk, float inv_sqrt_dh) {
  using M = OutSmem<KIND>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* intra = smem;
  uint8_t* stages = smem + M::INTRA_BYTES;
  double* sb = reinterpret_cast<double*>(smem + M::SC_OFFSET);
  float* sig = reinterpret_cast<float*>(sb + CT);
  float* smt = sig + CT;
  float* sdd = smt + CT;
  float* ssc = sdd + CT;   // w_out for dq, g for dk and dv
  uint64_t* i_full = reinterpret_cast<uint64_t*>(smem + M::BAR_OFFSET);
  uint64_t* full = i_full + 1;
  uint64_t* empty = full + M::STAGES;

  const int Dp = pad_dh(Dh), nt = Dp / CTILE;
  const int ot = blockIdx.x % nt;   // the CTA's column tile
  const int c = blockIdx.x / nt % n_chunks;
  const long long bh = blockIdx.x / (nt * n_chunks);
  const int b = (int)(bh / H), hh = (int)(bh % H);
  const long long slab = bh * n_chunks + c;
  const int o0 = ot * CTILE, t0 = c * CT, L = min(CT, S - t0);
  const int npo = min(2, (Dh - o0 + PANEL - 1) / PANEL);
  // 64-column panels of the part across chunks; none where the state is
  // the zero one (C entering chunk 0 without an initial state, D leaving
  // the last chunk)
  const int np = c == skip_chunk ? 0 : (Dh + PANEL - 1) / PANEL;
  const int wg = threadIdx.x / WG;

  for (int p = npo; p < 2; ++p) {
    zero_smem(intra + p * PANEL_BYTES, PANEL_BYTES);
    if (KIND == OUT_DV) zero_smem(intra + (2 + p) * PANEL_BYTES, PANEL_BYTES);
  }
  if (threadIdx.x == 0) {
    mbar_init(i_full, 1);
    for (int s = 0; s < M::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  fence_proxy_async();   // the zeroed panels, before wgmma reads them
  __syncthreads();

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_expect_tx(i_full, (KIND == OUT_DV ? 2 : 1) * npo * PANEL_BYTES);
      for (int p = 0; p < npo; ++p) {
        tma_load_4d(intra + p * PANEL_BYTES, &ti, i_full, o0 + p * PANEL, hh,
                    t0, b);
        if (KIND == OUT_DV)
          tma_load_4d(intra + (2 + p) * PANEL_BYTES, &ti2, i_full,
                      o0 + p * PANEL, hh, t0, b);
      }
      for (int p = 0; p < np; ++p) {
        const int s = p % M::STAGES;
        uint8_t* st = stages + s * M::STAGE_BYTES;
        mbar_wait(empty + s, ((p / M::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, M::STAGE_BYTES);
        tma_load_4d(st, &ta, full + s, p * PANEL, hh, t0, b);
        if (KIND == OUT_DQ)
          tma_load_4d(st + PANEL_BYTES, &ta2, full + s, p * PANEL, hh, t0, b);
        uint8_t* bt = st + M::A_BYTES;
        if (KIND == OUT_DV) {
          // D^T's tile (value tile ot, key panel p): 128 values x 64 keys
          const int tile = (int)((slab * nt + ot) * 2 * nt + p);
          tma_load_4d(bt, &tws, full + s, 0, 0, 0, tile);
          tma_load_4d(bt + PANEL_BYTES, &tws, full + s, 0, 0, 1, tile);
        } else {
          // rows 64 (p % 2).. of the state's tiles (value tile p / 2, key
          // panels 2 ot and 2 ot + 1): 64 values x 128 keys, hi then lo
          const int tile = (int)((slab * nt + p / 2) * 2 * nt + 2 * ot);
          for (int hl = 0; hl < 2; ++hl)
            for (int q = 0; q < 2; ++q)
              tma_load_4d(bt + hl * PANEL_BYTES + q * HALF_BOX, &tws,
                          full + s, 0, 64 * (p % 2), hl, tile + q);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, ct = threadIdx.x;
    const int warp = t / 32, lane = t % 32;
    const int rw = 16 * warp + lane / 4;   // row of acc[0] within the 64
    const int r0 = 64 * wg + rw;           // chunk row of acc[0]; +8 for hr 1
    const int cq = 2 * (lane % 4);
    const long long rec = slab * CT;
    if (ct < CT) {
      sb[ct] = gb[rec + ct];
      sig[ct] = gig[rec + ct];
      smt[ct] = wmt[rec + ct];
      sdd[ct] = wdd[rec + ct];
      ssc[ct] = wscale[rec + ct];
    }
    // oacc[e]: the output at row r0 + 8 ((e/2) % 2), column o0 + 8 (e/4) +
    // cq + e % 2
    float oacc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) oacc[e] = 0.f;
    // ---- the part across chunks, a fresh accumulator per 64 of K
    for (int p = 0; p < np; ++p) {
      const int s = p % M::STAGES;
      const uint8_t* st = stages + s * M::STAGE_BYTES;
      const uint8_t* Aw = st + wg * 64 * ROW_BYTES;   // this warpgroup's rows
      const uint8_t* bt = st + M::A_BYTES;
      float part[64];
      mbar_wait(full + s, (p / M::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const uint64_t da = sw128_desc(Aw + kk * 32, 16);
        if (KIND == OUT_DV) {
          wgmma_ss(part, da, sw128_desc(bt + kk * 32, 16), kk > 0);
          wgmma_ss(part, da, sw128_desc(bt + PANEL_BYTES + kk * 32, 16), 1);
        } else {
          const uint64_t dbh = sw128_desc(bt + kk * 16 * ROW_BYTES, HALF_BOX);
          const uint64_t dbl =
              sw128_desc(bt + PANEL_BYTES + kk * 16 * ROW_BYTES, HALF_BOX);
          wgmma_ss_mn(part, da, dbh, kk > 0);
          wgmma_ss_mn(part, da, dbl, 1);
          if (KIND == OUT_DQ)
            wgmma_ss_mn(part, sw128_desc(Aw + PANEL_BYTES + kk * 32, 16), dbh,
                        1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(part);
#pragma unroll
      for (int e = 0; e < 64; ++e) oacc[e] += part[e];
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    named_barrier(1, CONSUMERS * WG);   // the per-row scalars are staged

    // ---- the per-row scale of the part across chunks
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int tr = r0 + 8 * ((e / 2) % 2);
      const int col = o0 + 8 * (e / 4) + cq;
      if (KIND == OUT_DQ) {   // w_out (. + dden n)
        const float2 nv = *reinterpret_cast<const float2*>(nvec + slab * Dp +
                                                           col);
        oacc[e] = ssc[tr] * fmaf(sdd[tr], nv.x, oacc[e]);
        oacc[e + 1] = ssc[tr] * fmaf(sdd[tr], nv.y, oacc[e + 1]);
      } else if (KIND == OUT_DK) {   // g (. + Dn)
        const float2 nv = *reinterpret_cast<const float2*>(nvec + slab * Dp +
                                                           col);
        oacc[e] = ssc[tr] * (oacc[e] + nv.x);
        oacc[e + 1] = ssc[tr] * (oacc[e + 1] + nv.y);
      } else {   // g
        oacc[e] *= ssc[tr];
        oacc[e + 1] *= ssc[tr];
      }
    }
    if (KIND == OUT_DK) {
      // k . (dk's part across chunks) over this tile's columns, per row (the
      // loads not under the mask, so that they are all in flight at once:
      // a row or column past the tensor reads its last one, and counts 0)
      float kd[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int hr = (e / 2) % 2, tr = r0 + 8 * hr;
        const int col = o0 + 8 * (e / 4) + cq;
        const bool in = tr < L && col < Dh;
        const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(
            kin + (((long long)b * S_stride + t0 + min(tr, L - 1)) * H + hh) *
                      Dh + min(col, Dh - 2));
        const float2 kf = __bfloat1622float2(k2);
        kd[hr] = in ? fmaf(kf.x, oacc[e], fmaf(kf.y, oacc[e + 1], kd[hr]))
                    : kd[hr];
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x = kd[hr];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (lane % 4 == 0) dgp[(slab * nt + ot) * CT + r0 + 8 * hr] = x;
      }
    }

    // ---- the chunk's own pairs: A = dS (dq), dS^T / sqrt(Dh) (dk) or W^T
    // (dv), formed in the accumulator layout from the scores (rows r0 +
    // 8 hr, columns x = 8 (e/4) + cq + e % 2) and split.  The scores are
    // loaded whatever the mask (every entry of a chunk's is written), so
    // that the loads are all in flight at once; the mask selects after.
    const float* sc = sraw + slab * CT * CT;
    const float* pc = pws + slab * CT * CT;
    float mat[64];
    float cs[2] = {0.f, 0.f};   // dk: the column sums of dS o (q~ k^T)
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int hr = (e / 2) % 2, tr = r0 + 8 * hr;
      const int x0 = 8 * (e / 4) + cq;
      if (KIND == OUT_DQ) {   // row t = tr, columns s = x0, x0 + 1
        const float2 p2 =
            *reinterpret_cast<const float2*>(pc + tr * CT + x0);
        const float pv[2] = {p2.x, p2.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = x0 + u;
          const float w =
              (x <= tr && tr < L)
                  ? expf(((float)(sb[tr] - sb[x]) + sig[x]) - smt[tr])
                  : 0.f;
          mat[e + u] = w * (pv[u] + sdd[tr]);
        }
      } else {                // row s = tr, columns t = x0, x0 + 1
        float pv[2], sv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          pv[u] = pc[(x0 + u) * CT + tr];
          sv[u] = sc[(x0 + u) * CT + tr];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int x = x0 + u;
          const float w =
              (tr <= x && x < L)
                  ? expf(((float)(sb[x] - sb[tr]) + sig[tr]) - smt[x])
                  : 0.f;
          if (KIND == OUT_DK) {
            const float d = w * (pv[u] + sdd[x]);
            cs[hr] = fmaf(d, sv[u] * inv_sqrt_dh, cs[hr]);
            mat[e + u] = d * inv_sqrt_dh;
          } else {
            mat[e + u] = w * sv[u] * inv_sqrt_dh;
          }
        }
      }
    }
    if (KIND == OUT_DK && ot == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float x = cs[hr];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (lane % 4 == 0) dgi[rec + r0 + 8 * hr] = x;
      }
    }
    uint32_t mhi[CT / 16][4], mlo[CT / 16][4];
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(mat[8 * kk + 2 * r], mat[8 * kk + 2 * r + 1], mhi[kk][r],
                   mlo[kk][r]);
    mbar_wait(i_full, 0);
    reg_fence(oacc);
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk) {
      reg_fence(mhi[kk]);
      reg_fence(mlo[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk) {
      const uint64_t db = sw128_desc(intra + kk * 16 * ROW_BYTES, PANEL_BYTES);
      wgmma_rs(oacc, mhi[kk], db);
      wgmma_rs(oacc, mlo[kk], db);
      if (KIND == OUT_DV)
        wgmma_rs(oacc, mhi[kk],
                 sw128_desc(intra + 2 * PANEL_BYTES + kk * 16 * ROW_BYTES,
                            PANEL_BYTES));
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(oacc);

    // ---- the output in q's dtype (dq = dq~ / sqrt(Dh))
    const float scale = KIND == OUT_DQ ? inv_sqrt_dh : 1.f;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int tr = r0 + 8 * ((e / 2) % 2);
      const int col = o0 + 8 * (e / 4) + cq;
      if (tr < L && col < Dh)
        *reinterpret_cast<uint32_t*>(
            out + (((long long)b * S_stride + t0 + tr) * H + hh) * Dh + col) =
            pack_bf16(oacc[e] * scale, oacc[e + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 7: dig, the parts summed in a fixed order
// ---------------------------------------------------------------------------
__global__ void mlstm_bwd_dig_kernel(const float* __restrict__ dgi,
                                     const float* __restrict__ dgp,
                                     float* __restrict__ dig, int S,
                                     int S_stride, int H, int n_chunks,
                                     int nt, long long n_rows) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const long long slab = r / CT, bh = slab / n_chunks;
  const int t = (int)(r % CT), c = (int)(slab % n_chunks);
  if (c * CT + t >= S) return;
  float d = dgi[r];
  for (int it = 0; it < nt; ++it) d += dgp[(slab * nt + it) * CT + t];
  dig[((bh / H) * S_stride + c * CT + t) * H + bh % H] = d;
}

template <typename K>
cudaError_t set_smem(K kern, size_t bytes) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v,
                             const float* ig, const float* fg,
                             const float* C0, const float* n0,
                             const float* m0, const float* h,
                             const float* dh, const float* mstat,
                             const float* dstat, void* ws, void* dq,
                             void* dk, void* dv, float* dig, float* row_out,
                             int B, int S, int H, int Dh, float sqrt_dh,
                             cudaStream_t st) {
  if (Dh % 8 != 0) return cudaErrorInvalidValue;  // TMA's 16-byte strides
  for (const void* p : {q, k, v, (const void*)h, (const void*)dh,
                        (const void*)ws})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  const int n_chunks = (S + CT - 1) / CT;
  const int Dp = pad_dh(Dh), nt = Dp / CTILE;
  const long long BH = (long long)B * H;
  const WgWs w = wg_ws(B, S, H, Dh);
  const int seg = w.seg;
  if (BH * seg * nt * 2 * nt > 0x7fffffffLL || BH * nt * nt > 0x7fffffffLL ||
      BH * seg * nt > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  uint8_t* base = static_cast<uint8_t*>(ws);
  auto f32 = [&](long long off) { return reinterpret_cast<float*>(base + off); };
  double* gb = reinterpret_cast<double*>(base + w.b);
  float *gig = f32(w.ig), *gmi = f32(w.mi), *ggm = f32(w.gm), *gch = f32(w.ch);
  float *wo = f32(w.wo), *wgv = f32(w.g), *wdd = f32(w.dd), *wmt = f32(w.mt);
  float *wf = f32(w.f), *sc = f32(w.s), *pw = f32(w.p), *n_ws = f32(w.n);
  float *dn_ws = f32(w.dn), *dgi = f32(w.dgi), *dgp = f32(w.dgp);
  __nv_bfloat16* dnh = reinterpret_cast<__nv_bfloat16*>(base + w.dnh);
  __nv_bfloat16* dnl = reinterpret_cast<__nv_bfloat16*>(base + w.dnl);
  float *bc = f32(w.bc), *bn = f32(w.bn), *bm = f32(w.bm);
  float *dc = f32(w.dc), *dcn = f32(w.dcn);
  const long long DD = (long long)Dh * Dh;
  const float inv = 1.f / sqrt_dh;

  // the state workspaces tile by tile, as the forward lays out C^T: per
  // ((b, h, chunk), value tile, key panel), hi then lo, 128 values x 64
  // keys each; boxes of 64 rows (MN-major B, and the C state pass's
  // stores) or of all 128 (K-major B)
  CUtensorMap tc_half, td_half, td_full;
  const cuuint64_t wdims[4] = {PANEL, CTILE, 2,
                               (cuuint64_t)(BH * seg * nt * 2 * nt)};
  const cuuint64_t wstrides[3] = {PANEL * 2, PANEL * CTILE * 2,
                                  PANEL * CTILE * 2 * 2};
  const cuuint32_t half_box[4] = {PANEL, 64, 1, 1};
  const cuuint32_t full_box[4] = {PANEL, CTILE, 1, 1};
  if (!make_bf16_map_4d(&tc_half, base + w.c, wdims, wstrides, half_box) ||
      !make_bf16_map_4d(&td_half, base + w.d, wdims, wstrides, half_box) ||
      !make_bf16_map_4d(&td_full, base + w.d, wdims, wstrides, full_box))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = set_smem(mlstm_qk_kernel<1>, ScoresSmem<1>::bytes)) ||
      (err = set_smem(mlstm_qk_kernel<2>, ScoresSmem<2>::bytes)) ||
      (err = set_smem(mlstm_states_kernel, StatesSmem::bytes)) ||
      (err = set_smem(mlstm_bwd_dstates_kernel, DStatesSmem::bytes)) ||
      (err = set_smem(mlstm_bwd_out_kernel<OUT_DQ>, OutSmem<OUT_DQ>::bytes)) ||
      (err = set_smem(mlstm_bwd_out_kernel<OUT_DK>, OutSmem<OUT_DK>::bytes)) ||
      (err = set_smem(mlstm_bwd_out_kernel<OUT_DV>, OutSmem<OUT_DV>::bytes)))
    return err;

  // the state entering segment g >= 1 in slot g - 1 (slot n_seg - 1 also
  // takes the final state, which nothing reads)
  auto slot_c = [&](int g) { return bc + (g - 1) * BH * DD; };
  auto slot_n = [&](int g) { return bn + (g - 1) * BH * Dh; };
  auto slot_m = [&](int g) { return bm + (g - 1) * BH; };
  auto seg_maps = [&](int c0, int nc, CUtensorMap* maps) -> bool {
    const int Sg = std::min(nc * CT, S - c0 * CT);
    const long long off = 2LL * c0 * CT * H * Dh;   // bytes of a bf16 tensor
    const cuuint64_t row = (cuuint64_t)H * Dh * 2;
    const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H,
                                (cuuint64_t)Sg, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2, row, row * S};
    const cuuint32_t box[4] = {PANEL, 1, CT, 1};
    const void* srcs[5] = {q, k, v, dnh, dnl};
    for (int i = 0; i < 5; ++i)
      if (!make_bf16_map_4d(&maps[i], static_cast<const uint8_t*>(srcs[i]) + off,
                            dims, strides, box))
        return false;
    return true;
  };
  auto gates = [&](int c0, int nc) {
    const int Sg = std::min(nc * CT, S - c0 * CT);
    mlstm_gates_kernel<<<(int)(BH * nc), CT, 0, st>>>(
        ig + (long long)c0 * CT * H, fg + (long long)c0 * CT * H, gb, gig, gmi,
        ggm, gch, Sg, S, H, nc);
    return cudaGetLastError();
  };
  auto states = [&](int g, int nc, const CUtensorMap* maps) {
    const float* C_in = g == 0 ? C0 : slot_c(g);
    const float* n_in = g == 0 ? n0 : slot_n(g);
    const float* m_in = g == 0 ? m0 : slot_m(g);
    mlstm_states_kernel<<<(int)(BH * nt * nt), NTW, StatesSmem::bytes, st>>>(
        maps[1], maps[2], tc_half, ggm, gch, C_in, n_in, m_in, n_ws,
        slot_c(g + 1), slot_n(g + 1), slot_m(g + 1), H, Dh, nc);
    return cudaGetLastError();
  };

  // the C chain over the segments before the last, for their entry states
  for (int g = 0; g + 1 < w.n_seg; ++g) {
    CUtensorMap maps[5];
    if (!seg_maps(g * seg, seg, maps)) return cudaErrorInvalidValue;
    if ((err = gates(g * seg, seg)) || (err = states(g, seg, maps)))
      return err;
  }
  // the segments from the last
  for (int g = w.n_seg - 1; g >= 0; --g) {
    const int c0 = g * seg, nc = std::min(seg, n_chunks - c0);
    const int s0 = c0 * CT, Sg = std::min(nc * CT, S - s0);
    const long long off = (long long)s0 * H * Dh;   // elements of a tensor
    const bool last = g == w.n_seg - 1;
    CUtensorMap maps[5];   // q, k, v, dnum hi, dnum lo of the segment
    if (!seg_maps(c0, nc, maps)) return cudaErrorInvalidValue;
    if ((err = gates(c0, nc))) return err;
    mlstm_bwd_rows_kernel<<<(int)(BH * nc * (CT / NW)), NT, 0, st>>>(
        gb, ggm, gch, g == 0 ? m0 : slot_m(g), h + off, dh + off,
        mstat + (long long)s0 * H, dstat + (long long)s0 * H, wo, wgv, wdd,
        wmt, wf, dnh + off, dnl + off, row_out + (long long)s0 * H, Sg, S, H,
        Dh, nc);
    if ((err = cudaGetLastError()) || (err = states(g, nc, maps))) return err;
    mlstm_bwd_dstates_kernel<<<(int)(BH * nt * nt), NTW, DStatesSmem::bytes,
                               st>>>(
        maps[0], maps[3], maps[4], td_half, wo, wdd, wf, last ? nullptr : dc,
        last ? nullptr : dcn, reinterpret_cast<__nv_bfloat16*>(base + w.d),
        dn_ws, g > 0 ? dc : nullptr, g > 0 ? dcn : nullptr, H, Dh, nc,
        last ? 1 : 0, inv);
    if ((err = cudaGetLastError())) return err;
    mlstm_qk_kernel<1><<<(int)(BH * nc), NTW, ScoresSmem<1>::bytes, st>>>(
        maps[0], maps[0], maps[1], sc, H, Dh, nc);
    if ((err = cudaGetLastError())) return err;
    mlstm_qk_kernel<2><<<(int)(BH * nc), NTW, ScoresSmem<2>::bytes, st>>>(
        maps[3], maps[4], maps[2], pw, H, Dh, nc);
    if ((err = cudaGetLastError())) return err;
    const int grid = (int)(BH * nc * nt);
    const __nv_bfloat16* kseg = static_cast<const __nv_bfloat16*>(k) + off;
    mlstm_bwd_out_kernel<OUT_DQ><<<grid, NTW, OutSmem<OUT_DQ>::bytes, st>>>(
        maps[3], maps[4], tc_half, maps[1], maps[1], sc, pw, gb, gig, wmt, wdd,
        wo, n_ws, kseg, static_cast<__nv_bfloat16*>(dq) + off, dgi, dgp, Sg, S,
        H, Dh, nc, (g == 0 && C0 == nullptr) ? 0 : -1, inv);
    if ((err = cudaGetLastError())) return err;
    mlstm_bwd_out_kernel<OUT_DK><<<grid, NTW, OutSmem<OUT_DK>::bytes, st>>>(
        maps[2], maps[2], td_half, maps[0], maps[0], sc, pw, gb, gig, wmt, wdd,
        wgv, dn_ws, kseg, static_cast<__nv_bfloat16*>(dk) + off, dgi, dgp, Sg,
        S, H, Dh, nc, last ? nc - 1 : -1, inv);
    if ((err = cudaGetLastError())) return err;
    mlstm_bwd_out_kernel<OUT_DV><<<grid, NTW, OutSmem<OUT_DV>::bytes, st>>>(
        maps[1], maps[1], td_full, maps[3], maps[4], sc, pw, gb, gig, wmt, wdd,
        wgv, dn_ws, kseg, static_cast<__nv_bfloat16*>(dv) + off, dgi, dgp, Sg,
        S, H, Dh, nc, last ? nc - 1 : -1, inv);
    if ((err = cudaGetLastError())) return err;
    const long long n_rows = BH * nc * CT;
    mlstm_bwd_dig_kernel<<<(int)((n_rows + 255) / 256), 256, 0, st>>>(
        dgi, dgp, dig + (long long)s0 * H, Sg, S, H, nc, nt, n_rows);
    if ((err = cudaGetLastError())) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Routes: 0 scalar_f32, 1 scalar_bf16, 2 wgmma_bf16 (as the forward's).

// Steps per chunk of a route of the backward (any S; the last chunk is
// masked); 0 for an unknown route.
extern "C" int repro_mlstm_scan_bwd_chunk(int route) {
  return route == 2 ? CT : (route == 0 || route == 1) ? T : 0;
}

// Bytes of the workspace repro_mlstm_scan_bwd needs on a route (256-byte
// aligned parts; the base must be 16-byte aligned); -1 for an unknown route.
extern "C" long long repro_mlstm_scan_bwd_workspace_bytes(int B, int S,
                                                          int H, int Dh,
                                                          int route) {
  if (route == 2) return wg_ws(B, S, H, Dh).bytes;
  if (route == 0 || route == 1) return bwd_ws(B, S, H, Dh).bytes;
  return -1;
}

// q, k, v: (B, S, H, Dh) float32 (route 0) or bf16 (routes 1 and 2); ig,
// fg: (B, S, H) float32; C0 (B, H, Dh, Dh), n0 (B, H, Dh), m0 (B, H)
// float32 or all three null, as the forward took them; h: the forward's
// (B, S, H, Dh) float32 output, mstat and dstat its row statistics m_t and
// den_t (B, S, H) float32, from a forward on the same route (route 2 reads
// its states' stabilisers from the chain of that forward's state pass);
// dh: (B, S, H, Dh) float32; ws: the route's workspace
// (repro_mlstm_scan_bwd_workspace_bytes).  Writes dq, dk, dv (q's dtype),
// dig (B, S, H) float32 (the whole gradient of ig) and row (B, S, H)
// float32 (each row's sum of dS o (q~ k^T)), from which the caller forms
// fg's gradient.  All contiguous, on the current device; route 2 also
// needs q, k, v, h, dh and ws on 16-byte boundaries and Dh a multiple of 8.
// Launches the route's kernels on `stream` and returns cudaGetLastError()
// after them (0 on success), or the error that refused the call.
extern "C" int repro_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    const void* h, const void* dh, const void* mstat, const void* dstat,
    void* ws, void* dq, void* dk, void* dv, void* dig, void* row, int B,
    int S, int H, int Dh, int route, float sqrt_dh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0 ||
      (C0 == nullptr) != (n0 == nullptr) || (C0 == nullptr) != (m0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_ig = static_cast<const float*>(ig);
  const float* f_fg = static_cast<const float*>(fg);
  const float* f_C0 = static_cast<const float*>(C0);
  const float* f_n0 = static_cast<const float*>(n0);
  const float* f_m0 = static_cast<const float*>(m0);
  const float* f_h = static_cast<const float*>(h);
  const float* f_dh = static_cast<const float*>(dh);
  const float* f_ms = static_cast<const float*>(mstat);
  const float* f_ds = static_cast<const float*>(dstat);
  float* f_dig = static_cast<float*>(dig);
  float* f_row = static_cast<float*>(row);
  switch (route) {
    case 0:
      return (int)launch_bwd<float>(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0,
                                    f_h, f_dh, f_ms, f_ds, ws, dq, dk, dv,
                                    f_dig, f_row, B, S, H, Dh, sqrt_dh, st);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(
          q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0, f_h, f_dh, f_ms, f_ds, ws,
          dq, dk, dv, f_dig, f_row, B, S, H, Dh, sqrt_dh, st);
    case 2:
      return (int)launch_bwd_wgmma(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0, f_h,
                                   f_dh, f_ms, f_ds, ws, dq, dk, dv, f_dig,
                                   f_row, B, S, H, Dh, sqrt_dh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
