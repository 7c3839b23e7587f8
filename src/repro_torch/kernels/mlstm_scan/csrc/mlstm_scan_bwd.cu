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
// 0.07 ms for its bytes.  This kernel computes D's update twice (passes 3
// and 4), six state products where five would do.
//
// Design: scalar float32 FMAs for both dtypes (q, k, v read as bf16 or
// float32), five launches:
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
// The workspace holds the per-row scalars and the three inter-chunk parts
// (float32, B*S*H*Dh each): nothing grows with the number of chunks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

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
constexpr float NEG_INF = -1e30f;    // the reference's initial m
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

// log(sigmoid(x)) as jax.nn.log_sigmoid computes it: -softplus(-x)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
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

__host__ inline long long up256(long long x) { return (x + 255) / 256 * 256; }

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

}  // namespace

// Steps per chunk of the backward (any S; the last chunk is masked).
extern "C" int repro_mlstm_scan_bwd_chunk() { return T; }

// Bytes of the workspace repro_mlstm_scan_bwd needs (256-byte aligned
// parts; the base must be 16-byte aligned).
extern "C" long long repro_mlstm_scan_bwd_workspace_bytes(int B, int S,
                                                          int H, int Dh) {
  return bwd_ws(B, S, H, Dh).bytes;
}

// q, k, v: (B, S, H, Dh) float32 (dtype 0) or bf16 (dtype 1); ig, fg: (B,
// S, H) float32; C0 (B, H, Dh, Dh), n0 (B, H, Dh), m0 (B, H) float32 or all
// three null, as the forward took them; h: the forward's (B, S, H, Dh)
// float32 output, mstat and dstat its row statistics m_t and den_t (B, S,
// H) float32;
// dh: (B, S, H, Dh) float32; ws: the workspace
// (repro_mlstm_scan_bwd_workspace_bytes).  Writes dq, dk, dv (q's dtype),
// dig (B, S, H) float32 (the whole gradient of ig) and row (B, S, H)
// float32 (each row's sum of dS o (q~ k^T)), from which the caller forms
// fg's gradient.  All contiguous, on the current device.  Launches five
// kernels on `stream` and returns cudaGetLastError() after them (0 on
// success), or the error that refused the call.
extern "C" int repro_mlstm_scan_bwd(
    const void* q, const void* k, const void* v, const void* ig,
    const void* fg, const void* C0, const void* n0, const void* m0,
    const void* h, const void* dh, const void* mstat, const void* dstat,
    void* ws, void* dq, void* dk, void* dv, void* dig, void* row, int B,
    int S, int H, int Dh, int dtype, float sqrt_dh, void* stream) {
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
  if (dtype == 0)
    return (int)launch_bwd<float>(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0, f_h,
                                  f_dh, f_ms, f_ds, ws, dq, dk, dv, f_dig,
                                  f_row, B, S, H, Dh, sqrt_dh, st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(
        q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0, f_h, f_dh, f_ms, f_ds, ws, dq,
        dk, dv, f_dig, f_row, B, S, H, Dh, sqrt_dh, st);
  return (int)cudaErrorInvalidValue;
}
