// Chunkwise mLSTM for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_mlstm_kernel`, launched by
// `mlstm_chunkwise_pallas` in src/repro/kernels/mlstm_scan/kernel.py: the
// log-stabilised chunkwise mLSTM of xLSTM's matrix memory.  Per (b, h) and
// chunk of T steps, with q scaled by 1/sqrt(Dh) and lf = log_sigmoid(fg):
//
//   b_t   = cumsum(lf) within the chunk,   a[t,s] = (b_t - b_s) + ig_s (s <= t)
//   m_t   = max(max_s a[t,s], b_t + m_prev)
//   W     = (q k^T) o exp(a - m_t)                 (causal, zero above)
//   h_t   = (W v + (q w_out) C)_t / max(|den_t|, exp(-m_t)),
//           w_out_t = exp(b_t + m_prev - m_t),  den = rowsum(W) + (q w_out) n
//   m_new = max(b_T + m_prev, max_s (ig_s + b_T) - b_s)
//   C     = f_c C + (k o g)^T v,  n = f_c n + sum_s k_s g_s,
//           f_c = exp(b_T + m_prev - m_new),  g_s = exp(ig_s + (b_T - b_s) - m_new)
//
// all in float32 (q, k, v arrive as bf16 or float32, ig and fg as float32),
// in the reference's order of operations where it fixes one, with one
// exception: the in-chunk differences b_t - b_s come from a float64 cumsum.
// In float32 they lose the low bits of lf wherever |b| grows large (about
// T |lf|: strongly negative forget gates), which a smaller chunk, such as
// the reference's 8 at S = 1000, does not.  h, C, n and m leave as float32.
//
// The result does not depend on the chunk, so each route takes its own T
// for every S: the last chunk is masked (its padded rows enter neither the
// maxima nor the state update, and b_T is the cumsum at the last valid
// row), where the reference halves its chunk until it divides S (chunk 8 at
// S = 1000, 1 at a prime S) and the Pallas wrapper sends ragged S and
// `init_state` to the reference.  Every route takes any B, S and H and an
// initial state (C0, n0, m0).
//
// What bounds it on the H100: per (b, h) the inter-chunk products q C and
// (k g)^T v are 4 S Dh^2 flops and the intra-chunk q k^T and W v 4 S T Dh;
// at xlstm-1.3b's prefill (B 4, S 1000, H 4, Dh 1024) the least work of the
// function is 67.2 GFLOP against 231 MB of q, k, v, h, C and gates, 0.069 ms
// by bytes at the bf16 tensor-core rate, 1.0 ms by operations on float32
// CUDA cores.
//
// Three routes, picked by the caller (ops.py, by dtype and shape) and
// checked here: a route refuses what it cannot take, nothing falls back.
//  * wgmma_bf16: bf16 q, k, v that TMA can address (16-byte aligned bases,
//    Dh a multiple of 8).  Three passes with the products on bf16 `wgmma`
//    and float32 operands split into two bf16 halves (see its section).
//  * scalar_bf16: bf16 q, k, v that TMA cannot address, on the scalar
//    float32 kernels.
//  * scalar_f32: float32 q, k, v, on the scalar float32 kernels.  Splitting
//    both float32 factors of a product would take three or four bf16
//    passes; the float32 model is held at 1e-4 through this route.
//
// The Hopper primitives (inline PTX) are in ../../csrc/hopper.cuh; the
// wgmma route's gate, q k^T and state passes, which the backward runs too,
// in mlstm_wgmma.cuh.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "mlstm_wgmma.cuh"

namespace {

// ===========================================================================
// Scalar routes (scalar_f32, scalar_bf16)
//
// The TPU kernel keeps the (Dh, Dh) state in VMEM across the sequential
// chunk axis of its grid.  At xlstm-1.3b's Dh = 1024 that state is 4 MiB
// per (b, h), 18 times an H100 SM's shared memory.  So the value columns of
// C are split across blocks, and the work is two launches:
//  * scores: grid (B*H*chunks); each block forms the raw T x T products
//    P = (q / sqrt(Dh)) k^T of one chunk (a float32 workspace of
//    B*H*chunks*T*T, 4.2 MB at the serving shape).  No state is needed, so
//    every chunk runs in parallel.
//  * state: grid (B*H*ceil(Dh/32)); each block keeps a Dh x 32 slab of C in
//    shared memory (128 KiB at Dh 1024) and its own copy of n (Dh floats)
//    through all chunks.  Per chunk it recomputes the chunk's stabilisers
//    from ig and fg (O(T^2) scalars), gates P into W, and walks the key rows
//    of C in steps of 64: q and k o g sub-blocks are staged in shared
//    memory, the old rows feed (q w_out) C and (q w_out) n, then the rows are
//    updated.  Lane j of every warp owns value column j, so loads of v and h
//    coalesce and the staged q and k rows are read as broadcasts.  n and den
//    are the same in all 32 blocks of a (b, h): each computes them (3% of
//    its work) rather than wait on another block.
// Arithmetic is float32 on scalar FMAs (not TF32, which computes another
// function).  T = 64.  Past Dh = 1280 the slab no longer fits in shared
// memory; it then stays in the output C in device memory (each block still
// owns its own columns), which keeps every Dh up to 42,432 running, through
// L2.
// ===========================================================================


constexpr int T = 64;       // steps per chunk
constexpr int TILE = 32;    // value columns of C per block: one per lane
constexpr int IB = 64;      // key rows of C per inner step
constexpr int NT = 256;     // threads per block
constexpr int NW = NT / 32;
constexpr int RW = T / NW;  // chunk rows (and key rows) per warp
constexpr int QS = IB + 4;  // row stride of the staged q / k rows: float4
                            // aligned, rows four banks apart
constexpr int WS = T + 4;   // row stride of the gated scores
constexpr int SMEM_LIMIT = 232448;   // shared memory a block may use
constexpr int SE = T * IB / NT / 2;   // staged elements a thread loads at
                                      // once (two rounds per sub-block)
static_assert(RW == 8 && IB == NW * RW, "8 warps, 8 rows each");
static_assert(NT == 4 * T, "four threads per chunk row");
static_assert(2 * SE * NT == T * IB, "two rounds stage a sub-block");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}


// Round r of staging the T x IB sub-block x[t0 + t][i0 + i] of q or k:
// element u of the thread is (t, i) = divmod(tid + (2u + r) NT, IB), zero
// past L or ib.  All SE loads are issued before any value is used, so a
// round waits on one memory latency rather than one per element.
template <typename TQ>
__device__ __forceinline__ void load_round(float (&out)[SE],
                                           const TQ* __restrict__ x,
                                           long long base, long long row,
                                           int i0, int L, int ib, int r) {
#pragma unroll
  for (int u = 0; u < SE; ++u) {
    const int e = threadIdx.x + (2 * u + r) * NT, t = e / IB, i = e % IB;
    out[u] = (t < L && i < ib) ? to_f32(x[base + t * row + i0 + i]) : 0.f;
  }
}

// Floats of dynamic shared memory of one state block.
__host__ __device__ inline long long state_smem_floats(int Dh, bool smem_c) {
  const long long DhP = round_up(Dh, IB);
  return (smem_c ? DhP * TILE : 0) + DhP + 2LL * T * QS + (long long)T * WS +
         (long long)T * TILE + 2LL * T + 7LL * T + 4;
}

// ---------------------------------------------------------------------------
// Launch 1: raw scores P[t][s] = (q_t / sqrt(Dh)) . k_s of one chunk
// ---------------------------------------------------------------------------
template <typename TQ>
__global__ void __launch_bounds__(NT)
mlstm_scores_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                    float* __restrict__ scores, int S, int H, int Dh,
                    int n_chunks, float sqrt_dh) {
  __shared__ float qs[T][IB + 1];
  __shared__ float ks[T][IB + 1];
  const int bh = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int b = bh / H, hh = bh % H;
  const int t0 = c * T, L = min(T, S - t0);
  const long long row = (long long)H * Dh;   // elements between two steps
  const long long base = ((long long)b * S + t0) * row + (long long)hh * Dh;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[r][u] = 0.f;

  for (int i0 = 0; i0 < Dh; i0 += IB) {
    const int ib = min(IB, Dh - i0);
    for (int r = 0; r < 2; ++r) {
      float qv[SE], kv[SE];
      load_round(qv, q, base, row, i0, L, ib, r);
      load_round(kv, k, base, row, i0, L, ib, r);
#pragma unroll
      for (int u = 0; u < SE; ++u) {
        const int e = tid + (2 * u + r) * NT, t = e / IB, i = e % IB;
        qs[t][i] = qv[u] / sqrt_dh;
        ks[t][i] = kv[u];
      }
    }
    __syncthreads();
    for (int i = 0; i < ib; ++i) {
      float a[4], kk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = qs[ty + 16 * r][i];
        kk[r] = ks[tx + 16 * r][i];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[r][u] = fmaf(a[r], kk[u], acc[r][u]);
    }
    __syncthreads();
  }
  // rows and columns past L hold zeros; the state kernel reads only s <= t < L
  float* out = scores + (long long)blockIdx.x * T * T;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      out[(ty + 16 * r) * T + tx + 16 * u] = acc[r][u];
}

// ---------------------------------------------------------------------------
// Launch 2: the chunk recurrence over a 32-column slab of C
// ---------------------------------------------------------------------------
template <typename TQ, bool SMEM_C>
__global__ void __launch_bounds__(NT)
mlstm_state_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                   const TQ* __restrict__ v, const float* __restrict__ ig,
                   const float* __restrict__ fg, const float* __restrict__ C0,
                   const float* __restrict__ n0, const float* __restrict__ m0,
                   const float* __restrict__ scores, float* __restrict__ hout,
                   float* __restrict__ Cout, float* __restrict__ nout,
                   float* __restrict__ mout, float* __restrict__ mstat,
                   float* __restrict__ dstat, int S, int H, int Dh,
                   int n_chunks, int n_tiles, float sqrt_dh) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int DhP = round_up(Dh, IB);
  float* Cs = smem;                                   // DhP x TILE (SMEM_C)
  float* ns = Cs + (SMEM_C ? DhP * TILE : 0);         // DhP
  float* qs = ns + DhP;                               // T x QS
  float* ks = qs + T * QS;                            // T x QS
  float* Ws = ks + T * QS;                            // T x WS
  float* vt = Ws + T * WS;                            // T x TILE
  double* s_b = reinterpret_cast<double*>(vt + T * TILE);   // T doubles
  float* s_lf = reinterpret_cast<float*>(s_b + T);    // 7 arrays of T
  float* s_ig = s_lf + T;
  float* s_m = s_ig + T;
  float* s_wout = s_m + T;
  float* s_gm = s_wout + T;
  float* s_g = s_gm + T;
  float* s_den = s_g + T;
  float* s_mnew = s_den + T;                          // 1 (padded to 4)

  const int bh = blockIdx.x / n_tiles, tile = blockIdx.x % n_tiles;
  const int b = bh / H, hh = bh % H;
  const int j0 = tile * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool jok = j0 + lane < Dh;
  const long long DD = (long long)Dh * Dh;
  // C slab: element (i, lane) at Cp[i * cst + lane]
  float* Cp = SMEM_C ? Cs : Cout + bh * DD + j0;
  const long long cst = SMEM_C ? TILE : Dh;

  // ---- initial state ------------------------------------------------------
  if (SMEM_C) {
    for (int e = tid; e < DhP * TILE; e += NT) {
      const int i = e / TILE, jj = e % TILE;
      const bool ok = i < Dh && j0 + jj < Dh && C0 != nullptr;
      Cs[e] = ok ? C0[bh * DD + (long long)i * Dh + j0 + jj] : 0.f;
    }
  } else {
    for (int e = tid; e < Dh * TILE; e += NT) {
      const int i = e / TILE, jj = e % TILE;
      if (j0 + jj < Dh)
        Cp[i * cst + jj] =
            C0 != nullptr ? C0[bh * DD + (long long)i * Dh + j0 + jj] : 0.f;
    }
  }
  for (int i = tid; i < DhP; i += NT)
    ns[i] = (i < Dh && n0 != nullptr) ? n0[(long long)bh * Dh + i] : 0.f;
  float m_prev = m0 != nullptr ? m0[bh] : NEG_INF;
  __syncthreads();

  const long long row = (long long)H * Dh;   // elements between two steps
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * T, L = min(T, S - t0);
    const long long gbase = ((long long)b * S + t0) * H + hh;  // ig, fg
    const long long base = gbase * Dh;                         // q k v h

    // ---- stabilisers and gates of the chunk (O(T^2) scalars) --------------
    if (tid < T) {
      s_lf[tid] = tid < L ? log_sigmoid(fg[gbase + (long long)tid * H]) : 0.f;
      s_ig[tid] = tid < L ? ig[gbase + (long long)tid * H] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {           // cumulative log-forget, in order
      double acc = 0.0;
      for (int t = 0; t < L; ++t) {
        acc += s_lf[t];
        s_b[t] = acc;
      }
    }
    __syncthreads();
    const double bTd = s_b[L - 1];
    const float bT = (float)bTd;
    if (tid < L) {
      const int t = tid;
      const double bt = s_b[t];
      float m_intra = -INFINITY;
      for (int s = 0; s <= t; ++s)
        m_intra = fmaxf(m_intra, (float)(bt - s_b[s]) + s_ig[s]);
      const float m_inter = (float)bt + m_prev;
      const float mt = fmaxf(m_intra, m_inter);
      s_m[t] = mt;
      s_wout[t] = expf(m_inter - mt);
      // log weight of step t in the state update, before m_new
      s_gm[t] = s_ig[t] + (float)(bTd - bt);
    }
    __syncthreads();
    if (tid == 0) {
      float mx = bT + m_prev;
      for (int s = 0; s < L; ++s) mx = fmaxf(mx, s_gm[s]);
      s_mnew[0] = mx;
    }
    __syncthreads();
    const float m_new = s_mnew[0];
    const float f_c = expf((bT + m_prev) - m_new);
    if (tid < T) s_g[tid] = tid < L ? expf(s_gm[tid] - m_new) : 0.f;
    // gated scores W = P o exp(a - m_t), zero above the diagonal and past L
    const float* P = scores + ((long long)bh * n_chunks + c) * T * T;
    for (int e = tid; e < T * T; e += NT) {
      const int t = e / T, s = e % T;
      float w = 0.f;
      if (t < L && s <= t)
        w = P[e] * expf(((float)(s_b[t] - s_b[s]) + s_ig[s]) - s_m[t]);
      Ws[t * WS + s] = w;
    }
    for (int e = tid; e < T * TILE; e += NT) {
      const int s = e / TILE, jj = e % TILE;
      vt[e] = (s < L && j0 + jj < Dh)
                  ? to_f32(v[base + s * row + j0 + jj])
                  : 0.f;
    }
    __syncthreads();

    // ---- intra-chunk part: W v and rowsum(W) ------------------------------
    float acc_w[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) acc_w[r] = 0.f;
    const int smax = min(L, RW * warp + RW);   // rows of this warp: s < smax
    for (int s = 0; s < smax; s += 4) {
      float v4[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v4[u] = vt[(s + u) * TILE + lane];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 w = *reinterpret_cast<const float4*>(
            &Ws[(RW * warp + r) * WS + s]);
        acc_w[r] = fmaf(w.x, v4[0], acc_w[r]);
        acc_w[r] = fmaf(w.y, v4[1], acc_w[r]);
        acc_w[r] = fmaf(w.z, v4[2], acc_w[r]);
        acc_w[r] = fmaf(w.w, v4[3], acc_w[r]);
      }
    }
    const int drow = tid / 4, dpart = tid % 4;  // four threads per row
    float den_intra = 0.f;
    for (int s = dpart; s < T; s += 4) den_intra += Ws[drow * WS + s];
    den_intra += __shfl_xor_sync(0xffffffffu, den_intra, 1);
    den_intra += __shfl_xor_sync(0xffffffffu, den_intra, 2);

    // ---- inter-chunk part and state update, 64 key rows at a time ---------
    float acc_x[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) acc_x[r] = 0.f;
    float den_inter = 0.f;
    for (int i0 = 0; i0 < Dh; i0 += IB) {
      const int ib = min(IB, Dh - i0);
      for (int r = 0; r < 2; ++r) {
        float qv[SE], kv[SE];
        load_round(qv, q, base, row, i0, L, ib, r);
        load_round(kv, k, base, row, i0, L, ib, r);
#pragma unroll
        for (int u = 0; u < SE; ++u) {
          const int e = tid + (2 * u + r) * NT, t = e / IB, i = e % IB;
          qs[t * QS + i] = t < L ? (qv[u] / sqrt_dh) * s_wout[t] : 0.f;
          ks[t * QS + i] = t < L ? kv[u] * s_g[t] : 0.f;
        }
      }
      __syncthreads();
      // (q w_out) C and (q w_out) n with the old rows [i0, i0 + ib)
      for (int i = 0; i < ib; i += 4) {
        float c4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          c4[u] = (i + u < ib && jok) ? Cp[(i0 + i + u) * cst + lane] : 0.f;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(
              &qs[(RW * warp + r) * QS + i]);
          acc_x[r] = fmaf(qv.x, c4[0], acc_x[r]);
          acc_x[r] = fmaf(qv.y, c4[1], acc_x[r]);
          acc_x[r] = fmaf(qv.z, c4[2], acc_x[r]);
          acc_x[r] = fmaf(qv.w, c4[3], acc_x[r]);
        }
      }
      for (int i = dpart; i < ib; i += 4)
        den_inter = fmaf(qs[drow * QS + i], ns[i0 + i], den_inter);
      __syncthreads();   // every read of the old rows is done
      // C = f_c C + (k g)^T v and n = f_c n + sum_s k g on rows [i0, i0 + ib)
      float acc_u[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) acc_u[r] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float vv = vt[s * TILE + lane];
        const float4 k0 =
            *reinterpret_cast<const float4*>(&ks[s * QS + RW * warp]);
        const float4 k1 =
            *reinterpret_cast<const float4*>(&ks[s * QS + RW * warp + 4]);
        acc_u[0] = fmaf(k0.x, vv, acc_u[0]);
        acc_u[1] = fmaf(k0.y, vv, acc_u[1]);
        acc_u[2] = fmaf(k0.z, vv, acc_u[2]);
        acc_u[3] = fmaf(k0.w, vv, acc_u[3]);
        acc_u[4] = fmaf(k1.x, vv, acc_u[4]);
        acc_u[5] = fmaf(k1.y, vv, acc_u[5]);
        acc_u[6] = fmaf(k1.z, vv, acc_u[6]);
        acc_u[7] = fmaf(k1.w, vv, acc_u[7]);
      }
      if (jok) {
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int i = RW * warp + r;
          if (i < ib) {
            float* cp = &Cp[(i0 + i) * cst + lane];
            *cp = f_c * *cp + acc_u[r];
          }
        }
      }
      {   // four threads per key row, as for den
        float sk = 0.f;
        for (int s = dpart; s < L; s += 4) sk += ks[s * QS + drow];
        sk += __shfl_xor_sync(0xffffffffu, sk, 1);
        sk += __shfl_xor_sync(0xffffffffu, sk, 2);
        if (dpart == 0 && drow < ib)
          ns[i0 + drow] = f_c * ns[i0 + drow] + sk;
      }
      __syncthreads();   // before the next rows are staged
    }

    // ---- h = num / max(|den|, exp(-m_t)) ----------------------------------
    den_inter += __shfl_xor_sync(0xffffffffu, den_inter, 1);
    den_inter += __shfl_xor_sync(0xffffffffu, den_inter, 2);
    if (dpart == 0) s_den[drow] = den_intra + den_inter;
    __syncthreads();
    // the row statistics for the backward, m_t and den_t (one block of the
    // (b, h) writes them)
    if (mstat != nullptr && tile == 0 && tid < L) {
      mstat[gbase + (long long)tid * H] = s_m[tid];
      dstat[gbase + (long long)tid * H] = s_den[tid];
    }
    if (jok) {
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int t = RW * warp + r;
        if (t < L)
          hout[base + t * row + j0 + lane] =
              (acc_w[r] + acc_x[r]) / fmaxf(fabsf(s_den[t]), expf(-s_m[t]));
      }
    }
    m_prev = m_new;
    __syncthreads();   // before the next chunk overwrites the gate arrays
  }

  // ---- final state ----------------------------------------------------------
  if (SMEM_C) {
    for (int e = tid; e < Dh * TILE; e += NT) {
      const int i = e / TILE, jj = e % TILE;
      if (j0 + jj < Dh) Cout[bh * DD + (long long)i * Dh + j0 + jj] = Cs[e];
    }
  }
  if (tile == 0) {
    for (int i = tid; i < Dh; i += NT) nout[(long long)bh * Dh + i] = ns[i];
    if (tid == 0) mout[bh] = m_prev;
  }
}

template <typename TQ, bool SMEM_C>
cudaError_t launch_state(const void* q, const void* k, const void* v,
                         const float* ig, const float* fg, const float* C0,
                         const float* n0, const float* m0,
                         const float* scores, float* h, float* C, float* n,
                         float* m, float* mstat, float* dstat, int grid,
                         int S, int H, int Dh,
                         int n_chunks, int n_tiles, float sqrt_dh,
                         cudaStream_t st) {
  const size_t smem = sizeof(float) * state_smem_floats(Dh, SMEM_C);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_kernel<TQ, SMEM_C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_state_kernel<TQ, SMEM_C><<<grid, NT, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TQ*>(v), ig, fg, C0, n0, m0, scores, h, C, n, m,
      mstat, dstat, S, H, Dh, n_chunks, n_tiles, sqrt_dh);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, const float* C0,
                   const float* n0, const float* m0, float* scores, float* h,
                   float* C, float* n, float* m, float* mstat, float* dstat,
                   int B, int S, int H, int Dh, float sqrt_dh,
                   cudaStream_t st) {
  const int n_chunks = (S + T - 1) / T;
  const int n_tiles = (Dh + TILE - 1) / TILE;
  const long long BH = (long long)B * H;
  if (BH * n_chunks > 0x7fffffffLL || BH * n_tiles > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const bool smem_c = sizeof(float) * state_smem_floats(Dh, true) <=
                      (size_t)SMEM_LIMIT;
  if (!smem_c && sizeof(float) * state_smem_floats(Dh, false) >
                     (size_t)SMEM_LIMIT)
    return cudaErrorInvalidValue;
  mlstm_scores_kernel<TQ><<<(int)(BH * n_chunks), NT, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k), scores, S, H, Dh,
      n_chunks, sqrt_dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = (int)(BH * n_tiles);
  if (smem_c)
    return launch_state<TQ, true>(q, k, v, ig, fg, C0, n0, m0, scores, h, C,
                                  n, m, mstat, dstat, grid, S, H, Dh,
                                  n_chunks, n_tiles, sqrt_dh, st);
  return launch_state<TQ, false>(q, k, v, ig, fg, C0, n0, m0, scores, h, C,
                                 n, m, mstat, dstat, grid, S, H, Dh,
                                 n_chunks, n_tiles, sqrt_dh, st);
}


// ===========================================================================
// wgmma_bf16 route: a gate pass, a q k^T pass, a state pass, an output pass
//
// The state recurrence and the outputs come apart (the structure of the
// xLSTM authors' own GPU kernels, "Tiled Flash Linear Attention"): the
// state pass materialises the state that enters each chunk, and the output
// pass then runs every (chunk, value-column tile) in parallel.
//
// Tensor cores without another function.  The state C is float32, and bf16
// or TF32 operands would compute another function.  But q, k and v arrive
// as bf16, so every product has one factor that is exactly bf16, and the
// other, float32, factor x is split as hi + lo with hi = bf16(x) and
// lo = bf16(x - hi): |x - hi - lo| <= 2^-16 |x|.  Each product is then two
// bf16 `wgmma` passes (hi, lo) into float32 accumulators; per-row and
// per-step scalars stay outside the products:
//   q k^T              both factors bf16; 1/sqrt(Dh) scales the result
//   (q w_out) C        diag(w_out) (q C): q exact, C^T split
//   W v                v exact, W = (q k^T) o exp(a - m) split
//   (k o g)^T v        = (g o v)^T k: k exact, g o v split
// The tensor cores' float32 accumulation truncates, so a long chain of
// them (q k^T over Dh = 1024 keys in one accumulator) is several times
// less accurate than float32 FMAs; where den cancels toward its floor that
// shows in h (4x the plain version's error against the float64 recurrence
// in chip_smoke.py's random-key stress case).  q k^T therefore starts a
// fresh accumulator every 64 keys and sums them in float32; the other
// chains are 128 long (the steps of a chunk) or carry the state, which
// keeps its own error within the plain version's.
//
// Passes (T = CT = 128 steps a chunk; Dp = Dh rounded up to 128):
//  1. gates, grid (B*H*chunks), CT threads: the chunk's float64 cumsum b,
//     m_intra_t = max_{s<=t} a[t,s], ig, g's log weight ig_s + (b_T - b_s)
//     and the chunk's (b_T, max_s of that weight).  Nothing here depends
//     on the state, so every chunk runs at once; the chain of m over the
//     chunks (m_new = max(b_T + m_prev, that max)) is a few scalar steps
//     that each later CTA walks itself (entry_m), so the large passes have
//     no serial section.
//  2. q k^T, grid (B*H*chunks): the raw scores of each chunk (CT x CT,
//     float32, 64 rows a consumer warpgroup) from Q and K panels streamed
//     through three stages, once per chunk (8.4 MB at the serving shape).
//  3. states, grid (B*H * Dp/128 * Dp/128): each CTA holds one 128 x 128
//     tile of C^T (rows j: values, columns i: keys) as float32 wgmma
//     accumulators, 64 rows in each of two consumer warpgroups, and walks
//     the chunks in order.  Per chunk it stores the tile it holds (the state
//     entering the chunk) as bf16 hi and lo to the workspace, through a
//     staging buffer and TMA stores; scales it by f_c; and adds
//     (g o v)^T k in two passes, A = (g o v)^T built in registers from the
//     staged v tile and split (the accumulator layout is the A layout, as
//     flash feeds P), B = k MN-major in shared memory.  A producer warp
//     keeps the k and v tiles of the next chunk in flight (two stages).
//     The CTAs of the first value tile also carry n for their keys (CUDA
//     cores, 1/128 of the work) and write it per chunk.  Holding C^T rather
//     than C keeps every operand in a mode that the flash kernel uses.
//  4. outputs, grid (B*H * chunks * Dp/128): each CTA makes 128 value
//     columns of h for the CT rows of one chunk (64 rows a consumer
//     warpgroup).  Per 64-wide panel of keys, Q feeds O += Q (C^T_hi)^T +
//     Q (C^T_lo)^T (B K-major); the panels stream through four stages.
//     Then the chunk's scores are gated into W with the float64
//     differences and m_t, O is scaled by w_out / sqrt(Dh), O += W_hi V +
//     W_lo V (A from registers, B = V MN-major), den = rowsum(W) +
//     w_out (q . n) / sqrt(Dh) (q . n on CUDA cores from the staged q, 1/Dh
//     of the work), and h = O / max(|den|, exp(-m_t)) is stored as float32
//     pairs (each quad of lanes writes whole 32-byte sectors).
// Workspace per segment of the sequence (STATE_BUDGET: the passes walk S
// in segments of at most 1 GiB of C^T, carrying (C, n, m) from one to the
// next): the gates (CT doubles and 3 CT floats per (b, h, chunk)), the
// scores, n at each chunk's entry (float32, chunks x B*H x Dp) and C^T at
// each chunk's entry (bf16 hi and lo, chunks x B*H x 2 x Dp^2: 512 MiB at
// the serving shape, one segment, written once and read once), laid out
// tile by tile so that each TMA box of it is one contiguous block.
// Without an initial state the state entering chunk 0 is zero: the state
// pass does not store it and the output pass skips q C and q n there.
// Operand tiles in shared memory are 64-column panels with the 128-byte
// swizzle, one TMA box each; q, k and v are read in their (B, S, H, Dh)
// layout through 4-D tensor maps, rows past S and columns past Dh as
// zeros.  A panel that lies wholly past Dh is never loaded: it is zeroed
// once when the CTA starts.  Each CTA of passes 2-4 has one producer
// warpgroup and two consumer warpgroups, with `setmaxnreg` moving
// registers to the consumers, and runs one to an SM.
// ===========================================================================

// Byte offsets of the workspace's parts (each 256-byte aligned), for
// segments of n_chunks chunks.
struct WsLayout {
  long long b, ig, mi, gm, ch, s, n, c, m, bytes;
};

__host__ __device__ inline WsLayout ws_layout(long long BH, int n_chunks,
                                              int Dh) {
  const long long rows = BH * n_chunks * CT, Dp = pad_dh(Dh);
  WsLayout w;
  w.b = 0;                                   // b_t, float64
  w.ig = up256(w.b + 8 * rows);              // ig_t
  w.mi = up256(w.ig + 4 * rows);             // m_intra_t
  w.gm = up256(w.mi + 4 * rows);             // ig_s + (b_T - b_s), -inf past L
  w.ch = up256(w.gm + 4 * rows);             // (b_T, max_s gm_s) per chunk
  w.s = up256(w.ch + 8 * BH * n_chunks);     // q k^T of each chunk, float32
  w.n = up256(w.s + 4 * rows * CT);          // n entering each chunk
  w.c = up256(w.n + 4 * BH * n_chunks * Dp); // C^T entering each chunk
  w.m = up256(w.c + 2LL * BH * n_chunks * 2 * Dp * Dp);  // m, 2 segments
  w.bytes = w.m + 4 * 2 * BH;
  return w;
}

// Dynamic shared memory of the output pass: the V tile (two panels), four
// stages of (Q, C^T hi, C^T lo) panels, barriers.
struct OutputsSmem {
  static constexpr int STAGES = 4;
  static constexpr int V_BYTES = 2 * PANEL_BYTES;
  static constexpr int STAGE_BYTES = 3 * PANEL_BYTES;
  static constexpr int BAR_OFFSET = V_BYTES + STAGES * STAGE_BYTES;
  static constexpr int N_BARS = 1 + 2 * STAGES;
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
};


// ---------------------------------------------------------------------------
// Pass 4: h of one chunk, 128 value columns a CTA
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTW, 1)
mlstm_outputs_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tws,
                     const float* __restrict__ scores,
                     const double* __restrict__ gb,
                     const float* __restrict__ gig,
                     const float* __restrict__ gmi,
                     const float* __restrict__ gch,
                     const float* __restrict__ n_ws,
                     const float* __restrict__ m0, float* __restrict__ hout,
                     float* __restrict__ mstat, float* __restrict__ dstat,
                     int S, int S_stride, int H, int Dh, int n_chunks,
                     float inv_sqrt_dh) {
  using M = OutputsSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* vs = smem;
  uint8_t* stages = smem + M::V_BYTES;
  uint64_t* v_full = reinterpret_cast<uint64_t*>(smem + M::BAR_OFFSET);
  uint64_t* full = v_full + 1;
  uint64_t* empty = full + M::STAGES;

  const int Dp = pad_dh(Dh), nt = Dp / CTILE;
  const int jt = blockIdx.x % nt;
  const int c = blockIdx.x / nt % n_chunks;
  const long long bh = blockIdx.x / (nt * n_chunks);
  const int b = (int)(bh / H), hh = (int)(bh % H);
  const long long slab = bh * n_chunks + c;
  const int j0 = jt * CTILE, t0 = c * CT, L = min(CT, S - t0);
  const int npj = min(2, (Dh - j0 + PANEL - 1) / PANEL);
  // 64-key panels of q and of the state; none for chunk 0 from the zero
  // state, where q C and q n vanish
  const bool zero_entry = c == 0 && m0 == nullptr;
  const int np = zero_entry ? 0 : (Dh + PANEL - 1) / PANEL;
  const int wg = threadIdx.x / WG;

  for (int p = npj; p < 2; ++p) zero_smem(vs + p * PANEL_BYTES, PANEL_BYTES);
  if (threadIdx.x == 0) {
    mbar_init(v_full, 1);
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
      mbar_expect_tx(v_full, npj * PANEL_BYTES);
      for (int p = 0; p < npj; ++p)
        tma_load_4d(vs + p * PANEL_BYTES, &tv, v_full, j0 + p * PANEL, hh, t0,
                    b);
      for (int p = 0; p < np; ++p) {
        const int s = p % M::STAGES;
        uint8_t* st = stages + s * M::STAGE_BYTES;
        mbar_wait(empty + s, ((p / M::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 3 * PANEL_BYTES);
        tma_load_4d(st, &tq, full + s, p * PANEL, hh, t0, b);
        const int tile = (int)((slab * nt + jt) * 2 * nt + p);
        tma_load_4d(st + PANEL_BYTES, &tws, full + s, 0, 0, 0, tile);
        tma_load_4d(st + 2 * PANEL_BYTES, &tws, full + s, 0, 0, 1, tile);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;
    const int rw = 16 * warp + lane / 4;   // row of acc[0] within the 64
    const int r0 = 64 * wg + rw;           // chunk row of acc[0]; +8 for hr 1
    const int cq = 2 * (lane % 4);
    // oacc[e]: O[t][j] at t = r0 + 8 ((e/2) % 2), j - j0 = 8 (e/4) + cq +
    // e % 2
    float oacc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) oacc[e] = 0.f;
    float qn[2] = {0.f, 0.f};   // this lane's part of q . n, rows r0, r0 + 8

    for (int p = 0; p < np; ++p) {
      const int s = p % M::STAGES;
      const uint8_t* st = stages + s * M::STAGE_BYTES;
      const uint8_t* Qw = st + wg * 64 * ROW_BYTES;   // this warpgroup's rows
      // n of the panel's keys (the quad's lanes take 16 keys each), loaded
      // before the wait for the tiles, under which its latency passes
      const float4* nv4 = reinterpret_cast<const float4*>(
          n_ws + slab * Dp + p * PANEL + 16 * (lane % 4));
      float nv[16];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 f = nv4[u];
        nv[4 * u] = f.x;
        nv[4 * u + 1] = f.y;
        nv[4 * u + 2] = f.z;
        nv[4 * u + 3] = f.w;
      }
      mbar_wait(full + s, (p / M::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const int off = kk * 32;   // 16 columns = 32 bytes
        const uint64_t da = sw128_desc(Qw + off, 16);
        wgmma_ss(oacc, da, sw128_desc(st + PANEL_BYTES + off, 16), 1);
        wgmma_ss(oacc, da, sw128_desc(st + 2 * PANEL_BYTES + off, 16), 1);
      }
      wgmma_commit();
      // q . n over the panel's keys, from the staged q
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rw + 8 * hr;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int chunk16 = 2 * (lane % 4) + u;   // 16-byte chunk of the row
          const uint4 w = *reinterpret_cast<const uint4*>(
              Qw + row * ROW_BYTES + ((chunk16 ^ row) & 7) * 16);
          const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            __nv_bfloat162 pr;
            memcpy(&pr, &words[x], 4);
            const float2 f = __bfloat1622float2(pr);
            qn[hr] = fmaf(f.x, nv[8 * u + 2 * x], qn[hr]);
            qn[hr] = fmaf(f.y, nv[8 * u + 2 * x + 1], qn[hr]);
          }
        }
      }
      // the products of the panel before have completed: release its stage
      wgmma_wait1();
      if (p > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (p - 1) % M::STAGES);
      }
    }
    wgmma_wait0();
    __syncwarp();
    if (np > 0 && lane == 0) mbar_arrive(empty + (np - 1) % M::STAGES);
    reg_fence(oacc);

    // ---- stabilisers of this lane's rows
    const float m_prev = entry_m(gch, bh, c, n_chunks,
                                 m0 != nullptr ? m0[bh] : NEG_INF);
    const long long rec = slab * CT;
    double bt[2];
    float mt[2], wo[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int tr = r0 + 8 * hr;
      bt[hr] = gb[rec + tr];
      const float m_inter = (float)bt[hr] + m_prev;
      mt[hr] = fmaxf(gmi[rec + tr], m_inter);
      wo[hr] = expf(m_inter - mt[hr]);
    }
    // ---- W = (q k^T / sqrt(Dh)) o exp(a - m_t), causal, rows below L, in
    // the accumulator layout: sacc[e] at t = r0 + 8 ((e/2) % 2),
    // s = 8 (e/4) + cq + e % 2
    float sacc[64];
    const float* sc = scores + slab * CT * CT;
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const float2 f = *reinterpret_cast<const float2*>(
          sc + (r0 + 8 * ((e / 2) % 2)) * CT + 8 * (e / 4) + cq);
      sacc[e] = f.x;
      sacc[e + 1] = f.y;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int hr = (e / 2) % 2;
      const int tr = r0 + 8 * hr;
      const int sx = 8 * (e / 4) + cq + e % 2;
      float w = 0.f;
      if (sx <= tr && tr < L)
        w = sacc[e] * inv_sqrt_dh *
            expf(((float)(bt[hr] - gb[rec + sx]) + gig[rec + sx]) - mt[hr]);
      sacc[e] = w;
      rs[hr] += w;
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) oacc[e] *= wo[(e / 2) % 2] * inv_sqrt_dh;
    // ---- O += W_hi V + W_lo V
    uint32_t whi[CT / 16][4], wlo[CT / 16][4];
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sacc[8 * kk + 2 * r], sacc[8 * kk + 2 * r + 1], whi[kk][r],
                   wlo[kk][r]);
    mbar_wait(v_full, 0);
    reg_fence(oacc);
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk) {
      reg_fence(whi[kk]);
      reg_fence(wlo[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CT / 16; ++kk) {
      const uint64_t db = sw128_desc(vs + kk * 16 * ROW_BYTES, PANEL_BYTES);
      wgmma_rs(oacc, whi[kk], db);
      wgmma_rs(oacc, wlo[kk], db);
    }
    wgmma_commit();
    wgmma_wait0();
    reg_fence(oacc);

    // ---- h = O / max(|den|, exp(-m_t)), den = rowsum(W) + w_out q.n/sqrt(Dh)
    float dv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float r = rs[hr], x = qn[hr];
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const float den = r + wo[hr] * inv_sqrt_dh * x;
      dv[hr] = fmaxf(fabsf(den), expf(-mt[hr]));
      // the row statistics for the backward, m_t and den_t (the first value
      // tile's quad leaders write them)
      const int tr = r0 + 8 * hr;
      if (mstat != nullptr && jt == 0 && lane % 4 == 0 && tr < L) {
        const long long row = ((long long)b * S_stride + t0 + tr) * H + hh;
        mstat[row] = mt[hr];
        dstat[row] = den;
      }
    }
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int hr = (e / 2) % 2;
      const int tr = r0 + 8 * hr;
      const int j = j0 + 8 * (e / 4) + cq;
      if (tr < L && j < Dh)
        *reinterpret_cast<float2*>(
            hout + (((long long)b * S_stride + t0 + tr) * H + hh) * Dh + j) =
            make_float2(oacc[e] / dv[hr], oacc[e + 1] / dv[hr]);
    }
  }
}

// the row statistics from step s0 on (null stays null)
float* at_row(float* stat, int s0, int H) {
  return stat != nullptr ? stat + (long long)s0 * H : nullptr;
}

cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const float* ig, const float* fg, const float* C0,
                         const float* n0, const float* m0, void* ws,
                         float* h, float* C, float* n, float* m,
                         float* mstat, float* dstat, int B, int S, int H,
                         int Dh, float sqrt_dh, cudaStream_t st) {
  if (Dh % 8 != 0) return cudaErrorInvalidValue;  // TMA's 16-byte strides
  for (const void* p : {q, k, v, (const void*)ws})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  const int n_chunks = (S + CT - 1) / CT;
  const int Dp = pad_dh(Dh), nt = Dp / CTILE;
  const long long BH = (long long)B * H;
  const int seg = segment_chunks(BH, n_chunks, Dh);
  if (BH * seg * nt * 2 * nt > 0x7fffffffLL || BH * nt * nt > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const WsLayout w = ws_layout(BH, seg, Dh);
  uint8_t* base = static_cast<uint8_t*>(ws);
  double* gb = reinterpret_cast<double*>(base + w.b);
  float* gig = reinterpret_cast<float*>(base + w.ig);
  float* gmi = reinterpret_cast<float*>(base + w.mi);
  float* ggm = reinterpret_cast<float*>(base + w.gm);
  float* gch = reinterpret_cast<float*>(base + w.ch);
  float* sc = reinterpret_cast<float*>(base + w.s);
  float* n_ws = reinterpret_cast<float*>(base + w.n);
  void* cws = base + w.c;
  float* m_seg = reinterpret_cast<float*>(base + w.m);

  // the workspace tile by tile, so that every box is contiguous: per
  // ((b, h, chunk), value tile of 128, key panel of 64), hi then lo, each
  // 128 values x 64 keys; as (key, value, hi/lo, tile) for TMA
  CUtensorMap tws_st, tws_ld;
  const cuuint64_t wdims[4] = {PANEL, CTILE, 2,
                               (cuuint64_t)(BH * seg * nt * 2 * nt)};
  const cuuint64_t wstrides[3] = {PANEL * 2, PANEL * CTILE * 2,
                                  PANEL * CTILE * 2 * 2};
  const cuuint32_t st_box[4] = {PANEL, 64, 1, 1};
  const cuuint32_t ld_box[4] = {PANEL, CTILE, 1, 1};
  if (!make_bf16_map_4d(&tws_st, cws, wdims, wstrides, st_box) ||
      !make_bf16_map_4d(&tws_ld, cws, wdims, wstrides, ld_box))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_qk_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ScoresSmem<1>::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_states_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)StatesSmem::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_outputs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)OutputsSmem::bytes);
  if (err != cudaSuccess) return err;

  // Segment g covers chunks [c0, c0 + nc) and starts from the state the
  // last one left: C and n in the outputs, which each state-pass CTA reads
  // (its own tile, its own keys) before it overwrites them, and m in one
  // of two slots, since every CTA of a (b, h) reads m while one writes it.
  const float* C_in = C0;
  const float* n_in = n0;
  const float* m_in = m0;
  for (int c0 = 0, g = 0; c0 < n_chunks; c0 += seg, ++g) {
    const int nc = std::min(seg, n_chunks - c0);
    const int s0 = c0 * CT, Sg = std::min(nc * CT, S - s0);
    const long long off = (long long)s0 * H * Dh;   // elements of q, k, v, h
    float* m_out = c0 + nc >= n_chunks ? m : m_seg + (g % 2) * BH;
    // q, k, v of the segment, as (Dh, heads, steps, batch)
    CUtensorMap tq, tk, tv;
    const cuuint64_t row = (cuuint64_t)H * Dh * 2;   // bytes a step
    const cuuint64_t qdims[4] = {(cuuint64_t)Dh, (cuuint64_t)H,
                                 (cuuint64_t)Sg, (cuuint64_t)B};
    const cuuint64_t qstrides[3] = {(cuuint64_t)Dh * 2, row, row * S};
    const cuuint32_t qbox[4] = {PANEL, 1, CT, 1};
    if (!make_bf16_map_4d(&tq, static_cast<const uint8_t*>(q) + 2 * off,
                          qdims, qstrides, qbox) ||
        !make_bf16_map_4d(&tk, static_cast<const uint8_t*>(k) + 2 * off,
                          qdims, qstrides, qbox) ||
        !make_bf16_map_4d(&tv, static_cast<const uint8_t*>(v) + 2 * off,
                          qdims, qstrides, qbox))
      return cudaErrorInvalidValue;

    mlstm_gates_kernel<<<(int)(BH * nc), CT, 0, st>>>(
        ig + (long long)s0 * H, fg + (long long)s0 * H, gb, gig, gmi, ggm,
        gch, Sg, S, H, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlstm_qk_kernel<1><<<(int)(BH * nc), NTW, ScoresSmem<1>::bytes, st>>>(
        tq, tq, tk, sc, H, Dh, nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlstm_states_kernel<<<(int)(BH * nt * nt), NTW, StatesSmem::bytes, st>>>(
        tk, tv, tws_st, ggm, gch, C_in, n_in, m_in, n_ws, C, n, m_out, H, Dh,
        nc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlstm_outputs_kernel<<<(int)(BH * nc * nt), NTW, OutputsSmem::bytes,
                           st>>>(tq, tv, tws_ld, sc, gb, gig, gmi, gch, n_ws,
                                 m_in, h + off, at_row(mstat, s0, H),
                                 at_row(dstat, s0, H), Sg, S, H, Dh, nc,
                                 1.f / sqrt_dh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    C_in = C;
    n_in = n;
    m_in = m_out;
  }
  return cudaSuccess;
}

}  // namespace

// Routes: 0 scalar_f32, 1 scalar_bf16, 2 wgmma_bf16.

// Steps per chunk of a route (0 for an unknown route).
extern "C" int repro_mlstm_scan_chunk(int route) {
  return route == 2 ? CT : (route == 0 || route == 1) ? T : 0;
}

// Bytes of the workspace a call of the route needs: the raw scores
// (B*H, chunks, T, T) float32 on the scalar routes; gates, scores, and n
// and C^T at each chunk's entry on the wgmma route.
extern "C" long long repro_mlstm_scan_workspace_bytes(int B, int S, int H,
                                                      int Dh, int route) {
  if (route == 2) {
    const long long BH = (long long)B * H;
    return ws_layout(BH, segment_chunks(BH, (S + CT - 1) / CT, Dh), Dh).bytes;
  }
  return 4LL * B * H * ((S + T - 1) / T) * T * T;
}

// Dynamic shared memory of one block of a route's pass at Dh: on the
// scalar routes pass 0 is the state kernel (and *c_in_smem says whether its
// slab of C lives there); on the wgmma route passes 0, 1 and 2 are the
// q k^T, state and output passes.  -1 for an unknown route or pass.
extern "C" int repro_mlstm_scan_smem_bytes(int Dh, int route, int pass,
                                           int* c_in_smem) {
  *c_in_smem = 0;
  if (route == 2) {
    if (pass == 0) return (int)ScoresSmem<1>::bytes;
    if (pass == 1) return (int)StatesSmem::bytes;
    if (pass == 2) return (int)OutputsSmem::bytes;
    return -1;
  }
  if ((route != 0 && route != 1) || pass != 0) return -1;
  const long long with_c = sizeof(float) * state_smem_floats(Dh, true);
  *c_in_smem = with_c <= SMEM_LIMIT;
  return (int)(*c_in_smem ? with_c
                          : sizeof(float) * state_smem_floats(Dh, false));
}

// q, k, v: (B, S, H, Dh), float32 on route 0, bf16 on routes 1 and 2; ig,
// fg: (B, S, H) float32; C0 (B, H, Dh, Dh), n0 (B, H, Dh), m0 (B, H)
// float32, or all three null (zeros, zeros, -1e30); ws: the route's
// workspace (repro_mlstm_scan_workspace_bytes; 16-byte aligned on route 2);
// h: (B, S, H, Dh), C, n, m like C0, n0, m0, float32; mstat and dstat:
// (B, S, H) float32, or both null: for training, each row's stabiliser m_t
// and its denominator den_t before the clamp (h_t = num_t /
// max(|den_t|, exp(-m_t))).  All contiguous, on the current device; route
// 2 also needs q, k, v on 16-byte boundaries and Dh a multiple of 8.
// Launches the route's kernels on `stream` and returns cudaGetLastError()
// after them (0 on success), or the error that refused the call.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* ig, const void* fg,
                                const void* C0, const void* n0,
                                const void* m0, void* ws, void* h, void* C,
                                void* n, void* m, void* mstat, void* dstat,
                                int B, int S, int H, int Dh, int route,
                                float sqrt_dh, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0 ||
      (mstat == nullptr) != (dstat == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((C0 == nullptr) != (n0 == nullptr) || (C0 == nullptr) != (m0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_ig = static_cast<const float*>(ig);
  const float* f_fg = static_cast<const float*>(fg);
  const float* f_C0 = static_cast<const float*>(C0);
  const float* f_n0 = static_cast<const float*>(n0);
  const float* f_m0 = static_cast<const float*>(m0);
  float* f_h = static_cast<float*>(h);
  float* f_C = static_cast<float*>(C);
  float* f_n = static_cast<float*>(n);
  float* f_m = static_cast<float*>(m);
  float* f_ms = static_cast<float*>(mstat);
  float* f_ds = static_cast<float*>(dstat);
  switch (route) {
    case 0:
      return (int)launch<float>(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0,
                                static_cast<float*>(ws), f_h, f_C, f_n, f_m,
                                f_ms, f_ds, B, S, H, Dh, sqrt_dh, st);
    case 1:
      return (int)launch<__nv_bfloat16>(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0,
                                        static_cast<float*>(ws), f_h, f_C,
                                        f_n, f_m, f_ms, f_ds, B, S, H, Dh,
                                        sqrt_dh, st);
    case 2:
      return (int)launch_wgmma(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0, ws, f_h,
                               f_C, f_n, f_m, f_ms, f_ds, B, S, H, Dh,
                               sqrt_dh, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
