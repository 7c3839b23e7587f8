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
// The result does not depend on the chunk, so the kernel takes its own
// T = 64 for every S: the last chunk is masked (its padded rows enter
// neither the maxima nor the state update, and b_T is the cumsum at the
// last valid row), where the reference halves its chunk until it divides S
// (chunk 8 at S = 1000, 1 at a prime S) and the Pallas wrapper sends ragged
// S and `init_state` to the reference.  This kernel takes any B, S and H,
// any Dh up to 42,432 (its n and staging buffers fill the shared memory
// there) and an initial state (C0, n0, m0).
//
// What bounds it on the H100: operations.  Per (b, h) the inter-chunk
// products q C and (k g)^T v are 4 S Dh^2 flops and the intra-chunk q k^T and
// W v 4 S T Dh; at xlstm-1.3b's prefill (B 4, S 1000, H 4, Dh 1024) that is
// 71.3 GFLOP against 231 MB of q, k, v, h, C and gates.  Arithmetic is
// float32 throughout, on scalar FMAs (not TF32, which computes another
// function), so this first version runs far from the bf16 tensor-core
// bound that the repository's table states.
//
// Design.  The TPU kernel keeps the (Dh, Dh) state in VMEM across the
// sequential chunk axis of its grid.  At xlstm-1.3b's Dh = 1024 that state
// is 4 MiB per (b, h), 18 times an H100 SM's shared memory.  So the value
// columns of C are split across blocks, and the work is two launches:
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
// Past Dh = 1280 the slab no longer fits in shared memory; it then stays in
// the output C in device memory (each block still owns its own columns),
// which keeps every Dh running, through L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

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
constexpr float NEG_INF = -1e30f;    // the reference's initial m
constexpr int SE = T * IB / NT / 2;   // staged elements a thread loads at
                                      // once (two rounds per sub-block)
static_assert(RW == 8 && IB == NW * RW, "8 warps, 8 rows each");
static_assert(NT == 4 * T, "four threads per chunk row");
static_assert(2 * SE * NT == T * IB, "two rounds stage a sub-block");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// log(sigmoid(x)) as jax.nn.log_sigmoid computes it: -softplus(-x)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
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
                   float* __restrict__ mout, int S, int H, int Dh,
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
                         float* m, int grid, int S, int H, int Dh,
                         int n_chunks, int n_tiles, float sqrt_dh,
                         cudaStream_t st) {
  const size_t smem = sizeof(float) * state_smem_floats(Dh, SMEM_C);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_state_kernel<TQ, SMEM_C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_state_kernel<TQ, SMEM_C><<<grid, NT, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TQ*>(v), ig, fg, C0, n0, m0, scores, h, C, n, m, S,
      H, Dh, n_chunks, n_tiles, sqrt_dh);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ig, const float* fg, const float* C0,
                   const float* n0, const float* m0, float* scores, float* h,
                   float* C, float* n, float* m, int B, int S, int H, int Dh,
                   float sqrt_dh, cudaStream_t st) {
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
                                  n, m, grid, S, H, Dh, n_chunks, n_tiles,
                                  sqrt_dh, st);
  return launch_state<TQ, false>(q, k, v, ig, fg, C0, n0, m0, scores, h, C,
                                 n, m, grid, S, H, Dh, n_chunks, n_tiles,
                                 sqrt_dh, st);
}

}  // namespace

// Steps per chunk of the kernels.
extern "C" int repro_mlstm_scan_chunk() { return T; }

// Floats of the scores workspace the wrapper allocates: (B*H, chunks, T, T).
extern "C" long long repro_mlstm_scan_workspace_floats(int B, int S, int H) {
  return (long long)B * H * ((S + T - 1) / T) * T * T;
}

// Dynamic shared memory of one state block, and whether C stays in it.
extern "C" int repro_mlstm_scan_smem_bytes(int Dh, int* c_in_smem) {
  const long long with_c = sizeof(float) * state_smem_floats(Dh, true);
  *c_in_smem = with_c <= SMEM_LIMIT;
  return (int)(*c_in_smem ? with_c
                          : sizeof(float) * state_smem_floats(Dh, false));
}

// q, k, v: (B, S, H, Dh) of one dtype (0 float32, 1 bf16); ig, fg: (B, S, H)
// float32; C0 (B, H, Dh, Dh), n0 (B, H, Dh), m0 (B, H) float32, or all
// three null (zeros, zeros, -1e30); scores: the workspace; h: (B, S, H, Dh),
// C, n, m like C0, n0, m0, float32.  All contiguous, on the current device.
// Launches both kernels on `stream` and returns cudaGetLastError() after
// them (0 on success).
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const void* ig, const void* fg,
                                const void* C0, const void* n0,
                                const void* m0, void* scores, void* h,
                                void* C, void* n, void* m, int B, int S,
                                int H, int Dh, int dtype, float sqrt_dh,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Dh <= 0) return (int)cudaErrorInvalidValue;
  if ((C0 == nullptr) != (n0 == nullptr) || (C0 == nullptr) != (m0 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_ig = static_cast<const float*>(ig);
  const float* f_fg = static_cast<const float*>(fg);
  const float* f_C0 = static_cast<const float*>(C0);
  const float* f_n0 = static_cast<const float*>(n0);
  const float* f_m0 = static_cast<const float*>(m0);
  float* f_sc = static_cast<float*>(scores);
  float* f_h = static_cast<float*>(h);
  float* f_C = static_cast<float*>(C);
  float* f_n = static_cast<float*>(n);
  float* f_m = static_cast<float*>(m);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0, f_sc,
                              f_h, f_C, f_n, f_m, B, S, H, Dh, sqrt_dh, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, f_ig, f_fg, f_C0, f_n0, f_m0,
                                      f_sc, f_h, f_C, f_n, f_m, B, S, H, Dh,
                                      sqrt_dh, st);
  return (int)cudaErrorInvalidValue;
}
