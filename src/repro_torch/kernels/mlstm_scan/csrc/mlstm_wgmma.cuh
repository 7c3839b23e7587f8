// The passes that the chunkwise mLSTM's wgmma_bf16 route shares between its
// forward (mlstm_scan.cu) and its backward (mlstm_scan_bwd.cu): the gate
// pass, the q k^T pass (templated on its A operands: q alone, or the bf16
// hi and lo halves of a float32 factor) and the state pass that stores C^T
// entering each chunk as bf16 hi and lo.  The route's design is described
// in mlstm_scan.cu; both sources include this header, each into its own
// translation unit (everything here has internal linkage).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "../../csrc/hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;    // the reference's initial m


// log(sigmoid(x)) as jax.nn.log_sigmoid computes it: -softplus(-x)
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

constexpr int CT = 128;               // steps per chunk
constexpr int CTILE = 128;            // rows and columns of a state tile
constexpr int WG = 128;               // threads of a warpgroup
constexpr int CONSUMERS = 2;          // consumer warpgroups of 64 rows
constexpr int NTW = (CONSUMERS + 1) * WG;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int PANEL_BYTES = CT * ROW_BYTES;   // 128 rows of a 64-column panel
static_assert(CT == CTILE && CT == 64 * CONSUMERS, "two warpgroups of 64");

__host__ __device__ inline long long up256(long long x) {
  return (x + 255) / 256 * 256;
}

// Dh rounded up to whole state tiles
__host__ __device__ inline int pad_dh(int Dh) { return round_up(Dh, CTILE); }

// Bytes of C^T entry states (bf16 hi and lo) that one segment of the
// sequence keeps in the workspace: the passes walk S in segments of as many
// chunks as fit (at least one), each starting from the state the last one
// left, so the workspace does not grow with S.  At xlstm-1.3b's prefill
// (B*H 16, Dh 1024: 64 MiB a chunk) a segment holds 16 chunks, 2048 steps.
constexpr long long STATE_BUDGET = 1LL << 30;

// chunks of one segment
__host__ inline int segment_chunks(long long BH, int n_chunks, int Dh) {
  const long long per_chunk = 4LL * BH * pad_dh(Dh) * pad_dh(Dh);
  return (int)std::max(1LL, std::min((long long)n_chunks,
                                     STATE_BUDGET / per_chunk));
}

// Dynamic shared memory of the state pass: two stages of k and v tiles (two
// panels each), the staging of the stored tile (warpgroup, hi/lo, panel of
// 64 rows), g of two chunks, barriers.
struct StatesSmem {
  static constexpr int STAGES = 2;
  static constexpr int STAGE_BYTES = 4 * PANEL_BYTES;
  static constexpr int STG_PANEL = 64 * ROW_BYTES;
  static constexpr int STG_WG = 2 * 2 * STG_PANEL;
  static constexpr int G_OFFSET = STAGES * STAGE_BYTES + CONSUMERS * STG_WG;
  static constexpr int BAR_OFFSET = G_OFFSET + 2 * CT * 4;
  static constexpr int N_BARS = 2 * STAGES;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
};

// Dynamic shared memory of the q k^T pass: three stages of (A..., B)
// panels (NA A operands), barriers.
template <int NA>
struct ScoresSmem {
  static constexpr int STAGES = 3;
  static constexpr int STAGE_BYTES = (NA + 1) * PANEL_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int N_BARS = 2 * STAGES;
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
};

// byte offset of bf16 element (row, col) in a 64-column panel with the
// 128-byte swizzle, as TMA writes it (the panel 1024-byte aligned)
__device__ __forceinline__ int sw_off(int row, int col) {
  return row * ROW_BYTES + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ float ld_bf16(const uint8_t* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// (x0, x1) split into bf16 halves: hi = bf16(x), lo = bf16(x - hi), each
// packed as the two elements of one A-fragment register
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(hf.x, hf.y);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// m entering chunk c of (b, h): the chain of m_new over the chunks before
__device__ __forceinline__ float entry_m(const float* __restrict__ gch,
                                         long long bh, int c, int n_chunks,
                                         float m0) {
  float m = m0;
  for (int cc = 0; cc < c; ++cc) {
    const float* ch = gch + 2 * (bh * n_chunks + cc);
    m = fmaxf(ch[0] + m, ch[1]);
  }
  return m;
}

// zero `bytes` (a multiple of 16) of shared memory with all threads
__device__ __forceinline__ void zero_smem(uint8_t* p, int bytes) {
  for (int o = threadIdx.x * 16; o < bytes; o += blockDim.x * 16)
    *reinterpret_cast<uint4*>(p + o) = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// Pass 1: the chunk's gates
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CT)
mlstm_gates_kernel(const float* __restrict__ ig, const float* __restrict__ fg,
                   double* __restrict__ gb, float* __restrict__ gig,
                   float* __restrict__ gmi, float* __restrict__ ggm,
                   float* __restrict__ gch, int S, int S_stride, int H,
                   int n_chunks) {
  __shared__ double sb[CT];
  __shared__ float sig[CT];
  __shared__ double wsum[CT / 32];
  __shared__ float wmax[CT / 32];
  const long long bh = blockIdx.x / n_chunks;
  const int c = blockIdx.x % n_chunks;
  const long long b = bh / H;
  const int hh = (int)(bh % H);
  const int t0 = c * CT, L = min(CT, S - t0);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const long long gi = (b * S_stride + t0 + t) * H + hh;
  const float lf = t < L ? log_sigmoid(fg[gi]) : 0.f;
  const float igv = t < L ? ig[gi] : 0.f;
  // inclusive cumsum of lf in float64: within the warp, then the warps
  // before (past L, lf = 0 and b stays at b_T)
  double x = lf;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += wsum[w];
  sb[t] = x;
  sig[t] = igv;
  __syncthreads();
  const double bTd = sb[L - 1];
  float mi = -INFINITY;
  if (t < L)
    for (int s = 0; s <= t; ++s) mi = fmaxf(mi, (float)(x - sb[s]) + sig[s]);
  const float gm = t < L ? igv + (float)(bTd - x) : -INFINITY;
  float mx = gm;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  const long long r = (long long)blockIdx.x * CT + t;
  gb[r] = x;
  gig[r] = igv;
  gmi[r] = mi;
  ggm[r] = gm;
  if (t == 0) {
    float m = wmax[0];
    for (int w = 1; w < CT / 32; ++w) m = fmaxf(m, wmax[w]);
    gch[2LL * blockIdx.x] = (float)bTd;
    gch[2LL * blockIdx.x + 1] = m;
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the raw scores q k^T of each chunk (NA = 1: A = q from tq, B = k
// from tk).  The backward also runs it with NA = 2 for dnum v^T: A the bf16
// hi and lo halves of dnum (tq, tq2), B = v, two products a panel.
// ---------------------------------------------------------------------------
template <int NA>
__global__ void __launch_bounds__(NTW, 1)
mlstm_qk_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tq2,
                const __grid_constant__ CUtensorMap tk,
                float* __restrict__ scores, int H, int Dh, int n_chunks) {
  static_assert(NA == 1 || NA == 2, "one or two A operands");
  using M = ScoresSmem<NA>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M::BAR_OFFSET);
  uint64_t* empty = full + M::STAGES;
  const long long slab = blockIdx.x;
  const int b = (int)(slab / n_chunks / H), hh = (int)(slab / n_chunks % H);
  const int t0 = (int)(slab % n_chunks) * CT;
  const int np = (Dh + PANEL - 1) / PANEL;   // 64-key panels of q and k
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < M::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      for (int p = 0; p < np; ++p) {
        const int s = p % M::STAGES;
        uint8_t* st = smem + s * M::STAGE_BYTES;
        mbar_wait(empty + s, ((p / M::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, (NA + 1) * PANEL_BYTES);
        tma_load_4d(st, &tq, full + s, p * PANEL, hh, t0, b);
        if (NA == 2)
          tma_load_4d(st + PANEL_BYTES, &tq2, full + s, p * PANEL, hh, t0, b);
        tma_load_4d(st + NA * PANEL_BYTES, &tk, full + s, p * PANEL, hh, t0,
                    b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;
    const int r0 = 64 * wg + 16 * warp + lane / 4;
    const int cq = 2 * (lane % 4);
    // The tensor cores' float32 accumulation truncates: over all Dh keys at
    // once it is several times less accurate than float32 FMAs, which shows
    // in h wherever the denominator cancels.  So each 64-key panel starts a
    // fresh accumulator, and the panels are summed in float32.
    float sacc[64], spart[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) sacc[e] = 0.f;
    for (int p = 0; p < np; ++p) {
      const int s = p % M::STAGES;
      const uint8_t* st = smem + s * M::STAGE_BYTES;
      const uint8_t* Qw = st + wg * 64 * ROW_BYTES;   // this warpgroup's rows
      mbar_wait(full + s, (p / M::STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const int off = kk * 32;   // 16 columns = 32 bytes
        wgmma_ss(spart, sw128_desc(Qw + off, 16),
                 sw128_desc(st + NA * PANEL_BYTES + off, 16), kk > 0);
      }
      if (NA == 2) {
#pragma unroll
        for (int kk = 0; kk < PANEL / 16; ++kk) {
          const int off = kk * 32;
          wgmma_ss(spart, sw128_desc(Qw + PANEL_BYTES + off, 16),
                   sw128_desc(st + NA * PANEL_BYTES + off, 16), 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(spart);
#pragma unroll
      for (int e = 0; e < 64; ++e) sacc[e] += spart[e];
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    // scores[slab][t][s] at t = r0 + 8 ((e/2) % 2), s = 8 (e/4) + cq + e % 2
    float* out = scores + slab * CT * CT;
#pragma unroll
    for (int e = 0; e < 64; e += 2)
      *reinterpret_cast<float2*>(out + (r0 + 8 * ((e / 2) % 2)) * CT +
                                 8 * (e / 4) + cq) =
          make_float2(sacc[e], sacc[e + 1]);
  }
}

// ---------------------------------------------------------------------------
// Pass 3: the state entering each chunk, one 128 x 128 tile of C^T a CTA
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NTW, 1)
mlstm_states_kernel(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tws,
                    const float* __restrict__ ggm,
                    const float* __restrict__ gch,
                    const float* __restrict__ C0,
                    const float* __restrict__ n0,
                    const float* __restrict__ m0, float* __restrict__ n_ws,
                    float* __restrict__ Cout, float* __restrict__ nout,
                    float* __restrict__ mout, int H, int Dh, int n_chunks) {
  using M = StatesSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* stages = smem;
  uint8_t* stg = smem + M::STAGES * M::STAGE_BYTES;
  float* gsm = reinterpret_cast<float*>(smem + M::G_OFFSET);
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
    for (int p = npi; p < 2; ++p)
      zero_smem(stages + s * M::STAGE_BYTES + p * PANEL_BYTES, PANEL_BYTES);
    for (int p = npj; p < 2; ++p)
      zero_smem(stages + s * M::STAGE_BYTES + (2 + p) * PANEL_BYTES,
                PANEL_BYTES);
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
    // producer: one thread keeps the k and v tiles of the next chunks coming
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % M::STAGES;
        uint8_t* st = stages + s * M::STAGE_BYTES;
        mbar_wait(empty + s, ((c / M::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, (npi + npj) * PANEL_BYTES);
        for (int p = 0; p < npi; ++p)
          tma_load_4d(st + p * PANEL_BYTES, &tk, full + s, i0 + p * PANEL, hh,
                      c * CT, b);
        for (int p = 0; p < npj; ++p)
          tma_load_4d(st + (2 + p) * PANEL_BYTES, &tv, full + s,
                      j0 + p * PANEL, hh, c * CT, b);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const int t = threadIdx.x % WG, ct = threadIdx.x;
    const int warp = t / 32, lane = t % 32;
    const int rw = 16 * warp + lane / 4;   // row of acc[0] within the 64
    const int cq = 2 * (lane % 4);         // column within each 8
    const long long DD = (long long)Dh * Dh;
    // acc[e]: C^T[j][i] at j = j0 + 64 wg + rw + 8 ((e/2) % 2),
    // i = i0 + 8 (e/4) + cq + e % 2
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int j = j0 + 64 * wg + rw + 8 * ((e / 2) % 2);
      const int i = i0 + 8 * (e / 4) + cq + e % 2;
      acc[e] = (C0 != nullptr && i < Dh && j < Dh)
                   ? C0[bh * DD + (long long)i * Dh + j]
                   : 0.f;
    }
    // n of key i0 + ni (first value tile only): two threads a key, each
    // summing half of the chunk's steps
    const int ni = ct / 2, nh = ct % 2;
    float nreg = (jt == 0 && n0 != nullptr && i0 + ni < Dh)
                     ? n0[bh * Dh + i0 + ni] : 0.f;
    float m_prev = m0 != nullptr ? m0[bh] : NEG_INF;
    uint8_t* my_stg = stg + wg * M::STG_WG;   // [hi/lo][panel][64 rows]

    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % M::STAGES;
      const long long slab = bh * n_chunks + c;
      // the chunk's gates, loaded first: their latency passes under the
      // staging of the tile
      const float bT = gch[2 * slab], lmax = gch[2 * slab + 1];
      const float gm = ct < CT ? ggm[slab * CT + ct] : 0.f;
      // ---- the tile entering chunk c, as bf16 hi and lo, to the workspace
      // (not the zero state entering chunk 0, which the output pass skips)
      const bool store_entry = c > 0 || C0 != nullptr;
      if (store_entry) {
        if (t == 0) tma_store_wait();   // the last stores have read staging
        named_barrier(1 + wg, WG);
#pragma unroll
        for (int e = 0; e < 64; e += 2) {
          const int row = rw + 8 * ((e / 2) % 2);
          const int col = 8 * (e / 4) + cq;
          uint32_t hi, lo;
          split_bf16(acc[e], acc[e + 1], hi, lo);
          const int off =
              (col / PANEL) * M::STG_PANEL + sw_off(row, col % PANEL);
          *reinterpret_cast<uint32_t*>(my_stg + off) = hi;
          *reinterpret_cast<uint32_t*>(my_stg + 2 * M::STG_PANEL + off) = lo;
        }
        fence_proxy_async();
        named_barrier(1 + wg, WG);
        if (t == 0)
          for (int hl = 0; hl < 2; ++hl)
            for (int p = 0; p < 2; ++p)
              tma_store_4d(&tws, my_stg + (2 * hl + p) * M::STG_PANEL, 0,
                           64 * wg, hl,
                           (int)((slab * nt + jt) * 2 * nt + 2 * it + p));
      }
      if (jt == 0 && nh == 0) n_ws[slab * Dp + i0 + ni] = nreg;

      // ---- gates of the chunk
      const float m_new = fmaxf(bT + m_prev, lmax);
      const float f_c = expf((bT + m_prev) - m_new);
      float* g = gsm + (c & 1) * CT;   // two chunks' g: one barrier a chunk
      if (ct < CT) g[ct] = expf(gm - m_new);
      named_barrier(3, CONSUMERS * WG);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] *= f_c;

      // ---- C^T += (g o v)^T k in two passes, hi and lo
      mbar_wait(full + s, (c / M::STAGES) & 1);
      const uint8_t* kt = stages + s * M::STAGE_BYTES;
      const uint8_t* vt = kt + 2 * PANEL_BYTES;
      uint32_t ahi[CT / 16][4], alo[CT / 16][4];
#pragma unroll
      for (int kk = 0; kk < CT / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 64 * wg + rw + 8 * (r % 2);   // value column
          const int sx = 16 * kk + 8 * (r / 2) + cq;  // step
          const uint8_t* vp = vt + (j / PANEL) * PANEL_BYTES;
          split_bf16(g[sx] * ld_bf16(vp + sw_off(sx, j % PANEL)),
                     g[sx + 1] * ld_bf16(vp + sw_off(sx + 1, j % PANEL)),
                     ahi[kk][r], alo[kk][r]);
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
        const uint64_t db = sw128_desc(kt + kk * 16 * ROW_BYTES, PANEL_BYTES);
        wgmma_rs(acc, ahi[kk], db);
        wgmma_rs(acc, alo[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);

      // ---- n = f_c n + sum_s g_s k_s
      if (jt == 0) {
        const uint8_t* kp = kt + (ni / PANEL) * PANEL_BYTES;
        float sum = 0.f;
        for (int u = 0; u < CT / 2; ++u) {
          const int sx = nh * (CT / 2) + u;
          sum = fmaf(g[sx], ld_bf16(kp + sw_off(sx, ni % PANEL)), sum);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        nreg = f_c * nreg + sum;
      }
      // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      m_prev = m_new;
    }
    if (t == 0) tma_store_wait();

    // ---- the final state: C in its (i, j) layout, n, m
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const int j = j0 + 64 * wg + rw + 8 * ((e / 2) % 2);
      const int i = i0 + 8 * (e / 4) + cq + e % 2;
      if (i < Dh && j < Dh) Cout[bh * DD + (long long)i * Dh + j] = acc[e];
    }
    if (jt == 0 && nh == 0 && i0 + ni < Dh) nout[bh * Dh + i0 + ni] = nreg;
    if (jt == 0 && it == 0 && ct == 0) mout[bh] = m_prev;
  }
}

}  // namespace
