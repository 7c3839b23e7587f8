// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `flash_attention_bhsd` in src/repro/kernels/flash_attention/kernel.py:
// blocked online-softmax attention with grouped KV heads, float32 running
// max / denominator / accumulator, scale 1/sqrt(Dh), a causal and/or
// sliding-window mask (q - k < window), output in the input dtype.  It
// computes what that kernel and the plain `layers.attention` compute; it is
// not a block-by-block transcription of the TPU grid.
//
// What bounds it on the H100: per (query, key) pair it does 4*Dh FLOPs
// while reading q, k, v and writing o once.  At the serving shapes
// (S ~ 1e3, Dh 64..256) the tensor-core bound (989 TFLOP/s bf16) and the
// memory bound (3.35 TB/s) are of the same order, tens of microseconds.
//
// Two routes, chosen by dtype in `repro_flash_attention_fwd` (a dispatch,
// not a fallback: a bf16 input the first route cannot take is refused):
//  * bf16: `flash_fwd_bf16`, S = Q K^T and O += P V on `wgmma`, tiles
//    brought into shared memory by TMA under mbarriers, the online softmax
//    in registers.  Tensor cores are the only way to the bf16 rate.
//  * float32: `flash_fwd_f32`, scalar float32 FMAs out of shared memory.
//    TF32 would keep ~3 decimal digits, and the float32 model's decode is
//    held against its forward at 1e-4 of the logits' scale through this
//    kernel, so float32 stays off the tensor cores.
//
// Common to both:
//  * One block per (q-tile, b*h).  The TPU grid's sequential k dimension is
//    a loop inside the block; the running (m, l, acc) state lives in
//    registers.  Query head h reads KV head h / (H / KH).  The last q-tiles
//    have the most keys under a causal mask and start first.
//  * q, k, v, o are read and written in their (B, S, heads, Dh) layout by
//    stride, so the wrapper transposes nothing.
//  * Only k-tiles that can hold an unmasked key are visited: up to the
//    q-tile's last row when causal, from q0 - window + 1 with a window.
//    Masked scores are -inf, and a row whose keys so far are all masked
//    keeps p = 0 and acc = 0, so no exp(0) garbage from a fully masked
//    tile ever enters the sum.
//  * Any S works: q rows and k columns past S are masked, and K/V rows
//    past S are loaded as zeros.  Dh is a template parameter: 64, 120, 128
//    and 256.
//  * When the caller passes an `lse` buffer (B, H, S) float32 (training:
//    the backward in flash_attention_bwd.cu reads it), each row's
//    log-sum-exp of its scaled scores, m + log(l) in natural-log units, is
//    written beside the output.  Serving passes null and writes nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

// Hopper primitives (inline PTX for wgmma, TMA, mbarriers) and the tensor-map
// encoder, shared with the other kernels
#include "../../csrc/hopper.cuh"

namespace {

// ------------------------------------------------------------------------
// float32 route: scalar FMAs
//
// Thread layout (64 query rows x 64 keys per tile): a row group of L lanes
// owns 4 rows; lane c of row group g owns rows 4g .. 4g+3, keys c + L*j and
// output columns c + L*n.  L is 8 up to Dh 128 (128 threads) and 16 at
// Dh 256 (256 threads), so a thread keeps 4 x Dh/L <= 64 accumulators in
// registers at every Dh.  The L lanes of a row group are neighbouring
// lanes of one warp, so row max and row sum are log2(L) xor-shuffles and
// the P tile is shared within the warp.  At Dh 256 the tiles take 213,760 B
// of shared memory, so one block runs per SM.
// ------------------------------------------------------------------------

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per k-tile
constexpr int RPT = 4;   // rows per thread

// Thread layout and shared-memory tiles (float32, rows padded where lanes
// read down a column) of one head dim.
template <int DH>
struct Tiles {
  static constexpr int LANES = DH > 128 ? 16 : 8;  // per row group
  static constexpr int NT = BQ / RPT * LANES;  // threads per block
  static constexpr int KPT = BK / LANES;  // keys per thread (stride LANES)
  static constexpr int NC = DH / LANES;   // output columns per thread
  static constexpr int QS = DH + 1;  // Q: lanes read 4 rows, same column
  static constexpr int KS = DH + 1;  // K: lanes read LANES rows, same column
  static constexpr int VS = DH;      // V: lanes read along a row
  static constexpr int PS = BK + 1;  // P: lanes read 4 rows, same column
  static constexpr size_t bytes =
      sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
};

// max (or sum) over the lanes of a row group, by xor-shuffles
template <int LANES, bool MAX>
__device__ __forceinline__ float group_reduce(float v) {
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : v + o;
  }
  return v;
}

template <int DH>
__global__ void __launch_bounds__(Tiles<DH>::NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int S, int H, int KH, int causal,
              int window, float scale) {
  using L = Tiles<DH>;
  constexpr int NT = L::NT, KPT = L::KPT, NC = L::NC, LN = L::LANES;
  static_assert(DH % LN == 0, "Dh must split over the lanes of a row group");
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::QS;
  float* Vs = Ks + BK * L::KS;
  float* Ps = Vs + BK * L::VS;

  const int tid = threadIdx.x;
  const int tr = tid / LN;  // row group
  const int tc = tid % LN;  // lane within the row group
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / KH);
  // the last q-tiles have the most keys under a causal mask: start them first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;

  const long long q_stride = (long long)H * DH;    // between positions
  const long long kv_stride = (long long)KH * DH;
  const float* qb = q + (long long)b * S * q_stride + (long long)h * DH;
  const float* kb = k + (long long)b * S * kv_stride + (long long)kh * DH;
  const float* vb = v + (long long)b * S * kv_stride + (long long)kh * DH;
  float* ob = o + (long long)b * S * q_stride + (long long)h * DH;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int s = q0 + r;
    Qs[r * L::QS + d] = s < S ? qb[s * q_stride + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][NC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  // k-tiles that can hold an unmasked key for some row of this q-tile
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int k_hi = causal ? min(S, q0 + BQ) : S;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile is consumed before it is replaced
    for (int i = tid; i < BK * DH; i += NT) {
      const int c = i / DH, d = i % DH;
      const int s = k0 + c;
      const bool in = s < S;
      Ks[c * L::KS + d] = in ? kb[s * kv_stride + d] : 0.f;
      Vs[c * L::VS + d] = in ? vb[s * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;

#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(tr * RPT + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(tc + LN * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qp = q0 + tr * RPT + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kp = k0 + tc + LN * j;
        const bool valid = kp < S && (!causal || kp <= qp) &&
                           (window <= 0 || qp - kp < window);
        sc[i][j] = valid ? sc[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = group_reduce<LN, true>(mx);
      const float m_new = fmaxf(m[i], mx);
      // all keys so far masked: keep p = 0 and acc = 0 (exp(-inf) = 0)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        sc[i][j] = expf(sc[i][j] - m_use);
        rs += sc[i][j];
      }
      rs = group_reduce<LN, false>(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        Ps[(tr * RPT + i) * L::PS + tc + LN * j] = sc[i][j];
    }
    __syncwarp();  // a row group's P rows are written and read in one warp

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT], vv[NC];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(tr * RPT + i) * L::PS + c];
#pragma unroll
      for (int n = 0; n < NC; ++n) vv[n] = Vs[c * L::VS + tc + LN * n];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pv[i], vv[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + tr * RPT + i;
    if (s < S) {
      // a row with no valid key (only past S) is never stored
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n)
        ob[s * q_stride + tc + LN * n] = acc[i][n] * inv;
      // every lane of the row group holds the row's m and l
      if (lse != nullptr && tc == 0)
        lse[((long long)b * H + h) * S + s] = m[i] + logf(l[i]);
    }
  }
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int S, int H, int KH, int causal,
                       int window, float scale, cudaStream_t stream) {
  const size_t smem = Tiles<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_f32<DH><<<grid, Tiles<DH>::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, H, KH,
      causal, window, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// bf16 route: the kernel
//
//  * One CTA per (BQ query rows, b*h): consumer warpgroups of 64 rows each
//    (three at Dh 64, two above) and one producer warpgroup, of which one
//    thread issues the TMA loads: Q once, then K and V tiles of BK keys
//    into a ring of STAGES stages, each stage with a full barrier for K,
//    one for V and an empty barrier that every consumer warp arrives on.
//    `setmaxnreg` moves registers from the producer (40, or 24 beside
//    three consumers) to the consumers (232, or 160).  The consumer
//    warpgroups overlap each other's products and softmax.
//  * Shared memory holds every tile as panels of 64 columns (128 bytes a
//    row, the widest the 128-byte swizzle takes), one TMA box each, with
//    the 128-byte swizzle that `wgmma` reads without bank conflicts.  Dh
//    120 is loaded as two 64-column boxes over a tensor map whose inner
//    extent is 120, so TMA fills columns 120-127 with zeros: they add
//    nothing to Q K^T and give zero output columns, which the store clips.
//  * S = Q K^T: `wgmma` m64nBKk16, A = Q and B = K both K-major.  Thread t
//    of warp w of a consumer holds rows 16w + t/4 and 16w + t/4 + 8 and
//    columns 8j + 2(t%4) + {0, 1} of S; row max and row sum are two
//    xor-shuffles within the quad.  scale*log2(e) is folded into exp2f.
//  * O += P V: P rounded to bf16 in registers, where S's accumulator
//    layout is already the A-operand layout; V is B, MN-major (its rows
//    are Dh-contiguous).  O stays float32 in registers.
//  * Grid (B*H, q-tiles): blocks start in the order of blockIdx.x first,
//    so the heaviest q-tile of every head starts before any lighter one.
//  * Epilogue: O / l rounded to bf16 (round to nearest even) into the
//    warpgroup's own Q rows in shared memory, then TMA stores, which clip
//    rows past S and columns past Dh.
//  * The tensor maps are 4-D over (Dh, heads, S, B), so TMA reads and
//    writes the (B, S, heads, Dh) layout by stride and fills rows past S
//    with zeros; their base addresses must be 16-byte aligned (checked by
//    the wrapper and again here).
//  * BK is 128 keys up to Dh 128 with three stages, and 64 at Dh 256 with
//    two, where a consumer thread already holds 128 float32 accumulators
//    of O and the tiles take 192 KiB of shared memory.  One CTA per SM.
//  * Within a warpgroup the tiles run in order: Q K^T, softmax, P V.
// ------------------------------------------------------------------------

constexpr int WG = 128;          // threads of a warpgroup

template <int DH>
struct WgTiles {
  static constexpr int DHP = (DH + PANEL - 1) / PANEL * PANEL;  // 120 -> 128
  static constexpr int NP = DHP / PANEL;      // panels of a row
  static constexpr int BKEYS = DHP > 128 ? 64 : 128;
  // warpgroups of 64 query rows: three at Dh 64, where a thread's tiles
  // fit in 160 registers, two above (tools/flash_variants.py times both)
  static constexpr int CONSUMERS = DHP == 64 ? 3 : 2;
  static constexpr int BQ = 64 * CONSUMERS;   // query rows per CTA
  static constexpr int STAGES = DHP > 128 ? 2 : 3;  // K/V tiles in the ring
  static constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 24;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
  static constexpr int Q_PANEL = BQ * ROW_BYTES;
  static constexpr int KV_PANEL = BKEYS * ROW_BYTES;
  static constexpr int Q_BYTES = NP * Q_PANEL;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K or V stage
  static constexpr int BAR_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int N_BARS = 1 + 3 * STAGES;
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  static constexpr size_t bytes = 1024 + BAR_OFFSET + 8 * N_BARS;
  static constexpr int NT = (CONSUMERS + 1) * WG;
};

template <int DH>
__global__ void __launch_bounds__(WgTiles<DH>::NT, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap to,
               float* __restrict__ lse, int S, int H, int KH, int causal,
               int window, float scale) {
  using T = WgTiles<DH>;
  constexpr int DHP = T::DHP, NP = T::NP, BKEYS = T::BKEYS;
  constexpr int STAGES = T::STAGES, CONSUMERS = T::CONSUMERS, BQ = T::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Qs = smem;
  uint8_t* Ks = Qs + T::Q_BYTES;
  uint8_t* Vs = Ks + STAGES * T::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFFSET);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kh = h / (H / KH);
  // the last q-tiles have the most keys under a causal mask: start them
  // first, for every head (blocks start in the order of blockIdx.x, then y)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  // k-tiles that can hold an unmasked key for some row of this q-tile
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BKEYS * BKEYS : 0;
  const int k_hi = causal ? min(S, q0 + BQ) : S;
  const int n_tiles = (k_hi - k_lo + BKEYS - 1) / BKEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int p = 0; p < NP; ++p)
        tma_load_4d(Qs + p * T::Q_PANEL, &tq, q_full, p * PANEL, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const int k0 = k_lo + it * BKEYS;
        // the consumers have released this stage's previous tile
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
    // consumer warpgroup `wg`: query rows row0 .. row0 + 63
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + wg * 64;
    const int my_row = row0 + warp * 16 + lane / 4;  // and my_row + 8
    const int my_col = 2 * (lane % 4);                // within each 8 columns
    const float scale_log2 = scale * 1.4426950408889634f;
    uint8_t* Qw = Qs + wg * 64 * ROW_BYTES;  // this warpgroup's Q rows

    float o[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of s * scale_log2
    float l[2] = {0.f, 0.f};  // this thread's part of the running sum
    float sc[BKEYS / 2];      // S of one tile, then its p
    uint32_t pf[BKEYS / 4];   // p in bf16, the A operand of P V
    float corr[2];

    // S = Q K^T of tile `it` into sc, issued and committed
    auto issue_qk = [&](int it) {
      const uint8_t* Kt = Ks + (it % STAGES) * T::KV_BYTES;
      mbar_wait(k_full + it % STAGES, (it / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const int off = (kk % 4) * 32;  // 16 columns = 32 bytes
        wgmma_ss(sc, sw128_desc(Qw + (kk / 4) * T::Q_PANEL + off, 16),
                 sw128_desc(Kt + (kk / 4) * T::KV_PANEL + off, 16), kk > 0);
      }
      wgmma_commit();
    };
    // masks tile `it`'s scores in sc and turns them into p, updating m and
    // l; corr is the factor by which O must be rescaled before P V
    auto softmax = [&](int it) {
      const int k0 = k_lo + it * BKEYS;
      // the tile crosses S, the causal diagonal or the window's edge
      const bool partial = k0 + BKEYS > S ||
                           (causal && k0 + BKEYS - 1 > row0) ||
                           (window > 0 && row0 + 63 - k0 >= window);
      if (partial) {
#pragma unroll
        for (int i = 0; i < BKEYS / 2; ++i) {
          const int qp = my_row + 8 * ((i / 2) % 2);
          const int kp = k0 + 8 * (i / 4) + my_col + i % 2;
          const bool valid = kp < S && (!causal || kp <= qp) &&
                             (window <= 0 || qp - kp < window);
          if (!valid) sc[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 2 * hr; i < BKEYS / 2; i += 4)
          mx = fmaxf(mx, fmaxf(sc[i], sc[i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx * scale_log2);
        // all keys so far masked: keep p = 0 and acc = 0 (exp2(-inf) = 0)
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[hr] = exp2f(m[hr] - m_use);
        float rs = 0.f;
#pragma unroll
        for (int i = 2 * hr; i < BKEYS / 2; i += 4) {
          sc[i] = exp2f(fmaf(sc[i], scale_log2, -m_use));
          sc[i + 1] = exp2f(fmaf(sc[i + 1], scale_log2, -m_use));
          rs += sc[i] + sc[i + 1];
        }
        l[hr] = l[hr] * corr[hr] + rs;
        m[hr] = m_new;
      }
    };
    // O += P V of tile `it`, issued and committed
    auto issue_pv = [&](int it) {
      const uint8_t* Vt = Vs + (it % STAGES) * T::KV_BYTES;
      mbar_wait(v_full + it % STAGES, (it / STAGES) & 1);
      reg_fence(o);
      reg_fence(pf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKEYS / 16; ++kk) {
        const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                               pf[4 * kk + 3]};
        wgmma_rs(o, a, sw128_desc(Vt + kk * 16 * ROW_BYTES, T::KV_PANEL));
      }
      wgmma_commit();
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) o[i] *= corr[(i / 2) % 2];
    };
    auto to_bf16 = [&]() {
#pragma unroll
      for (int i = 0; i < BKEYS / 4; ++i)
        pf[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };
    // this warp is done with tile `it`'s stage: it has seen both full
    // barriers of the round and its products have completed.  Every warp
    // arrives, so that no warp (in a tile a warpgroup skips, nothing ties
    // its warps together) can still be waiting on this round's full
    // barriers when the next round completes them again.
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + it % STAGES);
    };
    auto skip = [&](int it) {
      mbar_wait(k_full + it % STAGES, (it / STAGES) & 1);
      mbar_wait(v_full + it % STAGES, (it / STAGES) & 1);
      release(it);
    };

    // The tiles [it_lo, it_hi) hold a valid key for some row of this
    // warpgroup: before them a window keeps every key out of reach, after
    // them the causal mask.  The others are only waited for and released.
    int it_lo = 0, it_hi = row0 < S ? n_tiles : 0;
    if (causal) it_hi = min(it_hi, (row0 + 63 - k_lo) / BKEYS + 1);
    if (window > 0) it_lo = max(0, row0 - window + 1 - k_lo) / BKEYS;
    it_lo = min(it_lo, it_hi);

    mbar_wait(q_full, 0);
    for (int it = 0; it < it_lo; ++it) skip(it);
    for (int it = it_lo; it < it_hi; ++it) {
      issue_qk(it);
      wgmma_wait0();
      reg_fence(sc);
      softmax(it);
      rescale();
      to_bf16();
      issue_pv(it);
      wgmma_wait0();
      reg_fence(o);
      release(it);
    }
    for (int it = max(it_lo, it_hi); it < n_tiles; ++it) skip(it);

    if (row0 < S) {
      float inv[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float sum = l[hr];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        // a row with no valid key (only past S) is never stored
        inv[hr] = sum > 0.f ? 1.f / sum : 0.f;
        // m is in log2 units (scores times scale * log2(e))
        const int row = my_row + 8 * hr;
        if (lse != nullptr && lane % 4 == 0 && row < S)
          lse[((long long)b * H + h) * S + row] =
              m[hr] * 0.6931471805599453f + logf(sum);
      }
      // O in bf16 into this warpgroup's Q rows, in the swizzled layout the
      // tensor map stores from; the products that read Q have completed
#pragma unroll
      for (int i = 0; i < DHP / 2; i += 2) {
        const int hr = (i / 2) % 2;
        const int r = warp * 16 + lane / 4 + 8 * hr;  // row in the 64
        const int c = 8 * (i / 4) + my_col;
        const int cc = c % PANEL;
        uint8_t* dst = Qw + (c / PANEL) * T::Q_PANEL + r * ROW_BYTES +
                       (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(o[i] * inv[hr], o[i + 1] * inv[hr]);
      }
      fence_proxy_async();
      named_barrier(1 + wg, WG);
      if (t == 0) {
        for (int p = 0; p < NP; ++p)
          tma_store_4d(&to, Qw + p * T::Q_PANEL, p * PANEL, h, row0, b);
        tma_store_wait();
      }
    }
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int H, int KH, int causal,
                        int window, float scale, cudaStream_t stream) {
  using T = WgTiles<DH>;
  for (const void* p : {q, k, v, (const void*)o})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv, to;
  if (!make_bshd_map(&tq, q, B, S, H, DH, T::BQ) ||
      !make_bshd_map(&tk, k, B, S, KH, DH, T::BKEYS) ||
      !make_bshd_map(&tv, v, B, S, KH, DH, T::BKEYS) ||
      !make_bshd_map(&to, o, B, S, H, DH, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + T::BQ - 1) / T::BQ);
  flash_fwd_bf16<DH><<<grid, T::NT, T::bytes, stream>>>(
      tq, tk, tv, to, lse, S, H, KH, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block of a route requests (0: Dh unsupported).
// dtype: 0 float32 (scalar route), 1 bf16 (wgmma route).
extern "C" int repro_flash_attention_smem_bytes(int Dh, int dtype) {
  switch (Dh) {
    case 64: return (int)(dtype ? WgTiles<64>::bytes : Tiles<64>::bytes);
    case 120: return (int)(dtype ? WgTiles<120>::bytes : Tiles<120>::bytes);
    case 128: return (int)(dtype ? WgTiles<128>::bytes : Tiles<128>::bytes);
    case 256: return (int)(dtype ? WgTiles<256>::bytes : Tiles<256>::bytes);
    default: return 0;
  }
}

// q: (B, S, H, Dh), k and v: (B, S, KH, Dh), o: (B, S, H, Dh), all
// contiguous, on the current device; lse: null, or (B, H, S) float32 for
// each row's log-sum-exp.  dtype picks the route: 0 float32 (the scalar
// kernel), 1 bf16 (the wgmma kernel, which takes 16-byte aligned tensors
// only).  Launches on `stream` and returns cudaGetLastError() after the
// launch (0 on success), or the error that refused it.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int B, int S, int H, int KH, int Dh,
                                         int causal, int window, int dtype,
                                         float scale, void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H <= 0 || H % KH != 0 ||
      (long long)B * H > 65535 || window < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 64:
      return (int)(bf16 ? launch_bf16<64>(q, k, v, o, l, B, S, H, KH, causal,
                                          window, scale, st)
                        : launch_f32<64>(q, k, v, o, l, B, S, H, KH, causal,
                                         window, scale, st));
    case 120:
      return (int)(bf16 ? launch_bf16<120>(q, k, v, o, l, B, S, H, KH, causal,
                                           window, scale, st)
                        : launch_f32<120>(q, k, v, o, l, B, S, H, KH, causal,
                                          window, scale, st));
    case 128:
      return (int)(bf16 ? launch_bf16<128>(q, k, v, o, l, B, S, H, KH, causal,
                                           window, scale, st)
                        : launch_f32<128>(q, k, v, o, l, B, S, H, KH, causal,
                                          window, scale, st));
    case 256:
      return (int)(bf16 ? launch_bf16<256>(q, k, v, o, l, B, S, H, KH, causal,
                                           window, scale, st)
                        : launch_f32<256>(q, k, v, o, l, B, S, H, KH, causal,
                                          window, scale, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
