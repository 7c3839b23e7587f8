// Backward of the grouped expert FFN (moe_gmm.cu) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// The TPU kernel it differentiates, `_ffn_kernel` launched by
// `expert_ffn_pallas` in src/repro/kernels/moe_gmm/kernel.py, has no
// backward of its own: the reference differentiates its plain einsums.  For
// every expert e, over its live rows (the first counts[e]; all without
// counts), with y = h w2 and h = act(a1) * a3, a1 = x w1, a3 = x w3:
//
//     dh  = dy w2^T
//     da1 = dh * a3 * act'(a1),  da3 = dh * act(a1)   (no w3: da1 = dh act')
//     dw2 = h^T dy,  dw1 = x^T da1,  dw3 = x^T da3
//     dx  = da1 w1^T + da3 w3^T
//
// Pad rows (at or past counts[e]) are constants 0 in the forward, whatever
// x holds there: dx is exactly 0 on them and they add nothing to any weight
// gradient, even where x or dy holds NaN.  An expert with no live row gets
// zero weight gradients.  Products accumulate in float32 and every output
// is written in the input dtype; the weight gradients are summed over the
// rows in one fixed order (no atomics), so a call is deterministic.
//
// What bounds it on the H100: eight products of 2 * rows * d * f FLOPs
// each (six, plus a1 and a3 recomputed) against x, dy, dx over the live
// rows and the weights and their gradients once.  At granite-moe's train
// shape (E 40, C 1024, d 1536, f 512, 32768 live rows, bf16) that is 412
// GFLOP against ~0.7 GB: the tensor cores bound it, 0.31 ms for the six
// products the function needs (cost.bwd_work), 0.42 ms for all eight.
//
// Design: three passes through (E, C, f) workspaces in HBM, since a
// (rows x d) float32 dx tile or a (d x f) weight tile does not stay in an
// SM beside the products that feed it:
//  (a) up: per tile of rows x f columns, x and dy staged once a depth
//      panel, three products a1 = x w1, a3 = x w3, dh = dy w2^T; the
//      epilogue forms h, da1 and da3 in registers and writes them rounded
//      to the input dtype (as the forward rounds h), 0 on pad rows;
//  (b) dx: per tile of rows x d columns, [da1 | da3] [w1^T; w3^T] (depth
//      2f), 0 on pad rows;
//  (c) weights: per tile of dw1 and dw3 (d x f; x^T shared) and, in a
//      second launch, of dw2 (f x d), the depth the expert's live rows.
// Routes, chosen by the caller (ops.kernel_route, the forward's):
//  * wgmma_bf16: `wgmma` on TMA-fed, 128-byte-swizzled panels, a producer
//    thread and two consumer warpgroups, persistent CTAs (the forward's
//    machinery).  (a) reads x and dy as K-major A, w1 and w3 as MN-major B
//    and w2 (f x d) as a K-major B; (b) reads w1 and w3 (d x f) as K-major
//    B; (c) reads x and h as MN-major A (`wgmma_tt`, A transposed) and
//    da1, da3, dy as MN-major B.  Pads: (a) and (b) skip tiles whose rows
//    are all pads ((b) writes their zeros); in (c) the depth stops at the
//    last live panel and the rows past the fill inside it are zeroed in
//    shared memory before the products (TMA zero-fills only past the
//    tensor's end, and 0 * NaN is NaN).
//  * scalar_f32 and wmma_bf16 (float32, and bf16 that TMA cannot address):
//    the same three passes on scalar FMAs with float32 accumulators, 64 x
//    64 tiles; pad rows are never loaded.
#include "moe_gmm.cuh"

namespace {

// ------------------------------------------------------------------------
// scalar route (float32 or bf16 storage, float32 arithmetic)
// ------------------------------------------------------------------------

constexpr int SBM = 64;   // rows per block
constexpr int SBN = 64;   // output columns per block
constexpr int SBK = 32;   // depth per shared-memory stage
constexpr int SNT = 256;  // threads: 16 x 16, each 4 x 4 outputs
constexpr int SAS = SBM + 4;

// One operand pair of a product over experts: A (M x K) element (m, k) of
// expert e at a[e * ae + m * sam + k * sak], B (K x N) element (k, n) at
// b[e * be + k * sbk + n * sbn].
template <typename T>
struct Pair {
  const T* a;
  const T* b;
  long long ae, sam, sak, be, sbk, sbn;
};

// As[k][m] <- A's (SBM x SBK) tile at (m0, k0), zeros at m >= mlim or
// k >= klim; neighbouring threads read neighbouring addresses
template <typename T>
__device__ __forceinline__ void load_a(float (*As)[SAS], const T* a,
                                       long long sam, long long sak, int m0,
                                       int k0, int mlim, int klim) {
  const bool k_inner = sak == 1;
#pragma unroll
  for (int t = 0; t < SBM * SBK / SNT; ++t) {
    const int i = threadIdx.x + t * SNT;
    const int r = k_inner ? i / SBK : i % SBM;
    const int c = k_inner ? i % SBK : i / SBM;
    const int m = m0 + r, k = k0 + c;
    As[c][r] = (m < mlim && k < klim) ? to_f32(a[m * sam + k * sak]) : 0.f;
  }
}

// Bs[k][n] <- B's (SBK x SBN) tile at (k0, n0), zeros at k >= klim or
// n >= nlim
template <typename T>
__device__ __forceinline__ void load_b(float (*Bs)[SBN], const T* b,
                                       long long sbk, long long sbn, int k0,
                                       int n0, int klim, int nlim) {
  const bool n_inner = sbn == 1;
#pragma unroll
  for (int t = 0; t < SBK * SBN / SNT; ++t) {
    const int i = threadIdx.x + t * SNT;
    const int r = n_inner ? i / SBN : i % SBK;
    const int c = n_inner ? i % SBN : i / SBK;
    const int k = k0 + r, n = n0 + c;
    Bs[r][c] = (k < klim && n < nlim) ? to_f32(b[k * sbk + n * sbn]) : 0.f;
  }
}

// acc[i][j] += sum over the stage of As[k][ty*4 + i] Bs[k][tx*4 + j]
__device__ __forceinline__ void fma_tile(float (&acc)[4][4],
                                         const float (*As)[SAS],
                                         const float (*Bs)[SBN], int ty,
                                         int tx) {
#pragma unroll 8
  for (int kk = 0; kk < SBK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Pass (a) on a (SBM rows x SBN f-columns) tile of expert blockIdx.z: h,
// da1 (and da3) into (E, C, f) workspaces; rows past the fill are written
// as 0, a tile of pads only is skipped (no later pass reads it).
template <typename T, bool GATED>
__global__ void __launch_bounds__(SNT)
gmm_bwd_up_scalar(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ w3, const T* __restrict__ w2,
              const T* __restrict__ dy, T* __restrict__ h,
              T* __restrict__ da1, T* __restrict__ da3,
              const int* __restrict__ counts, int C, int d, int f, int act) {
  __shared__ __align__(16) float Xs[SBK][SAS];
  __shared__ __align__(16) float Ys[SBK][SAS];
  __shared__ __align__(16) float W1s[SBK][SBN];
  __shared__ __align__(16) float W3s[GATED ? SBK : 1][SBN];
  __shared__ __align__(16) float W2s[SBK][SBN];

  const long long e = blockIdx.z;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int live = live_rows(counts, e, C);
  if (m0 >= live) return;
  x += e * C * d;
  dy += e * C * d;
  w1 += e * d * f;
  if constexpr (GATED) w3 += e * d * f;
  w2 += e * f * d;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float a1[4][4] = {}, a3[4][4] = {}, dh[4][4] = {};

  for (int k0 = 0; k0 < d; k0 += SBK) {
    load_a(Xs, x, d, 1, m0, k0, live, d);
    load_a(Ys, dy, d, 1, m0, k0, live, d);
    load_b(W1s, w1, f, 1, k0, n0, d, f);
    if constexpr (GATED) load_b(W3s, w3, f, 1, k0, n0, d, f);
    load_b(W2s, w2, 1, d, k0, n0, d, f);  // w2^T: (k, n) at w2[n d + k]
    __syncthreads();
    if (m0 + ty * 4 < live) {
      fma_tile(a1, Xs, W1s, ty, tx);
      if constexpr (GATED) fma_tile(a3, Xs, W3s, ty, tx);
      fma_tile(dh, Ys, W2s, ty, tx);
    }
    __syncthreads();
  }

  const long long base = e * C * f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= f) continue;
      const float g = activate(act, a1[i][j]);
      const float gd = act_grad(act, a1[i][j]);
      float hv = g, d1 = dh[i][j] * gd, d3 = 0.f;
      if constexpr (GATED) {
        hv = g * a3[i][j];
        d1 *= a3[i][j];
        d3 = dh[i][j] * g;
      }
      const bool pad = m >= live;
      const long long o = base + (long long)m * f + n;
      h[o] = from_f32<T>(pad ? 0.f : hv);
      da1[o] = from_f32<T>(pad ? 0.f : d1);
      if constexpr (GATED) da3[o] = from_f32<T>(pad ? 0.f : d3);
    }
  }
}

// Passes (b) and (c): out (M x N of expert blockIdx.z, row-major, in T) =
// A_0 B_0 (+ A_1 B_1), each K deep.  PAD_ROWS (dx): rows m past the fill
// are pads, not computed and written as 0.  Otherwise (weights) the depth
// runs over the live rows only.
template <typename T, bool TWO, bool PAD_ROWS>
__global__ void __launch_bounds__(SNT)
gmm_bwd_scalar(Pair<T> p0, Pair<T> p1, T* __restrict__ out,
               const int* __restrict__ counts, int C, int M, int N, int K) {
  __shared__ __align__(16) float As[SBK][SAS];
  __shared__ __align__(16) float Bs[SBK][SBN];

  const long long e = blockIdx.z;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int live = live_rows(counts, e, C);
  const int mlim = PAD_ROWS ? live : M, klim = PAD_ROWS ? K : live;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][4] = {};

  for (int q = 0; q < (TWO ? 2 : 1); ++q) {
    const Pair<T>& p = q == 0 ? p0 : p1;
    const T* a = p.a + e * p.ae;
    const T* b = p.b + e * p.be;
    for (int k0 = 0; m0 < mlim && k0 < klim; k0 += SBK) {
      load_a(As, a, p.sam, p.sak, m0, k0, mlim, klim);
      load_b(Bs, b, p.sbk, p.sbn, k0, n0, klim, N);
      __syncthreads();
      if (m0 + ty * 4 < mlim) fma_tile(acc, As, Bs, ty, tx);
      __syncthreads();
    }
  }

  out += e * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N)
        out[(long long)m * N + n] = from_f32<T>(m < mlim ? acc[i][j] : 0.f);
    }
  }
}

dim3 grid_of(int M, int N, int E) {
  return dim3((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, E);
}

template <typename T>
cudaError_t run_scalar(const void* xe, const void* w1v, const void* w3v,
                       const void* w2v, const void* dyv, void* dxv,
                       void* dw1v, void* dw3v, void* dw2v, void* ws,
                       const int* counts, int E, int C, int d, int f,
                       int act, cudaStream_t st) {
  const T* x = static_cast<const T*>(xe);
  const T* w1 = static_cast<const T*>(w1v);
  const T* w3 = static_cast<const T*>(w3v);
  const T* w2 = static_cast<const T*>(w2v);
  const T* dy = static_cast<const T*>(dyv);
  const long long ecf = (long long)E * C * f;
  T* h = static_cast<T*>(ws);
  T* da1 = h + ecf;
  T* da3 = w3 != nullptr ? da1 + ecf : nullptr;
  const long long cd = (long long)C * d, cf = (long long)C * f,
                  df = (long long)d * f;

  if (w3 != nullptr)
    gmm_bwd_up_scalar<T, true><<<grid_of(C, f, E), SNT, 0, st>>>(
        x, w1, w3, w2, dy, h, da1, da3, counts, C, d, f, act);
  else
    gmm_bwd_up_scalar<T, false><<<grid_of(C, f, E), SNT, 0, st>>>(
        x, w1, nullptr, w2, dy, h, da1, nullptr, counts, C, d, f, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // dx = da1 w1^T (+ da3 w3^T): w^T (k, n) at w[n f + k]
  const Pair<T> dx1{da1, w1, cf, f, 1, df, 1, f};
  if (w3 != nullptr) {
    const Pair<T> dx3{da3, w3, cf, f, 1, df, 1, f};
    gmm_bwd_scalar<T, true, true><<<grid_of(C, d, E), SNT, 0, st>>>(
        dx1, dx3, static_cast<T*>(dxv), counts, C, C, d, f);
  } else {
    gmm_bwd_scalar<T, false, true><<<grid_of(C, d, E), SNT, 0, st>>>(
        dx1, dx1, static_cast<T*>(dxv), counts, C, C, d, f);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // dw1 = x^T da1, dw3 = x^T da3: x^T (m, k) at x[k d + m]
  const Pair<T> g1{x, da1, cd, 1, d, cf, f, 1};
  gmm_bwd_scalar<T, false, false><<<grid_of(d, f, E), SNT, 0, st>>>(
      g1, g1, static_cast<T*>(dw1v), counts, C, d, f, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (w3 != nullptr) {
    const Pair<T> g3{x, da3, cd, 1, d, cf, f, 1};
    gmm_bwd_scalar<T, false, false><<<grid_of(d, f, E), SNT, 0, st>>>(
        g3, g3, static_cast<T*>(dw3v), counts, C, d, f, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // dw2 = h^T dy
  const Pair<T> g2{h, dy, cf, 1, f, cd, d, 1};
  gmm_bwd_scalar<T, false, false><<<grid_of(f, d, E), SNT, 0, st>>>(
      g2, g2, static_cast<T*>(dw2v), counts, C, f, d, C);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// wgmma_bf16 route
//
// Each pass is one persistent kernel of a producer thread (in a third
// warpgroup) and two consumer warpgroups of 64 output rows each, over a
// ring of stages that the producer fills by TMA (64 x 64 panels, 128-byte
// swizzled) and the consumers release warp by warp, stages counted across
// tiles as in moe_gmm.cu's `gmm_wgmma`.  In (b) and (c) a consumer's
// epilogue writes its tile rounded to bf16 into a swizzled shared tile that
// one thread stores by TMA; its next write waits for that store's reads.
// ------------------------------------------------------------------------

constexpr int CONS = 2;                  // consumer warpgroups
constexpr int NT_W = (CONS + 1) * WG;    // threads of a CTA
constexpr int ALL_CONSUMERS_BAR = 1 + CONS;  // named barrier of all consumers

// (a): 128 rows x 64 f-columns; a stage holds the x and dy panels of both
// consumers and the w1 (w3) and w2 panels.  The epilogue stores from
// registers, so that the ring has room for four stages
template <bool GATED>
struct UpTile {
  static constexpr int BM = 64 * CONS, BN = 64, STAGES = 4;
  static constexpr int NW = GATED ? 3 : 2;    // weight panels a stage
  static constexpr int STAGE_BYTES = (2 * CONS + NW) * BOX_BYTES;
  static constexpr size_t BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

// (b): 128 rows x 128 d-columns, depth f panels of [da1 | da3]
struct DxTile {
  static constexpr int BM = 64 * CONS, BN = 128, NP = BN / PANEL, STAGES = 4;
  static constexpr int STAGE_BYTES = (CONS + NP) * BOX_BYTES;
  static constexpr int OUT_BYTES = CONS * NP * BOX_BYTES;
  static constexpr size_t BYTES =
      1024 + STAGES * STAGE_BYTES + OUT_BYTES + 16 * STAGES;
};

// (c): 128 x 128 of NB weight gradients sharing the A panels, depth the
// live rows
template <int NB>
struct WtTile {
  static constexpr int BM = 64 * CONS, BN = 128, NP = BN / PANEL;
  static constexpr int STAGES = 4;
  static constexpr int STAGE_BYTES = (CONS + NB * NP) * BOX_BYTES;
  static constexpr int OUT_BYTES = CONS * NP * BOX_BYTES;  // reused per b
  static constexpr size_t BYTES =
      1024 + STAGES * STAGE_BYTES + OUT_BYTES + 16 * STAGES;
};
static_assert(DxTile::NP == 2 && WtTile<1>::NP == 2, "store_tile's panels");
static_assert(UpTile<true>::BYTES <= 232448 && DxTile::BYTES <= 232448 &&
                  WtTile<2>::BYTES <= 232448 && WtTile<1>::BYTES <= 232448,
              "a CTA's shared memory");

// the ring's shared memory: the base rounded up to the swizzle's period,
// the stages, the consumers' out tiles, then the full and empty barriers
struct Ring {
  uint8_t* stages;
  uint8_t* outs;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(uint8_t* raw, int stages,
                                          int stage_bytes, int out_bytes) {
  uint8_t* smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  Ring r{smem, smem + stages * stage_bytes, nullptr, nullptr};
  r.full = reinterpret_cast<uint64_t*>(r.outs + out_bytes);
  r.empty = r.full + stages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, CONS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// this warp is done with stage `it`: it has seen the stage's full barrier
// and its products on the stage have completed
__device__ __forceinline__ void release(const Ring& r, int it, int stages) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(r.empty + it % stages);
}

// the producer's wait for stage `it` to be free, then its byte count
__device__ __forceinline__ uint8_t* acquire(const Ring& r, int it,
                                            int stages, int stage_bytes) {
  const int s = it % stages;
  mbar_wait(r.empty + s, ((it / stages) & 1) ^ 1);
  mbar_expect_tx(r.full + s, stage_bytes);
  return r.stages + s * stage_bytes;
}

// the row of a consumer's 64 x (8 * N) accumulator that holds its
// elements i and i + 1 (i even), as wgmma lays them out
__device__ __forceinline__ int pair_row(int i, int warp, int lane) {
  return warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
}

// elements i and i + 1 of the accumulator into its bf16 out tile
// (64-column panels, 128-byte swizzled)
__device__ __forceinline__ void put_pair(uint8_t* out, int i, int warp,
                                         int lane, float v0, float v1) {
  const int r = pair_row(i, warp, lane);
  const int c = 8 * (i / 4) + 2 * (lane % 4);
  const int cc = c % PANEL;
  uint8_t* dst = out + (c / PANEL) * BOX_BYTES + r * ROW_BYTES +
                 (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2;
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
}

// a consumer's 64 x 128 accumulator, its rows from `live` on as 0, through
// its out tile Ow (two panels) to rows row0.. and columns n0.. of the
// tensor map by TMA
__device__ __forceinline__ void store_tile(const float (&acc)[64],
                                           uint8_t* Ow,
                                           const CUtensorMap* map, int wg,
                                           int n0, int row0, int e,
                                           int live) {
  const int t = threadIdx.x % WG, warp = t / 32, lane = t % 32;
  named_barrier(1 + wg, WG);  // the last store has read the out tile
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const bool pad = pair_row(i, warp, lane) >= live;
    put_pair(Ow, i, warp, lane, pad ? 0.f : acc[i], pad ? 0.f : acc[i + 1]);
  }
  fence_proxy_async();
  named_barrier(1 + wg, WG);
  if (t == 0) {
    for (int j = 0; j < 2; ++j)
      tma_store_4d(map, Ow + j * BOX_BYTES, n0 + j * PANEL, row0, e, 0);
    tma_store_wait();
  }
}

template <bool GATED>
__global__ void __launch_bounds__(NT_W, 1)
gmm_bwd_up_wgmma(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tdy,
             const __grid_constant__ CUtensorMap tw1,
             const __grid_constant__ CUtensorMap tw3,
             const __grid_constant__ CUtensorMap tw2,
             __nv_bfloat16* __restrict__ ws, const int* __restrict__ counts,
             int E, int C, int d, int f, int act) {
  using G = UpTile<GATED>;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_init(smem_raw, G::STAGES, G::STAGE_BYTES, 0);
  const int n_tiles_n = (f + G::BN - 1) / G::BN;
  const int n_tiles_m = (C + G::BM - 1) / G::BM;
  const int n_tiles = n_tiles_n * n_tiles_m * E;
  const int nk = (d + PANEL - 1) / PANEL;
  const int wg = threadIdx.x / WG;

  if (wg == CONS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONS * WG) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, m0, n0;
      tile_at(tile, n_tiles_m, n_tiles_n, G::BM, G::BN, e, m0, n0);
      if (m0 >= live_rows(counts, e, C)) continue;  // pads only
      for (int kp = 0; kp < nk; ++kp, ++it) {
        uint8_t* st = acquire(ring, it, G::STAGES, G::STAGE_BYTES);
        uint64_t* bar = ring.full + it % G::STAGES;
        for (int i = 0; i < CONS; ++i) {
          tma_load_4d(st + i * BOX_BYTES, &tx, bar, kp * PANEL,
                      m0 + i * BOX, e, 0);
          tma_load_4d(st + (CONS + i) * BOX_BYTES, &tdy, bar, kp * PANEL,
                      m0 + i * BOX, e, 0);
        }
        uint8_t* w = st + 2 * CONS * BOX_BYTES;
        tma_load_4d(w, &tw1, bar, n0, kp * PANEL, e, 0);  // (d, f): MN-major
        if constexpr (GATED)
          tma_load_4d(w + BOX_BYTES, &tw3, bar, n0, kp * PANEL, e, 0);
        // w2 (f, d): f rows n0.., d the depth: a K-major B
        tma_load_4d(w + (G::NW - 1) * BOX_BYTES, &tw2, bar, kp * PANEL, n0,
                    e, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const size_t ecf = (size_t)E * C * f;  // h, da1, da3 apart in ws
  float a1[32], a3[GATED ? 32 : 1], dh[32];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, m0, n0;
    tile_at(tile, n_tiles_m, n_tiles_n, G::BM, G::BN, e, m0, n0);
    const int live = live_rows(counts, e, C);
    if (m0 >= live) continue;
    const int row0 = m0 + wg * 64;
    const int k_live = row0 < live ? nk : 0;  // none where all are pads
#pragma unroll
    for (int i = 0; i < 32; ++i) a1[i] = dh[i] = 0.f;
    if constexpr (GATED) {
#pragma unroll
      for (int i = 0; i < 32; ++i) a3[i] = 0.f;
    }
    for (int kp = 0; kp < k_live; ++kp, ++it) {
      const int s = it % G::STAGES;
      mbar_wait(ring.full + s, (it / G::STAGES) & 1);
      const uint8_t* st = ring.stages + s * G::STAGE_BYTES;
      const uint8_t* Xs = st + wg * BOX_BYTES;
      const uint8_t* Ys = st + (CONS + wg) * BOX_BYTES;
      const uint8_t* W = st + 2 * CONS * BOX_BYTES;
      reg_fence(a1);
      reg_fence(dh);
      if constexpr (GATED) reg_fence(a3);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const uint64_t dx = sw128_desc(Xs + kk * 32, 16);
        wgmma_ss_mn(a1, dx, sw128_desc(W + kk * 16 * ROW_BYTES, BOX_BYTES),
                    1);
        if constexpr (GATED)
          wgmma_ss_mn(a3, dx, sw128_desc(W + BOX_BYTES + kk * 16 * ROW_BYTES,
                                         BOX_BYTES), 1);
        wgmma_ss(dh, sw128_desc(Ys + kk * 32, 16),
                 sw128_desc(W + (G::NW - 1) * BOX_BYTES + kk * 32, 16), 1);
      }
      wgmma_commit();
      wgmma_wait1();
      reg_fence(a1);
      reg_fence(dh);
      if constexpr (GATED) reg_fence(a3);
      if (kp > 0) release(ring, it - 1, G::STAGES);
    }
    wgmma_wait0();
    reg_fence(a1);
    reg_fence(dh);
    if constexpr (GATED) reg_fence(a3);
    if (k_live > 0) release(ring, it - 1, G::STAGES);
    for (int kp = k_live; kp < nk; ++kp, ++it) {  // pads: wait and release
      mbar_wait(ring.full + it % G::STAGES, (it / G::STAGES) & 1);
      release(ring, it, G::STAGES);
    }
    if (k_live == 0) continue;  // pads only: nothing reads these rows

    // h, da1 (da3) in bf16 from the accumulators into the workspace, a
    // quad of lanes 16 contiguous bytes of a row; rows past the fill as 0
    __nv_bfloat16* out = ws + ((size_t)e * C + row0) * f + n0;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = pair_row(i, warp, lane);
      const int c = 8 * (i / 4) + 2 * (lane % 4);
      if (row0 + r >= C || n0 + c >= f) continue;  // f % 8 == 0: c + 1 too
      float hv[2], d1[2], d3[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float g = activate(act, a1[i + u]);
        d1[u] = dh[i + u] * act_grad(act, a1[i + u]);
        hv[u] = g;
        d3[u] = 0.f;
        if constexpr (GATED) {
          hv[u] = g * a3[i + u];
          d1[u] *= a3[i + u];
          d3[u] = dh[i + u] * g;
        }
        if (row0 + r >= live) hv[u] = d1[u] = d3[u] = 0.f;
      }
      __nv_bfloat16* o = out + (size_t)r * f + c;
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(hv[0], hv[1]);
      *reinterpret_cast<uint32_t*>(o + ecf) = pack_bf16(d1[0], d1[1]);
      if constexpr (GATED)
        *reinterpret_cast<uint32_t*>(o + 2 * ecf) = pack_bf16(d3[0], d3[1]);
    }
  }
}

// (b) dx = da1 w1^T (+ da3 w3^T): the depth's first nkf panels pair da1
// with w1, the next nkf (gated) da3 with w3; w (d, f) is a K-major B
__global__ void __launch_bounds__(NT_W, 1)
gmm_bwd_dx_wgmma(const __grid_constant__ CUtensorMap tda1,
             const __grid_constant__ CUtensorMap tda3,
             const __grid_constant__ CUtensorMap tw1,
             const __grid_constant__ CUtensorMap tw3,
             const __grid_constant__ CUtensorMap tdx,
             __nv_bfloat16* __restrict__ dx, const int* __restrict__ counts,
             int E, int C, int d, int f, int gated) {
  using G = DxTile;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_init(smem_raw, G::STAGES, G::STAGE_BYTES,
                              G::OUT_BYTES);
  const int n_tiles_n = (d + G::BN - 1) / G::BN;
  const int n_tiles_m = (C + G::BM - 1) / G::BM;
  const int n_tiles = n_tiles_n * n_tiles_m * E;
  const int nkf = (f + PANEL - 1) / PANEL;
  const int nk = nkf * (gated ? 2 : 1);
  const int wg = threadIdx.x / WG;

  if (wg == CONS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONS * WG) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, m0, n0;
      tile_at(tile, n_tiles_m, n_tiles_n, G::BM, G::BN, e, m0, n0);
      if (m0 >= live_rows(counts, e, C)) continue;  // pads only
      for (int kp = 0; kp < nk; ++kp, ++it) {
        uint8_t* st = acquire(ring, it, G::STAGES, G::STAGE_BYTES);
        uint64_t* bar = ring.full + it % G::STAGES;
        const bool second = kp >= nkf;
        const int k0 = (second ? kp - nkf : kp) * PANEL;
        for (int i = 0; i < CONS; ++i)
          tma_load_4d(st + i * BOX_BYTES, second ? &tda3 : &tda1, bar, k0,
                      m0 + i * BOX, e, 0);
        for (int j = 0; j < G::NP; ++j)
          tma_load_4d(st + (CONS + j) * BOX_BYTES, second ? &tw3 : &tw1, bar,
                      k0, n0 + j * BOX, e, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  uint8_t* Ow = ring.outs + wg * G::NP * BOX_BYTES;
  float acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, m0, n0;
    tile_at(tile, n_tiles_m, n_tiles_n, G::BM, G::BN, e, m0, n0);
    const int live = live_rows(counts, e, C);
    if (m0 >= live) {  // pads only: their zeros
      zero_tile(dx + (long long)e * C * d, m0, C, n0, d, G::BM, G::BN,
                threadIdx.x, CONS * WG);
      continue;
    }
    const int row0 = m0 + wg * 64;
    const int k_live = row0 < live ? nk : 0;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kp = 0; kp < k_live; ++kp, ++it) {
      const int s = it % G::STAGES;
      mbar_wait(ring.full + s, (it / G::STAGES) & 1);
      const uint8_t* st = ring.stages + s * G::STAGE_BYTES;
      const uint8_t* As = st + wg * BOX_BYTES;
      const uint8_t* Bs = st + CONS * BOX_BYTES;
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk)
        wgmma_ss(acc, sw128_desc(As + kk * 32, 16),
                 sw128_desc(Bs + kk * 32, 16), 1);
      wgmma_commit();
      wgmma_wait1();
      reg_fence(acc);
      if (kp > 0) release(ring, it - 1, G::STAGES);
    }
    wgmma_wait0();
    reg_fence(acc);
    if (k_live > 0) release(ring, it - 1, G::STAGES);
    for (int kp = k_live; kp < nk; ++kp, ++it) {
      mbar_wait(ring.full + it % G::STAGES, (it / G::STAGES) & 1);
      release(ring, it, G::STAGES);
    }

    store_tile(acc, Ow, &tdx, wg, n0, row0, e, live - row0);
  }
}

// zeros over rows [r0, 64) of the `panels` 64-row panels at p (all
// consumer threads)
__device__ __forceinline__ void zero_rows(uint8_t* p, int panels, int r0) {
  const int per = (BOX - r0) * (ROW_BYTES / 16);  // 16-byte chunks a panel
  for (int v = threadIdx.x; v < panels * per; v += CONS * WG) {
    const int q = v / per, c = v % per;
    *reinterpret_cast<uint4*>(p + q * BOX_BYTES + r0 * ROW_BYTES + c * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// (c) out_b (M x N of each expert) = A^T B_b over the expert's live rows:
// A (E, C, M) and B_b (E, C, N) are read MN-major, 64 rows of depth a
// panel; the rows past the fill in the last panel are zeroed in shared
// memory before the products.  An expert with no live row gets zeros.
template <int NB>
__global__ void __launch_bounds__(NT_W, 1)
gmm_bwd_wt_wgmma(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb0,
             const __grid_constant__ CUtensorMap tb1,
             const __grid_constant__ CUtensorMap tout0,
             const __grid_constant__ CUtensorMap tout1,
             const int* __restrict__ counts, int E, int C, int M, int N) {
  using G = WtTile<NB>;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_init(smem_raw, G::STAGES, G::STAGE_BYTES,
                              G::OUT_BYTES);
  const int n_tiles_n = (N + G::BN - 1) / G::BN;
  const int n_tiles_m = (M + G::BM - 1) / G::BM;
  const int n_tiles = n_tiles_n * n_tiles_m * E;
  const int wg = threadIdx.x / WG;

  if (wg == CONS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x != CONS * WG) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, m0, n0;
      tile_at(tile, n_tiles_m, n_tiles_n, G::BM, G::BN, e, m0, n0);
      const int nk = (live_rows(counts, e, C) + PANEL - 1) / PANEL;
      for (int kp = 0; kp < nk; ++kp, ++it) {
        uint8_t* st = acquire(ring, it, G::STAGES, G::STAGE_BYTES);
        uint64_t* bar = ring.full + it % G::STAGES;
        for (int i = 0; i < CONS; ++i)
          tma_load_4d(st + i * BOX_BYTES, &ta, bar, m0 + i * PANEL,
                      kp * BOX, e, 0);
        for (int b = 0; b < NB; ++b)
          for (int j = 0; j < G::NP; ++j)
            tma_load_4d(st + (CONS + b * G::NP + j) * BOX_BYTES,
                        b == 0 ? &tb0 : &tb1, bar, n0 + j * PANEL, kp * BOX,
                        e, 0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  uint8_t* Ow = ring.outs + wg * G::NP * BOX_BYTES;
  float acc0[64], acc1[NB == 2 ? 64 : 1];
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, m0, n0;
    tile_at(tile, n_tiles_m, n_tiles_n, G::BM, G::BN, e, m0, n0);
    const int live = live_rows(counts, e, C);
    const int nk = (live + PANEL - 1) / PANEL;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = 0.f;
    if constexpr (NB == 2) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc1[i] = 0.f;
    }
    for (int kp = 0; kp < nk; ++kp, ++it) {
      const int s = it % G::STAGES;
      mbar_wait(ring.full + s, (it / G::STAGES) & 1);
      uint8_t* st = ring.stages + s * G::STAGE_BYTES;
      const int rem = live - kp * BOX;
      if (rem < BOX) {  // the last panel: rows past the fill to 0
        zero_rows(st, CONS + NB * G::NP, rem);
        fence_proxy_async();
        named_barrier(ALL_CONSUMERS_BAR, CONS * WG);
      }
      const uint8_t* As = st + wg * BOX_BYTES;
      const uint8_t* Bs = st + CONS * BOX_BYTES;
      reg_fence(acc0);
      if constexpr (NB == 2) reg_fence(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const uint64_t da = sw128_desc(As + kk * 16 * ROW_BYTES, BOX_BYTES);
        wgmma_tt(acc0, da,
                 sw128_desc(Bs + kk * 16 * ROW_BYTES, BOX_BYTES), 1);
        if constexpr (NB == 2)
          wgmma_tt(acc1, da,
                   sw128_desc(Bs + G::NP * BOX_BYTES + kk * 16 * ROW_BYTES,
                              BOX_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait1();
      reg_fence(acc0);
      if constexpr (NB == 2) reg_fence(acc1);
      if (kp > 0) release(ring, it - 1, G::STAGES);
    }
    wgmma_wait0();
    reg_fence(acc0);
    if constexpr (NB == 2) reg_fence(acc1);
    if (nk > 0) release(ring, it - 1, G::STAGES);

    // the out tile is reused: each store waits for the last one's reads
    store_tile(acc0, Ow, &tout0, wg, n0, m0 + wg * 64, e, BOX);
    if constexpr (NB == 2)
      store_tile(acc1, Ow, &tout1, wg, n0, m0 + wg * 64, e, BOX);
  }
}

// one launch of `kernel` over n_tiles tiles: an SM's worth of persistent
// CTAs, `smem` bytes each
template <typename K, typename... Args>
cudaError_t launch_persistent(K kernel, size_t smem, long long n_tiles,
                              cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  if (n_tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, NT_W, smem, st>>>(args...);
  return cudaGetLastError();
}

long long tiles(int E, int M, int N, int BM, int BN) {
  return (long long)E * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

cudaError_t run_wgmma(const void* xe, const void* w1, const void* w3,
                      const void* w2, const void* dy, void* dxv, void* dw1,
                      void* dw3, void* dw2, void* ws, const int* counts,
                      int E, int C, int d, int f, int act,
                      cudaStream_t st) {
  const bool gated = w3 != nullptr;
  const size_t ecf = (size_t)E * C * f;
  __nv_bfloat16* h = static_cast<__nv_bfloat16*>(ws);
  __nv_bfloat16* da1 = h + ecf;
  __nv_bfloat16* da3 = gated ? da1 + ecf : da1;
  CUtensorMap tx, tdy, tw1, tw3, tw2, th, tda1, tda3, tdx, tdw1, tdw3, tdw2;
  if (!make_map(&tx, xe, E, C, d) || !make_map(&tdy, dy, E, C, d) ||
      !make_map(&tw1, w1, E, d, f) ||
      !make_map(&tw3, gated ? w3 : w1, E, d, f) ||
      !make_map(&tw2, w2, E, f, d) || !make_map(&th, h, E, C, f) ||
      !make_map(&tda1, da1, E, C, f) || !make_map(&tda3, da3, E, C, f) ||
      !make_map(&tdx, dxv, E, C, d) || !make_map(&tdw1, dw1, E, d, f) ||
      !make_map(&tdw3, gated ? dw3 : dw1, E, d, f) ||
      !make_map(&tdw2, dw2, E, f, d))
    return cudaErrorInvalidValue;

  const long long n_up = tiles(E, C, f, UpTile<true>::BM, UpTile<true>::BN);
  cudaError_t err =
      gated ? launch_persistent(gmm_bwd_up_wgmma<true>, UpTile<true>::BYTES,
                                n_up, st, tx, tdy, tw1, tw3, tw2, h, counts,
                                E, C, d, f, act)
            : launch_persistent(gmm_bwd_up_wgmma<false>, UpTile<false>::BYTES,
                                n_up, st, tx, tdy, tw1, tw3, tw2, h, counts,
                                E, C, d, f, act);
  if (err != cudaSuccess) return err;
  err = launch_persistent(gmm_bwd_dx_wgmma, DxTile::BYTES,
                          tiles(E, C, d, DxTile::BM, DxTile::BN), st, tda1,
                          tda3, tw1, tw3, tdx,
                          static_cast<__nv_bfloat16*>(dxv), counts, E, C, d,
                          f, (int)gated);
  if (err != cudaSuccess) return err;
  // dw1 (and dw3) = x^T da1 (da3): M = d, N = f
  const long long n_w1 = tiles(E, d, f, WtTile<2>::BM, WtTile<2>::BN);
  err = gated ? launch_persistent(gmm_bwd_wt_wgmma<2>, WtTile<2>::BYTES, n_w1,
                                  st, tx, tda1, tda3, tdw1, tdw3, counts, E,
                                  C, d, f)
              : launch_persistent(gmm_bwd_wt_wgmma<1>, WtTile<1>::BYTES, n_w1,
                                  st, tx, tda1, tda1, tdw1, tdw1, counts, E,
                                  C, d, f);
  if (err != cudaSuccess) return err;
  // dw2 = h^T dy: M = f, N = d
  return launch_persistent(gmm_bwd_wt_wgmma<1>, WtTile<1>::BYTES,
                           tiles(E, f, d, WtTile<1>::BM, WtTile<1>::BN), st,
                           th, tdy, tdy, tdw2, tdw2, counts, E, C, f, d);
}

}  // namespace

// xe, dy, dxe: (E, C, d); w1, w3, dw1, dw3: (E, d, f) (w3 and dw3 null: no
// gate); w2, dw2: (E, f, d); ws: a (2 or 3, E, C, f) workspace (h, da1,
// da3); all contiguous, of one dtype, on the current device; counts: int32
// (E,) fills of the buckets, or null (every row live).  act: 0 silu, 1 tanh
// GELU, 2 squared ReLU.  route: 0 scalar float32, 1 bf16 on scalar FMAs (the
// forward's WMMA route), 2 wgmma bf16 (d and f multiples of 8, every tensor
// 16-byte aligned).  Launches the backward's kernels on `stream` and returns
// cudaGetLastError() after them (0 on success), or the error that refused
// the inputs.
extern "C" int repro_moe_gmm_ffn_bwd(const void* xe, const void* w1,
                                     const void* w3, const void* w2,
                                     const void* dy, void* dxe, void* dw1,
                                     void* dw3, void* dw2, void* ws,
                                     const void* counts, int E, int C, int d,
                                     int f, int act, int route,
                                     void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || act < kSilu || act > kRelu2 ||
      (w3 == nullptr) != (dw3 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (route == kWgmmaBf16) {
    for (const void* p : {xe, w1, w3, w2, dy, (const void*)dxe,
                          (const void*)dw1, (const void*)dw3,
                          (const void*)dw2, (const void*)ws})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    if (d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
    return (int)run_wgmma(xe, w1, w3, w2, dy, dxe, dw1, dw3, dw2, ws, cnt, E,
                          C, d, f, act, st);
  }
  if (E > 65535 || (C + SBM - 1) / SBM > 65535 || (d + SBM - 1) / SBM > 65535
      || (f + SBM - 1) / SBM > 65535)
    return (int)cudaErrorInvalidValue;
  if (route == kScalarF32)
    return (int)run_scalar<float>(xe, w1, w3, w2, dy, dxe, dw1, dw3, dw2, ws,
                                  cnt, E, C, d, f, act, st);
  if (route == kWmmaBf16)
    return (int)run_scalar<__nv_bfloat16>(xe, w1, w3, w2, dy, dxe, dw1, dw3,
                                          dw2, ws, cnt, E, C, d, f, act, st);
  return (int)cudaErrorInvalidValue;
}
