// Grouped expert FFN for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ffn_kernel`, launched by
// `expert_ffn_pallas` in src/repro/kernels/moe_gmm/kernel.py: for every
// expert e of xe (E, C, d),
//
//     y[e] = (act(xe[e] @ w1[e]) * (xe[e] @ w3[e])) @ w2[e]
//
// with acts swiglu (silu), geglu / gelu (the tanh form of GELU, as
// jax.nn.gelu) and relu2, and w3 optional (no gate: y = act(x@w1) @ w2).
// Products accumulate in float32; the hidden h is rounded to the input
// dtype before the down projection (as the TPU kernel's `h.astype(x.dtype)`)
// and y is written in the input dtype.  An optional int32 `counts` (E,)
// gives each bucket's fill: rows at or past counts[e] hold pads, and their
// y is exactly 0 (what the function gives a zero pad row, since act(0) = 0
// for all three acts).  Without it every row is live.
//
// What bounds it on the H100: 6*E*C*d*f FLOPs against the weights
// (3*E*d*f) plus xe and y.  At granite-moe's prefill (E 40, C 1000, d 1536,
// f 512, bf16) that is 188.7 GFLOP and 435 MB: the tensor-core bound is
// 0.19 ms.  At its decode (C 8) the weights bound it: 189 MB for all 40
// experts, 0.056 ms, and only the experts that a token reaches need theirs
// (about 24 of 40 at 4 tokens top-8: 0.034 ms).
//
// Design.  The TPU kernel keeps a (block_c, d) float32 accumulator resident
// across the f-blocks, so that h never reaches HBM.  At d 1536 and block_c
// 128 that tile is 768 KiB, at mixtral's d 4096 it is 2 MiB: an H100 SM has
// 227 KB of shared memory, and split-f partial sums of y would move more
// bytes than h does.  So the work is two launches of one grouped product
// kernel, and h goes through an (E, C, f) workspace in HBM (2 * E*C*f *
// sizeof(T) of extra traffic: 82 MB per granite prefill layer, 24 us at
// the HBM rate):
//  * gate/up: out = act(xe @ w1) * (xe @ w3), both products sharing the
//    staged xe tile;
//  * down:    y = h @ w2.
// Three routes, chosen by the caller (ops.kernel_route) and named by the
// `route` argument; a route that cannot take its inputs refuses them:
//  * wgmma_bf16 (`gmm_wgmma`): bf16 with d and f multiples of 8 and 16-byte
//    aligned tensors, which TMA can address.  A CTA walks output tiles
//    (many at prefill, one at decode); one producer thread keeps a ring of
//    stages full by TMA (64-deep
//    panels of the rows, 128-byte swizzled, and the weights' panels, N
//    innermost, read by `wgmma` as an MN-major B), and one or two consumer
//    warpgroups of 64 rows run `wgmma` on them, one group of products in
//    flight while the next stage's land.  The epilogue rounds to bf16 into
//    a swizzled tile that TMA stores; the tensor maps zero-fill rows,
//    columns and depth past the arrays and clip the stores, so any C runs
//    without masks in the products.  Buckets of more than 64 rows
//    (prefill) take 128-row tiles (two consumers); buckets of at most 64
//    (decode) one consumer and 64-column tiles, two CTAs an SM, so that
//    enough weight bytes are in flight to stream the touched experts'
//    weights.
//  * wmma_bf16 (`gmm_wmma_kernel`): other bf16, on WMMA fragments (the
//    pre-Hopper `mma.sync` path), 64 x 64 tiles staged by plain loads.
//  * scalar_f32 (`gmm_kernel`): float32, scalar FMAs, 64 x 64 tiles.
// Pads are skipped on every route: a tile whose rows all lie at or past
// counts[e] loads nothing; the gate/up launch writes nothing for it (no
// later pass reads those rows of h) and the down launch writes its zeros.
// So an expert that no token reached streams none of its weights.  Rows
// of a partly filled tile are computed and their results masked to 0.
#include <mma.h>

// Hopper primitives (inline PTX for wgmma, TMA, mbarriers), the tensor-map
// encoder, and the activations, fills and tiling helpers shared with the
// backward (moe_gmm_bwd.cu)
#include "moe_gmm.cuh"

namespace {

constexpr int BM = 64;   // rows (capacity slots) per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // depth per shared-memory stage
constexpr int NT = 256;  // threads per block: 16 x 16, each 4 x 4 outputs
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int AS = BM + 4;  // A tile row stride: float4-aligned, fewer
                            // bank conflicts on the transposing store
static_assert(BM == 16 * TM && BN == 16 * TN, "16 x 16 threads cover a tile");
static_assert(BM * BK % NT == 0 && BK * BN % NT == 0, "tiles split evenly");

// float32.  For expert blockIdx.z: acc_b = A (M x K) @ B_b (K x N), b < NB,
// all row-major and contiguous per expert.  UP: out = act(acc_0) [* acc_1];
// otherwise out = acc_0.  out is (M x N) per expert, in T.  Rows at or past
// the bucket's fill are loaded as zeros and stored as zeros; a block whose
// rows all lie there loads no weights (and the gate/up launch stores
// nothing for it).
template <typename T, int NB, bool UP>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ A, const T* __restrict__ B0,
           const T* __restrict__ B1, T* __restrict__ out,
           const int* __restrict__ counts, int M, int K, int N, int act) {
  __shared__ __align__(16) float As[BK][AS];      // transposed: As[k][m]
  __shared__ __align__(16) float Bs[NB][BK][BN];

  const long long e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int live = live_rows(counts, e, M);
  if (UP && m0 >= live) return;
  A += e * M * K;
  out += e * M * N;
  const T* B[NB];
  B[0] = B0 + e * K * N;
  if constexpr (NB == 2) B[1] = B1 + e * K * N;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3

  float acc[NB][TM][TN];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[b][i][j] = 0.f;

  for (int k0 = 0; m0 < live && k0 < K; k0 += BK) {
    // A tile (BM x BK): neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int t = 0; t < BM * BK / NT; ++t) {
      const int i = tid + t * NT;
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < live && k < K) ? to_f32(A[(long long)m * K + k]) : 0.f;
    }
    // B tiles (BK x BN): neighbouring threads read neighbouring n
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int t = 0; t < BK * BN / NT; ++t) {
        const int i = tid + t * NT;
        const int r = i / BN, c = i % BN;
        const int k = k0 + r, n = n0 + c;
        Bs[b][r][c] =
            (k < K && n < N) ? to_f32(B[b][(long long)k * N + n]) : 0.f;
      }
    __syncthreads();

    // threads whose rows all lie past the fill skip the FMAs (at decode a
    // bucket holds a few live rows of the tile's 64)
    if (m0 + ty * TM < live) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float4 v =
              *reinterpret_cast<const float4*>(&Bs[b][kk][tx * TN]);
          const float bv[TN] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[b][i][j] = fmaf(av[i], bv[j], acc[b][i][j]);
        }
      }
    }
    __syncthreads();  // the tiles are consumed before they are replaced
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (UP) {
        v = activate(act, v);
        if constexpr (NB == 2) v *= acc[1][i][j];
      }
      out[(long long)m * N + n] = from_f32<T>(m < live ? v : 0.f);
    }
  }
}

// bf16 that TMA cannot address: the same tile product on the tensor cores
// through WMMA (16 x 16 x 16 bf16 fragments, float32 accumulation).  128
// threads: warp w computes the 32 x 32 quarter (w / 2, w % 2) of the
// 64 x 64 tile as 2 x 2 fragments per B matrix.  Tiles are staged in shared
// memory as bf16 (16-byte loads where K and N are multiples of 8 and the
// tensors 16-byte aligned, element loads with masking otherwise); after the
// depth loop the accumulators go through shared memory (float32, reusing
// the tile buffers) to the same epilogue as above.
constexpr int WT = 128;       // threads per block
constexpr int WAS = BK + 8;   // bf16 row strides: multiples of 8 (WMMA's
constexpr int WBS = BN + 8;   // ldm), 16-byte rows, staggered banks
constexpr int WCS = BN + 4;   // float32 accumulator row stride

template <int NB>
struct WmmaSmem {
  static constexpr int tiles = 2 * (BM * WAS + NB * BK * WBS);
  static constexpr int acc = 4 * NB * BM * WCS;
  static constexpr int bytes = tiles > acc ? tiles : acc;
};

// 8 consecutive bf16 of row `row` from column `col` of a (rows x cols)
// row-major matrix into dst, zeros past its edge.
__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int row,
                                      int rows, int col, int cols, bool vec) {
  const __nv_bfloat16* p = src + (long long)row * cols + col;
  if (vec) {  // cols % 8 == 0, so col < cols means the 8 are all inside
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < rows && col < cols) v = *reinterpret_cast<const uint4*>(p);
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = (row < rows && col + i < cols) ? p[i] : __float2bfloat16(0.f);
  }
}

template <int NB, bool UP>
__global__ void __launch_bounds__(WT)
gmm_wmma_kernel(const __nv_bfloat16* __restrict__ A,
                const __nv_bfloat16* __restrict__ B0,
                const __nv_bfloat16* __restrict__ B1,
                __nv_bfloat16* __restrict__ out,
                const int* __restrict__ counts, int M, int K, int N, int act,
                int vec) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[WmmaSmem<NB>::bytes];
  auto As = reinterpret_cast<__nv_bfloat16(*)[WAS]>(smem);
  auto Bs = reinterpret_cast<__nv_bfloat16(*)[BK][WBS]>(
      smem + 2 * BM * WAS);
  auto Cs = reinterpret_cast<float(*)[BM][WCS]>(smem);  // after the loop

  const long long e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int live = live_rows(counts, e, M);
  if (UP && m0 >= live) return;
  A += e * M * K;
  out += e * M * N;
  const __nv_bfloat16* B[NB];
  B[0] = B0 + e * K * N;
  if constexpr (NB == 2) B[1] = B1 + e * K * N;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // the warp's rows and columns in the tile
  const int wn = (warp % 2) * 32;
  const bool rows_live = m0 + wm < live;  // else the warp's rows are pads

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[b][i][j], 0.f);

  for (int k0 = 0; m0 < live && k0 < K; k0 += BK) {
    // A tile (BM x BK) and B tiles (BK x BN): 256 runs of 8 each
#pragma unroll
    for (int t = 0; t < BM * BK / 8 / WT; ++t) {
      const int v = tid + t * WT;
      const int r = v / (BK / 8), c = v % (BK / 8) * 8;
      load8(&As[r][c], A, m0 + r, live, k0 + c, K, vec);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int t = 0; t < BK * BN / 8 / WT; ++t) {
        const int v = tid + t * WT;
        const int r = v / (BN / 8), c = v % (BN / 8) * 8;
        load8(&Bs[b][r][c], B[b], k0 + r, K, n0 + c, N, vec);
      }
    __syncthreads();
    if (rows_live) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[wm + 16 * i][kk], WAS);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> bf;
            wmma::load_matrix_sync(bf, &Bs[b][kk][wn + 16 * j], WBS);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wmma::mma_sync(acc[b][i][j], a[i], bf, acc[b][i][j]);
          }
      }
    }
    __syncthreads();  // the tiles are consumed before they are replaced
  }

#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&Cs[b][wm + 16 * i][wn + 16 * j],
                                acc[b][i][j], WCS, wmma::mem_row_major);
  __syncthreads();
  for (int v = tid; v < BM * BN; v += WT) {
    const int r = v / BN, c = v % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float x = Cs[0][r][c];
    if constexpr (UP) {
      x = activate(act, x);
      if constexpr (NB == 2) x *= Cs[1][r][c];
    }
    out[(long long)m * N + n] = __float2bfloat16(m < live ? x : 0.f);
  }
}

// ------------------------------------------------------------------------
// wgmma_bf16 route
//
// One kernel for both launches: acc_b = A (M x K, K innermost) @ B_b (K x
// N, N innermost) per expert, out = act(acc_0) [* acc_1] (UP) or acc_0,
// in bf16.  Every operand and the output go through 4-D tensor maps (inner,
// rows, E, 1) with boxes of 64 x 64 (one 128-byte-swizzled panel of 64
// rows), so a stage holds CONSUMERS panels of A and BN / 64 panels of each
// B, and a warpgroup's output tile BN / 64 panels.
//  * CTA i takes the output tiles i, i + grid, ... expert by expert, and
//    within an expert along its longer side first: where a bucket has more
//    column tiles than row tiles (wide weights: mixtral's w1 and w3 outgrow
//    L2), row tiles fastest, so that the CTAs in flight share each weight
//    panel across the bucket's rows and each weight byte leaves HBM about
//    once; otherwise column tiles fastest, sharing each row panel.
//    Producer and consumers walk the same tiles and skip the same dead
//    ones.  The prefill tiles' grid is persistent (an SM's worth of
//    CTAs), so that a tile's epilogue overlaps the next one's loads; the
//    decode tiles' grid has a CTA a tile, so that the hardware spreads the
//    few live tiles (those of touched experts) over the SMs.
//  * Stages are counted across tiles, so the producer loads the next
//    tile's panels while the consumers finish a tile and store it.
//  * A consumer warpgroup's rows that all lie past the fill skip the
//    products; it still waits for and releases every stage, so that each
//    warp has seen a stage's full barrier before the producer can refill it.
//  * The output tile goes to shared memory in the swizzled layout the
//    tensor map stores from; before a warpgroup writes it again, its store
//    thread has waited for the last store's reads (a named barrier orders
//    the rest of the warpgroup after that wait).
// ------------------------------------------------------------------------

// A tile shape: CONSUMERS warpgroups of 64 rows, BN output columns, STAGES
// stages in the ring, MIN_BLOCKS CTAs an SM, a persistent grid (PERSISTENT)
// or a CTA a tile; NB weight matrices (2 for the gated gate/up launch)
template <int CONSUMERS_, int BN_, int STAGES_, int MIN_BLOCKS_,
          bool PERSISTENT_>
struct Tile {
  static constexpr int CONSUMERS = CONSUMERS_, BN = BN_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool PERSISTENT = PERSISTENT_;
  static constexpr int BM = 64 * CONSUMERS;
  static constexpr int NP = BN / PANEL;         // panels of a B or out tile
  static constexpr int A_BYTES = CONSUMERS * BOX_BYTES;
  static constexpr int B_BYTES = NP * BOX_BYTES;  // one matrix, one stage
  static constexpr int OUT_BYTES = CONSUMERS * NP * BOX_BYTES;
  static constexpr int NT = (CONSUMERS + 1) * WG;
  static constexpr int ACC = BN / 2;  // accumulators a thread, per matrix
  template <int NB>
  __host__ __device__ static constexpr int stage_bytes() {
    return A_BYTES + NB * B_BYTES;
  }
  // + 1024: the base is rounded up to the swizzle's 1024-byte period
  template <int NB>
  __host__ __device__ static constexpr size_t bytes() {
    return 1024 + STAGES * stage_bytes<NB>() + OUT_BYTES + 8 * 2 * STAGES;
  }
  static_assert(BN % PANEL == 0 && BN <= 256, "BN: 64, 128 or 256");
};

// The tiles of the two launches.  Buckets of more than DECODE_ROWS rows
// (prefill) take 128-row tiles; smaller ones (decode) 64-row tiles with
// 64 columns, two CTAs an SM and a CTA a tile, so that enough CTAs stream
// the few touched experts' weights (tools/moe_variants.py times the
// alternatives).
constexpr int DECODE_ROWS = 64;
using PrefillUpTile = Tile<2, 128, 4, 1, true>;
using PrefillDownTile = Tile<2, 256, 3, 1, true>;
using DecodeUpTile = Tile<1, 64, 4, 2, false>;
using DecodeDownTile = Tile<1, 64, 4, 2, false>;

template <class G, int NB, bool UP>
__global__ void __launch_bounds__(G::NT, G::MIN_BLOCKS)
gmm_wgmma(const __grid_constant__ CUtensorMap ta,
          const __grid_constant__ CUtensorMap tb0,
          const __grid_constant__ CUtensorMap tb1,
          const __grid_constant__ CUtensorMap tout,
          __nv_bfloat16* __restrict__ out, const int* __restrict__ counts,
          int E, int M, int K, int N, int act) {
  constexpr int CONSUMERS = G::CONSUMERS, STAGES = G::STAGES, NP = G::NP;
  constexpr int BM = G::BM, BN = G::BN, ACC = G::ACC;
  constexpr int STAGE_BYTES = G::template stage_bytes<NB>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Outs = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Outs + G::OUT_BYTES);
  uint64_t* empty = full + STAGES;

  const int n_tiles_n = (N + BN - 1) / BN;
  const int n_tiles_m = (M + BM - 1) / BM;
  const int n_tiles = n_tiles_n * n_tiles_m * E;
  const int nk = (K + PANEL - 1) / PANEL;  // 64-deep panels of the depth
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS * WG / 32);  // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full across the CTA's tiles
    if constexpr (CONSUMERS > 1) setmaxnreg_dec<40>();
    if (threadIdx.x != CONSUMERS * WG) return;
    int it = 0;  // stages filled so far
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int e, m0, n0;
      tile_at(tile, n_tiles_m, n_tiles_n, BM, BN, e, m0, n0);
      if (m0 >= live_rows(counts, e, M)) continue;  // pads only
      for (int kp = 0; kp < nk; ++kp, ++it) {
        const int s = it % STAGES;
        // the consumers have released this stage's previous panels
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(full + s, STAGE_BYTES);
        for (int i = 0; i < CONSUMERS; ++i)
          tma_load_4d(st + i * BOX_BYTES, &ta, full + s, kp * PANEL,
                      m0 + i * BOX, e, 0);
        for (int j = 0; j < NP; ++j) {
          tma_load_4d(st + G::A_BYTES + j * BOX_BYTES, &tb0, full + s,
                      n0 + j * PANEL, kp * PANEL, e, 0);
          if constexpr (NB == 2)
            tma_load_4d(st + G::A_BYTES + G::B_BYTES + j * BOX_BYTES, &tb1,
                        full + s, n0 + j * PANEL, kp * PANEL, e, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroup `wg`: rows row0 .. row0 + 63 of each tile
  if constexpr (CONSUMERS > 1) setmaxnreg_inc<232>();
  const int t = threadIdx.x % WG;
  const int warp = t / 32, lane = t % 32;
  uint8_t* Ow = Outs + wg * NP * BOX_BYTES;  // this warpgroup's out tile
  float acc0[ACC], acc1[NB == 2 ? ACC : 1];
  int it = 0;  // stages consumed so far

  // this warp is done with stage `it`: it has seen the stage's full
  // barrier and its products on the stage have completed
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + it % STAGES);
  };

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int e, m0, n0;
    tile_at(tile, n_tiles_m, n_tiles_n, BM, BN, e, m0, n0);
    const int live = live_rows(counts, e, M);
    if (m0 >= live) {
      // pads only: no later pass reads these rows of h; y gets its zeros
      if constexpr (!UP)
        zero_tile(out + (long long)e * M * N, m0, M, n0, N, BM, BN,
                  threadIdx.x, CONSUMERS * WG);
      continue;
    }
    const int row0 = m0 + wg * 64;
    // panels this warpgroup multiplies: none where its rows are all pads
    const int k_live = row0 < live ? nk : 0;

#pragma unroll
    for (int i = 0; i < ACC; ++i) acc0[i] = 0.f;
    if constexpr (NB == 2) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc1[i] = 0.f;
    }
    for (int kp = 0; kp < k_live; ++kp, ++it) {
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      const uint8_t* st = smem + s * STAGE_BYTES;
      const uint8_t* As = st + wg * BOX_BYTES;
      const uint8_t* Bs = st + G::A_BYTES;
      reg_fence(acc0);
      if constexpr (NB == 2) reg_fence(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PANEL / 16; ++kk) {
        const uint64_t da = sw128_desc(As + kk * 32, 16);  // 16 columns
        wgmma_ss_mn(acc0, da, sw128_desc(Bs + kk * 16 * ROW_BYTES, BOX_BYTES),
                    1);
        if constexpr (NB == 2)
          wgmma_ss_mn(acc1, da,
                      sw128_desc(Bs + G::B_BYTES + kk * 16 * ROW_BYTES,
                                 BOX_BYTES), 1);
      }
      wgmma_commit();
      wgmma_wait1();  // the products on the previous stage are done
      reg_fence(acc0);
      if constexpr (NB == 2) reg_fence(acc1);
      if (kp > 0) release(it - 1);
    }
    wgmma_wait0();
    reg_fence(acc0);
    if constexpr (NB == 2) reg_fence(acc1);
    if (k_live > 0) release(it - 1);
    for (int kp = k_live; kp < nk; ++kp, ++it) {  // pads: wait and release
      mbar_wait(full + it % STAGES, (it / STAGES) & 1);
      release(it);
    }
    if (UP && k_live == 0) continue;  // pads only: nothing reads these rows

    // epilogue: the tile in bf16 into this warpgroup's out tile, swizzled;
    // rows past the fill are 0, rows and columns past the arrays clipped
    named_barrier(1 + wg, WG);  // the last store has read the out tile
    const int my_row = warp * 16 + lane / 4;  // and my_row + 8
    const int my_col = 2 * (lane % 4);        // within each 8 columns
#pragma unroll
    for (int i = 0; i < ACC; i += 2) {
      const int r = my_row + 8 * ((i / 2) % 2);
      const int c = 8 * (i / 4) + my_col;
      float v0 = acc0[i], v1 = acc0[i + 1];
      if constexpr (UP) {
        v0 = activate(act, v0);
        v1 = activate(act, v1);
        if constexpr (NB == 2) {
          v0 *= acc1[i];
          v1 *= acc1[i + 1];
        }
      }
      if (row0 + r >= live) v0 = v1 = 0.f;
      const int cc = c % PANEL;
      uint8_t* dst = Ow + (c / PANEL) * BOX_BYTES + r * ROW_BYTES +
                     (((cc / 8) ^ (r % 8)) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
    }
    fence_proxy_async();
    named_barrier(1 + wg, WG);
    if (t == 0) {
      for (int j = 0; j < NP; ++j)
        tma_store_4d(&tout, Ow + j * BOX_BYTES, n0 + j * PANEL, row0, e, 0);
      tma_store_wait();
    }
  }
}

// one launch of gmm_wgmma<G, NB, UP> over all its tiles
template <class G, int NB, bool UP>
cudaError_t launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb0,
                         const CUtensorMap& tb1, const CUtensorMap& tout,
                         void* out, const int* counts, int E, int M, int K,
                         int N, int act, cudaStream_t stream) {
  const size_t smem = G::template bytes<NB>();
  cudaError_t err = cudaFuncSetAttribute(
      gmm_wgmma<G, NB, UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long tiles = (long long)((N + G::BN - 1) / G::BN) *
                          ((M + G::BM - 1) / G::BM) * E;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const long long cap = G::PERSISTENT ? (long long)sms * G::MIN_BLOCKS
                                      : tiles;
  const int grid = (int)(tiles < cap ? tiles : cap);
  gmm_wgmma<G, NB, UP><<<grid, G::NT, smem, stream>>>(
      ta, tb0, tb1, tout, static_cast<__nv_bfloat16*>(out), counts, E, M, K,
      N, act);
  return cudaGetLastError();
}

template <class Up, class Down>
cudaError_t run_wgmma(const void* xe, const void* w1, const void* w3,
                      const void* w2, void* h, void* y, const int* counts,
                      int E, int C, int d, int f, int act,
                      cudaStream_t stream) {
  static_assert(Up::BM == Down::BM, "both launches tile the rows alike");
  CUtensorMap txe, tw1, tw3, th, tw2, ty;
  if (!make_map(&txe, xe, E, C, d) || !make_map(&tw1, w1, E, d, f) ||
      !make_map(&tw3, w3 != nullptr ? w3 : w1, E, d, f) ||
      !make_map(&th, h, E, C, f) || !make_map(&tw2, w2, E, f, d) ||
      !make_map(&ty, y, E, C, d))
    return cudaErrorInvalidValue;
  cudaError_t err =
      w3 != nullptr
          ? launch_wgmma<Up, 2, true>(txe, tw1, tw3, th, h, counts, E, C, d,
                                      f, act, stream)
          : launch_wgmma<Up, 1, true>(txe, tw1, tw1, th, h, counts, E, C, d,
                                      f, act, stream);
  if (err != cudaSuccess) return err;
  return launch_wgmma<Down, 1, false>(th, tw2, tw2, ty, y, counts, E, C, f,
                                      d, act, stream);
}

// The gate/up and the down launch of the scalar (float32) or the WMMA
// (bf16) route.
template <typename T>
cudaError_t run(const void* xe, const void* w1, const void* w3,
                const void* w2, void* h, void* y, const int* counts, int E,
                int C, int d, int f, int act, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xe);
  const T* W1 = static_cast<const T*>(w1);
  const T* W3 = static_cast<const T*>(w3);
  const T* W2 = static_cast<const T*>(w2);
  T* hid = static_cast<T*>(h);
  T* Y = static_cast<T*>(y);
  const int c_tiles = (C + BM - 1) / BM;
  const dim3 up_grid((f + BN - 1) / BN, c_tiles, E);
  const dim3 down_grid((d + BN - 1) / BN, c_tiles, E);
  if constexpr (sizeof(T) == 2) {
    auto aligned = [](const void* p) {
      return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    const bool al = aligned(xe) && aligned(w1) && aligned(w3) &&
                    aligned(w2) && aligned(h) && aligned(y);
    const int vec = al && d % 8 == 0 && f % 8 == 0;
    if (W3 != nullptr)
      gmm_wmma_kernel<2, true><<<up_grid, WT, 0, stream>>>(
          x, W1, W3, hid, counts, C, d, f, act, vec);
    else
      gmm_wmma_kernel<1, true><<<up_grid, WT, 0, stream>>>(
          x, W1, nullptr, hid, counts, C, d, f, act, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gmm_wmma_kernel<1, false><<<down_grid, WT, 0, stream>>>(
        hid, W2, nullptr, Y, counts, C, f, d, act, vec);
  } else {
    if (W3 != nullptr)
      gmm_kernel<T, 2, true><<<up_grid, NT, 0, stream>>>(
          x, W1, W3, hid, counts, C, d, f, act);
    else
      gmm_kernel<T, 1, true><<<up_grid, NT, 0, stream>>>(
          x, W1, nullptr, hid, counts, C, d, f, act);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gmm_kernel<T, 1, false><<<down_grid, NT, 0, stream>>>(
        hid, W2, nullptr, Y, counts, C, f, d, act);
  }
  return cudaGetLastError();
}

}  // namespace

// xe: (E, C, d); w1, w3: (E, d, f) (w3 may be null: no gate); w2: (E, f, d);
// h: (E, C, f) workspace; y: (E, C, d); all contiguous, of one dtype, on the
// current device; counts: int32 (E,) fills of the buckets, or null (every
// row live).  act: 0 silu, 1 tanh GELU, 2 squared ReLU.  route: 0 scalar
// float32, 1 WMMA bf16, 2 wgmma bf16 (d and f multiples of 8, every tensor
// 16-byte aligned).  Launches the gate/up and the down kernel on `stream`
// and returns cudaGetLastError() after them (0 on success), or the error
// that refused the inputs.
extern "C" int repro_moe_gmm_ffn(const void* xe, const void* w1,
                                 const void* w3, const void* w2, void* h,
                                 void* y, const void* counts, int E, int C,
                                 int d, int f, int act, int route,
                                 void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || act < kSilu || act > kRelu2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  if (route == kWgmmaBf16) {
    for (const void* p : {xe, w1, w3, w2, (const void*)h, (const void*)y})
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
    if (d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
    return (int)(C > DECODE_ROWS
                     ? run_wgmma<PrefillUpTile, PrefillDownTile>(
                           xe, w1, w3, w2, h, y, cnt, E, C, d, f, act, st)
                     : run_wgmma<DecodeUpTile, DecodeDownTile>(
                           xe, w1, w3, w2, h, y, cnt, E, C, d, f, act, st));
  }
  if (E > 65535 || (C + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (route == kScalarF32)
    return (int)run<float>(xe, w1, w3, w2, h, y, cnt, E, C, d, f, act, st);
  if (route == kWmmaBf16)
    return (int)run<__nv_bfloat16>(xe, w1, w3, w2, h, y, cnt, E, C, d, f,
                                   act, st);
  return (int)cudaErrorInvalidValue;
}
