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
// and y is written in the input dtype.
//
// What bounds it on the H100: 6*E*C*d*f FLOPs against the weights
// (3*E*d*f) plus xe and y.  At granite-moe's prefill (E 40, C 1000, d 1536,
// f 512, bf16) that is 188.7 GFLOP and 435 MB: the tensor-core bound is
// 0.19 ms.  At its decode (C 8) it is 1.5 GFLOP and 191 MB of weights: the
// memory bound is 0.057 ms.  This first version reaches neither: bf16 runs
// on the tensor cores through WMMA fragments (the pre-Hopper `mma.sync`
// path, fed by plain loads through shared memory, one stage at a time), and
// float32 on scalar FMAs.  `wgmma` on tiles fed by TMA with a pipeline of
// stages, and skipping experts whose bucket holds only pad rows, are the
// steps toward the bound.
//
// Design.  The TPU kernel keeps a (block_c, d) float32 accumulator resident
// across the f-blocks, so that h never reaches HBM.  At d 1536 and block_c
// 128 that tile is 768 KiB, at mixtral's d 4096 it is 2 MiB: an H100 SM has
// 228 KB of shared memory.  So the work is split into two launches of one
// tiled product kernel, and h goes through an (E, C, f) workspace in HBM
// (2 * E*C*f * sizeof(T) of extra traffic: 82 MB per granite prefill layer):
//  * gate/up: grid (f-tiles, C-tiles, E); out = act(xe @ w1) * (xe @ w3),
//    both products sharing the staged xe tile;
//  * down:    grid (d-tiles, C-tiles, E); y = h @ w2.
// Each block computes a 64 x 64 output tile, looping over the depth in
// stages of 32 staged in shared memory (float32: 256 threads, each a 4 x 4
// sub-tile of scalar FMAs; bf16: 4 warps of WMMA fragments).  Rows, columns
// and depth past the array's edge are masked (loaded as zeros, never
// stored), so any C, d and f run: no shape goes to the plain version.  Pad
// rows of xe (zeros) are computed like any other row, as on the TPU:
// act(0) * 0 = 0; only whole warps or threads whose rows all lie past C
// skip their products.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

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

enum Act { kSilu = 0, kGeluTanh = 1, kRelu2 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float activate(int act, float x) {
  if (act == kSilu) return x / (1.f + expf(-x));
  if (act == kGeluTanh) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  const float r = fmaxf(x, 0.f);
  return r * r;
}

// float32.  For expert blockIdx.z: acc_b = A (M x K) @ B_b (K x N), b < NB,
// all row-major and contiguous per expert.  UP: out = act(acc_0) [* acc_1];
// otherwise out = acc_0.  out is (M x N) per expert, in T.
template <typename T, int NB, bool UP>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ A, const T* __restrict__ B0,
           const T* __restrict__ B1, T* __restrict__ out, int M, int K,
           int N, int act) {
  __shared__ __align__(16) float As[BK][AS];      // transposed: As[k][m]
  __shared__ __align__(16) float Bs[NB][BK][BN];

  const long long e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
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

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK): neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int t = 0; t < BM * BK / NT; ++t) {
      const int i = tid + t * NT;
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K) ? to_f32(A[(long long)m * K + k]) : 0.f;
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

    // threads whose rows all lie past M skip the FMAs (at decode a bucket
    // holds 8 rows of the tile's 64)
    if (m0 + ty * TM < M) {
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
      out[(long long)m * N + n] = from_f32<T>(v);
    }
  }
}

// bf16: the same tile product on the tensor cores (WMMA, 16 x 16 x 16 bf16
// fragments, float32 accumulation).  128 threads: warp w computes the 32 x 32
// quarter (w / 2, w % 2) of the 64 x 64 tile as 2 x 2 fragments per B matrix.
// Tiles are staged in shared memory as bf16 (16-byte loads where K and N are
// multiples of 8, element loads with masking otherwise); after the depth
// loop the accumulators go through shared memory (float32, reusing the tile
// buffers) to the same epilogue as above.
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
                __nv_bfloat16* __restrict__ out, int M, int K, int N, int act,
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
  A += e * M * K;
  out += e * M * N;
  const __nv_bfloat16* B[NB];
  B[0] = B0 + e * K * N;
  if constexpr (NB == 2) B[1] = B1 + e * K * N;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = (warp / 2) * 32;  // the warp's rows and columns in the tile
  const int wn = (warp % 2) * 32;
  const bool rows_live = m0 + wm < M;  // else the warp's rows all lie past M

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][2][2];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[b][i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile (BM x BK) and B tiles (BK x BN): 256 runs of 8 each
#pragma unroll
    for (int t = 0; t < BM * BK / 8 / WT; ++t) {
      const int v = tid + t * WT;
      const int r = v / (BK / 8), c = v % (BK / 8) * 8;
      load8(&As[r][c], A, m0 + r, M, k0 + c, K, vec);
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

  if (rows_live)
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
    out[(long long)m * N + n] = __float2bfloat16(x);
  }
}

// The gate/up and the down launch for one dtype: the scalar kernel for
// float32, the WMMA kernel for bf16.
template <typename T>
cudaError_t run(const void* xe, const void* w1, const void* w3,
                const void* w2, void* h, void* y, int E, int C, int d, int f,
                int act, cudaStream_t stream) {
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
    const int vec_up = al && d % 8 == 0 && f % 8 == 0;
    const int vec_down = al && f % 8 == 0 && d % 8 == 0;
    if (W3 != nullptr)
      gmm_wmma_kernel<2, true><<<up_grid, WT, 0, stream>>>(
          x, W1, W3, hid, C, d, f, act, vec_up);
    else
      gmm_wmma_kernel<1, true><<<up_grid, WT, 0, stream>>>(
          x, W1, nullptr, hid, C, d, f, act, vec_up);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gmm_wmma_kernel<1, false><<<down_grid, WT, 0, stream>>>(
        hid, W2, nullptr, Y, C, f, d, act, vec_down);
  } else {
    if (W3 != nullptr)
      gmm_kernel<T, 2, true><<<up_grid, NT, 0, stream>>>(
          x, W1, W3, hid, C, d, f, act);
    else
      gmm_kernel<T, 1, true><<<up_grid, NT, 0, stream>>>(
          x, W1, nullptr, hid, C, d, f, act);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gmm_kernel<T, 1, false><<<down_grid, NT, 0, stream>>>(
        hid, W2, nullptr, Y, C, f, d, act);
  }
  return cudaGetLastError();
}

}  // namespace

// xe: (E, C, d); w1, w3: (E, d, f) (w3 may be null: no gate); w2: (E, f, d);
// h: (E, C, f) workspace; y: (E, C, d); all contiguous, of one dtype
// (0 float32, 1 bf16), on the current device.  act: 0 silu, 1 tanh GELU,
// 2 squared ReLU.  Launches the gate/up and the down kernel on `stream` and
// returns cudaGetLastError() after them (0 on success).
extern "C" int repro_moe_gmm_ffn(const void* xe, const void* w1,
                                 const void* w3, const void* w2, void* h,
                                 void* y, int E, int C, int d, int f, int act,
                                 int dtype, void* stream) {
  if (E <= 0 || C <= 0 || d <= 0 || f <= 0 || E > 65535 ||
      (C + BM - 1) / BM > 65535 || act < kSilu || act > kRelu2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)run<float>(xe, w1, w3, w2, h, y, E, C, d, f, act, st);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(xe, w1, w3, w2, h, y, E, C, d, f, act,
                                   st);
  return (int)cudaErrorInvalidValue;
}
