// RG-LRU scan for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_rglru_kernel`, launched by `rglru_pallas`
// in src/repro/kernels/rglru_scan/kernel.py: the fused RG-LRU gates
//   log_a = -8 softplus(lam) sigmoid(ga),  a = exp(log_a),
//   b = sqrt(-expm1(2 log_a)) (sigmoid(gx) x),
// then the diagonal recurrence h_t = a_t h_{t-1} + b_t from h_{-1} = h0 (or
// zeros), writing every h_t to y (float32) and the last to h_last.  It
// computes what the plain version (ref.py) computes, for every shape: the
// TPU grid drops the rows, channels and steps past its 8 x 512 x 128 blocks,
// and its wrapper sends h0 to the reference; this kernel masks the channel
// tail itself, takes any B and S (S = 1 too) and takes h0.  With the gate
// biases b_a and b_i (float32, (D,)), ga and gx are the bias-free products
// and the kernel forms ga + b_a and gx + b_i in float32 before the sigmoids,
// bit for bit what PyTorch's promotion of a bf16 product and a float32 bias
// computes, so that the model's two bias adds (a float32 pass each over
// (B, S, D)) go and the gates are read in bf16.
//
// What bounds it on the H100: by its bytes, 48.9 us at recurrentgemma-9b's
// prefill (B 4, S 1000, D 4096, bf16 x, bf16 gate products and the biases
// fused: x, ga, gx read and y written once, 163.95 MB at 3.35 TB/s; 68.5 us,
// 229.46 MB, with float32 gates); in practice by its arithmetic.  Each
// element's gates cost two sigmoids, expm1 and sqrt, and on an H100 the two
// routes run 6% apart while their bytes differ by 40%
// (tools/rglru_variants.py).  So every element's gates are computed once;
// one expm1 gives both a = 1 + em and 1 - a^2 = -em (2 + em) (em =
// expm1(log_a); as accurate near a = 1 as -expm1(2 log_a), where 1 - a a
// would cancel); and the sigmoids take the SFU's exp and reciprocal (the
// kernel runs 16% longer with them to float32's last bit).  The loads
// overlap the arithmetic.
//
// Design: a windowed chunked scan inside a block.  A block owns DC channels
// of one batch row (a warp each 32 of them, lane = channel) and walks S in
// windows of W steps, carrying h across windows in registers.  Each
// window's x, ga and gx tile is staged in shared memory with cp.async, 16
// bytes a copy, STAGES windows deep, so that the next window loads while
// this one computes.  Within a window, P warps (per 32 channels) each own
// W / P consecutive steps:
//   pass 1: compute each step's (a, b) from the staged tile into registers,
//           and the segment's (A = prod a, as exp(sum log_a), H = its h
//           from 0);
//   carry:  every warp composes the P segments' (A, H) from the window's
//           incoming h ((A1, H1) then (A2, H2) is (A1 A2, A2 H1 + H2)),
//           which gives its own segment's h_in and the next window's h;
//   pass 2: h = a h + b from h_in over the segment's registers, storing y.
// So every input byte crosses HBM once, y is written once, and the gates
// are computed once.  The segment products are the one new rounding: as
// exp(sum log_a) it is one a segment, and a long memory (a near 1 over
// thousands of steps) lands closer to the float64 recurrence than the
// sequential order does, which rounds each a.  Block: W 64, P 8, DC 64
// (two warps across the channels, 512 threads, 128-byte rows of bf16); at
// the serving shape 256 blocks, two resident an SM (32 warps), each with
// one window in flight (24.6 KB with bf16 gates, 41 KB with float32).
// D not a multiple of 8, or a tensor off a 16-byte boundary, stages with
// plain loads instead (the same kernel, VEC false).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float RGLRU_C = 8.f;  // the paper's fixed temperature

// A block: DC channels of one batch row, windows of W steps cut into P
// segments, STAGES windows staged, MIN_BLOCKS resident an SM.
template <int W_, int P_, int DC_, int STAGES_, int MIN_BLOCKS_>
struct Config {
  static constexpr int W = W_, P = P_, DC = DC_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int L = W / P;         // steps a warp owns in a window
  static constexpr int GROUPS = DC / 32;  // warps across the channels
  static constexpr int THREADS = 32 * P * GROUPS;
  static_assert(W % P == 0 && DC % 32 == 0 && STAGES >= 2, "bad config");
};

using Block = Config<64, 8, 64, 2, 2>;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// sigmoid from the SFU's exp and reciprocal (a few ulp): its rounding
// reaches a only as |log_a| times its relative error (a near 1 has log_a
// near 0), and reaches b unamplified
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

// softplus as torch.nn.functional.softplus computes it (threshold 20)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// Stages rows [row0, row0 + rows) x channels [d0, d0 + DC) of a (rows, D)
// array into dst (W x DC, row-major); channels past D read as 0, rows past
// `rows` are left as they are (never read).  VEC: 16-byte cp.async copies
// (D a multiple of 8, the array on a 16-byte boundary); else plain loads.
template <class C, bool VEC, typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      long long row0, int rows, int D,
                                      int d0) {
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);     // elements a copy
    constexpr int CHUNKS = C::DC / PER;     // copies a row
    for (int k = threadIdx.x; k < rows * CHUNKS; k += C::THREADS) {
      const int r = k / CHUNKS, j = (k % CHUNKS) * PER;
      const bool in = d0 + j < D;
      const T* g = src + (row0 + r) * D + (in ? d0 + j : 0);
      __pipeline_memcpy_async(dst + r * C::DC + j, g, 16, in ? 0 : 16);
    }
  } else {
    for (int k = threadIdx.x; k < rows * C::DC; k += C::THREADS) {
      const int r = k / C::DC, j = k % C::DC;
      dst[k] = d0 + j < D ? src[(row0 + r) * D + d0 + j] : T(0.f);
    }
  }
}

template <class C, typename TX, typename TG, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
rglru_scan_kernel(const TX* __restrict__ x, const float* __restrict__ lam,
                  const TG* __restrict__ ga, const TG* __restrict__ gx,
                  const float* __restrict__ b_a,
                  const float* __restrict__ b_i,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, int S, int D, int tiles) {
  constexpr int W = C::W, P = C::P, DC = C::DC, L = C::L;
  constexpr int TILE = W * DC;
  extern __shared__ float4 smem4[];
  TX* sx = reinterpret_cast<TX*>(smem4);                  // [STAGES][W][DC]
  TG* sga = reinterpret_cast<TG*>(sx + C::STAGES * TILE);  // [STAGES][W][DC]
  TG* sgx = sga + C::STAGES * TILE;                        // [STAGES][W][DC]
  float2* sAH = reinterpret_cast<float2*>(sgx + C::STAGES * TILE);  // [P][DC]

  const int b = blockIdx.x / tiles;
  const int d0 = (blockIdx.x % tiles) * DC;
  const int warp = threadIdx.x / 32;
  const int seg = warp / C::GROUPS;                  // segment in a window
  const int c = (warp % C::GROUPS) * 32 + threadIdx.x % 32;  // tile channel
  const int d = d0 + c;
  const bool live = d < D;
  const long long row0 = (long long)b * S;           // row of (b, 0)
  const float coef = live ? -RGLRU_C * softplus(lam[d]) : 0.f;
  const float bias_a = live && b_a != nullptr ? b_a[d] : 0.f;
  const float bias_x = live && b_i != nullptr ? b_i[d] : 0.f;
  float carry = live && h0 != nullptr ? h0[(long long)b * D + d] : 0.f;

  const int windows = (S + W - 1) / W;
  auto stage_window = [&](int w) {  // one commit group a call
    if (w < windows) {
      const int s = w % C::STAGES, rows = min(W, S - w * W);
      const long long r = row0 + (long long)w * W;
      stage<C, VEC>(sx + s * TILE, x, r, rows, D, d0);
      stage<C, VEC>(sga + s * TILE, ga, r, rows, D, d0);
      stage<C, VEC>(sgx + s * TILE, gx, r, rows, D, d0);
    }
    __pipeline_commit();
  };
  for (int w = 0; w < C::STAGES - 1; ++w) stage_window(w);

  for (int w = 0; w < windows; ++w) {
    // window w has landed, and every warp is done with window w - 1
    __pipeline_wait_prior(C::STAGES - 2);
    __syncthreads();
    stage_window(w + C::STAGES - 1);  // into window w - 1's buffer
    const int s = w % C::STAGES;
    const int r0 = seg * L;                  // the segment's first row
    const int t0 = w * W + r0;               // and its step
    const TX* tx = sx + s * TILE + r0 * DC + c;
    const TG* tga = sga + s * TILE + r0 * DC + c;
    const TG* tgx = sgx + s * TILE + r0 * DC + c;

    // pass 1: (a, b) of each step, the segment's (prod a, h from 0), the
    // product as exp(sum log_a): one rounding, where a product of the a's
    // rounds once a step on top of each a's own
    float a[L], bb[L];
    float sum_log_a = 0.f, H = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      a[i] = 1.f;
      bb[i] = 0.f;
      if (t0 + i < S) {
        const float log_a =
            coef * sigmoid(to_f32(tga[i * DC]) + bias_a);
        const float em = expm1f(log_a);     // a - 1, so 1 - a^2 = -em (2 + em)
        a[i] = 1.f + em;
        bb[i] = sqrtf(-em * (2.f + em)) *
                (sigmoid(to_f32(tgx[i * DC]) + bias_x) * to_f32(tx[i * DC]));
        H = fmaf(a[i], H, bb[i]);
        sum_log_a += log_a;
      }
    }
    sAH[seg * DC + c] = make_float2(expf(sum_log_a), H);
    __syncthreads();

    // carry: compose the segments from the window's incoming h
    float h = carry, h_in = carry;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q == seg) h_in = h;
      const float2 e = sAH[q * DC + c];
      h = fmaf(e.x, h, e.y);
    }
    carry = h;

    // pass 2: the recurrence over the segment from its h_in
    h = h_in;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      if (t0 + i < S) {
        h = fmaf(a[i], h, bb[i]);
        if (live) y[(row0 + t0 + i) * D + d] = h;
      }
    }
    // the segment holding step S - 1 writes h_last: y's last row exactly
    if (live && t0 < S && S <= t0 + L) h_last[(long long)b * D + d] = h;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <class C, typename TX, typename TG>
cudaError_t launch(const void* x, const void* lam, const void* ga,
                   const void* gx, const void* b_a, const void* b_i,
                   const void* h0, void* y, void* h_last, int B, int S, int D,
                   cudaStream_t stream) {
  const int tiles = (D + C::DC - 1) / C::DC;
  const long long blocks = (long long)B * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)C::STAGES * C::W * C::DC * (sizeof(TX) + 2 * sizeof(TG)) +
      (size_t)C::P * C::DC * sizeof(float2);
  const bool vec = D % 8 == 0 && aligned16(x) && aligned16(ga) &&
                   aligned16(gx);
  auto kern = vec ? rglru_scan_kernel<C, TX, TG, true>
                  : rglru_scan_kernel<C, TX, TG, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)blocks, C::THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(lam),
      static_cast<const TG*>(ga), static_cast<const TG*>(gx),
      static_cast<const float*>(b_a), static_cast<const float*>(b_i),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), S, D, tiles);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_g(const void* x, const void* lam, const void* ga,
                       const void* gx, const void* b_a, const void* b_i,
                       const void* h0, void* y, void* h_last, int B, int S,
                       int D, int g_dtype, cudaStream_t st) {
  if (g_dtype == 0)
    return launch<Block, TX, float>(x, lam, ga, gx, b_a, b_i, h0, y, h_last,
                                    B, S, D, st);
  if (g_dtype == 1)
    return launch<Block, TX, __nv_bfloat16>(x, lam, ga, gx, b_a, b_i, h0, y,
                                            h_last, B, S, D, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, S, D), ga and gx: (B, S, D) of one dtype, lam: (D,) float32, b_a
// and b_i: (D,) float32 gate biases or both null (ga and gx then hold the
// whole gate pre-activations), h0: (B, D) float32 or null (zeros); y: (B, S,
// D) float32, h_last: (B, D) float32.  All contiguous, on the current
// device.  x_dtype and g_dtype: 0 float32, 1 bf16.  Launches on `stream`
// and returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_rglru_scan(const void* x, const void* lam,
                                const void* ga, const void* gx,
                                const void* b_a, const void* b_i,
                                const void* h0, void* y, void* h_last, int B,
                                int S, int D, int x_dtype, int g_dtype,
                                void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || (b_a == nullptr) != (b_i == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)dispatch_g<float>(x, lam, ga, gx, b_a, b_i, h0, y, h_last, B,
                                  S, D, g_dtype, st);
  if (x_dtype == 1)
    return (int)dispatch_g<__nv_bfloat16>(x, lam, ga, gx, b_a, b_i, h0, y,
                                          h_last, B, S, D, g_dtype, st);
  return (int)cudaErrorInvalidValue;
}
