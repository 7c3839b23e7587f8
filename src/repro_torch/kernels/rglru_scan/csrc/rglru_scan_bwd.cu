// RG-LRU scan backward for Hopper (sm_90a), hand-written CUDA C++.
//
// The gradient of the forward in rglru_scan.cu.  The TPU kernel it stands
// beside, `_rglru_kernel` (`rglru_pallas` in
// src/repro/kernels/rglru_scan/kernel.py), has no backward of its own: the
// reference trains through jax.grad of its plain recurrence.  Here it is
// the plain backward of ref.py (`reference_rglru_bwd`) as a kernel.  With
// u = sigmoid(ga + b_a), sp = softplus(lam), log_a = -8 sp u, a = exp(log_a),
// beta = sqrt(-expm1(2 log_a)), i = sigmoid(gx + b_i):
//
//   g_t     = dy_t + a_{t+1} g_{t+1}        (g_{S-1} also takes dh_last)
//   dlog_a  = g_t h_{t-1} a - g_t i x a^2 / beta    (h_{-1} = h0 or 0)
//   dga     = dlog_a (-8 sp) u (1 - u),    dgx = g_t beta x i (1 - i),
//   dx      = g_t beta i,                   dh0 = a_0 g_0,
//   dlam    = sigmoid(lam) sum_{B,S} dlog_a (-8 u),
//   db_a, db_i = sum_{B,S} dga, dgx        (float32, before dga and dgx are
//                                            rounded to ga's dtype)
//
// What bounds it on the H100: its bytes.  x, ga, gx, the forward's y
// (float32) and dy (float32) are read and dx, dga, dgx written once: at
// recurrentgemma-9b's training shape (B 1, S 4096, D 4096, bf16) 20 bytes an
// element, 336 MB, 0.1 ms at 3.35 TB/s.  Its gates (two sigmoids, expm1 and
// a reciprocal square root an element) come close behind, as in the
// forward.
//
// Design: a windowed reverse scan, the forward's design run backwards.  The
// carry is a linear recurrence too, c_t = a_t (dy_t + c_{t+1}) with c_S =
// dh_last and g_t = dy_t + c_{t+1}.
//  * A block owns DC channels of one batch row (a warp each 32 of them,
//    lane = channel) and walks all of S backwards in windows of W steps,
//    carrying c across windows in registers.  Each window's x, ga, gx, dy
//    and h_{t-1} (y's rows shifted by one; h0, or 0, before step 0) are
//    staged in shared memory with cp.async, 16 bytes a copy, STAGES windows
//    deep, so that the next (earlier) window loads while this one computes.
//  * Within a window, P warps (per 32 channels) each own W / P consecutive
//    steps.  Pass 1 computes each step's gates once, from one expm1 (a = 1 +
//    em, 1 - a^2 = -em (2 + em), 1 / beta by rsqrt of it and beta as bsq
//    rsqrt(bsq)), keeps in registers what pass 2 needs (a and the factors
//    that turn g into dx, dga, dgx and dlam's term), and forms the
//    segment's reverse pair (A = prod a, as exp(sum log_a), C = its carry
//    out from 0).  The segments are composed in shared memory from the
//    window's incoming carry, last segment first, giving each its carry in
//    and the next window's carry.  Pass 2 runs g over the segment's
//    registers and writes dx, dga, dgx; dlam's, db_a's and db_i's terms go
//    to per-thread float32 sums.  The block's last carry is dh0.
//  * The sums: each block sums its segments' in order and writes one
//    partial per (b, channel); a last launch sums the B partials of each
//    channel in order.  No atomics: the same inputs give the same bits.
// So every input is read once, and the gates computed once.
// The block (tools/rglru_bwd_variants.py measured the choices at
// recurrentgemma-9b's training shape on an H100): DC 32 channels, P 16
// warps, one block an SM with ~90-120 registers a thread (at 64, two
// blocks an SM, it spills and runs 10-30% longer); bf16 gates in windows
// of 128 steps, 2 stages (122 KB of shared memory), float32 gates in
// windows of 64, 3 stages (130 KB), each the faster for its dtype by
// 12-20%.  At that shape the B * D / 32 = 128 blocks fill the card in one
// wave.  Cutting S into spans across more blocks (each span's carry in
// from a light first pass over ga and dy) ran 35% longer there (2 or 4
// spans a row); it wins only where few channel tiles leave SMs idle (D
// 1024), a width no RG-LRU model has, so it stays a variant of the tool.
// The gates' arithmetic: expm1 by a series or the SFU's exp, and beta as
// bsq rsqrt(bsq), took 7-11% off bf16 but made float32 up to 12% slower
// (its time moved 5-12% with every change to its code, and with the
// sigmoids exact too it ran 9% faster than committed).  One arithmetic
// serves both dtypes, so that the float32 route checks the bf16 route's
// formulas; float32 stays faster than the four-pass kernel it replaced.  D not a multiple of 8, or a tensor off a 16-byte boundary,
// stages with plain loads instead (the same kernel, VEC false).  All
// arithmetic is float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float RGLRU_C = 8.f;  // the paper's fixed temperature

// A block of the main pass: DC channels of one batch row,
// windows of W steps cut into P segments, STAGES windows staged,
// MIN_BLOCKS resident an SM.
template <int W_, int P_, int DC_, int STAGES_, int MIN_BLOCKS_>
struct Config {
  static constexpr int W = W_, P = P_, DC = DC_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int L = W / P;         // steps a warp owns in a window
  static constexpr int GROUPS = DC / 32;  // warps across the channels
  static constexpr int THREADS = 32 * P * GROUPS;
  static_assert(W % P == 0 && DC % 32 == 0 && STAGES >= 2, "bad config");
};

// the block by the gates' dtype; both DC 32, and BlockF32's W the smaller
using BlockBf16 = Config<128, 16, 32, 2, 1>;
using BlockF32 = Config<64, 16, 32, 3, 1>;
constexpr int NT_REDUCE = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// sigmoid from the SFU's exp and reciprocal (a few ulp), as the forward's
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

// expm1 from a 6-term series where |x| < 0.25 (under an ulp there: a near
// 1, where 1 - a^2 = -em (2 + em) needs em to the last bit), else from the
// SFU's exp (a few 1e-7 relative to em, which is then beyond -0.22)
__device__ __forceinline__ float expm1_fast(float x) {
  if (fabsf(x) < 0.25f)
    return x * fmaf(x, fmaf(x, fmaf(x, fmaf(x, fmaf(x, 1.f / 720.f,
        1.f / 120.f), 1.f / 24.f), 1.f / 6.f), 0.5f), 1.f);
  return __expf(x) - 1.f;
}

// softplus as torch.nn.functional.softplus computes it (threshold 20)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// Stages rows [row0, row0 + rows) x channels [d0, d0 + DC) of a (rows, D)
// array into dst (rows x DC, row-major); channels past D read as 0, rows
// past `rows` are left as they are (never read).  VEC: 16-byte cp.async
// copies (D a multiple of 8, the array on a 16-byte boundary); else plain
// loads.
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
      dst[k] = d0 + j < D ? src[(row0 + r) * D + d0 + j]
                          : from_f32<T>(0.f);
    }
  }
}

// The main pass: every gradient of one (b, channel tile), and the tile's
// partial sums of dlam (without its factor -8 sigmoid(lam)), db_a and db_i
// in part[b][3][D].
template <class C, typename TX, typename TG, bool VEC>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
rglru_bwd_kernel(const TX* __restrict__ x, const float* __restrict__ lam,
                 const TG* __restrict__ ga, const TG* __restrict__ gx,
                 const float* __restrict__ b_a,
                 const float* __restrict__ b_i,
                 const float* __restrict__ h0, const float* __restrict__ y,
                 const float* __restrict__ dy,
                 const float* __restrict__ dh_last,
                 float* __restrict__ part, TX* __restrict__ dx,
                 TG* __restrict__ dga, TG* __restrict__ dgx,
                 float* __restrict__ dh0, int S, int D, int tiles) {
  constexpr int W = C::W, P = C::P, DC = C::DC, L = C::L;
  constexpr int TILE = W * DC;
  extern __shared__ float4 smem4[];
  float* sy = reinterpret_cast<float*>(smem4);        // [STAGES][W][DC]
  float* sdy = sy + C::STAGES * TILE;                 // [STAGES][W][DC]
  TX* sx = reinterpret_cast<TX*>(sdy + C::STAGES * TILE);
  TG* sga = reinterpret_cast<TG*>(sx + C::STAGES * TILE);
  TG* sgx = sga + C::STAGES * TILE;
  float2* sAC = reinterpret_cast<float2*>(sgx + C::STAGES * TILE);  // [P][DC]
  float* sSum = reinterpret_cast<float*>(sAC + P * DC);          // [3][P][DC]

  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const int d0 = tile * DC;
  const int warp = threadIdx.x / 32;
  const int seg = warp / C::GROUPS;                  // segment in a window
  const int c = (warp % C::GROUPS) * 32 + threadIdx.x % 32;  // tile channel
  const int d = d0 + c;
  const bool live = d < D;
  const long long row0 = (long long)b * S;           // row of (b, 0)
  const float coef = live ? -RGLRU_C * softplus(lam[d]) : 0.f;
  const float bias_a = live && b_a != nullptr ? b_a[d] : 0.f;
  const float bias_x = live && b_i != nullptr ? b_i[d] : 0.f;
  // the carry into step S - 1
  float carry = live && dh_last != nullptr ? dh_last[(long long)b * D + d]
                                           : 0.f;

  const int n = (S + W - 1) / W;  // windows
  auto stage_window = [&](int j) {  // the j-th walked; one commit group
    if (j < n) {
      const int s = j % C::STAGES, t0 = (n - 1 - j) * W;
      const int rows = min(W, S - t0);
      const long long r = row0 + t0;
      stage<C, VEC>(sx + s * TILE, x, r, rows, D, d0);
      stage<C, VEC>(sga + s * TILE, ga, r, rows, D, d0);
      stage<C, VEC>(sgx + s * TILE, gx, r, rows, D, d0);
      stage<C, VEC>(sdy + s * TILE, dy, r, rows, D, d0);
      // h_{t-1} of the window's steps: y's rows t0 - 1 .. t0 + rows - 2,
      // and h0 (or 0) before step 0
      if (t0 > 0) {
        stage<C, VEC>(sy + s * TILE, y, r - 1, rows, D, d0);
      } else {
        stage<C, VEC>(sy + s * TILE + DC, y, r, rows - 1, D, d0);
        for (int i = threadIdx.x; i < DC; i += C::THREADS)
          sy[s * TILE + i] = h0 != nullptr && d0 + i < D
                                 ? h0[(long long)b * D + d0 + i] : 0.f;
      }
    }
    __pipeline_commit();
  };
  for (int j = 0; j < C::STAGES - 1; ++j) stage_window(j);

  float s_lam = 0.f, s_a = 0.f, s_i = 0.f;
  for (int j = 0; j < n; ++j) {
    // window j has landed, and every warp is done with window j - 1
    __pipeline_wait_prior(C::STAGES - 2);
    __syncthreads();
    stage_window(j + C::STAGES - 1);  // into window j - 1's buffer
    const int s = j % C::STAGES;
    const int r0 = seg * L;                          // the segment's first row
    const int t0 = (n - 1 - j) * W + r0;             // and its step
    const int o = s * TILE + r0 * DC + c;
    const TX* tx = sx + o;
    const TG* tga = sga + o;
    const TG* tgx = sgx + o;
    const float* ty = sy + o;
    const float* tdy = sdy + o;

    // pass 1: each step's gates, once, into what pass 2 needs, and the
    // segment's (A as exp(sum log_a), C = its carry out from 0)
    float a[L], kl[L], ka[L], kx[L], ki[L];
    float sum_log_a = 0.f, cc = 0.f;
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      a[i] = 1.f;
      kl[i] = ka[i] = kx[i] = ki[i] = 0.f;
      if (t0 + i < S) {
        const float u = sigmoid(to_f32(tga[i * DC]) + bias_a);
        const float log_a = coef * u;
        const float em = expm1_fast(log_a);  // a - 1: 1 - a^2 = -em (2 + em)
        const float bsq = -em * (2.f + em);
        const float rb = rsqrtf(bsq);         // 1 / beta
        const float ai = 1.f + em;
        const float ig = sigmoid(to_f32(tgx[i * DC]) + bias_x);
        const float xv = to_f32(tx[i * DC]);
        // dlog_a / g = h_{t-1} a - i x a^2 / beta
        const float p = ty[i * DC] * ai - ig * xv * ai * ai * rb;
        a[i] = ai;
        kl[i] = p * u;                       // dlog_a (-8 u) = -8 g kl
        ka[i] = kl[i] * coef * (1.f - u);    // d(ga + b_a) = g ka
        // dx = g kx, beta = bsq / sqrt(bsq), and 0 at a = 1 (bsq 0), as the
        // plain version's sqrt gives
        kx[i] = (bsq > 0.f ? bsq * rb : 0.f) * ig;
        ki[i] = kx[i] * xv * (1.f - ig);     // d(gx + b_i) = g ki
        cc = ai * (tdy[i * DC] + cc);
        sum_log_a += log_a;
      }
    }
    sAC[seg * DC + c] = make_float2(expf(sum_log_a), cc);
    __syncthreads();

    // carry: compose the segments from the window's incoming carry, the
    // last first
    float c_in = carry;
    cc = carry;
#pragma unroll
    for (int q = P - 1; q >= 0; --q) {
      if (q == seg) c_in = cc;
      const float2 e = sAC[q * DC + c];
      cc = fmaf(e.x, cc, e.y);
    }
    carry = cc;

    // pass 2: g over the segment from its carry in, and every gradient
    cc = c_in;
#pragma unroll
    for (int i = L - 1; i >= 0; --i) {
      if (t0 + i < S) {
        const float g = tdy[i * DC] + cc;
        const float vga = g * ka[i], vgx = g * ki[i];
        if (live) {
          const long long e = (row0 + t0 + i) * D + d;
          dx[e] = from_f32<TX>(g * kx[i]);
          dga[e] = from_f32<TG>(vga);
          dgx[e] = from_f32<TG>(vgx);
        }
        s_lam = fmaf(g, kl[i], s_lam);
        s_a += vga;
        s_i += vgx;
        cc = a[i] * g;
      }
    }
  }
  // the carry out of step 0 is dh0 = a_0 g_0
  if (seg == 0 && live && dh0 != nullptr)
    dh0[(long long)b * D + d] = carry;

  // the block's partial sums, its segments in order
  sSum[(0 * P + seg) * DC + c] = s_lam;
  sSum[(1 * P + seg) * DC + c] = s_a;
  sSum[(2 * P + seg) * DC + c] = s_i;
  __syncthreads();
  if (seg == 0 && live) {
    const long long o = (long long)b * 3 * D + d;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      float t = 0.f;
      for (int q = 0; q < P; ++q) t += sSum[(v * P + q) * DC + c];
      part[o + v * D] = t;
    }
  }
}

// The per-channel sums over the B partials, in order
__global__ void __launch_bounds__(NT_REDUCE)
rglru_bwd_reduce_kernel(const float* __restrict__ part,
                        const float* __restrict__ lam,
                        float* __restrict__ dlam, float* __restrict__ db_a,
                        float* __restrict__ db_i, int D, int n_parts) {
  const int d = blockIdx.x * NT_REDUCE + threadIdx.x;
  if (d >= D) return;
  float s_lam = 0.f, s_a = 0.f, s_i = 0.f;
  for (int k = 0; k < n_parts; ++k) {
    const float* p = part + (long long)k * 3 * D + d;
    s_lam += p[0];
    s_a += p[D];
    s_i += p[2 * D];
  }
  dlam[d] = -RGLRU_C * s_lam / (1.f + expf(-lam[d]));
  if (db_a != nullptr) db_a[d] = s_a;
  if (db_i != nullptr) db_i[d] = s_i;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the workspace's floats: the blocks' partials (B * 3 * D)
long long ws_floats(int B, int S, int D) { return 3LL * B * D; }

template <class C, typename TX, typename TG>
cudaError_t launch(const void* x, const float* lam, const void* ga,
                   const void* gx, const float* b_a, const float* b_i,
                   const float* h0, const float* y, const float* dy,
                   const float* dh_last, float* ws, void* dx, void* dga,
                   void* dgx, float* dlam, float* db_a, float* db_i,
                   float* dh0, int B, int S, int D, cudaStream_t st) {
  const int tiles = (D + C::DC - 1) / C::DC;
  const long long blocks = (long long)B * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  float* part = ws;
  const size_t smem =
      (size_t)C::STAGES * C::W * C::DC *
          (2 * sizeof(float) + sizeof(TX) + 2 * sizeof(TG)) +
      (size_t)C::P * C::DC * (sizeof(float2) + 3 * sizeof(float));
  const bool vec = D % 8 == 0 && aligned16(x) && aligned16(ga) &&
                   aligned16(gx) && aligned16(y) && aligned16(dy);
  auto kern = vec ? rglru_bwd_kernel<C, TX, TG, true>
                  : rglru_bwd_kernel<C, TX, TG, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)blocks, C::THREADS, smem, st>>>(
      static_cast<const TX*>(x), lam, static_cast<const TG*>(ga),
      static_cast<const TG*>(gx), b_a, b_i, h0, y, dy, dh_last, part,
      static_cast<TX*>(dx), static_cast<TG*>(dga), static_cast<TG*>(dgx),
      dh0, S, D, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_reduce_kernel<<<(unsigned)((D + NT_REDUCE - 1) / NT_REDUCE),
                            NT_REDUCE, 0, st>>>(
      part, lam, dlam, db_a, db_i, D, B);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_g(const void* x, const float* lam, const void* ga,
                       const void* gx, const float* b_a, const float* b_i,
                       const float* h0, const float* y, const float* dy,
                       const float* dh_last, float* ws, void* dx, void* dga,
                       void* dgx, float* dlam, float* db_a, float* db_i,
                       float* dh0, int B, int S, int D, int g_dtype,
                       cudaStream_t st) {
  if (g_dtype == 0)
    return launch<BlockF32, TX, float>(x, lam, ga, gx, b_a, b_i, h0, y, dy,
                                       dh_last, ws, dx, dga, dgx, dlam, db_a,
                                       db_i, dh0, B, S, D, st);
  if (g_dtype == 1)
    return launch<BlockBf16, TX, __nv_bfloat16>(
        x, lam, ga, gx, b_a, b_i, h0, y, dy, dh_last, ws, dx, dga, dgx, dlam,
        db_a, db_i, dh0, B, S, D, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the float32 workspace repro_rglru_scan_bwd needs.
extern "C" long long repro_rglru_scan_bwd_workspace_bytes(int B, int S,
                                                          int D) {
  return 4 * ws_floats(B, S, D);
}

// x: (B, S, D), ga and gx: (B, S, D) of one dtype, lam: (D,), b_a and b_i:
// (D,) or both null, h0: (B, D) or null, as the forward took them; y: the
// forward's (B, S, D) float32 output; dy: (B, S, D) float32; dh_last: (B,
// D) float32 or null (zero); ws: the workspace
// (repro_rglru_scan_bwd_workspace_bytes).  Writes dx (x's dtype), dga and
// dgx (ga's dtype), dlam (D,) float32, db_a and db_i (D,) float32 when the
// biases are given, and dh0 (B, D) float32 unless it is null.  All
// contiguous, on the current device.  x_dtype and g_dtype: 0 float32, 1
// bf16.  Launches two kernels on `stream` and returns
// cudaGetLastError() after them (0 on success).
extern "C" int repro_rglru_scan_bwd(
    const void* x, const void* lam, const void* ga, const void* gx,
    const void* b_a, const void* b_i, const void* h0, const void* y,
    const void* dy, const void* dh_last, void* ws, void* dx, void* dga,
    void* dgx, void* dlam, void* db_a, void* db_i, void* dh0, int B, int S,
    int D, int x_dtype, int g_dtype, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0 || (b_a == nullptr) != (b_i == nullptr) ||
      (b_a == nullptr) != (db_a == nullptr) ||
      (b_i == nullptr) != (db_i == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_lam = static_cast<const float*>(lam);
  const float* f_ba = static_cast<const float*>(b_a);
  const float* f_bi = static_cast<const float*>(b_i);
  const float* f_h0 = static_cast<const float*>(h0);
  const float* f_y = static_cast<const float*>(y);
  const float* f_dy = static_cast<const float*>(dy);
  const float* f_dhl = static_cast<const float*>(dh_last);
  float* f_ws = static_cast<float*>(ws);
  float* f_dlam = static_cast<float*>(dlam);
  float* f_dba = static_cast<float*>(db_a);
  float* f_dbi = static_cast<float*>(db_i);
  float* f_dh0 = static_cast<float*>(dh0);
  if (x_dtype == 0)
    return (int)dispatch_g<float>(x, f_lam, ga, gx, f_ba, f_bi, f_h0, f_y,
                                  f_dy, f_dhl, f_ws, dx, dga, dgx, f_dlam,
                                  f_dba, f_dbi, f_dh0, B, S, D, g_dtype, st);
  if (x_dtype == 1)
    return (int)dispatch_g<__nv_bfloat16>(
        x, f_lam, ga, gx, f_ba, f_bi, f_h0, f_y, f_dy, f_dhl, f_ws, dx, dga,
        dgx, f_dlam, f_dba, f_dbi, f_dh0, B, S, D, g_dtype, st);
  return (int)cudaErrorInvalidValue;
}
