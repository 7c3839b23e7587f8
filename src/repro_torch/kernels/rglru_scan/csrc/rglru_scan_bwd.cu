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
// element, 336 MB, 0.1 ms at 3.35 TB/s.
//
// Design: the reverse carry g is a linear recurrence too, c_t = a_t (dy_t +
// c_{t+1}) with c_S = dh_last and g_t = dy_t + c_{t+1}, so it is cut into
// chunks of CH steps as a scan:
//  1. chunk:  one thread per (b, chunk, channel) walks its chunk backwards
//             from c = 0, giving the chunk's (A = prod a, as exp(sum log_a),
//             and its carry out from 0);
//  2. carry:  one thread per (b, channel) composes the chunks from the last
//             (c_in of each chunk, and dh0 = the carry out of chunk 0);
//  3. grads:  one thread per (b, chunk, channel) walks its chunk backwards
//             again from its c_in, computes every gradient of the step, and
//             sums its dlam, db_a and db_i terms into a partial per (b,
//             chunk, channel);
//  4. reduce: one thread per channel sums the B * chunks partials in a
//             fixed order (no atomics: the same inputs give the same bits).
// Neighbouring threads own neighbouring channels, so every load and store
// of a step is coalesced; at the training shape 262,144 threads walk 64
// steps each.  Passes 1 and 3 both read ga and dy (and recompute a), about
// 1.3x the bound's bytes.  All arithmetic is float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float RGLRU_C = 8.f;  // the paper's fixed temperature
constexpr int CH = 64;          // steps per chunk
constexpr int NT = 128;         // threads per block: channels of one chunk

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

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// softplus as torch.nn.functional.softplus computes it (threshold 20)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// (b, chunk, channel) of this thread; false past D
struct Cell {
  int b, chunk, d, t0, t1;
  long long row0;  // row of (b, 0)
};

__device__ __forceinline__ bool cell(Cell& c, int S, int D, int n_chunks,
                                     int tiles) {
  const int blk = blockIdx.x;
  c.d = (blk % tiles) * NT + threadIdx.x;
  c.chunk = blk / tiles % n_chunks;
  c.b = blk / tiles / n_chunks;
  c.t0 = c.chunk * CH;
  c.t1 = min(S, c.t0 + CH);
  c.row0 = (long long)c.b * S;
  return c.d < D;
}

// Pass 1: each chunk's product of a and its carry out from c = 0
template <typename TG>
__global__ void __launch_bounds__(NT)
rglru_bwd_chunk_kernel(const TG* __restrict__ ga,
                       const float* __restrict__ lam,
                       const float* __restrict__ b_a,
                       const float* __restrict__ dy, float* __restrict__ A,
                       float* __restrict__ Cl, int S, int D, int n_chunks,
                       int tiles) {
  Cell c;
  if (!cell(c, S, D, n_chunks, tiles)) return;
  const int d = c.d;
  const float coef = -RGLRU_C * softplus(lam[d]);
  const float bias_a = b_a != nullptr ? b_a[d] : 0.f;
  float carry = 0.f, sum_log_a = 0.f;
  for (int t = c.t1 - 1; t >= c.t0; --t) {
    const long long e = (c.row0 + t) * D + d;
    const float log_a = coef * sigmoid(to_f32(ga[e]) + bias_a);
    carry = expf(log_a) * (dy[e] + carry);
    sum_log_a += log_a;
  }
  const long long o = ((long long)c.b * n_chunks + c.chunk) * D + d;
  A[o] = expf(sum_log_a);
  Cl[o] = carry;
}

// Pass 2: the carry into each chunk, composed from the last chunk; A is
// overwritten with it.  dh0 (if asked) is the carry out of chunk 0.
__global__ void __launch_bounds__(NT)
rglru_bwd_carry_kernel(float* __restrict__ A, const float* __restrict__ Cl,
                       const float* __restrict__ dh_last,
                       float* __restrict__ dh0, int B, int D, int n_chunks) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= (long long)B * D) return;
  const long long b = i / D, d = i % D;
  float carry = dh_last != nullptr ? dh_last[i] : 0.f;
  for (int k = n_chunks - 1; k >= 0; --k) {
    const long long o = (b * n_chunks + k) * D + d;
    const float a = A[o], cl = Cl[o];
    A[o] = carry;
    carry = fmaf(a, carry, cl);
  }
  if (dh0 != nullptr) dh0[i] = carry;
}

// Pass 3: every gradient of the chunk's steps, from its incoming carry;
// the chunk's dlam, db_a and db_i terms go to part[(b, chunk)][3][D]
template <typename TX, typename TG>
__global__ void __launch_bounds__(NT)
rglru_bwd_grads_kernel(const TX* __restrict__ x,
                       const float* __restrict__ lam,
                       const TG* __restrict__ ga, const TG* __restrict__ gx,
                       const float* __restrict__ b_a,
                       const float* __restrict__ b_i,
                       const float* __restrict__ h0,
                       const float* __restrict__ y,
                       const float* __restrict__ dy,
                       const float* __restrict__ c_in, TX* __restrict__ dx,
                       TG* __restrict__ dga, TG* __restrict__ dgx,
                       float* __restrict__ part, int S, int D, int n_chunks,
                       int tiles) {
  Cell c;
  if (!cell(c, S, D, n_chunks, tiles)) return;
  const int d = c.d;
  const float sp = softplus(lam[d]);
  const float coef = -RGLRU_C * sp;
  const float bias_a = b_a != nullptr ? b_a[d] : 0.f;
  const float bias_x = b_i != nullptr ? b_i[d] : 0.f;
  const long long o = ((long long)c.b * n_chunks + c.chunk) * D + d;
  float carry = c_in[o];
  float s_lam = 0.f, s_a = 0.f, s_i = 0.f;
  for (int t = c.t1 - 1; t >= c.t0; --t) {
    const long long e = (c.row0 + t) * D + d;
    const float u = sigmoid(to_f32(ga[e]) + bias_a);
    const float log_a = coef * u;
    const float em = expm1f(log_a);         // a - 1
    const float a = 1.f + em;
    const float beta = sqrtf(-em * (2.f + em));
    const float i = sigmoid(to_f32(gx[e]) + bias_x);
    const float xv = to_f32(x[e]);
    const float h_prev =
        t > 0 ? y[e - D] : (h0 != nullptr ? h0[(long long)c.b * D + d] : 0.f);
    const float g = dy[e] + carry;
    const float dlog_a = g * h_prev * a - g * i * xv * a * a / beta;
    const float dgab = dlog_a * coef * u * (1.f - u);
    const float dgxb = g * beta * xv * i * (1.f - i);
    dx[e] = from_f32<TX>(g * beta * i);
    dga[e] = from_f32<TG>(dgab);
    dgx[e] = from_f32<TG>(dgxb);
    s_lam += dlog_a * (-RGLRU_C * u);
    s_a += dgab;
    s_i += dgxb;
    carry = a * g;
  }
  const long long p = ((long long)c.b * n_chunks + c.chunk) * 3 * D + d;
  part[p] = s_lam;
  part[p + D] = s_a;
  part[p + 2 * D] = s_i;
}

// Pass 4: the per-channel sums over the B * chunks partials, in order
__global__ void __launch_bounds__(NT)
rglru_bwd_reduce_kernel(const float* __restrict__ part,
                        const float* __restrict__ lam,
                        float* __restrict__ dlam, float* __restrict__ db_a,
                        float* __restrict__ db_i, int D, int n_parts) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  float s_lam = 0.f, s_a = 0.f, s_i = 0.f;
  for (int k = 0; k < n_parts; ++k) {
    const float* p = part + (long long)k * 3 * D + d;
    s_lam += p[0];
    s_a += p[D];
    s_i += p[2 * D];
  }
  dlam[d] = s_lam * sigmoid(lam[d]);
  if (db_a != nullptr) db_a[d] = s_a;
  if (db_i != nullptr) db_i[d] = s_i;
}

// the workspace's floats: A / c_in and Cl (B * chunks * D each), then the
// partials (B * chunks * 3 * D)
long long ws_floats(int B, int S, int D) {
  const long long n_chunks = (S + CH - 1) / CH;
  return 5LL * B * n_chunks * D;
}

template <typename TX, typename TG>
cudaError_t launch(const void* x, const float* lam, const void* ga,
                   const void* gx, const float* b_a, const float* b_i,
                   const float* h0, const float* y, const float* dy,
                   const float* dh_last, float* ws, void* dx, void* dga,
                   void* dgx, float* dlam, float* db_a, float* db_i,
                   float* dh0, int B, int S, int D, cudaStream_t st) {
  const int n_chunks = (S + CH - 1) / CH;
  const int tiles = (D + NT - 1) / NT;
  const long long blocks = (long long)B * n_chunks * tiles;
  const long long n_parts = (long long)B * n_chunks;
  if (blocks > INT_MAX || n_parts > INT_MAX) return cudaErrorInvalidValue;
  float* A = ws;
  float* Cl = A + n_parts * D;
  float* part = Cl + n_parts * D;
  rglru_bwd_chunk_kernel<TG><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const TG*>(ga), lam, b_a, dy, A, Cl, S, D, n_chunks,
      tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_carry_kernel<<<(unsigned)(((long long)B * D + NT - 1) / NT), NT,
                           0, st>>>(A, Cl, dh_last, dh0, B, D, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_grads_kernel<TX, TG><<<(unsigned)blocks, NT, 0, st>>>(
      static_cast<const TX*>(x), lam, static_cast<const TG*>(ga),
      static_cast<const TG*>(gx), b_a, b_i, h0, y, dy, A,
      static_cast<TX*>(dx), static_cast<TG*>(dga), static_cast<TG*>(dgx),
      part, S, D, n_chunks, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_reduce_kernel<<<(unsigned)tiles, NT, 0, st>>>(
      part, lam, dlam, db_a, db_i, D, (int)n_parts);
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
    return launch<TX, float>(x, lam, ga, gx, b_a, b_i, h0, y, dy, dh_last,
                             ws, dx, dga, dgx, dlam, db_a, db_i, dh0, B, S,
                             D, st);
  if (g_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, lam, ga, gx, b_a, b_i, h0, y, dy,
                                     dh_last, ws, dx, dga, dgx, dlam, db_a,
                                     db_i, dh0, B, S, D, st);
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
// bf16.  Launches four kernels on `stream` and returns cudaGetLastError()
// after them (0 on success).
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
