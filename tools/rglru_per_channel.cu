// The first CUDA port of the RG-LRU scan: one thread per (b, d) channel
// walking all of S.  src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu
// replaced it; tools/rglru_variants.py builds this copy to time it beside
// the windowed kernel.  It takes the whole gate pre-activations (no fused
// biases).
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
// tail itself, takes any B and S (S = 1 too) and takes h0.
//
// What bounds it on the H100: bytes.  Per (b, t, d) it reads x, ga, gx and
// writes y once, with about 16 float32 operations between (two sigmoids,
// exp, expm1, sqrt, the products and the recurrence); at the serving shape
// B=4, S=1000, D=4096 with bf16 x and float32 gates that is 229.4 MB,
// 68.5 us at 3.35 TB/s, against 0.26 GFLOP, 3.9 us at 67 TFLOP/s.
//
// Design (simple first): one thread per (b, d) channel carries h in a
// register and walks t.  Neighbouring threads hold neighbouring d, so each
// step's loads and stores coalesce.  The gate loads do not depend on h, so
// the loop runs in chunks of U steps: the next chunk's loads are issued
// before the current chunk's recurrence runs, which keeps ~U steps of
// loads in flight per thread.  B * D = 16,384 channels at the serving shape
// fill only about one 128-thread block per SM, so the time loop's latency,
// not the memory rate, is what this version waits on.  The later design is
// a chunked two-pass scan over S (per-chunk (prod a, local h) in a first
// pass, a short carry scan, then a second pass), which puts S / chunk
// times as many threads to work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int NT = 128;        // threads per block (channels)
constexpr int U = 16;          // time steps per chunk
constexpr float RGLRU_C = 8.f;  // the paper's fixed temperature

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// softplus as torch.nn.functional.softplus computes it (threshold 20)
__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

template <typename TX, typename TG>
struct Chunk {
  TX x[U];
  TG ga[U];
  TG gx[U];
};

// Loads steps t0 .. t0+U-1 of one channel (at `off`, stride D between
// steps).  Steps past S load step S-1 again; their values are never used.
template <typename TX, typename TG>
__device__ __forceinline__ void load_chunk(Chunk<TX, TG>& c, const TX* x,
                                           const TG* ga, const TG* gx,
                                           long long off, long long D, int t0,
                                           int S) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = off + min(t0 + u, S - 1) * D;
    c.x[u] = x[i];
    c.ga[u] = ga[i];
    c.gx[u] = gx[i];
  }
}

template <typename TX, typename TG>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const TX* __restrict__ x, const float* __restrict__ lam,
                  const TG* __restrict__ ga, const TG* __restrict__ gx,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ h_last, int B, int S, int D) {
  const long long ch = (long long)blockIdx.x * NT + threadIdx.x;  // b*D + d
  if (ch >= (long long)B * D) return;
  const long long b = ch / D, d = ch % D;
  const long long off = b * S * D + d;   // (b, 0, d)
  const float coef = -RGLRU_C * softplus(lam[d]);
  float h = h0 != nullptr ? h0[ch] : 0.f;

  Chunk<TX, TG> cur, nxt;
  load_chunk(cur, x, ga, gx, off, D, 0, S);
  for (int t0 = 0; t0 < S; t0 += U) {
    float a[U], bb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float log_a = coef * sigmoid(to_f32(cur.ga[u]));
      a[u] = expf(log_a);
      bb[u] = sqrtf(-expm1f(2.f * log_a)) *
              (sigmoid(to_f32(cur.gx[u])) * to_f32(cur.x[u]));
    }
    // the next chunk's loads are in flight while this chunk's steps run
    if (t0 + U < S) load_chunk(nxt, x, ga, gx, off, D, t0 + U, S);
    const int n = min(U, S - t0);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        h = a[u] * h + bb[u];
        y[off + (t0 + u) * (long long)D] = h;
      }
    }
    cur = nxt;
  }
  h_last[ch] = h;
}

template <typename TX, typename TG>
cudaError_t launch(const void* x, const void* lam, const void* ga,
                   const void* gx, const void* h0, void* y, void* h_last,
                   int B, int S, int D, cudaStream_t stream) {
  const long long channels = (long long)B * D;
  const long long blocks = (channels + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rglru_scan_kernel<TX, TG><<<(unsigned)blocks, NT, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(lam),
      static_cast<const TG*>(ga), static_cast<const TG*>(gx),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(h_last), B, S, D);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_g(const void* x, const void* lam, const void* ga,
                       const void* gx, const void* h0, void* y, void* h_last,
                       int B, int S, int D, int g_dtype, cudaStream_t st) {
  if (g_dtype == 0)
    return launch<TX, float>(x, lam, ga, gx, h0, y, h_last, B, S, D, st);
  if (g_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, lam, ga, gx, h0, y, h_last, B, S, D,
                                     st);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, S, D), ga and gx: (B, S, D) of one dtype, lam: (D,) float32, h0:
// (B, D) float32 or null (zeros); y: (B, S, D) float32, h_last: (B, D)
// float32.  All contiguous, on the current device.  x_dtype and g_dtype: 0
// float32, 1 bf16.  Launches on `stream` and returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int repro_rglru_scan(const void* x, const void* lam,
                                const void* ga, const void* gx,
                                const void* h0, void* y, void* h_last, int B,
                                int S, int D, int x_dtype, int g_dtype,
                                void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)dispatch_g<float>(x, lam, ga, gx, h0, y, h_last, B, S, D,
                                  g_dtype, st);
  if (x_dtype == 1)
    return (int)dispatch_g<__nv_bfloat16>(x, lam, ga, gx, h0, y, h_last, B,
                                          S, D, g_dtype, st);
  return (int)cudaErrorInvalidValue;
}
