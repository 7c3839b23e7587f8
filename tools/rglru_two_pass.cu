// The RG-LRU scan in two launches, the simpler design that
// src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu was measured
// against (tools/rglru_variants.py builds and times it).
//
// The grid is (channel blocks x S-chunks of T steps), one thread per (b, d)
// and chunk.  Launch 1 computes each chunk's gates and its (A = prod a,
// H = its h from 0) into a float2 workspace (chunks, B, D).  Launch 2
// composes the earlier chunks' (A, H) from h0 into the chunk's incoming h,
// computes the gates again from the inputs and writes y (and h_last from
// the last chunk).  So the inputs cross HBM twice and the gates are
// computed twice; the same contract as the committed kernel, biases too.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int NT = 128;         // threads (channels) a block
constexpr int T = 64;           // steps a chunk
constexpr int U = 8;            // steps loaded ahead of their arithmetic
constexpr float RGLRU_C = 8.f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// Runs the chunk's steps from h: (A, H) with h = 0 and A tracked (pass 1),
// or the recurrence from h storing y (pass 2).
template <bool PASS2, typename TX, typename TG>
__device__ __forceinline__ void walk(const TX* x, const TG* ga, const TG* gx,
                                     float* y, long long off, long long D,
                                     int t0, int t1, float coef, float ba,
                                     float bi, float& A, float& h) {
  for (int t = t0; t < t1; t += U) {
    float xv[U], gav[U], gxv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = off + (long long)min(t + u, t1 - 1) * D;
      xv[u] = to_f32(x[i]);
      gav[u] = to_f32(ga[i]);
      gxv[u] = to_f32(gx[i]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < t1) {
        const float log_a = coef * sigmoid(gav[u] + ba);
        const float a = expf(log_a);
        const float b = sqrtf(-expm1f(2.f * log_a)) *
                        (sigmoid(gxv[u] + bi) * xv[u]);
        h = fmaf(a, h, b);
        if (PASS2) y[off + (long long)(t + u) * D] = h;
        else A *= a;
      }
    }
  }
}

template <bool PASS2, typename TX, typename TG>
__global__ void __launch_bounds__(NT)
two_pass_kernel(const TX* __restrict__ x, const float* __restrict__ lam,
                const TG* __restrict__ ga, const TG* __restrict__ gx,
                const float* __restrict__ b_a, const float* __restrict__ b_i,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_last, float2* __restrict__ ws, int B,
                int S, int D) {
  const long long BD = (long long)B * D;
  const long long ch = (long long)blockIdx.x * NT + threadIdx.x;  // b*D + d
  if (ch >= BD) return;
  const long long b = ch / D, d = ch % D;
  const int k = blockIdx.y;
  const int t0 = k * T, t1 = min(S, t0 + T);
  const long long off = b * S * D + d;
  const float coef = -RGLRU_C * softplus(lam[d]);
  const float ba = b_a != nullptr ? b_a[d] : 0.f;
  const float bi = b_i != nullptr ? b_i[d] : 0.f;
  float A = 1.f, h = 0.f;
  if (PASS2) {
    h = h0 != nullptr ? h0[ch] : 0.f;
    for (int j = 0; j < k; ++j) {
      const float2 e = ws[j * BD + ch];
      h = fmaf(e.x, h, e.y);
    }
  }
  walk<PASS2>(x, ga, gx, y, off, D, t0, t1, coef, ba, bi, A, h);
  if (!PASS2) ws[k * BD + ch] = make_float2(A, h);
  else if (t1 == S) h_last[ch] = h;
}

template <typename TX, typename TG>
cudaError_t launch(const void* x, const void* lam, const void* ga,
                   const void* gx, const void* b_a, const void* b_i,
                   const void* h0, void* y, void* h_last, void* ws, int B,
                   int S, int D, cudaStream_t st) {
  const long long blocks = ((long long)B * D + NT - 1) / NT;
  const int chunks = (S + T - 1) / T;
  if (blocks > INT_MAX || chunks > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, chunks);
  auto args = [&](auto kern) {
    kern<<<grid, NT, 0, st>>>(
        static_cast<const TX*>(x), static_cast<const float*>(lam),
        static_cast<const TG*>(ga), static_cast<const TG*>(gx),
        static_cast<const float*>(b_a), static_cast<const float*>(b_i),
        static_cast<const float*>(h0), static_cast<float*>(y),
        static_cast<float*>(h_last), static_cast<float2*>(ws), B, S, D);
  };
  args(two_pass_kernel<false, TX, TG>);
  args(two_pass_kernel<true, TX, TG>);
  return cudaGetLastError();
}

}  // namespace

// As repro_rglru_scan, with `ws` a float32 workspace of 2 * ceil(S / 64) *
// B * D elements.
extern "C" int repro_rglru_scan_two_pass(const void* x, const void* lam,
                                         const void* ga, const void* gx,
                                         const void* b_a, const void* b_i,
                                         const void* h0, void* y,
                                         void* h_last, void* ws, int B, int S,
                                         int D, int x_dtype, int g_dtype,
                                         void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, lam, ga, gx, b_a, b_i, h0, y,
                                             h_last, ws, B, S, D, st);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        x, lam, ga, gx, b_a, b_i, h0, y, h_last, ws, B, S, D, st);
  return (int)cudaErrorInvalidValue;   // the tool times bf16 x only
}
