// Pieces shared by the grouped expert FFN's forward (moe_gmm.cu) and
// backward (moe_gmm_bwd.cu): the activations and their derivatives, bucket
// fills, the wgmma route's tiling helpers and tensor maps.  Each source is
// its own translation unit, so everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"

namespace {

enum Act { kSilu = 0, kGeluTanh = 1, kRelu2 = 2 };
enum Route { kScalarF32 = 0, kWmmaBf16 = 1, kWgmmaBf16 = 2 };

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

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

__device__ __forceinline__ float activate(int act, float x) {
  if (act == kSilu) return x / (1.f + expf(-x));
  if (act == kGeluTanh)
    return 0.5f * x * (1.f + tanhf(kGeluC * (x + kGeluA * x * x * x)));
  const float r = fmaxf(x, 0.f);
  return r * r;
}

// act'(x), as torch's silu_backward, gelu_backward (tanh) and 2 relu(x)
__device__ __forceinline__ float act_grad(int act, float x) {
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  }
  if (act == kGeluTanh) {
    const float t = tanhf(kGeluC * (x + kGeluA * x * x * x));
    return 0.5f * (1.f + t) +
           0.5f * x * (1.f - t * t) * kGeluC * (1.f + 3.f * kGeluA * x * x);
  }
  return 2.f * fmaxf(x, 0.f);
}

// live rows of expert e's bucket of M: the first counts[e] (all without
// counts)
__device__ __forceinline__ int live_rows(const int* counts, int e, int M) {
  return counts == nullptr ? M : min(max(counts[e], 0), M);
}

constexpr int WG = 128;                   // threads of a warpgroup
constexpr int BOX = 64;                   // rows of every TMA box
constexpr int BOX_BYTES = BOX * ROW_BYTES;  // one panel of 64 x 64 bf16

// output tile `tile` of n_tiles_m x n_tiles_n tiles an expert: its expert,
// first row and first column, along the longer side first
__device__ __forceinline__ void tile_at(int tile, int n_tiles_m,
                                        int n_tiles_n, int BM, int BN,
                                        int& e, int& m0, int& n0) {
  const int per_expert = n_tiles_m * n_tiles_n;
  const int i = tile % per_expert;
  e = tile / per_expert;
  if (n_tiles_n > n_tiles_m) {  // rows fastest
    m0 = i % n_tiles_m * BM;
    n0 = i / n_tiles_m * BN;
  } else {                      // columns fastest
    n0 = i % n_tiles_n * BN;
    m0 = i / n_tiles_n * BM;
  }
}

// stores zeros over rows [m0, min(m0 + rows, M)) and columns [n0, min(n0 +
// cols, N)) of the (M x N) bf16 matrix out (N % 8 == 0, out 16-byte
// aligned), from `threads` threads
__device__ __forceinline__ void zero_tile(__nv_bfloat16* out, int m0, int M,
                                          int n0, int N, int rows, int cols,
                                          int tid, int threads) {
  for (int v = tid; v < rows * (cols / 8); v += threads) {
    const int r = m0 + v / (cols / 8), c = n0 + v % (cols / 8) * 8;
    if (r < M && c < N)
      *reinterpret_cast<uint4*>(out + (long long)r * N + c) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// 4-D bf16 tensor map over a contiguous (E, rows, inner) tensor, with boxes
// of 64 x 64 (inner, rows) and the 128-byte swizzle; cells outside the
// tensor read as zeros and are not written.
bool make_map(CUtensorMap* map, const void* base, int E, int rows,
              int inner) {
  const cuuint64_t row = (cuuint64_t)inner * 2;  // bytes
  return make_bf16_map_4d(
      map, base, {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)E, 1},
      {row, row * rows, row * rows * E},
      {(cuuint32_t)PANEL, (cuuint32_t)BOX, 1, 1});
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace
