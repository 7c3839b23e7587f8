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
// This first version does neither: it computes with scalar float32 FMAs
// out of shared memory, so the FMA and shared-memory issue rate bounds it.
// `wgmma` on bf16 tiles fed by TMA is the step that moves it toward the
// bound.
//
// Design:
//  * Grid (q-tiles, B*H).  The TPU grid's sequential k dimension is a loop
//    inside one thread block; the running (m, l, acc) state lives in
//    registers.  Query head h reads KV head h / (H / KH).
//  * q, k, v, o are read and written in their (B, S, heads, Dh) layout by
//    stride, so the wrapper transposes nothing.
//  * Only k-tiles that can hold an unmasked key are visited: up to the
//    q-tile's last row when causal, from q0 - window + 1 with a window.
//    Masked scores are -inf, and a row whose keys so far are all masked
//    keeps p = 0 and acc = 0, so no exp(0) garbage from a fully masked
//    tile ever enters the sum.
//  * Any S works: q rows and k columns past S are masked, and K/V rows
//    past S are loaded as zeros.  No reference fallback.
//  * float32 and bf16 inputs (template T); float32 computes in float32.
//    Dh is a template parameter: 64, 120, 128 and 256.
//
// Thread layout (64 query rows x 64 keys per tile): a row group of L lanes
// owns 4 rows; lane c of row group g owns rows 4g .. 4g+3, keys c + L*j and
// output columns c + L*n.  L is 8 up to Dh 128 (128 threads) and 16 at
// Dh 256 (256 threads), so a thread keeps 4 x Dh/L <= 64 accumulators in
// registers at every Dh.  The L lanes of a row group are neighbouring
// lanes of one warp, so row max and row sum are log2(L) xor-shuffles and
// the P tile is shared within the warp.  At Dh 256 the tiles take 213,760 B
// of shared memory, so one block runs per SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per k-tile
constexpr int RPT = 4;   // rows per thread

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

template <typename T, int DH>
__global__ void __launch_bounds__(Tiles<DH>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KH, int causal, int window, float scale) {
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
  const T* qb = q + (long long)b * S * q_stride + (long long)h * DH;
  const T* kb = k + (long long)b * S * kv_stride + (long long)kh * DH;
  const T* vb = v + (long long)b * S * kv_stride + (long long)kh * DH;
  T* ob = o + (long long)b * S * q_stride + (long long)h * DH;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int s = q0 + r;
    Qs[r * L::QS + d] = s < S ? to_f32(qb[s * q_stride + d]) : 0.f;
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
      Ks[c * L::KS + d] = in ? to_f32(kb[s * kv_stride + d]) : 0.f;
      Vs[c * L::VS + d] = in ? to_f32(vb[s * kv_stride + d]) : 0.f;
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
        ob[s * q_stride + tc + LN * n] = from_f32<T>(acc[i][n] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int H, int KH, int causal, int window,
                   float scale, cudaStream_t stream) {
  const size_t smem = Tiles<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, DH><<<grid, Tiles<DH>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KH, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dh(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KH, int Dh, int causal,
                        int window, float scale, cudaStream_t stream) {
  switch (Dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KH, causal, window, scale,
                           stream);
    case 120:
      return launch<T, 120>(q, k, v, o, B, S, H, KH, causal, window, scale,
                            stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KH, causal, window, scale,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, KH, causal, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory one block of the kernel requests (0: Dh unsupported).
extern "C" int repro_flash_attention_smem_bytes(int Dh) {
  switch (Dh) {
    case 64: return (int)Tiles<64>::bytes;
    case 120: return (int)Tiles<120>::bytes;
    case 128: return (int)Tiles<128>::bytes;
    case 256: return (int)Tiles<256>::bytes;
    default: return 0;
  }
}

// q: (B, S, H, Dh), k and v: (B, S, KH, Dh), o: (B, S, H, Dh), all
// contiguous, on the current device.  dtype: 0 float32, 1 bf16.  Launches on
// `stream` and returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int S,
                                         int H, int KH, int Dh, int causal,
                                         int window, int dtype, float scale,
                                         void* stream) {
  if (B <= 0 || S <= 0 || KH <= 0 || H <= 0 || H % KH != 0 ||
      (long long)B * H > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_dh<float>(q, k, v, o, B, S, H, KH, Dh, causal,
                                   window, scale, st);
  if (dtype == 1)
    return (int)dispatch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, KH, Dh,
                                           causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
