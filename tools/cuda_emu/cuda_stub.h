// Host stand-ins for the CUDA runtime and device builtins, for running a
// kernel source on the CPU (tools/cuda_emu/flash_bwd_emu.py): one
// std::thread per CUDA thread, blocks run one at a time.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
#define CUDART_VERSION 12050

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3s { unsigned x, y, z; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }
inline long long max(long long a, long long b) { return a > b ? a : b; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaErrorMisalignedAddress = 716 };
// a card of EMU_SMS multiprocessors: few, so that persistent CTAs walk
// several tiles each
inline int EMU_SMS = 3;
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = EMU_SMS; return cudaSuccess; }
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class T> cudaError_t cudaFuncSetAttribute(T, cudaFuncAttribute, int v) {
  return v <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}
inline thread_local cudaError_t emu_last_error = 0;
inline cudaError_t cudaGetLastError() { cudaError_t e = emu_last_error; emu_last_error = 0; return e; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu error"; }

struct float2 { float x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }

struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline uint16_t f2bf(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if (std::isnan(f)) return 0x7fc0;
  u += 0x7fff + ((u >> 16) & 1);
  return (uint16_t)(u >> 16);
}
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) { return {f2bf(f)}; }
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {{f2bf(a)}, {f2bf(b)}}; }
inline float2 __bfloat1622float2(__nv_bfloat162 v) { return {__bfloat162float(v.x), __bfloat162float(v.y)}; }

// ---- fast-math intrinsics and cuda_pipeline.h ----------------------------
inline float __expf(float v) { return expf(v); }
inline float __fdividef(float a, float b) { return a / b; }
inline float rsqrtf(float v) { return 1.f / sqrtf(v); }
// cp.async as a copy queued per thread: __pipeline_commit closes a group,
// __pipeline_wait_prior(n) carries out all but the newest n groups, so that
// a read of the buffer before its wait sees the launcher's NaN fill
struct EmuCopy { void* dst; const void* src; size_t size, zfill; };
inline thread_local std::vector<EmuCopy> emu_open_group;
inline thread_local std::vector<std::vector<EmuCopy>> emu_groups;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  emu_open_group.push_back({dst, src, size, zfill});
}
inline void __pipeline_commit() {
  emu_groups.push_back(std::move(emu_open_group));
  emu_open_group.clear();
}
inline void __pipeline_wait_prior(size_t n) {
  while (emu_groups.size() > n) {
    for (const EmuCopy& c : emu_groups.front()) {
      memcpy(c.dst, c.src, c.size - c.zfill);
      memset(static_cast<char*>(c.dst) + (c.size - c.zfill), 0, c.zfill);
    }
    emu_groups.erase(emu_groups.begin());
  }
}

// ---- per-block synchronisation -------------------------------------------
struct EmuBlock {
  uint8_t* smem = nullptr;
  std::unique_ptr<std::barrier<>> block_bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bar, wg_bar;
  std::vector<float> shfl;            // per-thread exchange slots
  std::vector<double> shfl_d;
  std::vector<uint32_t> frags;        // per-thread A fragments (4 each)
  std::mutex named_mu;                // named barriers (bar.sync id, count)
  std::map<int, std::unique_ptr<std::barrier<>>> named;
};
inline EmuBlock* emu_block = nullptr;
inline uint8_t* emu_smem() { return emu_block->smem; }
inline void __syncthreads() { emu_block->block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_block->warp_bar[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x;
  __syncwarp();
  emu_block->shfl[t] = v;
  __syncwarp();
  const float o = emu_block->shfl[(t / 32) * 32 + ((t % 32) ^ off)];
  __syncwarp();
  return o;
}
inline double __shfl_up_sync(unsigned, double v, int off) {
  const int t = threadIdx.x, lane = t % 32;
  __syncwarp();
  emu_block->shfl_d[t] = v;
  __syncwarp();
  const double o = lane >= off ? emu_block->shfl_d[t - off] : v;
  __syncwarp();
  return o;
}
inline void emu_named_barrier(int id, int count) {
  std::barrier<>* b;
  {
    std::lock_guard<std::mutex> g(emu_block->named_mu);
    auto& slot = emu_block->named[id];
    if (!slot) slot = std::make_unique<std::barrier<>>(count);
    b = slot.get();
  }
  b->arrive_and_wait();
}
inline void emu_wg_sync() { emu_block->wg_bar[threadIdx.x / 128]->arrive_and_wait(); }

inline size_t EMU_SMEM_BYTES = 232448 + 2048;

template <typename... KArgs, typename... Args>
void emu_launch(void (*k)(KArgs...), dim3 g, dim3 b, size_t smem, cudaStream_t, Args... args) {
  const int nt = b.x * b.y * b.z;
  if (smem > 232448 || nt > 1024) { emu_last_error = cudaErrorInvalidValue; return; }
  for (unsigned bz = 0; bz < g.z; ++bz)
  for (unsigned by = 0; by < g.y; ++by)
  for (unsigned bx = 0; bx < g.x; ++bx) {
    EmuBlock blk;
    blk.smem = static_cast<uint8_t*>(aligned_alloc(1024, EMU_SMEM_BYTES));
    // NaN fill: a read before a write shows
    for (size_t i = 0; i < EMU_SMEM_BYTES / 2; ++i) reinterpret_cast<uint16_t*>(blk.smem)[i] = 0x7fc1;
    blk.block_bar = std::make_unique<std::barrier<>>(nt);
    for (int w = 0; w < (nt + 31) / 32; ++w) blk.warp_bar.push_back(std::make_unique<std::barrier<>>(std::min(32, nt - 32 * w)));
    for (int w = 0; w < (nt + 127) / 128; ++w) blk.wg_bar.push_back(std::make_unique<std::barrier<>>(std::min(128, nt - 128 * w)));
    blk.shfl.assign(nt, 0.f);
    blk.shfl_d.assign(nt, 0.0);
    blk.frags.assign(4 * nt, 0u);
    emu_block = &blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, t]() {
        threadIdx = dim3(t, 0, 0); blockIdx = dim3(bx, by, bz); blockDim = b; gridDim = g;
        k(args...);
      });
    for (auto& th : ts) th.join();
    emu_block = nullptr;
    free(blk.smem);
  }
}

// ---- driver API stand-ins for the tensor-map encoder ---------------------
typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
enum { CUDA_SUCCESS = 0 };
typedef int CUtensorMapDataType; enum { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
typedef int CUtensorMapInterleave; enum { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
typedef int CUtensorMapSwizzle; enum { CU_TENSOR_MAP_SWIZZLE_128B = 3 };
typedef int CUtensorMapL2promotion; enum { CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
typedef int CUtensorMapFloatOOBfill; enum { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct CUtensorMap {
  const uint8_t* base; uint64_t dims[4]; uint64_t strides[4]; uint32_t box[4]; uint32_t rank;
};
inline CUresult emu_encode(CUtensorMap* m, CUtensorMapDataType, cuuint32_t rank, void* base,
                           const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                           const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle sw,
                           CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return 1;
  if (sw == CU_TENSOR_MAP_SWIZZLE_128B && box[0] * 2 > 128) return 1;
  m->base = static_cast<const uint8_t*>(base); m->rank = rank;
  m->strides[0] = 2;
  for (uint32_t i = 0; i < rank; ++i) {
    m->dims[i] = dims[i]; m->box[i] = box[i];
    if (box[i] == 0 || box[i] > 256) return 1;
    if (i > 0) { if (strides[i - 1] % 16) return 1; m->strides[i] = strides[i - 1]; }
  }
  return CUDA_SUCCESS;
}
typedef int cudaDriverEntryPointQueryResult;
enum { cudaDriverEntryPointSuccess = 0, cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPointByVersion(const char*, void** p, unsigned, int,
                                                    cudaDriverEntryPointQueryResult* r) {
  *p = reinterpret_cast<void*>(&emu_encode); *r = cudaDriverEntryPointSuccess; return cudaSuccess;
}
