// The swapped product for decode buckets, a variant of moe_gmm.cu's wgmma
// route that tools/moe_variants.py splices into a copy of the source (it
// uses that file's helpers and hopper.cuh's).  Each CTA takes 64 weight
// columns of one expert as the 64-row A operand of `wgmma` (MN-major: the
// weights are stored N innermost) and the bucket's rows, at most SW_ROWS,
// as an N = 8 B operand (K-major), so that no tensor-core row is spent on
// pads and a stage holds 1 KiB of rows instead of 8 KiB.  The output tile
// (64 columns x the bucket's rows) goes out by plain stores.

// D (64 x 8, float32) += A (64 x 16, MN-major) * B (16 x 8, K-major), both
// bf16 in shared memory through descriptors
__device__ __forceinline__ void wgmma_tn8(float (&d)[4], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

constexpr int SW_ROWS = 8;                       // the product's N
constexpr int SW_STAGES = 4;
constexpr int SW_X_BYTES = 1024;                 // SW_ROWS rows of a panel
template <int NB>
struct Swapped {
  static constexpr int STAGE_BYTES = NB * BOX_BYTES + SW_X_BYTES;
  static constexpr size_t bytes = 1024 + SW_STAGES * STAGE_BYTES +
                                  8 * 2 * SW_STAGES;
};

template <int NB, bool UP>
__global__ void __launch_bounds__(2 * WG, 3)
gmm_swapped(const __grid_constant__ CUtensorMap tx,
            const __grid_constant__ CUtensorMap tb0,
            const __grid_constant__ CUtensorMap tb1,
            __nv_bfloat16* __restrict__ out, const int* __restrict__ counts,
            int E, int M, int K, int N, int act) {
  constexpr int STAGE_BYTES = Swapped<NB>::STAGE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SW_STAGES * STAGE_BYTES);
  uint64_t* empty = full + SW_STAGES;
  const int n_tiles_n = (N + PANEL - 1) / PANEL;
  const int e = blockIdx.x / n_tiles_n;
  const int n0 = blockIdx.x % n_tiles_n * PANEL;
  const int live = live_rows(counts, e, M);
  out += (long long)e * M * N;
  if (live == 0) {  // pads only: y gets its zeros, h nothing
    if constexpr (!UP)
      zero_tile(out, 0, M, n0, N, M, PANEL, threadIdx.x, 2 * WG);
    return;
  }
  const int nk = (K + PANEL - 1) / PANEL;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x >= WG) {  // producer
    if (threadIdx.x != WG) return;
    for (int kp = 0; kp < nk; ++kp) {
      const int s = kp % SW_STAGES;
      mbar_wait(empty + s, ((kp / SW_STAGES) & 1) ^ 1);
      uint8_t* st = smem + s * STAGE_BYTES;
      mbar_expect_tx(full + s, STAGE_BYTES);
      tma_load_4d(st, &tb0, full + s, n0, kp * PANEL, e, 0);
      if constexpr (NB == 2)
        tma_load_4d(st + BOX_BYTES, &tb1, full + s, n0, kp * PANEL, e, 0);
      tma_load_4d(st + NB * BOX_BYTES, &tx, full + s, kp * PANEL, 0, e, 0);
    }
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kp = 0; kp < nk; ++kp) {
    const int s = kp % SW_STAGES;
    mbar_wait(full + s, (kp / SW_STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    reg_fence(acc0);
    reg_fence(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PANEL / 16; ++kk) {
      const uint64_t db = sw128_desc(st + NB * BOX_BYTES + kk * 32, 16);
      wgmma_tn8(acc0, sw128_desc(st + kk * 16 * ROW_BYTES, BOX_BYTES), db,
                1);
      if constexpr (NB == 2)
        wgmma_tn8(acc1,
                  sw128_desc(st + BOX_BYTES + kk * 16 * ROW_BYTES, BOX_BYTES),
                  db, 1);
    }
    wgmma_commit();
    wgmma_wait1();
    reg_fence(acc0);
    reg_fence(acc1);
    if (kp > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kp - 1) % SW_STAGES);
    }
  }
  wgmma_wait0();
  reg_fence(acc0);
  reg_fence(acc1);
  // d[i]: weight column 16 warp + lane / 4 + 8 (i / 2), row 2 (lane % 4) +
  // i % 2 of the bucket
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 16 * warp + lane / 4 + 8 * (i / 2);
    const int r = 2 * (lane % 4) + i % 2;
    float v = acc0[i];
    if constexpr (UP) {
      v = activate(act, v);
      if constexpr (NB == 2) v *= acc1[i];
    }
    if (r < M && n < N) out[(long long)r * N + n] =
        __float2bfloat16(r < live ? v : 0.f);
  }
}

// 4-D bf16 tensor map over a contiguous (E, rows, inner) tensor with boxes
// of 64 x SW_ROWS
bool make_rows_map(CUtensorMap* map, const void* base, int E, int rows,
                   int inner) {
  const cuuint64_t row = (cuuint64_t)inner * 2;
  return make_bf16_map_4d(
      map, base, {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)E, 1},
      {row, row * rows, row * rows * E},
      {(cuuint32_t)PANEL, (cuuint32_t)SW_ROWS, 1, 1});
}

template <int NB, bool UP>
cudaError_t launch_swapped(const CUtensorMap& tx, const CUtensorMap& tb0,
                           const CUtensorMap& tb1, void* out,
                           const int* counts, int E, int M, int K, int N,
                           int act, cudaStream_t stream) {
  const size_t smem = Swapped<NB>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gmm_swapped<NB, UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (N + PANEL - 1) / PANEL * E;
  gmm_swapped<NB, UP><<<grid, 2 * WG, smem, stream>>>(
      tx, tb0, tb1, static_cast<__nv_bfloat16*>(out), counts, E, M, K, N,
      act);
  return cudaGetLastError();
}

cudaError_t run_swapped(const void* xe, const void* w1, const void* w3,
                        const void* w2, void* h, void* y, const int* counts,
                        int E, int C, int d, int f, int act,
                        cudaStream_t stream) {
  CUtensorMap txe, tw1, tw3, th, tw2;
  if (!make_rows_map(&txe, xe, E, C, d) || !make_map(&tw1, w1, E, d, f) ||
      !make_map(&tw3, w3 != nullptr ? w3 : w1, E, d, f) ||
      !make_rows_map(&th, h, E, C, f) || !make_map(&tw2, w2, E, f, d))
    return cudaErrorInvalidValue;
  cudaError_t err =
      w3 != nullptr
          ? launch_swapped<2, true>(txe, tw1, tw3, h, counts, E, C, d, f,
                                    act, stream)
          : launch_swapped<1, true>(txe, tw1, tw1, h, counts, E, C, d, f,
                                    act, stream);
  if (err != cudaSuccess) return err;
  return launch_swapped<1, false>(th, tw2, tw2, y, counts, E, C, f, d, act,
                                  stream);
}
