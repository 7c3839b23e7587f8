// Stand-ins for the inline PTX section of csrc/hopper.cuh (mbarriers, TMA,
// wgmma), computing at issue what the hardware computes asynchronously.
inline uint32_t smem_u32(const void* p) {
  return (uint32_t)(static_cast<const uint8_t*>(p) - emu_block->smem);
}
inline uint32_t swz(uint32_t a) { return a ^ (((a >> 7) & 7) << 4); }

struct EmuBar { uint32_t count = 0, pending = 0; int64_t tx = 0; uint32_t phase = 0; };
inline std::mutex emu_bar_mu;
inline std::map<const void*, EmuBar> emu_bars;
inline void emu_bar_check(EmuBar& b) {
  if (b.pending == 0 && b.tx == 0) { b.phase ^= 1; b.pending = b.count; }
}
inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  emu_bars[bar] = EmuBar{count, count, 0, 0};
}
inline void mbar_init_fence() {}
inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& b = emu_bars.at(bar);
  if (b.pending == 0) { fprintf(stderr, "EMU: arrive on a barrier with no pending arrivals\n"); abort(); }
  b.tx += bytes; b.pending -= 1; emu_bar_check(b);
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& b = emu_bars.at(bar);
  if (b.pending == 0) { fprintf(stderr, "EMU: arrive on a barrier with no pending arrivals\n"); abort(); }
  b.pending -= 1; emu_bar_check(b);
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (long spins = 0;; ++spins) {
    {
      std::lock_guard<std::mutex> g(emu_bar_mu);
      if ((emu_bars.at(bar).phase & 1) != parity) return;
    }
    if (spins > 200000000) { fprintf(stderr, "EMU: mbar_wait hangs\n"); abort(); }
    std::this_thread::yield();
  }
}
inline void tma_load_4d(void* dst, const CUtensorMap* m, uint64_t* bar, int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t base = smem_u32(dst);
  if (base % 1024) { fprintf(stderr, "EMU: TMA destination not 1024-aligned\n"); abort(); }
  uint32_t lin = 0;
  for (uint32_t i3 = 0; i3 < m->box[3]; ++i3)
  for (uint32_t i2 = 0; i2 < m->box[2]; ++i2)
  for (uint32_t i1 = 0; i1 < m->box[1]; ++i1)
  for (uint32_t i0 = 0; i0 < m->box[0]; ++i0, ++lin) {
    const long long x[4] = {c[0] + (long long)i0, c[1] + (long long)i1, c[2] + (long long)i2, c[3] + (long long)i3};
    uint16_t v = 0;
    bool in = true;
    for (int d = 0; d < 4; ++d) in = in && x[d] >= 0 && x[d] < (long long)m->dims[d];
    if (in) {
      const uint8_t* src = m->base;
      for (int d = 0; d < 4; ++d) src += x[d] * m->strides[d];
      memcpy(&v, src, 2);
    }
    memcpy(emu_block->smem + swz(base + 2 * lin), &v, 2);
  }
  std::lock_guard<std::mutex> g(emu_bar_mu);
  EmuBar& b = emu_bars.at(bar);
  b.tx -= 2 * lin; emu_bar_check(b);
}
// the box from shared memory (swizzled as a load leaves it) into the
// tensor; cells outside the tensor are not written
inline void tma_store_4d(const CUtensorMap* m, const void* src, int c0, int c1, int c2, int c3) {
  const int c[4] = {c0, c1, c2, c3};
  const uint32_t base = smem_u32(src);
  if (base % 1024) { fprintf(stderr, "EMU: TMA source not 1024-aligned\n"); abort(); }
  uint32_t lin = 0;
  for (uint32_t i3 = 0; i3 < m->box[3]; ++i3)
  for (uint32_t i2 = 0; i2 < m->box[2]; ++i2)
  for (uint32_t i1 = 0; i1 < m->box[1]; ++i1)
  for (uint32_t i0 = 0; i0 < m->box[0]; ++i0, ++lin) {
    const long long x[4] = {c[0] + (long long)i0, c[1] + (long long)i1, c[2] + (long long)i2, c[3] + (long long)i3};
    bool in = true;
    for (int d = 0; d < 4; ++d) in = in && x[d] >= 0 && x[d] < (long long)m->dims[d];
    if (!in) continue;
    uint8_t* dst = const_cast<uint8_t*>(m->base);
    for (int d = 0; d < 4; ++d) dst += x[d] * m->strides[d];
    memcpy(dst, emu_block->smem + swz(base + 2 * lin), 2);
  }
}
inline void tma_store_wait() {}
inline void fence_proxy_async() {}
inline void named_barrier(int id, int count) { emu_named_barrier(id, count); }
template <int N> inline void setmaxnreg_inc() {}
template <int N> inline void setmaxnreg_dec() {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait0() {}
inline void wgmma_wait1() {}
template <int N> inline void reg_fence(float (&)[N]) {}
template <int N> inline void reg_fence(uint32_t (&)[N]) {}

inline float emu_bf(uint32_t addr) {
  uint16_t v; memcpy(&v, emu_block->smem + swz(addr), 2);
  return __bfloat162float(__nv_bfloat16{v});
}
struct Desc { uint32_t start, lbo, sbo; };
inline Desc dec(uint64_t d) {
  return {(uint32_t)((d & 0x3FFF) << 4), (uint32_t)(((d >> 16) & 0x3FFF) << 4),
          (uint32_t)(((d >> 32) & 0x3FFF) << 4)};
}
inline float kmaj(Desc d, int mn, int k) { return emu_bf(d.start + (mn / 8) * d.sbo + (mn % 8) * 128 + 2 * k); }
inline float mnmaj(Desc d, int k, int mn) {
  return emu_bf(d.start + (mn / 64) * d.lbo + 2 * (mn % 64) + (k / 8) * d.sbo + (k % 8) * 128);
}
inline void emu_rc(int i, int& row, int& col) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  row = 16 * w + lane / 4 + 8 * ((i / 2) % 2);
  col = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}
template <int NH, bool BMN, bool AMN = false>
inline void emu_ss(float (&d)[NH], uint64_t da, uint64_t db, int acc) {
  const Desc a = dec(da), b = dec(db);
  for (int i = 0; i < NH; ++i) {
    int r, c; emu_rc(i, r, c);
    float s = acc ? d[i] : 0.f;
    for (int k = 0; k < 16; ++k)
      s += (AMN ? mnmaj(a, k, r) : kmaj(a, r, k)) * (BMN ? mnmaj(b, k, c) : kmaj(b, c, k));
    d[i] = s;
  }
}
inline void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) { emu_ss<32, false>(d, da, db, acc); }
inline void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) { emu_ss<64, false>(d, da, db, acc); }
inline void wgmma_ss_mn(float (&d)[32], uint64_t da, uint64_t db, int acc) { emu_ss<32, true>(d, da, db, acc); }
inline void wgmma_ss_mn(float (&d)[64], uint64_t da, uint64_t db, int acc) { emu_ss<64, true>(d, da, db, acc); }
inline void wgmma_ss_mn(float (&d)[128], uint64_t da, uint64_t db, int acc) { emu_ss<128, true>(d, da, db, acc); }
inline void wgmma_tt(float (&d)[64], uint64_t da, uint64_t db, int acc) { emu_ss<64, true, true>(d, da, db, acc); }
inline float frag_val(const uint32_t* f, int row, int k) {
  // A (64 x 16) from the warpgroup's fragments: thread (row r, quad c)
  const int w = row / 16, rr = row % 16, lane = (rr % 8) * 4 + (k % 8) / 2;
  const int t = w * 32 + lane;
  const int idx = (rr >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0);
  const uint32_t bits = f[4 * t + idx];
  const uint16_t h = (k % 2) ? (uint16_t)(bits >> 16) : (uint16_t)(bits & 0xffff);
  return __bfloat162float(__nv_bfloat16{h});
}
template <int NH>
inline void emu_rs(float (&d)[NH], const uint32_t (&a)[4], uint64_t db) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  uint32_t* f = emu_block->frags.data() + 4 * 128 * wg;
  emu_wg_sync();
  for (int j = 0; j < 4; ++j) f[4 * t + j] = a[j];
  emu_wg_sync();
  const Desc b = dec(db);
  for (int i = 0; i < NH; ++i) {
    int r, c; emu_rc(i, r, c);
    float s = d[i];
    for (int k = 0; k < 16; ++k) s += frag_val(f, r, k) * mnmaj(b, k, c);
    d[i] = s;
  }
  emu_wg_sync();
}
inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) { emu_rs<32>(d, a, db); }
inline void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) { emu_rs<64>(d, a, db); }
inline void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) { emu_rs<128>(d, a, db); }
