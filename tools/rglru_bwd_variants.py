#!/usr/bin/env python3
"""Time variants of the RG-LRU backward kernel on one GPU.

    python3 tools/rglru_bwd_variants.py [variant ...]

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  It builds, one ``nvcc`` each, all started together, into
``build/rglru_bwd_variants/``:

* the committed kernel (``csrc/rglru_scan_bwd.cu``) and copies of it with
  one design choice changed by a text replacement: each dtype on the
  other's block (window W and stages), the segments P, the channels a
  block DC, S cut into spans across blocks (as many a row as fit in one
  wave of 132 blocks, an H100's SMs, or K 2 and 4 at the train shape),
  each span's carry in from a light first launch over ga and dy, the
  design's first block (W 32, P 8, DC 64, two blocks an SM, K 4), expm1
  and beta as its first build had them (expm1f, sqrtf), and with them the
  sigmoids and 1 / beta to float32's last bit, and the sums taken by the
  last block of each channel tile instead of a last launch; and one that
  is not the function: the gates' arithmetic taken out, timed for the
  floor that the loads, the scan and the stores leave;
* the first backward kernel, four launches over 64-step chunks
  (``tools/rglru_bwd_four_pass.cu``), the baseline.

At recurrentgemma-9b's train shape (B 1, S 4096, D 4096, fused biases), and
at D 1024, where spans fill the card that 32 tiles leave idle, it holds each against
``ref.reference_rglru_bwd`` in bf16 and float32 (bf16
dx, dga, dgx at 2e-2 of each gradient's max |.|, the rest at 1e-4, as
chip_smoke.py), then times all by CUDA events in turns (in order, then in
reverse), and each kernel a call launches by the profiler.  It prints the
card, each build's ptxas register and spill lines, each variant's errors,
two times per dtype, its share of the bound and its passes.  Names given
on the command line pick variants (the committed kernel and the baseline
always run).
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rglru_scan import ref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/rglru_scan/csrc/"
                            "rglru_scan_bwd.cu")
FOUR_PASS = os.path.join(ROOT, "tools", "rglru_bwd_four_pass.cu")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "rglru_bwd_variants")
COMMITTED_BF16 = "using BlockBf16 = Config<128, 16, 32, 2, 1>;"
COMMITTED_F32 = "using BlockF32 = Config<64, 16, 32, 3, 1>;"
COMMITTED_NAME = ("as committed (DC 32, P 16, one block an SM, all of S a "
                  "block; bf16 W 128, 2 stages; float32 W 64, 3 stages)")
BASELINE_NAME = "four launches, chunks of 64 (the first backward)"


def blocks(bf16=None, f32=None):
    """Edits that set BlockBf16 and BlockF32 (Config<W, P, DC, STAGES,
    MIN_BLOCKS> arguments)."""
    edits = []
    if bf16 is not None:
        edits.append((COMMITTED_BF16, "using BlockBf16 = Config<%d, %d, %d, "
                                      "%d, %d>;" % bf16))
    if f32 is not None:
        edits.append((COMMITTED_F32, "using BlockF32 = Config<%d, %d, %d, "
                                     "%d, %d>;" % f32))
    return edits


# S cut into spans across blocks: each batch row of channel tiles gets as
# many spans of whole windows as fit in one wave of `slots` blocks (at most
# one a window), and a first launch forms every span's (A = prod a as
# exp(sum log_a), C = its carry out from 0) but the first's from ga and dy
# alone; a block composes the later spans' pairs into its carry in.
SPAN_PASS = r"""
constexpr int SLOTS = %d;      // blocks in one wave
constexpr int SPAN_SEGS = 16;  // warps of a span pre-pass block

struct SpanCut { int wps, spans; };  // windows a span, spans a row

template <class C>
SpanCut span_cut(int B, int S, int D) {
  const int windows = (S + C::W - 1) / C::W;
  const long long rows = (long long)B * ((D + C::DC - 1) / C::DC);
  const long long fit = SLOTS / rows;
  const int spans = fit < 1 ? 1 : (int)(fit < windows ? fit : windows);
  const int wps = (windows + spans - 1) / spans;
  return {wps, (windows + wps - 1) / wps};
}

template <typename TG>
__global__ void __launch_bounds__(32 * SPAN_SEGS)
rglru_bwd_span_kernel(const TG* __restrict__ ga,
                      const float* __restrict__ lam,
                      const float* __restrict__ b_a,
                      const float* __restrict__ dy,
                      float2* __restrict__ span_ac, int S, int D,
                      int tiles32, int spans, int span_steps) {
  __shared__ float2 sAC[SPAN_SEGS][32];
  const int lane = threadIdx.x %% 32, seg = threadIdx.x / 32;
  const int d = (blockIdx.x %% tiles32) * 32 + lane;
  const int k = 1 + blockIdx.x / tiles32 %% (spans - 1);
  const int b = blockIdx.x / tiles32 / (spans - 1);
  const bool live = d < D;
  const int per = (span_steps + SPAN_SEGS - 1) / SPAN_SEGS;
  const int t_lo = k * span_steps + seg * per;
  const int t_hi = min(min(S, (k + 1) * span_steps), t_lo + per);
  float carry = 0.f, sum_log_a = 0.f;
  if (live) {
    const float coef = -RGLRU_C * softplus(lam[d]);
    const float bias_a = b_a != nullptr ? b_a[d] : 0.f;
    const long long row0 = (long long)b * S;
#pragma unroll 4
    for (int t = t_hi - 1; t >= t_lo; --t) {
      const long long e = (row0 + t) * D + d;
      const float log_a = coef * sigmoid(to_f32(ga[e]) + bias_a);
      carry = (1.f + expm1_fast(log_a)) * (dy[e] + carry);
      sum_log_a += log_a;
    }
  }
  sAC[seg][lane] = make_float2(sum_log_a, carry);
  __syncthreads();
  if (seg == 0 && live) {
    float s = 0.f, c = 0.f;
    for (int q = SPAN_SEGS - 1; q >= 0; --q) {
      const float2 e = sAC[q][lane];
      c = fmaf(expf(e.x), c, e.y);
      s += e.x;
    }
    span_ac[((long long)b * spans + k) * D + d] = make_float2(expf(s), c);
  }
}

// The main pass:"""


def spans(slots):
    """Edits that cut S into spans across blocks, as many a row as fit in
    one wave of ``slots`` blocks."""
    return [
        ("// The main pass:", SPAN_PASS % slots),
        ("float* __restrict__ dh0, int S, int D, int tiles) {",
         "float* __restrict__ dh0, int S, int D, int tiles,\n"
         "                 const float2* __restrict__ span_ac, int spans,\n"
         "                 int wps) {"),
        ("  const int b = blockIdx.x / tiles;",
         "  const int k = blockIdx.x / tiles % spans;\n"
         "  const int b = blockIdx.x / tiles / spans;"),
        ("  const int n = (S + W - 1) / W;  // windows",
         "  if (live)\n"
         "    for (int j = spans - 1; j > k; --j) {\n"
         "      const float2 e = span_ac[((long long)b * spans + j) * D + d];\n"
         "      carry = fmaf(e.x, carry, e.y);\n"
         "    }\n"
         "  const int w_lo = k * wps;\n"
         "  const int n = min((S + W - 1) / W, w_lo + wps) - w_lo;"),
        ("(n - 1 - j) * W", "(w_lo + n - 1 - j) * W"),
        ("  if (seg == 0 && live && dh0 != nullptr)",
         "  if (k == 0 && seg == 0 && live && dh0 != nullptr)"),
        ("const long long o = (long long)b * 3 * D + d;",
         "const long long o = ((long long)b * spans + k) * 3 * D + d;"),
        ("long long ws_floats(int B, int S, int D) { return 3LL * B * D; }",
         "long long ws_floats(int B, int S, int D) {\n"
         "  const int kf = span_cut<BlockF32>(B, S, D).spans;\n"
         "  const int kb = span_cut<BlockBf16>(B, S, D).spans;\n"
         "  return 5LL * B * (kf > kb ? kf : kb) * D;\n}"),
        ("  const long long blocks = (long long)B * tiles;\n"
         "  if (blocks > INT_MAX) return cudaErrorInvalidValue;\n"
         "  float* part = ws;\n",
         "  const SpanCut cut = span_cut<C>(B, S, D);\n"
         "  const long long blocks = (long long)B * tiles * cut.spans;\n"
         "  const long long tiles32 = (D + 31) / 32;\n"
         "  const long long span_blocks = (long long)B * (cut.spans - 1) *\n"
         "                                tiles32;\n"
         "  if (blocks > INT_MAX || span_blocks > INT_MAX)\n"
         "    return cudaErrorInvalidValue;\n"
         "  float2* span_ac = reinterpret_cast<float2*>(ws);\n"
         "  float* part = ws + 2LL * B * cut.spans * D;\n"
         "  if (cut.spans > 1) {\n"
         "    rglru_bwd_span_kernel<TG><<<(unsigned)span_blocks,\n"
         "                                32 * SPAN_SEGS, 0, st>>>(\n"
         "        static_cast<const TG*>(ga), lam, b_a, dy, span_ac, S, D,\n"
         "        (int)tiles32, cut.spans, cut.wps * C::W);\n"
         "    const cudaError_t err = cudaGetLastError();\n"
         "    if (err != cudaSuccess) return err;\n"
         "  }\n"),
        ("      dh0, S, D, tiles);",
         "      dh0, S, D, tiles, span_ac, cut.spans, cut.wps);"),
        ("      part, lam, dlam, db_a, db_i, D, B);",
         "      part, lam, dlam, db_a, db_i, D, B * cut.spans);"),
    ]


# the sums by the last block of each channel tile to finish: a counter per
# tile in the workspace (zeroed before the launch), __threadfence before
# it; no reduce launch
LAST_BLOCK_SUMS = [
    ("float* __restrict__ dh0, int S, int D, int tiles) {",
     "float* __restrict__ dh0, int S, int D, int tiles,\n"
     "                 float* __restrict__ dlam, float* __restrict__ db_a,\n"
     "                 float* __restrict__ db_i, unsigned* counters,\n"
     "                 int n_parts) {"),
    ("      part[o + v * D] = t;\n    }\n  }\n}",
     "      part[o + v * D] = t;\n    }\n  }\n"
     "  __threadfence();\n  __syncthreads();\n"
     "  __shared__ bool last;\n"
     "  if (threadIdx.x == 0)\n"
     "    last = atomicAdd(counters + tile, 1u) == (unsigned)n_parts - 1;\n"
     "  __syncthreads();\n"
     "  if (!last) return;\n"
     "  __threadfence();\n"
     "  if (seg == 0 && live) {\n"
     "    float s0 = 0.f, s1 = 0.f, s2 = 0.f;\n"
     "    for (int q = 0; q < n_parts; ++q) {\n"
     "      const float* pp = part + (long long)q * 3 * D + d;\n"
     "      s0 += __ldcg(pp);\n      s1 += __ldcg(pp + D);\n"
     "      s2 += __ldcg(pp + 2 * D);\n    }\n"
     "    dlam[d] = -RGLRU_C * s0 / (1.f + expf(-lam[d]));\n"
     "    if (db_a != nullptr) db_a[d] = s1;\n"
     "    if (db_i != nullptr) db_i[d] = s2;\n  }\n"
     "  if (threadIdx.x == 0) counters[tile] = 0;\n}"),
    ("{ return 3LL * B * D; }",
     "{\n  return 3LL * B * D + (D + BlockF32::DC - 1) / BlockF32::DC;\n}"),
    ("  kern<<<(unsigned)blocks,",
     "  unsigned* counters = reinterpret_cast<unsigned*>(part + 3LL * B * D);\n"
     "  if (cudaMemsetAsync(counters, 0, 4 * tiles, st) != cudaSuccess)\n"
     "    return cudaGetLastError();\n"
     "  kern<<<(unsigned)blocks,"),
    ("      dh0, S, D, tiles);",
     "      dh0, S, D, tiles, dlam, db_a, db_i, counters, B);"),
    ("  rglru_bwd_reduce_kernel<<<(unsigned)((D + NT_REDUCE - 1) / "
     "NT_REDUCE),\n                            NT_REDUCE, 0, st>>>(\n"
     "      part, lam, dlam, db_a, db_i, D, B);\n", ""),
]

# name: [(text in the committed source, its replacement: every occurrence)]
VARIANTS = {
    COMMITTED_NAME: [],
    "bf16 at W 64, 3 stages (float32's block)": blocks(bf16=(64, 16, 32, 3,
                                                             1)),
    "float32 at W 128, 2 stages (bf16's block)": blocks(f32=(128, 16, 32, 2,
                                                             1)),
    "bf16 with 3 stages": blocks(bf16=(128, 16, 32, 3, 1)),
    "P 8 (256 threads)": blocks((128, 8, 32, 2, 1), (64, 8, 32, 3, 1)),
    "P 32 (1024 threads, 64 registers)": blocks((128, 32, 32, 2, 1),
                                                (64, 32, 32, 3, 1)),
    "spans where the tiles leave SMs idle (one wave of 132)": spans(132),
    "K 2 (spans in one wave of 264)": spans(264),
    "K 4 (spans in one wave of 528)": spans(528),
    "DC 64, P 8, W 64, 2 stages, spans (64 tiles: K 2)": blocks(
        (64, 8, 64, 2, 1), (64, 8, 64, 2, 1)) + spans(132),
    "first design (W 32, P 8, DC 64, 2 blocks an SM, K 4)": blocks(
        (32, 8, 64, 2, 2), (32, 8, 64, 2, 2)) + spans(256),
    # the gates' arithmetic as the design's first build had it
    "expm1f and beta by sqrtf": [
        ("expm1_fast(", "expm1f("),
        ("kx[i] = (bsq > 0.f ? bsq * rb : 0.f) * ig;",
         "kx[i] = sqrtf(bsq) * ig;")],
    "exact sigmoids, expm1f, beta and 1 / beta by sqrtf and a division": [
        ("return __fdividef(1.f, 1.f + __expf(-v));",
         "return 1.f / (1.f + expf(-v));"),
        ("expm1_fast(", "expm1f("),
        ("const float rb = rsqrtf(bsq);",
         "const float rb = 1.f / sqrtf(bsq);"),
        ("kx[i] = (bsq > 0.f ? bsq * rb : 0.f) * ig;",
         "kx[i] = sqrtf(bsq) * ig;")],
    "sums by the last block of a tile": LAST_BLOCK_SUMS,
    # not the function: the same loads, scans and stores with the gates'
    # transcendentals and divisions taken out, for the floor they leave
    "no gate arithmetic (timed, not checked)": [
        ("return __fdividef(1.f, 1.f + __expf(-v));", "return v;"),
        ("expm1_fast(log_a)", "(log_a)"), ("rsqrtf(bsq)", "bsq")],
}
UNCHECKED = {"no gate arithmetic (timed, not checked)"}
# recurrentgemma-9b's train shape (128 tiles of 32 channels fill the card),
# and a narrower width, where 32 tiles leave most SMs idle and spans win
SHAPES = ((1, 4096, 4096), (1, 4096, 1024))
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
NAMES = ("dx", "dlam", "dga", "dgx", "dh0", "db_a", "db_i")


def _nvcc(stem, source):
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                             stem + ".so", source, ERRORS],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names):
    """{name: (C function, workspace function, ptxas notes)}, built in
    parallel."""
    os.makedirs(OUT, exist_ok=True)
    src0 = open(SOURCE).read()
    procs = {}
    for name in names:
        src = src0
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            src = src.replace(old, new)
        stem = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                         for c in name))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[name] = (stem, _nvcc(stem, stem + ".cu"))
    stem = os.path.join(OUT, "four_pass")
    procs[BASELINE_NAME] = (stem, _nvcc(stem, FOUR_PASS))
    fns = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "C75" in ln
                 or ("spill" in ln and not ln.strip().startswith("0 b"))]
        lib = ctypes.CDLL(stem + ".so")
        fn = lib.repro_rglru_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ws = lib.repro_rglru_scan_bwd_workspace_bytes
        ws.argtypes = [ctypes.c_int] * 3
        ws.restype = ctypes.c_longlong
        fns[name] = (fn, ws, notes)
    return fns


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def passes_ms(fn, calls=10):
    """{kernel: mean device ms a call}, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        found = re.search(r"rglru_bwd\w*|memset\w*|Memset\w*", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and found:
            out[found.group(0)] = out.get(found.group(0), 0.0) + \
                e.self_device_time_total / calls / 1e3
    return out


def bound_ms(B, S, D, dtype):
    """The bytes bound: x, ga, gx, y and dy read, dx, dga, dgx written
    once, lam and the biases read and their gradients written."""
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = B * S * D * (6 * size + 8) + 4 * D * 4
    return nbytes / 3.35e12 * 1e3, nbytes


def run_shape(fns, B, S, D, dtype):
    """Checks and times every build at (B, S, D) in ``dtype``; returns the
    names that failed."""
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(6)
    u = 0.9 + 0.099 * torch.rand((D,), generator=gen, device="cuda")
    lam = torch.log(torch.expm1(-torch.log(u) / ref.RGLRU_C))
    x, ga, gx = (torch.randn((B, S, D), generator=gen, device="cuda")
                 .to(dtype) for _ in range(3))
    b_a, b_i = (0.5 * torch.randn((D,), generator=gen, device="cuda")
                for _ in range(2))
    dy = torch.randn((B, S, D), generator=gen, device="cuda")
    y, _ = ref.reference_rglru(x, lam, ga, gx, b_a=b_a, b_i=b_i)
    want = ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, b_a=b_a, b_i=b_i)
    top = max(float(w.abs().max()) for w in want if w is not None)
    outs = [torch.empty_like(t) for t in (x, ga, gx)] + \
        [torch.empty((D,), device="cuda") for _ in range(3)]
    code = 1 if dtype == torch.bfloat16 else 0

    def call(name):
        fn, ws_fn, _ = fns[name]
        ws = torch.empty((ws_fn(B, S, D),), dtype=torch.uint8, device="cuda")
        dx, dga, dgx, dlam, dba, dbi = outs
        args = [x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gx.data_ptr(),
                b_a.data_ptr(), b_i.data_ptr(), None, y.data_ptr(),
                dy.data_ptr(), None, ws.data_ptr(), dx.data_ptr(),
                dga.data_ptr(), dgx.data_ptr(), dlam.data_ptr(),
                dba.data_ptr(), dbi.data_ptr(), None]
        return lambda: fn(*args, B, S, D, code, code, stream)

    b_ms, nbytes = bound_ms(B, S, D, dtype)
    print(f"{dtype}: B={B} S={S} D={D} fused_bias, bound {b_ms:.4f} ms by "
          f"bytes ({nbytes / 1e6:.2f} MB)", flush=True)
    errs, good, failed = {}, [], []
    for name in fns:
        for t in outs:
            t.fill_(float("nan"))
        if call(name)() != 0:
            print(f"  {name}: launch refused", flush=True)
            failed.append(name)
            continue
        torch.cuda.synchronize()
        got = outs[:1] + outs[3:4] + outs[1:3] + [None] + outs[4:]
        e = {}
        for k, g, w in zip(NAMES, got, want):
            if w is not None:
                e[k] = float((g.float() - w.float()).abs().max()) / max(
                    float(w.abs().max()), 1e-3 * top)
        errs[name] = e
        if name in UNCHECKED or all(
                v == v and v <= (TOL[dtype] if k in ("dx", "dga", "dgx")
                                 else 1e-4) for k, v in e.items()):
            good.append(name)
        else:
            print(f"  {name}: errors {e}, not timed", flush=True)
            failed.append(name)
    times = {name: [] for name in good}
    for name in good + good[::-1]:
        times[name].append(cuda_ms(call(name)))
    for name, ts in times.items():
        ps = passes_ms(call(name))
        print(f"  {name:52s} {ts[0]:.4f} {ts[1]:.4f} ms, "
              f"{b_ms / min(ts):.1%} of the bound; errors "
              + " ".join(f"{k} {v:.2e}" for k, v in errs[name].items())
              + "; passes " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        ps.items()), flush=True)
    return failed


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    picked = sys.argv[1:]
    unknown = [n for n in picked if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{list(VARIANTS)}")
    names = [COMMITTED_NAME] + [n for n in (picked or VARIANTS)
                                if n != COMMITTED_NAME]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    fns = build_all(names)
    for name, (_, _, notes) in fns.items():
        print(f"{name}: ptxas {'; '.join(notes)}", flush=True)
    failed = []
    for B, S, D in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            failed += run_shape(fns, B, S, D, dtype)
            torch.cuda.empty_cache()
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
