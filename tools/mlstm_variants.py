#!/usr/bin/env python3
"""Time variants of mlstm_scan's wgmma_bf16 route on one GPU.

    python3 tools/mlstm_variants.py

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  Each variant is ``csrc/mlstm_scan.cu`` and the header of the
passes it shares with the backward, ``csrc/mlstm_wgmma.cuh``, with a few
text replacements that undo one design choice; each is built by ``nvcc``
with the port's flags into its own directory under
``build/mlstm_variants/`` and called through its C entry point on the
wgmma route.  Each variant is held against the plain
version at xlstm-1.3b's prefill shape and against the float64 recurrence
at chip_smoke.py's random-key stress case (the same inputs: the generator
is advanced through ``MLSTM_CASES`` as there), then all are timed by CUDA
events in turns (in order, then in reverse).  It prints the card, each
variant's ptxas spill lines, its errors and its two times.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mlstm_scan import ref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/mlstm_scan/csrc/"
                            "mlstm_scan.cu")
HEADER = os.path.join(os.path.dirname(SOURCE), "mlstm_wgmma.cuh")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "mlstm_variants")
WGMMA_ROUTE = 2   # the C function's route code

# the output pass's loads of n for a panel of keys
NV_LOADS = """      // n of the panel's keys (the quad's lanes take 16 keys each), loaded
      // before the wait for the tiles, under which its latency passes
      const float4* nv4 = reinterpret_cast<const float4*>(
          n_ws + slab * Dp + p * PANEL + 16 * (lane % 4));
      float nv[16];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 f = nv4[u];
        nv[4 * u] = f.x;
        nv[4 * u + 1] = f.y;
        nv[4 * u + 2] = f.z;
        nv[4 * u + 3] = f.w;
      }
"""

# name: [(text in the source, its replacement)]
VARIANTS = {
    "as committed": [],
    "q k^T in one accumulator": [
        ("float sacc[64], spart[64];", "float sacc[64];"),
        ("""        wgmma_ss(spart, sw128_desc(Qw + off, 16),
                 sw128_desc(st + NA * PANEL_BYTES + off, 16), kk > 0);""",
         """        wgmma_ss(sacc, sw128_desc(Qw + off, 16),
                 sw128_desc(st + NA * PANEL_BYTES + off, 16), 1);"""),
        ("wgmma_ss(spart, sw128_desc(Qw + PANEL_BYTES + off, 16),",
         "wgmma_ss(sacc, sw128_desc(Qw + PANEL_BYTES + off, 16),"),
        ("""      reg_fence(spart);
#pragma unroll
      for (int e = 0; e < 64; ++e) sacc[e] += spart[e];""",
         "      reg_fence(sacc);")],
    "gates and n not loaded ahead": [
        ("""      const float bT = gch[2 * slab], lmax = gch[2 * slab + 1];
      const float gm = ct < CT ? ggm[slab * CT + ct] : 0.f;
""", ""),
        ("""      const float m_new = fmaxf(bT + m_prev, lmax);""",
         """      const float bT = gch[2 * slab], lmax = gch[2 * slab + 1];
      const float gm = ct < CT ? ggm[slab * CT + ct] : 0.f;
      const float m_new = fmaxf(bT + m_prev, lmax);"""),
        (NV_LOADS + """      mbar_wait(full + s, (p / M::STAGES) & 1);
""", """      mbar_wait(full + s, (p / M::STAGES) & 1);
"""),
        ("""      wgmma_commit();
      // q . n over the panel's keys, from the staged q
""", """      wgmma_commit();
""" + NV_LOADS)],
    "three output stages": [
        ("  static constexpr int STAGES = 4;",
         "  static constexpr int STAGES = 3;")],
    "chunk 0's zero state stored and read": [
        ("const bool store_entry = c > 0 || C0 != nullptr;",
         "const bool store_entry = true;"),
        ("const bool zero_entry = c == 0 && m0 == nullptr;",
         "const bool zero_entry = false;")],
    "workspace row by row": [
        ("""              tma_store_4d(&tws, my_stg + (2 * hl + p) * M::STG_PANEL, 0,
                           64 * wg, hl,
                           (int)((slab * nt + jt) * 2 * nt + 2 * it + p));""",
         """              tma_store_4d(&tws, my_stg + (2 * hl + p) * M::STG_PANEL,
                           i0 + p * PANEL, j0 + 64 * wg, hl, (int)slab);"""),
        ("""        tma_load_4d(st + PANEL_BYTES, &tws, full + s, 0, 0, 0, tile);
        tma_load_4d(st + 2 * PANEL_BYTES, &tws, full + s, 0, 0, 1, tile);""",
         """        tma_load_4d(st + PANEL_BYTES, &tws, full + s, p * PANEL, j0, 0,
                    (int)slab);
        tma_load_4d(st + 2 * PANEL_BYTES, &tws, full + s, p * PANEL, j0, 1,
                    (int)slab);"""),
        ("""  const cuuint64_t wdims[4] = {PANEL, CTILE, 2,
                               (cuuint64_t)(BH * seg * nt * 2 * nt)};
  const cuuint64_t wstrides[3] = {PANEL * 2, PANEL * CTILE * 2,
                                  PANEL * CTILE * 2 * 2};""",
         """  const cuuint64_t wdims[4] = {(cuuint64_t)Dp, (cuuint64_t)Dp, 2,
                               (cuuint64_t)(BH * seg)};
  const cuuint64_t wstrides[3] = {(cuuint64_t)Dp * 2,
                                  (cuuint64_t)Dp * Dp * 2,
                                  (cuuint64_t)Dp * Dp * 2 * 2};""")],
}
SHAPE = (4, 1000, 4, 1024)   # xlstm-1.3b's prefill: B, S, H, Dh


def build_variant(name, edits):
    texts = {path: open(path).read() for path in (SOURCE, HEADER)}
    for old, new in edits:
        where = [p for p, t in texts.items() if old in t]
        if len(where) != 1 or texts[where[0]].count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the sources once")
        texts[where[0]] = texts[where[0]].replace(old, new)
    vdir = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                     for c in name))
    os.makedirs(vdir, exist_ok=True)
    for path, text in texts.items():
        with open(os.path.join(vdir, os.path.basename(path)), "w") as f:
            f.write(text)
    stem = os.path.join(vdir, "mlstm_scan")
    # -I: the copies' relative include of csrc/hopper.cuh resolves from the
    # source's own directory (the copy of the header, beside the copy of
    # the source, comes first)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          os.path.dirname(SOURCE), "-o", stem + ".so",
                          stem + ".cu", ERRORS],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{res.stderr}")
    notes = [line.strip() for line in (res.stdout + res.stderr).splitlines()
             if "spill" in line and not line.strip().startswith("0 b")]
    lib = ctypes.CDLL(stem + ".so")
    fn = lib.repro_mlstm_scan
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws_fn = lib.repro_mlstm_scan_workspace_bytes
    ws_fn.argtypes = [ctypes.c_int] * 5
    ws_fn.restype = ctypes.c_longlong
    return fn, ws_fn, notes


def caller(fn, ws_fn, xs):
    """A function that runs the variant on xs into fresh outputs and
    returns (h, C, n, m)."""
    q, k, v, ig, fg = xs
    B, S, H, Dh = q.shape
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = (torch.empty((B, S, H, Dh), **f32),
            torch.empty((B, H, Dh, Dh), **f32), torch.empty((B, H, Dh), **f32),
            torch.empty((B, H), **f32))
    ws = torch.empty((ws_fn(B, S, H, Dh, WGMMA_ROUTE),), dtype=torch.uint8,
                     device="cuda")

    def run():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                 fg.data_ptr(), None, None, None, ws.data_ptr(),
                 *(t.data_ptr() for t in outs), None, None, B, S, H, Dh,
                 WGMMA_ROUTE,
                 math.sqrt(Dh), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")
        return outs
    return run


def fmt(rels):
    return " ".join(f"{k}={r:.3e}" for k, r in rels.items())


def main() -> int:
    if not torch.cuda.is_available():
        print("mlstm_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = {}
    for name, edits in VARIANTS.items():
        fn, ws_fn, notes = build_variant(name, edits)
        libs[name] = (fn, ws_fn)
        print(f"{name}: built; " + ("; ".join(notes) if notes
                                     else "no spills"), flush=True)

    # chip_smoke.py's random-key stress case, on the same inputs
    gen = torch.Generator(device="cuda").manual_seed(3)
    for _, B, S, H, Dh, dtype, with_init, stress in cs.MLSTM_CASES:
        cs.mlstm_inputs(B, S, H, Dh, dtype, with_init, stress, gen)
    _, B, S, H, Dh, dtype = cs.MLSTM_ORACLE_CASE
    oxs, _ = cs.mlstm_inputs(B, S, H, Dh, dtype, False, "random-keys", gen)
    wh, wstate = ref.sequential_oracle(*oxs, dtype=torch.float64)
    truth = (wh,) + wstate
    plain = ref.reference_mlstm(*oxs, chunk=8)
    print(f"stress-random-keys against the float64 recurrence: plain at "
          f"chunk 8 {fmt(cs.rel_errs((plain[0],) + plain[1], truth))}",
          flush=True)
    for name, (fn, ws_fn) in libs.items():
        got = caller(fn, ws_fn, oxs)()
        torch.cuda.synchronize()
        print(f"  {name}: {fmt(cs.rel_errs(got, truth))}", flush=True)
    del oxs, wh, wstate, truth, plain
    torch.cuda.empty_cache()

    B, S, H, Dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    xs, _ = cs.mlstm_inputs(B, S, H, Dh, torch.bfloat16, False, None, gen)
    wh, wstate = ref.reference_mlstm(*xs, chunk=cs.MLSTM_PLAIN_CHUNK)
    runs = {name: caller(fn, ws_fn, xs) for name, (fn, ws_fn) in libs.items()}
    print(f"B={B} S={S} H={H} Dh={Dh} bf16, against the plain version:",
          flush=True)
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        print(f"  {name}: {fmt(cs.rel_errs(got, (wh,) + wstate))}",
              flush=True)
    times = {name: [] for name in runs}
    for order in (list(runs), list(reversed(runs))):
        for name in order:
            times[name].append(cs.cuda_ms(runs[name]))
    for name, ts in times.items():
        print(f"  {name}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
