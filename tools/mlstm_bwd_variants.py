#!/usr/bin/env python3
"""Time variants of the mLSTM backward's wgmma_bf16 route on one GPU.

    python3 tools/mlstm_bwd_variants.py [variant ...]

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  Each variant is ``csrc/mlstm_scan_bwd.cu`` and the header of
the passes it shares with the forward, ``csrc/mlstm_wgmma.cuh``, with a
few text replacements that undo one design choice (or, where the name says
"timing only", drop a part of the work to show what it costs); each is
built by ``nvcc`` with the port's flags into its own directory under
``build/mlstm_bwd_variants/`` and called through its C entry point on the
wgmma route.  At xlstm-1.3b's train shape (B 1, S 4096, 4 heads of 1024,
bf16), from the port's own forward and its row statistics, each variant is
held against the plain backward (each gradient's error over the plain
one's max |.|, as chip_smoke.py's), then all are timed by CUDA events in
turns (in order, then in reverse), and each pass of each by the profiler.
It prints the card, each variant's ptxas registers and spills, its errors
and its times.  With names, only those variants (and the committed one).
"""
from __future__ import annotations

import ctypes
import math
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops, ref  # noqa: E402

CSRC = os.path.join(ROOT, "src/repro_torch/kernels/mlstm_scan/csrc")
SOURCE = os.path.join(CSRC, "mlstm_scan_bwd.cu")
HEADER = os.path.join(CSRC, "mlstm_wgmma.cuh")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "mlstm_bwd_variants")
WGMMA_ROUTE = 2   # the C function's route code
SHAPE = (1, 4096, 4, 1024)   # xlstm-1.3b's mLSTM at train_4k: B, S, H, Dh

# the output pass's part across chunks, a fresh accumulator per 64 of K
PART_SUM = """      wgmma_commit();
      wgmma_wait0();
      reg_fence(part);
#pragma unroll
      for (int e = 0; e < 64; ++e) oacc[e] += part[e];"""
# the D state pass's A operand, from the staged dnum halves
A_FROM_HALVES = """          const float x0 = ld_bf16(dht + po + sw_off(sx, col)) +
                           ld_bf16(dlt + po + sw_off(sx, col));
          const float x1 = ld_bf16(dht + po + sw_off(sx + 1, col)) +
                           ld_bf16(dlt + po + sw_off(sx + 1, col));"""

# name: [(text in the sources, its replacement)]
VARIANTS = {
    "as committed": [],
    "one accumulator over Dh": [
        ("      float part[64];\n      mbar_wait(full + s, (p / M::STAGES) & 1);",
         "      float (&part)[64] = oacc;\n"
         "      mbar_wait(full + s, (p / M::STAGES) & 1);"),
        ("          wgmma_ss(part, da, sw128_desc(bt + kk * 32, 16), kk > 0);",
         "          wgmma_ss(part, da, sw128_desc(bt + kk * 32, 16), 1);"),
        ("          wgmma_ss_mn(part, da, dbh, kk > 0);",
         "          wgmma_ss_mn(part, da, dbh, 1);"),
        (PART_SUM, """      wgmma_commit();
      wgmma_wait0();
      reg_fence(part);""")],
    "D^T not stored (timing only)": [
        ("      if (ci == 0 && !last_zero) {", "      if (false) {"),
        ("      if (c > 0) {\n        uint8_t* hs", "      if (false) {\n"
         "        uint8_t* hs")],
    "states' lo halves not loaded by the outputs (timing only)": [
        ("        mbar_expect_tx(full + s, M::STAGE_BYTES);",
         "        mbar_expect_tx(full + s, M::STAGE_BYTES - PANEL_BYTES);"),
        ("          tma_load_4d(bt + PANEL_BYTES, &tws, full + s, 0, 0, 1, "
         "tile);\n", ""),
        ("          for (int hl = 0; hl < 2; ++hl)\n"
         "            for (int q = 0; q < 2; ++q)",
         "          for (int hl = 0; hl < 1; ++hl)\n"
         "            for (int q = 0; q < 2; ++q)")],
    "outputs without the chunk's own pairs (timing only)": [
        ("      const int x0 = 8 * (e / 4) + cq;\n",
         "      const int x0 = 8 * (e / 4) + cq;\n"
         "      if (x0 >= 0) { mat[e] = mat[e + 1] = 0.f; continue; }\n"),
        ("    for (int kk = 0; kk < CT / 16; ++kk) {\n"
         "      const uint64_t db = sw128_desc(intra + kk * 16 * ROW_BYTES, "
         "PANEL_BYTES);",
         "    for (int kk = 0; kk < 0; ++kk) {\n"
         "      const uint64_t db = sw128_desc(intra + kk * 16 * ROW_BYTES, "
         "PANEL_BYTES);")],
    "D's A from dnum hi alone (timing only)": [
        (A_FROM_HALVES, """          const float x0 = ld_bf16(dht + po + sw_off(sx, col));
          const float x1 = ld_bf16(dht + po + sw_off(sx + 1, col));""")],
}


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
    stem = os.path.join(vdir, "mlstm_scan_bwd")
    # -I: the header copy's relative include of csrc/hopper.cuh resolves
    # from the source's own directory
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC,
                             "-o", stem + ".so", stem + ".cu", ERRORS],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), stem + ".so"


def load(path):
    lib = ctypes.CDLL(path)
    fn = lib.repro_mlstm_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws_fn = lib.repro_mlstm_scan_bwd_workspace_bytes
    ws_fn.argtypes = [ctypes.c_int] * 5
    ws_fn.restype = ctypes.c_longlong
    return fn, ws_fn


def ptxas_notes(log):
    """Registers and spills of the wgmma route's kernels, and any C75xx."""
    notes, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = re.search(r"(mlstm_(?:bwd_(?:rows|dstates|out|dig)|gates|"
                              r"states|qk)_kernel)(ILi(\d))?", line)
            name = found and found.group(1) + (
                f"<{found.group(3)}>" if found.group(3) else "")
        elif "C75" in line:
            notes.append(line.strip())
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            notes.append(f"{name} {regs} regs")
        elif name and "spill" in line and not line.strip().startswith("0 b"):
            notes.append(f"{name} {line.strip()}")
    return notes


def caller(fn, ws_fn, xs, h, stats, dh):
    q, k, v, ig, fg = xs
    B, S, H, Dh = q.shape
    outs = [torch.empty_like(t) for t in (q, k, v)] + \
        [torch.empty_like(ig), torch.empty_like(ig)]
    ws = torch.empty((ws_fn(B, S, H, Dh, WGMMA_ROUTE),), dtype=torch.uint8,
                     device="cuda")

    def run():
        err = fn(*(t.data_ptr() for t in xs), None, None, None,
                 h.data_ptr(), dh.data_ptr(), stats[0].data_ptr(),
                 stats[1].data_ptr(), ws.data_ptr(),
                 *(t.data_ptr() for t in outs), B, S, H, Dh, WGMMA_ROUTE,
                 math.sqrt(Dh), torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"CUDA error {err}")
        return outs
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("mlstm_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    names = ["as committed"] + [n for n in sys.argv[1:]
                                if n != "as committed"] \
        if len(sys.argv) > 1 else list(VARIANTS)
    # one nvcc per variant, all at once
    procs = {name: build_variant(name, VARIANTS[name]) for name in names}
    libs = {}
    for name, (proc, path) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        libs[name] = load(path)
        print(f"{name}: " + "; ".join(ptxas_notes(log)), flush=True)

    B, S, H, Dh = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    xs, _ = cs.mlstm_inputs(B, S, H, Dh, torch.bfloat16, False, None, gen)
    dh = torch.randn((B, S, H, Dh), generator=gen, device="cuda")
    h, _, stats = ops._forward(*xs, None, "wgmma_bf16", True)
    want = ref.reference_mlstm_bwd(*xs, h, stats, dh)
    runs = {name: caller(*lib, xs, h, stats, dh)
            for name, lib in libs.items()}
    print(f"B={B} S={S} H={H} Dh={Dh} bf16, against the plain backward "
          f"(dq dk dv dig dfg):", flush=True)
    for name, run in runs.items():
        dq, dk, dv, dig, rows = run()
        got = (dq, dk, dv, dig, ops.fg_grad(xs[4], dig, rows))
        torch.cuda.synchronize()
        errs = cs.grad_errors(got[:3], want[:3]) + \
            cs.grad_errors(got[3:], want[3:])
        print(f"  {name}: " + " ".join(f"{e:.3e}" for e in errs), flush=True)
    times = {name: [] for name in runs}
    for order in (list(runs), list(reversed(runs))):
        for name in order:
            times[name].append(cs.cuda_ms(runs[name], iters=10, warmup=1))
    from torch.profiler import ProfilerActivity, profile
    for name, ts in times.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                runs[name]()
            torch.cuda.synchronize()
        passes = {}
        for e in prof.key_averages():
            found = re.search(r"mlstm_\w+(<[^()]*>)?", e.key)
            if e.device_type == torch.autograd.DeviceType.CUDA and found \
                    and e.count:
                passes[found.group(0)] = passes.get(found.group(0), 0.0) + \
                    e.self_device_time_total / 3 / 1e3
        print(f"  {name}: " + ", ".join(f"{t:.4f}" for t in ts) + " ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
