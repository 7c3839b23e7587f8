#!/usr/bin/env python3
"""Time variants of the expert FFN backward's wgmma_bf16 route on one GPU.

    python3 tools/moe_bwd_variants.py [variant ...]

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  Each variant is ``csrc/moe_gmm_bwd.cu`` (and its header
``csrc/moe_gmm.cuh``) with a few text replacements that undo or change one
design choice; all are built at once (one ``nvcc`` each, started together)
with the port's flags into ``build/moe_bwd_variants/`` and called through
their C entry point on the wgmma route.  At granite-moe-3b-a800m's train
shape (E 40, C 1024, d 1536, f 512, the fills of a seeded top-8 routing of
4096 tokens) and its prefill bucket with every row live, every variant is
held against the plain backward once, then all are timed by CUDA events in
turns (in order, then in reverse) beside the plain backward, each pass of
every variant by the profiler.  It prints the card, each variant's ptxas
spill and wgmma-serialisation lines, and per shape each variant's two
times and its passes.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.moe_gmm import kernel, ref  # noqa: E402

CSRC = os.path.join(ROOT, "src/repro_torch/kernels/moe_gmm/csrc")
SOURCE = os.path.join(CSRC, "moe_gmm_bwd.cu")
HEADER = os.path.join(CSRC, "moe_gmm.cuh")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "moe_bwd_variants")
WGMMA_ROUTE = kernel.ROUTES["wgmma_bf16"]
# the passes, by parts of their kernels' names, demangled or not
PASSES = (("up", ("gmm_bwd_up",)), ("dx", ("gmm_bwd_dx",)),
          ("dw1+dw3", ("gmm_bwd_wt_wgmma<2>", "gmm_bwd_wt_wgmmaILi2E")),
          ("dw2", ("gmm_bwd_wt_wgmma<1>", "gmm_bwd_wt_wgmmaILi1E")))

# name: [(text in the source or header, its replacement)]
VARIANTS = {
    "as committed": [],
    "up: 3 stages": [
        ("static constexpr int BM = 64 * CONS, BN = 64, STAGES = 4;",
         "static constexpr int BM = 64 * CONS, BN = 64, STAGES = 3;")],
    "up: 2 stages": [
        ("static constexpr int BM = 64 * CONS, BN = 64, STAGES = 4;",
         "static constexpr int BM = 64 * CONS, BN = 64, STAGES = 2;")],
    "dx: 3 stages": [
        ("BN = 128, NP = BN / PANEL, STAGES = 4;",
         "BN = 128, NP = BN / PANEL, STAGES = 3;")],
    "weights: 3 stages": [
        ("static constexpr int STAGES = 4;",
         "static constexpr int STAGES = 3;")],
    "weights: 2 stages": [
        ("static constexpr int STAGES = 4;",
         "static constexpr int STAGES = 2;")],
    "a CTA a tile": [
        ("const int grid = (int)(n_tiles < sms ? n_tiles : sms);",
         "const int grid = (int)n_tiles;")],
    "two CTAs an SM's worth of grid": [
        ("const int grid = (int)(n_tiles < sms ? n_tiles : sms);",
         "const int grid = (int)(n_tiles < 2 * sms ? n_tiles : 2 * sms);")],
    "tiles always rows fastest": [
        ("if (n_tiles_n > n_tiles_m) {  // rows fastest",
         "if (true) {  // rows fastest")],
    "tiles always columns fastest": [
        ("if (n_tiles_n > n_tiles_m) {  // rows fastest",
         "if (false) {  // rows fastest")],
}

# (name, E, C, d, f, routed tokens or None: every row live)
SHAPES = [("granite-train", 40, 1024, 1536, 512, 4096),
          ("granite-prefill-all-live", 40, 1000, 1536, 512, None)]
TOL = 2e-2   # each bf16 gradient against the float32 plain one, of its max


def build_variants(names):
    """{name: (C function, ptxas notes)}, built in parallel."""
    os.makedirs(OUT, exist_ok=True)
    texts = {SOURCE: open(SOURCE).read(), HEADER: open(HEADER).read()}
    procs = {}
    for name in names:
        stem = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                         for c in name))
        os.makedirs(stem, exist_ok=True)
        files = dict(texts)
        for old, new in VARIANTS[name]:
            hits = [p for p, t in files.items() if old in t]
            if len(hits) != 1 or files[hits[0]].count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the sources "
                                 f"once")
            files[hits[0]] = files[hits[0]].replace(old, new)
        for path, text in files.items():
            with open(os.path.join(stem, os.path.basename(path)), "w") as f:
                f.write(text)
        # the copies' includes: moe_gmm.cuh beside the source, and the
        # header's relative include of csrc/hopper.cuh from CSRC (-I)
        procs[name] = (stem, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC,
             "-o", os.path.join(stem, "lib.so"),
             os.path.join(stem, "moe_gmm_bwd.cu"), ERRORS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "C75" in ln or ("spill" in ln
                                      and not ln.strip().startswith("0 b"))]
        fn = ctypes.CDLL(os.path.join(stem, "lib.so")).repro_moe_gmm_ffn_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, notes)
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


def pass_ms(fn, iters=10):
    """Each pass's mean device ms over ``iters`` calls, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label, _ in PASSES}
    for e in prof.key_averages():
        label = next((lb for lb, parts in PASSES
                      if any(p in e.key for p in parts)), None)
        if label is not None:
            dev = getattr(e, "device_time_total", None)
            if dev is None:
                dev = e.cuda_time_total
            out[label] += dev / 1e3 / iters
    return out


def inputs(E, C, d, f, tokens, gen):
    """(xe, w1, w3, w2, dy, counts) in bf16 on the card, counts int32 or
    None; the rows past each fill hold data."""
    counts = None
    if tokens:
        logits = torch.randn((tokens, E), generator=gen, device="cuda")
        idx = torch.topk(logits, 8, dim=-1).indices.reshape(-1)
        counts = torch.zeros(E, dtype=torch.int32, device="cuda")
        counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        counts = counts.clamp(max=C)
    x, dy = (torch.randn((E, C, d), generator=gen, device="cuda")
             for _ in range(2))
    ws = [torch.randn(s, generator=gen, device="cuda") / math.sqrt(s[1])
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    return (x.bfloat16(), *(w.bfloat16() for w in ws), dy.bfloat16(),
            counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    fns = build_variants(names)
    for name, (_, notes) in fns.items():
        print(f"{name}: ptxas {notes or 'no spills, no serialised wgmma'}",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for label, E, C, d, f, tokens in SHAPES:
        xe, w1, w3, w2, dy, counts = inputs(E, C, d, f, tokens, gen)
        outs = [torch.empty_like(t) for t in (xe, w1, w3, w2)]
        ws = torch.empty((3, E, C, f), dtype=xe.dtype, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            return lambda: fn(xe.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                              w2.data_ptr(), dy.data_ptr(),
                              *(t.data_ptr() for t in outs), ws.data_ptr(),
                              None if counts is None else counts.data_ptr(),
                              E, C, d, f, 0, WGMMA_ROUTE, stream)
        want = ref.reference_expert_ffn_bwd(
            xe.float(), {"w1": w1.float(), "w3": w3.float(),
                         "w2": w2.float()}, dy.float(), "swiglu", counts)
        errs = {}
        for name, (fn, _) in fns.items():
            if call(fn)() != 0:
                raise SystemExit(f"{name}: launch refused")
            torch.cuda.synchronize()
            errs[name] = max(float((g.float() - w).abs().max())
                             / float(w.abs().max())
                             for g, w in zip(outs, want))
            if not errs[name] <= TOL:
                raise SystemExit(f"{name} at {label}: error {errs[name]} "
                                 f"> {TOL}")
        del want
        x_, p_ = xe, {"w1": w1, "w3": w3, "w2": w2}
        plain = [cuda_ms(lambda: ref.reference_expert_ffn_bwd(
            x_, p_, dy, "swiglu", counts), iters=10)]
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cuda_ms(call(fns[name][0])))
        plain.append(cuda_ms(lambda: ref.reference_expert_ffn_bwd(
            x_, p_, dy, "swiglu", counts), iters=10))
        live = E * C if counts is None else int(counts.sum())
        print(f"{label} E={E} C={C} d={d} f={f}, {live} live rows; plain "
              f"backward {plain[0]:.4f} {plain[1]:.4f} ms", flush=True)
        for name, ts in times.items():
            passes = pass_ms(call(fns[name][0]))
            print(f"  {name:32s} {ts[0]:.4f} {ts[1]:.4f} ms, rel err "
                  f"{errs[name]:.3e}; passes " + ", ".join(
                      f"{k} {v:.4f}" for k, v in passes.items()), flush=True)
        del xe, w1, w3, w2, dy, outs, ws
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
