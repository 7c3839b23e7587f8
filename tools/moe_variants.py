#!/usr/bin/env python3
"""Time variants of moe_gmm's wgmma_bf16 route on one GPU.

    python3 tools/moe_variants.py

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  Each variant is ``csrc/moe_gmm.cu`` with a few text
replacements that undo or change one design choice; all are built at once
(one ``nvcc`` each, started together) with the port's flags into
``build/moe_variants/`` and called through their C entry point on the
wgmma route.  At each shape every variant runs against the plain version
once, then all are timed by CUDA events in turns (in order, then in
reverse), beside the three-``bmm`` yardstick at the prefill shapes.  The
shapes are granite-moe's prefill bucket with every row live, its decode
with a seeded top-8 routing of 4 tokens (the buckets' fills handed over
as counts, so that only the touched experts' weights stream) and a
mixtral expert FFN with 8% pad rows.  It prints the card, each variant's
ptxas spill and wgmma-serialisation lines, and per shape each variant's
two times.
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
from repro_torch.models.layers import act_fn  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/moe_gmm/csrc/"
                            "moe_gmm.cu")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "moe_variants")
# the swapped product for decode buckets, spliced in by its variant
SWAPPED = os.path.join(ROOT, "tools", "moe_swapped.cuh")
WGMMA_ROUTE = kernel.ROUTES["wgmma_bf16"]

# name: [(text in the source, its replacement)]
VARIANTS = {
    "as committed": [],
    "gate/up: 3 stages": [
        ("PrefillUpTile = Tile<2, 128, 4, 1, true>;",
         "PrefillUpTile = Tile<2, 128, 3, 1, true>;")],
    "gate/up: 2 stages": [
        ("PrefillUpTile = Tile<2, 128, 4, 1, true>;",
         "PrefillUpTile = Tile<2, 128, 2, 1, true>;")],
    "down: 2 stages": [
        ("PrefillDownTile = Tile<2, 256, 3, 1, true>;",
         "PrefillDownTile = Tile<2, 256, 2, 1, true>;")],
    "down: N 128, 4 stages": [
        ("PrefillDownTile = Tile<2, 256, 3, 1, true>;",
         "PrefillDownTile = Tile<2, 128, 4, 1, true>;")],
    "prefill: a CTA a tile": [
        ("PrefillUpTile = Tile<2, 128, 4, 1, true>;",
         "PrefillUpTile = Tile<2, 128, 4, 1, false>;"),
        ("PrefillDownTile = Tile<2, 256, 3, 1, true>;",
         "PrefillDownTile = Tile<2, 256, 3, 1, false>;")],
    "tiles always rows fastest": [
        ("if (n_tiles_n > n_tiles_m) {  // rows fastest",
         "if (true) {  // rows fastest")],
    "tiles always columns fastest": [
        ("if (n_tiles_n > n_tiles_m) {  // rows fastest",
         "if (false) {  // rows fastest")],
    "decode: persistent grid": [
        ("DecodeUpTile = Tile<1, 64, 4, 2, false>;",
         "DecodeUpTile = Tile<1, 64, 4, 2, true>;"),
        ("DecodeDownTile = Tile<1, 64, 4, 2, false>;",
         "DecodeDownTile = Tile<1, 64, 4, 2, true>;")],
    "decode: N 128, one CTA an SM": [
        ("DecodeUpTile = Tile<1, 64, 4, 2, false>;",
         "DecodeUpTile = Tile<1, 128, 4, 1, false>;"),
        ("DecodeDownTile = Tile<1, 64, 4, 2, false>;",
         "DecodeDownTile = Tile<1, 128, 4, 1, false>;")],
    "decode: 6 stages, one CTA an SM": [
        ("DecodeUpTile = Tile<1, 64, 4, 2, false>;",
         "DecodeUpTile = Tile<1, 64, 6, 1, false>;"),
        ("DecodeDownTile = Tile<1, 64, 4, 2, false>;",
         "DecodeDownTile = Tile<1, 64, 6, 1, false>;")],
    "decode: swapped product (buckets of <= 8 rows)": [
        ("constexpr int DECODE_ROWS = 64;", "constexpr int DECODE_ROWS = 8;"),
        (": run_wgmma<DecodeUpTile, DecodeDownTile>(",
         ": run_swapped("),
        ("}  // namespace\n\n// xe: (E, C, d)",
         "SWAPPED_SOURCE\n}  // namespace\n\n// xe: (E, C, d)")],
    "counts ignored (every row live)": [
        ("return counts == nullptr ? M : min(max(counts[e], 0), M);",
         "return M;")],
}

# (name, E, C, d, f, pad rows a bucket or None, routed tokens or None)
SHAPES = [
    ("granite-prefill", 40, 1000, 1536, 512, 0, None),
    ("granite-decode-routed", 40, 8, 1536, 512, None, 4),
    ("mixtral-prefill", 8, 1250, 4096, 14336, 100, None),
]
TOL = 2e-2   # bf16 y against the float32 plain version, of max |y|


def build_variants():
    """{name: (C function, ptxas notes)}, built in parallel."""
    os.makedirs(OUT, exist_ok=True)
    src0 = open(SOURCE).read()
    procs = {}
    for name, edits in VARIANTS.items():
        src = src0
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        src = src.replace("SWAPPED_SOURCE", open(SWAPPED).read())
        stem = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                         for c in name))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        # -I: the copy's relative include of csrc/hopper.cuh resolves from
        # the source's own directory
        procs[name] = (stem, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", os.path.dirname(SOURCE),
             "-o", stem + ".so", stem + ".cu", ERRORS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "C75" in ln or ("spill" in ln
                                      and not ln.strip().startswith("0 b"))]
        fn = ctypes.CDLL(stem + ".so").repro_moe_gmm_ffn
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
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


def inputs(E, C, d, f, pad, tokens, gen):
    """(xe, w1, w3, w2, counts) in bf16 on the card; counts int32 or None."""
    counts = None
    x = torch.randn((E, C, d), generator=gen, device="cuda")
    if tokens:
        logits = torch.randn((tokens, E), generator=gen, device="cuda")
        idx = torch.topk(logits, 8, dim=-1).indices.reshape(-1)
        counts = torch.zeros(E, dtype=torch.int32, device="cuda")
        counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
        rows = torch.arange(C, device="cuda")
        x = x * (rows[None, :] < counts[:, None])[..., None]
    elif pad:
        x[:, C - pad:] = 0.0
        counts = torch.full((E,), C - pad, dtype=torch.int32, device="cuda")
    ws = [torch.randn(s, generator=gen, device="cuda") / math.sqrt(s[1])
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    return (x.to(torch.bfloat16), *(w.to(torch.bfloat16) for w in ws),
            counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    fns = build_variants()
    for name, (_, notes) in fns.items():
        print(f"{name}: ptxas {notes or 'no spills, no serialised wgmma'}",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    silu = act_fn("swiglu")
    for label, E, C, d, f, pad, tokens in SHAPES:
        xe, w1, w3, w2, counts = inputs(E, C, d, f, pad, tokens, gen)
        h = torch.empty((E, C, f), dtype=xe.dtype, device="cuda")
        y = torch.empty_like(xe)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            return lambda: fn(xe.data_ptr(), w1.data_ptr(), w3.data_ptr(),
                              w2.data_ptr(), h.data_ptr(), y.data_ptr(),
                              None if counts is None else counts.data_ptr(),
                              E, C, d, f, 0, WGMMA_ROUTE, stream)
        want = ref.reference_expert_ffn(
            xe.float(), {"w1": w1.float(), "w3": w3.float(),
                         "w2": w2.float()}, "swiglu", counts)
        scale = float(want.abs().max())
        errs = {}
        for name, (fn, _) in fns.items():
            if call(fn)() != 0:
                raise SystemExit(f"{name}: launch refused")
            torch.cuda.synchronize()
            errs[name] = float((y.float() - want).abs().max()) / scale
            if not errs[name] <= TOL:
                raise SystemExit(f"{name} at {label}: error {errs[name]} "
                                 f"> {TOL}")
        del want
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cuda_ms(call(fns[name][0]),
                                       iters=100 if C <= 64 else 20))
        line = f"{label} E={E} C={C} d={d} f={f}"
        if counts is not None:
            line += (f", {int((counts > 0).sum())} experts touched, "
                     f"{int(counts.sum())} live rows")
        if C > 64:
            yard_ms = cuda_ms(lambda: torch.bmm(
                silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3), w2))
            line += f"; yardstick (3 bmm + act) {yard_ms:.4f} ms"
        print(line, flush=True)
        for name, ts in times.items():
            print(f"  {name:34s} {ts[0]:.4f} {ts[1]:.4f} ms, rel err "
                  f"{errs[name]:.3e}", flush=True)
        del xe, w1, w3, w2, h, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
