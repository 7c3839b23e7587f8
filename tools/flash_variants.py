#!/usr/bin/env python3
"""Time variants of the flash-attention kernel's bf16 route on one GPU.

    python3 tools/flash_variants.py

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  Each variant is ``csrc/flash_attention.cu`` with a few text
replacements that undo one design choice; each is built by ``nvcc`` with
the port's flags into ``build/flash_variants/`` and called through its C
entry point.  At each shape every variant runs against the plain version
once, then all are timed by CUDA events in turns (in order, then in
reverse), beside ``scaled_dot_product_attention``.  It prints the card,
each variant's ptxas spill and wgmma-serialisation lines, and per shape
each variant's two times and its best time over SDPA's.
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
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention.cu")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "flash_variants")

# name: [(text in the source, its replacement)]
VARIANTS = {
    "as committed": [],
    "two consumer warpgroups at Dh 64": [
        ("CONSUMERS = DHP == 64 ? 3 : 2;", "CONSUMERS = 2;")],
    "two stages up to Dh 128": [
        ("STAGES = DHP > 128 ? 2 : 3;", "STAGES = 2;")],
    "grid (q-tiles, B*H)": [
        ("const int b = blockIdx.x / H;", "const int b = blockIdx.y / H;"),
        ("const int h = blockIdx.x % H;", "const int h = blockIdx.y % H;"),
        ("(gridDim.y - 1 - blockIdx.y) * BQ;",
         "(gridDim.x - 1 - blockIdx.x) * BQ;"),
        ("grid(B * H, (S + T::BQ - 1) / T::BQ);",
         "grid((S + T::BQ - 1) / T::BQ, B * H);")],
}

# (B, S, H, KH, Dh, causal, window): the prefill shapes of chip_smoke.py's
# timed cases, h2o-danube's windowed one and a long causal sequence
SHAPES = [(4, 1000, 36, 36, 64, True, 0), (4, 1000, 24, 8, 64, True, 0),
          (4, 1000, 16, 1, 256, True, 2048), (2, 1000, 32, 8, 120, True, 256),
          (2, 4000, 16, 16, 128, True, 0)]
TOL = 2e-2   # bf16 output against the float32 plain version


def build_variant(name, edits):
    src = open(SOURCE).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, name.replace(" ", "_").replace("*", "")
                        .replace(",", "").replace("(", "").replace(")", ""))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    # -I: the copy's relative include of csrc/hopper.cuh resolves from the
    # source's own directory
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                          os.path.dirname(SOURCE), "-o", stem + ".so",
                          stem + ".cu", ERRORS],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{res.stderr}")
    notes = [line.strip() for line in (res.stdout + res.stderr).splitlines()
             if "C7514" in line or ("spill" in line
                                    and not line.strip().startswith("0 b"))]
    fn = ctypes.CDLL(stem + ".so").repro_flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, notes


def cuda_ms(fn, iters=50, warmup=5):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    fns = {}
    for name, edits in VARIANTS.items():
        fns[name], notes = build_variant(name, edits)
        print(f"{name}: ptxas {notes or 'no spills, no serialised wgmma'}",
              flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, KH, Dh, causal, window in SHAPES:
        q, k, v = (torch.randn((B, S, h, Dh), generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (H, KH, KH))
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn):
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), None, B, S, H, KH, Dh,
                              int(causal),
                              window, 1, 1.0 / math.sqrt(Dh), stream)
        want = ref.reference_attention(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
        for name, fn in fns.items():
            if call(fn)() != 0:
                raise SystemExit(f"{name}: launch refused")
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            if not err <= TOL:
                raise SystemExit(f"{name}: error {err} > {TOL}")
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cuda_ms(call(fns[name])))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=H != KH))
        print(f"B={B} S={S} H={H} KH={KH} Dh={Dh} causal={causal} "
              f"window={window}: sdpa {sdpa:.4f} ms", flush=True)
        for name, ts in times.items():
            print(f"  {name:34s} {ts[0]:.4f} {ts[1]:.4f} ms, "
                  f"{min(ts) / sdpa:.2f}x sdpa", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
