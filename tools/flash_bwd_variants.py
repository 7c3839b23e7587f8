#!/usr/bin/env python3
"""Time variants of the flash-attention backward's bf16 route on one GPU.

    python3 tools/flash_bwd_variants.py [variant ...]

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  Each variant is ``csrc/flash_attention_bwd.cu`` with a few
text replacements that change one design choice (all of them, or those
named on the command line); each is built by ``nvcc`` with the port's
flags (one process each, all at once) into ``build/flash_bwd_variants/``
and called through its C entry point on the forward's own output and
log-sum-exp.  At each shape every variant runs against the plain backward
once, then all are timed by CUDA events in turns (in order, then in
reverse), beside SDPA's backward (with an explicit band mask where a
window bites: masked SDPA) and the bound of
``chip_smoke.attention_bwd_bound``; the first variant's passes are timed
one by one by the profiler.  At the MQA and GQA shapes the first variant
is also timed at every split of the query heads that the dK/dV pass can
take.  It prints the card, each variant's ptxas lines for the backward's
kernels (registers, spills, injected or serialised wgmma), and per shape
each variant's two times and its best time over SDPA's and the bound.
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

from chip_smoke import attention_bwd_bound, sdpa_bwd_call  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_bwd.cu")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "flash_bwd_variants")

# the committed masking of P (dQ) and P^T (dK/dV): entries set to -inf
# before the exponent, on tiles that cross an edge only
DQ_MASK = """      if (partial) {
#pragma unroll
        for (int i = 0; i < BKEYS / 2; ++i)
          if (!visible(my_row + 8 * ((i / 2) % 2),
                       k0 + 8 * (i / 4) + my_col + i % 2, S, causal, window))
            sc[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < BKEYS / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse2[(i / 2) % 2]));"""
KV_MASK = """      if (partial) {
#pragma unroll
        for (int i = 0; i < QT / 2; ++i)
          if (!visible(q0 + 8 * (i / 4) + my_col + i % 2,
                       my_key + 8 * ((i / 2) % 2), S, causal, window))
            st[i] = -INFINITY;
      }
#pragma unroll
      for (int i = 0; i < QT / 2; ++i)
        st[i] = exp2f(fmaf(st[i], scale_log2,
                           -rows[8 * (i / 4) + my_col + i % 2]));"""

# name: [(text in the source, its replacement)]
VARIANTS = {
    "as committed": [],
    "dK/dV: dS from P in float32": [
        ("(i % 2 ? bf16_hi(pp) : bf16_lo(pp)) * (dpt[i]",
         "st[i] * (dpt[i]")],
    "masked by a select after the exponent": [
        (DQ_MASK, """#pragma unroll
      for (int i = 0; i < BKEYS / 2; ++i) {
        const int hr = (i / 2) % 2;
        const float p = exp2f(fmaf(sc[i], scale_log2, -lse2[hr]));
        sc[i] = partial && !visible(my_row + 8 * hr,
                                    k0 + 8 * (i / 4) + my_col + i % 2,
                                    S, causal, window)
                    ? 0.f
                    : p;
      }"""),
        (KV_MASK, """#pragma unroll
      for (int i = 0; i < QT / 2; ++i) {
        const int c = 8 * (i / 4) + my_col + i % 2;   // query q0 + c
        const float p = exp2f(fmaf(st[i], scale_log2, -rows[c]));
        st[i] = partial && !visible(q0 + c, my_key + 8 * ((i / 2) % 2), S,
                                    causal, window)
                    ? 0.f
                    : p;
      }""")],
    "dQ: two consumers at Dh 64": [
        ("CONSUMERS = DHP > 128 ? 1 : DHP == 64 ? 3 : 2;",
         "CONSUMERS = DHP > 128 ? 1 : 2;")],
    "dK/dV: two consumers at Dh 64": [
        ("static constexpr int CONSUMERS = DHP == 64 ? 3 : 2;",
         "static constexpr int CONSUMERS = 2;")],
    "dK/dV: 128 queries a stage at Dh 64, two consumers": [
        ("static constexpr int CONSUMERS = DHP == 64 ? 3 : 2;",
         "static constexpr int CONSUMERS = 2;"),
        ("static constexpr int QT = 64;",
         "static constexpr int QT = DHP == 64 ? 128 : 64;")],
    "dK/dV: two stages": [
        ("STAGES = DHP > 128 ? 2 : DHP > 64 ? 3 : 4;", "STAGES = 2;")],
    "dQ: two stages": [
        ("STAGES = DHP > 128 ? 2 : 3;\n  static constexpr int Q_PANEL = BQ",
         "STAGES = 2;\n  static constexpr int Q_PANEL = BQ")],
    "dK/dV: key tiles in grid order x": [
        ("const int split = blockIdx.x % splits;",
         "const int split = blockIdx.y % splits;"),
        ("const int bkh = blockIdx.x / splits;",
         "const int bkh = blockIdx.y / splits;"),
        ("const int k0 = blockIdx.y * BKEYS;",
         "const int k0 = blockIdx.x * BKEYS;"),
        ("<<<dim3(B * KH * splits, (S + TB::BKEYS - 1) / TB::BKEYS),",
         "<<<dim3((S + TB::BKEYS - 1) / TB::BKEYS, B * KH * splits),")],
}

# (name, B, S, H, KH, Dh, causal, window): chip_smoke.py's timed backward
# shapes and a Dh 128 one
SHAPES = [("minicpm-train", 1, 4096, 36, 36, 64, True, 0),
          ("griffin-train", 1, 4096, 16, 1, 256, True, 2048),
          ("minicpm-prefill", 4, 1000, 36, 36, 64, True, 0),
          ("granite-prefill", 4, 1000, 24, 8, 64, True, 0),
          ("griffin-prefill", 4, 1000, 16, 1, 256, True, 2048),
          ("dh128", 2, 2048, 16, 16, 128, True, 0)]
TOL = 2e-2   # chip_smoke's BWD_TOL in bf16, of each gradient's max |.|


def start_build(name, edits):
    """(library path, the nvcc process building it) of one variant."""
    src = open(SOURCE).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the source once")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    stem = os.path.join(OUT, re.sub(r"[^A-Za-z0-9]+", "_", name))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    # -I: the copy's relative include of csrc/hopper.cuh resolves from the
    # source's own directory
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I",
                             os.path.dirname(SOURCE), "-o", stem + ".so",
                             stem + ".cu", ERRORS], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return stem + ".so", proc


def ptxas_notes(log):
    """The ptxas lines of the bf16 kernels: registers, spills, C75xx."""
    notes, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        bf16 = current is not None and ("bf16" in current
                                        or "reduce" in current)
        if "C75" in line or (bf16 and ("registers" in line
                                       or "spill" in line)):
            notes.append(f"{current}: {line.strip()}" if current else
                         line.strip())
    return notes


def bwd_fn(path):
    fn = ctypes.CDLL(path).repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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


def pass_ms(fn, iters=5):
    """{kernel: device ms a call} of the backward's passes, by
    torch.profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"flash_bwd_[a-z0-9_]+", e.key)
            name = m.group(0) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + \
                e.self_device_time_total / 1e3 / iters
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    # one nvcc each, all at once
    builds = {name: start_build(name, VARIANTS[name]) for name in names}
    fns = {}
    for name, (path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        fns[name] = bwd_fn(path)
        print(f"{name}: ptxas", flush=True)
        for note in ptxas_notes(log):
            print(f"    {note}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, S, H, KH, Dh, causal, window in SHAPES:
        q, k, v, do = (torch.randn((B, S, h, Dh), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for h in (H, KH, KH, H))
        scale = 1.0 / math.sqrt(Dh)
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), device="cuda")
        kernel.launch(q, k, v, out, causal=causal, window=window,
                      scale=scale, lse=lse)
        dsum = torch.empty_like(lse)
        grads = tuple(torch.empty_like(t) for t in (q, k, v))
        stream = torch.cuda.current_stream().cuda_stream
        default = kernel.bwd_splits(B, S, H, KH, Dh, sms)

        def call(fn, splits=default):
            part = None if splits == 1 else torch.empty(
                (2, splits, B, S, KH, Dh), device="cuda")
            ptr = None if part is None else part.data_ptr()
            return lambda: fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                              dsum.data_ptr(), *(g.data_ptr() for g in grads),
                              ptr, B, S, H, KH, Dh, int(causal), window, 1,
                              splits, scale, stream)
        want = ref.reference_attention_bwd(q, k, v, out, lse, do,
                                           causal=causal, window=window)
        scales = [float(w.abs().max()) for w in want]
        floor = 1e-3 * max(scales)

        def check(name, splits):
            if call(fns[name], splits)() != 0:
                raise SystemExit(f"{name}: launch refused")
            torch.cuda.synchronize()
            errs = [float((g.float() - w).abs().max()) / max(sc, floor)
                    for g, w, sc in zip(grads, want, scales)]
            if not all(e <= TOL for e in errs):
                raise SystemExit(f"{name} at {label}, splits {splits}: "
                                 f"errors {errs} > {TOL}")
        for name in fns:
            check(name, default)
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cuda_ms(call(fns[name])))
        sdpa, masked = sdpa_bwd_call(q, k, v, do, causal, window)
        sdpa_ms = cuda_ms(sdpa)
        bound_ms, bound_by, flops, _ = attention_bwd_bound(
            B, S, H, KH, Dh, causal, window, q.dtype)
        print(f"{label}: B={B} S={S} H={H} KH={KH} Dh={Dh} causal={causal} "
              f"window={window} splits={default}: "
              f"{'masked ' if masked else ''}sdpa backward {sdpa_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} "
              f"GFLOP)", flush=True)
        for name, ts in times.items():
            print(f"  {name:38s} {ts[0]:.4f} {ts[1]:.4f} ms, "
                  f"{min(ts) / sdpa_ms:.2f}x sdpa, "
                  f"{min(ts) / bound_ms:.2f}x bound", flush=True)
        first = next(iter(fns))
        for kname, ms in pass_ms(call(fns[first])).items():
            print(f"    {first}, pass {kname}: {ms:.4f} ms", flush=True)
        if KH < H:
            G = H // KH
            for splits in sorted({s for s in (1, 2, 4, 8, 16) if s <= G}
                                 | {default}):
                check(first, splits)
                ms = cuda_ms(call(fns[first], splits))
                print(f"  {first}, splits {splits:2d}: {ms:.4f} ms",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
