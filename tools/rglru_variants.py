#!/usr/bin/env python3
"""Time variants of the RG-LRU scan kernel on one GPU.

    python3 tools/rglru_variants.py

Run it from a checkout of the repository on a machine with a CUDA card and
the toolkit.  It builds, one ``nvcc`` each, all started together, into
``build/rglru_variants/``:

* the committed kernel (``csrc/rglru_scan.cu``) and copies of it with one
  design choice changed by a text replacement (window W, segments P,
  channels a block DC, stages; sigmoids, exp and expm1 to float32's last
  bit, as the first build of the design had them), and one that is not
  the function: the gates' arithmetic taken out, timed for the floor that
  the loads, the scan and the stores leave;
* the first CUDA port, one thread per channel (``tools/rglru_per_channel.cu``),
  which takes whole gates only;
* the two-launch design (``tools/rglru_two_pass.cu``), which reads the
  inputs twice through a workspace of per-chunk (prod a, h).

At recurrentgemma-9b's prefill shape (B 4, S 1000, D 4096, bf16 x) it holds
each against the plain version on the two routes, fused (bf16 gate
products and float32 biases) and whole gates (float32, the biases added
beforehand), then times all by CUDA events in turns (in order, then in
reverse).  On the fused route the per-channel kernel is timed with the two
float32 bias adds it needs in front of it.  It prints the card, each
build's ptxas register and spill lines, each variant's error and two times
per route, and the routes' bounds.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rglru_scan import ref  # noqa: E402

SOURCE = os.path.join(ROOT, "src/repro_torch/kernels/rglru_scan/csrc/"
                            "rglru_scan.cu")
PER_CHANNEL = os.path.join(ROOT, "tools", "rglru_per_channel.cu")
TWO_PASS = os.path.join(ROOT, "tools", "rglru_two_pass.cu")
ERRORS = os.path.join(ROOT, "src/repro_torch/kernels/csrc/cuda_errors.cu")
OUT = os.path.join(ROOT, "build", "rglru_variants")
COMMITTED = "using Block = Config<64, 8, 64, 2, 2>;"


def block(w, p, dc, stages, min_blocks):
    return [(COMMITTED, f"using Block = Config<{w}, {p}, {dc}, {stages}, "
                        f"{min_blocks}>;")]


EXACT_SIGMOID = ("return __fdividef(1.f, 1.f + __expf(-v));",
                 "return 1.f / (1.f + expf(-v));")
# name: [(text in the committed source, its replacement)]
VARIANTS = {
    "as committed (W 64, P 8, DC 64, 2 stages)": [],
    "DC 32, 4 blocks an SM": block(64, 8, 32, 2, 4),
    "W 32, P 4, 4 blocks an SM": block(32, 4, 64, 2, 4),
    "W 128, P 16, 1 block an SM": block(128, 16, 64, 2, 1),
    "DC 32, W 128, P 16, 2 blocks an SM": block(128, 16, 32, 2, 2),
    "DC 32, 3 stages, 3 blocks an SM": block(64, 8, 32, 3, 3),
    "exact sigmoids (expf, division)": [EXACT_SIGMOID],
    "exact sigmoids, exp and expm1(2 log_a)": [
        EXACT_SIGMOID,
        ("const float em = expm1f(log_a);",
         "const float em = expm1f(2.f * log_a);"),
        ("a[i] = 1.f + em;", "a[i] = expf(log_a);"),
        ("bb[i] = sqrtf(-em * (2.f + em)) *", "bb[i] = sqrtf(-em) *")],
    # not the function: the same loads, scan and stores with the gates'
    # transcendentals and divisions taken out, for the floor they leave
    "no gate arithmetic (timed, not checked)": [
        ("coef * sigmoid(to_f32(tga[i * DC]) + bias_a);",
         "coef * (to_f32(tga[i * DC]) + bias_a);"),
        ("const float em = expm1f(log_a);", "const float em = log_a;"),
        ("bb[i] = sqrtf(-em * (2.f + em)) *\n"
         "                (sigmoid(to_f32(tgx[i * DC]) + bias_x) * "
         "to_f32(tx[i * DC]));",
         "bb[i] = (to_f32(tgx[i * DC]) + bias_x) * to_f32(tx[i * DC]);")],
}
UNCHECKED = {"no gate arithmetic (timed, not checked)"}
B, S, D = 4, 1000, 4096
RTOL = 1e-5      # RGLRU_RTOL of chip_smoke.py: relative to max |y|


def _nvcc(stem, source):
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                             stem + ".so", source, ERRORS],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all():
    """{name: (C function, kind, ptxas notes)}, built in parallel; kind is
    "windowed", "per_channel" or "two_pass"."""
    os.makedirs(OUT, exist_ok=True)
    src0 = open(SOURCE).read()
    procs = {}
    for name, edits in VARIANTS.items():
        src = src0
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not in the source once")
            src = src.replace(old, new)
        stem = os.path.join(OUT, "".join(c if c.isalnum() else "_"
                                         for c in name))
        with open(stem + ".cu", "w") as f:
            f.write(src)
        procs[name] = ("windowed", stem, _nvcc(stem, stem + ".cu"))
    for name, kind, path in (("per channel (first port)", "per_channel",
                              PER_CHANNEL),
                             ("two launches, chunks of 64", "two_pass",
                              TWO_PASS)):
        stem = os.path.join(OUT, kind)
        procs[name] = (kind, stem, _nvcc(stem, path))
    fns = {}
    for name, (kind, stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln
                 or ("spill" in ln and not ln.strip().startswith("0 b"))]
        lib = ctypes.CDLL(stem + ".so")
        if kind == "two_pass":
            fn = lib.repro_rglru_scan_two_pass
            fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
        elif kind == "per_channel":
            fn = lib.repro_rglru_scan
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
        else:
            fn = lib.repro_rglru_scan
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
                [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = (fn, kind, notes)
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


def bound_ms(g_bytes, fused):
    """The bytes bound of one scan at (B, S, D) with bf16 x: x, ga, gx,
    lam (and the biases) read once, y and h_last written once."""
    n = B * S * D
    nbytes = n * (2 + 2 * g_bytes + 4) + 4 * D + 4 * B * D \
        + (8 * D if fused else 0)
    return nbytes / 3.35e12 * 1e3, nbytes


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    fns = build_all()
    for name, (_, _, notes) in fns.items():
        print(f"{name}: ptxas {'; '.join(notes)}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(5)
    u = 0.9 + 0.099 * torch.rand((D,), generator=gen, device="cuda")
    lam = torch.log(torch.expm1(-torch.log(u) / ref.RGLRU_C))
    x, pa, pi = (torch.randn((B, S, D), generator=gen, device="cuda")
                 .to(torch.bfloat16) for _ in range(3))
    b_a, b_i = (0.5 * torch.randn((D,), generator=gen, device="cuda")
                for _ in range(2))
    ga, gx = pa + b_a, pi + b_i          # whole gates, float32
    y = torch.empty((B, S, D), device="cuda")
    h_last = torch.empty((B, D), device="cuda")
    ws = torch.empty((2 * -(-S // 64) * B * D,), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    want, _ = ref.reference_rglru(x, lam, ga, gx)
    scale = float(want.abs().max())

    def call(name, fused):
        fn, kind, _ = fns[name]
        g = (pa, pi, b_a, b_i) if fused else (ga, gx, None, None)
        code = 1 if fused else 0

        def ptrs(*ts):
            return [None if t is None else t.data_ptr() for t in ts]
        if kind == "per_channel":
            def run():
                a, i = (pa + b_a, pi + b_i) if fused else (ga, gx)
                return fn(*ptrs(x, lam, a, i, None, y, h_last), B, S, D, 1,
                          0, stream)
            return run
        if kind == "two_pass":
            args = ptrs(x, lam, *g, None, y, h_last, ws)
        else:
            args = ptrs(x, lam, *g, None, y, h_last)
        return lambda: fn(*args, B, S, D, 1, code, stream)

    failed = []
    for fused in (True, False):
        route = "fused_bias (bf16 products, float32 biases)" if fused else \
            "gates (float32, biases added beforehand)"
        b_ms, nbytes = bound_ms(2 if fused else 4, fused)
        print(f"route {route}: B={B} S={S} D={D}, bound {b_ms:.4f} ms by "
              f"bytes ({nbytes / 1e6:.2f} MB)", flush=True)
        errs, good = {}, []
        for name in fns:
            y.fill_(float("nan"))
            if call(name, fused)() != 0:
                print(f"  {name}: launch refused", flush=True)
                failed.append(name)
                continue
            torch.cuda.synchronize()
            errs[name] = float((y - want).abs().max()) / scale
            if errs[name] <= RTOL or name in UNCHECKED:
                good.append(name)
            else:
                print(f"  {name}: error {errs[name]:.3e} > {RTOL}, not "
                      f"timed", flush=True)
                failed.append(name)
        times = {name: [] for name in good}
        for name in good + good[::-1]:
            times[name].append(cuda_ms(call(name, fused)))
        for name, ts in times.items():
            extra = " (with the two bias adds)" if fused and \
                fns[name][1] == "per_channel" else ""
            print(f"  {name:42s} {ts[0]:.4f} {ts[1]:.4f} ms, "
                  f"{b_ms / min(ts):.1%} of the bound, rel err "
                  f"{errs[name]:.3e}{extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
