#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run it from a checkout of the repository; it puts ``src/`` on ``sys.path``
itself and needs one CUDA device.  Without one it exits non-zero and prints
no result.  The phases run in this order, and any failure ends the run with
a non-zero exit:

1. device       the card's name and power limit, as nvidia-smi reports them
2. build        every CUDA kernel of the port built from ``csrc/`` into
                ``build/repro_torch/``; ptxas's register, shared-memory and
                spill lines and the build's seconds
3. kernel       each kernel against its plain PyTorch version on the card,
                bf16 and float32, within the stated tolerances; at the
                serving shape also kernel, plain and library times and the
                card's bound for the same work
4. serve        full-width minicpm-2b (40 layers, bf16, random weights from a
                seed) serves 8 requests of 1000 prompt tokens through
                ``repro_torch.launch.serve.serve``; every prefill layer must
                have launched the flash-attention kernel
5. consistency  prefill + decode_step against forward_logits at full width in
                float32, with a negative control (an off-by-one position must
                fail the same tolerance)

It then prints one JSON line of kernel numbers, the card line, and as its
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its FLOPs over the
# peak rate for its input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Tolerances of kernel against plain version, both on the same inputs and the
# plain version computing in float32 (inputs upcast):
#  * bf16: the kernel rounds its output to bf16, half a unit in the last
#    place of |o| < 8 is at most 2**-6 / 2 ~ 7.8e-3; 2e-2 leaves room for
#    outputs up to 8 and for float32 summation order.
#  * float32: both compute in float32 (no TF32) in another summation order
#    over at most S = 1000 keys; errors are ~1e-6, 1e-4 is the bar.
KERNEL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# prefill + decode vs forward_logits in float32, relative to max |logit|:
# two summation orders over d = 2304 and 40 layers differ by ~1e-6 of the
# scale (6.6e-7 measured on an H100); a position off by one moves the
# logits by ~2e-3 of it, so the bar sits between the two, 20x from each.
CONSISTENCY_RTOL = 1e-4

ARCH = "minicpm-2b"
SERVE_REQUESTS, SERVE_SLOTS, PROMPT_LEN, GEN = 8, 4, 1000, 16


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters`` runs."""
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


def profile_ms(fn):
    """(wall ms, device-busy ms, top kernels) of one call, by torch.profiler.

    Device-busy is the sum of the kernels' device times; the profiler's own
    overhead inflates the wall time, so read the share, not the wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return wall, busy, [(e.self_device_time_total / 1e3, e.count, e.key)
                        for e in top]


def print_profile(label, wall, busy, top):
    if busy <= 0:
        print(f"  profile {label}: device time not measured (the profiler "
              f"saw no kernels)", flush=True)
        return
    print(f"  profile {label}: wall {wall:.2f} ms under the profiler, device "
          f"busy {busy:.2f} ms ({busy / wall:.1%}); top kernels:", flush=True)
    for ms, n, name in top:
        print(f"    {ms:9.3f} ms {n:6d}x  {name[:90]}", flush=True)


def attention_bound(B, S, H, KH, Dh, causal, window, dtype):
    """(bound_ms, bound_by, flops, bytes) of one attention on the card.

    FLOPs count the (query, key) pairs this mask leaves (4*Dh per pair: the
    score and the weighted sum of V); bytes count q, k, v read once and o
    written once.
    """
    qpos = np.arange(S)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, int)
    hi = qpos + 1 if causal else np.full(S, S)
    pairs = int(np.sum(hi - lo))
    flops = 4.0 * B * H * Dh * pairs
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * (2 * B * S * H * Dh + 2 * B * S * KH * Dh)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def phase_device() -> str:
    phase("device")
    check(torch.cuda.is_available(), "no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    # state the float32 matmul precision of every plain version: no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from repro_torch.kernels import build
    phase("build")
    info = build.build()
    for line in info.log.splitlines():
        if any(w in line for w in ("registers", "spill", "Function properties",
                                   "Compiling entry")):
            print("  " + line.strip())
    print(f"built {info.path.relative_to(ROOT)} in {info.seconds:.3f} s"
          f"{' (cached)' if info.cached else ''}", flush=True)
    from repro_torch.kernels.flash_attention import kernel, ops
    print("  flash_attention dynamic shared memory per block: " + ", ".join(
        f"Dh={dh}: {kernel.shared_memory_bytes(dh)} B"
        for dh in ops.SUPPORTED_HEAD_DIMS), flush=True)


# (name, B, S, H, KH, Dh, causal, window); the first is the serving shape
KERNEL_CASES = [
    ("minicpm-prefill", 4, 1000, 36, 36, 64, True, 0),
    ("h2o-danube-swa", 2, 1000, 32, 8, 120, True, 256),
    ("single-token", 2, 1, 8, 2, 128, True, 0),
    ("ragged-136", 2, 136, 8, 2, 128, True, 0),
    ("ragged-136-window", 2, 136, 8, 2, 64, True, 100),
    ("non-causal-136", 2, 136, 4, 4, 120, False, 0),
]


def phase_kernel():
    from repro_torch.kernels.flash_attention import ops, ref
    phase("kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = None
    for name, B, S, H, KH, Dh, causal, window in KERNEL_CASES:
        q32 = torch.randn((B, S, H, Dh), generator=gen, device="cuda")
        k32 = torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
        v32 = torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.reference_attention(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
            err = float((out.float() - want).abs().max())
            tol = KERNEL_TOL[dtype]
            print(f"  {name:18s} {str(dtype):15s} B={B} S={S} H={H} KH={KH} "
                  f"Dh={Dh} causal={causal} window={window}: "
                  f"max_abs_err={err:.3e} tol={tol:.0e}", flush=True)
            check(math.isfinite(err) and err <= tol,
                  f"flash_attention {name} {dtype}: error {err} > {tol}")
            if result is None and dtype == torch.bfloat16:
                result = time_kernel(q, k, v, causal, window, err)
    return result


def time_kernel(q, k, v, causal, window, err):
    """Kernel, plain version and library times at the serving shape."""
    from repro_torch.kernels.flash_attention import ops, ref
    import torch.nn.functional as F
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    kernel_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                    window=window))
    plain_ms = cuda_ms(lambda: ref.reference_attention(
        q, k, v, causal=causal, window=window), iters=5)
    # yardstick only: one PyTorch call computing the same function; the
    # port never calls it
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=H != KH))
    bound_ms, bound_by, flops, nbytes = attention_bound(
        B, S, H, KH, Dh, causal, window, q.dtype)
    print(f"  timing at B={B} S={S} H={H} Dh={Dh} {q.dtype}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_serve():
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch.serve import Request, serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry as R
    phase("serve")
    cfg = get_arch(ARCH)
    t0 = time.perf_counter()
    params = R.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = R.count_params_analytic(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in {cfg.dtype}, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, size=PROMPT_LEN)
                    .astype(np.int32), GEN) for i in range(SERVE_REQUESTS)]
    ctx_len = PROMPT_LEN + GEN

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    done = serve(cfg, reqs, slots=SERVE_SLOTS, ctx_len=ctx_len,
                 params=params, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa_kernel.LAUNCHES
    peak = torch.cuda.max_memory_allocated()

    n_prefill = math.ceil(SERVE_REQUESTS / SERVE_SLOTS)
    check(len(done) == SERVE_REQUESTS, f"{len(done)} requests served")
    for r in done:
        check(len(r.generated) == GEN,
              f"request {r.rid} got {len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.rid}: token outside the vocab")
    check(launches == cfg.n_layers * n_prefill,
          f"flash_attention launched {launches} times, expected "
          f"{cfg.n_layers} x {n_prefill} prefill batches")
    n_tok = sum(len(r.generated) for r in done)
    print(f"  served {len(done)} requests, {n_tok} new tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); flash_attention "
          f"launches {launches} = {cfg.n_layers} x {n_prefill}; peak "
          f"memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  req{done[0].rid}: {done[0].generated}", flush=True)

    # per-step times at the same shapes, through the same step functions
    prefill = make_prefill_step(cfg, cache_len=ctx_len, device="cuda")
    decode = make_serve_step(cfg, device="cuda")
    toks = np.stack([r.prompt for r in reqs[:SERVE_SLOTS]])
    with torch.inference_mode():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        prefill_ms = sorted(times)[1] * 1e3
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(PROMPT_LEN, ctx_len):
            nxt, logits, cache = decode(params, nxt, pos, cache)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / GEN * 1e3
        print(f"  prefill {SERVE_SLOTS}x{PROMPT_LEN}: {prefill_ms:.2f} ms "
              f"(median of 3); decode: {decode_ms:.3f} ms/step at batch "
              f"{SERVE_SLOTS}", flush=True)
        # where the time goes: one prefill batch and one decode step
        print_profile(f"prefill {SERVE_SLOTS}x{PROMPT_LEN}", *profile_ms(
            lambda: prefill(params, {"tokens": toks})))
        print_profile(f"decode step at batch {SERVE_SLOTS}", *profile_ms(
            lambda: decode(params, nxt, ctx_len - 1, cache)))
    return cfg, params, launches


def phase_consistency(cfg, params):
    from repro_torch.models import registry as R
    phase("consistency")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = {k: ([{g: {n: w.float() for n, w in sub.items()}
                 for g, sub in layer.items()} for layer in v]
               if k == "layers" else v.float())
           for k, v in params.items()}
    B, S = 2, 200
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    def run(pos_shift: int) -> float:
        with torch.inference_mode():
            full = R.forward_logits(p32, cfg32, {"tokens": toks},
                                    device="cuda")
            logits, cache = R.prefill(p32, cfg32, {"tokens": toks[:, :S - 4]},
                                      cache_len=S, device="cuda")
            err = float((logits - full[:, S - 5]).abs().max())
            for t in range(S - 4, S - 1):
                logits, cache = R.decode_step(p32, cfg32, toks[:, t:t + 1],
                                              t + pos_shift, cache,
                                              device="cuda")
                err = max(err, float((logits - full[:, t]).abs().max()))
            return err / float(full.abs().max())

    rel = run(0)
    rel_bad = run(1)
    print(f"  B={B} S={S}: prefill({S - 4}) + 3 decode steps vs "
          f"forward_logits, float32: max rel err {rel:.3e} "
          f"(tol {CONSISTENCY_RTOL:.0e}); off-by-one pos: {rel_bad:.3e}",
          flush=True)
    check(rel <= CONSISTENCY_RTOL, f"decode disagrees with forward: {rel}")
    check(rel_bad > CONSISTENCY_RTOL,
          f"an off-by-one position passes the tolerance ({rel_bad})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = phase_device()
    phase_build()
    timing = phase_kernel()
    cfg, params, launches = phase_serve()
    phase_consistency(cfg, params)

    kernel_line = {"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
        "launches": launches,
        **timing,
        # the same numbers again under short names (bound in microseconds)
        "max_err": timing["max_abs_err"],
        "kernel_ms": timing["ms"],
        "bound_us": timing["bound_ms"] * 1e3,
    }]}
    print(json.dumps(kernel_line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
