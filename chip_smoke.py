#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run it from a checkout of the repository; it puts ``src/`` on ``sys.path``
itself and needs one CUDA device.  Without one it exits non-zero and prints
no result.  The phases run in this order, and any failure ends the run with
a non-zero exit:

1. device       the card's name and power limit, as nvidia-smi reports them
2. build        every CUDA kernel of the port built from ``csrc/`` into
                ``build/repro_torch/``; ptxas's register, shared-memory,
                spill and wgmma lines, the build's seconds, and each
                flash-attention and mlstm_scan route's shared memory per
                block (and mlstm_scan's chunk and workspace per route)
3. kernel       each kernel (flash_attention, moe_gmm, rglru_scan,
                mlstm_scan) against its plain PyTorch version on the card,
                bf16 and float32, within the stated tolerances; at the
                serving shapes also kernel, plain and library (or yardstick)
                times and the card's bound for the same work (flash
                attention at minicpm's, granite-moe's and recurrentgemma's
                prefill shapes, with kernel / SDPA as a factor); bf16 flash
                attention runs on the wgmma route, float32 on the scalar
                one; moe_gmm likewise (bf16 that TMA cannot address on its
                WMMA route), timed at granite-moe's prefill with every row
                live and at its decode with a routing's bucket fills (only
                the touched experts' weights streamed), with the launches
                per route; mlstm_scan likewise (bf16 that TMA cannot
                address on its scalar bf16 route), each case on the route
                its dtype and shape pick, with each pass of the wgmma route
                timed at the serving shape beside the scalar bf16 kernel,
                and also under stress with random keys, against the
                recurrence in float64; rglru_scan on both routes (gate
                biases fused in, whole gates), each timed at the serving
                shape beside its own bound, its window and segment edges,
                and a long memory (a up to 0.9999, S 1000 and 4096) held
                against the recurrence in float64; and flash_attention's
                backward (kernel_bwd): through the wrapper's autograd
                function against the plain backward (explicit formulas in
                float32), bf16 (wgmma_bf16) and float32 (scalar_f32), MHA,
                GQA 24/8 and MQA (its query heads split over blocks),
                causal, not causal and biting windows, head dims 16, 64,
                80, 120, 128 and 256 (16 and 80 padded), S 1, 63, 65, 200,
                1000 and 4096 (the train phases' own shapes: minicpm-2b's
                36 heads of 64 and recurrentgemma-9b's 16/1 at 256 with its
                window of 2048, at one microbatch of 4096), each case
                checked to run on its route and, in bf16, to give the same
                bits on a second call, the forward's row log-sum-exp
                against the plain one, and at both train shapes and
                minicpm's, granite's and recurrentgemma's prefill shapes the
                kernel, the plain version and SDPA's backward (with a band
                mask where the window bites: masked SDPA) timed beside the
                card's bound; then rglru_scan's backward
                (through ``ops.rglru``'s autograd function, bf16 and float32,
                the train shape B 1, S 4096, D 4096, the 64-step chunk's
                edges, h0 and dh_last, both routes; a long memory, a up to
                0.9999 over 4096 steps, against autograd in float64) and
                mlstm_scan's backward (through ``ops.mlstm_chunkwise``'s,
                each case's backward on its forward's route, checked per
                case: bf16 on wgmma_bf16 (split-bf16 ``wgmma`` products on
                the states of each chunk of 128), Dh 37 in bf16 on
                scalar_bf16, float32 on scalar_f32: the train shape B 1, S
                4096, 4 heads of 1024, S 200 and 1, the denominator's floor
                active on most rows, an initial state, Dh 1600 and 37; the
                forward's row statistics against the plain ones), each
                against its plain backward, the train shape timed beside
                its bound (fixed at chunks of 64, as both routes are held
                to it), with each pass of the wgmma route and the scalar
                bf16 route's total beside it
4. serve        full-width minicpm-2b (40 layers, bf16, random weights from a
                seed) serves 8 requests of 1000 prompt tokens through
                ``repro_torch.launch.serve.serve``; every prefill layer must
                have launched the flash-attention kernel, on its wgmma route
                (the launches per route are printed after each serve)
5. consistency  prefill + decode_step against forward_logits at full width in
                float32, with a negative control (an off-by-one position must
                fail the same tolerance)
6. serve        the same for full-width granite-moe-3b-a800m (32 layers, 40
                experts top-8) with ``moe_dispatch="gather"``: every MoE
                layer of every prefill and decode call must have launched the
                moe_gmm kernels, on their wgmma route, every attention layer
                of every prefill the flash kernel
7. consistency  the same for granite-moe in float32, at a capacity where no
                (token, expert) pair is dropped
8. serve        the same for full-width recurrentgemma-9b (38 layers: 26
                RG-LRU, 12 LOCAL attention with MQA at head dim 256): every
                RG-LRU layer of every prefill must have launched rglru_scan,
                on its fused_bias route, every LOCAL layer the flash kernel
9. consistency  the same for recurrentgemma-9b in float32, under its own
                bar (its decode state rounds the conv lag buffer to bf16)
10. serve       the same for full-width xlstm-1.3b (48 layers: 24 mLSTM, 24
                sLSTM, d 2048, 4 heads, mLSTM head dim 1024): every mLSTM
                layer of every prefill must have launched mlstm_scan, on its
                wgmma route, and no other kernel runs; its prefill is
                profiled at 200 prompt
                tokens (the sLSTM's loop over time makes a 1000-token trace
                some 480,000 launches long)
11. consistency the same for xlstm-1.3b in float32, under its own bar (both
                blocks round their conv lag buffers to bf16); xLSTM reads no
                position, so its negative control feeds each decode step the
                previous token instead
12. train       full-width, full-depth minicpm-2b (40 layers, 2.725 B
                params) trains 4 AdamW steps (float32 master weights and
                moments, bf16 compute, remat "full", the wsd schedule at lr
                3e-4 with one warmup step) on one batch of 2 x 4096 tokens
                as 2 microbatches, then one eval step, through
                ``make_train_step`` / ``make_eval_step``: metrics finite,
                the loss after step 4 below step 1's, every step 160 flash
                forward launches (40 layers x 2 microbatches x forward and
                recompute, on wgmma_bf16) and 80 backward ones (on
                wgmma_bf16), no other kernel; step times, tokens/s, peak
                memory and a profiled step
13. train consistency  one float32 step of minicpm-2b at full width, 2
                layers, S 1024 (flash's scalar_f32 routes both ways): loss
                and every parameter's gradient on the card against the CPU's
                plain versions from the same weights, with the labels
                shifted by one position as the negative control
14. train       recurrentgemma-9b at full width, depth cut to 2 periods (4
                RG-LRU, 2 LOCAL layers, 3.41 B params), as phase 12 at
                2 x 4096: every step 16 rglru_scan and 8 flash forward
                launches (forward and recompute), 8 rglru_scan_bwd and 4
                flash backward ones, all on the bf16 routes; a profiled step
15. train consistency  recurrentgemma-9b, one period, float32, S 512
                (rglru_scan's fused_bias route both ways, flash's
                scalar_f32)
16. train       xlstm-1.3b at full width, depth cut to 2 periods (2 mLSTM,
                2 sLSTM layers), as phase 12 at 2 x 1024: every step 8
                mlstm_scan launches and 4 mlstm_scan_bwd, all on
                wgmma_bf16
17. train consistency  xlstm-1.3b, one period, float32, S 512 (mlstm_scan's
                scalar_f32 routes both ways)

Earlier serve paths run at full depth; if the run outgrows its time, their
depth is what gets cut first.

It then prints one JSON line of kernel numbers, the card line, and as its
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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

# moe_gmm against its plain version, relative to the plain version's
# max |y|, both on the same inputs and the plain version in float32:
#  * bf16: the kernel rounds h to bf16 before the down projection (as the
#    TPU kernel does) and y to bf16; each rounding is half a unit in the
#    last place, 2**-9 ~ 2e-3 of the value, so the error stays near 4e-3 of
#    max |y|; 2e-2 leaves 5x for float32 summation order.
#  * float32: both compute in float32 (no TF32) in another summation order
#    over at most d = 4096 and f = 14336 terms; errors are ~1e-6 of max |y|,
#    1e-4 is the bar.
GMM_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# prefill + decode vs forward_logits in float32, relative to max |logit|:
# two summation orders over d = 2304 and 40 layers differ by ~1e-6 of the
# scale (6.6e-7 measured on an H100); a position off by one moves the
# logits by ~2e-3 of it, so the bar sits between the two, 20x from each.
CONSISTENCY_RTOL = 1e-4

# recurrentgemma-9b: the reference rounds the RG-LRU conv lag buffer to bf16
# in a float32 model too, and the port mirrors it, so its prefill + decode
# differs from forward_logits by that rounding.  At full width and depth on
# an H100 the gap is 9.0e-4 of the logits' scale and an off-by-one position
# gives 2.0e-2; the bar sits between the two, about 5x from each.
GRIFFIN_CONSISTENCY_RTOL = 4e-3

# xlstm-1.3b: both blocks round their conv lag buffers to bf16 in a float32
# model too (as the reference does), so prefill + decode differs from
# forward_logits by that rounding.  At full width and depth on an H100 the
# gap is 1.2e-3 of the logits' scale, and feeding each decode step the
# previous token (the control: xLSTM reads no position) gives 0.56; the bar,
# written before that run, sits 8x above the gap and 56x below the control.
XLSTM_CONSISTENCY_RTOL = 1e-2

# rglru_scan against its plain version, relative to the plain version's
# max |y|: both compute in float32 from the same inputs and the kernel does
# not round its output, for either input type; they differ by the last bits
# of exp / expm1 / sqrt and a fused multiply-add per step, which the
# recurrence (a < 1) does not amplify.
RGLRU_RTOL = 1e-5
# operations per (b, t, d) element: two sigmoids (3 each), the rate
# product, exp, the doubling, expm1, negation, sqrt, two products and the
# recurrence's multiply-add (2)
RGLRU_OPS_PER_ELEM = 16

# flash_attention's backward against its plain version (explicit formulas
# in float32 on the same q, k, v, o, dO), dq, dk and dv each relative to the
# plain gradient's max |.|:
#  * bf16: the kernel rounds P and dS to bf16 for the products that take
#    them, and dq, dk, dv on output (half a unit in the last place, 2**-9
#    ~ 2e-3 of the value, each), and reads the forward's bf16 o in D =
#    rowsum(dO o); 2e-2 leaves room for those roundings' sums.
#  * float32: both compute in float32 (no TF32) in another summation order
#    over at most 4096 keys or queries; errors are ~1e-6, 1e-4 is the bar.
# A gradient below 1e-3 of the largest of the three is a sum of cancelling
# terms of that size, so each scale is floored at 1e-3 of the largest.
# Where every query sees one key (S 1, or a window of 1), dP = D and dS = 0,
# so dq = dk = 0 in exact arithmetic and both sides hold only the rounding
# of dP and D in two summation orders (~3e-7 of the largest in float32):
# there dq and dk are held against the largest gradient's scale, which
# checks that they vanish.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
BWD_SCALE_FLOOR = 1e-3
# the forward's row log-sum-exp against the plain one (natural log, ~log S
# plus the largest score, < 20 here): float32 sums of exact bf16 products
# or of float32 products in another order, ~1e-5 apart; 1e-4 is the bar
LSE_ATOL = 1e-4

# training consistency: the same float32 step (loss and every parameter's
# gradient) on the card (the flash kernel's scalar routes, cuBLAS) and on
# the CPU (the plain versions), from the same weights and batch, relative
# to each leaf's max |g| (floored at 1e-3 of the largest leaf's, as a leaf
# whose gradient nearly vanishes holds only rounding): other summation
# orders over d = 2304, 1024 keys and 122753 logits agree to ~1e-6; the
# labels shifted by one position move the gradients by O(1) of their
# scale, so 1e-4 sits between the two.
TRAIN_RTOL = 1e-4
TRAIN_FLOOR = 1e-3

# mlstm_scan against its plain version, relative to the plain version's max
# |h| (and max |C|, |n|, |m| for the state): both compute in float32 from the
# same inputs, in another order (chunks of 64 steps against the reference's
# 8 at S = 1000; sums over Dh = 1024 and up to 1000 steps); errors are
# ~1e-6 of the scale, 1e-4 is the bar.
MLSTM_RTOL = 1e-4

ARCH = "minicpm-2b"
MOE_ARCH = "granite-moe-3b-a800m"
GRIFFIN_ARCH = "recurrentgemma-9b"
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_PROFILE_LEN = 200     # prompt tokens of the profiled xLSTM prefill
SERVE_REQUESTS, SERVE_SLOTS, PROMPT_LEN, GEN = 8, 4, 1000, 16
# training: minicpm-2b at full width and depth, the reference's train_4k
# sequence, a global batch of 2 as two microbatches of 1 (its global batch
# of 256 does not fit one card), 4 AdamW steps on one batch, then an eval
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 2, 2, 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 1
# the consistency step: full width, depth cut to 2 layers, float32
CONSIST_LAYERS, CONSIST_SEQ = 2, 1024
# the recurrent families' training at full width, depth cut for time:
# recurrentgemma-9b to 2 periods of (RG-LRU, RG-LRU, LOCAL), 6 layers, at
# TRAIN_SEQ; xlstm-1.3b to 2 periods of (mLSTM, sLSTM), 4 layers, at S
# 1024 (the sLSTM's plain loop over time is ~60 launches a step and layer)
GRIFFIN_TRAIN_LAYERS = 6
XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SEQ = 4, 1024
# their float32 consistency steps: one period each, at S 512
GRIFFIN_CONSIST_LAYERS, XLSTM_CONSIST_LAYERS, RECURRENT_CONSIST_SEQ = \
    3, 2, 512


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


# the port's kernels, by a part of their CUDA function names; a kernel
# counts under the first entry whose part it holds
PORT_KERNELS = (("flash_attention_bwd", "flash_bwd"),
                ("flash_attention", "flash_fwd"), ("moe_gmm", "gmm_"),
                ("rglru_scan_bwd", "rglru_bwd"), ("rglru_scan", "rglru_scan"),
                ("mlstm_scan_bwd", "mlstm_bwd"), ("mlstm_scan", "mlstm_"))


def profile_ms(fn):
    """(wall ms, device-busy ms, top kernels, {port kernel: (ms, launches)})
    of one call, by torch.profiler.

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
    port = {}
    for e in kernels:
        name = next((n for n, part in PORT_KERNELS if part in e.key), None)
        if name is not None:
            ms, n = port.get(name, (0.0, 0))
            port[name] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return wall, busy, [(e.self_device_time_total / 1e3, e.count, e.key)
                        for e in top], port


def print_profile(label, wall, busy, top, port):
    if busy <= 0:
        print(f"  profile {label}: device time not measured (the profiler "
              f"saw no kernels)", flush=True)
        return
    print(f"  profile {label}: wall {wall:.2f} ms under the profiler, device "
          f"busy {busy:.2f} ms ({busy / wall:.1%}); top kernels:", flush=True)
    for ms, n, name in top:
        print(f"    {ms:9.3f} ms {n:6d}x  {name[:90]}", flush=True)
    for name, (ms, n) in port.items():
        print(f"    port kernel {name}: {ms:.3f} ms over {n} launches, "
              f"{ms / busy:.1%} of device busy", flush=True)


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
                                   "Compiling entry", "wgmma", "setmaxnreg",
                                   "warning")):
            print("  " + line.strip())
    print(f"built {info.path.relative_to(ROOT)} in {info.seconds:.3f} s"
          f"{' (cached)' if info.cached else ''}", flush=True)
    from repro_torch.kernels.flash_attention import kernel, ops
    for dtype, (_, route) in kernel.ROUTES.items():
        print(f"  flash_attention {route} dynamic shared memory per block: "
              + ", ".join(f"Dh={dh}: {kernel.shared_memory_bytes(dh, dtype)} B"
                          for dh in ops.SUPPORTED_HEAD_DIMS), flush=True)
    for dtype, route in kernel.BWD_ROUTES.items():
        print(f"  flash_attention backward {route} (dK/dV and dQ passes) "
              f"dynamic shared memory per block: " + ", ".join(
                  f"Dh={dh}: {kernel.bwd_shared_memory_bytes(dh, dtype)} B"
                  for dh in ops.SUPPORTED_HEAD_DIMS), flush=True)
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    B, S, H, Dh = MLSTM_CASES[0][1:5]
    for route in ml_kernel.ROUTES:
        sizes = []
        for dh in (32, 512, 1024, 1300):
            if route == "wgmma_bf16" and dh % 8:
                continue
            smem = ml_kernel.shared_memory_bytes(dh, route)
            where = ""
            if route != "wgmma_bf16":
                in_smem = ml_kernel.state_in_shared_memory(dh)
                where = f" (C in {'shared' if in_smem else 'device'} memory)"
            sizes.append(f"Dh={dh}: " + ", ".join(
                f"{k} {v} B" for k, v in smem.items()) + where)
        print(f"  mlstm_scan {route}: chunk {ml_kernel.chunk(route)}; "
              f"workspace at B={B} S={S} H={H} Dh={Dh} "
              f"{ml_kernel.workspace_bytes(B, S, H, Dh, route)} B; dynamic "
              f"shared memory per block: " + "; ".join(sizes), flush=True)
    B, S, H, Dh = MLSTM_BWD_CASES[0][1:5]
    for route in ml_kernel.BWD_ROUTES:
        print(f"  mlstm_scan backward {route}: chunk "
              f"{ml_kernel.bwd_chunk(route)}; workspace at B={B} S={S} H={H} "
              f"Dh={Dh} {ml_kernel.bwd_workspace_bytes(B, S, H, Dh, route)} "
              f"B", flush=True)


# (name, B, S, H, KH, Dh, causal, window); the cases in TIMED_CASES are
# serving shapes, timed in bf16
KERNEL_CASES = [
    ("minicpm-prefill", 4, 1000, 36, 36, 64, True, 0),
    ("granite-prefill", 4, 1000, 24, 8, 64, True, 0),
    ("griffin-prefill", 4, 1000, 16, 1, 256, True, 2048),
    ("griffin-window", 1, 2304, 16, 1, 256, True, 2048),
    ("h2o-danube-swa", 2, 1000, 32, 8, 120, True, 256),
    ("single-token", 2, 1, 8, 2, 128, True, 0),
    ("ragged-136", 2, 136, 8, 2, 128, True, 0),
    ("ragged-136-window", 2, 136, 8, 2, 64, True, 100),
    ("non-causal-136", 2, 136, 4, 4, 120, False, 0),
]
TIMED_CASES = ("minicpm-prefill", "granite-prefill", "griffin-prefill")


def phase_kernel():
    """Returns {timed case name: timing} of the flash kernel."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    phase("kernel")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for name, B, S, H, KH, Dh, causal, window in KERNEL_CASES:
        q32 = torch.randn((B, S, H, Dh), generator=gen, device="cuda")
        k32 = torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
        v32 = torch.randn((B, S, KH, Dh), generator=gen, device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            route = kernel.ROUTES[dtype][1]
            before = kernel.LAUNCHES_BY_ROUTE[route]
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
                  f"flash_attention {name} {dtype} did not run on {route}")
            want = ref.reference_attention(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
            err = float((out.float() - want).abs().max())
            tol = KERNEL_TOL[dtype]
            print(f"  {name:18s} {str(dtype):15s} B={B} S={S} H={H} KH={KH} "
                  f"Dh={Dh} causal={causal} window={window} ({route}): "
                  f"max_abs_err={err:.3e} tol={tol:.0e}", flush=True)
            check(math.isfinite(err) and err <= tol,
                  f"flash_attention {name} {dtype}: error {err} > {tol}")
            if name in TIMED_CASES and dtype == torch.bfloat16:
                result[name] = time_kernel(q, k, v, causal, window, err)
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
    print(f"  timing at B={B} S={S} H={H} KH={KH} Dh={Dh} window={window} "
          f"{q.dtype}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
          f"{library_ms:.4f} ms, kernel / sdpa {kernel_ms / library_ms:.2f}x; "
          f"bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def attention_bwd_bound(B, S, H, KH, Dh, causal, window, dtype):
    """(bound_ms, bound_by, flops, bytes) of one attention backward.

    FLOPs: five products of 2*Dh per visible (query, key) pair (q k^T,
    P^T dO, dO V^T, dS^T Q, dS K); bytes: q, k, v, o, dO and the row
    log-sum-exp read once, dq, dk, dv written once."""
    qpos = np.arange(S)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, int)
    hi = qpos + 1 if causal else np.full(S, S)
    pairs = int(np.sum(hi - lo))
    flops = 10.0 * B * H * Dh * pairs
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * (4 * B * S * H * Dh + 4 * B * S * KH * Dh) + 4 * B * H * S
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


# (name, B, S, H, KH, Dh, causal, window): the train phases' own shapes
# (minicpm-2b and recurrentgemma-9b's LOCAL attention, one microbatch of
# 4096); MHA, GQA 24/8 and MQA; causal, not causal and windows that bite;
# head dims 16 and 80 padded by the wrapper; S 1, 63, 65, 1000 and 4096.
# BWD_TIMED_CASES are timed in bf16: minicpm's train shape for the kernels
# line's numbers, the others under its at_* keys.
BWD_CASES = [
    ("minicpm-train", 1, TRAIN_SEQ, 36, 36, 64, True, 0),
    ("griffin-train", 1, TRAIN_SEQ, 16, 1, 256, True, 2048),
    ("minicpm-prefill", 4, 1000, 36, 36, 64, True, 0),
    ("granite-prefill", 4, 1000, 24, 8, 64, True, 0),
    ("griffin-prefill", 4, 1000, 16, 1, 256, True, 2048),
    ("window-bites-1000", 2, 1000, 8, 2, 128, True, 100),
    ("single-token", 2, 1, 8, 2, 64, True, 0),
    ("ragged-63", 2, 63, 8, 8, 120, True, 0),
    ("ragged-65-mqa-window", 2, 65, 6, 1, 256, True, 32),
    ("dh16-padded", 2, 65, 4, 2, 16, True, 0),
    ("dh80-non-causal", 2, 63, 4, 4, 80, False, 0),
    ("non-causal-window", 1, 200, 4, 2, 64, False, 40),
]
BWD_TIMED_CASES = ("minicpm-train", "griffin-train") + TIMED_CASES
# the backward's route by dtype, as the port's kernel.BWD_ROUTES must say
BWD_EXPECTED_ROUTES = {torch.bfloat16: "wgmma_bf16",
                       torch.float32: "scalar_f32"}


def bwd_errors(got, want, one_key):
    """(each of dq, dk, dv's max error over the plain gradient's max |.|,
    floored at BWD_SCALE_FLOOR of the largest of the three; the largest
    absolute error).  With ``one_key`` (every query sees one key), dq and
    dk vanish in exact arithmetic and are held against the largest scale."""
    scales = [float(w.abs().max()) for w in want]
    floor = BWD_SCALE_FLOOR * max(scales)
    if one_key:
        scales[0] = scales[1] = max(scales)
    errs = [float((g.float() - w).abs().max()) for g, w in zip(got, want)]
    return [e / max(sc, floor) for e, sc in zip(errs, scales)], max(errs)


def phase_kernel_bwd():
    """The flash backward against its plain version, and in bf16 against
    itself on a second call (bit for bit); returns the timing at minicpm's
    train shape, with recurrentgemma's train shape and minicpm's, granite's
    and recurrentgemma's prefill shapes under at_griffin_train_shape,
    at_minicpm_prefill_shape, at_granite_shape and at_griffin_shape."""
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    phase("kernel_bwd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for name, B, S, H, KH, Dh, causal, window in BWD_CASES:
        q32, k32, v32, do32 = (
            torch.randn((B, S, h, Dh), generator=gen, device="cuda")
            for h in (H, KH, KH, H))
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype).requires_grad_() for t in (q32, k32, v32))
            do = do32.to(dtype)
            route = kernel.BWD_ROUTES[dtype]
            check(route == BWD_EXPECTED_ROUTES[dtype],
                  f"flash backward's {dtype} route is {route}, not "
                  f"{BWD_EXPECTED_ROUTES[dtype]}")
            fwd_route = kernel.ROUTES[dtype][1]
            before = (kernel.BWD_LAUNCHES_BY_ROUTE[route],
                      kernel.LAUNCHES_BY_ROUTE[fwd_route])
            o = ops.flash_attention(q, k, v, causal=causal, window=window)
            bf16 = dtype == torch.bfloat16
            grads = torch.autograd.grad(o, (q, k, v), do, retain_graph=bf16)
            torch.cuda.synchronize()
            check((kernel.BWD_LAUNCHES_BY_ROUTE[route],
                   kernel.LAUNCHES_BY_ROUTE[fwd_route]) ==
                  (before[0] + 1, before[1] + 1),
                  f"flash backward {name} {dtype} did not run on {route} "
                  f"after a forward on {fwd_route}")
            same_note = ""
            if bf16:
                # deterministic: no atomics, every sum in a fixed order
                again = torch.autograd.grad(o, (q, k, v), do)
                same = all(torch.equal(a, b) for a, b in zip(grads, again))
                check(same, f"flash backward {name} {dtype}: a second call "
                            f"gave other bits")
                same_note = ", repeat bit-identical"
                del again
            qd, kd, vd = (t.detach() for t in (q, k, v))
            lse = ref.reference_attention_lse(qd, kd, causal=causal,
                                              window=window)
            want = ref.reference_attention_bwd(qd, kd, vd, o.detach(), lse,
                                               do, causal=causal,
                                               window=window)
            errs, abs_err = bwd_errors(grads, want, S == 1 or window == 1)
            del want
            tol = BWD_TOL[dtype]
            lse_note = ""
            if Dh in ops.SUPPORTED_HEAD_DIMS:
                # the log-sum-exp the training forward writes
                out = torch.empty_like(qd)
                klse = torch.empty((B, H, S), device="cuda")
                kernel.launch(qd, kd, vd, out, causal=causal, window=window,
                              lse=klse)
                torch.cuda.synchronize()
                lse_err = float((klse - lse).abs().max())
                lse_note = f", lse max_abs_err={lse_err:.3e}"
                check(lse_err <= LSE_ATOL,
                      f"flash forward {name} {dtype}: lse error {lse_err}")
            print(f"  {name:20s} {str(dtype):15s} B={B} S={S} H={H} KH={KH} "
                  f"Dh={Dh} causal={causal} window={window} ({route}): rel "
                  f"err dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} "
                  f"tol={tol:.0e}{lse_note}{same_note}", flush=True)
            check(all(math.isfinite(e) and e <= tol for e in errs),
                  f"flash backward {name} {dtype}: errors {errs} > {tol}")
            if name in BWD_TIMED_CASES and dtype == torch.bfloat16:
                result[name] = time_kernel_bwd(qd, kd, vd, do, causal,
                                               window, abs_err)
            del q, k, v, o, grads
    torch.cuda.empty_cache()
    timing = dict(result["minicpm-train"])
    timing["at_griffin_train_shape"] = result["griffin-train"]
    timing["at_minicpm_prefill_shape"] = result["minicpm-prefill"]
    timing["at_granite_shape"] = result["granite-prefill"]
    timing["at_griffin_shape"] = result["griffin-prefill"]
    return timing


def sdpa_bwd_call(q, k, v, do, causal, window):
    """(a call of ``torch.autograd.grad`` of SDPA on (B, S, heads, Dh) q,
    k, v and dO, whether it takes an explicit mask): a yardstick only, the
    port never calls it.  Where the window bites (some query is at least
    ``window`` past a key it could otherwise see), ``is_causal`` alone
    would attend beyond it, so SDPA gets the band as a boolean mask and
    computes the same function (masked SDPA, on another backend)."""
    import torch.nn.functional as F
    B, S, H, _ = q.shape
    KH = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    masked = 0 < window < S
    if masked:
        pos = torch.arange(S, device=q.device)
        dist = pos[:, None] - pos[None, :]
        band = dist < window
        if causal:
            band &= dist >= 0
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                            enable_gqa=H != KH)
    else:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                            enable_gqa=H != KH)
    dot = do.transpose(1, 2).contiguous()
    return (lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                        retain_graph=True)), masked


def time_kernel_bwd(q, k, v, do, causal, window, err):
    """The backward kernel's passes, its plain version and
    ``torch.autograd.grad`` of SDPA (``sdpa_bwd_call``) on the same
    inputs."""
    from repro_torch.kernels.flash_attention import kernel, ref
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    scale = 1.0 / math.sqrt(Dh)
    out, lse = torch.empty_like(q), torch.empty((B, H, S), device="cuda")
    kernel.launch(q, k, v, out, causal=causal, window=window, scale=scale,
                  lse=lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dsum = torch.empty_like(lse)
    kernel_ms = cuda_ms(lambda: kernel.launch_bwd(
        q, k, v, out, do, lse, dsum, dq, dk, dv, causal=causal,
        window=window, scale=scale), iters=10)
    plain_ms = cuda_ms(lambda: ref.reference_attention_bwd(
        q, k, v, out, lse, do, causal=causal, window=window), iters=3,
        warmup=1)
    sdpa, masked = sdpa_bwd_call(q, k, v, do, causal, window)
    library_ms = cuda_ms(sdpa, iters=10)
    del sdpa
    sdpa_name = "masked sdpa" if masked else "sdpa"
    bound_ms, bound_by, flops, nbytes = attention_bwd_bound(
        B, S, H, KH, Dh, causal, window, q.dtype)
    print(f"  backward timing at B={B} S={S} H={H} KH={KH} Dh={Dh} "
          f"window={window} {q.dtype} (splits "
          f"{kernel.bwd_splits(B, S, H, KH, Dh, sms)}): kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, {sdpa_name} "
          f"backward {library_ms:.4f} ms, kernel / {sdpa_name} "
          f"{kernel_ms / library_ms:.2f}x; bound {bound_ms:.4f} ms by "
          f"{bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"kernel / bound {kernel_ms / bound_ms:.2f}x", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library": sdpa_name}


def gmm_bound(E, C, d, f, gated, dtype):
    """(bound_ms, bound_by, flops, bytes) of one expert FFN on the card.

    FLOPs are 2*E*C*d*f per product (three with a gate, two without);
    bytes count xe, the weights and y once each (not the h workspace,
    which an ideal kernel keeps on chip)."""
    n_up = 2 if gated else 1
    flops = 2.0 * E * C * d * f * (n_up + 1)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * (2 * E * C * d + (n_up + 1) * E * d * f)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


# (name, E, C, d, f, act, gated, pad): the last ``pad`` rows of each bucket
# are zero, as pad rows are in the served buckets.  The first case is the
# serving (prefill) shape, timed with every row real.
GMM_CASES = [
    ("granite-prefill", 40, 1000, 1536, 512, "swiglu", True, 0),
    ("granite-decode", 40, 8, 1536, 512, "swiglu", True, 7),
    ("mixtral-prefill", 8, 1250, 4096, 14336, "swiglu", True, 100),
    ("ragged-1", 4, 1, 256, 512, "swiglu", True, 0),
    ("ragged-136", 4, 136, 256, 512, "swiglu", True, 17),
    ("odd-d-f", 3, 100, 211, 333, "swiglu", True, 9),
    ("geglu-136", 4, 136, 256, 512, "geglu", True, 17),
    ("relu2-no-w3", 4, 136, 256, 512, "relu2", False, 17),
]
# granite-moe's decode with served routing: 4 tokens routed top-8 of 40
# experts by a seeded router, the buckets (C 8) filled to each expert's
# count and zero after, the fills handed to the kernel as ``counts``
GMM_DECODE_ROUTED = ("granite-decode-routed", 40, 4, 8, 1536, 512)


def gmm_route(dtype, d, f) -> str:
    """The route of moe_gmm a contiguous fresh input takes (ops.py's rule):
    float32 on the scalar kernels, bf16 on wgmma where TMA can address it
    (d and f multiples of 8), else on the WMMA kernels."""
    if dtype == torch.float32:
        return "scalar_f32"
    return "wgmma_bf16" if d % 8 == 0 and f % 8 == 0 else "wmma_bf16"


def run_gmm_case(name, xe, p, act, counts, pad_note):
    """One moe_gmm call on the route its inputs pick, held against the
    plain version; returns (max abs error, rows at or past counts all 0)."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref
    E, C, d = xe.shape
    f = p["w1"].shape[-1]
    route = gmm_route(xe.dtype, d, f)
    got_route = ops.kernel_route(xe, p["w1"], p.get("w3"), p["w2"])
    check(got_route == route,
          f"moe_gmm {name}: route {got_route}, expected {route}")
    before = kernel.LAUNCHES_BY_ROUTE[route]
    out = ops.expert_ffn(xe, p, act, counts)
    torch.cuda.synchronize()
    check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
          f"moe_gmm {name} {xe.dtype} did not run on {route}")
    want = ref.reference_expert_ffn(
        xe.float(), {k: w.float() for k, w in p.items()}, act, counts)
    scale = float(want.abs().max())
    err = float((out.float() - want).abs().max())
    rel = err / scale if scale > 0 else err
    tol = GMM_RTOL[xe.dtype]
    pads_zero = True
    if counts is not None:
        rows = torch.arange(C, device=xe.device)
        pads_zero = not bool(out[rows[None, :] >= counts[:, None]].any())
    print(f"  {name:21s} {str(xe.dtype):15s} E={E} C={C} d={d} f={f} "
          f"{act}{'' if 'w3' in p else ' no w3'} ({route}): "
          f"max_abs_err={err:.3e} max|y|={scale:.3e} rel={rel:.3e} "
          f"tol={tol:.0e}; {pad_note}", flush=True)
    check(math.isfinite(rel) and rel <= tol,
          f"moe_gmm {name} {xe.dtype}: relative error {rel} > {tol}")
    check(pads_zero, f"moe_gmm {name} {xe.dtype}: a row past counts is not 0")
    return err


def phase_kernel_moe():
    """Returns the timings at the prefill and the routed decode shape."""
    from repro_torch.kernels.moe_gmm import kernel
    phase("kernel moe_gmm")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = None
    for name, E, C, d, f, act, gated, pad in GMM_CASES:
        x32 = torch.randn((E, C, d), generator=gen, device="cuda")
        x32[:, C - pad:] = 0.0
        p32 = {"w1": torch.randn((E, d, f), generator=gen, device="cuda")
               / math.sqrt(d),
               "w2": torch.randn((E, f, d), generator=gen, device="cuda")
               / math.sqrt(f)}
        if gated:
            p32["w3"] = torch.randn((E, d, f), generator=gen,
                                    device="cuda") / math.sqrt(d)
        for dtype in (torch.bfloat16, torch.float32):
            xe = x32.to(dtype)
            p = {k: w.to(dtype) for k, w in p32.items()}
            bound_ms, bound_by, _, _ = gmm_bound(E, C - pad, d, f, gated,
                                                 dtype)
            err = run_gmm_case(
                name, xe, p, act, None,
                f"bound over the {C - pad} real rows {bound_ms * 1e3:.2f} "
                f"us by {bound_by}")
            if result is None and dtype == torch.bfloat16:
                result = time_moe_kernel(xe, p, act, err)
            del xe, p
        del x32, p32
        torch.cuda.empty_cache()
    result["at_decode_routed"] = phase_kernel_moe_decode(gen)
    print(f"  moe_gmm launches by route in this phase: "
          f"{dict(kernel.LAUNCHES_BY_ROUTE)}", flush=True)
    return result


def routed_fills(E, T, k, gen):
    """Bucket fills of a seeded top-k routing of T tokens over E experts:
    int32 (E,), and the number of experts some token reached."""
    logits = torch.randn((T, E), generator=gen, device="cuda")
    idx = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    counts = torch.zeros(E, dtype=torch.int32, device="cuda")
    counts.scatter_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts, int((counts > 0).sum())


def phase_kernel_moe_decode(gen):
    """GMM_DECODE_ROUTED in bf16 and float32 against the plain version,
    and the bf16 kernel's time there beside two bounds: every expert's
    weights, and the touched experts' only."""
    from repro_torch.kernels.moe_gmm import ops
    name, E, T, C, d, f = GMM_DECODE_ROUTED
    counts, touched = routed_fills(E, T, 8, gen)
    rows = torch.arange(C, device="cuda")
    live = (rows[None, :] < counts[:, None])[..., None]
    x32 = torch.randn((E, C, d), generator=gen, device="cuda") * live
    p32 = {k: torch.randn(s, generator=gen, device="cuda") / math.sqrt(s[1])
           for k, s in (("w1", (E, d, f)), ("w3", (E, d, f)),
                        ("w2", (E, f, d)))}
    n_live = int(counts.sum())
    result = None
    for dtype in (torch.bfloat16, torch.float32):
        xe = x32.to(dtype)
        p = {k: w.to(dtype) for k, w in p32.items()}
        err = run_gmm_case(name, xe, p, "swiglu", counts,
                           f"{n_live} live rows in {touched} of {E} experts")
        if dtype == torch.bfloat16:
            kernel_ms = cuda_ms(lambda: ops.expert_ffn(xe, p, "swiglu",
                                                       counts), iters=50)
            all_ms, all_by, _, _ = gmm_bound(E, C, d, f, True, dtype)
            # the least the card could do: the touched experts' weights,
            # the live rows of xe read and of y written
            nbytes = 2 * (2 * n_live * d + 3 * touched * d * f)
            flops = 6.0 * n_live * d * f
            t_ops = flops / PEAK_FLOPS[dtype]
            t_bytes = nbytes / HBM_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"  timing at {name} (E={E} C={C} d={d} f={f} {dtype}, "
                  f"{n_live} live rows, {touched} experts touched): kernel "
                  f"{kernel_ms:.4f} ms; bound over the touched experts "
                  f"{bound_ms * 1e3:.2f} us by {bound_by} "
                  f"({nbytes / 1e6:.2f} MB), over all {E} experts "
                  f"{all_ms * 1e3:.2f} us by {all_by}", flush=True)
            result = {"max_abs_err": err, "ms": kernel_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "bound_all_experts_ms": all_ms,
                      "touched_experts": touched, "live_rows": n_live}
        del xe, p
    return result


def time_moe_kernel(xe, p, act, err):
    """Kernel, plain version and bmm-yardstick times at the serving shape."""
    from repro_torch.kernels.moe_gmm import ops, ref
    from repro_torch.models.layers import act_fn
    E, C, d = xe.shape
    f = p["w1"].shape[-1]
    kernel_ms = cuda_ms(lambda: ops.expert_ffn(xe, p, act))
    plain_ms = cuda_ms(lambda: ref.reference_expert_ffn(xe, p, act), iters=5)
    # yardstick only: no single PyTorch call computes this function, and the
    # port never calls bmm for the expert products
    fn = act_fn(act)
    yard_ms = cuda_ms(lambda: torch.bmm(
        fn(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"]), p["w2"]))
    bound_ms, bound_by, flops, nbytes = gmm_bound(E, C, d, f, True, xe.dtype)
    print(f"  timing at E={E} C={C} d={d} f={f} {xe.dtype}: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, yardstick (3 bmm + "
          f"act, not a port) {yard_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us "
          f"by {bound_by} ({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)",
          flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bmm_yardstick_ms": yard_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def rglru_bound(B, S, D, x_dtype, g_dtype, with_h0, fused):
    """(bound_ms, bound_by, flops, bytes) of one RG-LRU scan on the card.

    Bytes count x, ga, gx, lam (the biases b_a and b_i on the fused route,
    and h0) read once and y, h_last written once; operations are
    RGLRU_OPS_PER_ELEM float32 operations per (b, t, d) element."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    n = B * S * D
    nbytes = (n * (size[x_dtype] + 2 * size[g_dtype] + 4) + 4 * D
              + (8 * D if fused else 0)
              + 4 * B * D * (2 if with_h0 else 1))
    flops = float(RGLRU_OPS_PER_ELEM * n)
    t_ops = flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


# (name, B, S, D, x dtype, gate dtype, with h0, route).  The first two are
# the serving shape, timed (RGLRU_TIMED): on the fused route, as the bf16
# model hands its gates over (bf16 x, bf16 gate products and float32
# biases), and on whole float32 gates.  The kernel walks S in windows of
# 64 steps, 64 channels a block; D not a multiple of 8 stages with plain
# loads.
RGLRU_CASES = [
    ("griffin-prefill", 4, 1000, 4096, torch.bfloat16, torch.bfloat16,
     False, "fused_bias"),
    ("griffin-gates-f32", 4, 1000, 4096, torch.bfloat16, torch.float32,
     False, "gates"),
    ("griffin-prefill-f32", 4, 1000, 4096, torch.float32, torch.float32,
     False, "gates"),
    ("ragged-136", 2, 136, 128, torch.bfloat16, torch.float32, False,
     "gates"),
    ("d-640", 2, 128, 640, torch.bfloat16, torch.float32, False, "gates"),
    ("b-12", 12, 64, 128, torch.float32, torch.float32, False, "gates"),
    ("single-step", 3, 1, 256, torch.bfloat16, torch.float32, False,
     "gates"),
    ("odd-d", 3, 77, 200, torch.float32, torch.float32, False, "gates"),
    ("with-h0", 3, 77, 200, torch.bfloat16, torch.float32, True, "gates"),
    ("bf16-gates", 2, 136, 128, torch.bfloat16, torch.bfloat16, True,
     "gates"),
    ("fused-single-step", 1, 1, 96, torch.bfloat16, torch.bfloat16, True,
     "fused_bias"),
    ("fused-window-63", 3, 63, 77, torch.bfloat16, torch.bfloat16, False,
     "fused_bias"),
    ("fused-window-65", 12, 65, 200, torch.bfloat16, torch.bfloat16, True,
     "fused_bias"),
    ("fused-f32-129", 1, 129, 4100, torch.float32, torch.float32, True,
     "fused_bias"),
]
RGLRU_TIMED = ("griffin-prefill", "griffin-gates-f32")

# Long memory: a between 0.999 and 0.9999 at zero gate, from h0, on the
# fused route in bf16.  The plain version rounds each a, and over
# thousands of steps of a near 1 drifts from the recurrence in float64 by
# ~1e-5 of max |y| (1.1e-5 on an H100 at S 1000), so the kernel is held
# against float64 there: at most twice the plain version's own error and
# at most RGLRU_RTOL (the bar written before the first run on the card).
RGLRU_ORACLE_CASES = [("long-memory-1000", 2, 1000, 512),
                      ("long-memory-4096", 2, 4096, 512)]


def rglru_inputs(B, S, D, x_dt, g_dt, gen, u=(0.9, 0.999)):
    """(x, lam, ga, gx, h0, b_a, b_i) on the card; a in [u0, u1] at zero
    gate."""
    from repro_torch.kernels.rglru_scan.ref import RGLRU_C
    u = u[0] + (u[1] - u[0]) * torch.rand((D,), generator=gen, device="cuda")
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    x, ga, gx = (torch.randn((B, S, D), generator=gen, device="cuda")
                 for _ in range(3))
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    b_a, b_i = (0.5 * torch.randn((D,), generator=gen, device="cuda")
                for _ in range(2))
    return x.to(x_dt), lam, ga.to(g_dt), gx.to(g_dt), h0, b_a, b_i


def phase_kernel_rglru():
    from repro_torch.kernels.rglru_scan import kernel, ops, ref
    phase("kernel rglru_scan")
    gen = torch.Generator(device="cuda").manual_seed(2)
    timed = {}
    for name, B, S, D, x_dt, g_dt, with_h0, route in RGLRU_CASES:
        x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(B, S, D, x_dt, g_dt, gen)
        h0 = h0 if with_h0 else None
        bias = dict(b_a=b_a, b_i=b_i) if route == "fused_bias" else {}
        before = kernel.LAUNCHES_BY_ROUTE[route]
        y, h = ops.rglru(x, lam, ga, gx, h0, **bias)
        torch.cuda.synchronize()
        check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
              f"rglru_scan {name} did not run on {route}")
        # the plain version computes in float32 from the same inputs
        wy, wh = ref.reference_rglru(x, lam, ga, gx, h0, **bias)
        scale = float(wy.abs().max())
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        rel = err / scale if scale > 0 else err
        bound_ms, bound_by, _, _ = rglru_bound(B, S, D, x_dt, g_dt, with_h0,
                                               bool(bias))
        print(f"  {name:19s} x {str(x_dt):14s} gates {str(g_dt):14s} "
              f"B={B} S={S} D={D} h0={with_h0} ({route}): "
              f"max_abs_err={err:.3e} max|y|={scale:.3e} rel={rel:.3e} "
              f"tol={RGLRU_RTOL:.0e}; bound {bound_ms * 1e3:.2f} us by "
              f"{bound_by}", flush=True)
        check(math.isfinite(rel) and rel <= RGLRU_RTOL,
              f"rglru_scan {name}: relative error {rel} > {RGLRU_RTOL}")
        if name in RGLRU_TIMED:
            timed[route] = time_rglru_kernel(x, lam, ga, gx, bias, route,
                                             err)
        del x, ga, gx, y, wy
    for name, B, S, D in RGLRU_ORACLE_CASES:
        x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(
            B, S, D, torch.bfloat16, torch.bfloat16, gen, u=(0.999, 0.9999))
        truth = ref.oracle_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        y, _ = ops.rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        wy, _ = ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        scale = float(truth.abs().max())
        err = float((y.double() - truth).abs().max()) / scale
        plain_err = float((wy.double() - truth).abs().max()) / scale
        print(f"  {name:19s} B={B} S={S} D={D} a in [0.999, 0.9999], h0 "
              f"(fused_bias): against float64, kernel {err:.3e}, plain "
              f"{plain_err:.3e} (bar: <= 2x plain and <= {RGLRU_RTOL:.0e}); "
              f"kernel vs plain "
              f"{float((y - wy).abs().max()) / float(wy.abs().max()):.3e}",
              flush=True)
        check(err <= 2 * plain_err and err <= RGLRU_RTOL,
              f"rglru_scan {name}: {err} from float64, the plain version "
              f"{plain_err}")
        del x, ga, gx, y, wy, truth
    torch.cuda.empty_cache()
    return {**timed["fused_bias"], "timed_route": "fused_bias",
            "at_gates_route": timed["gates"]}


def time_rglru_kernel(x, lam, ga, gx, bias, route, err):
    """Kernel and plain times at the serving shape on ``route``; no single
    PyTorch call computes this function, so there is no library time."""
    from repro_torch.kernels.rglru_scan import ops, ref
    B, S, D = x.shape
    kernel_ms = cuda_ms(lambda: ops.rglru(x, lam, ga, gx, **bias))
    plain_ms = cuda_ms(lambda: ref.reference_rglru(x, lam, ga, gx, **bias),
                       iters=3, warmup=1)
    bound_ms, bound_by, flops, nbytes = rglru_bound(
        B, S, D, x.dtype, ga.dtype, False, bool(bias))
    print(f"  timing at B={B} S={S} D={D} x {x.dtype} gates {ga.dtype} "
          f"({route}): kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library: none; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{bound_ms / kernel_ms:.1%} of it", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


def mlstm_bound(B, S, H, Dh, dtype, with_init):
    """(bound_ms, bound_by, flops, bytes) of one chunkwise mLSTM on the card.

    Bytes count q, k, v, ig, fg (and an initial state) read once and h, C,
    n, m written once.  FLOPs count the least work of the function, whatever
    chunk an evaluation takes: per (b, h), q C and the state update
    (k g)^T v, 4 S Dh^2 at any chunk, plus the intra-chunk q k^T and W v
    over the (query, key) pairs the causal mask leaves, 2 S (T + 1) Dh at
    chunk T, least at T = 1 (the sequential form: 4 S Dh); at the peak rate
    of the input type, as the other kernels' bounds."""
    size = {torch.float32: 4, torch.bfloat16: 2}
    n = B * S * H * Dh
    state = 4 * (B * H * Dh * Dh + B * H * Dh + B * H)
    nbytes = (3 * n * size[dtype] + 4 * n + 2 * 4 * B * S * H
              + state * (2 if with_init else 1))
    flops = 4.0 * B * H * S * Dh * (Dh + 1)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


# (name, B, S, H, Dh, q/k/v dtype, with init_state, stress); the first is
# xlstm-1.3b's prefill shape (bf16 q, k, v and float32 gates, as the bf16
# model hands them over) and is timed.  A stress case has strongly negative
# forget gates (the chunk's forget sum underflows exp) and input gates near
# 90 (exp overflows float32), which only the stabiliser m keeps finite.
# With input gates that large the floor exp(-m) of the denominator is a
# float32 denormal, so where q . n cancels toward 0, h is ill-conditioned
# for any float32 evaluation.  Here the keys lie near their queries
# ("near-keys"), which keeps q . n from 0, so the plain version is a fair
# yardstick at 1e-4; MLSTM_ORACLE_CASE takes random keys.
MLSTM_CASES = [
    ("xlstm-prefill", 4, 1000, 4, 1024, torch.bfloat16, False, None),
    ("xlstm-prefill-f32", 4, 1000, 4, 1024, torch.float32, False, None),
    ("ragged-37", 2, 37, 4, 512, torch.bfloat16, False, None),
    ("single-step", 3, 1, 4, 1024, torch.bfloat16, False, None),
    ("dh-32", 2, 200, 4, 32, torch.float32, False, None),
    ("one-head", 1, 1000, 1, 1024, torch.bfloat16, False, None),
    ("with-init", 2, 136, 4, 512, torch.float32, True, None),
    ("stress", 2, 1000, 4, 1024, torch.bfloat16, False, "near-keys"),
    ("dh-1300", 1, 100, 2, 1300, torch.float32, False, None),
    # the wgmma route's chunk (128) and its edges, a Dh that is not a
    # multiple of 64, and a bf16 input that TMA cannot address (H * Dh odd:
    # its rows are not 16-byte strided), which takes the scalar bf16 route
    ("chunk-127", 2, 127, 4, 1024, torch.bfloat16, False, None),
    ("chunk-128", 2, 128, 4, 1024, torch.bfloat16, True, None),
    ("chunk-129", 2, 129, 4, 512, torch.bfloat16, False, None),
    ("chunk-257", 2, 257, 2, 1024, torch.bfloat16, True, None),
    ("dh-96", 2, 300, 4, 96, torch.bfloat16, True, None),
    ("tma-refused", 2, 150, 1, 37, torch.bfloat16, True, None),
    # 21 chunks of 64 MiB of state: two segments of the wgmma route's
    # bounded workspace, the second starting from the first one's state
    ("segments", 1, 2600, 16, 1024, torch.bfloat16, True, None),
]
MLSTM_PLAIN_CHUNK = 256     # the block's chunk, halved until it divides S

# The stress gates with random keys, where q . n may cancel toward the
# vanishing floor: the kernel, and the plain version at chunks 8 and 64
# (S = 1024 takes both unhalved), are each held against the recurrence
# step by step in float64.  A float32 evaluation of h then misses the
# truth by more than 1e-4 of max |h|: on an H100 the plain version's h by
# 1.33e-4 at both chunks (which differ from each other by 1.3e-5) and the
# kernel's by 1.15e-4; C and n by 1.4e-5 at chunk 64, 4e-8 at chunk 8 and
# in the kernel.  So the kernel's bar for each of h, C, n and m is
# MLSTM_RTOL or, where larger, twice the plain version's own worst error
# against the truth at either chunk (as a bf16 model is held at twice the
# reference's own bf16 error).
MLSTM_ORACLE_CASE = ("stress-random-keys", 2, 1024, 4, 1024, torch.bfloat16)
MLSTM_ORACLE_CHUNKS = (8, 64)


def mlstm_inputs(B, S, H, Dh, dtype, with_init, stress, gen):
    """(q, k, v, ig, fg) and init_state or None, on the card; ``stress``
    None, "near-keys" or "random-keys"."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    q, k, v = randn(B, S, H, Dh), randn(B, S, H, Dh), randn(B, S, H, Dh)
    ig, fg = randn(B, S, H), 3.0 + randn(B, S, H)   # forget bias 3 to 6
    if stress:
        ig, fg = ig + 90.0, fg - 12.0
    if stress == "near-keys":
        k = q + 0.5 * k
    init = (randn(B, H, Dh, Dh), randn(B, H, Dh), randn(B, H)) \
        if with_init else None
    return (q.to(dtype), k.to(dtype), v.to(dtype), ig, fg), init


def rel_errs(got, want) -> dict:
    """{leaf: max |got - want| / max |want|} over h, C, n, m, in
    want's dtype."""
    rels = {}
    for what, g, w in zip("hCnm", got, want):
        scale = float(w.abs().max())
        err = float((g.to(w.dtype) - w).abs().max())
        rels[what] = err / scale if scale > 0 else err
    return rels


def mlstm_route(dtype, Dh) -> str:
    """The route of mlstm_scan a contiguous fresh input takes (ops.py's
    rule): float32 on the scalar kernels, bf16 on wgmma where TMA can
    address it (Dh a multiple of 8), else on the scalar bf16 kernels."""
    if dtype == torch.float32:
        return "scalar_f32"
    return "wgmma_bf16" if Dh % 8 == 0 else "scalar_bf16"


def phase_kernel_mlstm():
    from repro_torch.kernels.mlstm_scan import kernel, ops, ref
    phase("kernel mlstm_scan")
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = None
    for name, B, S, H, Dh, dtype, with_init, stress in MLSTM_CASES:
        xs, init = mlstm_inputs(B, S, H, Dh, dtype, with_init, stress, gen)
        route = mlstm_route(dtype, Dh)
        check(ops.kernel_route(*xs[:3]) == route,
              f"mlstm_scan {name}: route {ops.kernel_route(*xs[:3])}, "
              f"expected {route}")
        before = kernel.LAUNCHES_BY_ROUTE[route]
        h, state = ops.mlstm_chunkwise(*xs, chunk=MLSTM_PLAIN_CHUNK,
                                       init_state=init)
        torch.cuda.synchronize()
        check(kernel.LAUNCHES_BY_ROUTE[route] == before + 1,
              f"mlstm_scan {name} did not run on {route}")
        # the plain version computes in float32 from the same inputs
        wh, wstate = ref.reference_mlstm(*xs, chunk=MLSTM_PLAIN_CHUNK,
                                         init_state=init)
        rels = rel_errs((h,) + state, (wh,) + wstate)
        h_err = float((h - wh).abs().max())
        bound_ms, bound_by, _, _ = mlstm_bound(B, S, H, Dh, dtype, with_init)
        print(f"  {name:17s} {str(dtype):15s} B={B} S={S} H={H} Dh={Dh} "
              f"init={with_init} ({route}): max_abs_err(h)={h_err:.3e} "
              f"max|h|={float(wh.abs().max()):.3e} rel " + " ".join(
                  f"{k}={r:.3e}" for k, r in rels.items())
              + f" tol={MLSTM_RTOL:.0e}; bound {bound_ms * 1e3:.2f} us by "
              f"{bound_by}", flush=True)
        for what, r in rels.items():
            check(math.isfinite(r) and r <= MLSTM_RTOL,
                  f"mlstm_scan {name} {what}: relative error {r} > "
                  f"{MLSTM_RTOL}")
        if result is None:
            result = time_mlstm_kernel(xs, h_err)
        del xs, init, h, state, wh, wstate
        torch.cuda.empty_cache()
    check_mlstm_against_oracle(gen)
    return result


def check_mlstm_against_oracle(gen):
    """MLSTM_ORACLE_CASE: kernel and plain version against the float64
    recurrence, the kernel within MLSTM_RTOL or twice the plain version's
    worst error, for each of h, C, n and m."""
    from repro_torch.kernels.mlstm_scan import ops, ref
    name, B, S, H, Dh, dtype = MLSTM_ORACLE_CASE
    xs, _ = mlstm_inputs(B, S, H, Dh, dtype, False, "random-keys", gen)
    h, state = ops.mlstm_chunkwise(*xs, chunk=MLSTM_PLAIN_CHUNK)
    torch.cuda.synchronize()
    wh, wstate = ref.sequential_oracle(*xs, dtype=torch.float64)
    truth = (wh,) + wstate
    plains = {}
    for c in MLSTM_ORACLE_CHUNKS:
        ph, pstate = ref.reference_mlstm(*xs, chunk=c)
        plains[c] = (ph,) + pstate
    plain_rels = {c: rel_errs(o, truth) for c, o in plains.items()}
    got = rel_errs((h,) + state, truth)
    c0, c1 = MLSTM_ORACLE_CHUNKS
    between = rel_errs(plains[c0], plains[c1])

    def fmt(rels):
        return " ".join(f"{k}={r:.3e}" for k, r in rels.items())
    print(f"  {name} {dtype} B={B} S={S} H={H} Dh={Dh}, against the float64 "
          f"recurrence (max|h| {float(wh.abs().max()):.3e}): kernel "
          f"{fmt(got)}; " + "; ".join(f"plain at chunk {c} {fmt(r)}"
                                      for c, r in plain_rels.items())
          + f"; plain at chunk {c0} against chunk {c1} {fmt(between)}",
          flush=True)
    for what, r in got.items():
        bar = max(MLSTM_RTOL,
                  2 * max(pr[what] for pr in plain_rels.values()))
        check(math.isfinite(r) and r <= bar,
              f"mlstm_scan {name} {what}: error {r} against the float64 "
              f"recurrence > {bar}")
    del xs, h, state, wh, wstate, truth, plains
    torch.cuda.empty_cache()


def time_mlstm_kernel(xs, err):
    """Kernel and plain times at the serving shape; no PyTorch call
    computes this function, so there is no library time.  Also the time of
    each kernel the call launches (by the profiler, over the same calls)
    and, beside it, the scalar bf16 kernels on the same inputs."""
    from repro_torch.kernels.mlstm_scan import kernel, ops, ref
    from torch.profiler import ProfilerActivity, profile
    B, S, H, Dh = xs[0].shape
    route = ops.kernel_route(*xs[:3])
    kernel_ms = cuda_ms(lambda: ops.mlstm_chunkwise(
        *xs, chunk=MLSTM_PLAIN_CHUNK))
    plain_ms = cuda_ms(lambda: ref.reference_mlstm(
        *xs, chunk=MLSTM_PLAIN_CHUNK), iters=3, warmup=1)
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = (torch.empty((B, S, H, Dh), **f32),
            torch.empty((B, H, Dh, Dh), **f32), torch.empty((B, H, Dh), **f32),
            torch.empty((B, H), **f32))
    scalar_ms = cuda_ms(lambda: kernel.launch(*xs, None, *outs,
                                              "scalar_bf16"), iters=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ops.mlstm_chunkwise(*xs, chunk=MLSTM_PLAIN_CHUNK)
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "mlstm_" in e.key and e.count:
            name = e.key.split("::")[-1].split("(")[0]
            passes[name] = e.self_device_time_total / e.count / 1e3
    ws = kernel.workspace_bytes(B, S, H, Dh, route)
    bound_ms, bound_by, flops, nbytes = mlstm_bound(B, S, H, Dh,
                                                    xs[0].dtype, False)
    print(f"  timing at B={B} S={S} H={H} Dh={Dh} q/k/v {xs[0].dtype} gates "
          f"{xs[3].dtype} ({route}): kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library: none, scalar_bf16 kernels "
          f"{scalar_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); workspace "
          f"{ws} B", flush=True)
    if passes:
        print("  passes of one call (profiler, mean of 10 calls): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()),
              flush=True)
    else:
        print("  passes of one call: not measured (the profiler saw no "
              "kernels)", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "kernel_route": route, "passes_ms": passes,
            "workspace_bytes": ws, "scalar_bf16_ms": scalar_ms}


# rglru_scan's backward against its plain version (explicit formulas in
# float32 on the same inputs and the forward's y), each gradient relative
# to the plain one's max |.|:
#  * bf16 dx, dga, dgx: rounded to bf16 on output (2**-9 of the value);
#    2e-2 as the other bf16 bars;
#  * float32 gradients, and dlam, db_a, db_i, dh0 in either dtype: the same
#    float32 formulas in another order (the carry composed over chunks of
#    64 steps, the per-channel sums over B * S from 64-step partials);
#    ~1e-6 apart, 1e-4 is the bar.
RGLRU_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# float32 operations per (b, t, d) element of the backward: the gates again
# (two sigmoids, expm1, sqrt: 12), the carry (2), dlog_a (7), dga (4),
# dgx (5), dx (2), three partial sums (3); pass 1's gates and carry (8)
RGLRU_BWD_OPS_PER_ELEM = 43

# (name, B, S, D, h0, dh_last, fused biases), each run with bf16 and with
# float32 x and gates: the train phase's own shape (recurrentgemma-9b, one
# microbatch of 4096; h_last unused, as in training), timed in bf16; the
# edges of the backward's 64-step chunks (S 1, 63, 64, 65, 129), D not a
# multiple of the 128-channel block (77, 200, 4100), h0 and dh_last, both
# routes.
RGLRU_BWD_CASES = [
    ("griffin-train", 1, TRAIN_SEQ, 4096, False, False, True),
    ("single-step", 2, 1, 256, True, True, True),
    ("chunk-63", 3, 63, 77, True, True, False),
    ("chunk-64", 2, 64, 128, False, True, True),
    ("chunk-65", 2, 65, 200, True, False, True),
    ("chunk-129", 1, 129, 4100, True, True, True),
    ("gates-1000", 2, 1000, 512, True, True, False),
]
# a from 0.999 to 0.9999 over 4096 steps, float32, from h0 with dh_last:
# the carry runs through thousands of a near 1, where every float32
# evaluation drifts from the truth (as the forward's long-memory case), so
# the kernel's gradients are held against autograd of the recurrence in
# float64, at most twice the plain version's own error, or 1e-4 where that
# is larger
RGLRU_BWD_ORACLE_CASE = ("long-memory-4096", 2, 4096, 512)


def rglru_bwd_bound(B, S, D, dtype, fused):
    """(bound_ms, bound_by, flops, bytes) of one RG-LRU backward: x, ga,
    gx (``dtype``), the forward's y and dy (float32), lam and the biases
    read once; dx, dga, dgx (``dtype``), dlam and the biases' gradients
    written once; RGLRU_BWD_OPS_PER_ELEM float32 operations an element."""
    size = torch.tensor([], dtype=dtype).element_size()
    n = B * S * D
    nbytes = n * (6 * size + 8) + 4 * D * (4 if fused else 2)
    flops = float(RGLRU_BWD_OPS_PER_ELEM * n)
    t_ops = flops / PEAK_FLOPS[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last):
    """The gradients (x, lam, ga, gx, h0, b_a, b_i; None where not given)
    through ``ops.rglru``'s autograd function, and its y."""
    from repro_torch.kernels.rglru_scan import ops
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (x, lam, ga, gx, h0, b_a, b_i)]
    y, h_last = ops.rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    outs, cots = ([y, h_last], [dy, dh_last]) if dh_last is not None \
        else ([y], [dy])
    given = [t for t in leaves if t is not None]
    got = iter(torch.autograd.grad(outs, given, cots))
    return [None if t is None else next(got) for t in leaves], y.detach()


def grad_errors(got, want, floor_frac=BWD_SCALE_FLOOR):
    """Each gradient's max error over the plain one's max |.|, floored at
    ``floor_frac`` of the largest of them (None stays None)."""
    scales = [float(w.abs().max()) for w in want if w is not None]
    floor = floor_frac * max(scales)
    return [None if w is None else
            float((g.float() - w.float()).abs().max()) /
            max(float(w.abs().max()), floor) for g, w in zip(got, want)]


def phase_kernel_rglru_bwd():
    """rglru_scan's backward through ``ops.rglru`` under grad against the
    plain backward, both dtypes; returns the timing at the train shape."""
    from repro_torch.kernels.rglru_scan import kernel, ref
    phase("kernel_bwd rglru_scan")
    gen = torch.Generator(device="cuda").manual_seed(4)
    names = ("dx", "dlam", "dga", "dgx", "dh0", "db_a", "db_i")
    timing = None
    for name, B, S, D, with_h0, with_dhl, fused in RGLRU_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(B, S, D, dtype,
                                                        dtype, gen)
            h0 = h0 if with_h0 else None
            b_a, b_i = (b_a, b_i) if fused else (None, None)
            dy = torch.randn((B, S, D), generator=gen, device="cuda")
            dh_last = torch.randn((B, D), generator=gen, device="cuda") \
                if with_dhl else None
            route = "fused_bias" if fused else "gates"
            before = (kernel.BWD_LAUNCHES_BY_ROUTE[route],
                      kernel.LAUNCHES_BY_ROUTE[route])
            got, y = rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last)
            torch.cuda.synchronize()
            check((kernel.BWD_LAUNCHES_BY_ROUTE[route],
                   kernel.LAUNCHES_BY_ROUTE[route]) ==
                  (before[0] + 1, before[1] + 1),
                  f"rglru_scan backward {name} {dtype} did not run on "
                  f"{route}")
            want = ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0,
                                           dh_last, b_a=b_a, b_i=b_i)
            errs = grad_errors(got, want)
            tols = [RGLRU_BWD_TOL[dtype] if k in ("dx", "dga", "dgx")
                    else RGLRU_BWD_TOL[torch.float32] for k in names]
            abs_err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(got, want) if w is not None)
            print(f"  {name:15s} {str(dtype):15s} B={B} S={S} D={D} "
                  f"h0={with_h0} dh_last={with_dhl} ({route}): rel err "
                  + " ".join(f"{k} {e:.3e}" for k, e in zip(names, errs)
                             if e is not None), flush=True)
            check(all(e is None or (math.isfinite(e) and e <= t)
                      for e, t in zip(errs, tols)),
                  f"rglru_scan backward {name} {dtype}: errors {errs}")
            if name == "griffin-train" and dtype == torch.bfloat16:
                timing = time_rglru_bwd(x, lam, ga, gx, b_a, b_i, y, dy,
                                        abs_err)
            del x, ga, gx, y, dy, got, want
    check_rglru_bwd_against_oracle(gen)
    torch.cuda.empty_cache()
    return timing


def check_rglru_bwd_against_oracle(gen):
    from repro_torch.kernels.rglru_scan import ref
    name, B, S, D = RGLRU_BWD_ORACLE_CASE
    x, lam, ga, gx, h0, b_a, b_i = rglru_inputs(
        B, S, D, torch.float32, torch.float32, gen, u=(0.999, 0.9999))
    dy = torch.randn((B, S, D), generator=gen, device="cuda")
    dh_last = torch.randn((B, D), generator=gen, device="cuda")
    got, y = rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last)
    plain = ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0, dh_last,
                                    b_a=b_a, b_i=b_i)
    leaves = [t.double().requires_grad_()
              for t in (x, lam, ga, gx, h0, b_a, b_i)]
    y64 = ref.oracle_rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    truth = torch.autograd.grad(
        (y64 * dy.double()).sum() + (y64[:, -1] * dh_last.double()).sum(),
        leaves)
    errs = grad_errors(got, truth)
    plain_errs = grad_errors(plain, truth)
    print(f"  {name} B={B} S={S} D={D} a in [0.999, 0.9999], h0, dh_last, "
          f"float32 (fused_bias): against autograd in float64, kernel "
          + " ".join(f"{e:.3e}" for e in errs) + "; plain "
          + " ".join(f"{e:.3e}" for e in plain_errs), flush=True)
    for e, pe in zip(errs, plain_errs):
        check(math.isfinite(e) and e <= max(RGLRU_BWD_TOL[torch.float32],
                                            2 * pe),
              f"rglru_scan backward {name}: {errs} against float64, the "
              f"plain version {plain_errs}")


def time_rglru_bwd(x, lam, ga, gx, b_a, b_i, y, dy, err):
    """The backward kernel's four passes and the plain backward at the
    train shape; no PyTorch call computes this gradient, so no library
    time."""
    from repro_torch.kernels.rglru_scan import kernel, ref
    B, S, D = x.shape
    f32 = dict(dtype=torch.float32, device="cuda")
    dx, dga, dgx = (torch.empty_like(t) for t in (x, ga, gx))
    dlam, db_a, db_i = (torch.empty((D,), **f32) for _ in range(3))
    kernel_ms = cuda_ms(lambda: kernel.launch_bwd(
        x, lam, ga, gx, b_a, b_i, None, y, dy, None, dx, dga, dgx, dlam,
        db_a, db_i, None))
    plain_ms = cuda_ms(lambda: ref.reference_rglru_bwd(
        x, lam, ga, gx, y, dy, b_a=b_a, b_i=b_i), iters=2, warmup=1)
    bound_ms, bound_by, flops, nbytes = rglru_bwd_bound(B, S, D, x.dtype,
                                                        b_a is not None)
    print(f"  backward timing at B={B} S={S} D={D} {x.dtype} (fused_bias): "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library: "
          f"none; bound {bound_ms * 1e3:.2f} us by {bound_by} "
          f"({flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), "
          f"{bound_ms / kernel_ms:.1%} of it", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}


# mlstm_scan's backward against its plain version (explicit formulas in
# float32, on the same inputs, the forward's h and its row statistics),
# each gradient relative to the plain one's max |.|, floored at 1e-3 of the
# largest of dq, dk, dv (or of dig, dfg):
#  * bf16 dq, dk, dv: rounded to bf16 on output; 2e-2 as the other bf16
#    bars;
#  * float32 dq, dk, dv, and dig and dfg in both dtypes: the same float32
#    formulas in another order (chunks of 64 on the card, sums over Dh and
#    S); ~1e-6 apart, 1e-4 is the bar.
# With one step (S 1) h does not depend on fg (F_t - F_s = 0), and where the
# clamp is inactive h = v sign(q . k): dfg, and dq and dk, vanish in exact
# arithmetic and hold only rounding, so each is held against the largest
# scale of its group.
MLSTM_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# (name, B, S, H, Dh, with init_state, stress), each in bf16 and float32:
# the train phase's own shape (xlstm-1.3b's mLSTM at train_4k, one
# microbatch), timed in bf16; S not a multiple of either chunk (200); S 1;
# input gates lowered by 8, so that the denominator's floor exp(-m) takes
# most rows ("clamp"); a constant initial state; Dh 1600, past which a
# state slab leaves shared memory; Dh 37, whose bf16 forward takes the
# scalar route.
MLSTM_BWD_CASES = [
    ("xlstm-train", 1, TRAIN_SEQ, 4, 1024, False, None),
    ("ragged-200", 2, 200, 4, 512, False, None),
    ("single-step", 2, 1, 4, 256, False, None),
    ("clamp-active", 1, 300, 4, 256, False, "clamp"),
    ("with-init", 2, 136, 4, 512, True, None),
    ("dh-1600", 1, 100, 1, 1600, False, None),
    ("dh-37", 2, 150, 1, 37, True, None),
]


def mlstm_bwd_bound(B, S, H, Dh, dtype, chunk):
    """(bound_ms, bound_by, flops, bytes) of one mLSTM backward.  FLOPs: per
    (b, h) the five state products (C's update, C dnum, D's update, D v,
    D^T k), 10 S Dh^2, and the five products over the pairs a chunk of
    ``chunk`` steps leaves under the causal mask, 5 S (chunk + 1) Dh; at the
    peak rate of the input type.  Bytes: q, k, v, h, dh, ig, fg and the row
    statistics read once, dq, dk, dv, dig and the row sums written once."""
    size = torch.tensor([], dtype=dtype).element_size()
    n = B * S * H * Dh
    nbytes = n * (6 * size + 8) + 4 * B * S * H * 6
    flops = float(B * H) * (10.0 * S * Dh * Dh + 5.0 * S * (chunk + 1) * Dh)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def phase_kernel_mlstm_bwd():
    """mlstm_scan's backward through ``ops.mlstm_chunkwise`` under grad
    against the plain backward, both dtypes, and the forward's row
    statistics against the plain ones; returns the timing at the train
    shape."""
    from repro_torch.kernels.mlstm_scan import kernel, ops, ref
    phase("kernel_bwd mlstm_scan")
    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("dq", "dk", "dv", "dig", "dfg")
    timing = None
    for name, B, S, H, Dh, with_init, stress in MLSTM_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            (q, k, v, ig, fg), init = mlstm_inputs(B, S, H, Dh, dtype,
                                                   with_init, None, gen)
            if stress == "clamp":
                ig = ig - 8.0
            dh = torch.randn((B, S, H, Dh), generator=gen, device="cuda")
            route = mlstm_route(dtype, Dh)
            check(ops.kernel_route(q, k, v) == route,
                  f"mlstm_scan backward {name} {dtype}: inputs on route "
                  f"{ops.kernel_route(q, k, v)}, not {route}")
            bwd_route = route   # the backward takes its forward's route
            leaves = [t.requires_grad_() for t in (q, k, v, ig, fg)]
            before = (kernel.BWD_LAUNCHES_BY_ROUTE[bwd_route],
                      kernel.LAUNCHES_BY_ROUTE[route])
            h, _ = ops.mlstm_chunkwise(*leaves, chunk=MLSTM_PLAIN_CHUNK,
                                       init_state=init)
            m_t, den = h.grad_fn.saved_tensors[-2:]
            got = torch.autograd.grad(h, leaves, dh)
            torch.cuda.synchronize()
            check((kernel.BWD_LAUNCHES_BY_ROUTE[bwd_route],
                   kernel.LAUNCHES_BY_ROUTE[route]) ==
                  (before[0] + 1, before[1] + 1),
                  f"mlstm_scan backward {name} {dtype} did not run on "
                  f"{bwd_route} after a forward on {route}")
            xs = [t.detach() for t in leaves]
            # the forward's statistics against the plain ones
            pm, pden, _ = ref.reference_mlstm_stats(*xs, init_state=init)
            m_err = float((m_t - pm).abs().max()) / \
                max(float(pm.abs().max()), 1.0)
            den_err = float((den - pden).abs().max()) / \
                float(pden.abs().max())
            want = ref.reference_mlstm_bwd(*xs, h.detach(), (m_t, den), dh,
                                           init_state=init)
            errs = grad_errors(got[:3], want[:3]) + \
                grad_errors(got[3:], want[3:])
            if S == 1:
                top = max(float(w.abs().max()) for w in want[:3])
                errs[:2] = [float((g.float() - w).abs().max()) / top
                            for g, w in zip(got[:2], want[:2])]
                errs[4] = float((got[4] - want[4]).abs().max()) / \
                    max(float(w.abs().max()) for w in want[3:])
            tols = [MLSTM_BWD_TOL[dtype]] * 3 + \
                [MLSTM_BWD_TOL[torch.float32]] * 2
            clamped = float((den.abs() <= torch.exp(-m_t)).float().mean())
            abs_err = max(float((g.float() - w).abs().max())
                          for g, w in zip(got, want))
            print(f"  {name:13s} {str(dtype):15s} B={B} S={S} H={H} Dh={Dh} "
                  f"init={with_init} ({route} -> {bwd_route}), clamped rows "
                  f"{clamped:.1%}: rel err " + " ".join(
                      f"{k} {e:.3e}" for k, e in zip(names, errs))
                  + f"; stats m {m_err:.3e} den {den_err:.3e}", flush=True)
            check(all(math.isfinite(e) and e <= t
                      for e, t in zip(errs, tols)),
                  f"mlstm_scan backward {name} {dtype}: errors {errs}")
            check(m_err <= MLSTM_RTOL and den_err <= MLSTM_RTOL,
                  f"mlstm_scan forward {name} {dtype}: row statistics "
                  f"m {m_err}, den {den_err}")
            if name == "xlstm-train" and dtype == torch.bfloat16:
                timing = time_mlstm_bwd(xs, h.detach(), (m_t, den), dh,
                                        abs_err, bwd_route)
            del q, k, v, ig, fg, leaves, h, got, want, xs
            torch.cuda.empty_cache()
    return timing


# The bound of the mLSTM backward counts the chunk's own pairs at chunks of
# 64, whatever chunk a route takes, so that the routes' times (and the
# scalar route's earlier ones) are held to one yardstick.
MLSTM_BWD_BOUND_CHUNK = 64


def time_mlstm_bwd(xs, h, stats, dh, err, route):
    """The backward on ``route`` (each of its passes by the profiler), the
    scalar bf16 route on the same inputs and the plain backward, at the
    train shape; no PyTorch call computes this gradient, so no library
    time."""
    from repro_torch.kernels.mlstm_scan import kernel, ref
    from torch.profiler import ProfilerActivity, profile
    q, k, v, ig, fg = xs
    B, S, H, Dh = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dig, rows = torch.empty_like(ig), torch.empty_like(ig)

    def run(on=route):
        kernel.launch_bwd(q, k, v, ig, fg, None, h, stats, dh, dq, dk, dv,
                          dig, rows, on)
    kernel_ms = cuda_ms(run, iters=10, warmup=1)
    scalar_ms = cuda_ms(lambda: run("scalar_bf16"), iters=3, warmup=1)
    plain_ms = cuda_ms(lambda: ref.reference_mlstm_bwd(
        q, k, v, ig, fg, h, stats, dh), iters=2, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        found = re.search(r"mlstm_(bwd_\w+|gates_kernel|states_kernel|"
                          r"qk_kernel)(<[^()]*>)?", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and found and \
                e.count:
            name = found.group(0)
            passes[name] = passes.get(name, 0.0) + \
                e.self_device_time_total / 3 / 1e3
    bound_ms, bound_by, flops, nbytes = mlstm_bwd_bound(
        B, S, H, Dh, q.dtype, MLSTM_BWD_BOUND_CHUNK)
    f32_bound_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    print(f"  backward timing at B={B} S={S} H={H} Dh={Dh} {q.dtype} "
          f"({route}, chunk {kernel.bwd_chunk(route)}): kernel "
          f"{kernel_ms:.4f} ms, scalar_bf16 {scalar_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library: none; bound {bound_ms * 1e3:.2f} us "
          f"by {bound_by} ({flops / 1e9:.2f} GFLOP at chunks of "
          f"{MLSTM_BWD_BOUND_CHUNK}, {nbytes / 1e6:.2f} MB; "
          f"{f32_bound_ms:.3f} ms at the float32 rate); passes "
          + (", ".join(f"{k} {v:.4f} ms" for k, v in passes.items())
             or "not measured"), flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "float32_rate_bound_ms": f32_bound_ms, "passes_ms": passes,
            "scalar_bf16_ms": scalar_ms}


def layer_counts(cfg) -> dict:
    """{block kind: number of layers} of a config's pattern."""
    counts: dict = {}
    for n in range(cfg.n_layers):
        kind = cfg.block_pattern[n % cfg.pattern_period]
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def phase_serve(arch: str, moe_dispatch: str = "einsum",
                profile_len: int = PROMPT_LEN):
    """Serve SERVE_REQUESTS requests of ``arch`` at full width through
    ``serve()``; returns (cfg, params, launches of each kernel, {kernel:
    launches by route} of flash_attention, moe_gmm, rglru_scan and
    mlstm_scan).  The
    profiled prefill takes the first ``profile_len`` prompt tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    from repro_torch.launch.serve import Request, serve
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import registry as R
    phase(f"serve {arch}")
    cfg = get_arch(arch)
    t0 = time.perf_counter()
    params = R.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = R.count_params_analytic(cfg)
    active = R.count_params_analytic(cfg, active_only=True)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params ({active / 1e9:.3f} B active) in "
          f"{cfg.dtype}, init {time.perf_counter() - t0:.2f} s; "
          f"moe_dispatch={moe_dispatch}", flush=True)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, size=PROMPT_LEN)
                    .astype(np.int32), GEN) for i in range(SERVE_REQUESTS)]
    ctx_len = PROMPT_LEN + GEN

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_kernel.reset_launches()
    gmm_kernel.reset_launches()
    rg_kernel.reset_launches()
    ml_kernel.reset_launches()
    t0 = time.perf_counter()
    done = serve(cfg, reqs, slots=SERVE_SLOTS, ctx_len=ctx_len,
                 params=params, moe_dispatch=moe_dispatch, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa_kernel.LAUNCHES,
                "moe_gmm": gmm_kernel.LAUNCHES,
                "rglru_scan": rg_kernel.LAUNCHES,
                "mlstm_scan": ml_kernel.LAUNCHES}
    fa_routes = dict(fa_kernel.LAUNCHES_BY_ROUTE)
    gmm_routes = dict(gmm_kernel.LAUNCHES_BY_ROUTE)
    rg_routes = dict(rg_kernel.LAUNCHES_BY_ROUTE)
    ml_routes = dict(ml_kernel.LAUNCHES_BY_ROUTE)
    peak = torch.cuda.max_memory_allocated()

    n_prefill = math.ceil(SERVE_REQUESTS / SERVE_SLOTS)
    # each batch decodes until every slot holds GEN tokens, and one step
    # more that finds them all done: GEN decode calls per batch
    n_decode = n_prefill * GEN
    check(len(done) == SERVE_REQUESTS, f"{len(done)} requests served")
    for r in done:
        check(len(r.generated) == GEN,
              f"request {r.rid} got {len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.rid}: token outside the vocab")
    kinds = layer_counts(cfg)
    n_attn = sum(kinds.get(k, 0) for k in ("attn", "swa", "local"))
    n_rglru = kinds.get("rglru", 0)
    n_mlstm = kinds.get("mlstm", 0)
    want = {"flash_attention": n_attn * n_prefill,
            "moe_gmm": cfg.n_layers * (n_prefill + n_decode)
            if cfg.is_moe and moe_dispatch == "gather" else 0,
            "rglru_scan": n_rglru * n_prefill,
            "mlstm_scan": n_mlstm * n_prefill}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times, expected {n}")
    # a bf16 model's attention runs on the wgmma route only
    fa_route = fa_kernel.ROUTES[getattr(torch, cfg.dtype)][1]
    check(fa_routes == {r: launches["flash_attention"] if r == fa_route else 0
                        for r in fa_routes},
          f"flash_attention launches by route {fa_routes}: a {cfg.dtype} "
          f"model must take {fa_route} only")
    # and its mLSTM layers and expert FFNs the wgmma route (contiguous
    # fresh q, k, v; buckets with d and f multiples of 8)
    check(cfg.dtype == "bfloat16", f"served in {cfg.dtype}")
    check(gmm_routes == {r: launches["moe_gmm"] if r == "wgmma_bf16" else 0
                         for r in gmm_routes},
          f"moe_gmm launches by route {gmm_routes}: a bfloat16 model must "
          f"take wgmma_bf16 only")
    check(ml_routes == {r: launches["mlstm_scan"] if r == "wgmma_bf16" else 0
                        for r in ml_routes},
          f"mlstm_scan launches by route {ml_routes}: a bfloat16 model must "
          f"take wgmma_bf16 only")
    # and every RG-LRU layer hands the scan its bf16 gate products with the
    # float32 biases, which the kernel adds itself
    check(rg_routes == {r: launches["rglru_scan"] if r == "fused_bias" else 0
                        for r in rg_routes},
          f"rglru_scan launches by route {rg_routes}: every RG-LRU layer "
          f"must take fused_bias")
    n_tok = sum(len(r.generated) for r in done)
    print(f"  served {len(done)} requests, {n_tok} new tokens in "
          f"{wall:.3f} s ({n_tok / wall:.1f} tok/s); flash_attention "
          f"launches {launches['flash_attention']} = {n_attn} attention "
          f"layers x {n_prefill} prefills; moe_gmm launches "
          f"{launches['moe_gmm']}"
          + (f" = {cfg.n_layers} x ({n_prefill} prefills + {n_decode} "
             f"decode steps)" if want["moe_gmm"] else "")
          + f"; rglru_scan launches {launches['rglru_scan']}"
          + (f" = {n_rglru} RG-LRU layers x {n_prefill} prefills"
             if want["rglru_scan"] else "")
          + f"; mlstm_scan launches {launches['mlstm_scan']}"
          + (f" = {n_mlstm} mLSTM layers x {n_prefill} prefills"
             if want["mlstm_scan"] else "")
          + f"; peak memory {peak / 2**30:.2f} GiB", flush=True)
    print(f"  flash_attention launches by route: {fa_routes}; moe_gmm "
          f"launches by route: {gmm_routes}; rglru_scan launches by route: "
          f"{rg_routes}; mlstm_scan launches by route: {ml_routes}",
          flush=True)
    print(f"  req{done[0].rid}: {done[0].generated}", flush=True)

    # per-step times at the same shapes, through the same step functions
    prefill = make_prefill_step(cfg, cache_len=ctx_len,
                                moe_dispatch=moe_dispatch, device="cuda")
    decode = make_serve_step(cfg, moe_dispatch=moe_dispatch, device="cuda")
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
        print_profile(f"prefill {SERVE_SLOTS}x{profile_len}", *profile_ms(
            lambda: prefill(params, {"tokens": toks[:, :profile_len]})))
        print_profile(f"decode step at batch {SERVE_SLOTS}", *profile_ms(
            lambda: decode(params, nxt, ctx_len - 1, cache)))
    return cfg, params, launches, {"flash_attention": fa_routes,
                                   "moe_gmm": gmm_routes,
                                   "rglru_scan": rg_routes,
                                   "mlstm_scan": ml_routes}


def count_drops(drops: list):
    """Wrap ``moe.moe_gather`` so that each call appends the number of
    (token, expert) pairs its capacity drops, from the same routing
    functions; returns a function that restores it."""
    from repro_torch.models import moe
    real = moe.moe_gather

    def counted(x, p, cfg):
        _, idx, _ = moe.router_topk(x, p["router"], cfg.top_k)
        C = moe._capacity(x.shape[0], cfg.n_experts, cfg.top_k,
                          cfg.capacity_factor)
        drops.append(int((moe._slots(idx.reshape(-1), cfg.n_experts)
                          >= C).sum()))
        return real(x, p, cfg)

    moe.moe_gather = counted

    def restore():
        moe.moe_gather = real
    return restore


def phase_consistency(cfg, params, moe_dispatch: str = "einsum",
                      tol: float = CONSISTENCY_RTOL):
    """prefill + decode_step against forward_logits in float32; the
    negative control decodes at a position off by one, or, in a model with
    no attention layer (it reads no position), feeds each decode step the
    previous token."""
    from repro_torch.models import registry as R
    phase(f"consistency {cfg.name}")
    kinds = layer_counts(cfg)
    control = "position" if any(kinds.get(k) for k in ("attn", "swa",
                                                        "local")) else "token"
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = 2, 200
    if cfg.is_moe:
        # capacity depends on T, so with drops prefill(S-4) and
        # forward_logits(S) would route different batches.  At this
        # factor C >= T: an expert gets at most one pair per token (top-k
        # experts differ), so no slot reaches C; the run counts the drops.
        cfg32 = dataclasses.replace(
            cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    p32 = {k: ([{g: {n: w.float() for n, w in sub.items()}
                 for g, sub in layer.items()} for layer in v]
               if k == "layers" else v.float())
           for k, v in params.items()}
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    drops: list = []

    def run(shift: int) -> float:
        pos_shift, tok_shift = (shift, 0) if control == "position" else \
            (0, shift)
        with torch.inference_mode():
            full = R.forward_logits(p32, cfg32, {"tokens": toks},
                                    moe_dispatch=moe_dispatch, device="cuda")
            logits, cache = R.prefill(p32, cfg32, {"tokens": toks[:, :S - 4]},
                                      cache_len=S, moe_dispatch=moe_dispatch,
                                      device="cuda")
            err = float((logits - full[:, S - 5]).abs().max())
            for t in range(S - 4, S - 1):
                tok = toks[:, t - tok_shift:t - tok_shift + 1]
                logits, cache = R.decode_step(p32, cfg32, tok,
                                              t + pos_shift, cache,
                                              moe_dispatch=moe_dispatch,
                                              device="cuda")
                err = max(err, float((logits - full[:, t]).abs().max()))
            return err / float(full.abs().max())

    if cfg.is_moe and moe_dispatch == "gather":
        restore = count_drops(drops)
        try:
            rel = run(0)
        finally:
            restore()
        # forward, prefill and 3 decode steps through every MoE layer
        check(len(drops) == 5 * cfg.n_layers and not any(drops),
              f"{sum(drops)} pairs dropped in {len(drops)} MoE calls")
        print(f"  capacity factor {cfg32.capacity_factor}: 0 of the "
              f"(token, expert) pairs dropped in {len(drops)} MoE calls",
              flush=True)
    else:
        rel = run(0)
    rel_bad = run(1)
    print(f"  B={B} S={S}: prefill({S - 4}) + 3 decode steps vs "
          f"forward_logits, float32: max rel err {rel:.3e} "
          f"(tol {tol:.0e}); off-by-one {control}: {rel_bad:.3e}",
          flush=True)
    check(rel <= tol, f"decode disagrees with forward: {rel}")
    check(rel_bad > tol,
          f"an off-by-one {control} passes the tolerance ({rel_bad})")


def _kernel_modules():
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.rglru_scan import kernel as rg_kernel
    return fa_kernel, gmm_kernel, rg_kernel, ml_kernel


def kernel_launches() -> dict:
    """Every kernel's launch count, each backward apart."""
    fa, gmm, rg, ml = _kernel_modules()
    return {"flash_attention": fa.LAUNCHES,
            "flash_attention_bwd": fa.BWD_LAUNCHES, "moe_gmm": gmm.LAUNCHES,
            "rglru_scan": rg.LAUNCHES, "rglru_scan_bwd": rg.BWD_LAUNCHES,
            "mlstm_scan": ml.LAUNCHES, "mlstm_scan_bwd": ml.BWD_LAUNCHES}


def kernel_routes() -> dict:
    """Every kernel's launches by route, each backward apart."""
    fa, gmm, rg, ml = _kernel_modules()
    return {"flash_attention": dict(fa.LAUNCHES_BY_ROUTE),
            "flash_attention_bwd": dict(fa.BWD_LAUNCHES_BY_ROUTE),
            "moe_gmm": dict(gmm.LAUNCHES_BY_ROUTE),
            "rglru_scan": dict(rg.LAUNCHES_BY_ROUTE),
            "rglru_scan_bwd": dict(rg.BWD_LAUNCHES_BY_ROUTE),
            "mlstm_scan": dict(ml.LAUNCHES_BY_ROUTE),
            "mlstm_scan_bwd": dict(ml.BWD_LAUNCHES_BY_ROUTE)}


def reset_kernel_launches() -> None:
    for module in _kernel_modules():
        module.reset_launches()


def step_launches(cfg, microbatches: int, backward: bool) -> dict:
    """The launches of one train step (``backward``) or eval step: per
    microbatch and layer a forward, and under full remat its recompute and
    one backward."""
    counts = layer_counts(cfg)
    layers = {"flash_attention": sum(counts.get(k, 0) for k in
                                     ("attn", "swa", "local")),
              "rglru_scan": counts.get("rglru", 0),
              "mlstm_scan": counts.get("mlstm", 0)}
    want = {k: 0 for k in kernel_launches()}
    for name, n in layers.items():
        if backward:
            want[name] = n * microbatches * (2 if cfg.remat == "full" else 1)
            want[name + "_bwd"] = n * microbatches
        else:
            want[name] = n
    return want


# the route every launch of a bf16 model's train step takes
TRAIN_ROUTES = {"flash_attention": "wgmma_bf16",
                "flash_attention_bwd": "wgmma_bf16",
                "rglru_scan": "fused_bias", "rglru_scan_bwd": "fused_bias",
                "mlstm_scan": "wgmma_bf16", "mlstm_scan_bwd": "wgmma_bf16"}
# the routes of the float32 consistency step
CONSIST_ROUTES = {"flash_attention": "scalar_f32",
                  "flash_attention_bwd": "scalar_f32",
                  "rglru_scan": "fused_bias", "rglru_scan_bwd": "fused_bias",
                  "mlstm_scan": "scalar_f32", "mlstm_scan_bwd": "scalar_f32"}


def check_routes(routes, launches, expected, what):
    for name, want_route in expected.items():
        check(routes[name] == {r: launches[name] if r == want_route else 0
                               for r in routes[name]},
              f"{what}: {name} launches by route {routes[name]}, all "
              f"expected on {want_route}")


def phase_train(arch: str = ARCH, n_layers=None, seq: int = TRAIN_SEQ,
                profile: bool = True):
    """Four AdamW steps of full-width ``arch`` (``n_layers`` layers, or its
    full depth) at ``seq``, then an eval step, through ``make_train_step``
    / ``make_eval_step``; returns ({kernel: launches over the steps and the
    eval}, {kernel: launches by route}, {step metrics and times})."""
    from repro_torch.configs import get_arch, get_schedule
    from repro_torch.data import batch_for
    from repro_torch.launch.steps import make_eval_step, make_train_step
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init
    phase(f"train {arch}")
    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16",
          f"{cfg.name} trains with remat={cfg.remat} in {cfg.dtype}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # float32 master weights from a seed, cast to bf16 at use
    params = R.init_params(cfg, 0, device="cuda", param_dtype=torch.float32)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    n_params = R.count_params_analytic(cfg)
    shape = ShapeSpec("train", seq, TRAIN_BATCH, "train")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in batch_for(cfg, shape, seed=0, step=0).items()}
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS,
                       schedule=get_schedule(arch))
    print(f"  {cfg.name}: {cfg.n_layers} layers {layer_counts(cfg)}, "
          f"d={cfg.d_model}, {n_params / 1e9:.3f} B params, float32 weights "
          f"and AdamW moments, {cfg.dtype} compute, remat={cfg.remat}; batch "
          f"{TRAIN_BATCH} x {seq} as {TRAIN_ACCUM} microbatches; "
          f"{ocfg.schedule} lr {ocfg.lr} warmup {ocfg.warmup_steps} of "
          f"{ocfg.total_steps}; init {time.perf_counter() - t0:.2f} s",
          flush=True)
    step_fn = make_train_step(cfg, ocfg, accum_steps=TRAIN_ACCUM,
                              device="cuda")
    want = step_launches(cfg, TRAIN_ACCUM, backward=True)
    reset_kernel_launches()
    history = []
    for i in range(TRAIN_STEPS):
        before = kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in metrics.items()}
        after = kernel_launches()
        delta = {k: after[k] - before[k] for k in after}
        check(all(math.isfinite(v) for v in m.values()),
              f"train step {i + 1}: a metric is not finite: {m}")
        check(delta == want, f"train step {i + 1} launched {delta}, "
              f"expected {want}")
        m["ms"] = ms
        m["tokens_per_s"] = TRAIN_BATCH * seq / (ms / 1e3)
        history.append(m)
        print(f"  step {i + 1}: loss {m['loss']:.5f} nll {m['nll']:.5f} "
              f"acc {m['acc']:.4f} grad_norm {m['grad_norm']:.4f} lr "
              f"{m['lr']:.3e}; {ms:.1f} ms, {m['tokens_per_s']:.1f} "
              f"tokens/s; launches {delta}", flush=True)
    check(history[-1]["loss"] < history[0]["loss"],
          f"the loss did not fall over {TRAIN_STEPS} steps on one batch: "
          f"{history[0]['loss']} -> {history[-1]['loss']}")
    peak = torch.cuda.max_memory_allocated()
    before = kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = {k: float(v) for k, v in
          make_eval_step(cfg, device="cuda")(params, batch).items()}
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    delta = {k: v - before[k] for k, v in kernel_launches().items()}
    check(all(math.isfinite(v) for v in ev.values()),
          f"eval: a metric is not finite: {ev}")
    check(delta == step_launches(cfg, TRAIN_ACCUM, backward=False),
          f"the eval step launched {delta}")
    launches = kernel_launches()
    routes = kernel_routes()
    check_routes(routes, launches, TRAIN_ROUTES, f"train {cfg.name}")
    steady = [h["ms"] for h in history[1:]]
    print(f"  eval: loss {ev['loss']:.5f} nll {ev['nll']:.5f} acc "
          f"{ev['acc']:.4f}; {eval_ms:.1f} ms; loss {history[0]['loss']:.5f}"
          f" -> {history[-1]['loss']:.5f} over {TRAIN_STEPS} steps",
          flush=True)
    print(f"  {TRAIN_STEPS} steps + eval: launches {launches}; by route "
          f"{routes}; step time {min(steady):.1f}-{max(steady):.1f} ms after "
          f"the first ({history[0]['ms']:.1f} ms); peak memory over the "
          f"steps {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)", flush=True)
    if profile:
        # where the time goes: one more step, under the profiler
        print_profile("train step", *profile_ms(
            lambda: step_fn(params, opt, batch)))
    del params, opt, batch, step_fn
    torch.cuda.empty_cache()
    return launches, routes, {"steps": history, "eval": ev,
                              "eval_ms": eval_ms, "peak_bytes": peak}


def phase_train_consistency(arch: str = ARCH, n_layers: int = CONSIST_LAYERS,
                            seq: int = CONSIST_SEQ):
    """One float32 training step's loss and gradients on the card against
    the same on the CPU, at full width and ``n_layers`` layers, with the
    labels shifted by one position as the negative control."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import flatten_with_paths
    from repro_torch.data import batch_for
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.tree import tree_map
    phase(f"train consistency {arch}")
    cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers,
                              dtype="float32")
    params = R.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    batch = batch_for(cfg, ShapeSpec("consistency", seq, 1, "train"),
                      seed=1)

    def run(device, labels):
        p = tree_map(lambda t: t.detach().to(device).requires_grad_(True),
                     params)
        loss, _ = R.forward_train(p, cfg, {"tokens": batch["tokens"],
                                           "labels": labels}, device=device)
        loss.backward()
        return float(loss.detach()), {k: t.grad.detach().cpu() for k, t in
                                      flatten_with_paths(p).items()}

    reset_kernel_launches()
    t0 = time.perf_counter()
    loss_gpu, g_gpu = run("cuda", batch["labels"])
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = kernel_launches()
    want = step_launches(cfg, 1, backward=True)
    check(launches == want,
          f"the float32 step launched {launches}, expected {want}")
    check_routes(kernel_routes(), launches, CONSIST_ROUTES,
                 f"train consistency {cfg.name}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loss_cpu, g_cpu = run("cpu", batch["labels"])
    cpu_s = time.perf_counter() - t0
    _, g_bad = run("cpu", np.roll(batch["labels"], 1, axis=1))

    def rel(got, want):
        top = max(float(w.abs().max()) for w in want.values())
        return max(float((got[k] - w).abs().max()) /
                   max(float(w.abs().max()), TRAIN_FLOOR * top)
                   for k, w in want.items())
    err, err_bad = rel(g_gpu, g_cpu), rel(g_gpu, g_bad)
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"  {cfg.n_layers} layers {layer_counts(cfg)} at full width, "
          f"float32, S={seq}: loss card {loss_gpu:.6f} cpu {loss_cpu:.6f} "
          f"(rel err {loss_err:.3e}); max rel grad err over {len(g_cpu)} "
          f"leaves {err:.3e} (tol {TRAIN_RTOL:.0e}); labels shifted by one: "
          f"{err_bad:.3e}; card {gpu_s:.2f} s, cpu {cpu_s:.2f} s; launches "
          f"{launches}", flush=True)
    check(loss_err <= TRAIN_RTOL, f"the loss disagrees: {loss_err}")
    check(err <= TRAIN_RTOL, f"the gradients disagree: {err}")
    check(err_bad > TRAIN_RTOL,
          f"shifted labels pass the tolerance ({err_bad})")
    del params, g_gpu, g_cpu, g_bad
    return {"rel_err": err, "shifted_rel_err": err_bad}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this runs on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    card = phase_device()
    phase_build()
    fa_timing = phase_kernel()
    bwd_timing = phase_kernel_bwd()
    rg_bwd_timing = phase_kernel_rglru_bwd()
    ml_bwd_timing = phase_kernel_mlstm_bwd()
    gmm_timing = phase_kernel_moe()
    rg_timing = phase_kernel_rglru()
    ml_timing = phase_kernel_mlstm()
    routes = {}     # {arch: {kernel: launches by route}}
    cfg, params, dense_launches, routes[ARCH] = phase_serve(ARCH)
    phase_consistency(cfg, params)
    del params
    torch.cuda.empty_cache()
    cfg, params, moe_launches, routes[MOE_ARCH] = \
        phase_serve(MOE_ARCH, moe_dispatch="gather")
    phase_consistency(cfg, params, moe_dispatch="gather")
    del params
    torch.cuda.empty_cache()
    cfg, params, griffin_launches, routes[GRIFFIN_ARCH] = \
        phase_serve(GRIFFIN_ARCH)
    phase_consistency(cfg, params, tol=GRIFFIN_CONSISTENCY_RTOL)
    del params
    torch.cuda.empty_cache()
    cfg, params, xlstm_launches, routes[XLSTM_ARCH] = \
        phase_serve(XLSTM_ARCH, profile_len=XLSTM_PROFILE_LEN)
    phase_consistency(cfg, params, tol=XLSTM_CONSISTENCY_RTOL)
    del params
    torch.cuda.empty_cache()
    train_launches, train_routes, _ = phase_train()
    phase_train_consistency()
    griffin_train, griffin_train_routes, _ = phase_train(
        GRIFFIN_ARCH, GRIFFIN_TRAIN_LAYERS)
    phase_train_consistency(GRIFFIN_ARCH, GRIFFIN_CONSIST_LAYERS,
                            RECURRENT_CONSIST_SEQ)
    xlstm_train, xlstm_train_routes, _ = phase_train(
        XLSTM_ARCH, XLSTM_TRAIN_LAYERS, XLSTM_TRAIN_SEQ, profile=False)
    phase_train_consistency(XLSTM_ARCH, XLSTM_CONSIST_LAYERS,
                            RECURRENT_CONSIST_SEQ)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         # launches and times on its first path (minicpm-2b serving); the
         # other paths' counts, each checked in its serve phase, the counts
         # by route (bf16 on wgmma_bf16), and the times at granite-moe's
         # (GQA) and recurrentgemma's (head dim 256, MQA) prefill shapes
         "launches": dense_launches["flash_attention"],
         **fa_timing["minicpm-prefill"],
         "launches_by_path": {
             ARCH: dense_launches["flash_attention"],
             MOE_ARCH: moe_launches["flash_attention"],
             GRIFFIN_ARCH: griffin_launches["flash_attention"],
             XLSTM_ARCH: xlstm_launches["flash_attention"],
             f"{ARCH} train": train_launches["flash_attention"],
             f"{GRIFFIN_ARCH} train": griffin_train["flash_attention"]},
         "launches_by_route": {
             **{arch: r["flash_attention"] for arch, r in routes.items()},
             f"{ARCH} train": train_routes["flash_attention"],
             f"{GRIFFIN_ARCH} train": griffin_train_routes["flash_attention"]},
         "at_granite_shape": fa_timing["granite-prefill"],
         "at_griffin_shape": fa_timing["griffin-prefill"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain attention
         # (src/repro/models/layers.py:90) with jax.grad
         "replaces": "src/repro/kernels/flash_attention/kernel.py:72",
         # launches on its path, minicpm-2b training (4 steps and an eval),
         # all on wgmma_bf16 (checked in the train phase); times at that
         # path's shape (B 1, S 4096, 36 heads of 64), and at
         # recurrentgemma's train shape and minicpm's, granite's and
         # recurrentgemma's prefill shapes
         "launches": train_launches["flash_attention_bwd"],
         "launches_by_route": {
             f"{ARCH} train": train_routes["flash_attention_bwd"],
             f"{GRIFFIN_ARCH} train":
                 griffin_train_routes["flash_attention_bwd"]},
         "launches_by_path": {
             f"{ARCH} train": train_launches["flash_attention_bwd"],
             f"{GRIFFIN_ARCH} train": griffin_train["flash_attention_bwd"]},
         **bwd_timing},
        {"name": "moe_gmm", "route": "cuda",
         "source": "src/repro_torch/kernels/moe_gmm/csrc/moe_gmm.cu",
         "replaces": "src/repro/kernels/moe_gmm/kernel.py:55",
         # launches on granite-moe's serving, all on wgmma_bf16 (checked in
         # its serve phase); times at its prefill shape with every row live,
         # and in "at_decode_routed" at its decode with a routing's fills
         "launches": moe_launches["moe_gmm"],
         "launches_by_route": routes[MOE_ARCH]["moe_gmm"], **gmm_timing},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:55",
         # launches on recurrentgemma-9b's serving, all on fused_bias
         # (checked in its serve phase); times at its prefill shape on that
         # route, and in "at_gates_route" on whole float32 gates
         "launches": griffin_launches["rglru_scan"],
         "launches_by_route": routes[GRIFFIN_ARCH]["rglru_scan"],
         "launches_by_path": {
             GRIFFIN_ARCH: griffin_launches["rglru_scan"],
             f"{GRIFFIN_ARCH} train": griffin_train["rglru_scan"]},
         **rg_timing},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/rglru_scan/csrc/"
                   "rglru_scan_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain recurrence
         # (src/repro/models/rglru.py:41) with jax.grad
         "replaces": "src/repro/kernels/rglru_scan/kernel.py:55",
         # launches on its path, recurrentgemma-9b training (4 steps and an
         # eval), all on fused_bias (checked in the train phase); times at
         # that path's shape (B 1, S 4096, D 4096, bf16)
         "launches": griffin_train["rglru_scan_bwd"],
         "launches_by_route": griffin_train_routes["rglru_scan_bwd"],
         **rg_bwd_timing},
        {"name": "mlstm_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/mlstm_scan/csrc/mlstm_scan.cu",
         "replaces": "src/repro/kernels/mlstm_scan/kernel.py:85",
         # launches on xlstm-1.3b's serving, all on the route in
         # "kernel_route" (checked in its serve phase); times at its prefill
         # shape, with each pass and the scalar bf16 kernels beside them
         "launches": xlstm_launches["mlstm_scan"],
         "launches_by_route": routes[XLSTM_ARCH]["mlstm_scan"],
         "launches_by_path": {
             XLSTM_ARCH: xlstm_launches["mlstm_scan"],
             f"{XLSTM_ARCH} train": xlstm_train["mlstm_scan"]},
         **ml_timing},
        {"name": "mlstm_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/mlstm_scan/csrc/"
                   "mlstm_scan_bwd.cu",
         # the gradient of the TPU kernel above, which has none of its own:
         # the reference differentiates its plain chunkwise function
         # (src/repro/models/xlstm.py:92) with jax.grad
         "replaces": "src/repro/kernels/mlstm_scan/kernel.py:85",
         # launches on its path, xlstm-1.3b training (4 steps and an eval),
         # all on wgmma_bf16 (checked in the train phase); times at the
         # mLSTM's train_4k shape (B 1, S 4096, 4 heads of 1024, bf16),
         # with each pass and the scalar bf16 route beside them
         "launches": xlstm_train["mlstm_scan_bwd"],
         "launches_by_route": xlstm_train_routes["mlstm_scan_bwd"],
         **ml_bwd_timing},
    ]
    for k in kernels:
        # the same numbers again under short names (bound in microseconds)
        k.update(max_err=k["max_abs_err"], kernel_ms=k["ms"],
                 bound_us=k["bound_ms"] * 1e3)
    print(json.dumps({"kernels": kernels}))
    print(card)
    # the run uses one card, whatever the machine shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
