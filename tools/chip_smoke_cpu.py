#!/usr/bin/env python3
"""Rehearse chip_smoke.py's attention-only phases on the CPU, at the
reduced configs, before a chip call.

    PYTHONPATH=src python3 tools/chip_smoke_cpu.py [PHASE ...]

PHASE is any of ``serve-vision``, ``consistency-vision``, ``train-audio``,
``train-consistency-audio`` and ``train-consistency`` (minicpm-2b); by
default all of them.  The script runs a copy of chip_smoke.py with every
``"cuda"`` made ``"cpu"`` and ``torch.cuda``'s memory and synchronisation
calls stubbed, every architecture replaced by its ``-smoke`` config (remat
"full", as the train phases require) and the serving and encode sizes cut.
The flash kernel's ``launch`` and ``launch_bwd`` are replaced by functions
that fill their outputs from the plain versions (``ref``) and count their
launches by route, and CPU tensors are routed through the wrapper's
kernel path and its autograd function, so that every launch check of
these phases runs as it does on the card.  Only the flash kernel is
faked: phases that launch moe_gmm, rglru_scan or mlstm_scan are not
rehearsed here.  Timings are CPU times and mean nothing.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

PHASES = ("serve-vision", "consistency-vision", "train-audio",
          "train-consistency-audio", "train-consistency")


def fake_launch(q, k, v, out, *, causal, window, scale=None, lse=None):
    # the plain versions scale by 1/sqrt of q's (padded) head dim
    qs = q.float() * ((scale or 1 / math.sqrt(q.shape[3]))
                      * math.sqrt(q.shape[3]))
    out.copy_(ref.reference_attention(qs, k.float(), v.float(),
                                      causal=causal, window=window))
    if lse is not None:
        lse.copy_(ref.reference_attention_lse(qs, k.float(), causal=causal,
                                              window=window))
    kernel.LAUNCHES += 1
    kernel.LAUNCHES_BY_ROUTE[kernel.ROUTES[q.dtype][1]] += 1


def fake_launch_bwd(q, k, v, out, dout, lse, dsum, dq, dk, dv, *, causal,
                    window, scale, splits=None):
    c = scale * math.sqrt(q.shape[3])
    dqs, dks, dvs = ref.reference_attention_bwd(
        q.float() * c, k.float(), v.float(), out.float(), lse, dout.float(),
        causal=causal, window=window)
    dq.copy_(dqs * c)
    dk.copy_(dks)
    dv.copy_(dvs)
    kernel.BWD_LAUNCHES += 1
    kernel.BWD_LAUNCHES_BY_ROUTE[kernel.BWD_ROUTES[q.dtype]] += 1


def flash_on_the_cpu(q, k, v, *, causal=True, window=0):
    """``ops.flash_attention`` without its CPU branch and device checks."""
    ops._check_shapes(q, k, v, window)
    head_dim = q.shape[3]
    scale = 1.0 / math.sqrt(head_dim)
    q, k, v = ops.kernel_layout(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = ops.FlashAttentionFunction.apply(q, k, v, causal, window, scale)
    else:
        out, _ = ops._forward(q, k, v, causal, window, scale, with_lse=False)
    return out if head_dim == out.shape[3] else \
        out[..., :head_dim].contiguous()


def load_chip_smoke():
    """chip_smoke.py's namespace, rewritten for the CPU at smoke size."""
    kernel.launch, kernel.launch_bwd = fake_launch, fake_launch_bwd
    ops.flash_attention = transformer.flash_attention = flash_on_the_cpu
    full = configs.get_arch

    def get_arch(name):
        if name.endswith("-smoke"):
            return full(name)
        return dataclasses.replace(full(name).reduced(), remat="full")
    configs.get_arch = get_arch
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0

    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        src = f.read().replace('"cuda"', '"cpu"').replace(".cuda()",
                                                          ".cpu()")
    ns = {"__name__": "chip_smoke_cpu", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    ns["cuda_ms"] = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
    ns["profile_ms"] = lambda fn: (fn(), (1.0, 0.0, [], {}))[1]
    ns.update(PROMPT_LEN=40, GEN=4, ENCODE_BATCH=2, TRAIN_SEQ=64)
    return ns


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or list(PHASES)
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {PHASES}")
    cs = load_chip_smoke()
    runs = {
        "serve-vision": lambda: cs["phase_serve_vision"](),
        "consistency-vision": lambda: cs["phase_consistency_vision"](
            seq=32),
        "train-audio": lambda: cs["phase_train"](
            cs["AUDIO_ARCH"], seq=cs["TRAIN_SEQ"], profile=False,
            extra=cs["time_encode"]),
        "train-consistency-audio": lambda: cs["phase_train_consistency"](
            cs["AUDIO_ARCH"], cs["AUDIO_CONSIST_LAYERS"], 32),
        "train-consistency": lambda: cs["phase_train_consistency"](
            cs["ARCH"], cs["CONSIST_LAYERS"], 32),
    }
    t0 = time.perf_counter()
    for name in which:
        runs[name]()
    print(f"rehearsed {', '.join(which)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
