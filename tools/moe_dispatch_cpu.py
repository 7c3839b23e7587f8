#!/usr/bin/env python3
"""How far apart the MoE gather and einsum dispatches train in bf16, and
how far a lost expert gradient moves the loss, on the CPU.

    PYTHONPATH=src python3 tools/moe_dispatch_cpu.py

granite-moe-3b-a800m's routing (40 experts, top-8) and recipe
(``chip_smoke.py``'s train phases: float32 masters, bf16 compute, remat
"full", 2 microbatches, 4 AdamW steps at lr 3e-4 with one warmup step,
one batch repeated) at a width the CPU trains in seconds: 2 layers, d 256,
4 heads, expert d_ff 128, vocabulary 4096, 2 x 512 tokens, capacity
factor E / k (no pair drops).  Three runs from one init: gather, einsum,
and gather with the expert weights detached inside the expert FFN (their
gradient lost, as a fault in its backward would lose it).  Prints each
run's (loss, nll) a step and the relative loss differences, which
``chip_smoke.py``'s ``MOE_DISPATCH_RTOL`` is set between.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import batch_for  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402


def train(cfg, batch, dispatch):
    params = R.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1,
                                            total_steps=4),
                           moe_dispatch=dispatch, accum_steps=2,
                           device="cpu")
    curve = []
    for _ in range(4):
        params, opt, m = step(params, opt, batch)
        curve.append((float(m["loss"]), float(m["nll"])))
    return curve


def main() -> int:
    base = get_arch("granite-moe-3b-a800m")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=4096, remat="full",
        capacity_factor=base.n_experts / base.top_k)
    batch = {k: torch.as_tensor(v) for k, v in batch_for(
        cfg, ShapeSpec("train", 512, 2, "train"), seed=0).items()}
    curves = {d: train(cfg, batch, d) for d in ("gather", "einsum")}
    real = gmm_ops.expert_ffn
    gmm_ops.expert_ffn = lambda xe, p, act, counts=None: real(
        xe, {k: w.detach() for k, w in p.items()}, act, counts)
    try:
        curves["gather, expert gradients lost"] = train(cfg, batch,
                                                        "gather")
    finally:
        gmm_ops.expert_ffn = real
    einsum = curves["einsum"]
    for name, curve in curves.items():
        rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(curve, einsum)]
        pairs = [(round(a, 5), round(b, 5)) for a, b in curve]
        print(f"{name:30s} (loss, nll) {pairs}; loss rel diff to einsum "
              f"{[f'{r:.2e}' for r in rel]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
