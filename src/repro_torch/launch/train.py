"""End-to-end training entry point (PyTorch port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b-smoke \
        --device cpu --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

Wires the synthetic data pipeline (prefetching loader), the model zoo with
float32 master weights, AdamW (+WSD for minicpm), step-atomic checkpoints
in the JAX package's layout with auto-resume from the latest one, and
per-step metrics.  It runs on the GPU unless ``--device`` says otherwise,
and raises without a GPU and without ``--device``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_arch, get_schedule
from repro_torch.data import PrefetchLoader, make_batch_iter
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import AdamWConfig, adamw_init


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b",
                    choices=ARCH_IDS + [a + "-smoke" for a in ARCH_IDS])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced (~100M-or-less) config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--stop-at", type=int, default=None,
                    help="end the run after this step, with a checkpoint "
                         "there, as a run cut short would; the schedule "
                         "still spans --steps, so a run that resumes from "
                         "it goes on as one straight run")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke and not args.arch.endswith("-smoke"):
        cfg = cfg.reduced()
    shape = ShapeSpec("cli", args.seq, args.batch, "train")
    sched = get_schedule(args.arch.removesuffix("-smoke"))
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=args.warmup,
                       total_steps=args.steps, schedule=sched)

    print(f"[train] arch={cfg.name} params={R.count_params_analytic(cfg):,} "
          f"schedule={sched} device={device}")

    params = R.init_params(cfg, args.seed, device=device,
                           param_dtype=torch.float32)
    opt = adamw_init(params)
    step0 = 0
    mgr = CheckpointManager(args.ckpt_dir, cfg) if args.ckpt_dir else None
    if mgr is not None:
        got = mgr.restore_latest({"params": params, "opt": opt})
        if got is not None:
            step0, trees, _ = got
            params, opt = trees["params"], trees["opt"]
            print(f"[train] auto-resumed from step {step0}")

    train_step = make_train_step(cfg, ocfg, accum_steps=args.accum,
                                 device=device)
    loader = PrefetchLoader(make_batch_iter(cfg, shape, seed=args.seed,
                                            start_step=step0), depth=2)
    history = []
    t_last = time.time()
    end = args.steps if args.stop_at is None else min(args.stop_at,
                                                       args.steps)
    try:
        for step in range(step0, end):
            params, opt, metrics = train_step(params, opt, next(loader))
            if (step + 1) % args.log_every == 0 or step == step0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                t_last = time.time()
                tok_s = shape.tokens * args.log_every / max(dt, 1e-9)
                print(f"[train] step {step+1:5d} loss={m['loss']:.4f} "
                      f"nll={m['nll']:.4f} acc={m['acc']:.3f} "
                      f"gnorm={m['grad_norm']:.2f} lr={m['lr']:.2e} "
                      f"tok/s={tok_s:,.0f}")
                history.append({"step": step + 1, **m})
            if mgr is not None and (step + 1) % args.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt},
                         meta={"arch": cfg.name, "seed": args.seed})
    finally:
        loader.close()
    if mgr is not None:
        mgr.save(end, {"params": params, "opt": opt},
                 meta={"arch": cfg.name, "seed": args.seed})
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f, indent=1)
    if len(history) >= 2:
        improved = history[-1]["nll"] < history[0]["nll"]
        print(f"[train] loss {history[0]['nll']:.4f} -> "
              f"{history[-1]['nll']:.4f} "
              f"({'improved' if improved else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
