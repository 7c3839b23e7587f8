"""Batched serving driver: continuous prefill+decode over a request queue
(PyTorch port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm-2b \
        --requests 8 --prompt-len 64 --gen 32            # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch minicpm-2b-smoke --device cpu              # reduced, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --moe-dispatch gather  # MoE, on the GPU

Static-batch synchronous decode (all slots advance one position per step).
Text models only: an encoder-only model has no decode step, and a vision
model's prefill needs image patches, which a request here does not carry
(as in the reference's loop); both are refused with the reason.  A vision
model serves through ``make_prefill_step`` and ``make_serve_step``, with
the patches in the prefill batch.
Requests are packed into fixed slots; finished slots are refilled from the
queue (continuous batching at slot granularity).  Step for step the same
loop as the reference: left-padded prompts, one shared position counter,
a new batch admitted only when every slot is empty.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import registry as R


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_done: Optional[float] = None


def check_servable(cfg) -> None:
    """Raise ValueError for a model this loop cannot serve."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    if cfg.modality == "vision":
        raise ValueError(
            f"{cfg.name} is a vision model: its prefill needs image patches, "
            f"which these requests do not carry; serve it through "
            f"make_prefill_step / make_serve_step with a \"patches\" batch")


def serve(cfg, requests: List[Request], *, slots: int = 4,
          ctx_len: int = 512, seed: int = 0, params=None,
          moe_dispatch: str = "einsum", device=None):
    """Serve ``requests`` greedily; returns them in completion order.

    ``params`` defaults to ``init_params(cfg, seed)`` on ``device``; a test
    hands in weights converted from the JAX package instead.
    ``moe_dispatch`` goes to both steps: "gather" runs MoE layers through
    the grouped expert-FFN kernel, "einsum" (the reference's default)
    through one-hot dispatch.  Raises ValueError for an encoder-only or a
    vision model (``check_servable``).
    """
    check_servable(cfg)
    device = resolve_device(device)
    with torch.inference_mode():
        if params is None:
            params = R.init_params(cfg, seed, device=device)
        prefill = make_prefill_step(cfg, cache_len=ctx_len,
                                    moe_dispatch=moe_dispatch, device=device)
        decode = make_serve_step(cfg, moe_dispatch=moe_dispatch,
                                 device=device)

        queue = list(requests)
        active: List[Optional[Request]] = [None] * slots
        done: List[Request] = []

        while queue or any(active):
            # admit a fresh batch into empty slots (batched prefill)
            if all(a is None for a in active) and queue:
                batch = [queue.pop(0) for _ in range(min(slots, len(queue)))]
                plen = max(len(r.prompt) for r in batch)
                toks = np.zeros((len(batch), plen), np.int32)
                for i, r in enumerate(batch):
                    toks[i, -len(r.prompt):] = r.prompt      # left-pad
                logits, cache = prefill(params, {"tokens": toks})
                nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
                pos = plen
                first = nxt[:, 0].tolist()
                for i, r in enumerate(batch):
                    r.generated.append(first[i])
                    active[i] = r
                # decode until every slot hits its budget
                while any(a is not None for a in active):
                    nxt, logits, cache = decode(params, nxt, pos, cache)
                    pos += 1
                    new = None
                    for i, r in enumerate(active):
                        if r is None:
                            continue
                        if len(r.generated) >= r.max_new:
                            r.t_done = time.time()
                            done.append(r)
                            active[i] = None
                        else:
                            if new is None:     # one device->host copy
                                new = nxt[:, 0].tolist()
                            r.generated.append(new[i])
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b",
                    choices=ARCH_IDS + [a + "-smoke" for a in ARCH_IDS])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moe-dispatch", default="einsum",
                    choices=["einsum", "gather"],
                    help="MoE dispatch; gather runs the moe_gmm kernel")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without a GPU)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke and not args.arch.endswith("-smoke"):
        cfg = cfg.reduced()
    try:
        check_servable(cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    reqs = [Request(i, rng.integers(1, cfg.vocab_size,
                                    size=args.prompt_len).astype(np.int32),
                    args.gen, t_submit=t0)
            for i in range(args.requests)]
    done = serve(cfg, reqs, slots=args.slots,
                 ctx_len=args.prompt_len + args.gen, seed=args.seed,
                 moe_dispatch=args.moe_dispatch, device=device)
    wall = time.time() - t0
    n_tok = sum(len(r.generated) for r in done)
    print(f"[serve] arch={cfg.name} device={device} requests={len(done)} "
          f"new_tokens={n_tok} wall={wall:.2f}s "
          f"tok/s={n_tok / max(wall, 1e-9):.1f}")
    for r in done[:3]:
        print(f"  req{r.rid}: {r.generated[:10]}...")
    return done


if __name__ == "__main__":
    main()
