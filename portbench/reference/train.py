"""The plain reference of a training step: the microbatches' mean loss,
its gradient by autograd, clipping by the global norm, and AdamW with the
WSD schedule (MiniCPM, arXiv:2404.06395: linear warm-up, a flat stage, a
decay towards a tenth), all in float32 (or the control's float8 products,
``model.mm``).

Weight decay is decoupled and applies to every leaf of a layer and to
every matrix outside them (the embedding, the head), not to the final
norm's scale: the port's rule for a uniform stack of layers, whose JAX
layout stacks each layer leaf along a leading axis.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from . import model


def lr_at(step: int, opt: dict) -> float:
    """The WSD schedule's learning rate at step 1, 2, ..."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    decay_start = int(opt["total_steps"] * (1.0 - opt["decay_frac"]))
    prog = min(max((step - decay_start) /
                   max(opt["total_steps"] - decay_start, 1), 0.0), 1.0)
    return opt["lr"] * warm * 0.1 ** prog


def decayed(path: str, t: torch.Tensor) -> bool:
    return path.startswith("layers.") or t.dim() >= 2


def run(W: Dict[str, torch.Tensor], s,
        batches: List[List[Tuple[torch.Tensor, torch.Tensor]]], opt: dict,
        prec: str, model=model):
    """AdamW steps from weights W (float32, updated in place), one step a
    list of (tokens, labels) microbatches; ``model`` is the reference
    module whose ``train_loss`` the steps take, ``s`` its ``Spec``.
    Returns (each step's loss, {leaf: the norm of step 1's clipped
    gradient}).  W holds the weights after the last step."""
    if opt["schedule"] != "wsd":
        raise ValueError(f"reference: schedule {opt['schedule']!r}")
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    losses, g1 = [], {}
    for step, micro in enumerate(batches, start=1):
        for t in W.values():
            t.requires_grad_(True)
            t.grad = None
        loss = 0.0
        for tokens, labels in micro:
            li = model.train_loss(W, s, tokens, labels, prec) / len(micro)
            li.backward()
            loss += float(li.detach())
        losses.append(loss)
        with torch.no_grad():
            grads = {k: t.grad for k, t in W.items()}
            for t in W.values():
                t.grad = None
                t.requires_grad_(False)
            gnorm = math.sqrt(sum(float(g.double().square().sum())
                                  for g in grads.values()))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
            lr = lr_at(step, opt)
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for k, p in W.items():
                g = grads[k] * scale
                if step == 1:
                    g1[k] = float(g.double().norm())
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                delta = (m[k] / c1) / (torch.sqrt(v2[k] / c2) + eps)
                if decayed(k, p):
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
            del grads
    return losses, g1


def change_norms(W: Dict[str, torch.Tensor],
                 initial: Callable) -> Dict[str, float]:
    """{leaf: || W[leaf] - its initial value ||}, the initial values from
    ``initial()``, an iterator of (leaf, float32 tensor) made anew."""
    return {k: float((W[k] - t).double().norm()) for k, t in initial()}
