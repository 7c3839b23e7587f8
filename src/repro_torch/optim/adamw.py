"""AdamW with global-norm clipping and WSD / cosine LR schedules (PyTorch
port of the JAX package's ``adamw.py``, with the same arithmetic in
float32).

The state mirrors the parameters' tree: float32 moments ``m`` and ``v``
and an int32 ``step``.  Unlike the reference, which returns fresh arrays,
``adamw_update`` updates the parameters and the moments in place (the
reference's train step donates them): at full width each is a copy of the
model in float32, and in place no second copy is held.

On a device mesh the parameters are DTensors; their moments are DTensors
placed like them (the reference's ``AdamWState(step=P(), m=pshard,
v=pshard)``), each rank updates its own pieces, and the clipping norm is
the whole tree's, the same on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"         # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1          # WSD: final fraction spent decaying


class AdamWState(NamedTuple):
    step: torch.Tensor               # int32 scalar
    m: Any                           # tree like params, float32
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 and step 0, on the parameters' device; a
    DTensor parameter's moments are DTensors with its placements."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """The norm of all the tree's leaves, as one plain 0-dim tensor.  A
    DTensor leaf's sum of squares is partial over the mesh dims that shard
    it: the leaves of one placement are reduced by one all-reduce, and
    the whole sums are added in the leaves' order."""
    from torch.distributed.tensor import DTensor
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    by_place: dict = {}
    for i, s in enumerate(sums):
        if is_dtensor(s):
            by_place.setdefault((s.device_mesh, tuple(s.placements)),
                                []).append(i)
    for (mesh, place), idx in by_place.items():
        whole = DTensor.from_local(
            torch.stack([sums[i].to_local() for i in idx]), mesh, place,
            run_check=False).full_tensor()
        for j, i in enumerate(idx):
            sums[i] = whole[j]
    return torch.sqrt(sum(sums))


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(cfg: AdamWConfig) -> Callable[[Any], torch.Tensor]:
    def fn(step):
        step = _f32(step)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return fn


def wsd_schedule(cfg: AdamWConfig) -> Callable[[Any], torch.Tensor]:
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup, long
    flat stage, short (decay_frac) exponential-ish cooldown to ~0.1x."""
    decay_start = int(cfg.total_steps * (1.0 - cfg.decay_frac))

    def fn(step):
        step = _f32(step)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp((step - decay_start) /
                           max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
        decay = torch.pow(torch.tensor(0.1, dtype=torch.float32,
                                       device=prog.device), prog)
        return cfg.lr * warm * decay
    return fn


def make_schedule(cfg: AdamWConfig):
    def const(c):
        return lambda s: torch.tensor(c.lr, dtype=torch.float32,
                                      device=torch.as_tensor(s).device)
    return {"cosine": cosine_schedule, "wsd": wsd_schedule,
            "const": const}[cfg.schedule](cfg)


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig,
                 schedule: Optional[Callable] = None, decay=None):
    """Returns (params, new_state, metrics {"grad_norm", "lr"}).

    Clips by the global norm first, then updates the moments, with
    decoupled weight decay and the update in float32, cast back to each
    parameter's dtype.  ``decay``, a tree of bools shaped like ``params``
    (``convert.decay_mask`` gives the reference's rule for a model's
    parameters), says which leaves are decayed; without it, matrices only
    (``ndim >= 2``).  ``params``, ``m`` and ``v`` are updated in place; the
    returned params and the new state's moments are those same tensors.

    DTensor leaves: a gradient is first brought to its parameter's
    placements, whose moments must have them too; each rank then updates
    its local pieces, and ``decay`` reads the global shapes."""
    schedule = schedule or make_schedule(cfg)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(step)
    b1t = 1.0 - torch.pow(torch.tensor(cfg.b1, device=gnorm.device),
                          _f32(step))
    b2t = 1.0 - torch.pow(torch.tensor(cfg.b2, device=gnorm.device),
                          _f32(step))

    def upd(p, g, m, v, decayed):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if decayed:                       # decoupled WD
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))

    leaves = tree_leaves(params)
    decays = ([p.dim() >= 2 for p in leaves] if decay is None
              else tree_leaves(decay))
    if len(decays) != len(leaves):
        raise ValueError(f"decay mask has {len(decays)} leaves, params "
                         f"{len(leaves)}")
    for p, g, m, v, d in zip(leaves, tree_leaves(grads),
                             tree_leaves(state.m), tree_leaves(state.v),
                             decays):
        if is_dtensor(p):
            place = tuple(p.placements)
            if tuple(g.placements) != place:
                g = g.redistribute(p.device_mesh, place)
            if tuple(m.placements) != place or tuple(v.placements) != place:
                raise ValueError(f"moments placed {tuple(m.placements)} and "
                                 f"{tuple(v.placements)}, their parameter "
                                 f"{place}")
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        upd(p, g, m, v, d)
    return params, AdamWState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
