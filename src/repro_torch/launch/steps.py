"""Step functions (PyTorch port of ``repro/launch/steps.py``): training,
evaluation, prefill and serving.

The train step differentiates ``forward_train`` with autograd (through the
flash-attention kernel's own backward on the GPU) and applies AdamW.  The
parameters are float32 master weights (``init_params(...,
param_dtype=torch.float32)``), updated in place with the optimizer's
moments.  The multi-pod step with compressed gradients
(``make_train_step_dp_compressed``) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.convert import decay_mask
from repro_torch.models import registry as R
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_update, make_schedule
from repro_torch.tree import tree_leaves


def make_train_step(cfg: ArchConfig, opt_cfg: Optional[AdamWConfig] = None,
                    *, moe_dispatch: str = "einsum", accum_steps: int = 1,
                    device=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum_steps`` > 1 splits the batch along its first dim into that many
    microbatches, run in order, their float32 gradients summed and divided
    by ``accum_steps`` (as is the loss); ``nll``, ``aux`` and ``acc`` are
    the last microbatch's, as in the reference.  Metrics: loss, nll, aux,
    acc, grad_norm, lr, as 0-dim tensors.  The parameters and the moments
    are updated in place and returned.  Weight decay follows the
    reference's rule for the parameters' JAX layout (``decay_mask``)."""
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = make_schedule(opt_cfg)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        n = len(next(iter(batch.values())))
        if n % accum_steps:
            raise ValueError(f"a batch of {n} does not split into "
                             f"{accum_steps} microbatches")
        mb = n // accum_steps
        loss = 0.0
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            li, metrics = R.forward_train(params, cfg, micro,
                                          moe_dispatch=moe_dispatch,
                                          device=device)
            # backward() sums each microbatch's gradient into p.grad in
            # place, one parameter at a time: no second copy of the grads
            li.backward()
            loss = loss + li.detach()
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                 .float() for p in leaves]
        for p, g in zip(leaves, grads):
            p.grad = None
            if accum_steps > 1:
                g.div_(accum_steps)       # in place: float32 grads already
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg, schedule,
                                             decay_mask(cfg, params))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = loss / accum_steps
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                   device=None):
    """(params, batch) -> {"loss", "nll", "aux", "acc"}, without gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = R.forward_train(params, cfg, batch,
                                            moe_dispatch=moe_dispatch,
                                            device=device)
        return {"loss": loss, **metrics}
    return eval_step


def make_prefill_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                      cache_len: Optional[int] = None, device=None):
    """(params, batch) -> (last_logits, cache)."""
    def prefill_step(params, batch):
        return R.prefill(params, cfg, batch, cache_len=cache_len,
                         moe_dispatch=moe_dispatch, device=device)
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                    device=None):
    """One decode step: (params, tokens, pos, cache) ->
    (next_tokens, logits, cache), greedy (argmax) as in the reference."""
    def serve_step(params, tokens, pos, cache):
        logits, cache = R.decode_step(params, cfg, tokens, pos, cache,
                                      moe_dispatch=moe_dispatch,
                                      device=device)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return serve_step
