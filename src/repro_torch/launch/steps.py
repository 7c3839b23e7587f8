"""Step functions (PyTorch port of ``repro/launch/steps.py``): training,
evaluation, prefill and serving.

The train step differentiates ``forward_train`` with autograd (through the
flash-attention kernel's own backward on the GPU) and applies AdamW.  The
parameters are float32 master weights (``init_params(...,
param_dtype=torch.float32)``), updated in place with the optimizer's
moments.  The data-parallel step with compressed gradients
(``make_train_step_dp_compressed``) runs the same microbatches on each
rank's share of the batch and all-reduces their gradients over a
``torch.distributed`` group in int8 with error feedback
(``optim.compression``), where the reference reduces over its "pod" mesh
axis.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.convert import decay_mask
from repro_torch.distributed import sharding
from repro_torch.models import registry as R
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_update, make_schedule
from repro_torch.optim import compression
from repro_torch.tree import tree_leaves, tree_map


def _gradients(params, cfg, batch, moe_dispatch, accum_steps, device):
    """The microbatches of ``batch`` (split along its first dim) through
    ``forward_train`` and its backward, in order.  Returns (the float32
    gradients of ``params``' leaves and the loss, each summed over the
    microbatches and divided by ``accum_steps``, the last microbatch's
    metrics)."""
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
    return grads, loss / accum_steps, metrics


def _apply(params, opt_state, grads, loss, metrics, cfg, opt_cfg,
           schedule):
    """AdamW on ``grads`` (with the reference's decay mask) and the
    step's metrics."""
    params, opt_state, om = adamw_update(grads, opt_state, params, opt_cfg,
                                         schedule, decay_mask(cfg, params))
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics.update(om)
    metrics["loss"] = loss
    return params, opt_state, metrics


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
        grads, loss, metrics = _gradients(params, cfg, batch, moe_dispatch,
                                          accum_steps, device)
        return _apply(params, opt_state, grads, loss, metrics, cfg, opt_cfg,
                      schedule)

    return train_step


def init_ef_errors(params):
    """The error-feedback state of ``make_train_step_dp_compressed``: a
    float32 zero tree like ``params``, on their device (each rank keeps
    its own)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def make_train_step_dp_compressed(cfg: ArchConfig,
                                  opt_cfg: Optional[AdamWConfig] = None, *,
                                  group=None, moe_dispatch: str = "einsum",
                                  accum_steps: int = 1, device=None):
    """Data-parallel train step with the int8 error-feedback all-reduce:
    (params, opt_state, errors, batch) -> (params, opt_state, errors,
    metrics), on each rank of ``group`` (None: the default group).

    Each rank takes its share of the global ``batch`` (the rank-th of
    world-size equal slices of its first dim) through the same
    microbatches and autograd as ``make_train_step``; the gradients go
    through ``compression.all_reduce_int8_with_ef`` with the rank's
    ``errors`` (``init_ef_errors``; updated in place), then through the
    same AdamW and decay mask.  The loss is averaged over the group; nll,
    aux and acc are the rank's last microbatch's.  With one rank it is
    ``make_train_step`` with each gradient rounded to int8 steps of its
    own scale."""
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = make_schedule(opt_cfg)

    def train_step(params, opt_state, errors, batch):
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        n = len(next(iter(batch.values())))
        if n % world:
            raise ValueError(f"a batch of {n} does not split over {world} "
                             f"ranks")
        share = n // world
        mine = {k: v[rank * share:(rank + 1) * share]
                for k, v in batch.items()}
        grads, loss, metrics = _gradients(params, cfg, mine, moe_dispatch,
                                          accum_steps, device)
        grads, new = compression.all_reduce_int8_with_ef(grads, errors,
                                                         group)
        for e, e_new in zip(tree_leaves(errors), new):
            e.copy_(e_new)
        dist.all_reduce(loss, group=group)      # a fresh tensor: in place
        params, opt_state, metrics = _apply(params, opt_state, grads,
                                            loss / world, metrics, cfg,
                                            opt_cfg, schedule)
        return params, opt_state, errors, metrics

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


def place_batch(batch, mesh):
    """The batch's tensors as DTensors on ``mesh`` by ``batch_specs``
    (leading dim over the DP axes where it divides); DTensors pass as
    they are."""
    from torch.distributed.tensor import DTensor

    def place(t):
        if isinstance(t, DTensor):
            return t
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t, device=mesh.device_type)
        return sharding.distribute(t, mesh, sharding.batch_specs([t],
                                                                 mesh)[0])
    return {k: place(v) for k, v in batch.items()}


def make_prefill_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                      cache_len: Optional[int] = None, device=None,
                      mesh=None):
    """(params, batch) -> (last_logits, cache).  ``mesh``: a
    ``DeviceMesh`` on which ``params`` lie (``sharding.distribute_tree``);
    the batch is placed by ``sharding.batch_specs`` and the cache comes
    back placed by ``sharding.cache_specs``."""
    def prefill_step(params, batch):
        if mesh is not None:
            batch = place_batch(batch, mesh)
        return R.prefill(params, cfg, batch, cache_len=cache_len,
                         moe_dispatch=moe_dispatch, device=device,
                         mesh=mesh)
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                    device=None, mesh=None):
    """One decode step: (params, tokens, pos, cache) ->
    (next_tokens, logits, cache), greedy (argmax) as in the reference.
    ``mesh`` as ``make_prefill_step``'s: the tokens are placed by
    ``sharding.batch_specs``, the cache is the prefill step's, and the
    next tokens come back as a DTensor that the next step takes."""
    def serve_step(params, tokens, pos, cache):
        if mesh is not None:
            tokens = place_batch({"tokens": tokens}, mesh)["tokens"]
        logits, cache = R.decode_step(params, cfg, tokens, pos, cache,
                                      moe_dispatch=moe_dispatch,
                                      device=device, mesh=mesh)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return serve_step
