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

On a ``DeviceMesh`` (``mesh=``) the parameters and moments are DTensors
placed by a ruleset (``distributed.sharding``): each microbatch is placed
by ``sharding.batch_specs`` and runs through ``forward_train`` on the
mesh, and each gradient is brought to its parameter's placements (the
data-parallel all-reduce or reduce-scatter) before AdamW.  The compressed
step on a mesh with a "pod" axis runs this inside each pod's ("data",
"model") submesh and only the all-reduce across pods in int8, as the
reference's partial-manual step does.
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


def _grad(p):
    """``p``'s float32 gradient (zeros if it has none); a DTensor's
    brought to ``p``'s placements (its partial sums over the batch
    reduced)."""
    g = p.grad if p.grad is not None else torch.zeros_like(p)
    if sharding.is_dtensor(g) and \
            tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.float()


def _gradients(params, cfg, batch, moe_dispatch, accum_steps, device,
               mesh=None):
    """The microbatches of ``batch`` (split along its first dim) through
    ``forward_train`` and its backward, in order; on ``mesh`` each
    microbatch is placed by ``place_batch`` (so a microbatch is the same
    rows as without a mesh).  Returns (the float32 gradients of
    ``params``' leaves, placed like them, and the loss, each summed over
    the microbatches and divided by ``accum_steps``, the last
    microbatch's metrics), metrics and loss plain tensors."""
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
        if mesh is not None:
            micro = place_batch(micro, mesh)
        li, metrics = R.forward_train(params, cfg, micro,
                                      moe_dispatch=moe_dispatch,
                                      device=device, mesh=mesh)
        # backward() sums each microbatch's gradient into p.grad in
        # place, one parameter at a time: no second copy of the grads
        with R.on_mesh(mesh):
            li.backward()
        loss = loss + sharding.whole(li.detach())
    grads = [_grad(p) for p in leaves]
    for p, g in zip(leaves, grads):
        p.grad = None
        if accum_steps > 1:
            g.div_(accum_steps)       # in place: float32 grads already
    metrics = {k: sharding.whole(v) for k, v in metrics.items()}
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
                    device=None, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accum_steps`` > 1 splits the batch along its first dim into that many
    microbatches, run in order, their float32 gradients summed and divided
    by ``accum_steps`` (as is the loss); ``nll``, ``aux`` and ``acc`` are
    the last microbatch's, as in the reference.  Metrics: loss, nll, aux,
    acc, grad_norm, lr, as 0-dim tensors.  The parameters and the moments
    are updated in place and returned.  Weight decay follows the
    reference's rule for the parameters' JAX layout (``decay_mask``).

    ``mesh``: a ``DeviceMesh`` ("data", "model") or ("pod", "data",
    "model") on which ``params`` lie as DTensors
    (``sharding.distribute_tree``) and the moments with them
    (``adamw_init``); ``batch`` is whole on every rank, and its
    microbatches are placed by ``sharding.batch_specs``.  The metrics are
    plain tensors, the same on every rank.  Every config: the text
    decoders, the vision model (a batch with "patches") and the audio
    encoder (a batch with "frames" and "mask")."""
    opt_cfg = opt_cfg or AdamWConfig()
    schedule = make_schedule(opt_cfg)

    def train_step(params, opt_state, batch):
        grads, loss, metrics = _gradients(params, cfg, batch, moe_dispatch,
                                          accum_steps, device, mesh)
        return _apply(params, opt_state, grads, loss, metrics, cfg, opt_cfg,
                      schedule)

    return train_step


def init_ef_errors(params):
    """The error-feedback state of ``make_train_step_dp_compressed``: a
    float32 zero tree like ``params``, on their device (each rank keeps
    its own).  For params on a pod's submesh it is a tree of DTensors
    placed like them: each pod's ranks hold their pod's error, and the
    pods' errors together are the reference's ``init_ef_errors(params,
    n_pods)``, whose leading pod dim is sharded over "pod"."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def make_train_step_dp_compressed(cfg: ArchConfig,
                                  opt_cfg: Optional[AdamWConfig] = None, *,
                                  group=None, mesh=None,
                                  moe_dispatch: str = "einsum",
                                  accum_steps: int = 1, device=None):
    """Data-parallel train step with the int8 error-feedback all-reduce:
    (params, opt_state, errors, batch) -> (params, opt_state, errors,
    metrics), on each rank of ``group`` (None: the default group).

    ``mesh``: instead of ``group``, a ("pod", "data", "model") mesh
    (``launch.mesh.make_production_mesh(dp, tp, multi_pod=True)``).  Each
    pod's ranks form its ``mesh["data", "model"]`` submesh, on which the
    params, moments and errors lie (placed by a ruleset's specs on that
    submesh); a pod takes its share of the batch through
    ``make_train_step``'s sharded path on its submesh, and the int8
    all-reduce runs over the "pod" dim's group on each rank's local
    pieces, each leaf quantised with its whole max.

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
    pod_mesh = None
    if mesh is not None:
        if group is not None:
            raise ValueError("pass a group or a mesh, not both")
        if mesh.mesh_dim_names != ("pod", "data", "model"):
            raise ValueError(f"the compressed step's mesh has axes "
                             f"{mesh.mesh_dim_names}, not (pod, data, "
                             f"model): the int8 all-reduce runs over "
                             f"\"pod\"")
        group, pod_mesh = mesh.get_group("pod"), mesh["data", "model"]

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
                                          accum_steps, device, pod_mesh)
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
    return {k: sharding.distribute_batch(v, mesh) for k, v in batch.items()}


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
