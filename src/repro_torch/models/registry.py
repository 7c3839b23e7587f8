"""Model-zoo registry: the public model API surface and parameter
accounting (PyTorch port of ``repro/models/registry.py``).

Counts come from the port's own initialiser on the ``meta`` device, so they
cannot drift from it and allocate nothing even for full-size configs.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

# Re-exported model API (single entry point for the rest of the port).
init_params = tf.init_params
forward_train = tf.forward_train
forward_logits = tf.forward_logits
prefill = tf.prefill
decode_step = tf.decode_step
init_cache = tf.init_cache
logical_axes = tf.logical_axes
on_mesh = tf.on_mesh


def params_and_axes(cfg: ArchConfig):
    """(params on ``meta``, their logical axes): the shapes and the
    sharding names of a full-size model, without allocation."""
    return tf.init_params(cfg, device="meta"), tf.logical_axes(cfg)


def _numel(tree, cfg: ArchConfig, active_only: bool,
           path: Tuple[str, ...] = (), skip_lookup: bool = False) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v, cfg, active_only, path + (k,), skip_lookup)
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v, cfg, active_only, path, skip_lookup)
                   for v in tree)
    if skip_lookup and path[0] == "embed" and not cfg.tie_embeddings:
        return 0                            # a pure lookup, no matmul
    n = tree.numel()
    if active_only and cfg.is_moe and "ffn" in path and \
            path[-1] in ("w1", "w2", "w3"):
        n = n * cfg.top_k // cfg.n_experts      # the per-token active share
    return n


def count_params_analytic(cfg: ArchConfig, active_only: bool = False) -> int:
    """Exact parameter count, from init shapes on the meta device.

    ``active_only`` scales MoE expert tensors by top_k / E (the share of
    them each token runs through)."""
    return _numel(tf.init_params(cfg, device="meta"), cfg, active_only)


def count_flops_params(cfg: ArchConfig, active_only: bool = True) -> int:
    """N for the 6 N D model-FLOPs estimate: the parameters that take part
    in a matrix product per token.  The untied embedding's lookup does no
    FLOPs and is left out; a tied head reuses the table, which then counts
    once.  ``active_only`` scales expert tensors by top_k / E."""
    return _numel(tf.init_params(cfg, device="meta"), cfg, active_only,
                  skip_lookup=True)


def model_flops(cfg: ArchConfig, tokens: int, *, train: bool = True) -> float:
    """MODEL_FLOPS = 6 N D for a training step (forward and backward), 2 N D
    for inference (forward)."""
    return (6.0 if train else 2.0) * count_flops_params(cfg) * tokens


def param_bytes(cfg: ArchConfig, dtype_bytes: int = 4) -> int:
    return count_params_analytic(cfg) * dtype_bytes
