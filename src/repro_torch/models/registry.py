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


def _numel(tree, cfg: ArchConfig, active_only: bool,
           path: Tuple[str, ...] = ()) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v, cfg, active_only, path + (k,))
                   for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v, cfg, active_only, path) for v in tree)
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
