"""Model-zoo registry: the public model API surface and parameter
accounting (PyTorch port of ``repro/models/registry.py``).

Counts come from the port's own initialiser on the ``meta`` device, so they
cannot drift from it and allocate nothing even for full-size configs.
"""
from __future__ import annotations

from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

# Re-exported model API (single entry point for the rest of the port).
init_params = tf.init_params
forward_logits = tf.forward_logits
prefill = tf.prefill
decode_step = tf.decode_step
init_cache = tf.init_cache


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def count_params_analytic(cfg: ArchConfig) -> int:
    """Exact parameter count, from init shapes on the meta device."""
    return _numel(tf.init_params(cfg, device="meta"))
