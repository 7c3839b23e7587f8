"""The work of one flash-attention call, forward and backward: (FLOPs,
bytes) from its shapes.  Frozen copy of the port's
``src/repro_torch/kernels/flash_attention/cost.py`` (``visible_pairs``,
``work``, ``bwd_work``) with the element size passed as bytes: the counts
cover the (query, key) pairs the mask leaves, which is what the inputs
need, whatever the kernel computes."""
from __future__ import annotations

import numpy as np


def visible_pairs(S: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs the mask leaves over one head's S x S."""
    qpos = np.arange(S)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(S, int)
    hi = qpos + 1 if causal else np.full(S, S)
    return int(np.sum(hi - lo))


def work(B, S, H, KH, Dh, causal, window=0, elem=2):
    """(flops, bytes) of one attention: 4*Dh FLOPs per visible (query, key)
    pair (the score and the weighted sum of V); q, k, v read once and o
    written once, ``elem`` bytes an element."""
    flops = 4.0 * B * H * Dh * visible_pairs(S, causal, window)
    nbytes = elem * (2 * B * S * H * Dh + 2 * B * S * KH * Dh)
    return flops, nbytes


def bwd_work(B, S, H, KH, Dh, causal, window=0, elem=2):
    """(flops, bytes) of one attention backward: five products of 2*Dh per
    visible (query, key) pair (q k^T, P^T dO, dO V^T, dS^T Q, dS K); q, k,
    v, o, dO and the float32 row log-sum-exp read once, dq, dk, dv written
    once."""
    flops = 10.0 * B * H * Dh * visible_pairs(S, causal, window)
    nbytes = elem * (4 * B * S * H * Dh + 4 * B * S * KH * Dh) + 4 * B * H * S
    return flops, nbytes
