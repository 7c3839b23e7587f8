"""Plain PyTorch version of the RG-LRU scan kernel.

Same contract as ``repro.models.rglru.rglru``: the gates are fused in
float32, then the diagonal recurrence ``h_t = a_t * h_{t-1} + b_t`` runs
over time.  PyTorch has no associative scan, so the recurrence is a loop
over ``t``, which repeats the kernel's arithmetic step for step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RGLRU_C = 8.0  # the paper's fixed temperature


def rglru_gates(x, lam, ga, gx):
    """(a, b) of the recurrence, float32: ``log_a = -c softplus(lam)
    sigmoid(ga)``, ``a = exp(log_a)``, ``b = sqrt(1 - a^2) sigmoid(gx) x``
    (``1 - a^2`` as ``-expm1(2 log_a)``, stable near a = 1)."""
    log_a = -RGLRU_C * F.softplus(lam.float()) * torch.sigmoid(ga.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, beta * (torch.sigmoid(gx.float()) * x.float())


def reference_rglru(x, lam, ga, gx, h0=None):
    """x, ga, gx: (B, S, D); lam: (D,); h0: (B, D) or None (zeros).

    Returns (y: (B, S, D) float32, h_last: (B, D) float32)."""
    a, b = rglru_gates(x, lam, ga, gx)
    B, S, D = b.shape
    h = b.new_zeros((B, D)) if h0 is None else h0.float()
    y = torch.empty_like(b)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, y[:, -1].clone()
