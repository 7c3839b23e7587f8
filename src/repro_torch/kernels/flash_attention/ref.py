"""Plain PyTorch versions of the flash-attention kernels: the forward, the
row log-sum-exp its training launch writes, and the backward."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import attention


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Same contract as ops.flash_attention; exact softmax."""
    return attention(q, k, v, causal=causal, window=window)


def _scores(q, k, causal, window):
    """Scaled float32 scores (B, H, S, S), masked entries -inf."""
    B, S, H, Dh = q.shape
    G = H // k.shape[2]
    kk = k.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(Dh)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    return s.masked_fill(~mask, float("-inf"))


def reference_attention_lse(q, k, *, causal: bool = True, window: int = 0):
    """Each row's log-sum-exp of its scaled scores, (B, H, S) float32, as
    the kernel's forward writes it for the backward."""
    return torch.logsumexp(_scores(q, k, causal, window), dim=-1)


def reference_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0):
    """(dq, dk, dv) in float32 by the explicit formulas the kernel computes
    (not by autograd): P = exp(scale q k^T - lse), dV = P^T dO, dP = dO V^T,
    D = rowsum(dO o), dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q,
    dK and dV summed over each KV head's group of query heads."""
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    p = torch.exp(_scores(q, k, causal, window) - lse.float()[..., None])
    do32, o32 = do.float(), o.float()
    vv = v.float().repeat_interleave(G, dim=2)
    kk = k.float().repeat_interleave(G, dim=2)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, vv)
    dsum = (do32 * o32).sum(-1).transpose(1, 2)           # (B, H, S)
    ds = p * (dp - dsum[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kk)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    fold = (B, S, KH, G, Dh)
    return dq, dk.reshape(fold).sum(3), dv.reshape(fold).sum(3)
