"""xLSTM helpers (PyTorch port of ``repro/models/xlstm.py``).

For now only the causal depthwise conv shared with the Griffin block
(``repro_torch.models.rglru``); the mLSTM and sLSTM blocks come with the
xLSTM slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CONV_K = 4            # causal depthwise conv width


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); b: (C,).

    K unrolled taps over a left-padded copy of ``x``, in ``x.dtype``, as the
    reference computes it (not ``F.conv1d``, which goes to cuDNN and, in
    float32, to TF32 by default)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    w = w.to(x.dtype)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b.to(x.dtype)


def conv1d_decode(x_t, conv_buf, w, b):
    """One-step causal conv against a (B, K-1, C) lag buffer.

    Returns (out: (B, C), the new lag buffer: (B, K-1, C))."""
    xs = torch.cat([conv_buf, x_t[:, None, :]], dim=1)        # (B, K, C)
    out = torch.einsum("bkc,kc->bc", xs, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, xs[:, 1:, :]
