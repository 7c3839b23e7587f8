"""Plain PyTorch versions of the chunkwise-mLSTM kernel: the chunkwise
evaluation of ``models.xlstm`` at the kernel's contract, and the strictly
sequential recurrence (ground truth for both)."""
from __future__ import annotations

import torch

from repro_torch.models import xlstm as _xlstm


def reference_mlstm(q, k, v, ig, fg, *, chunk: int = 64, init_state=None):
    """q, k, v: (B, S, H, Dh); ig, fg: (B, S, H) pre-activations.

    Returns (h (B, S, H, Dh) float32, (C (B, H, Dh, Dh), n (B, H, Dh),
    m (B, H)) float32), at the reference's chunk (halved until it divides
    S)."""
    return _xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk=chunk,
                                  init_state=init_state)


def sequential_oracle(q, k, v, ig, fg, init_state=None, dtype=torch.float32):
    """The recurrence step by step, in ``dtype``."""
    return _xlstm.mlstm_sequential(q, k, v, ig, fg, init_state=init_state,
                                   dtype=dtype)
