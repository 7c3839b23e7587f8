"""Plain PyTorch version of the flash-attention kernel."""
from __future__ import annotations

from repro_torch.models.layers import attention


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Same contract as ops.flash_attention; exact softmax."""
    return attention(q, k, v, causal=causal, window=window)
