"""Plain PyTorch version of the grouped expert-FFN kernel."""
from __future__ import annotations

import torch

from repro_torch.models.layers import act_fn


def reference_expert_ffn(xe, p, act: str = "swiglu"):
    """xe: (E, C, d) -> (E, C, d); einsums in ``xe.dtype``, ``w3`` optional."""
    w1 = p["w1"].to(xe.dtype)
    w2 = p["w2"].to(xe.dtype)
    h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, w1))
    if p.get("w3") is not None:
        h = h * torch.einsum("ecd,edf->ecf", xe, p["w3"].to(xe.dtype))
    return torch.einsum("ecf,efd->ecd", h, w2)
