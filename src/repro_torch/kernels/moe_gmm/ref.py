"""Plain PyTorch version of the grouped expert-FFN kernel."""
from __future__ import annotations

import torch

from repro_torch.models.layers import act_fn


def reference_expert_ffn(xe, p, act: str = "swiglu", counts=None):
    """xe: (E, C, d) -> (E, C, d); einsums in ``xe.dtype``, ``w3`` optional;
    rows at or past ``counts`` ((E,), or None: all live) are 0."""
    w1 = p["w1"].to(xe.dtype)
    w2 = p["w2"].to(xe.dtype)
    h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, w1))
    if p.get("w3") is not None:
        h = h * torch.einsum("ecd,edf->ecf", xe, p["w3"].to(xe.dtype))
    y = torch.einsum("ecf,efd->ecd", h, w2)
    if counts is None:
        return y
    rows = torch.arange(xe.shape[1], device=xe.device)
    live = rows[None, :] < counts.to(xe.device)[:, None]
    return torch.where(live[..., None], y, torch.zeros((), dtype=y.dtype,
                                                       device=y.device))
