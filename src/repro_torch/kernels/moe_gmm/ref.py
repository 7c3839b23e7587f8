"""Plain PyTorch version of the grouped expert-FFN kernel, and its
backward by formula."""
from __future__ import annotations

import torch

from repro_torch.models.layers import act_bwd_fn, act_fn


def live_rows(xe, counts):
    """(E, C) bool: the rows before each bucket's fill ``counts`` (E,)."""
    rows = torch.arange(xe.shape[1], device=xe.device)
    return rows[None, :] < counts.to(xe.device)[:, None]


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
    return torch.where(live_rows(xe, counts)[..., None], y,
                       torch.zeros((), dtype=y.dtype, device=y.device))


def reference_expert_ffn_bwd(xe, p, dy, act: str = "swiglu", counts=None):
    """(dxe, dw1, dw3, dw2): the gradients of ``reference_expert_ffn``'s y
    for the cotangent dy (E, C, d), with respect to xe and the weights cast
    to ``xe.dtype`` (dw3 None without w3).  Grouped products (``bmm``) in
    ``xe.dtype``, with a1 = xe w1 and a3 = xe w3 recomputed.

    Rows at or past ``counts`` are constants 0 in the forward, whatever xe
    holds there (NaN too): dy and xe are zeroed on them before any product,
    so dxe is 0 there and they add nothing to the weights' gradients."""
    w1, w2 = p["w1"].to(xe.dtype), p["w2"].to(xe.dtype)
    w3 = None if p.get("w3") is None else p["w3"].to(xe.dtype)
    dy = dy.to(xe.dtype)
    if counts is not None:
        live = live_rows(xe, counts)[..., None]
        zero = torch.zeros((), dtype=xe.dtype, device=xe.device)
        xe, dy = torch.where(live, xe, zero), torch.where(live, dy, zero)
    xt = xe.transpose(1, 2)
    a1 = torch.bmm(xe, w1)
    g1 = act_fn(act)(a1)
    dh = torch.bmm(dy, w2.transpose(1, 2))
    if w3 is None:
        h = g1
        da1 = act_bwd_fn(act)(dh, a1)
        dw3 = None
        dxe = torch.bmm(da1, w1.transpose(1, 2))
    else:
        a3 = torch.bmm(xe, w3)
        h = g1 * a3
        da1 = act_bwd_fn(act)(dh * a3, a1)
        da3 = dh * g1
        dw3 = torch.bmm(xt, da3)
        dxe = torch.baddbmm(torch.bmm(da1, w1.transpose(1, 2)), da3,
                            w3.transpose(1, 2))
    dw2 = torch.bmm(h.transpose(1, 2), dy)
    dw1 = torch.bmm(xt, da1)
    return dxe, dw1, dw3, dw2
