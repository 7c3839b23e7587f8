"""Mixture-of-Experts blocks (Mixtral / Granite-MoE families), PyTorch port
of ``repro/models/moe.py``.

Two dispatch strategies, selectable per call, as in the reference:

* ``einsum``  — capacity-bucketed one-hot dispatch per token group (the
  reference's default).  The expert products are plain einsums, as they are
  plain XLA einsums in the reference.
* ``gather``  — capacity-indexed gather dispatch: tokens are gathered into
  ``(E, C, d)`` buckets and the expert FFN runs through the grouped
  expert-FFN kernel (``repro_torch.kernels.moe_gmm``): the CUDA kernel on a
  GPU tensor, its plain version on a CPU tensor.  Each bucket's fill goes
  with it, so that the kernel skips the pad rows (and an expert no token
  reached).  This is the serving path.

Every MoE model is gated whatever ``cfg.act`` says: the reference's
``_init_moe`` always makes ``w3`` and ``_expert_ffn`` always uses it.

The combine of the gather path is deterministic: the reference scatter-adds
each (token, k) contribution into its token's row; here each token's k
contributions are gathered as ``(T, k, d)`` and summed over k, the same sum
without atomics.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import act_fn, rms_norm

DISPATCHES = ("einsum", "gather")


def router_topk(x, wr, k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Token->expert routing. Returns (weights (T,k) f32, idx (T,k), aux)."""
    logits = x.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balancing auxiliary loss
    E = wr.shape[-1]
    me = probs.mean(0)
    ce = F.one_hot(idx, E).float().sum(1).mean(0)
    aux = E * torch.sum(me * ce)
    return w, idx, aux


def _group_size(T: int, k: int, cf: float) -> int:
    """Dispatch group size: keep the (g, E, C) tensors ~O(64M) elements."""
    g = 512
    while g * 2 <= T and (2 * g) * (2 * g) * k * cf <= 2 ** 26:
        g *= 2
    return min(g, T)


def _capacity(tokens: int, n_experts: int, top_k: int, cf: float) -> int:
    c = int(tokens * top_k * cf / n_experts)
    return max(8, (c + 7) // 8 * 8)


def _expert_ffn(xe, p, act: str):
    """xe: (E, C, d) -> (E, C, d) through per-expert gated MLP (plain)."""
    w1, w2, w3 = (p["w1"].to(xe.dtype), p["w2"].to(xe.dtype),
                  p["w3"].to(xe.dtype))
    h = act_fn(act)(torch.einsum("ecd,edf->ecf", xe, w1))
    h = h * torch.einsum("ecd,edf->ecf", xe, w3)
    return torch.einsum("ecf,efd->ecd", h, w2)


def _slots(flat_e, E: int):
    """flat_e: (..., T*k) experts of the (token, k) pairs, token-major.
    Returns each pair's slot in its expert's bucket: its rank among the
    pairs routed to that expert, in that order."""
    return _slots_and_counts(flat_e, E)[0]


def _slots_and_counts(flat_e, E: int):
    """``_slots`` and the number of pairs routed to each expert, (..., E)
    int64, both without a host sync.

    The reference takes a cumsum of the (T*k, E) one-hot down the pairs; a
    stable sort by expert gives the same ranks (pairs of one expert keep
    their order), without a scan along T*k that the GPU runs one column
    per thread."""
    n = flat_e.shape[-1]
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = torch.zeros(flat_e.shape[:-1] + (E,), dtype=torch.long,
                         device=flat_e.device)
    counts.scatter_add_(-1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, -1) - counts       # first sorted index
    rank = torch.arange(n, device=flat_e.device) - \
        torch.gather(starts, -1, sorted_e)
    return torch.empty_like(flat_e).scatter_(-1, order, rank), counts


# ---------------------------------------------------------------------------
# einsum (one-hot) dispatch
# ---------------------------------------------------------------------------

def moe_einsum(x, p, cfg):
    """x: (T, d) flat tokens. Returns (T, d), aux_loss."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    g = _group_size(T, k, cfg.capacity_factor)
    G = T // g
    w, idx, aux = router_topk(x, p["router"], k)
    C = _capacity(g, E, k, cfg.capacity_factor)
    if T % g:
        # where the reference's reshape of (T, d) into (T // g, g, d) fails
        raise ValueError(f"moe_einsum: {T} tokens do not split into groups "
                         f"of {g}; use moe_dispatch='gather'")

    xg = x.reshape(G, g, d)
    # slot of each (token, k) inside its expert's capacity bucket, per
    # group; a pair past capacity goes to the sink column E*C
    slot = _slots(idx.reshape(G, g * k), E)
    flat = idx.reshape(G, g * k) * C + slot
    flat = torch.where(slot < C, flat, E * C).reshape(G, g, k)
    # the k experts of a token differ, so no two kept pairs of one token
    # share a column: each sum below has at most one nonzero term
    sel = torch.zeros((G, g, E * C + 1), dtype=torch.float32, device=x.device)
    dispatch = sel.scatter(2, flat, 1.0)[..., :E * C].reshape(G, g, E, C)
    combine = sel.scatter(2, flat, w.reshape(G, g, k))[..., :E * C] \
        .reshape(G, g, E, C)

    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    ye = _apply_experts_grouped(xe, p, cfg)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    return y.reshape(T, d), aux


def _apply_experts_grouped(xe, p, cfg):
    """xe: (G, E, C, d) -> (G, E, C, d)."""
    G, E, C, d = xe.shape
    out = _expert_ffn(
        xe.permute(1, 0, 2, 3).reshape(E, G * C, d), p, cfg.act)
    return out.reshape(E, G, C, d).permute(1, 0, 2, 3)


# ---------------------------------------------------------------------------
# gather dispatch — the serving path, through the grouped expert-FFN kernel
# ---------------------------------------------------------------------------

def moe_gather(x, p, cfg):
    """Capacity-indexed gather dispatch: active FLOPs only.

    Returns ((T, d), aux_loss).  Pairs whose slot is past the capacity C
    are dropped, as in the reference: they add nothing to their token."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    w, idx, aux = router_topk(x, p["router"], k)
    C = _capacity(T, E, k, cfg.capacity_factor)

    flat_e = idx.reshape(-1)                                 # (T*k,)
    slot, routed = _slots_and_counts(flat_e, E)
    keep = slot < C
    tok_id = torch.arange(T, device=x.device).repeat_interleave(k)
    # token ids into (E, C) buckets, T (the zero pad row) where empty;
    # dropped pairs write to a sink entry past the buckets
    bucket = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    bucket[torch.where(keep, flat_e * C + slot, E * C)] = tok_id
    xpad = torch.cat([x, x.new_zeros((1, d))])
    xe = xpad[bucket[:E * C].reshape(E, C)]                  # (E, C, d)
    # slots are ranks, so each bucket's filled slots are its first
    # min(routed, C): the kernel skips the pad rows after them
    fill = torch.clamp(routed, max=C).to(torch.int32)
    ye = gmm_ops.expert_ffn(xe, p, cfg.act, fill)
    # combine: each token owns k consecutive pairs; sum them, no atomics
    wk = torch.where(keep, w.reshape(-1).to(x.dtype), 0.0)
    src = ye[flat_e, slot.clamp(0, C - 1)] * wk[:, None]
    return src.reshape(T, k, d).sum(1), aux


def moe_block(x, p, cfg, *, dispatch: str = "einsum"):
    """Pre-norm MoE residual block. x: (B, S, d). Returns (x, aux_loss)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch {dispatch!r}; known: {DISPATCHES}")
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, d)
    if dispatch == "gather":
        y, aux = moe_gather(h, p, cfg)
    else:
        y, aux = moe_einsum(h, p, cfg)
    return x + y.reshape(B, S, d), aux
