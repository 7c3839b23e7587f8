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
  reached).  This is the serving path; it trains too, through the
  kernel's autograd function (``gmm_ops.ExpertFFNFunction``).

Every MoE model is gated whatever ``cfg.act`` says: the reference's
``_init_moe`` always makes ``w3`` and ``_expert_ffn`` always uses it.

On a device mesh (``moe_block(..., mesh=)``) the tokens stay
data-parallel, as in the reference, and no token moves between ranks: each
rank runs the block on its own batch rows, with the router and the expert
weights gathered over the data axes and the experts (the ``ep`` ruleset) or
each expert's d_ff (``base``) split over "model", so its output is a
partial sum over "model" that the residual stream's hint reduces.
Capacity and slots are the reference's global ones: a pair's slot counts
the pairs of its expert on the lower data ranks too (``_moe_on_mesh``).

The combine of the gather path is deterministic: the reference scatter-adds
each (token, k) contribution into its token's row; here each token's k
contributions are gathered as ``(T, k, d)`` and summed over k, the same sum
without atomics.  Both gathers of the path (tokens into buckets, bucket rows
back to pairs) gather in their backward too (``_Rows``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.distributed.sharding import (batch_specs, data_axes,
                                              is_dtensor, placements)
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models.layers import (act_fn, gathered, rms_norm,
                                       sum_over_ranks)

DISPATCHES = ("einsum", "gather")


def moe_ffn_axes():
    """Logical axes of a MoE layer's leaves (the reference's router and
    ``init_moe_ffn_axes``: the (E, d, f)/(E, f, d) expert tensors)."""
    return {"ln": ("embed",), "router": ("embed", None),
            "w1": ("experts", "embed", "mlp"),
            "w3": ("experts", "embed", "mlp"),
            "w2": ("experts", "mlp", "embed")}


def _route(x, wr, k: int):
    """(weights (T,k) f32, idx (T,k), probs (T,E) f32) of tokens x."""
    logits = x.float() @ wr.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def router_topk(x, wr, k: int) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Token->expert routing. Returns (weights (T,k) f32, idx (T,k), aux)."""
    w, idx, probs = _route(x, wr, k)
    # each token's pairs a (distinct) expert: the one-hot of idx summed
    # over k, without one_hot, whose check of idx's range reads the data
    # (a host sync on the card; no value on ``meta``)
    ce = torch.zeros_like(probs).scatter_(-1, idx, 1.0).sum(0)
    return w, idx, _aux(probs.sum(0), ce, x.shape[0], wr.shape[-1])


def _aux(me_sum, ce_sum, T: int, E: int):
    """Switch-style load-balancing auxiliary loss from the router probs'
    sums over T tokens (E,) and each expert's routed pairs (E,)."""
    return E * torch.sum((me_sum / T) * (ce_sum / T))


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
    T = x.shape[0]
    g = _group_size(T, cfg.top_k, cfg.capacity_factor)
    w, idx, aux = router_topk(x, p["router"], cfg.top_k)
    _check_groups(T, g)
    return _einsum_experts(x, w, idx, p, cfg, g), aux


def _check_groups(T: int, g: int) -> None:
    if T % g:
        # where the reference's reshape of (T, d) into (T // g, g, d) fails
        raise ValueError(f"moe_einsum: {T} tokens do not split into groups "
                         f"of {g}; use moe_dispatch='gather'")


def _einsum_experts(x, w, idx, p, cfg, g: int, e0: int = 0):
    """The einsum dispatch's expert products and combine over groups of
    ``g`` tokens, for the experts e0, .., e0 + E_loc - 1 whose weights
    ``p`` holds (E_loc its w1's first dim): x (T, d), w and idx (T, k),
    T a multiple of g.  Returns (T, d), each token's sum over its kept
    pairs of those experts."""
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = T // g
    C = _capacity(g, E, k, cfg.capacity_factor)
    E_loc = p["w1"].shape[0]
    xg = x.reshape(G, g, d)
    # slot of each (token, k) inside its expert's capacity bucket, per
    # group; a pair past capacity goes to the sink column E*C
    slot = _slots(idx.reshape(G, g * k), E)
    flat = idx.reshape(G, g * k) * C + slot
    flat = torch.where(slot < C, flat, E * C).reshape(G, g, k)
    # the k experts of a token differ, so no two kept pairs of one token
    # share a column: each sum below has at most one nonzero term
    sel = torch.zeros((G, g, E * C + 1), dtype=torch.float32, device=x.device)
    cols = slice(e0 * C, (e0 + E_loc) * C)
    dispatch = sel.scatter(2, flat, 1.0)[..., cols].reshape(G, g, E_loc, C)
    combine = sel.scatter(2, flat, w.reshape(G, g, k))[..., cols] \
        .reshape(G, g, E_loc, C)

    xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
    ye = _apply_experts_grouped(xe, p, cfg)
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    return y.reshape(T, d)


def _apply_experts_grouped(xe, p, cfg):
    """xe: (G, E, C, d) -> (G, E, C, d)."""
    G, E, C, d = xe.shape
    out = _expert_ffn(
        xe.permute(1, 0, 2, 3).reshape(E, G * C, d), p, cfg.act)
    return out.reshape(E, G, C, d).permute(1, 0, 2, 3)


# ---------------------------------------------------------------------------
# gather dispatch — through the grouped expert-FFN kernel
# ---------------------------------------------------------------------------

def moe_gather(x, p, cfg):
    """Capacity-indexed gather dispatch: active FLOPs only.

    Returns ((T, d), aux_loss).  Pairs whose slot is past the capacity C
    are dropped, as in the reference: they add nothing to their token."""
    T = x.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    w, idx, aux = router_topk(x, p["router"], k)
    C = _capacity(T, E, k, cfg.capacity_factor)
    flat_e = idx.reshape(-1)                                 # (T*k,)
    slot, routed = _slots_and_counts(flat_e, E)
    # slots are ranks, so each bucket's filled slots are its first
    # min(routed, C): the kernel skips the pad rows after them
    fill = torch.clamp(routed, max=C).to(torch.int32)
    return _gather_experts(x, w, flat_e, slot, slot < C, fill, p, cfg.act,
                           C), aux


def _gather_experts(x, w, flat_e, slot, keep, fill, p, act: str, C: int,
                    e0: int = 0):
    """The gather dispatch's buckets, expert FFN and combine for the
    experts e0, .., e0 + E_loc - 1 whose weights ``p`` holds (E_loc its
    w1's first dim): x (T, d) tokens, w (T, k) their routing weights;
    flat_e, slot, keep (T*k,) each (token, k) pair's expert, slot in its
    bucket and whether it is kept; fill (E_loc,) int32 the filled slots
    of each bucket of C rows, which hold the kept pairs of its expert
    (the kernel skips the rows after them).  Returns (T, d), each token's
    sum over its kept pairs of those experts."""
    T, d = x.shape
    n = flat_e.shape[0]
    k = n // T
    E_loc = p["w1"].shape[0]
    rows = E_loc * C
    mine = keep & (flat_e >= e0) & (flat_e < e0 + E_loc)
    # each pair's row of the buckets, ``rows`` (none) if not here; each
    # bucket row's token (T: the zero pad row) and pair (n: none)
    row = torch.where(mine, (flat_e - e0) * C + slot, rows)
    token = torch.full((rows + 1,), T, dtype=torch.long, device=x.device)
    token[row] = torch.arange(T, device=x.device).repeat_interleave(k)
    pair = torch.full((rows + 1,), n, dtype=torch.long, device=x.device)
    pair[row] = torch.arange(n, device=x.device)
    xpad = torch.cat([x, x.new_zeros((1, d))])
    # the pad row's k (no) uses, after the tokens' k pairs each
    uses = torch.cat([row, row.new_full((k,), rows)])
    xe = _Rows.apply(xpad, token[:rows], uses, k).reshape(E_loc, C, d)
    ye = gmm_ops.expert_ffn(xe, p, act, fill)
    # combine: each token owns k consecutive pairs; sum them, no atomics.
    # A pair not here reads row 0 and is weighted 0.
    wk = torch.where(mine, w.reshape(-1).to(x.dtype), 0.0)
    src = _Rows.apply(ye.reshape(rows, d), torch.where(mine, row, 0),
                      pair[:rows], 1)
    return (src * wk[:, None]).reshape(T, k, d).sum(1)


class _Rows(torch.autograd.Function):
    """``src[index]``, whose backward is a gather too: ``uses`` lists, for
    each row of src in turn, the k output rows it went to (``len(out)``
    where fewer; a row read where the result is weighted 0 need not be
    listed), and a row's gradient is the sum of theirs.  So no gradient is
    summed by index into a shared row (the backward of ``src[index]``
    serialises on the pad row every empty slot reads), and no atomics."""

    @staticmethod
    def forward(ctx, src, index, uses, k: int):
        ctx.save_for_backward(uses)
        ctx.k = k
        return src[index]

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        (uses,) = ctx.saved_tensors
        d = dout.shape[-1]
        g = torch.cat([dout, dout.new_zeros((1, d))])[uses]
        return g.reshape(-1, ctx.k, d).sum(1), None, None, None


def moe_block(x, p, cfg, *, dispatch: str = "einsum", mesh=None):
    """Pre-norm MoE residual block. x: (B, S, d). Returns (x, aux_loss).

    ``mesh``: a ``DeviceMesh`` on which x and ``p`` lie as DTensors; the
    block then runs on each rank's pieces (``_moe_on_mesh``)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"moe dispatch {dispatch!r}; known: {DISPATCHES}")
    if mesh is not None and is_dtensor(x):
        return _moe_on_mesh(x, p, cfg, dispatch, mesh)
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, d)
    if dispatch == "gather":
        y, aux = moe_gather(h, p, cfg)
    else:
        y, aux = moe_einsum(h, p, cfg)
    return x + y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# On a device mesh
# ---------------------------------------------------------------------------

def _moe_on_mesh(x, p, cfg, dispatch: str, mesh):
    """``moe_block`` on a mesh, each rank on its local pieces (two
    ``local_map`` calls with explicit collectives; DTensor's op rules see
    none of the dispatch's scatters and index puts).

    x is held to its batch rows over the data axes, whole over "model"
    (whole everywhere if the batch does not split).  The router and the
    expert weights are gathered over the data axes (``layers.gathered``)
    and keep their "model" placement: a rank holds E / tp experts whole
    (``ep``), every expert's d_ff / tp slice (``base``), or all of them
    where ``safe_spec`` left both whole.

    Routing runs on the rank's rows.  Capacity is the reference's, over
    the global batch: its C comes from all B * S tokens, and a pair's slot
    is its rank among all pairs of its expert in token-major order.  The
    data ranks hold contiguous batch rows, so each rank's local slots are
    offset by the pairs its expert has on the lower data ranks: the (E,)
    counts of every data rank are summed over the data axes, and a rank
    fills its buckets with its own kept pairs (at most C rows each).  The
    aux loss takes ``me`` and ``ce`` over the global batch (their sums
    reduced over the data axes).  The einsum dispatch's groups of g tokens
    (``_group_size`` of the global batch) run on the rank where its rows
    hold whole groups; otherwise the tokens are gathered over the data
    axes for the dispatch and the rank takes its rows of the result.

    The expert products run on the rank's experts or d_ff slice, so its
    output is a partial sum over "model" (or whole, where the weights
    are), reduced by the residual stream's hint after the block."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    B, S, d = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.top_k
    names = mesh.mesh_dim_names
    model = names.index("model")
    dp = [names.index(a) for a in data_axes(mesh)]
    rep = (Replicate(),) * mesh.ndim

    want = placements(mesh, batch_specs([tuple(x.shape)], mesh)[0],
                      tuple(x.shape))
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    sharded = x.placements[dp[0]].is_shard()
    coord = mesh.get_coordinate()
    n_dp, r = 1, 0              # data shards and this rank's, pod major
    if sharded:
        for i in dp:
            n_dp, r = n_dp * mesh.size(i), r * mesh.size(i) + coord[i]
    h = rms_norm(x, p["ln"], cfg.norm_eps)

    g = None
    if dispatch == "einsum":
        g = _group_size(T, k, cfg.capacity_factor)
        _check_groups(T, g)
    # the einsum's groups span data ranks: the dispatch runs on all tokens
    whole = sharded and g is not None and (T // n_dp) % g != 0
    if whole:
        h = h.redistribute(mesh, rep)
    local_rows = sharded and not whole
    groups = [mesh.get_group(names[i]) for i in dp] if local_rows else []
    n_route, r_route = (n_dp, r) if local_rows else (1, 0)

    def place(data, model_place):
        return tuple(model_place if i == model else
                     (data if i in dp else Replicate())
                     for i in range(mesh.ndim))

    def route(h, wr):
        w, idx, probs = _route(h.reshape(-1, d), wr, k)
        counts = torch.zeros((n_route, E), dtype=torch.long,
                             device=h.device)
        counts[r_route].scatter_add_(0, idx.reshape(-1),
                                     torch.ones_like(idx.reshape(-1)))
        me = probs.sum(0)
        for grp in groups:
            counts = funcol.wait_tensor(funcol.all_reduce(counts, "sum",
                                                          grp))
            me = sum_over_ranks(me, grp)
        aux = _aux(me, counts.sum(0).float(), T, E)
        lead = h.shape[:2]
        return w.reshape(lead + (k,)), idx.reshape(lead + (k,)), counts, aux

    h_place = tuple(h.placements)
    wr = gathered(p["router"])
    # the router's gradient is each data rank's share where the rows are
    w, idx, counts, aux = local_map(
        route, out_placements=(list(h_place), list(h_place), list(rep),
                               list(rep)),
        in_placements=(h_place, tuple(wr.placements)),
        in_grad_placements=(h_place, place(
            Partial() if local_rows else Replicate(), Replicate())),
        device_mesh=mesh)(h, wr)

    ws = {n: gathered(p[n]) for n in ("w1", "w3", "w2") if n in p}
    split = ws["w1"].placements[model]
    experts_split = split.is_shard(0)
    partial = Partial() if split.is_shard() else Replicate()
    E_loc = E // mesh.size(model) if experts_split else E
    e0 = coord[model] * E_loc if experts_split else 0
    C = _capacity(T, E, k, cfg.capacity_factor)
    b_loc = B // n_dp

    def experts(h, w, idx, counts, *weights):
        t = h.reshape(-1, d)
        pw = dict(zip(ws, weights))
        if dispatch == "gather":
            flat_e = idx.reshape(-1)
            slot, routed = _slots_and_counts(flat_e, E)
            # each bucket's room after the lower data ranks' pairs
            room = torch.clamp(C - counts[:r_route].sum(0), min=0)
            fill = torch.minimum(routed, room)[e0:e0 + E_loc]
            y = _gather_experts(t, w.reshape(-1, k), flat_e, slot,
                                slot < room[flat_e], fill.to(torch.int32),
                                pw, cfg.act, C, e0)
        else:
            y = _einsum_experts(t, w.reshape(-1, k), idx.reshape(-1, k), pw,
                                cfg, g, e0)
        y = y.reshape(h.shape)
        return y[r * b_loc:(r + 1) * b_loc] if whole else y

    # a rank's share of the tokens' gradient is its experts' (or d_ff
    # slice's), over the rows it took; the weights' is its rows'
    tok_grad = place(Partial() if whole else want[dp[0]], partial)
    w_grad = Partial() if sharded else Replicate()
    y = local_map(
        experts, out_placements=list(place(want[dp[0]], partial)),
        in_placements=(h_place, h_place, h_place, rep) +
        tuple(tuple(t.placements) for t in ws.values()),
        in_grad_placements=(tok_grad, tok_grad, h_place, rep) +
        tuple(place(w_grad, t.placements[model]) for t in ws.values()),
        device_mesh=mesh)(h, w, idx, counts, *ws.values())
    return x + y, aux
