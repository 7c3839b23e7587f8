"""Shared neural building blocks for the model zoo (PyTorch port).

Counterpart of ``repro/models/layers.py``: plain functions on tensors that
keep the JAX package's layouts, so that the parity tests compare like with
like.  Self-attention over a full sequence goes through the flash-attention
kernel (``repro_torch.kernels.flash_attention``), whose plain version is
:func:`attention` here.

Conventions:
  * activations compute in ``cfg.dtype``, norms and softmax in float32,
  * weights are cast to the activation dtype at use (:func:`dense`),
  * q/k/v are ``(B, S, heads, Dh)``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (data_axes, is_dtensor,
                                              placements, safe_spec)

_QBLOCK = 512          # query-block rows for long plain attention
_PLAIN_ATTN_MAX = 2048  # up to this many query rows, one block


# ---------------------------------------------------------------------------
# Elementary ops
# ---------------------------------------------------------------------------

def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as it is used: a DTensor made whole over the mesh's
    data-parallel axes (the FSDP all-gather at use, whose backward
    reduce-scatters the gradient), as the reference's partitioner gathers
    the ruleset's ZeRO shards; left to itself, DTensor would move the
    batch-sharded activations instead.  Other tensors pass as they are."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    dp = data_axes(mesh)
    place = [Replicate() if name in dp else p
             for name, p in zip(mesh.mesh_dim_names, w.placements)]
    return w if place == list(w.placements) else w.redistribute(mesh, place)


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_ranks(t: torch.Tensor, group) -> torch.Tensor:
    """An all-reduce sum over ``group`` of a value that every rank then
    holds whole: its gradient is the same on every rank and passes
    through unchanged."""
    return _SumOverRanks.apply(t, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(g, "sum", ctx.group)), \
            None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """An all-reduce sum over ``group`` of a value that each rank then uses
    in its own way (a norm over a width the ranks split): its gradient is
    the sum of every rank's, all-reduced in the backward too."""
    return _AllReduceSum.apply(t, group)


# ---------------------------------------------------------------------------
# On a device mesh: hints and each rank's local pieces
# ---------------------------------------------------------------------------

def shard_hint(x, mesh, dims):
    """Explicit activation-sharding constraint, the reference's
    ``shard_hint``.

    ``dims``: one logical name per dim of x — "batch" (DP axes), "model"
    (TP axis), or None.  Without a mesh, or on a plain tensor, this is a
    no-op.  On a DTensor it redistributes x to ``safe_spec``'s placements
    (indivisible dims degrade to replicated), so that the partitioning of
    batch and heads is the reference's whatever DTensor's op rules would
    pick."""
    if mesh is None or not is_dtensor(x):
        return x
    dp = data_axes(mesh)
    dp_axis = dp if len(dp) > 1 else dp[0]
    want = [dp_axis if d == "batch" else ("model" if d == "model" else None)
            for d in dims]
    place = placements(mesh, safe_spec(x.shape, want, mesh), x.shape)
    return x if tuple(x.placements) == place else \
        reduce_partials(x).redistribute(mesh, place)


def reduce_partials(x):
    """A DTensor's partial sums reduced whole (all-reduced) first: DTensor's
    one-step move from a vocab-sharded lookup's masked partial to a batch
    shard misreads the mask."""
    if not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def local_call(fn, mesh, args, out, grads=None):
    """``fn`` on each rank's local pieces (``local_map``): a DTensor of
    ``args`` is passed as its local tensor, anything else as it is.
    ``out``: a list of placements for one output, a tuple of lists for
    several.  ``grads``: for each arg the placements of its gradient, or
    None for its own (a weight used on a rank's batch rows has a partial
    gradient: ``rows_grad``)."""
    from torch.distributed.tensor.experimental import local_map
    ins = tuple(tuple(a.placements) if is_dtensor(a) else None
                for a in args)
    if grads is not None:
        grads = tuple(i if g is None else tuple(g)
                      for g, i in zip(grads, ins))
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


def rows_grad(x, w):
    """The placements of the gradient of ``w`` (a DTensor whole over the
    data axes) that each rank takes on its batch rows of ``x``: partial
    over the mesh dims that split x's batch, w's own elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if xp.is_shard(0) else wp
                 for xp, wp in zip(x.placements, w.placements))


def model_dim(mesh) -> int:
    return mesh.mesh_dim_names.index("model")


def over_model(t, mesh, dim: Optional[int]):
    """The DTensor ``t`` split along ``dim`` over "model" (a local slice
    where it was whole), or whole over "model" for ``dim`` None (an
    all-gather where it was split, an all-reduce where it was partial);
    its other mesh dims as they are."""
    from torch.distributed.tensor import Replicate, Shard
    place = list(t.placements)
    place[model_dim(mesh)] = Replicate() if dim is None else Shard(dim)
    return t if tuple(place) == tuple(t.placements) else \
        t.redistribute(mesh, place)


def model_rank(t, mesh) -> int:
    """This rank's piece of the DTensor ``t``'s split over "model" (0
    where it is whole)."""
    if not t.placements[model_dim(mesh)].is_shard():
        return 0
    return mesh.get_local_rank("model")


def model_group(t, mesh):
    """The "model" group for a collective over the ranks that split ``t``,
    or None where it is whole over "model"."""
    return (mesh, model_dim(mesh)) if t.placements[model_dim(mesh)] \
        .is_shard() else None


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """A local piece all-gathered along its last dim over ``group`` (no
    gradient: decode steps), or ``t`` for group None."""
    if group is None:
        return t
    from torch.distributed import _functional_collectives as funcol
    # all_gather_single is all_gather_tensor's newer name
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    return funcol.wait_tensor(gather(t.contiguous(), t.dim() - 1, group))


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
             group=None):
    """RMS norm over the last dim.  ``group``: a (mesh, mesh dim) whose
    ranks hold equal pieces of that dim (x is a rank's columns inside a
    ``local_map``); the sums of squares are all-reduced over it."""
    dt = x.dtype
    x = x.float()
    if group is None:
        ms = x.square().mean(-1, keepdim=True)
    else:
        ms = all_reduce_sum(x.square().sum(-1, keepdim=True), group) / (
            x.shape[-1] * group[0].size(group[1]))
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + gathered(w).float())).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor):
    """x @ w with the weight cast to the activation dtype (and gathered
    over the data axes on a mesh)."""
    return x @ gathered(w.to(x.dtype))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Half-split rotary embedding. x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    ang = ang[..., :, None, :]                            # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _relu2(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact form
    return F.gelu(x, approximate="tanh")


_ACTS = {"swiglu": F.silu, "geglu": _gelu_tanh, "gelu": _gelu_tanh,
         "relu2": _relu2}


def _relu2_bwd(grad, x):
    return grad * (2.0 * F.relu(x))


def _gelu_tanh_bwd(grad, x):
    return torch.ops.aten.gelu_backward(grad, x, approximate="tanh")


# grad * act'(x) for each activation of _ACTS, by the same names: the
# fused backward ops autograd itself runs for them
_ACT_BWDS = {"swiglu": torch.ops.aten.silu_backward,
             "geglu": _gelu_tanh_bwd, "gelu": _gelu_tanh_bwd,
             "relu2": _relu2_bwd}


def act_fn(name: str):
    return _ACTS[name]


def act_bwd_fn(name: str):
    """``(grad, x) -> grad * act'(x)``, the backward of ``act_fn(name)``."""
    return _ACT_BWDS[name]


def is_gated_act(name: str) -> bool:
    return name in ("swiglu", "geglu")


def gated_mlp(x, p, act: str):
    """MLP: gated (SwiGLU/GeGLU: w1, w3, w2) or plain (gelu/relu2: w1, w2)."""
    h = act_fn(act)(dense(x, p["w1"]))
    if "w3" in p:
        h = h * dense(x, p["w3"])
    return dense(h, p["w2"])


def split_heads(t, shape):
    """``t.reshape(shape)``, the last dim split into (heads, Dh).  A
    DTensor's last dim sharded over a mesh dim that does not divide the
    heads is gathered first (DTensor splits only a dim whose leading part
    its shards divide), as the reference's partitioner does."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        mesh, place = t.device_mesh, list(t.placements)
        for i, p in enumerate(place):
            if p.is_shard(t.ndim - 1) and shape[-2] % mesh.size(i):
                place[i] = Replicate()
        if place != list(t.placements):
            t = t.redistribute(mesh, place)
    return t.reshape(shape)


def merge_heads(t, shape):
    """``t.reshape(shape)``, (heads, Dh) merged into the last dim.  On a
    DTensor the gradient is brought back to the merged tensor's placements
    (redistribute's backward) before the backward splits it: where
    ``split_heads`` left the heads whole, the product with ``wo`` hands
    back a gradient sharded along the merged dim, which DTensor cannot
    split into heads its shards do not divide."""
    from torch.distributed.tensor import DTensor
    out = t.reshape(shape)
    if isinstance(out, DTensor):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window), plain version
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0,
              kv_len: Optional[int] = None, return_lse: bool = False):
    """Grouped-query attention, exact softmax.

    q: (B, S_q, H, Dh); k, v: (B, S_k, KH, Dh).  H = KH * G.
    ``q_offset``: absolute position of q[0] relative to k[0] (decode/prefill).
    ``window`` > 0 restricts attention to the last ``window`` key positions.
    ``kv_len``: number of valid key slots (decode caches).
    Scores are formed in the input dtype and then upcast, as the JAX
    reference does.  Returns (B, S_q, H, Dh), and with ``return_lse`` also
    each row's float32 log-sum-exp of its masked scores, (B, S_q, H): the
    weight of this block of keys when blocks are combined
    (``combine_partials``).
    """
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Sq, KH, G, Dh)
    k_pos = torch.arange(Sk, device=q.device)
    ct = torch.promote_types(q.dtype, k.dtype)   # jnp.einsum promotes too

    def block_out(q_blk, q_pos):
        # q_blk: (B, bq, KH, G, Dh); q_pos: (bq,) absolute positions
        s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.to(ct), k.to(ct))
        s = (s * scale).float()
        mask = torch.ones((q_pos.shape[0], Sk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        if kv_len is not None:
            mask &= (k_pos < kv_len)[None, :]
        s = s.masked_fill(~mask, -1e30)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v)
        if not return_lse:
            return out
        # (B, KH, G, bq) -> (B, bq, KH, G)
        return out, torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2)

    q_pos = q_offset + torch.arange(Sq, device=q.device)
    if Sq <= _PLAIN_ATTN_MAX:
        outs = [block_out(qg, q_pos)]
    else:   # bound the (bq, S_k) score block; rows are independent
        outs = [block_out(qg[:, i:i + _QBLOCK], q_pos[i:i + _QBLOCK])
                for i in range(0, Sq, _QBLOCK)]
    if not return_lse:
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return out.reshape(B, Sq, H, Dh)
    out = torch.cat([o for o, _ in outs], dim=1).reshape(B, Sq, H, Dh)
    lse = torch.cat([l for _, l in outs], dim=1).reshape(B, Sq, H)
    return out, lse


def combine_partials(out, lse, group):
    """Attention over keys split across the ranks of ``group``, from each
    rank's ``attention(..., return_lse=True)`` over its own keys: the
    outputs weighted by exp(lse - the log-sum-exp over all ranks) and
    summed, in float32 (flash-decoding's combine).  A rank whose keys are
    all masked has an lse near -1e30 and weight 0.  With one rank the
    weight is exactly 1 and ``out`` comes back unchanged.  Returns the
    combined (B, S_q, H, Dh) in ``out``'s dtype on every rank."""
    from torch.distributed import _functional_collectives as funcol
    m = funcol.all_reduce(lse, "max", group)
    total = m + torch.log(funcol.all_reduce(torch.exp(lse - m), "sum",
                                            group))
    w = torch.exp(lse - total)[..., None]
    return funcol.all_reduce(out.float() * w, "sum", group).to(out.dtype)


# ---------------------------------------------------------------------------
# Decode-path attention with a KV ring-buffer cache
# ---------------------------------------------------------------------------

def decode_attention_block(x, p, cfg, cache, pos: int, *, window: int = 0,
                           mesh=None):
    """One-token self-attention against a cache.

    cache: {"k","v": (B, S_cache, KH, Dh)}; pos: absolute position (int).
    For windowed attention S_cache == window and writes wrap (ring buffer):
    RoPE is applied pre-insertion so rotated keys stay valid under wrap.
    Without a window a position past the cache writes its last slot, as
    ``lax.dynamic_update_slice`` clamps in the reference.  The cache
    tensors are updated in place (no copy of the cache per token) and
    returned.  On a ``mesh`` the cache is DTensors placed by
    ``distributed.sharding.cache_specs``: see ``decode_attend_on_mesh``.
    """
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B = h.shape[0]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(dense(h, p["wq"]), (B, 1, H, Dh))
    k = split_heads(dense(h, p["wk"]), (B, 1, KH, Dh))
    v = split_heads(dense(h, p["wv"]), (B, 1, KH, Dh))
    posv = torch.full((1,), pos, device=x.device)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    S_cache = ck.shape[1]
    slot = pos % S_cache if window else min(max(pos, 0), S_cache - 1)
    kv_len = min(pos + 1, S_cache)
    if mesh is None:
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        o = attention(q, ck, cv, causal=False, kv_len=kv_len)
    else:
        o = decode_attend_on_mesh(q, k, v, ck, cv, slot, kv_len, mesh)
    o = dense(o.reshape(B, 1, H * Dh), p["wo"])
    return x + o, {"k": ck, "v": cv}


def decode_attend_on_mesh(q, k, v, ck, cv, slot: Optional[int],
                          kv_len: Optional[int], mesh):
    """Write slot ``slot`` and attend over the first ``kv_len`` slots of a
    cache that lies on ``mesh``; q, k, v (B, 1, heads, Dh) DTensors.  Read
    only (a CROSS layer's patch memory): k, v, ``slot`` and ``kv_len``
    None, nothing written and every slot attended.

    Each rank holds all heads of its batch rows (q, k, v are made whole
    over "model").  A sequence-sharded cache (``cache_specs``' choice for
    1024 slots or more) is written only by the rank that owns ``slot``,
    each rank attends over its own slots, and the ranks' outputs are
    combined across "model" by their log-sum-exps (``combine_partials``).
    A cache sharded along its feature dim (shorter caches), or whole over
    "model", is written by every rank in its own columns and gathered
    whole over "model" for the attention, as the reference's partitioner
    does.  Returns o (B, 1, H, Dh), whole over "model"."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    model = model_dim(mesh)
    rank = mesh.get_coordinate()[model]
    whole = list(ck.placements)
    whole[model] = Replicate()
    new = () if slot is None else (k, v)
    q, *new = (t.redistribute(mesh, whole) for t in (q, *new))
    cache_place = tuple(ck.placements)
    in_place = (tuple(whole),) + (cache_place,) * 2 + \
        (tuple(whole),) * len(new)

    if ck.placements[model] == Shard(1):
        def attend(q, ck, cv, *new):
            L = ck.shape[1]
            lo = rank * L
            if new and lo <= slot < lo + L:
                ck[:, slot - lo] = new[0][:, 0].to(ck.dtype)
                cv[:, slot - lo] = new[1][:, 0].to(cv.dtype)
            n = None if kv_len is None else min(max(kv_len - lo, 0), L)
            o, lse = attention(q, ck, cv, causal=False, kv_len=n,
                               return_lse=True)
            return combine_partials(o, lse, (mesh, model))
        return local_map(attend, out_placements=whole, in_placements=in_place,
                         device_mesh=mesh)(q, ck, cv, *new)

    if new:
        sharded = ck.placements[model] == Shard(3)

        def write_cols(ck, cv, k, v):
            lo = rank * ck.shape[3] if sharded else 0
            hi = lo + ck.shape[3]
            ck[:, slot] = k[:, 0, :, lo:hi].to(ck.dtype)
            cv[:, slot] = v[:, 0, :, lo:hi].to(cv.dtype)
            return ck, cv
        ck, cv = local_map(write_cols, out_placements=(list(cache_place),) * 2,
                           in_placements=in_place[1:],
                           device_mesh=mesh)(ck, cv, *new)
    ck_all, cv_all = (t.redistribute(mesh, whole) for t in (ck, cv))
    return local_map(
        lambda q, ck, cv: attention(q, ck, cv, causal=False, kv_len=kv_len),
        out_placements=whole, in_placements=(tuple(whole),) * 3,
        device_mesh=mesh)(q, ck_all, cv_all)
