"""Decoder stack of the model zoo (PyTorch port of
``repro/models/transformer.py``).

The port covers ATTN / SWA / LOCAL self-attention and the Griffin RG-LRU
recurrent block (``repro_torch.models.rglru``), each with a gated (or
plain) MLP or a mixture of experts (``repro_torch.models.moe``), and the
xLSTM mLSTM and sLSTM blocks (``repro_torch.models.xlstm``), which have no
separate FFN.  Cross-attention and the audio encoder raise
``NotImplementedError`` naming the slice that ports them.

Layouts differ from the JAX package in one way: where JAX stacks the layers
of each pattern position under ``params["blocks"]`` (leading
``n_scan_blocks`` dim, for ``lax.scan``) plus a ``tail`` list, the port
keeps one dict per layer in depth order, ``params["layers"][n]``, of kind
``block_pattern[n % pattern_period]``.  ``repro_torch.convert`` maps
between the two.  The decode cache follows the same per-layer layout:
{"k", "v"} for an attention layer, {"h", "conv"} for an RG-LRU layer,
{"C", "n", "m", "conv"} for an mLSTM and {"h", "c", "n", "m", "conv"} for an
sLSTM layer.

Public API (``moe_dispatch`` is "einsum" or "gather", as in the reference;
it is read only by MoE layers):
  init_params(cfg, seed, device=, param_dtype=)    -> params
  forward_train(params, cfg, batch, moe_dispatch=, aux_weight=, device=)
                                                   -> (loss, metrics)
  forward_logits(params, cfg, batch, moe_dispatch=, device=) -> (B, S, V)
  prefill(params, cfg, batch, cache_len=, moe_dispatch=, device=)
                                                   -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache, moe_dispatch=, device=)
                                                   -> (logits, cache)
  init_cache(cfg, B, ctx_len, device=)             -> cache (zeros)
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import check_on_device, resolve_device, torch_dtype
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import (ATTN, SWA, LOCAL, CROSS, MLSTM, SLSTM,
                                       RGLRU, ArchConfig)
from repro_torch.models.layers import (decode_attention_block, dense,
                                       gated_mlp, is_gated_act, rms_norm,
                                       rope)
from repro_torch.models.moe import moe_block
from repro_torch.models.rglru import (RGLRU_C, apply_rglru, d_rnn,
                                      decode_rglru, init_state_rglru)
from repro_torch.models.xlstm import (CONV_K, apply_mlstm, apply_slstm,
                                      decode_mlstm, decode_slstm,
                                      init_state_mlstm, init_state_slstm,
                                      mlstm_dims, slstm_dims)

_SELF_ATTN = (ATTN, SWA, LOCAL)
_RECURRENT = (RGLRU, MLSTM, SLSTM)
_SUPPORTED = _SELF_ATTN + _RECURRENT
_LATER_SLICE = {CROSS: "the cross-attention (vision) slice"}
XENT_CHUNK = 512  # sequence chunk of the fused logits + loss


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what this slice of the port lacks."""
    if cfg.modality == "audio" or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: the audio encoder is ported in a later slice")
    for kind in cfg.block_pattern:
        if kind not in _SUPPORTED:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} blocks are ported in "
                f"{_LATER_SLICE.get(kind, 'a later slice')}")
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} inputs are ported in a later slice")


def layer_kind(cfg: ArchConfig, n: int) -> str:
    return cfg.block_pattern[n % cfg.pattern_period]


def _window_for(kind: str, cfg: ArchConfig) -> int:
    return cfg.window if kind in (SWA, LOCAL) else 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int = 0, *, device=None,
                param_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random weights with the JAX init's shapes and scales.

    Drawn in float32 from a ``torch.Generator`` seeded with ``seed`` on the
    target device, then stored in ``param_dtype``.  Training passes
    ``torch.float32``: master weights as the reference keeps them, cast to
    ``cfg.dtype`` at use, which AdamW updates.  By default (serving) they
    are stored in ``cfg.dtype``, so that full-width serving reads half the
    bytes; then the MoE router stays float32: routing casts it
    to float32 anyway, and a rounded router routes differently from the
    reference's.  So do the RG-LRU's ``lam``, ``b_a`` and ``b_i`` and the
    xLSTM gate biases (the reference's gates are float32 sums in a bf16
    model too), and the sLSTM's recurrent ``r_*``, which the reference
    reads in float32.  The numbers differ from ``jax.random``'s; parity
    tests convert JAX params instead.
    On the ``meta`` device nothing is drawn or allocated.
    """
    check_supported(cfg)
    device = resolve_device(device)
    dt = param_dtype or torch_dtype(cfg.dtype)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std, dtype=dt):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * std).to(dtype)

    def lin(m, n, scale=1.0):
        return normal((m, n), scale / math.sqrt(m))

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, device=device, dtype=dtype)

    d, H, KH, Dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

    def moe():
        E = cfg.n_experts
        return {"ln": zeros(d),
                "router": normal((d, E), d ** -0.5, torch.float32),
                "w1": normal((E, d, f), d ** -0.5),
                "w3": normal((E, d, f), d ** -0.5),
                "w2": normal((E, f, d), f ** -0.5 * out_scale)}

    def rglru():
        dr = d_rnn(cfg)
        # a = exp(-c softplus(lam)) starts in [0.9, 0.999]: lam is the
        # inverse softplus of -log(u) / c for u ~ U(0.9, 0.999)
        u = 0.9 + 0.099 * torch.rand((dr,), generator=gen, device=device,
                                     dtype=torch.float32)
        lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
        f32 = torch.float32
        return {"ln": zeros(d), "w_x": lin(d, dr), "w_g": lin(d, dr),
                "conv_w": normal((CONV_K, dr), 0.1),
                "conv_b": zeros(dr), "lam": lam,
                "w_a": lin(dr, dr, 0.1), "b_a": zeros(dr, dtype=f32),
                "w_i": lin(dr, dr, 0.1), "b_i": zeros(dr, dtype=f32),
                "w_out": lin(dr, d)}

    def mlstm():
        H, Dh, inner = mlstm_dims(cfg)
        f32 = torch.float32
        return {"ln": zeros(d), "w_up": lin(d, 2 * inner),
                "conv_w": normal((CONV_K, inner), 0.1),
                "conv_b": zeros(inner),
                # block-diagonal per-head projections
                "wq": normal((H, Dh, Dh), Dh ** -0.5),
                "wk": normal((H, Dh, Dh), Dh ** -0.5),
                "wv": normal((H, Dh, Dh), Dh ** -0.5),
                "w_ig": lin(inner, H, 0.1), "b_ig": zeros(H, dtype=f32),
                "w_fg": lin(inner, H, 0.1),
                # forget bias in [3, 6]: sigmoid(f) ~ 1 early
                "b_fg": torch.linspace(3.0, 6.0, H, device=device,
                                       dtype=f32),
                "skip": torch.ones((inner,), device=device, dtype=dt),
                "gn": zeros(inner), "w_down": lin(inner, d)}

    def slstm():
        H, Dh, ff = slstm_dims(cfg)
        f32 = torch.float32

        def rec():
            return normal((H, Dh, Dh), Dh ** -0.5, f32)
        p = {"ln": zeros(d), "conv_w": normal((CONV_K, d), 0.1),
             "conv_b": zeros(d)}
        for g in ("z", "i", "f", "o"):
            p[f"w_{g}"] = lin(d, d)
            p[f"r_{g}"] = rec()
            p[f"b_{g}"] = zeros(d, dtype=f32)
        p["b_f"] = torch.full((d,), 4.0, device=device, dtype=f32)
        p.update({"gn": zeros(d), "mlp_ln": zeros(d), "w1": lin(d, ff),
                  "w3": lin(d, ff), "w2": lin(ff, d)})
        return p

    def layer(kind):
        if kind in (MLSTM, SLSTM):
            # no separate FFN: the gates and the post-MLP live in the block
            return {"mix": mlstm() if kind == MLSTM else slstm()}
        if kind == RGLRU:
            p = {"mix": rglru()}
        else:
            p = {"mix": {"ln": zeros(d), "wq": lin(d, H * Dh),
                         "wk": lin(d, KH * Dh), "wv": lin(d, KH * Dh),
                         "wo": lin(H * Dh, d, out_scale)}}
        if cfg.is_moe:
            p["ffn"] = moe()
        elif f > 0:
            p["ffn"] = {"ln": zeros(d), "w1": lin(d, f),
                        "w2": lin(f, d, out_scale)}
            if is_gated_act(cfg.act):
                p["ffn"]["w3"] = lin(d, f)
        return p

    # std d^-1/2: lookups are rescaled by sqrt(d) when tied, and the tied
    # head then produces O(1) logits (MiniCPM-style mup scaling)
    params: Dict[str, Any] = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5)}
    params["layers"] = [layer(layer_kind(cfg, n))
                        for n in range(cfg.n_layers)]
    params["final_ln"] = zeros(d)
    if not cfg.tie_embeddings:
        params["head"] = lin(d, cfg.vocab_size)
    return params


# ---------------------------------------------------------------------------
# Blocks (full sequence)
# ---------------------------------------------------------------------------

def _self_attn(x, p, cfg, *, positions, window):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B, S, _ = h.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(h, p["wq"]).reshape(B, S, H, Dh)
    k = dense(h, p["wk"]).reshape(B, S, KH, Dh)
    v = dense(h, p["wv"]).reshape(B, S, KH, Dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # the CUDA kernel on the GPU, its plain version on the CPU
    o = flash_attention(q, k, v, causal=True, window=window)
    return x + dense(o.reshape(B, S, H * Dh), p["wo"]), (k, v)


def _apply_ffn(x, p, cfg, moe_dispatch):
    """Returns (x, aux): the MoE load-balancing loss, 0.0 for a dense MLP."""
    if cfg.is_moe:
        return moe_block(x, p, cfg, dispatch=moe_dispatch)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + gated_mlp(h, p, cfg.act), 0.0


def _apply_layer(x, layer, kind, cfg, positions, moe_dispatch,
                 collect_kv: bool):
    """Returns (x, aux, (k, v) or recurrent state or None)."""
    if kind in _RECURRENT:
        out = _APPLY_RECURRENT[kind](x, layer["mix"], cfg,
                                     return_state=collect_kv)
        x, kv = out if collect_kv else (out, None)
    else:
        x, kv = _self_attn(x, layer["mix"], cfg, positions=positions,
                           window=_window_for(kind, cfg))
    aux = 0.0
    if "ffn" in layer:
        x, aux = _apply_ffn(x, layer["ffn"], cfg, moe_dispatch)
    return x, aux, kv


# matrix products without batch dims: what the reference's "dots" policy
# (``dots_with_no_batch_dims_saveable``) keeps; ``x @ w`` with a 2-D weight
# dispatches to one of these
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _stack_forward(params, cfg, x, positions, moe_dispatch, *,
                   collect_kv: bool = False, remat: str = "none"):
    """Runs every layer in depth order.

    ``remat`` is the reference's ``cfg.remat`` for training: "full" keeps
    only each layer's input and recomputes the layer in the backward,
    "dots" keeps its matrix products' outputs too, "none" keeps all.
    Returns (x, summed aux loss (0.0 without MoE layers), per-layer
    [(k, v) or recurrent state] or None)."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"remat {remat!r}; known: full, dots, none")
    ckpt = {"use_reentrant": False}
    if remat == "dots":
        ckpt["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    kvs: Optional[List[Any]] = [] if collect_kv else None
    aux = 0.0
    for n, layer in enumerate(params["layers"]):
        args = (x, layer, layer_kind(cfg, n), cfg, positions, moe_dispatch,
                collect_kv)
        if remat == "none":
            x, a, kv = _apply_layer(*args)
        else:
            x, a, kv = checkpoint(_apply_layer, *args, **ckpt)
        aux = aux + a
        if kvs is not None:
            kvs.append(kv)
    return x, aux, kvs


_APPLY_RECURRENT = {RGLRU: apply_rglru, MLSTM: apply_mlstm,
                    SLSTM: apply_slstm}
_DECODE_RECURRENT = {RGLRU: decode_rglru, MLSTM: decode_mlstm,
                     SLSTM: decode_slstm}
_INIT_RECURRENT = {RGLRU: init_state_rglru, MLSTM: init_state_mlstm,
                   SLSTM: init_state_slstm}


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _embed(params, cfg, tokens):
    dt = torch_dtype(cfg.dtype)
    x = F.embedding(tokens, params["embed"]).to(dt)
    if cfg.tie_embeddings:
        # sqrt(d) rounded to the activation dtype first, as the reference
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def _unembed(x, params, cfg):
    if cfg.tie_embeddings:
        return F.linear(x, params["embed"].to(x.dtype))
    return x @ params["head"].to(x.dtype)


def _prepare(params, cfg, tokens, device):
    check_supported(cfg)
    device = resolve_device(device)
    check_on_device(params["embed"], device, "params")
    return _tokens(tokens, device)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _head_matrix(params, cfg):
    """The unembedding as (d, V), float32 in training."""
    return params["embed"].t() if cfg.tie_embeddings else params["head"]


def _chunk_loss(xc, head, lc, mc, z_weight: float):
    logits = (xc @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    nll = (lse - gold) * mc
    zl = z_weight * torch.sum(torch.square(lse) * mc)
    correct = torch.sum((torch.argmax(logits, dim=-1) == lc) * mc)
    return torch.sum(nll) + zl, torch.sum(mc), correct


def softmax_xent_from_hidden(x, head, labels, mask=None, *,
                             chunk: int = XENT_CHUNK,
                             z_weight: float = 1e-4):
    """Fused per-chunk logits + cross-entropy, each chunk recomputed in the
    backward, so that (B, S, V) is never held.

    x: (B, S, d) hidden states; head: (d, V), cast to x's dtype (once, not
    per chunk); labels: (B, S) ints; mask: (B, S) or None.  Chunks of
    ``chunk`` positions, then the remainder, in order.  Returns
    (mean nll + z-loss, accuracy), both over the mask's weight; the z-loss
    ``z_weight * sum(lse^2)`` regularises the log-sum-exp."""
    B, S, d = x.shape
    chunk = min(chunk, S)
    head = head.to(x.dtype)
    labels = labels.long()
    mask = torch.ones((B, S), device=x.device) if mask is None else \
        mask.float()
    tot = cnt = cor = torch.zeros((), device=x.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(s0 + chunk, S))
        t, m, c = checkpoint(_chunk_loss, x[:, sl], head, labels[:, sl],
                             mask[:, sl], z_weight, use_reentrant=False)
        tot, cnt, cor = tot + t, cnt + m, cor + c
    den = torch.clamp(cnt, min=1.0)
    return tot / den, cor / den


def forward_train(params, cfg: ArchConfig, batch, *,
                  moe_dispatch: str = "einsum", aux_weight: float = 0.01,
                  device=None):
    """Training forward: next-token LM loss.  batch: tokens and labels
    (B, S), and optionally a (B, S) mask.

    Layers are recomputed in the backward as ``cfg.remat`` says.  Returns
    (total, {"nll", "aux", "acc"}); total adds ``aux_weight * aux /
    n_layers`` to the loss for an MoE model, as the reference does."""
    tokens = _prepare(params, cfg, batch["tokens"], device)
    labels = _tokens(batch["labels"], tokens.device)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _stack_forward(params, cfg, x, positions, moe_dispatch,
                               remat=cfg.remat)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=x.device)
    loss, acc = softmax_xent_from_hidden(x, _head_matrix(params, cfg),
                                         labels, mask)
    total = loss + aux_weight * aux / cfg.n_layers if cfg.is_moe else loss
    return total, {"nll": loss, "aux": aux, "acc": acc}


def forward_logits(params, cfg: ArchConfig, batch, *,
                   moe_dispatch: str = "einsum", device=None):
    """Full-sequence logits (no cache) — used by eval / tests."""
    tokens = _prepare(params, cfg, batch["tokens"], device)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = _stack_forward(params, cfg, x, positions, moe_dispatch)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(x, params, cfg)


def _cache_len(kind: str, cfg: ArchConfig, ctx_len: int) -> int:
    w = _window_for(kind, cfg)
    return min(ctx_len, w) if w else ctx_len


def init_cache(cfg: ArchConfig, B: int, ctx_len: int, *, device=None):
    """Zeroed decode cache: {"layers": [{"k", "v": (B, L, KH, Dh)} or a
    recurrent layer's state, ...]}: RG-LRU {"h": (B, D) float32, "conv":
    (B, CONV_K - 1, D)}, mLSTM {"C", "n", "m" float32, "conv"}, sLSTM
    {"h", "c", "n", "m" float32, "conv"} (``repro_torch.models.xlstm``).

    k, v and conv are bf16 whatever ``cfg.dtype`` is, as in the reference;
    ``prefill`` makes k and v in ``cfg.dtype`` (conv stays bf16)."""
    check_supported(cfg)
    device = resolve_device(device)
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    layers = []
    for n in range(cfg.n_layers):
        kind = layer_kind(cfg, n)
        if kind in _RECURRENT:
            layers.append(_INIT_RECURRENT[kind](cfg, B, device=device))
            continue
        L = _cache_len(kind, cfg, ctx_len)
        layers.append({
            "k": torch.zeros((B, L, KH, Dh), dtype=torch.bfloat16,
                             device=device),
            "v": torch.zeros((B, L, KH, Dh), dtype=torch.bfloat16,
                             device=device)})
    return {"layers": layers}


def decode_step(params, cfg: ArchConfig, tokens, pos: int, cache, *,
                moe_dispatch: str = "einsum", device=None):
    """One new token against the cache.  tokens: (B, 1); pos: int.

    Returns (logits: (B, V), cache).  The cache's tensors, attention k/v
    and recurrent state alike, are updated in place; the returned cache
    holds the same tensors.
    """
    tokens = _prepare(params, cfg, tokens, device)
    pos = int(pos)
    x = _embed(params, cfg, tokens)
    layers = []
    for n, layer in enumerate(params["layers"]):
        kind = layer_kind(cfg, n)
        if kind in _RECURRENT:
            x, new = _DECODE_RECURRENT[kind](x, layer["mix"], cfg,
                                             cache["layers"][n])
        else:
            x, new = decode_attention_block(
                x, layer["mix"], cfg, cache["layers"][n], pos,
                window=_window_for(kind, cfg))
        layers.append(new)
        if "ffn" in layer:
            x, _ = _apply_ffn(x, layer["ffn"], cfg, moe_dispatch)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(x, params, cfg)[:, 0], {"layers": layers}


def prefill(params, cfg: ArchConfig, batch, *,
            cache_len: Optional[int] = None, moe_dispatch: str = "einsum",
            device=None):
    """Full-context forward that also materialises the decode cache.

    Returns (last_token_logits: (B, V), cache).  Each attention layer's
    cache is sized ``cache_len`` (default: context length), or its window
    when smaller, and holds the (windowed, ring-rotated) keys/values in
    ``cfg.dtype``; a recurrent layer's is its state after the last token,
    as the reference keeps it.
    """
    tokens = _prepare(params, cfg, batch["tokens"], device)
    x = _embed(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, _, kvs = _stack_forward(params, cfg, x, positions, moe_dispatch,
                               collect_kv=True)
    x = rms_norm(x[:, -1], params["final_ln"], cfg.norm_eps)
    logits = _unembed(x, params, cfg)

    L_default = cache_len or S
    dt = torch_dtype(cfg.dtype)

    def fit(arr, L):
        if arr.shape[1] > L:            # keep last L, ring-rotate
            arr = torch.roll(arr[:, -L:], S % L, dims=1)
        elif arr.shape[1] < L:          # pad up to L slots
            pad = arr.new_zeros((arr.shape[0], L) + arr.shape[2:])
            pad[:, :arr.shape[1]] = arr
            arr = pad
        return arr.to(dt).contiguous()

    layers = []
    for n, kv in enumerate(kvs):
        kind = layer_kind(cfg, n)
        if kind in _RECURRENT:
            layers.append(kv)           # recurrent state dict, verbatim
            continue
        L = _cache_len(kind, cfg, L_default)
        layers.append({"k": fit(kv[0], L), "v": fit(kv[1], L)})
    return logits, {"layers": layers}
