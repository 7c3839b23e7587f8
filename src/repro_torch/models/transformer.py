"""Decoder stack of the model zoo (PyTorch port of
``repro/models/transformer.py``).

The port covers every block kind of the reference: ATTN / SWA / LOCAL
self-attention (causal, or not for an encoder-only model), CROSS (gated
cross-attention from the tokens to a vision model's patch memory) and the
Griffin RG-LRU recurrent block (``repro_torch.models.rglru``), each with a
gated (or plain) MLP or a mixture of experts (``repro_torch.models.moe``),
and the xLSTM mLSTM and sLSTM blocks (``repro_torch.models.xlstm``), which
have no separate FFN.  Inputs are tokens (text), tokens plus patch
embeddings (vision: ``memory = patches @ vis_proj``, computed once per
forward) or frame embeddings (audio: ``frames @ frontend``, no token
embedding; trained by masked prediction of cluster labels, with no decode
step).

Layouts differ from the JAX package in one way: where JAX stacks the layers
of each pattern position under ``params["blocks"]`` (leading
``n_scan_blocks`` dim, for ``lax.scan``) plus a ``tail`` list, the port
keeps one dict per layer in depth order, ``params["layers"][n]``, of kind
``block_pattern[n % pattern_period]``.  ``repro_torch.convert`` maps
between the two.  The decode cache follows the same per-layer layout:
{"k", "v"} for a self-attention layer, {"ck", "cv"} (the patch memory's
keys and values) for a CROSS layer, {"h", "conv"} for an RG-LRU layer,
{"C", "n", "m", "conv"} for an mLSTM and {"h", "c", "n", "m", "conv"} for an
sLSTM layer.

Public API (``moe_dispatch`` is "einsum" or "gather", as in the reference;
it is read only by MoE layers):
  init_params(cfg, seed, device=, param_dtype=)    -> params
  forward_train(params, cfg, batch, moe_dispatch=, aux_weight=, device=)
                                                   -> (loss, metrics)
  (a batch holds "tokens" and "labels", plus "patches" for vision; or
  "frames", "labels" and "mask" for audio)
  forward_logits(params, cfg, batch, moe_dispatch=, device=) -> (B, S, V)
  prefill(params, cfg, batch, cache_len=, moe_dispatch=, device=)
                                                   -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache, moe_dispatch=, device=)
                                                   -> (logits, cache)
  init_cache(cfg, B, ctx_len, device=)             -> cache (zeros)
``forward_train``, ``forward_logits``, ``prefill`` and ``decode_step`` also
take ``mesh=``, a ``DeviceMesh`` on which the params lie as DTensors, for
every config: the text decoders, the vision model's gated
cross-attention and the audio encoder.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import check_on_device, resolve_device, torch_dtype
from repro_torch.distributed import flops
from repro_torch.distributed.sharding import (cache_specs,
                                              distribute_batch, is_dtensor,
                                              placements)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import (ATTN, SWA, LOCAL, CROSS, MLSTM, SLSTM,
                                       RGLRU, ArchConfig)
from repro_torch.models.layers import (attention, decode_attend_on_mesh,
                                       decode_attention_block, dense,
                                       gated_mlp, gathered, is_gated_act,
                                       local_call, merge_heads, model_dim,
                                       over_model, reduce_partials, rms_norm,
                                       rope, shard_hint, split_heads,
                                       sum_over_ranks)
from repro_torch.models.moe import moe_block, moe_ffn_axes
from repro_torch.models.rglru import (RGLRU_C, apply_rglru, d_rnn,
                                      decode_rglru, init_state_rglru,
                                      rglru_axes)
from repro_torch.models.xlstm import (CONV_K, apply_mlstm, apply_slstm,
                                      decode_mlstm, decode_slstm,
                                      init_state_mlstm, init_state_slstm,
                                      mlstm_axes, mlstm_dims, slstm_axes,
                                      slstm_dims)

_SELF_ATTN = (ATTN, SWA, LOCAL)
_RECURRENT = (RGLRU, MLSTM, SLSTM)
_KINDS = _SELF_ATTN + (CROSS,) + _RECURRENT
_MODALITIES = ("text", "audio", "vision")
XENT_CHUNK = 512  # sequence chunk of the fused logits + loss


def check_supported(cfg: ArchConfig) -> None:
    """Raise ValueError on a block kind or modality the model does not
    know, as the reference's block dispatch does."""
    for kind in cfg.block_pattern:
        if kind not in _KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}; "
                             f"known: {', '.join(_KINDS)}")
    if cfg.modality not in _MODALITIES:
        raise ValueError(f"{cfg.name}: unknown modality {cfg.modality!r}; "
                         f"known: {', '.join(_MODALITIES)}")


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
    reads in float32, and a CROSS layer's scalar ``gate`` (0 at init, as in
    the reference: a fresh model's cross path adds nothing).  An audio
    model has a ``frontend`` (frontend_dim x d) and no ``embed``; a vision
    model adds ``vis_proj`` (frontend_dim x d).  The numbers differ from
    ``jax.random``'s; parity tests convert JAX params instead.
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
            if kind == CROSS:
                p["mix"]["gate"] = zeros(dtype=torch.float32)
        if cfg.is_moe:
            p["ffn"] = moe()
        elif f > 0:
            p["ffn"] = {"ln": zeros(d), "w1": lin(d, f),
                        "w2": lin(f, d, out_scale)}
            if is_gated_act(cfg.act):
                p["ffn"]["w3"] = lin(d, f)
        return p

    params: Dict[str, Any] = {}
    if cfg.modality == "audio":
        params["frontend"] = lin(cfg.frontend_dim, d)
    else:
        # std d^-1/2: lookups are rescaled by sqrt(d) when tied, and the
        # tied head then produces O(1) logits (MiniCPM-style mup scaling)
        params["embed"] = normal((cfg.vocab_size, d), d ** -0.5)
    if cfg.modality == "vision":
        params["vis_proj"] = lin(cfg.frontend_dim, d)
    params["layers"] = [layer(layer_kind(cfg, n))
                        for n in range(cfg.n_layers)]
    params["final_ln"] = zeros(d)
    if not cfg.tie_embeddings:
        params["head"] = lin(d, cfg.vocab_size)
    return params


def logical_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """The logical axis names of each leaf of ``init_params(cfg)``, keyed
    leaf for leaf like it: the reference's axes tree, each layer's without
    the leading stacked "layers" dim (``distributed.sharding`` maps them
    onto a mesh)."""
    check_supported(cfg)
    recurrent = {RGLRU: rglru_axes, MLSTM: mlstm_axes, SLSTM: slstm_axes}

    def layer(kind):
        if kind in (MLSTM, SLSTM):
            return {"mix": recurrent[kind]()}
        if kind == RGLRU:
            p = {"mix": rglru_axes()}
        else:
            p = {"mix": {"ln": ("embed",), "wq": ("embed", "heads"),
                         "wk": ("embed", "kv"), "wv": ("embed", "kv"),
                         "wo": ("heads", "embed")}}
            if kind == CROSS:
                p["mix"]["gate"] = ()
        if cfg.is_moe:
            p["ffn"] = moe_ffn_axes()
        elif cfg.d_ff > 0:
            p["ffn"] = {"ln": ("embed",), "w1": ("embed", "mlp"),
                        "w2": ("mlp", "embed")}
            if is_gated_act(cfg.act):
                p["ffn"]["w3"] = ("embed", "mlp")
        return p

    axes: Dict[str, Any] = {}
    if cfg.modality == "audio":
        axes["frontend"] = (None, "embed")
    else:
        axes["embed"] = ("vocab", "embed")
    if cfg.modality == "vision":
        axes["vis_proj"] = (None, "embed")
    axes["layers"] = [layer(layer_kind(cfg, n)) for n in range(cfg.n_layers)]
    axes["final_ln"] = ("embed",)
    if not cfg.tie_embeddings:
        axes["head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# Blocks (full sequence)
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# On a device mesh (serving and training every config)
# ---------------------------------------------------------------------------

_HEADS_HINT = ("batch", None, "model", None)
_STREAM_HINT = ("batch", None, None)


def on_mesh(mesh):
    """The context a model call runs in: on a mesh, plain tensors (the
    positions, masks and constants) join DTensor ops as replicated.  The
    backward of ``forward_train``'s loss runs in it too: its saved
    constants meet DTensor gradients there, and its recomputed layers
    replay the forward."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _on_local_heads(fn, q, k, v, mesh):
    """``fn(q, k, v)``, an attention over (B, S, heads, Dh), on each
    rank's local heads: q, k, v hinted to ("batch", None, "model", None),
    so a rank holds H / tp query heads and the KH / tp KV heads they read.
    One KV head (recurrentgemma's MQA) does not split: a rank runs its
    H / tp query heads against it whole, as the reference's partitioner
    places them, and its gradient is each rank's partial sum over
    "model".  Where ``safe_spec`` leaves more KV heads whole (KH does not
    divide the "model" axis), the query heads are left whole too, and
    ``fn`` runs on all heads.  The flash kernel (self-attention) and the
    plain ``attention`` (a CROSS layer's, keys from the patch memory) both
    run here."""
    from torch.distributed.tensor import Partial
    q, k, v = (shard_hint(t, mesh, _HEADS_HINT) for t in (q, k, v))
    model = model_dim(mesh)
    if k.placements[model] != q.placements[model]:
        if k.shape[2] == 1:
            kv_grad = list(k.placements)
            kv_grad[model] = Partial()
            return local_call(fn, mesh, (q, k, v), list(q.placements),
                              grads=(None, kv_grad, kv_grad))
        q = over_model(q, mesh, None)
    return local_call(fn, mesh, (q, k, v), list(q.placements))


def _self_attn(x, p, cfg, *, positions, window, mesh=None):
    """Causal unless the model is encoder-only.  On a mesh, q, k, v and o
    are hinted to ("batch", None, "model", None), where the reference
    hints them."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B, S, _ = h.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = shard_hint(split_heads(dense(h, p["wq"]), (B, S, H, Dh)), mesh,
                   _HEADS_HINT)
    k = shard_hint(split_heads(dense(h, p["wk"]), (B, S, KH, Dh)), mesh,
                   _HEADS_HINT)
    v = shard_hint(split_heads(dense(h, p["wv"]), (B, S, KH, Dh)), mesh,
                   _HEADS_HINT)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    # the CUDA kernel on the GPU, its plain version on the CPU
    fn = functools.partial(flash_attention, causal=not cfg.encoder_only,
                           window=window)
    o = _on_local_heads(fn, q, k, v, mesh) if is_dtensor(q) else fn(q, k, v)
    o = shard_hint(o, mesh, _HEADS_HINT)
    return x + dense(merge_heads(o, (B, S, H * Dh)), p["wo"]), (k, v)


def _gated_out(x, p, o):
    """x + tanh(gate) * (o @ wo), the gate cast to x's dtype first.  On a
    mesh the scalar gate is replicated; its gradient, a sum over every
    rank's rows, is reduced over them where the train step brings it to
    the gate's placements."""
    B, S, H, Dh = o.shape
    o = dense(merge_heads(o, (B, S, H * Dh)), p["wo"])
    return x + torch.tanh(p["gate"].to(x.dtype)) * o


def _cross_attn(x, p, cfg, *, memory, mesh=None):
    """Gated cross-attention: queries from the normed x, keys and values
    from ``memory`` (B, P, d), no mask and no rotary embedding.  The plain
    ``attention`` computes it (the flash kernel takes S_k = S_q only), as
    the reference computes it outside its Pallas kernel; on a mesh on each
    rank's local heads (``_on_local_heads``), q, k and v hinted as
    ``_self_attn`` hints them.  Returns (x, (k, v)), the memory's keys and
    values for the decode cache."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B, S, _ = h.shape
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    P = memory.shape[1]
    q = shard_hint(split_heads(dense(h, p["wq"]), (B, S, H, Dh)), mesh,
                   _HEADS_HINT)
    k = shard_hint(split_heads(dense(memory, p["wk"]), (B, P, KH, Dh)),
                   mesh, _HEADS_HINT)
    v = shard_hint(split_heads(dense(memory, p["wv"]), (B, P, KH, Dh)),
                   mesh, _HEADS_HINT)
    fn = functools.partial(attention, causal=False)
    o = _on_local_heads(fn, q, k, v, mesh) if is_dtensor(q) else fn(q, k, v)
    o = shard_hint(o, mesh, _HEADS_HINT)
    return _gated_out(x, p, o), (k, v)


def _decode_cross_attn(x, p, cfg, cache, mesh=None):
    """One token's cross-attention against the cached memory keys and
    values (cast to x's dtype, as the reference does); the cache is
    read only.  On a mesh, ``decode_attend_on_mesh`` in its read-only
    mode: over a sequence-sharded cache (``cache_specs``' choice from 1024
    patches) each rank attends its own patches with all heads and the
    partials are combined; a feature-sharded one is gathered whole."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    B = h.shape[0]
    q = split_heads(dense(h, p["wq"]), (B, 1, cfg.n_heads, cfg.head_dim))
    ck, cv = (cache[name].to(x.dtype) for name in ("ck", "cv"))
    if mesh is None:
        o = attention(q, ck, cv, causal=False)
    else:
        o = decode_attend_on_mesh(q, None, None, ck, cv, None, None, mesh)
    return _gated_out(x, p, o), cache


def _apply_ffn(x, p, cfg, moe_dispatch, mesh=None):
    """Returns (x, aux): the MoE load-balancing loss, 0.0 for a dense MLP.
    On a mesh an MoE block's output is left a partial sum over "model",
    which the caller's stream hint reduces."""
    if cfg.is_moe:
        return moe_block(x, p, cfg, dispatch=moe_dispatch, mesh=mesh)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + gated_mlp(h, p, cfg.act), 0.0


def _apply_layer(x, memory, layer, kind, cfg, positions, moe_dispatch,
                 collect_kv: bool, mesh=None):
    """Returns (x, aux, (k, v) or recurrent state or None).  On a mesh the
    residual stream is held to ("batch", None, None) after each block:
    the "model" ranks' partial sums of ``wo`` and ``w2`` are all-reduced
    there, as Megatron's tensor parallelism does, where DTensor left to
    itself shards the stream and moves the MLP's wider activations."""
    if kind in _RECURRENT:
        out = _APPLY_RECURRENT[kind](x, layer["mix"], cfg,
                                     return_state=collect_kv, mesh=mesh)
        x, kv = out if collect_kv else (out, None)
    elif kind == CROSS:
        x, kv = _cross_attn(x, layer["mix"], cfg, memory=memory, mesh=mesh)
    else:
        x, kv = _self_attn(x, layer["mix"], cfg, positions=positions,
                           window=_window_for(kind, cfg), mesh=mesh)
    x = shard_hint(x, mesh, _STREAM_HINT)
    aux = 0.0
    if "ffn" in layer:
        x, aux = _apply_ffn(x, layer["ffn"], cfg, moe_dispatch, mesh)
        x = shard_hint(x, mesh, _STREAM_HINT)
    return x, aux, kv


# matrix products without batch dims: what the reference's "dots" policy
# (``dots_with_no_batch_dims_saveable``) keeps; ``x @ w`` with a 2-D weight
# dispatches to one of these
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _stack_forward(params, cfg, x, memory, positions, moe_dispatch, *,
                   collect_kv: bool = False, remat: str = "none",
                   mesh=None):
    """Runs every layer in depth order; ``memory`` (a vision model's
    projected patches, else None) feeds the CROSS layers; ``mesh``, the
    layers' hints and local pieces.

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
        args = (x, memory, layer, layer_kind(cfg, n), cfg, positions,
                moe_dispatch, collect_kv, mesh)
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
    if is_dtensor(tokens):
        # placed on a mesh by the caller: made whole for the lookup, which
        # DTensor takes into a vocab-sharded table only with whole ids
        from torch.distributed.tensor import Replicate
        mesh = tokens.device_mesh
        return tokens.redistribute(mesh, [Replicate()] * mesh.ndim).long()
    return torch.as_tensor(tokens, device=device).long()


def _batch_tensor(t, device, mesh=None) -> torch.Tensor:
    """A batch entry as a tensor on ``device``; on a mesh a DTensor placed
    by ``sharding.batch_specs`` (labels and masks stay batch-sharded, as
    the hidden states are), or as the caller placed it."""
    if mesh is None:
        return torch.as_tensor(t, device=device)
    return distribute_batch(t, mesh)


def _embed_tokens(params, cfg, tokens):
    dt = torch_dtype(cfg.dtype)
    x = F.embedding(tokens, gathered(params["embed"]))
    if is_dtensor(x):
        # redistribute's backward brings the gradient back whole (its
        # partial sums over "model" reduced): the masked lookup's backward
        # takes no partial sums
        x = reduce_partials(x)
        x = x.redistribute(x.device_mesh, x.placements)
    x = x.to(dt)
    if cfg.tie_embeddings:
        # sqrt(d) rounded to the activation dtype first, as the reference
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def _project(inputs, w, dt, device, mesh=None):
    """Frontend embeddings (B, n, frontend_dim) @ w, in the activation
    dtype (inputs rounded to it first, as the reference does).  On a mesh
    the inputs are placed by ``sharding.batch_specs`` (or as the caller
    placed them), ``w`` is gathered over the data axes at use
    (``dense``), and the product is hinted to ("batch", None, None)."""
    x = _batch_tensor(inputs, device, mesh).to(dt)
    return shard_hint(dense(x, w), mesh, _STREAM_HINT)


def _embed(params, cfg, batch, device, mesh=None):
    """(x: (B, S, d) activations, memory: (B, P, d) or None) of a batch:
    audio frames through the frontend, else tokens through the embedding;
    a vision model's patches through ``vis_proj``."""
    dt = torch_dtype(cfg.dtype)
    if cfg.modality == "audio":
        x = _project(batch["frames"], params["frontend"], dt, device, mesh)
    else:
        x = _embed_tokens(params, cfg, _tokens(batch["tokens"], device))
    memory = None
    if cfg.modality == "vision":
        memory = _project(batch["patches"], params["vis_proj"], dt, device,
                          mesh)
    return x, memory


def _unembed(x, params, cfg):
    if cfg.tie_embeddings:
        return F.linear(x, params["embed"].to(x.dtype))
    return x @ params["head"].to(x.dtype)


def _prepare(params, cfg, device) -> torch.device:
    """The device the call runs on; raises if the params lie elsewhere
    (checked on ``final_ln``, which every model has)."""
    check_supported(cfg)
    device = resolve_device(device)
    check_on_device(params["final_ln"], device, "params")
    return device


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _head_matrix(params, cfg):
    """The unembedding as (d, V), float32 in training."""
    return params["embed"].t() if cfg.tie_embeddings else params["head"]


def _chunk_loss(xc, head, lc, mc, z_weight: float):
    return _xent_sums((xc @ head).float(), lc, mc, z_weight)


def _xent_sums(logits, lc, mc, z_weight: float):
    """(summed nll + z-loss, summed weight, summed hits) of a chunk's
    float32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    nll = (lse - gold) * mc
    zl = z_weight * torch.sum(torch.square(lse) * mc)
    correct = torch.sum((torch.argmax(logits, dim=-1) == lc) * mc)
    return torch.sum(nll) + zl, torch.sum(mc), correct


def _vocab_parallel_sums(logits, lc, mc, z_weight: float, group, v0: int,
                         vocab: int):
    """``_xent_sums`` of a rank's columns [v0, v0 + local) of a chunk's
    logits, combined over ``group``, the "model" ranks that hold the
    others: the row max, the sum of exponentials, the gold logit and the
    first column of the row max (``argmax``'s tie rule) are reduced over
    it, so no rank holds a row of the whole vocabulary."""
    from torch.distributed import _functional_collectives as funcol
    n = logits.shape[-1]
    m = funcol.wait_tensor(funcol.all_reduce(logits.detach().amax(-1),
                                             "max", group))
    lse = m + torch.log(sum_over_ranks(
        torch.sum(torch.exp(logits - m[..., None]), -1), group))
    local = lc - v0
    here = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = sum_over_ranks(gold * here, group)
    first = torch.where(logits.detach().amax(-1) == m,
                        logits.detach().argmax(-1) + v0, vocab)
    first = funcol.wait_tensor(funcol.all_reduce(first, "min", group))
    nll = (lse - gold) * mc
    zl = z_weight * torch.sum(torch.square(lse) * mc)
    correct = torch.sum((first == lc) * mc)
    return torch.sum(nll) + zl, torch.sum(mc), correct


def _mesh_chunk_loss(xc, head, lc, mc, z_weight: float):
    """``_chunk_loss`` on a mesh: the logits batch-sharded and, where the
    head is, vocab-sharded over "model"; each rank's sums over its rows
    (``_vocab_parallel_sums`` across the "model" ranks), partial over the
    batch-sharded mesh dims."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = xc.device_mesh
    logits = shard_hint((xc @ head).float(), mesh, ("batch", None, "model"))
    lc, mc = (shard_hint(t, mesh, ("batch", None)) for t in (lc, mc))
    model = mesh.mesh_dim_names.index("model")
    fn = functools.partial(_xent_sums, z_weight=z_weight)
    if logits.placements[model].is_shard() and mesh.size(model) > 1:
        n = logits.shape[-1] // mesh.size(model)
        fn = functools.partial(
            _vocab_parallel_sums, z_weight=z_weight,
            group=mesh.get_group("model"),
            v0=mesh.get_local_rank("model") * n, vocab=logits.shape[-1])
    out = [Partial() if p.is_shard() and i != model else Replicate()
           for i, p in enumerate(logits.placements)]
    return local_map(fn, out_placements=(out, out, out),
                     in_placements=tuple(tuple(t.placements)
                                         for t in (logits, lc, mc)),
                     device_mesh=mesh)(logits, lc, mc)


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
    chunk_loss = _chunk_loss
    if is_dtensor(x):
        # the head whole over the data axes (FSDP's gather, once a loss)
        # and vocab-sharded over "model"
        head = shard_hint(head, x.device_mesh, (None, "model"))
        chunk_loss = _mesh_chunk_loss
    labels = labels.long()
    # like the labels: batch-sharded on a mesh
    mask = torch.ones_like(labels, dtype=torch.float32) if mask is None \
        else mask.float()
    sums = [torch.zeros((), device=x.device)] * 3     # loss, weight, hits

    def add(s0, s1):
        parts = checkpoint(chunk_loss, x[:, s0:s1], head, labels[:, s0:s1],
                           mask[:, s0:s1], z_weight, use_reentrant=False)
        sums[:] = [a + b for a, b in zip(sums, parts)]
    # the whole chunks (``flops.loop``: one chunk times their number under
    # a FlopCounter), then the remainder
    for i in flops.loop(S // chunk):
        add(i * chunk, (i + 1) * chunk)
    if S % chunk:
        add(S - S % chunk, S)
    tot, cnt, cor = sums
    den = torch.clamp(cnt, min=1.0)
    return tot / den, cor / den


def forward_train(params, cfg: ArchConfig, batch, *,
                  moe_dispatch: str = "einsum", aux_weight: float = 0.01,
                  device=None, mesh=None):
    """Training forward: next-token LM loss, or an audio model's masked
    prediction.  batch: tokens and labels (B, S) (plus patches for
    vision), or frames, cluster-id labels and the (B, S) mask of the
    frames to predict (audio); a text batch may carry a mask too.

    Layers are recomputed in the backward as ``cfg.remat`` says.  Returns
    (total, {"nll", "aux", "acc"}); total adds ``aux_weight * aux /
    n_layers`` to the loss for an MoE model, as the reference does.

    ``mesh``: as ``forward_logits``'s, with the batch placed by
    ``sharding.batch_specs`` (``launch.steps.place_batch``); the hidden
    states, labels and mask stay batch-sharded, the flash kernel and its
    backward run on each rank's heads, and the loss and metrics come back
    as replicated 0-dim DTensors."""
    device = _prepare(params, cfg, device)
    with on_mesh(mesh):
        labels = _batch_tensor(batch["labels"], device, mesh).long()
        x, memory = _embed(params, cfg, batch, device, mesh)
        x = shard_hint(x, mesh, ("batch", None, None))
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux, _ = _stack_forward(params, cfg, x, memory, positions,
                                   moe_dispatch, remat=cfg.remat, mesh=mesh)
        if not is_dtensor(aux):     # on a mesh: replicated, from the MoE
            aux = torch.as_tensor(aux, dtype=torch.float32, device=x.device)
        x = rms_norm(x, params["final_ln"], cfg.norm_eps)
        mask = batch.get("mask")
        if mask is not None:
            mask = _batch_tensor(mask, x.device, mesh)
        loss, acc = softmax_xent_from_hidden(x, _head_matrix(params, cfg),
                                             labels, mask)
        if mesh is not None:        # the batch's partial sums reduced
            loss, acc = reduce_partials(loss), reduce_partials(acc)
    total = loss + aux_weight * aux / cfg.n_layers if cfg.is_moe else loss
    return total, {"nll": loss, "aux": aux, "acc": acc}


def forward_logits(params, cfg: ArchConfig, batch, *,
                   moe_dispatch: str = "einsum", device=None, mesh=None):
    """Full-sequence logits (no cache): eval, tests, and an audio model's
    encoding.  batch as ``forward_train``'s, without labels.

    ``mesh``: a ``DeviceMesh`` ("data", "model") or ("pod", "data",
    "model") on which ``params`` lie as DTensors
    (``distributed.sharding.distribute_tree``); the activations are
    hinted where the reference hints them, and the logits come back as a
    DTensor, batch-sharded and whole over the vocabulary.  The text
    decoders, the vision model (its patch memory batch-sharded, each CROSS
    layer on a rank's local heads) and the audio encoder (its frames
    batch-sharded, the flash kernel not causal)."""
    device = _prepare(params, cfg, device)
    with on_mesh(mesh):
        x, memory = _embed(params, cfg, batch, device, mesh)
        x = shard_hint(x, mesh, ("batch", None, None))
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, _ = _stack_forward(params, cfg, x, memory, positions,
                                 moe_dispatch, mesh=mesh)
        x = rms_norm(x, params["final_ln"], cfg.norm_eps)
        return shard_hint(_unembed(x, params, cfg), mesh,
                          ("batch", None, None))


def _cache_len(kind: str, cfg: ArchConfig, ctx_len: int) -> int:
    w = _window_for(kind, cfg)
    return min(ctx_len, w) if w else ctx_len


def init_cache(cfg: ArchConfig, B: int, ctx_len: int, *, device=None):
    """Zeroed decode cache: {"layers": [{"k", "v": (B, L, KH, Dh)},
    {"ck", "cv": (B, n_patches, KH, Dh)} for a CROSS layer, or a
    recurrent layer's state, ...]}: RG-LRU {"h": (B, D) float32, "conv":
    (B, CONV_K - 1, D)}, mLSTM {"C", "n", "m" float32, "conv"}, sLSTM
    {"h", "c", "n", "m" float32, "conv"} (``repro_torch.models.xlstm``).

    k, v, ck, cv and conv are bf16 whatever ``cfg.dtype`` is, as in the
    reference; ``prefill`` makes k, v, ck and cv in ``cfg.dtype`` (conv
    stays bf16).  An encoder-only model gets the plain k/v cache, as the
    reference builds it, though it has no decode step."""
    check_supported(cfg)
    device = resolve_device(device)
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    layers = []
    for n in range(cfg.n_layers):
        kind = layer_kind(cfg, n)
        if kind in _RECURRENT:
            layers.append(_INIT_RECURRENT[kind](cfg, B, device=device))
            continue
        if kind == CROSS:
            names, L = ("ck", "cv"), cfg.n_patches
        else:
            names, L = ("k", "v"), _cache_len(kind, cfg, ctx_len)
        layers.append({name: torch.zeros((B, L, KH, Dh),
                                         dtype=torch.bfloat16, device=device)
                       for name in names})
    return {"layers": layers}


def decode_step(params, cfg: ArchConfig, tokens, pos: int, cache, *,
                moe_dispatch: str = "einsum", device=None, mesh=None):
    """One new token against the cache.  tokens: (B, 1); pos: int.

    Returns (logits: (B, V), cache).  The cache's tensors, attention k/v
    and recurrent state alike, are updated in place; the returned cache
    holds the same tensors.  A CROSS layer reads its ``ck``/``cv``, which
    ``prefill`` filled from the patches.  An encoder-only (audio) model
    has no decode step: ValueError, as in the reference.

    ``mesh``: as ``forward_logits``'s; the cache is then ``prefill``'s on
    that mesh, placed by ``distributed.sharding.cache_specs`` (a cache of
    1024 slots or more sequence-sharded over "model"), and each
    attention layer's write and read run on the ranks' own slices
    (``models.layers.decode_attention_block``); a CROSS layer reads its
    ck/cv there without writing (``decode_attend_on_mesh``).
    """
    if cfg.modality == "audio":
        raise ValueError(f"{cfg.name}: encoder-only arch has no decode step")
    device = _prepare(params, cfg, device)
    pos = int(pos)
    with on_mesh(mesh):
        x = _embed_tokens(params, cfg, _tokens(tokens, device))
        x = shard_hint(x, mesh, ("batch", None, None))
        layers = []
        for n, layer in enumerate(params["layers"]):
            kind = layer_kind(cfg, n)
            if kind in _RECURRENT:
                x, new = _DECODE_RECURRENT[kind](x, layer["mix"], cfg,
                                                 cache["layers"][n],
                                                 mesh=mesh)
            elif kind == CROSS:
                x, new = _decode_cross_attn(x, layer["mix"], cfg,
                                            cache["layers"][n], mesh=mesh)
            else:
                x, new = decode_attention_block(
                    x, layer["mix"], cfg, cache["layers"][n], pos,
                    window=_window_for(kind, cfg), mesh=mesh)
            layers.append(new)
            x = shard_hint(x, mesh, _STREAM_HINT)
            if "ffn" in layer:
                x, _ = _apply_ffn(x, layer["ffn"], cfg, moe_dispatch, mesh)
                x = shard_hint(x, mesh, _STREAM_HINT)
        x = rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = shard_hint(_unembed(x, params, cfg)[:, 0], mesh,
                            ("batch", None))
    return logits, {"layers": layers}


def prefill(params, cfg: ArchConfig, batch, *,
            cache_len: Optional[int] = None, moe_dispatch: str = "einsum",
            device=None, mesh=None):
    """Full-context forward that also materialises the decode cache.

    Returns (last_token_logits: (B, V), cache).  Each self-attention
    layer's cache is sized ``cache_len`` (default: context length), or its
    window when smaller, and holds the (windowed, ring-rotated)
    keys/values in ``cfg.dtype``; a CROSS layer's holds the patch memory's
    keys and values (``ck``, ``cv``) in ``cfg.dtype``; a recurrent layer's
    is its state after the last token, as the reference keeps it.

    ``mesh``: as ``forward_logits``'s; the cache's tensors are then
    DTensors placed by ``distributed.sharding.cache_specs``, as
    ``decode_step`` takes them.
    """
    device = _prepare(params, cfg, device)
    with on_mesh(mesh):
        return _prefill(params, cfg, batch, cache_len, moe_dispatch, device,
                        mesh)


def _prefill(params, cfg, batch, cache_len, moe_dispatch, device, mesh):
    x, memory = _embed(params, cfg, batch, device, mesh)
    x = shard_hint(x, mesh, ("batch", None, None))
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, _, kvs = _stack_forward(params, cfg, x, memory, positions,
                               moe_dispatch, collect_kv=True, mesh=mesh)
    x = rms_norm(x[:, -1], params["final_ln"], cfg.norm_eps)
    logits = shard_hint(_unembed(x, params, cfg), mesh, ("batch", None))

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
        if kind in _RECURRENT:          # the state dict, verbatim
            layers.append(kv if mesh is None else {
                name: _place_cache(t, mesh) for name, t in kv.items()})
            continue
        if kind == CROSS:
            ck, cv = (t.to(dt).contiguous() for t in kv)
            layers.append({"ck": ck, "cv": cv} if mesh is None else {
                "ck": _place_cache(ck, mesh), "cv": _place_cache(cv, mesh)})
            continue
        L = _cache_len(kind, cfg, L_default)
        if mesh is None:
            layers.append({"k": fit(kv[0], L), "v": fit(kv[1], L)})
        else:   # fit each rank's heads (S is whole), then place the cache
            layers.append({
                name: _place_cache(local_call(functools.partial(fit, L=L),
                                              mesh, (t,),
                                              list(t.placements)), mesh)
                for name, t in zip(("k", "v"), kv)})
    return logits, {"layers": layers}


def _place_cache(t, mesh):
    """A cache tensor redistributed to ``cache_specs``' placements."""
    spec = cache_specs([tuple(t.shape)], mesh)[0]
    return t.redistribute(mesh, placements(mesh, spec, t.shape))
