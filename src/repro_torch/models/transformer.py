"""Dense decoder stack of the model zoo (PyTorch port of
``repro/models/transformer.py``).

This slice covers the dense block kinds: ATTN / SWA / LOCAL self-attention
with a gated (or plain) MLP.  MoE, RG-LRU, mLSTM, sLSTM, cross-attention
and the audio encoder raise ``NotImplementedError`` naming the slice that
ports them.

Layouts differ from the JAX package in one way: where JAX stacks the layers
of each pattern position under ``params["blocks"]`` (leading
``n_scan_blocks`` dim, for ``lax.scan``) plus a ``tail`` list, the port
keeps one dict per layer in depth order, ``params["layers"][n]``, of kind
``block_pattern[n % pattern_period]``.  ``repro_torch.convert`` maps
between the two.  The decode cache follows the same per-layer layout.

Public API:
  init_params(cfg, seed, device=)                  -> params
  forward_logits(params, cfg, batch, device=)      -> (B, S, V) logits
  prefill(params, cfg, batch, cache_len=, device=) -> (last_logits, cache)
  decode_step(params, cfg, tokens, pos, cache, device=) -> (logits, cache)
  init_cache(cfg, B, ctx_len, device=)             -> cache (zeros)
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import check_on_device, resolve_device, torch_dtype
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.config import (ATTN, SWA, LOCAL, CROSS, MLSTM, SLSTM,
                                       RGLRU, ArchConfig)
from repro_torch.models.layers import (decode_attention_block, dense,
                                       gated_mlp, is_gated_act, rms_norm,
                                       rope)

_SELF_ATTN = (ATTN, SWA, LOCAL)
_LATER_SLICE = {
    CROSS: "the cross-attention (vision) slice",
    MLSTM: "the xLSTM slice (mlstm_scan kernel)",
    SLSTM: "the xLSTM slice",
    RGLRU: "the Griffin slice (rglru_scan kernel)",
}


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for what this slice of the port lacks."""
    if cfg.modality == "audio" or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name}: the audio encoder is ported in a later slice")
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are ported in the MoE slice "
            f"(moe_gmm kernel)")
    for kind in cfg.block_pattern:
        if kind not in _SELF_ATTN:
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

def init_params(cfg: ArchConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights with the JAX init's shapes and scales.

    Drawn in float32 from a ``torch.Generator`` seeded with ``seed`` on the
    target device, then stored in ``cfg.dtype`` (the reference keeps
    float32 weights and casts them at use; full-width serving reads half
    the bytes this way).  The numbers differ from ``jax.random``'s; parity
    tests convert JAX params instead.  On the ``meta`` device nothing is
    drawn or allocated.
    """
    check_supported(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * std).to(dt)

    def lin(m, n, scale=1.0):
        return normal((m, n), scale / math.sqrt(m))

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dt)

    d, H, KH, Dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    out_scale = 1.0 / math.sqrt(2 * cfg.n_layers)

    def layer():
        p = {"mix": {"ln": zeros(d), "wq": lin(d, H * Dh),
                     "wk": lin(d, KH * Dh), "wv": lin(d, KH * Dh),
                     "wo": lin(H * Dh, d, out_scale)}}
        if f > 0:
            p["ffn"] = {"ln": zeros(d), "w1": lin(d, f),
                        "w2": lin(f, d, out_scale)}
            if is_gated_act(cfg.act):
                p["ffn"]["w3"] = lin(d, f)
        return p

    # std d^-1/2: lookups are rescaled by sqrt(d) when tied, and the tied
    # head then produces O(1) logits (MiniCPM-style mup scaling)
    params: Dict[str, Any] = {
        "embed": normal((cfg.vocab_size, d), d ** -0.5)}
    params["layers"] = [layer() for _ in range(cfg.n_layers)]
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


def _apply_ffn(x, p, cfg):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + gated_mlp(h, p, cfg.act)


def _stack_forward(params, cfg, x, positions, *, collect_kv: bool = False):
    """Runs every layer in depth order. Returns (x, [(k, v)] or None)."""
    kvs: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = \
        [] if collect_kv else None
    for n, layer in enumerate(params["layers"]):
        kind = layer_kind(cfg, n)
        x, kv = _self_attn(x, layer["mix"], cfg, positions=positions,
                           window=_window_for(kind, cfg))
        if kvs is not None:
            kvs.append(kv)
        if "ffn" in layer:
            x = _apply_ffn(x, layer["ffn"], cfg)
    return x, kvs


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

def forward_logits(params, cfg: ArchConfig, batch, *, device=None):
    """Full-sequence logits (no cache) — used by eval / tests."""
    tokens = _prepare(params, cfg, batch["tokens"], device)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _stack_forward(params, cfg, x, positions)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(x, params, cfg)


def _cache_len(kind: str, cfg: ArchConfig, ctx_len: int) -> int:
    w = _window_for(kind, cfg)
    return min(ctx_len, w) if w else ctx_len


def init_cache(cfg: ArchConfig, B: int, ctx_len: int, *, device=None):
    """Zeroed decode cache: {"layers": [{"k", "v": (B, L, KH, Dh)}, ...]}.

    bf16 whatever ``cfg.dtype`` is, as in the reference; ``prefill`` makes
    its cache in ``cfg.dtype``."""
    check_supported(cfg)
    device = resolve_device(device)
    KH, Dh = cfg.n_kv_heads, cfg.head_dim
    layers = []
    for n in range(cfg.n_layers):
        L = _cache_len(layer_kind(cfg, n), cfg, ctx_len)
        layers.append({
            "k": torch.zeros((B, L, KH, Dh), dtype=torch.bfloat16,
                             device=device),
            "v": torch.zeros((B, L, KH, Dh), dtype=torch.bfloat16,
                             device=device)})
    return {"layers": layers}


def decode_step(params, cfg: ArchConfig, tokens, pos: int, cache, *,
                device=None):
    """One new token against the cache.  tokens: (B, 1); pos: int.

    Returns (logits: (B, V), cache).  The cache's tensors are updated in
    place; the returned cache holds the same tensors.
    """
    tokens = _prepare(params, cfg, tokens, device)
    pos = int(pos)
    x = _embed(params, cfg, tokens)
    layers = []
    for n, layer in enumerate(params["layers"]):
        w = _window_for(layer_kind(cfg, n), cfg)
        x, new = decode_attention_block(x, layer["mix"], cfg,
                                        cache["layers"][n], pos, window=w)
        layers.append(new)
        if "ffn" in layer:
            x = _apply_ffn(x, layer["ffn"], cfg)
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _unembed(x, params, cfg)[:, 0], {"layers": layers}


def prefill(params, cfg: ArchConfig, batch, *,
            cache_len: Optional[int] = None, device=None):
    """Full-context forward that also materialises the decode cache.

    Returns (last_token_logits: (B, V), cache).  Each layer's cache is sized
    ``cache_len`` (default: context length), or its window when smaller, and
    holds the (windowed, ring-rotated) keys/values in ``cfg.dtype``.
    """
    tokens = _prepare(params, cfg, batch["tokens"], device)
    x = _embed(params, cfg, tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    x, kvs = _stack_forward(params, cfg, x, positions, collect_kv=True)
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
    for n, (k, v) in enumerate(kvs):
        L = _cache_len(layer_kind(cfg, n), cfg, L_default)
        layers.append({"k": fit(k, L), "v": fit(v, L)})
    return logits, {"layers": layers}
