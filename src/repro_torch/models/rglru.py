"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
PyTorch port of ``repro/models/rglru.py``.

The temporal mixer is a diagonal gated linear recurrence

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))          (in (0, 1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), i_t = sigmoid(W_x x_t)

Over a full sequence it runs through the RG-LRU scan kernel
(``repro_torch.kernels.rglru_scan``) on the GPU and its plain version on
the CPU; a decode step runs it one step at a time in plain PyTorch, as the
reference does.  On a device mesh (``mesh=``) the block runs on each
rank's channels (``_apply_rglru_on_mesh``).  The block follows Griffin: a
GELU gate branch and a recurrent branch (causal conv4 -> RG-LRU), merged
elementwise, then the output projection.  The MLP sublayer lives in
``transformer.py``.

Numerics follow the reference where they are not obvious: the gates are
float32 even in a bf16 model (``b_a`` and ``b_i`` are float32 and promote
the sum; over a sequence the scan adds them to the bf16 products itself),
and the conv lag buffer of the decode state is stored in bf16
whatever ``cfg.dtype`` is, so a float32 model's prefill + decode differs
from its full forward by that rounding, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.rglru_scan.ops import rglru as rglru_scan
from repro_torch.kernels.rglru_scan.ref import (RGLRU_C, reference_rglru,
                                                rglru_gates)
from repro_torch.models.layers import (act_fn, dense, gather_last, gathered,
                                       local_call, model_group, model_rank,
                                       rms_norm, rows_grad, shard_hint)
from repro_torch.models.xlstm import (CHANNELS, CONV_K, causal_conv1d,
                                      conv1d_decode, conv_on_channels,
                                      conv_step_on_channels, seq_dropped)

__all__ = ["RGLRU_C", "rglru", "rglru_decode", "d_rnn", "apply_rglru",
           "init_state_rglru", "decode_rglru"]

# the plain recurrence over a sequence: (x, lam, ga, gx, h0=None) ->
# (y (B, S, D) float32, h_last (B, D) float32)
rglru = reference_rglru


def rglru_decode(x_t, lam, gate_a, gate_x, h):
    """One-step RG-LRU. x_t, gates: (B, D); h: (B, D) float32 state.

    Returns (y, h_new), the same tensor twice."""
    a, b = rglru_gates(x_t, lam, gate_a, gate_x)
    h_new = a * h + b
    return h_new, h_new


def d_rnn(cfg) -> int:
    """Recurrent width; RecurrentGemma uses lru_width == d_model."""
    return cfg.d_model


def rglru_axes():
    """Logical axes of an RG-LRU block's leaves, as the reference's
    ``init_rglru`` gives them."""
    return {"ln": ("embed",), "w_x": ("embed", "rnn"),
            "w_g": ("embed", "rnn"), "conv_w": ("conv", "rnn"),
            "conv_b": ("rnn",), "lam": ("rnn",),
            "w_a": ("rnn", "rnn_out"), "b_a": ("rnn",),
            "w_i": ("rnn", "rnn_out"), "b_i": ("rnn",),
            "w_out": ("rnn", "embed")}


def apply_rglru(x, p, cfg, *, return_state: bool = False, mesh=None):
    """Full-sequence Griffin recurrent block. x: (B, S, d).

    Returns the block's output, and with ``return_state`` also the decode
    state {"h": (B, D) float32, "conv": (B, CONV_K - 1, D) bf16}.
    ``mesh``: x and ``p`` are DTensors on it (``_apply_rglru_on_mesh``)."""
    if mesh is not None and is_dtensor(x):
        return _apply_rglru_on_mesh(x, p, cfg, return_state, mesh)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xb_pre = dense(h_in, p["w_x"])
    gb = act_fn("gelu")(dense(h_in, p["w_g"]))     # the tanh approximation
    xb = causal_conv1d(xb_pre, p["conv_w"], p["conv_b"])
    # the CUDA kernel on the GPU, its plain version on the CPU; either adds
    # the float32 gate biases to the products itself, in float32
    y, h_last = rglru_scan(xb, p["lam"], dense(xb, p["w_a"]),
                           dense(xb, p["w_i"]), b_a=p["b_a"], b_i=p["b_i"])
    y = y.to(x.dtype) * gb
    out = x + dense(y, p["w_out"])
    if return_state:
        conv = xb_pre[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return out, {"h": h_last, "conv": conv}
    return out


def init_state_rglru(cfg, B: int, *, device=None):
    dr = d_rnn(cfg)
    return {"h": torch.zeros((B, dr), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, CONV_K - 1, dr), dtype=torch.bfloat16,
                                device=device)}


def decode_rglru(x, p, cfg, state, *, mesh=None):
    """One-token Griffin recurrent step. x: (B, 1, d).

    Returns (out, state): ``state``'s tensors are updated in place (the new
    h, and the lag buffer shifted by one token, rounded to bf16).
    ``mesh``: x, ``p`` and ``state`` are DTensors on it, the state placed
    by ``sharding.cache_specs`` (``_decode_rglru_on_mesh``)."""
    if mesh is not None and is_dtensor(x):
        return _decode_rglru_on_mesh(x, p, cfg, state, mesh)
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    xb = dense(h_in, p["w_x"])
    gb = act_fn("gelu")(dense(h_in, p["w_g"]))
    xb, conv_buf = conv1d_decode(xb, state["conv"].to(x.dtype),
                                 p["conv_w"], p["conv_b"])
    ga = dense(xb, p["w_a"]) + p["b_a"]
    gx = dense(xb, p["w_i"]) + p["b_i"]
    y, h_new = rglru_decode(xb, p["lam"], ga, gx, state["h"])
    y = y.to(x.dtype) * gb
    out = x + dense(y, p["w_out"])[:, None, :]
    state["h"].copy_(h_new)
    state["conv"].copy_(conv_buf)
    return out, state


# ---------------------------------------------------------------------------
# On a device mesh
# ---------------------------------------------------------------------------

def _apply_rglru_on_mesh(x, p, cfg, return_state, mesh):
    """``apply_rglru`` on each rank's D / tp channels (the "rnn" axis over
    "model", where D divides it; else every rank runs all D).

    x is the residual stream, batch-sharded and whole over "model".  The
    in-projections ``w_x``, ``w_g`` are column-split, so their outputs
    come out on the rank's channels; the depthwise conv and the scan are
    channel-local and run in ``local_map`` on the rank's pieces: the conv
    once, the ``rglru_scan`` kernel (forward, and backward under grad)
    once on (B / dp, S, D / tp) with the float32 biases fused.  ``w_a``
    and ``w_i`` are ("rnn", "rnn_out"), split by rows only (``safe_spec``
    drops "model" used twice), so ``xb @ w_a`` is a partial sum over
    "model", reduce-scattered to the rank's channels.  ``w_out`` is
    row-split: the block's output is a partial sum over "model", which the
    residual stream's hint after the block reduces.  The parameters read
    on a rank's batch rows (conv, lam, b_a, b_i) have gradients partial
    over the data axes."""
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xb_pre = shard_hint(dense(h_in, p["w_x"]), mesh, CHANNELS)
    gb = act_fn("gelu")(shard_hint(dense(h_in, p["w_g"]), mesh, CHANNELS))
    xb = conv_on_channels(xb_pre, p, mesh)
    place = list(xb.placements)
    # (B, S, D) partial sums over "model": reduce-scattered to channels
    ga, gx = (dense(xb, p[n]).redistribute(mesh, place)
              for n in ("w_a", "w_i"))
    lam, b_a, b_i = (gathered(p[n]) for n in ("lam", "b_a", "b_i"))

    def scan(xb, lam, ga, gx, b_a, b_i):
        return rglru_scan(*(t.contiguous() for t in (xb, lam, ga, gx)),
                          b_a=b_a.contiguous(), b_i=b_i.contiguous())
    y, h_last = local_call(
        scan, mesh, (xb, lam, ga, gx, b_a, b_i),
        (place, seq_dropped(place)),
        grads=(None, rows_grad(xb, lam), None, None, rows_grad(xb, b_a),
               rows_grad(xb, b_i)))
    y = y.to(x.dtype) * gb
    out = x + dense(y, p["w_out"])
    if return_state:
        conv = xb_pre[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return out, {"h": h_last, "conv": conv}
    return out


def _decode_rglru_on_mesh(x, p, cfg, state, mesh):
    """``decode_rglru`` on a rank's channels of the lag buffer, which
    ``cache_specs`` splits over "model" on its feature dim: the conv step
    writes the rank's columns in place; the gates and the recurrence run
    on them, and the new h (whole over "model" in the cache: (B, D) is
    batch-sharded only) is all-gathered and written by every rank."""
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    place = seq_dropped(state["conv"].placements)
    xb = dense(h_in, p["w_x"]).redistribute(mesh, place)
    gb = act_fn("gelu")(dense(h_in, p["w_g"]).redistribute(mesh, place))
    xb = conv_step_on_channels(xb, state["conv"], p, mesh)
    ga, gx = (dense(xb, p[n]).redistribute(mesh, place)
              for n in ("w_a", "w_i"))
    lam, b_a, b_i = (gathered(p[n]) for n in ("lam", "b_a", "b_i"))
    rank = model_rank(xb, mesh)
    group = model_group(xb, mesh)

    def step(xb, lam, ga, gx, b_a, b_i, h):
        n = xb.shape[-1]
        y, h_new = rglru_decode(xb, lam, ga + b_a, gx + b_i,
                                h[:, rank * n:(rank + 1) * n])
        h.copy_(gather_last(h_new, group))
        return y
    y = local_call(step, mesh, (xb, lam, ga, gx, b_a, b_i, state["h"]),
                   list(place))
    y = y.to(x.dtype) * gb
    out = x + dense(y, p["w_out"])[:, None, :]
    return out, state
