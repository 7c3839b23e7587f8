"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
PyTorch port of ``repro/models/rglru.py``.

The temporal mixer is a diagonal gated linear recurrence

    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))          (in (0, 1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), i_t = sigmoid(W_x x_t)

Over a full sequence it runs through the RG-LRU scan kernel
(``repro_torch.kernels.rglru_scan``) on the GPU and its plain version on
the CPU; a decode step runs it one step at a time in plain PyTorch, as the
reference does.  The block follows Griffin: a GELU gate branch and a
recurrent branch (causal conv4 -> RG-LRU), merged elementwise, then the
output projection.  The MLP sublayer lives in ``transformer.py``.

Numerics follow the reference where they are not obvious: the gates are
float32 even in a bf16 model (``b_a`` and ``b_i`` are float32 and promote
the sum; over a sequence the scan adds them to the bf16 products itself),
and the conv lag buffer of the decode state is stored in bf16
whatever ``cfg.dtype`` is, so a float32 model's prefill + decode differs
from its full forward by that rounding, as the reference's does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru_scan.ops import rglru as rglru_scan
from repro_torch.kernels.rglru_scan.ref import (RGLRU_C, reference_rglru,
                                                rglru_gates)
from repro_torch.models.layers import act_fn, dense, rms_norm
from repro_torch.models.xlstm import CONV_K, causal_conv1d, conv1d_decode

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


def apply_rglru(x, p, cfg, *, return_state: bool = False):
    """Full-sequence Griffin recurrent block. x: (B, S, d).

    Returns the block's output, and with ``return_state`` also the decode
    state {"h": (B, D) float32, "conv": (B, CONV_K - 1, D) bf16}."""
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


def decode_rglru(x, p, cfg, state):
    """One-token Griffin recurrent step. x: (B, 1, d).

    Returns (out, state): ``state``'s tensors are updated in place (the new
    h, and the lag buffer shifted by one token, rounded to bf16)."""
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
