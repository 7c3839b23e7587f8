"""xLSTM blocks (PyTorch port of ``repro/models/xlstm.py``): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, strictly sequential),
after arXiv:2405.04517.

Over a full sequence the mLSTM runs through the chunkwise mLSTM kernel
(``repro_torch.kernels.mlstm_scan``) on the GPU and its plain version
(:func:`mlstm_chunkwise`) on the CPU; its decode step, the sLSTM, the
convolutions and the projections are plain PyTorch, as they are plain jnp
in the reference.  All recurrences are stabilised in log space (the ``m``
running-max trick of the paper).  On a device mesh (``mesh=``) the blocks
run on each rank's heads: see ``_apply_mlstm_on_mesh`` and
``_apply_slstm_on_mesh``.

Shapes follow the repo convention: activations (B, S, d); the mLSTM inner
width is ``MLSTM_PF * d`` split into ``n_heads`` heads of
``Dh = MLSTM_PF * d / n_heads`` (1024 at xlstm-1.3b, not ``cfg.head_dim``);
the sLSTM has ``n_heads`` heads of ``d / n_heads``.

Numerics follow the reference where they are not obvious:
  * the gate biases (``b_ig``, ``b_fg``; ``b_z``, ``b_i``, ``b_f``, ``b_o``)
    are float32, so the gate pre-activations are float32 sums in a bf16
    model, and the sLSTM reads its recurrent weights in float32;
  * the conv lag buffer of the decode state is stored in bf16 whatever
    ``cfg.dtype`` is, so a float32 model's prefill + decode differs from its
    full forward by that rounding, as the reference's does;
  * a prompt shorter than ``CONV_K - 1`` tokens leaves a lag buffer of as
    many rows, and the next decode step raises, as in the reference.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import flops
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.models.layers import (act_fn, all_reduce_sum, dense,
                                       gather_last, gathered, local_call,
                                       model_dim, model_group, model_rank,
                                       over_model, rms_norm, rows_grad,
                                       shard_hint)

MLSTM_PF = 2          # mLSTM up-projection factor (paper: 2)
SLSTM_PF = 4.0 / 3.0  # sLSTM post-MLP projection factor (paper: 4/3)
CONV_K = 4            # causal depthwise conv width
NEG_INF = -1e30       # the initial log-stabiliser m
CHANNELS = ("batch", None, "model")   # a (B, S, C) activation's hint on a mesh


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); b: (C,).

    K unrolled taps over a left-padded copy of ``x``, in ``x.dtype``, as the
    reference computes it (not ``F.conv1d``, which goes to cuDNN and, in
    float32, to TF32 by default)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    w = w.to(x.dtype)
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b.to(x.dtype)


def conv1d_decode(x_t, conv_buf, w, b):
    """One-step causal conv against a (B, K-1, C) lag buffer.

    Returns (out: (B, C), the new lag buffer: (B, K-1, C))."""
    xs = torch.cat([conv_buf, x_t[:, None, :]], dim=1)        # (B, K, C)
    out = torch.einsum("bkc,kc->bc", xs, w.to(x_t.dtype)) + b.to(x_t.dtype)
    return out, xs[:, 1:, :]


# ---------------------------------------------------------------------------
# mLSTM cell math
# ---------------------------------------------------------------------------

def _zero_state(B, H, Dh, device, dtype=torch.float32):
    kw = dict(dtype=dtype, device=device)
    return (torch.zeros((B, H, Dh, Dh), **kw), torch.zeros((B, H, Dh), **kw),
            torch.full((B, H), NEG_INF, **kw))


def mlstm_sequential(q, k, v, ig, fg, init_state=None, dtype=torch.float32):
    """Sequential oracle. q, k, v: (B, S, H, Dh); ig, fg: (B, S, H).

    Returns (h: (B, S, H, Dh), final state (C, n, m)), computed and returned
    in ``dtype`` (float32 as the reference; float64 gives ground truth for
    a float32 evaluation):
      m_t = max(lf_t + m_{t-1}, ig_t)
      C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(ig_t - m_t) k_t v_t^T
      n_t likewise;  h_t = C_t^T q_t / max(|n_t.q_t|, exp(-m_t))
    """
    B, S, H, Dh = q.shape
    qs = q.to(dtype) / math.sqrt(Dh)
    ks, vs = k.to(dtype), v.to(dtype)
    igs = ig.to(dtype)
    lf = F.logsigmoid(fg.to(dtype))           # forget gate = sigmoid, in log
    C, n, m = _zero_state(B, H, Dh, q.device, dtype) if init_state is None \
        else tuple(t.to(dtype) for t in init_state)
    hs = []
    for t in range(S):
        qt, kt, vt, it, ft = qs[:, t], ks[:, t], vs[:, t], igs[:, t], \
            lf[:, t]
        m_new = torch.maximum(ft + m, it)
        fgate = torch.exp(ft + m - m_new)[..., None]           # (B, H, 1)
        igate = torch.exp(it - m_new)[..., None]
        C = fgate[..., None] * C + igate[..., None] * (
            kt[..., :, None] * vt[..., None, :])               # (B, H, Dh, Dh)
        n = fgate * n + igate * kt
        num = torch.einsum("bhij,bhi->bhj", C, qt)
        den = torch.maximum(torch.einsum("bhi,bhi->bh", n, qt).abs(),
                            torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(num / den)
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunkwise(q, k, v, ig, fg, *, chunk: int = 64, init_state=None):
    """Chunkwise-parallel mLSTM (same math as :func:`mlstm_sequential`).

    Intra-chunk: masked quadratic attention with per-pair gate decays.
    Inter-chunk: the O(Dh^2) state carried from chunk to chunk.  As in the
    reference, ``chunk`` is halved until it divides S.  Returns (h, final
    state (C, n, m)), float32.
    """
    B, S, H, Dh = q.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    L, T = S // chunk, chunk
    q32 = (q.float() / math.sqrt(Dh)).reshape(B, L, T, H, Dh)
    k32 = k.float().reshape(B, L, T, H, Dh)
    v32 = v.float().reshape(B, L, T, H, Dh)
    ig32 = ig.float().reshape(B, L, T, H)
    lf = F.logsigmoid(fg.float()).reshape(B, L, T, H)

    # cumulative log-forget inside each chunk: b_t = sum_{s<=t} lf_s
    bcum = torch.cumsum(lf, dim=2)                         # (B, L, T, H)
    btot = bcum[:, :, -1]                                  # (B, L, H)
    C, n, m = _zero_state(B, H, Dh, q.device) if init_state is None else \
        tuple(t.float() for t in init_state)
    idx = torch.arange(T, device=q.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]   # (1,T,T,1)

    hs = []
    for c in range(L):
        qc, kc, vc, igc, bc, bt = (q32[:, c], k32[:, c], v32[:, c], ig32[:, c],
                                   bcum[:, c], btot[:, c])
        # ---- stabilisers ---------------------------------------------------
        # log weight of intra-chunk pair (t, s): b_t - b_s + ig_s
        a = bc[:, :, None] - bc[:, None] + igc[:, None]    # (B, T, T, H)
        a = a.masked_fill(~causal, -math.inf)
        m_intra = a.amax(dim=2)                            # (B, T, H)
        m_inter = bc + m[:, None]                          # (B, T, H)
        m_t = torch.maximum(m_intra, m_inter)
        # ---- intra-chunk quadratic part -----------------------------------
        w_inr = torch.exp(a - m_t[:, :, None])             # (B, T, T, H)
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * w_inr
        num = torch.einsum("btsh,bshd->bthd", scores, vc)
        # ---- inter-chunk recurrent part -----------------------------------
        w_out = torch.exp(m_inter - m_t)                   # (B, T, H)
        qw = qc * w_out[..., None]
        num = num + torch.einsum("bthd,bhde->bthe", qw, C)
        den = scores.sum(dim=2) + torch.einsum("bthd,bhd->bth", qw, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # ---- state update --------------------------------------------------
        m_new = torch.maximum(bt + m, (igc + bt[:, None] - bc).amax(dim=1))
        f_c = torch.exp(bt + m - m_new)                    # (B, H)
        g = torch.exp(igc + (bt[:, None] - bc) - m_new[:, None])   # (B, T, H)
        kg = kc * g[..., None]
        C = f_c[..., None, None] * C + torch.einsum("bthd,bthe->bhde", kg, vc)
        n = f_c[..., None] * n + kg.sum(dim=1)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H, Dh)
    return h, (C, n, m)


def mlstm_decode_step(q, k, v, ig, fg, state, rank: int = 0, group=None):
    """One-token mLSTM update. q, k, v: (B, H, Dh); ig, fg: (B, H);
    state: (C, n, m) float32.

    Returns (h (B, H, Dh) float32, (C, n, m)).  C and n are updated in
    place (the same operations as the reference's, so the same numbers: at
    full width C is 64 MiB a layer) and m is a new tensor.

    On a mesh, C and n may be a rank's columns as ``cache_specs`` splits
    them over "model": C (B, H, Dh, Dh / tp) on its value dim, n (B, H,
    Dh / tp) on its key dim, ``rank`` their piece; q, k, v and the gates
    stay whole.  The denominator's dot product n.q is then all-reduced
    over ``group`` and h all-gathered (group None: the state is whole)."""
    C, n, m = state
    Dh, w = q.shape[-1], C.shape[-1]
    cols = slice(rank * w, (rank + 1) * w)
    q32 = q.float() / math.sqrt(Dh)
    k32, v32 = k.float(), v.float()
    lf = F.logsigmoid(fg.float())
    ig32 = ig.float()
    m_new = torch.maximum(lf + m, ig32)
    fgate = torch.exp(lf + m - m_new)[..., None]
    igate = torch.exp(ig32 - m_new)[..., None]
    C.mul_(fgate[..., None]).add_(
        igate[..., None] * (k32[..., :, None] * v32[..., None, cols]))
    n.mul_(fgate).add_(igate * k32[..., cols])
    num = torch.einsum("bhij,bhi->bhj", C, q32)
    qn = torch.einsum("bhi,bhi->bh", n, q32[..., cols])
    if group is not None:
        qn = all_reduce_sum(qn, group)
    den = torch.maximum(qn.abs(), torch.exp(-m_new))[..., None]
    return gather_last(num / den, group), (C, n, m_new)


# ---------------------------------------------------------------------------
# mLSTM block (pre-LN residual, up-projection 2x, conv4, per-head gates)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg):
    """(heads, head dim, inner width) of the mLSTM block."""
    inner = MLSTM_PF * cfg.d_model
    H = cfg.n_heads
    return H, inner // H, inner


def mlstm_axes():
    """Logical axes of an mLSTM block's leaves, as the reference's
    ``init_mlstm`` gives them."""
    heads = ("kv_heads", None, None)
    return {"ln": ("embed",), "w_up": ("embed", "rnn"),
            "conv_w": ("conv", "rnn"), "conv_b": ("rnn",),
            "wq": heads, "wk": heads, "wv": heads,
            "w_ig": ("rnn", None), "b_ig": (None,),
            "w_fg": ("rnn", None), "b_fg": (None,),
            "skip": ("rnn",), "gn": ("rnn",), "w_down": ("rnn", "embed")}


def _mlstm_qkv(x_br, xc, p, B, S, H, Dh):
    """q, k from the convolved branch, v from the unconvolved one."""
    xch = xc.reshape(B, S, H, Dh)
    q = torch.einsum("bshd,hde->bshe", xch, p["wq"].to(xc.dtype))
    k = torch.einsum("bshd,hde->bshe", xch, p["wk"].to(xc.dtype))
    v = torch.einsum("bshd,hde->bshe", x_br.reshape(B, S, H, Dh),
                     p["wv"].to(xc.dtype))
    return q.contiguous(), k.contiguous(), v.contiguous()


def _mlstm_gated(h, xc, z_br, skip, gn, eps: float, group=None):
    """Skip, group norm and output gate of the block, the down
    projection's input.  ``group``: the ranks that split the inner width
    (on a mesh), over which the norm's sums of squares are all-reduced."""
    h = h + skip.to(h.dtype) * xc                             # learnable skip
    h = rms_norm(h, gn, eps, group)                           # per-group norm
    return h * F.silu(z_br)                                   # output gate


def _mlstm_out(x, h, xc, z_br, p, cfg):
    """Skip, group norm, output gate and down projection of the block."""
    return dense(_mlstm_gated(h, xc, z_br, p["skip"], p["gn"],
                              cfg.norm_eps), p["w_down"])


def apply_mlstm(x, p, cfg, *, chunk: int = 256, return_state: bool = False,
                mesh=None):
    """Full-sequence mLSTM block. x: (B, S, d) -> (B, S, d).

    With ``return_state`` also the decode state {"C": (B, H, Dh, Dh), "n":
    (B, H, Dh), "m": (B, H) float32, "conv": (B, CONV_K - 1, inner) bf16}.
    ``mesh``: x and ``p`` are DTensors on it (``_apply_mlstm_on_mesh``)."""
    if mesh is not None and is_dtensor(x):
        return _apply_mlstm_on_mesh(x, p, cfg, chunk, return_state, mesh)
    B, S, _ = x.shape
    H, Dh, inner = mlstm_dims(cfg)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    up = dense(h_in, p["w_up"])
    x_br, z_br = up[..., :inner], up[..., inner:]
    xc = F.silu(causal_conv1d(x_br, p["conv_w"], p["conv_b"]))
    q, k, v = _mlstm_qkv(x_br, xc, p, B, S, H, Dh)
    ig = dense(xc, p["w_ig"]) + p["b_ig"]
    fg = dense(xc, p["w_fg"]) + p["b_fg"]
    # the CUDA kernel on the GPU, its plain version on the CPU
    h, (C, n, m) = mlstm_ops.mlstm_chunkwise(q, k, v, ig, fg, chunk=chunk)
    h = h.to(x.dtype).reshape(B, S, inner)
    y = x + _mlstm_out(x, h, xc, z_br, p, cfg)
    if return_state:
        conv = x_br[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return y, {"C": C, "n": n, "m": m, "conv": conv}
    return y


def init_state_mlstm(cfg, B: int, *, device=None):
    H, Dh, inner = mlstm_dims(cfg)
    C, n, m = _zero_state(B, H, Dh, device)
    return {"C": C, "n": n, "m": m,
            "conv": torch.zeros((B, CONV_K - 1, inner), dtype=torch.bfloat16,
                                device=device)}


def decode_mlstm(x, p, cfg, state, *, mesh=None):
    """One-token mLSTM step. x: (B, 1, d).

    Returns (out, state): ``state``'s tensors are updated in place.
    ``mesh``: x, ``p`` and ``state`` are DTensors on it, the state placed
    by ``sharding.cache_specs`` (``_decode_mlstm_on_mesh``)."""
    if mesh is not None and is_dtensor(x):
        return _decode_mlstm_on_mesh(x, p, cfg, state, mesh)
    B = x.shape[0]
    H, Dh, inner = mlstm_dims(cfg)
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    up = dense(h_in, p["w_up"])
    x_br, z_br = up[..., :inner], up[..., inner:]
    xc, conv_buf = conv1d_decode(x_br, state["conv"].to(x.dtype),
                                 p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    q, k, v = (t[:, 0] for t in _mlstm_qkv(x_br, xc, p, B, 1, H, Dh))
    ig = dense(xc, p["w_ig"]) + p["b_ig"]
    fg = dense(xc, p["w_fg"]) + p["b_fg"]
    h, (_, _, m) = mlstm_decode_step(q, k, v, ig, fg,
                                     (state["C"], state["n"], state["m"]))
    h = h.to(x.dtype).reshape(B, inner)
    out = x + _mlstm_out(x, h, xc, z_br, p, cfg)[:, None, :]
    state["m"].copy_(m)
    state["conv"].copy_(conv_buf)
    return out, state


# ---------------------------------------------------------------------------
# sLSTM block (scalar memory, sequential; block-diagonal recurrence)
# ---------------------------------------------------------------------------

def slstm_dims(cfg):
    """(heads, head dim, post-MLP width) of the sLSTM block."""
    H = cfg.n_heads
    return H, cfg.d_model // H, int(SLSTM_PF * cfg.d_model)


def slstm_axes():
    """Logical axes of an sLSTM block's leaves, as the reference's
    ``init_slstm`` gives them."""
    axes = {"ln": ("embed",), "conv_w": ("conv", "embed"),
            "conv_b": ("embed",), "gn": ("embed",), "mlp_ln": ("embed",),
            "w1": ("embed", "mlp"), "w3": ("embed", "mlp"),
            "w2": ("mlp", "embed")}
    for g in ("z", "i", "f", "o"):
        axes.update({f"w_{g}": ("embed", "rnn_out"),
                     f"r_{g}": ("kv_heads", None, None),
                     f"b_{g}": ("rnn_out",)})
    return axes


def _slstm_cell(pre, c, n, m):
    """One sLSTM step from its pre-activations ``pre`` (..., 4, Dh) (z, i,
    f, o) and the state (c, n, m): returns (h, c, n, m)."""
    zt = torch.tanh(pre[..., 0, :])
    it = pre[..., 1, :]
    lf = F.logsigmoid(pre[..., 2, :])
    ot = torch.sigmoid(pre[..., 3, :])
    m_new = torch.maximum(lf + m, it)
    i_g = torch.exp(it - m_new)
    f_g = torch.exp(lf + m - m_new)
    c = f_g * c + i_g * zt
    n = f_g * n + i_g
    return ot * c / torch.clamp_min(n, 1e-6), c, n, m_new


def _slstm_scan(zx, ix, fx, ox, p, H, Dh, init):
    """Sequential sLSTM over time. *x: (B, S, H, Dh) pre-activations;
    init: (h, c, n, m), each (B, H, Dh) float32.

    Returns (hs (B, S, H, Dh) float32, (h, c, n, m)).  A plain loop over t:
    the four recurrent products ``h @ r_*`` are one batched product over
    the concatenated ``r_*`` (read in float32), which sums each output
    element as the four would.  Its steps are ``flops.loop``'s: counted
    as one step times S under a ``FlopCounter``."""
    r = torch.cat([p[n].float() for n in ("r_z", "r_i", "r_f", "r_o")],
                  dim=-1)                                  # (H, Dh, 4 Dh)
    B, S = zx.shape[:2]
    # (S, B, H, 4, Dh): one slice per step holds the four pre-activations
    xs = torch.stack([a.float() for a in (zx, ix, fx, ox)], dim=3) \
        .transpose(0, 1).contiguous()
    h, c, n, m = init
    hs = torch.empty((S, B, H, Dh), dtype=torch.float32, device=zx.device)
    for t in flops.loop(S):
        rec = torch.einsum("bhi,hij->bhj", h, r).reshape(B, H, 4, Dh)
        h, c, n, m = _slstm_cell(xs[t] + rec, c, n, m)
        hs[t] = h
    return hs.transpose(0, 1), (h, c, n, m)


def _slstm_preacts(h_in, xc, p, B, S, H, Dh):
    """z and o read the normed input, i and f the convolved one."""
    def gate(src, name):
        return (dense(src, p["w_" + name]) + p["b_" + name]).reshape(
            B, S, H, Dh)
    return gate(h_in, "z"), gate(xc, "i"), gate(xc, "f"), gate(h_in, "o")


def _slstm_out(x, hs, p, cfg):
    """Group norm, residual and the GeGLU post-MLP (GELU tanh, as
    ``jax.nn.gelu``, whatever ``cfg.act`` says)."""
    B, S, d = x.shape
    y = x + rms_norm(hs.to(x.dtype).reshape(B, S, d), p["gn"], cfg.norm_eps)
    hm = rms_norm(y, p["mlp_ln"], cfg.norm_eps)
    hm = act_fn("gelu")(dense(hm, p["w1"])) * dense(hm, p["w3"])
    return y + dense(hm, p["w2"])


def apply_slstm(x, p, cfg, *, return_state: bool = False, mesh=None):
    """Full-sequence sLSTM block. x: (B, S, d).

    With ``return_state`` also the decode state {"h", "c", "n", "m": (B, H,
    Dh) float32, "conv": (B, CONV_K - 1, d) bf16}.  ``mesh``: x and ``p``
    are DTensors on it (``_apply_slstm_on_mesh``)."""
    if mesh is not None and is_dtensor(x):
        return _apply_slstm_on_mesh(x, p, cfg, return_state, mesh)
    B, S, _ = x.shape
    H, Dh, _ = slstm_dims(cfg)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xc = F.silu(causal_conv1d(h_in, p["conv_w"], p["conv_b"]))
    hs, (h, c, n, m) = _slstm_scan(*_slstm_preacts(h_in, xc, p, B, S, H, Dh),
                                   p, H, Dh, _slstm_zero(B, H, Dh, x.device))
    y = _slstm_out(x, hs, p, cfg)
    if return_state:
        conv = h_in[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return y, {"h": h, "c": c, "n": n, "m": m, "conv": conv}
    return y


def _slstm_zero(B: int, H: int, Dh: int, device):
    """The initial (h, c, n, m), each (B, H, Dh) float32."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, H, Dh), **f32), torch.zeros((B, H, Dh), **f32),
            torch.zeros((B, H, Dh), **f32),
            torch.full((B, H, Dh), NEG_INF, **f32))


def init_state_slstm(cfg, B: int, *, device=None):
    H, Dh, _ = slstm_dims(cfg)
    state = dict(zip(("h", "c", "n", "m"), _slstm_zero(B, H, Dh, device)))
    state["conv"] = torch.zeros((B, CONV_K - 1, cfg.d_model),
                                dtype=torch.bfloat16, device=device)
    return state


def decode_slstm(x, p, cfg, state, *, mesh=None):
    """One-token sLSTM step. x: (B, 1, d).

    Returns (out, state): ``state``'s tensors are updated in place.
    ``mesh``: x, ``p`` and ``state`` are DTensors on it, the state placed
    by ``sharding.cache_specs`` (``_decode_slstm_on_mesh``)."""
    if mesh is not None and is_dtensor(x):
        return _decode_slstm_on_mesh(x, p, cfg, state, mesh)
    B = x.shape[0]
    H, Dh, _ = slstm_dims(cfg)
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    xc, conv_buf = conv1d_decode(h_in, state["conv"].to(x.dtype),
                                 p["conv_w"], p["conv_b"])
    xc = F.silu(xc)
    hs, new = _slstm_scan(*_slstm_preacts(h_in, xc, p, B, 1, H, Dh), p, H,
                          Dh, (state["h"], state["c"], state["n"],
                               state["m"]))
    for name, t in zip(("h", "c", "n", "m"), new):
        state[name].copy_(t)
    state["conv"].copy_(conv_buf)
    return _slstm_out(x, hs, p, cfg), state


# ---------------------------------------------------------------------------
# On a device mesh
# ---------------------------------------------------------------------------
#
# The reference's rulesets split the recurrent blocks over "model" by their
# parameters' logical axes: the mLSTM's channels ("rnn"), the sLSTM's gate
# columns ("rnn_out"), and neither the per-head weights ("kv_heads": None)
# nor the channels' norms where they read "embed".  Here each block's
# projections are DTensor products, and the channel- and head-local parts
# (the convs, the kernels, the sLSTM's loop, the state updates) run in
# ``local_map`` on each rank's pieces.  A weight read on a rank's batch
# rows has a gradient partial over the data axes (``rows_grad``).

def seq_dropped(place):
    """The placements of a (B, S, C) tensor's (B, C) counterpart (or of a
    (B, K, C) lag buffer's): a split of dim 2 becomes a split of dim 1."""
    from torch.distributed.tensor import Shard
    return [Shard(p.dim - 1) if p.is_shard() and p.dim > 1 else p
            for p in place]


def _conv_weights(x, p, mesh):
    """conv_w (K, C) and conv_b (C,) whole over the data axes and split
    over "model" as x's channels (last dim) are."""
    split = x.placements[model_dim(mesh)].is_shard()
    return (over_model(gathered(p["conv_w"]), mesh, 1 if split else None),
            over_model(gathered(p["conv_b"]), mesh, 0 if split else None))


def conv_on_channels(x, p, mesh, act=None):
    """``causal_conv1d`` (then ``act``) of x (B, S, C) on each rank's
    channels of x."""
    w, b = _conv_weights(x, p, mesh)

    def conv(x, w, b):
        y = causal_conv1d(x, w, b)
        return y if act is None else act(y)
    return local_call(conv, mesh, (x, w, b), list(x.placements),
                      grads=(None, rows_grad(x, w), rows_grad(x, b)))


def conv_step_on_channels(x, buf, p, mesh, act=None):
    """``conv1d_decode`` (then ``act``) of x (B, C) against the lag buffer
    ``buf`` (B, CONV_K - 1, C), both on each rank's channels; the buffer
    is written in place."""
    w, b = _conv_weights(x, p, mesh)

    def step(x, buf, w, b):
        out, new = conv1d_decode(x, buf.to(x.dtype), w, b)
        buf.copy_(new)
        return out if act is None else act(out)
    return local_call(step, mesh, (x, buf, w, b), list(x.placements))


def _split_heads_over_model(H: int, mesh) -> bool:
    return H % mesh.size(model_dim(mesh)) == 0


def _mlstm_out_on_channels(h, xc, z, p, cfg, mesh):
    """``_mlstm_gated`` on each rank's channels of the inner width (as
    ``skip`` and ``gn`` are split)."""
    skip, gn = gathered(p["skip"]), gathered(p["gn"])
    out = functools.partial(_mlstm_gated, eps=cfg.norm_eps,
                            group=model_group(xc, mesh))
    return local_call(out, mesh, (h, xc, z, skip, gn), list(xc.placements),
                      grads=(None, None, None, rows_grad(xc, skip),
                             rows_grad(xc, gn)))


def _apply_mlstm_on_mesh(x, p, cfg, chunk, return_state, mesh):
    """``apply_mlstm`` on each rank's H / tp heads (all H where H does not
    divide "model": xlstm-1.3b's 4 heads at tp 8).

    ``w_up`` is ("embed", "rnn") over the concatenated [x_br | z_br], so
    its column split is not aligned with the branches (at tp 2 rank 0
    holds all of x_br).  The parameter layout stays the reference's: the
    up projection is all-gathered over "model" ((B, S, 2 inner) a layer)
    and each branch re-split into the ranks' channels, a local slice.
    The conv runs on the rank's channels, then the per-head q, k, v (the
    rank's rows of the replicated ``wq``, ``wk``, ``wv``) and the
    ``mlstm_scan`` kernel on (B / dp, S, H / tp, Dh), in one
    ``local_map``.  ``w_ig`` and ``w_fg`` are ("rnn", None): their
    products are partial sums over "model", reduced and split by heads.
    The skip, group norm and output gate run on the rank's channels (the
    norm's sums of squares all-reduced), and ``w_down`` is row-split: a
    partial sum over "model" that the residual stream's hint reduces."""
    H, Dh, inner = mlstm_dims(cfg)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    up = over_model(dense(h_in, p["w_up"]), mesh, None)
    x_br = shard_hint(up[..., :inner], mesh, CHANNELS)
    z_br = shard_hint(up[..., inner:], mesh, CHANNELS)
    xc = conv_on_channels(x_br, p, mesh, act=F.silu)
    split = _split_heads_over_model(H, mesh)
    heads = 0 if split else None
    xc_h, xb_h = (over_model(t, mesh, 2 if split else None)
                  for t in (xc, x_br))
    wq, wk, wv, b_ig, b_fg = (over_model(gathered(p[n]), mesh, heads)
                              for n in ("wq", "wk", "wv", "b_ig", "b_fg"))
    ig, fg = (shard_hint(dense(xc, p[n]), mesh, CHANNELS)
              for n in ("w_ig", "w_fg"))

    def scan(xc, xb, wq, wk, wv, ig, fg, b_ig, b_fg):
        B, S, n = xc.shape
        Hl = wq.shape[0]
        q, k, v = _mlstm_qkv(xb, xc, {"wq": wq, "wk": wk, "wv": wv}, B, S,
                             Hl, Dh)
        h, (C, n_, m) = mlstm_ops.mlstm_chunkwise(
            q, k, v, (ig + b_ig).contiguous(), (fg + b_fg).contiguous(),
            chunk=chunk)
        return h.to(xc.dtype).reshape(B, S, n), C, n_, m
    hp = list(xc_h.placements)
    sp = seq_dropped(hp)
    h, C, n, m = local_call(
        scan, mesh, (xc_h, xb_h, wq, wk, wv, ig, fg, b_ig, b_fg),
        (hp, sp, sp, sp),
        grads=(None, None, rows_grad(xc_h, wq), rows_grad(xc_h, wk),
               rows_grad(xc_h, wv), None, None, rows_grad(xc_h, b_ig),
               rows_grad(xc_h, b_fg)))
    h = over_model(h, mesh, 2 if xc.placements[model_dim(mesh)].is_shard()
                   else None)
    y = x + dense(_mlstm_out_on_channels(h, xc, z_br, p, cfg, mesh),
                  p["w_down"])
    if return_state:
        conv = x_br[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return y, {"C": C, "n": n, "m": m, "conv": conv}
    return y


def _decode_mlstm_on_mesh(x, p, cfg, state, mesh):
    """``decode_mlstm`` on the state as ``cache_specs`` places it: the lag
    buffer on its channels, C and n on their last dim, m whole over
    "model".  The conv step writes the rank's channels; q, k, v and the
    gates are made whole over "model" ((B, inner) and (B, H): a token's);
    the state update runs on the rank's columns (``mlstm_decode_step``
    with its rank and group), and the skip, norm and gate on its
    channels."""
    B = x.shape[0]
    H, Dh, inner = mlstm_dims(cfg)
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    up = over_model(dense(h_in, p["w_up"]), mesh, None)
    x_br, z_br = up[..., :inner], up[..., inner:]
    place = seq_dropped(state["conv"].placements)
    xc = conv_step_on_channels(x_br.redistribute(mesh, place),
                               state["conv"], p, mesh, act=F.silu)
    ig, fg = (over_model(dense(xc, p[n]), mesh, None)
              for n in ("w_ig", "w_fg"))
    ws = [gathered(p[n]) for n in ("wq", "wk", "wv", "b_ig", "b_fg")]
    rank = model_rank(state["C"], mesh)
    group = model_group(state["C"], mesh)

    def step(xc, xb, wq, wk, wv, b_ig, b_fg, ig, fg, C, n, m):
        q, k, v = (t[:, 0] for t in _mlstm_qkv(
            xb, xc, {"wq": wq, "wk": wk, "wv": wv}, xc.shape[0], 1, H, Dh))
        h, (_, _, m_new) = mlstm_decode_step(
            q, k, v, ig + b_ig, fg + b_fg, (C, n, m), rank, group)
        m.copy_(m_new)
        return h.to(xc.dtype).reshape(xc.shape[0], inner)
    h = local_call(step, mesh, (over_model(xc, mesh, None), x_br, *ws, ig,
                                fg, state["C"], state["n"], state["m"]),
                   list(x_br.placements))
    h, z = (t.redistribute(mesh, place) for t in (h, z_br))
    out = dense(_mlstm_out_on_channels(h, xc, z, p, cfg, mesh), p["w_down"])
    return x + out[:, None, :], state


def _apply_slstm_on_mesh(x, p, cfg, return_state, mesh):
    """``apply_slstm`` on each rank's H / tp heads (all H where H does not
    divide "model").

    The conv reads the normed stream, whole over "model", with its
    weights made whole.  The gate projections ``w_*`` are ("embed",
    "rnn_out"): column-split, so each pre-activation comes out on the
    rank's heads (all-gathered where the heads do not split).  The
    recurrent ``r_*`` are ("kv_heads", None, None), replicated and
    block-diagonal by head, so the loop over time is head-local: it runs
    whole in one ``local_map`` on the rank's heads and their rows of
    ``r_*``, never as DTensor ops a step.  Its h is then all-gathered, and
    the group norm over d and the GeGLU post-MLP follow the dense rules."""
    H, Dh, _ = slstm_dims(cfg)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xc = conv_on_channels(h_in, p, mesh, act=F.silu)
    heads = 0 if _split_heads_over_model(H, mesh) else None
    pre = [over_model(dense(src, p["w_" + g]), mesh,
                      None if heads is None else 2)
           for src, g in ((h_in, "z"), (xc, "i"), (xc, "f"), (h_in, "o"))]
    ws = [over_model(gathered(p[k + g]), mesh, heads)
          for k in ("b_", "r_") for g in "zifo"]

    def scan(zx, ix, fx, ox, b_z, b_i, b_f, b_o, r_z, r_i, r_f, r_o):
        B, S, w = zx.shape
        Hl = w // Dh
        xs = [(a + b).reshape(B, S, Hl, Dh)
              for a, b in zip((zx, ix, fx, ox), (b_z, b_i, b_f, b_o))]
        hs, state = _slstm_scan(*xs, {"r_z": r_z, "r_i": r_i, "r_f": r_f,
                                      "r_o": r_o}, Hl, Dh,
                                _slstm_zero(B, Hl, Dh, zx.device))
        return (hs.reshape(B, S, w), *state)
    hp = list(pre[0].placements)
    sp = seq_dropped(hp)
    hs, h, c, n, m = local_call(
        scan, mesh, (*pre, *ws), (hp, sp, sp, sp, sp),
        grads=(None,) * 4 + tuple(rows_grad(pre[0], w) for w in ws))
    y = _slstm_out(x, over_model(hs, mesh, None), p, cfg)
    if return_state:
        conv = h_in[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return y, {"h": h, "c": c, "n": n, "m": m, "conv": conv}
    return y


def _decode_slstm_on_mesh(x, p, cfg, state, mesh):
    """``decode_slstm`` on the state as ``cache_specs`` places it: h, c, n,
    m (B, H, Dh) split over "model" on Dh, the lag buffer on its channels.
    The conv step writes the rank's channels; the four pre-activations
    (bias added on the gate columns) are made whole over "model" in one
    all-gather; the step runs on the rank's Dh columns of every head,
    reading the whole h (all-gathered) against its columns of ``r_*``,
    and updates the state in place.  The new h is all-gathered for the
    norm and the post-MLP."""
    H, Dh, _ = slstm_dims(cfg)
    h_in = rms_norm(x[:, 0], p["ln"], cfg.norm_eps)
    place = seq_dropped(state["conv"].placements)
    xc = conv_step_on_channels(h_in.redistribute(mesh, place),
                               state["conv"], p, mesh, act=F.silu)
    xc = over_model(xc, mesh, None)
    pre = over_model(torch.stack(
        [dense(src, p["w_" + g]) + p["b_" + g]
         for src, g in ((h_in, "z"), (xc, "i"), (xc, "f"), (h_in, "o"))],
        dim=1), mesh, None)                             # (B, 4, d)
    rs = [gathered(p["r_" + g]) for g in "zifo"]
    rank = model_rank(state["h"], mesh)
    group = model_group(state["h"], mesh)

    def step(pre, r_z, r_i, r_f, r_o, h, c, n, m):
        B, w = h.shape[0], h.shape[-1]
        cols = slice(rank * w, (rank + 1) * w)
        r = torch.cat([t.float()[..., cols] for t in (r_z, r_i, r_f, r_o)],
                      dim=-1)                            # (H, Dh, 4 w)
        rec = torch.einsum("bhi,hij->bhj", gather_last(h, group), r)
        xs = pre.reshape(B, 4, H, Dh)[..., cols].transpose(1, 2)
        new = _slstm_cell(xs + rec.reshape(B, H, 4, w), c, n, m)
        for t, v in zip((h, c, n, m), new):
            t.copy_(v)
        return gather_last(new[0], group).reshape(B, 1, H * Dh)
    hs = local_call(step, mesh, (pre, *rs, state["h"], state["c"],
                                 state["n"], state["m"]),
                    list(pre.placements))
    return _slstm_out(x, hs, p, cfg), state
