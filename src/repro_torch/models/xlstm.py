"""xLSTM blocks (PyTorch port of ``repro/models/xlstm.py``): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, strictly sequential),
after arXiv:2405.04517.

Over a full sequence the mLSTM runs through the chunkwise mLSTM kernel
(``repro_torch.kernels.mlstm_scan``) on the GPU and its plain version
(:func:`mlstm_chunkwise`) on the CPU; its decode step, the sLSTM, the
convolutions and the projections are plain PyTorch, as they are plain jnp
in the reference.  All recurrences are stabilised in log space (the ``m``
running-max trick of the paper).

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

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import flops
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.models.layers import act_fn, dense, rms_norm

MLSTM_PF = 2          # mLSTM up-projection factor (paper: 2)
SLSTM_PF = 4.0 / 3.0  # sLSTM post-MLP projection factor (paper: 4/3)
CONV_K = 4            # causal depthwise conv width
NEG_INF = -1e30       # the initial log-stabiliser m


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


def mlstm_decode_step(q, k, v, ig, fg, state):
    """One-token mLSTM update. q, k, v: (B, H, Dh); ig, fg: (B, H);
    state: (C, n, m) float32.

    Returns (h (B, H, Dh) float32, (C, n, m)).  C and n are updated in
    place (the same operations as the reference's, so the same numbers: at
    full width C is 64 MiB a layer) and m is a new tensor."""
    C, n, m = state
    Dh = q.shape[-1]
    q32 = q.float() / math.sqrt(Dh)
    k32, v32 = k.float(), v.float()
    lf = F.logsigmoid(fg.float())
    ig32 = ig.float()
    m_new = torch.maximum(lf + m, ig32)
    fgate = torch.exp(lf + m - m_new)[..., None]
    igate = torch.exp(ig32 - m_new)[..., None]
    C.mul_(fgate[..., None]).add_(
        igate[..., None] * (k32[..., :, None] * v32[..., None, :]))
    n.mul_(fgate).add_(igate * k32)
    num = torch.einsum("bhij,bhi->bhj", C, q32)
    den = torch.maximum(torch.einsum("bhi,bhi->bh", n, q32).abs(),
                        torch.exp(-m_new))[..., None]
    return num / den, (C, n, m_new)


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


def _mlstm_out(x, h, xc, z_br, p, cfg):
    """Skip, group norm, output gate and down projection of the block."""
    h = h + p["skip"].to(x.dtype) * xc                       # learnable skip
    h = rms_norm(h, p["gn"], cfg.norm_eps)                    # per-group norm
    h = h * F.silu(z_br)                                      # output gate
    return dense(h, p["w_down"])


def apply_mlstm(x, p, cfg, *, chunk: int = 256, return_state: bool = False):
    """Full-sequence mLSTM block. x: (B, S, d) -> (B, S, d).

    With ``return_state`` also the decode state {"C": (B, H, Dh, Dh), "n":
    (B, H, Dh), "m": (B, H) float32, "conv": (B, CONV_K - 1, inner) bf16}."""
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


def decode_mlstm(x, p, cfg, state):
    """One-token mLSTM step. x: (B, 1, d).

    Returns (out, state): ``state``'s tensors are updated in place."""
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
        pre = xs[t] + rec
        zt = torch.tanh(pre[:, :, 0])
        it = pre[:, :, 1]
        lf = F.logsigmoid(pre[:, :, 2])
        ot = torch.sigmoid(pre[:, :, 3])
        m_new = torch.maximum(lf + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(lf + m - m_new)
        c = f_g * c + i_g * zt
        n = f_g * n + i_g
        h = ot * c / torch.clamp_min(n, 1e-6)
        m = m_new
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


def apply_slstm(x, p, cfg, *, return_state: bool = False):
    """Full-sequence sLSTM block. x: (B, S, d).

    With ``return_state`` also the decode state {"h", "c", "n", "m": (B, H,
    Dh) float32, "conv": (B, CONV_K - 1, d) bf16}."""
    B, S, _ = x.shape
    H, Dh, _ = slstm_dims(cfg)
    h_in = rms_norm(x, p["ln"], cfg.norm_eps)
    xc = F.silu(causal_conv1d(h_in, p["conv_w"], p["conv_b"]))
    init = init_state_slstm(cfg, B, device=x.device)
    hs, (h, c, n, m) = _slstm_scan(*_slstm_preacts(h_in, xc, p, B, S, H, Dh),
                                   p, H, Dh,
                                   (init["h"], init["c"], init["n"],
                                    init["m"]))
    y = _slstm_out(x, hs, p, cfg)
    if return_state:
        conv = h_in[:, -(CONV_K - 1):].to(torch.bfloat16, copy=True)
        return y, {"h": h, "c": c, "n": n, "m": m, "conv": conv}
    return y


def init_state_slstm(cfg, B: int, *, device=None):
    H, Dh, _ = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((B, H, Dh), **f32),
            "c": torch.zeros((B, H, Dh), **f32),
            "n": torch.zeros((B, H, Dh), **f32),
            "m": torch.full((B, H, Dh), NEG_INF, **f32),
            "conv": torch.zeros((B, CONV_K - 1, cfg.d_model),
                                dtype=torch.bfloat16, device=device)}


def decode_slstm(x, p, cfg, state):
    """One-token sLSTM step. x: (B, 1, d).

    Returns (out, state): ``state``'s tensors are updated in place."""
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
