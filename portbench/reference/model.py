"""The plain reference of the benchmark's decoders, in plain PyTorch.

A GQA decoder with RMSNorm (scale ``1 + w``), half-split rotary
embeddings, causal softmax attention scaled by 1 / sqrt(Dh), a SiLU-gated
MLP or a top-k mixture of experts with capacity, and a tied or untied
head, as each configuration file under ``portbench/configs`` states it.
Written from those statements, not from the program: it imports nothing
of the port, and it takes only the weights and tokens the benchmark makes.

Precision: ``"fp32"`` computes every product in float32 (the caller turns
TF32 off, ``exact_float32``); ``"fp8"`` is the control: every matrix
product's operands (and, in training, its output gradient) rounded to
float8 e4m3 with a per-tensor scale, the rest in float32.

Weights are a flat dict of float32 tensors keyed like the benchmark's
weights (``embed``, ``head``, ``final_ln``, ``layers.<i>.mix.<name>``,
``layers.<i>.ffn.<name>``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

QBLOCK = 512            # query rows a block of the plain attention
SCORE_ELEMS = 1 << 28   # float32 scores a block of the plain attention
LOSS_CHUNK = 1024       # positions a chunk of the loss
Z_WEIGHT = 1e-4         # z-loss on the log-sum-exp
AUX_WEIGHT = 0.01       # MoE load-balancing loss, over the layers
FP8_MAX = 448.0         # largest float8 e4m3 number

# the port's families and activations this reference covers
FAMILIES = ("dense", "moe")
ACTS = ("swiglu",)


def exact_float32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Spec:
    """The sizes of one configuration file's ``model``, with the numbers
    that its ``port_departs`` gives as run in place of the published ones.
    The MiniCPM and Granite scalars are covered where, as run, they leave
    the lookup at sqrt(d) (tied) or 1 (untied), the scores at
    1 / sqrt(Dh) and the residual branches and the logits unscaled."""

    def __init__(self, conf: dict):
        m = dict(conf["model"])
        m.update({k: v["as_run"] for k, v in conf.get("port_departs",
                                                       {}).items()})
        self.L = m["num_hidden_layers"]
        self.d = m["hidden_size"]
        self.H = m["num_attention_heads"]
        self.KH = m["num_key_value_heads"]
        self.Dh = m.get("head_dim") or self.d // self.H
        self.f = m["intermediate_size"]
        self.V = m["vocab_size"]
        self.E = m.get("num_local_experts", 0)
        self.k = m.get("num_experts_per_tok", 0)
        self.cf = m.get("capacity_factor", 0.0)
        self.tied = bool(m["tie_word_embeddings"])
        self.eps = m["rms_norm_eps"]
        self.theta = m["rope_theta"]
        if m.get("hidden_act", "silu") != "silu":
            raise ValueError(f"reference: activation {m['hidden_act']!r}")
        # a tied table is scaled by sqrt(d) at lookup (the port's MiniCPM
        # scaling), an untied one is read as it is
        self.embed_scale = math.sqrt(self.d) if self.tied else 1.0
        unit = {"scale_emb": self.embed_scale,
                "embedding_multiplier": self.embed_scale,
                "attention_multiplier": self.Dh ** -0.5,
                "scale_depth": math.sqrt(self.L),
                "dim_model_base": self.d,
                "logits_scaling": 1.0, "residual_multiplier": 1.0}
        off = {k: m[k] for k, want in unit.items()
               if k in m and not math.isclose(m[k], want, rel_tol=1e-6)}
        if off:
            raise ValueError(f"reference: scalars {off} as run are not "
                             f"covered")

    @property
    def moe(self) -> bool:
        return self.E > 0

    def capacity(self, T: int) -> int:
        """An expert's slots over the T tokens of one call, a multiple of
        8 and at least 8."""
        c = int(T * self.k * self.cf / self.E)
        return max(8, (c + 7) // 8 * 8)


# ---------------------------------------------------------------------------
# float8 rounding (the control)
# ---------------------------------------------------------------------------

def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


class _Fp8Round(torch.autograd.Function):
    """fp8(x) forward, the gradient passed through."""
    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a (..., K) @ b (K, N)."""
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


def _q(x: torch.Tensor, prec: str) -> torch.Tensor:
    return _Fp8Round.apply(x) if prec == "fp8" else x


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, positions, theta: float):
    """x (B, S, heads, Dh); positions (S,): rotate the two halves of each
    head by the angles pos * theta^(-i / half)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = (positions.float()[:, None] * freq)[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, q0: int, prec: str):
    """Causal attention of queries at positions q0, q0 + 1, .. over keys at
    0, 1, ..: q (B, Sq, H, Dh), k and v (B, Sk, KH, Dh); query head h reads
    key head h // (H / KH).  In blocks of QBLOCK query rows, each over the
    keys it can see, as many batch rows at once as keep a block's scores
    under SCORE_ELEMS."""
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(Dh)
    k, v = _q(k, prec), _q(v, prec)
    rows = max(1, min(B, SCORE_ELEMS // (H * QBLOCK * (q0 + Sq))))
    out = []
    for b0 in range(0, B, rows):
        outs = []
        for s0 in range(0, Sq, QBLOCK):
            qb = _q(q[b0:b0 + rows, s0:s0 + QBLOCK], prec)
            nb, n = qb.shape[:2]
            qb = qb.reshape(nb, n, KH, G, Dh)
            kend = q0 + s0 + n
            kb, vb = k[b0:b0 + rows, :kend], v[b0:b0 + rows, :kend]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            qpos = q0 + s0 + torch.arange(n, device=q.device)
            kpos = torch.arange(kend, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
            p = _q(torch.softmax(s, dim=-1), prec)
            outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, vb)
                        .reshape(nb, n, H, Dh))
        out.append(torch.cat(outs, 1))
    return torch.cat(out, 0)


def gated_mlp(h, w1, w3, w2, prec: str):
    return mm(F.silu(mm(h, w1, prec)) * mm(h, w3, prec), w2, prec)


def moe(h, W: Dict[str, torch.Tensor], p: str, s: Spec, prec: str):
    """Top-k experts over the T tokens of h (T, d), as one group.  Returns
    (y (T, d), the layer's load-balancing loss).

    Each token's k experts are its k largest router probabilities (a
    softmax over the experts), weighted by those probabilities divided by
    their sum.  A (token, choice) pair takes the next free slot of its
    expert in token-major order (token by token, each token's choices in
    order of probability); an expert has ``s.capacity(T)`` slots and a
    pair past them is dropped.  The loss is E * sum_e(mean probability of
    e * pairs routed to e / T), over all pairs, dropped or not."""
    T = h.shape[0]
    E, k = s.E, s.k
    probs = torch.softmax(mm(h, W[p + "router"], prec), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, E)
    slot = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    keep = slot < s.capacity(T)
    aux = E * torch.sum(probs.mean(0) * onehot.sum(0).float() / T)
    token = torch.arange(T, device=h.device).repeat_interleave(k)
    wflat = w.reshape(-1)
    y = torch.zeros_like(h)
    w1, w3, w2 = W[p + "w1"], W[p + "w3"], W[p + "w2"]
    for e in range(E):
        sel = keep & (flat == e)
        rows = token[sel]
        if rows.numel() == 0:
            continue
        ye = gated_mlp(h[rows], w1[e], w3[e], w2[e], prec)
        ye = ye * wflat[sel][:, None]
        # in place where nothing needs the graph (serving)
        y = y.index_add(0, rows, ye) if torch.is_grad_enabled() else \
            y.index_add_(0, rows, ye)
    return y, aux


def layer(x, W, i: int, s: Spec, pos0: int, prec: str,
          past: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One decoder layer over x (B, S, d) at positions pos0 .. pos0 + S - 1.
    ``past``: keys and values (B, >= pos0 + S, KH, Dh) of the positions
    before, written here at pos0 .. pos0 + S - 1 and attended; without it
    the layer sees only x's own positions (pos0 must be 0).  Every token of
    x is one routing group.  Returns (x, aux, (k, v) of x's positions)."""
    B, S, d = x.shape
    p = f"layers.{i}.mix."
    h = rms_norm(x, W[p + "ln"], s.eps)
    pos = pos0 + torch.arange(S, device=x.device)
    q = rope(mm(h, W[p + "wq"], prec).reshape(B, S, s.H, s.Dh), pos, s.theta)
    k = rope(mm(h, W[p + "wk"], prec).reshape(B, S, s.KH, s.Dh), pos, s.theta)
    v = mm(h, W[p + "wv"], prec).reshape(B, S, s.KH, s.Dh)
    if past is None:
        if pos0:
            raise ValueError("a layer at position > 0 needs the past keys")
        ks, vs = k, v
    else:
        past[0][:, pos0:pos0 + S] = k
        past[1][:, pos0:pos0 + S] = v
        ks, vs = past[0][:, :pos0 + S], past[1][:, :pos0 + S]
    o = attend(q, ks, vs, pos0, prec)
    x = x + mm(o.reshape(B, S, s.H * s.Dh), W[p + "wo"], prec)
    p = f"layers.{i}.ffn."
    h = rms_norm(x, W[p + "ln"], s.eps)
    if s.moe:
        y, aux = moe(h.reshape(B * S, d), W, p, s, prec)
        y = y.reshape(B, S, d)
    else:
        y, aux = gated_mlp(h, W[p + "w1"], W[p + "w3"], W[p + "w2"], prec), \
            torch.zeros((), device=x.device)
    return x + y, aux, (k, v)


def embed(W, s: Spec, tokens):
    return W["embed"][tokens] * s.embed_scale


def head_matrix(W, s: Spec):
    """(d, V)."""
    return W["embed"].t() if s.tied else W["head"]


# ---------------------------------------------------------------------------
# Training: the loss of one microbatch
# ---------------------------------------------------------------------------

def _layer_train(x, W, i, s, prec):
    y, aux, _ = layer(x, W, i, s, 0, prec)
    return y, aux


def _chunk_loss(x, head, labels, prec):
    logits = mm(x, head, prec)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(lse - gold) + Z_WEIGHT * torch.sum(lse.square())


def train_loss(W, s: Spec, tokens, labels, prec: str):
    """Mean next-token cross-entropy plus the z-loss over (B, S) tokens,
    plus AUX_WEIGHT * the layers' summed load-balancing loss / L for a
    mixture of experts.  Each layer and each loss chunk is recomputed in
    the backward, so that the whole model's activations are never held."""
    x = embed(W, s, tokens)
    aux = torch.zeros((), device=x.device)
    for i in range(s.L):
        x, a = checkpoint(_layer_train, x, W, i, s, prec, use_reentrant=False)
        aux = aux + a
    x = rms_norm(x, W["final_ln"], s.eps)
    head = head_matrix(W, s)
    total = torch.zeros((), device=x.device)
    S = x.shape[1]
    for c0 in range(0, S, LOSS_CHUNK):
        total = total + checkpoint(_chunk_loss, x[:, c0:c0 + LOSS_CHUNK],
                                   head, labels[:, c0:c0 + LOSS_CHUNK], prec,
                                   use_reentrant=False)
    loss = total / labels.numel()
    if s.moe:
        loss = loss + AUX_WEIGHT * aux / s.L
    return loss


# ---------------------------------------------------------------------------
# Serving: logits of served positions
# ---------------------------------------------------------------------------

def _final_logits(W, s, x, prec):
    return mm(rms_norm(x, W["final_ln"], s.eps), head_matrix(W, s), prec)


@torch.no_grad()
def hidden_all(W, s: Spec, tokens, prec: str):
    """Final hidden states (B, S, d) of a whole sequence, every row on its
    own (a dense model: rows do not meet)."""
    x = embed(W, s, tokens)
    for i in range(s.L):
        x, _, _ = layer(x, W, i, s, 0, prec)
    return x


@torch.no_grad()
def teacher_forced_logits(W, s: Spec, tokens, positions: List[List[int]],
                          prec: str) -> List[torch.Tensor]:
    """Row b's logits (len(positions[b]), V) at positions[b] of a full
    forward over tokens (B, S)."""
    x = hidden_all(W, s, tokens, prec)
    return [_final_logits(W, s, x[b, pos], prec)
            for b, pos in enumerate(positions)]


@torch.no_grad()
def prefill_decode_logits(W, s: Spec, prompts, fed, prec: str):
    """The round of a served batch, step by step: prompts (B, P) in one
    forward (one routing group over all B * P tokens), then M decode steps
    (one group of B tokens each), step j feeding fed[:, j] at position
    P + j where it is >= 0 and the reference's own argmax of the step
    before where it is -1.  Returns logits (B, M + 1, V): after the prompt
    and after each step.  Keys and values are kept in float32."""
    B, P = prompts.shape
    M = fed.shape[1]
    dev = prompts.device
    cache = [(torch.zeros((B, P + M, s.KH, s.Dh), device=dev),
              torch.zeros((B, P + M, s.KH, s.Dh), device=dev))
             for _ in range(s.L)]
    x = embed(W, s, prompts)
    for i in range(s.L):
        x, _, _ = layer(x, W, i, s, 0, prec, past=cache[i])
    out = [_final_logits(W, s, x[:, -1], prec)]
    for j in range(M):
        tok = torch.where(fed[:, j] >= 0, fed[:, j], out[-1].argmax(-1))
        x = embed(W, s, tok[:, None])
        for i in range(s.L):
            x, _, _ = layer(x, W, i, s, P + j, prec, past=cache[i])
        out.append(_final_logits(W, s, x[:, -1], prec))
    return torch.stack(out, 1)
