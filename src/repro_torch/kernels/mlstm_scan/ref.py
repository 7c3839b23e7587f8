"""Plain PyTorch versions of the chunkwise-mLSTM kernel: the chunkwise
evaluation of ``models.xlstm`` at the kernel's contract, and the strictly
sequential recurrence (ground truth for both)."""
from __future__ import annotations

import math

import torch

from repro_torch.models import xlstm as _xlstm


def reference_mlstm(q, k, v, ig, fg, *, chunk: int = 64, init_state=None):
    """q, k, v: (B, S, H, Dh); ig, fg: (B, S, H) pre-activations.

    Returns (h (B, S, H, Dh) float32, (C (B, H, Dh, Dh), n (B, H, Dh),
    m (B, H)) float32), at the reference's chunk (halved until it divides
    S)."""
    return _xlstm.mlstm_chunkwise(q, k, v, ig, fg, chunk=chunk,
                                  init_state=init_state)


def sequential_oracle(q, k, v, ig, fg, init_state=None, dtype=torch.float32):
    """The recurrence step by step, in ``dtype``."""
    return _xlstm.mlstm_sequential(q, k, v, ig, fg, init_state=init_state,
                                   dtype=dtype)


# Steps per chunk of the CUDA kernels' wgmma_bf16 route (CT in
# csrc/mlstm_scan.cu).
WGMMA_CHUNK = 128


def split_bf16(x):
    """x (float32) as two bf16 tensors, hi = bf16(x) and lo = bf16(x - hi),
    both rounded to nearest even, as the wgmma route splits its float32
    operands: hi + lo is x to within 2^-16 |x|, and exactly x where x is a
    bf16 value."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _joined(x, split):
    """x as the products of the wgmma route read it: hi + lo where
    ``split``, else unchanged; float32."""
    if not split:
        return x
    hi, lo = split_bf16(x)
    return hi.float() + lo.float()


def wgmma_route_model(q, k, v, ig, fg, *, init_state=None,
                      chunk: int = WGMMA_CHUNK, split: bool = True):
    """The wgmma route's algorithm in plain PyTorch, for the tests: its
    gate pass, the states entering each chunk and its output pass, at the
    kernel's chunk (the last chunk masked, any S), with the float32 factors
    of the products split into bf16 hi + lo where the kernel splits them
    (``split``): the state C entering a chunk (for q C), W (for W v) and
    g o v (for the state update).  The products themselves are float32
    here.  Same contract as ``reference_mlstm``."""
    B, S, H, Dh = q.shape
    T = chunk
    n_chunks = -(-S // T)
    pad = n_chunks * T - S

    def chunks(x):
        x = torch.nn.functional.pad(x.float(), (0, 0) * (x.dim() - 2)
                                    + (0, pad)) if pad else x.float()
        return x.reshape((B, n_chunks, T) + x.shape[2:])
    qc, kc, vc = chunks(q), chunks(k), chunks(v)          # (B, L, T, H, Dh)
    valid = torch.arange(n_chunks * T, device=q.device).reshape(
        n_chunks, T) < S                                 # (L, T)
    lf = torch.nn.functional.logsigmoid(chunks(fg)) * valid[None, :, :, None]
    igc = chunks(ig) * valid[None, :, :, None]           # (B, L, T, H)

    # ---- gate pass: nothing here depends on the state
    b = torch.cumsum(lf.double(), dim=2)                 # past L: b_T
    last = (valid.sum(1) - 1).clamp(min=0)               # (L,)
    bT = b.gather(2, last[None, :, None, None].expand(B, -1, 1, H))[:, :, 0]
    a = (b[:, :, :, None] - b[:, :, None]).float() + igc[:, :, None]
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    mask = causal[None, None, :, :, None] & valid[None, :, None, :, None]
    a = a.masked_fill(~mask, -math.inf)                  # (B, L, T, S, H)
    m_intra = a.amax(dim=3)
    gm = (igc + (bT[:, :, None] - b).float()).masked_fill(
        ~valid[None, :, :, None], -math.inf)             # (B, L, T, H)
    lmax = gm.amax(dim=2)                                # (B, L, H)
    bTf = bT.float()

    # ---- state pass: the state entering each chunk, carried in float32
    if init_state is None:
        C = torch.zeros((B, H, Dh, Dh), device=q.device)
        n = torch.zeros((B, H, Dh), device=q.device)
        m = torch.full((B, H), -1e30, device=q.device)
    else:
        C, n, m = (t.float() for t in init_state)
    entry = []
    for c in range(n_chunks):
        entry.append((_joined(C, split), n, m))
        m_new = torch.maximum(bTf[:, c] + m, lmax[:, c])
        f_c = torch.exp((bTf[:, c] + m) - m_new)
        g = torch.exp(gm[:, c] - m_new[:, None])         # (B, T, H)
        gv = _joined(g[..., None] * vc[:, c], split)     # (B, T, H, Dh)
        C = f_c[..., None, None] * C + torch.einsum("bshi,bshj->bhij",
                                                    kc[:, c], gv)
        n = f_c[..., None] * n + torch.einsum("bsh,bshi->bhi", g, kc[:, c])
        m = m_new

    # ---- output pass: every chunk from the state that enters it
    inv = 1.0 / math.sqrt(Dh)
    hs = []
    for c in range(n_chunks):
        Cc, nc, mc = entry[c]
        m_inter = b[:, c].float() + mc[:, None]           # (B, T, H)
        m_t = torch.maximum(m_intra[:, c], m_inter)
        w_out = torch.exp(m_inter - m_t)
        s = torch.einsum("bthi,bshi->btsh", qc[:, c], kc[:, c]) * inv
        W = torch.where(mask[:, c], s * torch.exp(a[:, c] - m_t[:, :, None]),
                        torch.zeros((), device=q.device))
        o = (w_out * inv)[..., None] * torch.einsum("bthi,bhij->bthj",
                                                    qc[:, c], Cc)
        o = o + torch.einsum("btsh,bshj->bthj", _joined(W, split), vc[:, c])
        den = W.sum(dim=2) + w_out * inv * torch.einsum(
            "bthi,bhi->bth", qc[:, c], nc)
        hs.append(o / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
    h = torch.stack(hs, dim=1).reshape(B, n_chunks * T, H, Dh)[:, :S]
    return h, (C, n, m)
