"""Plain PyTorch versions of the chunkwise-mLSTM kernels: the chunkwise
evaluation of ``models.xlstm`` at the kernel's contract, the strictly
sequential recurrence (ground truth for both), the per-row statistics the
forward writes for training (``reference_mlstm_stats``) and the backward
by explicit formulas (``reference_mlstm_bwd``)."""
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


def _padded_chunks(x, T, value=0.0):
    """x (B, S, ...) padded along S to whole chunks of T with ``value``."""
    pad = -x.shape[1] % T
    if not pad:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad) + x.shape[2:],
                                    value)], dim=1)


def reference_mlstm_stats(q, k, v, ig, fg, *, chunk: int = 64,
                          init_state=None):
    """The chunkwise mLSTM at ``chunk`` steps (any S: the last chunk is
    masked, as in the kernels), keeping what the forward kernel writes for
    the backward.  Returns (m, den, m_e): m (B, S, H) each row's stabiliser
    m_t; den (B, S, H) its denominator before the clamp (h_t = num_t /
    max(|den_t|, exp(-m_t))); m_e (B, chunks, H) the m entering each
    chunk, which is m0 (-1e30 without an initial state) for the first and
    the row stabiliser of the last step before it for every other (the
    same max over the same log weights), so that a backward at any chunk
    can take its boundaries' stabilisers from m alone."""
    B, S, H, Dh = q.shape
    T = chunk
    n_chunks = -(-S // T)
    qs, ks, vs = (_padded_chunks(t.float(), T) for t in (q, k, v))
    qs = qs / math.sqrt(Dh)
    igp = _padded_chunks(ig.float(), T, -math.inf)
    lf = _padded_chunks(torch.nn.functional.logsigmoid(fg.float()), T)
    C, n, m = _xlstm._zero_state(B, H, Dh, q.device) if init_state is None \
        else tuple(t.float() for t in init_state)
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    ms, dens, m_e = [], [], []
    for c in range(n_chunks):
        sl = slice(c * T, (c + 1) * T)
        qc, kc, vc, igc = qs[:, sl], ks[:, sl], vs[:, sl], igp[:, sl]
        bc = torch.cumsum(lf[:, sl].double(), dim=1)          # (B, T, H)
        bt = bc[:, -1]
        a = ((bc[:, :, None] - bc[:, None]).float() + igc[:, None]) \
            .masked_fill(~causal[None, :, :, None], -math.inf)
        m_inter = bc.float() + m[:, None]
        m_t = torch.maximum(a.amax(dim=2), m_inter)
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * \
            torch.exp(a - m_t[:, :, None])
        w_out = torch.exp(m_inter - m_t)
        den = scores.sum(dim=2) + torch.einsum("bthd,bhd->bth",
                                               qc * w_out[..., None], n)
        ms.append(m_t)
        dens.append(den)
        m_e.append(m)
        gm = igc + (bt[:, None] - bc).float()
        m_new = torch.maximum(bt.float() + m, gm.amax(dim=1))
        f_c = torch.exp(bt.float() + m - m_new)
        g = torch.exp(gm - m_new[:, None])
        C = f_c[..., None, None] * C + torch.einsum(
            "bthd,bthe->bhde", kc * g[..., None], vc)
        n = f_c[..., None] * n + (kc * g[..., None]).sum(dim=1)
        m = m_new
    return (torch.cat(ms, dim=1)[:, :S], torch.cat(dens, dim=1)[:, :S],
            torch.stack(m_e, dim=1))


def reference_mlstm_bwd(q, k, v, ig, fg, h, stats, dh, *, chunk: int = 64,
                        init_state=None):
    """The gradient of the mLSTM at its output h for the gradient dh, by
    explicit formulas in chunks of ``chunk`` steps (any S), from the
    forward's row statistics ``stats`` = (m, den, ...) of
    ``reference_mlstm_stats`` (at any chunk).  h does not depend on the
    stabilisers in exact arithmetic, so every m is a constant here.  With
    q~ = q / sqrt(Dh), F_t = sum_{s<=t} logsigmoid(fg_s),
    N_t = max(|den_t|, exp(-m_t)) and w_ts = exp(F_t - F_s + ig_s - m_t)
    (s <= t):

      dnum_t = dh_t / N_t,
      dden_t = -(dh_t . h_t) / den_t where |den_t| > exp(-m_t), else 0
      dS_ts  = w_ts (dnum_t . v_s + dden_t),
      dq~_t  = sum_s dS_ts k_s,  dk_s = sum_t dS_ts q~_t,
      dv_s   = sum_t w_ts (q~_t . k_s) dnum_t,
      dig_s  = sum_t dS_ts (q~_t . k_s),
      dF_t   = sum_s dS_ts (q~_t . k_s) - dig_t, where the row sum is
               dnum_t . num_t + dden_t den_t = (dh_t . h_t) when the clamp
               is active and 0 otherwise (an initial state's terms
               included),
      dfg    = (reverse cumsum of dF) sigmoid(-fg).

    Pairs in one chunk are summed as they stand.  Pairs across a chunk
    boundary go through states: forwards the state (C, n) entering each
    chunk, as the forward carries it, for dq~_t += w_out_t (C dnum_t +
    dden_t n); backwards the state gradient (D, Dn) leaving each chunk,
    D = sum over later t of exp(F_t - F_e + m_e - m_t) q~_t dnum_t^T (Dn
    with dden_t q~_t), for dk_s += g_s (D v_s + Dn) and dv_s += g_s D^T k_s.
    The boundary's stabiliser m_e is the row stabiliser of the step before
    it, so the decay of a state over a chunk, f_c = exp(F_end - F_e + m_e -
    m_end), the weights w_out_t = exp(F_t - F_e + m_e - m_t) and g_s =
    exp(ig_s + F_end - F_s - m_end) are all at most 1.

    Returns (dq, dk, dv, dig, dfg): dq, dk, dv (B, S, H, Dh) and dig, dfg
    (B, S, H), float32."""
    B, S, H, Dh = q.shape
    m, den = stats[0].float(), stats[1].float()
    T = chunk
    n_chunks = -(-S // T)
    qs = q.float() / math.sqrt(Dh)
    kf, vf, dhf = k.float(), v.float(), dh.float()
    F = torch.cumsum(torch.nn.functional.logsigmoid(fg.float()).double(),
                     dim=1)                                    # (B, S, H)
    floor = torch.exp(-m)
    dhh = (dhf * h.float()).sum(dim=-1)
    active = den.abs() > floor
    dnum = dhf / torch.maximum(den.abs(), floor)[..., None]
    dden = torch.where(active, -dhh / den, torch.zeros_like(dhh))
    rows = torch.where(active, torch.zeros_like(dhh), dhh)
    if init_state is None:
        m0 = torch.full((B, H), _xlstm.NEG_INF, device=q.device)
    else:
        m0 = init_state[2].float()
    bounds = [(c * T, min(S, (c + 1) * T)) for c in range(n_chunks)]

    def chunk_gates(c):
        """(w_out (B, T, H), g (B, T, H), f (B, H)) of chunk c."""
        t0, t1 = bounds[c]
        me = m0 if t0 == 0 else m[:, t0 - 1]
        Fe = torch.zeros_like(F[:, 0]) if t0 == 0 else F[:, t0 - 1]
        Fc, Fend, mend = F[:, t0:t1], F[:, t1 - 1], m[:, t1 - 1]
        w_out = torch.exp((Fc - Fe[:, None]).float() + me[:, None]
                          - m[:, t0:t1])
        g = torch.exp(ig[:, t0:t1].float() + (Fend[:, None] - Fc).float()
                      - mend[:, None])
        f = torch.exp((Fend - Fe).float() + me - mend)
        return w_out, g, f

    gates = [chunk_gates(c) for c in range(n_chunks)]
    dq = torch.empty_like(qs)
    dk = torch.empty_like(qs)
    dv = torch.empty_like(qs)
    # forwards: the state entering each chunk
    if init_state is None:
        C = qs.new_zeros((B, H, Dh, Dh))
        n = qs.new_zeros((B, H, Dh))
    else:
        C, n = init_state[0].float(), init_state[1].float()
    for c, (t0, t1) in enumerate(bounds):
        w_out, g, f = gates[c]
        dq[:, t0:t1] = w_out[..., None] * (
            torch.einsum("bhij,bthj->bthi", C, dnum[:, t0:t1])
            + dden[:, t0:t1, :, None] * n[:, None])
        kg = kf[:, t0:t1] * g[..., None]
        C = f[..., None, None] * C + torch.einsum("bthi,bthj->bhij", kg,
                                                  vf[:, t0:t1])
        n = f[..., None] * n + kg.sum(dim=1)
    # backwards: the state gradient leaving each chunk
    D = qs.new_zeros((B, H, Dh, Dh))
    Dn = qs.new_zeros((B, H, Dh))
    for c in range(n_chunks - 1, -1, -1):
        t0, t1 = bounds[c]
        w_out, g, f = gates[c]
        dk[:, t0:t1] = g[..., None] * (
            torch.einsum("bhij,bthj->bthi", D, vf[:, t0:t1]) + Dn[:, None])
        dv[:, t0:t1] = g[..., None] * torch.einsum("bhij,bthi->bthj", D,
                                                   kf[:, t0:t1])
        qw = qs[:, t0:t1] * w_out[..., None]
        D = f[..., None, None] * D + torch.einsum("bthi,bthj->bhij", qw,
                                                  dnum[:, t0:t1])
        Dn = f[..., None] * Dn + (qw * dden[:, t0:t1, :, None]).sum(dim=1)
    # pairs inside each chunk; dig_s = sum_t dS_ts (q~_t . k_s): across
    # chunks k_s . dk_s, inside a chunk the column sums (which cancel less)
    dig = (kf * dk).sum(dim=-1)
    for t0, t1 in bounds:
        L = t1 - t0
        Fc = F[:, t0:t1]
        logw = (Fc[:, :, None] - Fc[:, None]).float() + \
            ig[:, None, t0:t1].float() - m[:, t0:t1, None]     # (B, t, s, H)
        causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        w = torch.exp(logw).masked_fill(~causal[None, :, :, None], 0.0)
        qc, kc, vc, dnc = (x[:, t0:t1] for x in (qs, kf, vf, dnum))
        sc = torch.einsum("bthd,bshd->btsh", qc, kc)
        dS = w * (torch.einsum("bthd,bshd->btsh", dnc, vc)
                  + dden[:, t0:t1, None])
        dq[:, t0:t1] += torch.einsum("btsh,bshd->bthd", dS, kc)
        dk[:, t0:t1] += torch.einsum("btsh,bthd->bshd", dS, qc)
        dv[:, t0:t1] += torch.einsum("btsh,bthd->bshd", w * sc, dnc)
        dig[:, t0:t1] += (dS * sc).sum(dim=1)
    dF = rows - dig
    dlf = torch.flip(torch.cumsum(torch.flip(dF, (1,)), dim=1), (1,))
    dfg = dlf * torch.sigmoid(-fg.float())
    return dq / math.sqrt(Dh), dk, dv, dig, dfg


def wgmma_bwd_route_model(q, k, v, ig, fg, h, stats, dh, *, init_state=None,
                          chunk: int = WGMMA_CHUNK, split: bool = True,
                          tile: int = 128):
    """The wgmma_bf16 route of the backward (csrc/mlstm_scan_bwd.cu) in
    plain PyTorch, for the tests: its algorithm at the kernel's chunk (the
    last chunk masked, any S), with the float32 factors of the products
    split into bf16 hi + lo where the kernel splits them (``split``).  The
    products themselves are float32 here.

    * The chain of m over the chunks is the forward's state pass's (m_new
      = max(b_T + m_prev, max_s gm_s)); every state is scaled by it, and
      w_out, g and the decay f of a chunk take their boundary stabilisers
      from it (the forward's row statistics give m_t and den_t).
    * C^T entering each chunk goes forwards as the forward's state pass
      carries it (g o v split); D^T leaving each chunk goes backwards,
      D^T = f D^T + (s o dnum)^T q with s_t = w_out_t / sqrt(Dh) (dnum =
      dh / N_t split, then s o dnum split again), and Dn on CUDA cores.
    * The outputs: dq~ = w_out (dnum C^T + dden n) + dS k, dk = g (v D^T
      + Dn) + (dS^T / sqrt(Dh)) q, dv = g (k D) + W^T dnum, with dS = w o
      (dnum v^T + dden) and W = w o (q k^T) / sqrt(Dh) split.
    * dig = the column sums of dS o (q~ k^T) plus k . (dk's part across
      chunks), the latter summed over column tiles of ``tile`` in order.

    Same contract as ``reference_mlstm_bwd``: returns (dq, dk, dv, dig,
    dfg), float32."""
    B, S, H, Dh = q.shape
    T = chunk
    n_chunks = -(-S // T)
    pad = n_chunks * T - S
    inv = 1.0 / math.sqrt(Dh)

    def chunks(x):
        x = torch.nn.functional.pad(x.float(), (0, 0) * (x.dim() - 2)
                                    + (0, pad)) if pad else x.float()
        return x.reshape((B, n_chunks, T) + x.shape[2:])
    qc, kc, vc = chunks(q), chunks(k), chunks(v)          # (B, L, T, H, Dh)
    valid = torch.arange(n_chunks * T, device=q.device).reshape(
        n_chunks, T) < S                                 # (L, T)
    vmask = valid[None, :, :, None]
    lf = torch.nn.functional.logsigmoid(chunks(fg)) * vmask
    igc = chunks(ig) * vmask                             # (B, L, T, H)
    m_t = chunks(stats[0]) * vmask
    den = chunks(stats[1])

    # ---- the forward's gate pass and its chain of m
    b = torch.cumsum(lf.double(), dim=2)
    last = (valid.sum(1) - 1).clamp(min=0)
    bT = b.gather(2, last[None, :, None, None].expand(B, -1, 1, H))[:, :, 0]
    gm = (igc + (bT[:, :, None] - b).float()).masked_fill(~vmask, -math.inf)
    lmax = gm.amax(dim=2)                                # (B, L, H)
    bTf = bT.float()
    m = torch.full((B, H), _xlstm.NEG_INF, device=q.device) \
        if init_state is None else init_state[2].float()
    m_e, m_new = [], []
    for c in range(n_chunks):
        m_e.append(m)
        m = torch.maximum(bTf[:, c] + m, lmax[:, c])
        m_new.append(m)
    m_e, m_new = torch.stack(m_e, 1), torch.stack(m_new, 1)   # (B, L, H)

    # ---- prep: the per-row scalars and dnum
    floor = torch.exp(-m_t)
    active = (den.abs() > floor) & vmask
    invn = torch.where(vmask, 1.0 / torch.maximum(den.abs(), floor),
                       torch.zeros((), device=q.device))
    dhh = (chunks(dh) * chunks(h)).sum(-1)
    dden = torch.where(active, -dhh / den, torch.zeros_like(dhh))
    rows = torch.where(active | ~vmask, torch.zeros_like(dhh), dhh)
    w_out = torch.where(vmask, torch.exp((b.float() + m_e[:, :, None])
                                         - m_t),
                        torch.zeros((), device=q.device))
    g = torch.exp(gm - m_new[:, :, None])                # 0 past L
    f = torch.exp((bTf + m_e) - m_new)                   # (B, L, H)
    dnum = _joined(chunks(dh) * invn[..., None], split)

    # ---- C^T and n entering each chunk, forwards
    if init_state is None:
        C = torch.zeros((B, H, Dh, Dh), device=q.device)
        n = torch.zeros((B, H, Dh), device=q.device)
    else:
        C, n = init_state[0].float(), init_state[1].float()
    C_in, n_in = [], []
    for c in range(n_chunks):
        C_in.append(_joined(C, split))
        n_in.append(n)
        gv = _joined(g[:, c, ..., None] * vc[:, c], split)
        C = f[:, c, ..., None, None] * C + torch.einsum("bshi,bshj->bhij",
                                                        kc[:, c], gv)
        n = f[:, c, ..., None] * n + torch.einsum("bsh,bshi->bhi", g[:, c],
                                                  kc[:, c])
    # ---- D (keys x values) and Dn leaving each chunk, backwards
    D = torch.zeros((B, H, Dh, Dh), device=q.device)
    Dn = torch.zeros((B, H, Dh), device=q.device)
    D_out, Dn_out = [None] * n_chunks, [None] * n_chunks
    for c in range(n_chunks - 1, -1, -1):
        D_out[c], Dn_out[c] = _joined(D, split), Dn
        u = _joined((w_out[:, c] * inv)[..., None] * dnum[:, c], split)
        D = f[:, c, ..., None, None] * D + torch.einsum("bthi,bthj->bhij",
                                                        qc[:, c], u)
        Dn = f[:, c, ..., None] * Dn + torch.einsum(
            "bth,bthi->bhi", w_out[:, c] * dden[:, c] * inv, qc[:, c])

    # ---- outputs, chunk by chunk
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    dq, dk, dv, dig = [], [], [], []
    for c in range(n_chunks):
        mask = causal[None, :, :, None] & valid[c][None, :, None, None] \
            & valid[c][None, None, :, None]
        logw = (b[:, c, :, None] - b[:, c, None]).float() + \
            igc[:, c, None] - m_t[:, c, :, None]          # (B, t, s, H)
        w = torch.where(mask, torch.exp(logw), torch.zeros((),
                                                           device=q.device))
        sraw = torch.einsum("bthd,bshd->btsh", qc[:, c], kc[:, c])
        P = torch.einsum("bthd,bshd->btsh", dnum[:, c], vc[:, c])
        dS = w * (P + dden[:, c, :, None])
        W = w * sraw * inv
        wo, gg = w_out[:, c, ..., None], g[:, c, ..., None]
        dq_c = wo * (torch.einsum("bthj,bhij->bthi", dnum[:, c], C_in[c])
                     + dden[:, c, ..., None] * n_in[c][:, None])
        dq_c = dq_c + torch.einsum("btsh,bshi->bthi", _joined(dS, split),
                                   kc[:, c])
        dk_inter = gg * (torch.einsum("bshj,bhij->bshi", vc[:, c], D_out[c])
                         + Dn_out[c][:, None])
        dk_c = dk_inter + torch.einsum("btsh,bthi->bshi",
                                       _joined(dS * inv, split), qc[:, c])
        dv_c = gg * torch.einsum("bshi,bhij->bshj", kc[:, c], D_out[c])
        dv_c = dv_c + torch.einsum("btsh,bthj->bshj", _joined(W, split),
                                   dnum[:, c])
        dig_c = (dS * sraw * inv).sum(dim=1)               # (B, s, H)
        for i0 in range(0, Dh, tile):
            dig_c = dig_c + (kc[:, c, ..., i0:i0 + tile]
                             * dk_inter[..., i0:i0 + tile]).sum(-1)
        dq.append(dq_c * inv)
        dk.append(dk_c)
        dv.append(dv_c)
        dig.append(dig_c)

    def whole(xs):
        x = torch.stack(xs, dim=1)
        return x.reshape((B, n_chunks * T) + x.shape[3:])[:, :S]
    dig = whole(dig)
    rows = rows.reshape(B, n_chunks * T, H)[:, :S]
    dF = rows - dig
    dlf = torch.flip(torch.cumsum(torch.flip(dF, (1,)), dim=1), (1,))
    dfg = dlf * torch.sigmoid(-fg.float())
    return whole(dq), whole(dk), whole(dv), dig, dfg
