"""Plain PyTorch version of the RG-LRU scan kernel.

Same contract as ``repro.models.rglru.rglru``: the gates are fused in
float32, then the diagonal recurrence ``h_t = a_t * h_{t-1} + b_t`` runs
over time.  PyTorch has no associative scan, so the recurrence is a loop
over ``t``, in the sequential order.  With the gate biases, ``ga + b_a``
and ``gx + b_i`` are formed first, with PyTorch's promotion (a bf16
product and a float32 bias add in float32).

``windowed_rglru`` is the CUDA kernel's order of the same arithmetic
(windows cut into segments, each segment's product of a and its h from 0,
the segments composed into each segment's incoming h), for checking that
order on the CPU; ``oracle_rglru`` is the recurrence in float64.
``reference_rglru_bwd`` is the plain version of the backward kernel: the
gradient by explicit formulas, not by autograd; ``rglru_bwd_route_model``
is the backward kernel's order of the same arithmetic (windows, segments,
the fixed-order sums).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RGLRU_C = 8.0  # the paper's fixed temperature


def _gates_with_log(x, lam, ga, gx):
    log_a = -RGLRU_C * F.softplus(lam.float()) * torch.sigmoid(ga.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return log_a, a, beta * (torch.sigmoid(gx.float()) * x.float())


def rglru_gates(x, lam, ga, gx):
    """(a, b) of the recurrence, float32: ``log_a = -c softplus(lam)
    sigmoid(ga)``, ``a = exp(log_a)``, ``b = sqrt(1 - a^2) sigmoid(gx) x``
    (``1 - a^2`` as ``-expm1(2 log_a)``, stable near a = 1)."""
    return _gates_with_log(x, lam, ga, gx)[1:]


def _biased(ga, gx, b_a, b_i):
    if b_a is None:
        return ga, gx
    return ga + b_a, gx + b_i


def reference_rglru(x, lam, ga, gx, h0=None, *, b_a=None, b_i=None):
    """x, ga, gx: (B, S, D); lam: (D,); h0: (B, D) or None (zeros); b_a,
    b_i: (D,) float32 gate biases or None.

    Returns (y: (B, S, D) float32, h_last: (B, D) float32)."""
    a, b = rglru_gates(x, lam, *_biased(ga, gx, b_a, b_i))
    B, S, D = b.shape
    h = b.new_zeros((B, D)) if h0 is None else h0.float()
    y = torch.empty_like(b)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, y[:, -1].clone()


def oracle_rglru(x, lam, ga, gx, h0=None, *, b_a=None, b_i=None):
    """``reference_rglru``'s y in float64, step by step, from the float32
    gates the contract forms (``ga + b_a`` and ``gx + b_i`` with PyTorch's
    promotion): the yardstick for a long memory, where each float32 a's
    rounding adds up over thousands of steps."""
    ga, gx = _biased(ga, gx, b_a, b_i)
    ga, gx = ga.double(), gx.double()
    log_a = -RGLRU_C * F.softplus(lam.double()) * torch.sigmoid(ga)
    a = torch.exp(log_a)
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * torch.sigmoid(gx) \
        * x.double()
    B, S, D = b.shape
    h = b.new_zeros((B, D)) if h0 is None else h0.double()
    y = torch.empty_like(b)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y


def windowed_rglru(x, lam, ga, gx, h0=None, *, b_a=None, b_i=None,
                   window: int = 64, segments: int = 8):
    """``reference_rglru`` in the CUDA kernel's order: S in windows of
    ``window`` steps, each cut into ``segments`` segments of window /
    segments steps.  Per segment, pass 1 forms (A = exp(sum log_a), one
    rounding where a product of the a's has one a step, H = its h from 0);
    the carry composes the window's segments in turn from the incoming
    h, giving each segment's h_in and the next window's h; pass 2 runs the
    recurrence over the segment from its h_in.  Returns (y, h_last), h_last
    being y's last step."""
    log_a, a, b = _gates_with_log(x, lam, *_biased(ga, gx, b_a, b_i))
    B, S, D = b.shape
    n = -(-S // window)
    pad = n * window - S            # steps past S: log_a = 0, a = 1, b = 0
    L = window // segments
    log_a, a, b = (F.pad(t, (0, 0, 0, pad), value=v).reshape(
        B, n, segments, L, D) for t, v in ((log_a, 0.0), (a, 1.0), (b, 0.0)))
    sum_log_a = torch.zeros_like(b[:, :, :, 0])
    H = torch.zeros_like(b[:, :, :, 0])
    for i in range(L):                                  # pass 1
        H = a[:, :, :, i] * H + b[:, :, :, i]
        sum_log_a = sum_log_a + log_a[:, :, :, i]
    A = torch.exp(sum_log_a)
    h = b.new_zeros((B, D)) if h0 is None else h0.float()
    h_in = torch.empty_like(H)
    for w in range(n):                                  # carry
        for q in range(segments):
            h_in[:, w, q] = h
            h = A[:, w, q] * h + H[:, w, q]
    y = torch.empty_like(b)
    h = h_in
    for i in range(L):                                  # pass 2
        h = a[:, :, :, i] * h + b[:, :, :, i]
        y[:, :, :, i] = h
    y = y.reshape(B, n * window, D)[:, :S]
    return y, y[:, -1].clone()


def reference_rglru_bwd(x, lam, ga, gx, y, dy, h0=None, dh_last=None, *,
                        b_a=None, b_i=None):
    """The gradient of ``reference_rglru`` by explicit formulas: x, lam, ga,
    gx, h0, b_a, b_i as there; y its output (the h_t, float32); dy (B, S, D)
    and dh_last (B, D) or None the gradients of y and h_last.

    With u = sigmoid(ga + b_a), sp = softplus(lam), log_a = -c sp u,
    a = exp(log_a), beta = sqrt(-expm1(2 log_a)), i = sigmoid(gx + b_i):
    the carry runs backwards, g_t = dy_t + a_{t+1} g_{t+1} (g_{S-1} also
    takes dh_last); da_t = g_t h_{t-1} (h_{-1} = h0 or 0), db_t = g_t,
    dh0 = a_0 g_0; dlog_a = da a - db i x a^2 / beta (autograd's own
    derivative of sqrt(-expm1(2 log_a)), with its singularity at beta 0);
    d(ga + b_a) = dlog_a (-c sp) u (1 - u); dlam = sum over B, S of
    dlog_a (-c u) sigmoid(lam); d(gx + b_i) = db beta x i (1 - i);
    dx = db beta i.

    Returns (dx, dlam, dga, dgx, dh0, db_a, db_i): dx in x's dtype, dga and
    dgx in ga's, dlam, dh0 (None without h0), db_a and db_i (None without
    the biases; the float32 sums over B and S of d(ga + b_a) and
    d(gx + b_i)) in float32."""
    gab, gxb = _biased(ga, gx, b_a, b_i)
    u = torch.sigmoid(gab.float())
    sp = F.softplus(lam.float())
    log_a = -RGLRU_C * sp * u
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    i = torch.sigmoid(gxb.float())
    x32 = x.float()
    B, S, D = x.shape
    g = torch.empty_like(a)
    carry = torch.zeros((B, D), dtype=torch.float32, device=x.device) \
        if dh_last is None else dh_last.float()
    for t in range(S - 1, -1, -1):
        carry = dy[:, t].float() + carry
        g[:, t] = carry
        carry = a[:, t] * carry
    h_prev = torch.zeros_like(a)
    h_prev[:, 1:] = y[:, :-1].float()
    if h0 is not None:
        h_prev[:, 0] = h0.float()
    dlog_a = g * h_prev * a - g * i * x32 * a * a / beta
    dgab = dlog_a * (-RGLRU_C * sp) * u * (1.0 - u)
    dlam = (dlog_a * (-RGLRU_C * u)).sum(dim=(0, 1)) * torch.sigmoid(
        lam.float())
    dgxb = g * beta * x32 * i * (1.0 - i)
    dx = (g * beta * i).to(x.dtype)
    dh0 = None if h0 is None else carry
    db_a = None if b_a is None else dgab.sum(dim=(0, 1))
    db_i = None if b_i is None else dgxb.sum(dim=(0, 1))
    return (dx, dlam, dgab.to(ga.dtype), dgxb.to(gx.dtype), dh0, db_a,
            db_i)


# The backward kernel's cut of the work (csrc/rglru_scan_bwd.cu: the
# blocks' W by the gates' dtype, their P)
BWD_WINDOW = {torch.bfloat16: 128, torch.float32: 64}
BWD_SEGMENTS = 16


def rglru_bwd_route_model(x, lam, ga, gx, y, dy, h0=None, dh_last=None, *,
                          b_a=None, b_i=None, window=None,
                          segments=BWD_SEGMENTS):
    """``reference_rglru_bwd`` in the backward kernel's order, in float32.

    S is cut into windows of ``window`` steps (None: the kernel's for ga's
    dtype), each into ``segments`` segments.  Pass 1 forms each step's
    gates once (a = 1 + em from em = expm1(log_a), 1 - a^2 = -em (2 + em),
    1 / beta as rsqrt of it) and each segment's reverse pair (A =
    exp(sum log_a), C = its carry out from 0).  The windows are walked
    backwards from dh_last, the segments composed the last first from the
    window's carry, and pass 2 runs g = dy + c over each segment from its
    carry in; the last carry is dh0.  dlam's, db_a's and db_i's terms are
    summed per (b, segment, channel) in the walked order, then over the
    segments, then over b, in order.  Returns what ``reference_rglru_bwd``
    returns."""
    gab, gxb = _biased(ga, gx, b_a, b_i)
    B, S, D = x.shape
    u = torch.sigmoid(gab.float())
    sp = F.softplus(lam.float())
    coef = -RGLRU_C * sp
    log_a = coef * u
    em = torch.expm1(log_a)
    bsq = -em * (2.0 + em)
    a = 1.0 + em
    i = torch.sigmoid(gxb.float())
    x32 = x.float()
    h_prev = torch.zeros_like(a)
    h_prev[:, 1:] = y[:, :-1].float()
    if h0 is not None:
        h_prev[:, 0] = h0.float()
    p = h_prev * a - i * x32 * a * a * torch.rsqrt(bsq)
    kl = p * u                          # dlog_a (-c u) = -c g kl
    ka = kl * coef * (1.0 - u)          # d(ga + b_a) = g ka
    kx = torch.sqrt(bsq) * i            # dx = g kx
    ki = kx * x32 * (1.0 - i)           # d(gx + b_i) = g ki
    dy = dy.float()

    if window is None:
        window = BWD_WINDOW[ga.dtype]
    n = -(-S // window)
    L = window // segments
    pad = n * window - S            # steps past S: a = 1, the rest 0

    def cut(t, v=0.0):
        return F.pad(t, (0, 0, 0, pad), value=v).reshape(B, n, segments, L,
                                                         D)
    log_a_w, a_w, dy_w = cut(log_a), cut(a, 1.0), cut(dy)
    kl_w, ka_w, kx_w, ki_w = cut(kl), cut(ka), cut(kx), cut(ki)

    # pass 1: each segment's (A, C)
    sum_log_a = torch.zeros_like(dy_w[:, :, :, 0])
    C = torch.zeros_like(sum_log_a)
    for s in range(L - 1, -1, -1):
        C = a_w[:, :, :, s] * (dy_w[:, :, :, s] + C)
        sum_log_a = sum_log_a + log_a_w[:, :, :, s]
    A = torch.exp(sum_log_a)

    # the carries: the windows walked backwards from dh_last
    carry = dy.new_zeros((B, D)) if dh_last is None else dh_last.float()
    c_in = torch.empty_like(A)
    for w in range(n - 1, -1, -1):
        for q in range(segments - 1, -1, -1):
            c_in[:, w, q] = carry
            carry = A[:, w, q] * carry + C[:, w, q]
    dh0 = None if h0 is None else carry

    # pass 2: g over each segment from its carry in, and every gradient
    g = torch.empty_like(dy_w)
    c = c_in
    for s in range(L - 1, -1, -1):
        g[:, :, :, s] = dy_w[:, :, :, s] + c
        c = a_w[:, :, :, s] * g[:, :, :, s]
    terms = [g * kl_w, g * ka_w, g * ki_w]

    # the sums: per (b, segment, channel) in the walked order (the windows
    # backwards, each segment's steps backwards), then over the segments,
    # then over b
    sums = []
    for t in terms:
        acc = dy.new_zeros((B, segments, D))
        for w in range(n - 1, -1, -1):
            for s in range(L - 1, -1, -1):
                acc = acc + t[:, w, :, s]
        part = dy.new_zeros((B, D))
        for q in range(segments):
            part = part + acc[:, q]
        total = dy.new_zeros((D,))
        for r in part:
            total = total + r
        sums.append(total)

    def out(t, like):
        return t.reshape(B, n * window, D)[:, :S].to(like.dtype)
    dx = out(g * kx_w, x)
    dgab = out(terms[1], ga)
    dgxb = out(terms[2], gx)
    dlam = -RGLRU_C * sums[0] * torch.sigmoid(lam.float())
    db_a = None if b_a is None else sums[1]
    db_i = None if b_i is None else sums[2]
    return dx, dlam, dgab, dgxb, dh0, db_a, db_i
