"""The RG-LRU backward kernel's order of arithmetic, on the CPU.

``ref.rglru_bwd_route_model`` is the backward kernel's algorithm
(csrc/rglru_scan_bwd.cu) in plain PyTorch: S walked backwards in windows
(128 steps for bf16 gates, 64 for float32) cut into segments, each
segment's reverse pair (A = exp(sum log_a), C = its carry out from 0)
composed from the window's carry, and the per-channel sums taken per (b,
segment), then over the segments, then over b, in order.  It is
held here, in float32, against the plain backward
(``ref.reference_rglru_bwd``, explicit formulas) and against ``jax.grad``
of the reference's plain recurrence (``repro.models.rglru.rglru``), on the
same numpy inputs from a seed, each gradient within 1e-4 of its own largest
entry; and, where a is near 1 over a long memory, against autograd of the
recurrence in float64.  The CUDA kernel itself is held against the plain
backward on the card (tests/test_torch_kernels_gpu.py) and, on the CPU,
through ``tools/cuda_emu/rglru_bwd_emu.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JG
from repro_torch.kernels.rglru_scan import ref

# float32 gradients against their own largest entry: the same formulas in
# another order (the carry over windows and segments; the sums over B * S
# in per-block partials); ~1e-7 apart, 1e-4 is the bar
RTOL = 1e-4
NAMES = ("x", "lam", "ga", "gx", "h0", "b_a", "b_i")


def _rel(got, want):
    got, want = (t if isinstance(t, torch.Tensor) else
                 torch.from_numpy(np.array(t)) for t in (got, want))
    scale = float(want.abs().max())
    return float((got.double() - want.double()).abs().max()) / scale


def _inputs(B, S, D, seed, u=None):
    """numpy float32 x, lam, ga, gx, h0, b_a, b_i, dy, dh_last; with
    ``u``, lam puts a in [u0, u1] at zero gate."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = dict(x=f(B, S, D), lam=f(D), ga=f(B, S, D), gx=f(B, S, D),
             h0=f(B, D), b_a=0.5 * f(D), b_i=0.5 * f(D), dy=f(B, S, D),
             dh_last=f(B, D))
    if u is not None:
        uu = rng.uniform(u[0], u[1], D)
        a["lam"] = np.log(np.expm1(-np.log(uu) / ref.RGLRU_C)).astype(
            np.float32)
        a["ga"] = 0.1 * a["ga"]
        a["b_a"] = np.zeros_like(a["b_a"])
    return a


# (B, S, D, h0, dh_last, fused biases, window or None: the kernel's for
# ga's dtype, 64 steps for float32, segments).  S 1; the float32 window's
# edges (63, 64, 65) and the bf16 one's (127, 128, 129); D not a multiple of
# 8 (77) or of the block's 32 channels (200, 4100); windows of 32 steps,
# S on a window's edge and off it (96, 127, 128, 129, 160); the segments'
# edges (4 steps in a float32 window of 64: S 4, 5; 8 in bf16's 128: S 8,
# 9); 8 segments a window (S 1000 over 16 windows, the last ragged); many
# windows with B 2 (S 1100) and B 1 (S 1025, D 512).
CASES = [
    (2, 1, 16, True, True, True, None, 16),
    (3, 63, 77, True, True, False, None, 16),
    (2, 64, 24, False, True, True, None, 16),
    (2, 65, 200, True, False, True, None, 16),
    (1, 129, 4100, True, True, True, None, 16),
    (2, 127, 16, True, True, True, 128, 16),
    (2, 128, 16, False, False, True, 128, 16),
    (1, 129, 16, True, True, False, 128, 16),
    (1, 96, 16, True, True, True, 32, 16),
    (2, 127, 16, True, True, True, 32, 16),
    (2, 128, 16, False, True, False, 32, 16),
    (2, 129, 16, True, False, True, 32, 16),
    (2, 160, 16, True, True, True, 32, 16),
    (2, 4, 16, True, True, True, None, 16),
    (2, 5, 16, True, True, False, None, 16),
    (1, 8, 16, True, False, True, 128, 16),
    (1, 9, 16, False, True, True, 128, 16),
    (2, 1000, 24, True, True, True, None, 8),
    (2, 1100, 40, True, True, True, None, 16),
    (1, 1025, 512, True, True, True, None, 16),
]


@pytest.mark.parametrize("case", CASES)
def test_route_model_matches_plain_and_jax(case):
    B, S, D, with_h0, with_dhl, fused, window, segments = case
    a = _inputs(B, S, D, seed=S + D)
    t = {k: torch.tensor(v) for k, v in a.items()}
    h0 = t["h0"] if with_h0 else None
    dh_last = t["dh_last"] if with_dhl else None
    bias = dict(b_a=t["b_a"], b_i=t["b_i"]) if fused else {}
    y, _ = ref.reference_rglru(t["x"], t["lam"], t["ga"], t["gx"], h0,
                               **bias)
    got = ref.rglru_bwd_route_model(t["x"], t["lam"], t["ga"], t["gx"], y,
                                    t["dy"], h0, dh_last, window=window,
                                    segments=segments, **bias)
    plain = ref.reference_rglru_bwd(t["x"], t["lam"], t["ga"], t["gx"], y,
                                    t["dy"], h0, dh_last, **bias)

    # jax.grad of the reference's plain recurrence, biases added outside
    def jfn(x, lam, ga, gx, h0, b_a, b_i):
        if fused:
            ga, gx = ga + b_a, gx + b_i
        return JG.rglru(x, lam, ga, gx, h0 if with_h0 else None)
    _, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(a[k]) for k in NAMES))
    jg = vjp((jnp.asarray(a["dy"]), jnp.asarray(
        a["dh_last"] if with_dhl else np.zeros_like(a["dh_last"]))))

    for name, g, p, j in zip(NAMES, got, plain, jg):
        assert (g is None) == (p is None), name
        if g is None:
            continue
        assert g.dtype == torch.float32 and g.shape == p.shape, name
        assert _rel(g, p) <= RTOL, name
        assert _rel(g, j) <= RTOL, name


@pytest.mark.parametrize("window", [None, 128])
def test_route_model_long_memory_against_float64(window):
    """a from 0.999 to 0.9999 over 1000 steps, from h0 with dh_last, in
    the float32 windows of 64 steps and the bf16 ones of 128: the carry
    runs through hundreds of a near 1, where each float32 a's rounding adds
    up; the model's gradients within 1e-4 of autograd of the recurrence in
    float64 (and no further than twice the plain backward's own error, where
    that is larger)."""
    B, S, D = 2, 1000, 16
    a = _inputs(B, S, D, seed=3, u=(0.999, 0.9999))
    t = {k: torch.tensor(v) for k, v in a.items()}
    args = [t[k] for k in NAMES]
    y, _ = ref.reference_rglru(*args[:5], b_a=args[5], b_i=args[6])
    got = ref.rglru_bwd_route_model(*args[:4], y, t["dy"], args[4],
                                    t["dh_last"], b_a=args[5], b_i=args[6],
                                    window=window)
    plain = ref.reference_rglru_bwd(*args[:4], y, t["dy"], args[4],
                                    t["dh_last"], b_a=args[5], b_i=args[6])
    leaves = [v.double().requires_grad_() for v in args]
    y64 = ref.oracle_rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    truth = torch.autograd.grad(
        (y64 * t["dy"].double()).sum()
        + (y64[:, -1] * t["dh_last"].double()).sum(), leaves)
    for name, g, p, w in zip(NAMES, got, plain, truth):
        assert _rel(g, w) <= max(RTOL, 2 * _rel(p, w)), name
