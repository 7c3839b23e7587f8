"""The port's recurrent backwards against autodiff, on the CPU.

The TPU kernels rglru_scan and mlstm_scan have no gradient of their own:
the reference trains through ``jax.grad`` of its plain functions
(``repro.models.rglru.rglru`` and ``repro.models.xlstm.mlstm_chunkwise``).
The port's plain backwards, ``ref.reference_rglru_bwd`` and
``ref.reference_mlstm_bwd`` (explicit formulas, the plain versions of the
CUDA backward kernels), are held here against autograd of the port's plain
forwards and against ``jax.grad`` of the reference's, on the same numpy
inputs from a seed, in float32; and the two autograd functions' wiring
runs with fake launches that do the kernels' work with the plain versions.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_kernels_gpu.py)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JG
from repro.models import xlstm as JX
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan import ref as ml_ref
from repro_torch.kernels.rglru_scan import kernel as rg_kernel
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref

# float32 gradients, each against its own largest entry: the formulas are
# autograd's own, summed in another order (the reverse carry over at most
# 200 steps, the chunks' states over Dh 16)
RTOL = 1e-4


def _rel(got, want, floor=0.0):
    got, want = (t if isinstance(t, torch.Tensor) else
                 torch.from_numpy(np.array(t)) for t in (got, want))
    scale = max(float(want.abs().max()), floor)
    return float((got.float() - want.float()).abs().max()) / scale


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------

def _rglru_inputs(B, S, D, seed, lam_shift=0.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, S, D), lam=f(D) + np.float32(lam_shift),
                ga=f(B, S, D), gx=f(B, S, D), h0=f(B, D), b_a=f(D),
                b_i=f(D), dy=f(B, S, D), dh_last=f(B, D))


# (B, S, D, h0, biases, dh_last, lam shift): lam - 9 puts a near 1
# (a >= 0.9993: softplus(lam) ~ 1e-4)
_RGLRU_CASES = [(2, 37, 16, False, False, False, 0.0),
                (2, 37, 16, True, False, False, 0.0),
                (1, 64, 24, False, True, False, 0.0),
                (2, 65, 8, False, False, True, 0.0),
                (2, 129, 16, True, True, True, 0.0),
                (1, 1, 16, True, True, True, 0.0),
                (2, 200, 16, True, True, True, -9.0)]


@pytest.mark.parametrize("case", _RGLRU_CASES)
def test_plain_rglru_backward_matches_autograd_and_jax(case):
    B, S, D, with_h0, with_bias, with_dhl, shift = case
    a = _rglru_inputs(B, S, D, seed=S + D, lam_shift=shift)
    names = ["x", "lam", "ga", "gx"] + (["h0"] if with_h0 else []) + \
        (["b_a", "b_i"] if with_bias else [])
    t = {k: torch.tensor(a[k], requires_grad=True) for k in names}
    h0 = t.get("h0")
    y, h_last = rg_ref.reference_rglru(t["x"], t["lam"], t["ga"], t["gx"],
                                       h0, b_a=t.get("b_a"),
                                       b_i=t.get("b_i"))
    dy = torch.tensor(a["dy"])
    dh_last = torch.tensor(a["dh_last"]) if with_dhl else None
    outs, grads = [y], [dy]
    if with_dhl:
        outs, grads = [y, h_last], [dy, dh_last]
    auto = dict(zip(names, torch.autograd.grad(outs, [t[k] for k in names],
                                               grads)))

    # jax.grad of the reference's plain recurrence, biases added outside
    def jfn(x, lam, ga, gx, h0, b_a, b_i):
        if with_bias:
            ga, gx = ga + b_a, gx + b_i
        return JG.rglru(x, lam, ga, gx, h0 if with_h0 else None)
    jy, vjp = jax.vjp(jax.jit(jfn), *(jnp.asarray(a[k]) for k in
                                      ("x", "lam", "ga", "gx", "h0", "b_a",
                                       "b_i")))
    jg = dict(zip(("x", "lam", "ga", "gx", "h0", "b_a", "b_i"), vjp((
        jnp.asarray(a["dy"]),
        jnp.asarray(a["dh_last"] if with_dhl else np.zeros_like(
            a["dh_last"]))))))

    plain = rg_ref.reference_rglru_bwd(
        t["x"].detach(), t["lam"].detach(), t["ga"].detach(),
        t["gx"].detach(), y.detach(), dy,
        None if h0 is None else h0.detach(), dh_last,
        b_a=t["b_a"].detach() if with_bias else None,
        b_i=t["b_i"].detach() if with_bias else None)
    plain = dict(zip(("x", "lam", "ga", "gx", "h0", "b_a", "b_i"), plain))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy[0]),
                               rtol=1e-5, atol=1e-5)
    for k in names:
        assert plain[k].dtype == torch.float32
        assert _rel(plain[k], auto[k]) <= RTOL, k
        assert _rel(plain[k], jg[k]) <= RTOL, k
    for k in ("h0", "b_a", "b_i"):
        if k not in names:
            assert plain[k] is None


def test_plain_rglru_backward_keeps_the_input_dtypes():
    """dx in x's dtype, dga and dgx in ga's, the rest float32: the
    promotion of a bf16 product plus a float32 bias."""
    a = _rglru_inputs(2, 20, 8, seed=1)
    x = torch.tensor(a["x"]).bfloat16()
    ga, gx = (torch.tensor(a[k]).bfloat16() for k in ("ga", "gx"))
    lam, b_a, b_i = (torch.tensor(a[k]) for k in ("lam", "b_a", "b_i"))
    y, _ = rg_ref.reference_rglru(x, lam, ga, gx, b_a=b_a, b_i=b_i)
    dx, dlam, dga, dgx, dh0, db_a, db_i = rg_ref.reference_rglru_bwd(
        x, lam, ga, gx, y, torch.tensor(a["dy"]), b_a=b_a, b_i=b_i)
    assert (dx.dtype, dga.dtype, dgx.dtype) == (torch.bfloat16,) * 3
    assert dlam.dtype == db_a.dtype == db_i.dtype == torch.float32
    assert dh0 is None
    xs = [t.clone().requires_grad_() for t in (x, lam, ga, gx, b_a, b_i)]
    yy, _ = rg_ref.reference_rglru(xs[0], xs[1], xs[2], xs[3], b_a=xs[4],
                                   b_i=xs[5])
    want = torch.autograd.grad(yy, xs, torch.tensor(a["dy"]))
    for got, w in zip((dx, dlam, dga, dgx, db_a, db_i), want):
        assert got.dtype == w.dtype
        assert _rel(got, w) <= 1e-2   # bf16 outputs: half an ulp, 2**-9


def _fake_rglru_kernels(monkeypatch):
    calls = {"fwd": 0, "bwd": 0}

    def launch(x, lam, ga, gx, b_a, b_i, h0, y, h_last):
        yy, hl = rg_ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
        y.copy_(yy)
        h_last.copy_(hl)
        calls["fwd"] += 1

    def launch_bwd(x, lam, ga, gx, b_a, b_i, h0, y, dy, dh_last, dx, dga,
                   dgx, dlam, db_a, db_i, dh0):
        assert dy.dtype == torch.float32 and dy.is_contiguous()
        grads = rg_ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0,
                                           dh_last, b_a=b_a, b_i=b_i)
        for dst, g in zip((dx, dlam, dga, dgx, dh0, db_a, db_i), grads):
            assert (dst is None) == (g is None)
            if dst is not None:
                dst.copy_(g)
        calls["bwd"] += 1
    monkeypatch.setattr(rg_kernel, "launch", launch)
    monkeypatch.setattr(rg_kernel, "launch_bwd", launch_bwd)
    return calls


@pytest.mark.parametrize("use_h_last", [False, True])
def test_rglru_autograd_function_wiring(monkeypatch, use_h_last):
    """RGLRUScanFunction saves y, calls the backward launch once, and
    returns its gradients to x, lam, ga, gx, h0 and the biases; a gradient
    of h_last alone, or of y alone, reaches it."""
    calls = _fake_rglru_kernels(monkeypatch)
    a = _rglru_inputs(2, 33, 8, seed=5)
    names = ("x", "lam", "ga", "gx", "h0", "b_a", "b_i")
    t = [torch.tensor(a[k], requires_grad=True) for k in names]
    y, h_last = rg_ref.reference_rglru(t[0], t[1], t[2], t[3], t[4],
                                       b_a=t[5], b_i=t[6])
    out = h_last if use_h_last else y
    g = torch.tensor(a["dh_last" if use_h_last else "dy"])
    want = torch.autograd.grad(out, t, g)
    fy, fh = rg_ops.RGLRUScanFunction.apply(*t)
    got = torch.autograd.grad(fh if use_h_last else fy, t, g)
    assert calls == {"fwd": 1, "bwd": 1}
    for k, gg, w in zip(names, got, want):
        assert _rel(gg, w) <= 1e-6, k


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def _mlstm_inputs(B, S, H, Dh, seed, stress=None):
    """q, k, v, ig, fg and dh as numpy.  ``stress``: "big" meets strongly
    negative forget gates with large input gates (m large, the clamp never
    active); "clamp" lowers the input gates so that the denominator's
    floor exp(-m) takes most rows."""
    rng = np.random.default_rng(seed)
    q, k, v, dh = (rng.standard_normal((B, S, H, Dh)).astype(np.float32)
                   for _ in range(4))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (3.0 + rng.standard_normal((B, S, H))).astype(np.float32)
    if stress == "big":
        ig, fg = ig * 4 + 12, fg * 2 - 16
    elif stress == "clamp":
        ig = ig - 8
    return (q, k, v, ig, fg), dh


_jax_chunkwise = jax.jit(JX.mlstm_chunkwise, static_argnames="chunk")


def _jax_mlstm_grads(xs, dh, chunk):
    def f(q, k, v, ig, fg):
        return _jax_chunkwise(q, k, v, ig, fg, chunk=chunk)[0]
    h, vjp = jax.vjp(f, *(jnp.asarray(a) for a in xs))
    return np.asarray(h), [np.asarray(g) for g in vjp(jnp.asarray(dh))]


# (B, S, H, Dh, stress): S ragged against every chunk below, one chunk of
# 256 at S 150; "clamp" has the denominator's floor active on most rows
_MLSTM_CASES = [(2, 150, 2, 16, None), (1, 150, 2, 16, "clamp"),
                (2, 64, 1, 8, None), (1, 1, 2, 8, None)]


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("case", _MLSTM_CASES)
def test_plain_mlstm_backward_matches_autograd_and_jax(case, chunk):
    """The gradients to q, k, v, ig and fg do not depend on the chunk of
    the backward, nor on that of the statistics, and match autograd of the
    port's plain chunkwise forward and jax.grad of the reference's."""
    B, S, H, Dh, stress = case
    xs, dh = _mlstm_inputs(B, S, H, Dh, seed=S + Dh, stress=stress)
    ts = [torch.tensor(a, requires_grad=True) for a in xs]
    h, _ = ml_ref.reference_mlstm(*ts, chunk=min(16, S))
    auto = torch.autograd.grad(h, ts, torch.tensor(dh))
    jh, jg = _jax_mlstm_grads(xs, dh, chunk=min(16, S))
    np.testing.assert_allclose(h.detach().numpy(), jh, rtol=1e-5, atol=1e-5)
    plain_ts = [t.detach() for t in ts]
    stats = ml_ref.reference_mlstm_stats(*plain_ts, chunk=128 if chunk == 64
                                         else 64)
    if stress == "clamp":
        m, den = stats[:2]
        assert float((den.abs() <= torch.exp(-m)).float().mean()) > 0.5
    plain = ml_ref.reference_mlstm_bwd(*plain_ts, h.detach(), stats,
                                       torch.tensor(dh), chunk=chunk)
    # where one key meets each query (S 1) dq and dk are 0 in exact
    # arithmetic and hold only rounding: each gradient is held against the
    # largest one's scale where its own is below a thousandth of it
    top = max(float(a.abs().max()) for a in auto)
    for name, p, a, j in zip(("q", "k", "v", "ig", "fg"), plain, auto, jg):
        assert p.dtype == torch.float32
        assert _rel(p, a, 1e-3 * top) <= RTOL, name
        assert _rel(p, j, 1e-3 * top) <= RTOL, name


@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_plain_mlstm_backward_under_stress_against_float64(chunk):
    """Strongly negative forget gates meet large input gates: float32
    cancels in the denominator and in the gates' sums, and autograd of the
    port's plain forward and jax.grad of the reference's miss the float64
    gradient by up to 2.4e-4 of the largest one.  The plain backward is held
    against autograd of the sequential recurrence in float64, at twice
    autograd's own error in float32 (and never above 5e-4)."""
    xs, dh = _mlstm_inputs(1, 150, 2, 16, seed=1, stress="big")
    ts = [torch.tensor(a, requires_grad=True) for a in xs]
    h, _ = ml_ref.reference_mlstm(*ts, chunk=16)
    auto = torch.autograd.grad(h, ts, torch.tensor(dh))
    t64 = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
           for a in xs]
    h64, _ = ml_ref.sequential_oracle(*t64, dtype=torch.float64)
    want = torch.autograd.grad(h64, t64, torch.tensor(dh, dtype=torch.float64))
    plain_ts = [t.detach() for t in ts]
    stats = ml_ref.reference_mlstm_stats(*plain_ts, chunk=128)
    plain = ml_ref.reference_mlstm_bwd(*plain_ts, h.detach(), stats,
                                       torch.tensor(dh), chunk=chunk)
    top = max(float(w.abs().max()) for w in want)
    own = max(_rel(a, w, 1e-3 * top) for a, w in zip(auto, want))
    bar = max(RTOL, 2 * own)
    assert bar <= 5e-4
    for name, p, w in zip(("q", "k", "v", "ig", "fg"), plain, want):
        assert _rel(p, w, 1e-3 * top) <= bar, name


@pytest.mark.parametrize("chunk", [8, 64, 128])
def test_mlstm_stats_describe_the_forward(chunk):
    """reference_mlstm_stats' rows give the forward's h (num / max(|den|,
    exp(-m))), and the m entering each chunk is the row stabiliser of the
    step before it, which is what lets a backward take its boundaries'
    stabilisers from m at any chunk."""
    xs, _ = _mlstm_inputs(2, 150, 2, 16, seed=3)
    ts = [torch.tensor(a) for a in xs]
    m, den, m_e = ml_ref.reference_mlstm_stats(*ts, chunk=chunk)
    n_chunks = -(-150 // chunk)
    assert m.shape == den.shape == (2, 150, 2)
    assert m_e.shape == (2, n_chunks, 2)
    assert torch.all(m_e[:, 0] == -1e30)
    for c in range(1, n_chunks):
        assert torch.equal(m_e[:, c], m[:, c * chunk - 1])
    seq_h, _ = ml_ref.sequential_oracle(*ts, dtype=torch.float64)
    h, _ = ml_ref.reference_mlstm(*ts, chunk=chunk)
    assert _rel(h, seq_h) <= 1e-5
    # m_t is the running max of the log weights F_t - F_s + ig_s
    lf = torch.nn.functional.logsigmoid(ts[4].double())
    F = torch.cumsum(lf, dim=1)
    logw = F[:, :, None] - F[:, None] + ts[3].double()[:, None]
    causal = torch.ones(150, 150, dtype=torch.bool).tril()[None, :, :, None]
    want_m = logw.masked_fill(~causal, -math.inf).amax(dim=2)
    assert float((m.double() - want_m).abs().max()) <= 1e-4


def test_plain_mlstm_backward_with_an_initial_state():
    """A constant initial state adds terms to num and den: its rows' sums
    and dq are held against autograd."""
    xs, dh = _mlstm_inputs(1, 100, 2, 12, seed=9)
    rng = np.random.default_rng(10)
    init = (torch.tensor(rng.standard_normal((1, 2, 12, 12)),
                         dtype=torch.float32),
            torch.tensor(rng.standard_normal((1, 2, 12)),
                         dtype=torch.float32),
            torch.tensor(rng.standard_normal((1, 2)), dtype=torch.float32))
    ts = [torch.tensor(a, requires_grad=True) for a in xs]
    h, _ = ml_ref.reference_mlstm(*ts, chunk=20, init_state=init)
    auto = torch.autograd.grad(h, ts, torch.tensor(dh))
    plain_ts = [t.detach() for t in ts]
    stats = ml_ref.reference_mlstm_stats(*plain_ts, chunk=64,
                                         init_state=init)
    plain = ml_ref.reference_mlstm_bwd(*plain_ts, h.detach(), stats,
                                       torch.tensor(dh), chunk=32,
                                       init_state=init)
    top = max(float(a.abs().max()) for a in auto)
    for p, a in zip(plain, auto):
        assert _rel(p, a, 1e-3 * top) <= RTOL


# (B, S, H, Dh, with an initial state, stress): the wgmma backward's chunk
# (128) ragged (200, 136) and a single step, with and without an initial
# state, and the denominator's floor on most rows
_BWD_MODEL_CASES = [(2, 200, 2, 64, False, None), (2, 136, 2, 64, True, None),
                    (2, 1, 2, 64, False, None), (2, 1, 2, 64, True, None),
                    (2, 200, 2, 64, True, "clamp")]
# The wgmma route's model with its operands split: each float32 factor
# keeps 16 of its bits (|x - hi - lo| <= 2^-16 |x|), and sums over Dh and a
# chunk of such terms drift by ~1e-5 of the largest gradient; the bar is
# the card's for dig and dfg against the plain backward, 1e-4 (bf16 dq,
# dk, dv are rounded on output there, which the model does not).
MLSTM_BWD_SPLIT_TOL = 1e-4


def _mlstm_init(B, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Dh, Dh)).astype(np.float32),
            rng.standard_normal((B, H, Dh)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _jax_mlstm_grads_from(xs, dh, init):
    chunk = 8 if xs[0].shape[1] % 8 == 0 else 1

    def f(q, k, v, ig, fg):
        return _jax_chunkwise(q, k, v, ig, fg, chunk=chunk, init_state=(
            None if init is None else tuple(map(jnp.asarray, init))))[0]
    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in xs))
    return [np.asarray(g) for g in vjp(jnp.asarray(dh))]


def _bwd_model_errors(case, split, seed):
    """Each of the model's gradients against the plain backward's and
    jax.grad's, relative to its own scale floored at 1e-3 of its group's
    largest (dq, dk, dv; dig, dfg); where one key meets each query (S 1)
    dq, dk and dfg vanish in exact arithmetic and are held against their
    group's largest.  With ``split`` q, k and v are bf16 values (the
    route's inputs), held in float32 for JAX."""
    B, S, H, Dh, with_init, stress = case
    xs, dh = _mlstm_inputs(B, S, H, Dh, seed=seed, stress=stress)
    if split:
        xs = tuple(torch.from_numpy(a).bfloat16().float().numpy()
                   if i < 3 else a for i, a in enumerate(xs))
    init = _mlstm_init(B, H, Dh, seed + 1) if with_init else None
    ts = [torch.from_numpy(a.copy()) for a in xs]
    init_t = None if init is None else tuple(torch.from_numpy(a.copy())
                                             for a in init)
    h, _ = ml_ref.reference_mlstm(*ts, chunk=8, init_state=init_t)
    m_t, den, _ = ml_ref.reference_mlstm_stats(*ts, chunk=128,
                                               init_state=init_t)
    if stress == "clamp":
        assert float((den.abs() <= torch.exp(-m_t)).float().mean()) > 0.5
    dht = torch.from_numpy(dh)
    got = ml_ref.wgmma_bwd_route_model(*ts, h, (m_t, den), dht,
                                       init_state=init_t, split=split)
    plain = ml_ref.reference_mlstm_bwd(*ts, h, (m_t, den), dht,
                                       init_state=init_t)
    jg = _jax_mlstm_grads_from(xs, dh, init)
    jg = jg[:3] + [jg[3]] + [jg[4]]
    errs = {}
    for lo, hi in ((0, 3), (3, 5)):
        top = max(float(w.abs().max()) for w in plain[lo:hi])
        for i in range(lo, hi):
            name = ("dq", "dk", "dv", "dig", "dfg")[i]
            floor = top if S == 1 and name in ("dq", "dk", "dfg") \
                else 1e-3 * top
            errs[name] = (_rel(got[i], plain[i], floor),
                          _rel(got[i], jg[i], floor))
    return errs


@pytest.mark.parametrize("case", _BWD_MODEL_CASES)
def test_wgmma_bwd_route_model_without_split_matches_plain_and_jax(case):
    """float32 inputs, no split: the wgmma backward's passes (the states
    scaled by the forward's chain of m, C^T forwards and D^T backwards at
    chunks of 128, dig's tile parts in order) compute the gradient of the
    reference's function, as the plain backward and jax.grad give it, at
    1e-4."""
    for name, (e_plain, e_jax) in _bwd_model_errors(case, False,
                                                    seed=31).items():
        assert e_plain <= RTOL and e_jax <= RTOL, (name, e_plain, e_jax)


@pytest.mark.parametrize("case", _BWD_MODEL_CASES)
def test_wgmma_bwd_route_model_with_split_matches_plain_and_jax(case):
    """bf16 q, k, v and the float32 factors split into bf16 hi + lo where
    the kernels split them: within MLSTM_BWD_SPLIT_TOL of the plain
    backward and of jax.grad on the same inputs."""
    for name, (e_plain, e_jax) in _bwd_model_errors(case, True,
                                                    seed=32).items():
        assert e_plain <= MLSTM_BWD_SPLIT_TOL and \
            e_jax <= MLSTM_BWD_SPLIT_TOL, (name, e_plain, e_jax)


@pytest.mark.parametrize("S,with_init", [(384, False), (200, True),
                                         (129, False), (1, True)])
def test_forward_chain_of_m_is_the_row_stabiliser_before_each_boundary(
        S, with_init):
    """The wgmma backward scales its states by the chain m_new = max(b_T +
    m_prev, max_s gm_s) of the forward's state pass, and its w_out takes
    m_t from the forward's row statistics.  At a chunk's last row m_t is
    the same float expression as the chain's m_new (max over s of (b_T -
    b_s) + ig_s, and b_T + m_prev), so the two agree bit for bit, as the
    plain statistics at chunk 128 show: the rounding is held here."""
    B, H, Dh = 2, 2, 16
    xs, _ = _mlstm_inputs(B, S, H, Dh, seed=33)
    ts = [torch.from_numpy(a.copy()) for a in xs]
    init = None
    if with_init:
        init = tuple(torch.from_numpy(a.copy())
                     for a in _mlstm_init(B, H, Dh, 34))
    m_t, _, m_e = ml_ref.reference_mlstm_stats(*ts, chunk=128,
                                               init_state=init)
    # the chain, as the kernels' gate pass and state pass compute it
    lf = torch.nn.functional.logsigmoid(ts[4])
    m = torch.full((B, H), -1e30) if init is None else init[2].clone()
    for c0 in range(0, S, 128):
        assert torch.equal(m, m_e[:, c0 // 128])
        b = torch.cumsum(lf[:, c0:c0 + 128].double(), dim=1)
        bT = b[:, -1]
        gm = ts[3][:, c0:c0 + 128] + (bT[:, None] - b).float()
        m = torch.maximum(bT.float() + m, gm.amax(dim=1))
        last = min(S, c0 + 128) - 1
        assert torch.equal(m, m_t[:, last]), c0


def _fake_mlstm_kernels(monkeypatch):
    calls = {"fwd_stats": [], "bwd": 0, "bwd_routes": []}

    def launch(q, k, v, ig, fg, init, h, C, n, m, route, stats=None):
        hh, (CC, nn, mm) = ml_ref.reference_mlstm(q, k, v, ig, fg, chunk=8,
                                                  init_state=init)
        for dst, src in zip((h, C, n, m), (hh, CC, nn, mm)):
            dst.copy_(src)
        calls["fwd_stats"].append(stats is not None)
        if stats is not None:
            m_t, den, _ = ml_ref.reference_mlstm_stats(q, k, v, ig, fg,
                                                       init_state=init)
            stats[0].copy_(m_t)
            stats[1].copy_(den)

    def launch_bwd(q, k, v, ig, fg, init, h, stats, dh, dq, dk, dv, dig,
                   rows, route):
        assert dh.dtype == torch.float32 and dh.is_contiguous()
        calls["bwd_routes"].append(route)
        grads = ml_ref.reference_mlstm_bwd(q, k, v, ig, fg, h, stats, dh,
                                           init_state=init)
        for dst, g in zip((dq, dk, dv, dig), grads):
            dst.copy_(g)
        m_t, den = stats
        dhh = (dh * h).sum(-1)
        rows.copy_(torch.where(den.abs() > torch.exp(-m_t),
                               torch.zeros_like(dhh), dhh))
        calls["bwd"] += 1
    monkeypatch.setattr(ml_kernel, "launch", launch)
    monkeypatch.setattr(ml_kernel, "launch_bwd", launch_bwd)
    return calls


def test_mlstm_autograd_function_wiring(monkeypatch):
    """MLSTMScanFunction writes the row statistics, calls the backward
    launch once, and returns the gradients of q, k, v, ig and fg (fg's
    finished from the kernel's dig and row sums); the saved statistics are
    the forward's."""
    calls = _fake_mlstm_kernels(monkeypatch)
    xs, dh = _mlstm_inputs(2, 70, 2, 8, seed=4, stress="clamp")
    ts = [torch.tensor(a, requires_grad=True) for a in xs]
    want = torch.autograd.grad(ml_ref.reference_mlstm(*ts, chunk=10)[0], ts,
                               torch.tensor(dh))
    h, C, n, m = ml_ops.MLSTMScanFunction.apply(*ts, None, None, None,
                                                "scalar_f32")
    saved = h.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved[-2:]] == [(2, 70, 2)] * 2
    got = torch.autograd.grad(h, ts, torch.tensor(dh))
    assert calls == {"fwd_stats": [True], "bwd": 1,
                     "bwd_routes": ["scalar_f32"]}
    top = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert _rel(g, w, 1e-3 * top) <= RTOL


def test_mlstm_function_refuses_gradients_through_the_state(monkeypatch):
    """A gradient that reaches (C, n, m), or an initial state that requires
    grad, raises rather than being dropped."""
    _fake_mlstm_kernels(monkeypatch)
    xs, _ = _mlstm_inputs(1, 20, 1, 8, seed=6)
    ts = [torch.tensor(a, requires_grad=True) for a in xs]
    h, C, n, m = ml_ops.MLSTMScanFunction.apply(*ts, None, None, None,
                                                "scalar_f32")
    with pytest.raises(RuntimeError, match="final state"):
        (h.sum() + C.sum()).backward()
    init = [torch.zeros(1, 1, 8, 8), torch.zeros(1, 1, 8),
            torch.zeros(1, 1)]
    init[0].requires_grad_()
    with pytest.raises(RuntimeError, match="init_state"):
        ml_ops.MLSTMScanFunction.apply(*ts, *init, "scalar_f32")
    # a constant initial state is taken, and h's gradient flows
    h, *_ = ml_ops.MLSTMScanFunction.apply(*ts, init[0].detach(), init[1],
                                           init[2], "scalar_f32")
    h.sum().backward()
    assert all(t.grad is not None for t in ts)


def test_mlstm_fg_grad_is_a_reverse_cumsum():
    """fg_grad: dF = rows - dig summed from each step to the end, times
    sigmoid(-fg)."""
    rng = np.random.default_rng(0)
    fg, dig, rows = (torch.tensor(rng.standard_normal((2, 9, 3)),
                                  dtype=torch.float32) for _ in range(3))
    got = ml_ops.fg_grad(fg, dig, rows)
    dF = (rows - dig).numpy()
    want = np.flip(np.cumsum(np.flip(dF, 1), 1), 1) / (1 + np.exp(
        fg.numpy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
