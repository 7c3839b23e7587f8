"""The port's Griffin path against the JAX package's, on the CPU: the plain
RG-LRU recurrence (the JAX package's jnp ``rglru``, since its Pallas op
does not run on this jax), the conv4 helpers, the RG-LRU block in both
modes, and recurrentgemma-9b reduced end to end (forward, prefill with its
cache, decode, serve).  The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_kernels_gpu.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import serve as jax_serve
from repro.models import registry as JR
from repro.models import rglru as JG
from repro.models.layers import dense as jax_dense
from repro.models import xlstm as JX
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_from_jax)
from repro_torch.kernels.rglru_scan import kernel, ops, ref
from repro_torch.launch import serve as torch_serve
from repro_torch.models import registry as R
from repro_torch.models import rglru as TG
from repro_torch.models.layers import dense
from repro_torch.models import xlstm as TX

# float32 ops: the same formulas; the reference's associative scan sums in
# another order than the port's loop, over at most 136 steps of a < 1.
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# model logits, as tests/test_torch_transformer.py: float32 1e-4 (6-8
# layers, O(10) logits); bf16 0.08, the bar tests/test_models.py sets.
TOL = {"float32": 1e-4, "bfloat16": 0.08}
# the conv lag buffer is rounded to bf16 on both sides: an input that
# differs in the last float32 bits may round to the neighbouring bf16
# value, one bf16 ulp apart, which is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7

# recurrentgemma-9b reduced: 2 periods of (RGLRU, RGLRU, LOCAL), window 64,
# MQA; and a variant with 2 RGLRU tail layers after the scanned periods
CASES = {
    "recurrentgemma-9b": lambda get: get("recurrentgemma-9b").reduced(),
    "griffin-tail": lambda get: dataclasses.replace(
        get("recurrentgemma-9b").reduced(), n_layers=8),
}

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames="cache_len")
_jax_decode = jax.jit(JR.decode_step, static_argnums=1)


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _scan_inputs(B, S, D, seed=0):
    """x, lam (a in [0.9, 0.999] at zero gate), ga, gx, h0 as numpy."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.9, 0.999, D)
    lam = np.log(np.expm1(-np.log(u) / JG.RGLRU_C)).astype(np.float32)
    x, ga, gx, h0 = (rng.standard_normal(s).astype(np.float32)
                     for s in ((B, S, D), (B, S, D), (B, S, D), (B, D)))
    return x, lam, ga, gx, h0


def _rglru_float64(x, lam, ga, gx, h0=None):
    """The RG-LRU in float64 numpy, step by step: the gates as
    ``repro.models.rglru.rglru`` forms them, then h_t = a_t h_{t-1} + b_t.
    Returns (y (B, S, D), h_last (B, D))."""
    x, lam, ga, gx = (np.asarray(a, np.float64) for a in (x, lam, ga, gx))
    log_a = -JG.RGLRU_C * np.logaddexp(0.0, lam) / (1.0 + np.exp(-ga))
    b = np.sqrt(-np.expm1(2.0 * log_a)) * x / (1.0 + np.exp(-gx))
    a = np.exp(log_a)
    h = np.zeros(x[:, 0].shape) if h0 is None else np.asarray(h0, np.float64)
    y = np.empty_like(x)
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        y[:, t] = h
    return y, h


# the reference under jit, as the other parity tests call it: one XLA
# executable rather than the associative scan's ops dispatched one by one
_jax_rglru = jax.jit(JG.rglru)


# ------------------------------------------------------------ RG-LRU ops
@pytest.mark.parametrize("B,S,D,with_h0", [
    (2, 136, 128, False),     # shapes whose steps, channels or rows the
    (2, 128, 640, False),     # Pallas grid drops (ROADMAP C2)
    (12, 64, 128, False),
    (2, 1, 128, False),       # a single step
    (3, 77, 200, False),      # odd S and D
    (3, 77, 200, True),       # with an initial state
])
def test_plain_rglru_matches_jax(B, S, D, with_h0):
    """The port's plain scan and the JAX package's, each held against the
    same recurrence step by step in float64 (numpy), so that an error names
    its side: both are float32 evaluations of one function, ~5e-7 from it
    at (2, 136, 128), 1/20 of OP_TOL."""
    x, lam, ga, gx, h0 = _scan_inputs(B, S, D)
    h0 = h0 if with_h0 else None
    ty, th = _rglru_float64(x, lam, ga, gx, h0)
    wy, wh = _jax_rglru(*(jnp.asarray(a) for a in (x, lam, ga, gx)),
                        None if h0 is None else jnp.asarray(h0))
    before = kernel.LAUNCHES
    gy, gh = ops.rglru(_t(x), _t(lam), _t(ga), _t(gx),
                       None if h0 is None else _t(h0))
    assert kernel.LAUNCHES == before        # the CPU takes the plain version
    assert gy.dtype == gh.dtype == torch.float32
    for side, y, h in (("port", gy.numpy(), gh.numpy()),
                       ("jax", np.asarray(wy), np.asarray(wh))):
        np.testing.assert_allclose(y, ty, err_msg=side, **OP_TOL)
        np.testing.assert_allclose(h, th, err_msg=side, **OP_TOL)


def test_plain_rglru_takes_bf16_x_with_float32_gates():
    """The served mix: bf16 x, float32 gates, as the reference's block
    hands them to the scan."""
    x, lam, ga, gx, _ = _scan_inputs(2, 40, 96, seed=1)
    xb = jnp.asarray(x, jnp.bfloat16)
    wy, wh = JG.rglru(xb, jnp.asarray(lam), jnp.asarray(ga), jnp.asarray(gx))
    gy, gh = ops.rglru(_t(x).bfloat16(), _t(lam), _t(ga), _t(gx))
    assert gy.dtype == torch.float32
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **OP_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **OP_TOL)


def test_rglru_decode_matches_jax_and_the_scan():
    x, lam, ga, gx, h0 = _scan_inputs(3, 5, 80, seed=2)
    h_j, h_t = jnp.asarray(h0), _t(h0)
    for t in range(5):
        args = (x[:, t], lam, ga[:, t], gx[:, t])
        wy, h_j = JG.rglru_decode(*(jnp.asarray(a) for a in args), h_j)
        gy, h_t = TG.rglru_decode(*(_t(a) for a in args), h_t)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **OP_TOL)
    # five single steps are the scan over five steps from the same state
    sy, sh = TG.rglru(_t(x), _t(lam), _t(ga), _t(gx), _t(h0))
    np.testing.assert_allclose(h_t.numpy(), sh.numpy(), **OP_TOL)


def test_rglru_wrapper_checks_shapes_on_the_cpu_too():
    x, lam, ga, gx, h0 = (_t(a) for a in _scan_inputs(2, 8, 16))
    with pytest.raises(ValueError, match="do not match"):
        ops.rglru(x, lam, ga[:, :4], gx)
    with pytest.raises(ValueError, match="lam"):
        ops.rglru(x, lam[:8], ga, gx)
    with pytest.raises(ValueError, match="h0"):
        ops.rglru(x, lam, ga, gx, h0[:1])
    with pytest.raises(ValueError, match=r"\(B, S, D\)"):
        ops.rglru(x[0], lam, ga[0], gx[0])


def test_non_cpu_tensor_goes_to_the_kernel_checks_never_the_plain_path():
    x, lam, ga, gx, _ = (_t(a) for a in _scan_inputs(2, 8, 16))
    before = kernel.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rglru(x.to("meta"), lam, ga, gx)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rglru(x, lam, ga.to("meta"), gx)
    assert kernel.LAUNCHES == before


# ------------------------------------------------------------ gate biases
def _products(B, S, D, dtype, seed=3):
    """xb, w_a, w_i, b_a, b_i as numpy (xb and the weights rounded to
    ``dtype``, the biases float32), lam as in ``_scan_inputs``."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((B, S, D)).astype(np.float32)
    w_a, w_i = (rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D)
                for _ in range(2))
    b_a, b_i = (0.5 * rng.standard_normal(D).astype(np.float32)
                for _ in range(2))
    if dtype == "bfloat16":
        xb, w_a, w_i = (_f32(jnp.asarray(a, jnp.bfloat16))
                        for a in (xb, w_a, w_i))
    _, lam, _, _, h0 = _scan_inputs(B, S, D, seed)
    return xb, w_a, w_i, b_a, b_i, lam, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bias_plain_route_matches_jax(dtype):
    """The JAX package's ``dense(xb, w) + b`` then ``rglru`` against the
    port's scan handed the bias-free products and the biases.  In bf16 both
    sides get the same products (JAX's ``dense``), so that a matmul
    rounding one bf16 ulp apart does not hide the scan's arithmetic."""
    xb, w_a, w_i, b_a, b_i, lam, h0 = _products(2, 40, 96, dtype)
    jdt = jnp.dtype(dtype)
    jxb = jnp.asarray(xb, jdt)
    pa, pi = (jax_dense(jxb, jnp.asarray(w, jdt)) for w in (w_a, w_i))
    wy, wh = _jax_rglru(jxb, jnp.asarray(lam), pa + jnp.asarray(b_a),
                        pi + jnp.asarray(b_i), jnp.asarray(h0))
    tdt = getattr(torch, dtype)
    txb = _t(xb).to(tdt)
    if dtype == "float32":
        ta, ti = dense(txb, _t(w_a)), dense(txb, _t(w_i))
    else:
        ta, ti = (_t(_f32(p)).to(tdt) for p in (pa, pi))
    before = kernel.LAUNCHES
    gy, gh = ops.rglru(txb, _t(lam), ta, ti, _t(h0), b_a=_t(b_a),
                       b_i=_t(b_i))
    assert kernel.LAUNCHES == before
    assert ta.dtype == tdt and gy.dtype == torch.float32
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **OP_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **OP_TOL)


@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_fused_bias_route_is_the_whole_gate_route_bit_for_bit(g_dtype):
    """Adding the float32 biases inside the scan is PyTorch's promotion of
    the sum: the same float32 gates, so the same y and h_last."""
    x, lam, pa, pi, h0 = (_t(a) for a in _scan_inputs(3, 33, 48, seed=4))
    x, pa, pi = x.bfloat16(), pa.to(g_dtype), pi.to(g_dtype)
    ba, bi = _t(_rand((48,), 6, 0.5)), _t(_rand((48,), 7, 0.5))
    fy, fh = ops.rglru(x, lam, pa, pi, h0, b_a=ba, b_i=bi)
    gy, gh = ops.rglru(x, lam, pa + ba, pi + bi, h0)
    assert (pa + ba).dtype == torch.float32
    assert torch.equal(fy, gy) and torch.equal(fh, gh)


def test_rglru_wrapper_checks_the_gate_biases():
    x, lam, ga, gx, _ = (_t(a) for a in _scan_inputs(2, 8, 16))
    b = torch.zeros(16)
    with pytest.raises(ValueError, match="both gate biases"):
        ops.rglru(x, lam, ga, gx, b_a=b)
    with pytest.raises(ValueError, match="both gate biases"):
        ops.rglru(x, lam, ga, gx, b_i=b)
    with pytest.raises(ValueError, match=r"b_i \(8,\) is not \(16,\)"):
        ops.rglru(x, lam, ga, gx, b_a=b, b_i=b[:8])
    with pytest.raises(ValueError, match=r"b_a \(2, 16\)"):
        ops.rglru(x, lam, ga, gx, b_a=b.expand(2, 16), b_i=b)
    for dt in (torch.bfloat16, torch.float64):
        with pytest.raises(ValueError, match="b_a must be float32"):
            ops.rglru(x, lam, ga, gx, b_a=b.to(dt), b_i=b)
    before = kernel.LAUNCHES_BY_ROUTE["fused_bias"]
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rglru(x, lam, ga, gx, b_a=b.to("meta"), b_i=b)
    assert kernel.LAUNCHES_BY_ROUTE["fused_bias"] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rglru_fuses_the_gate_biases_into_the_scan(dtype,
                                                         monkeypatch):
    """The block hands the scan its bias-free gate products, in the model's
    dtype, and the float32 biases, and stays at the JAX block's output."""
    jc, tc, (pj, pt) = _block(dtype)
    tdt = getattr(torch, dtype)
    calls = []
    real = TG.rglru_scan

    def spy(xb, lam, ga, gx, h0=None, **bias):
        calls.append((ga.dtype, gx.dtype, bias))
        return real(xb, lam, ga, gx, h0, **bias)

    monkeypatch.setattr(TG, "rglru_scan", spy)
    x = _rand((2, 20, jc.d_model), 8)
    wo = JG.apply_rglru(jnp.asarray(x, dtype), pj, jc)
    go = TG.apply_rglru(_t(x).to(tdt), pt, tc)
    assert len(calls) == 1
    ga_dtype, gx_dtype, bias = calls[0]
    assert ga_dtype == gx_dtype == tdt
    assert bias["b_a"] is pt["b_a"] and bias["b_i"] is pt["b_i"]
    assert pt["b_a"].dtype == torch.float32
    np.testing.assert_allclose(_f32(go), _f32(wo), atol=TOL[dtype], rtol=0)


# ------------------------------------------------------------ the kernel's
# order: windows of W steps, each cut into P segments (ref.windowed_rglru)
@pytest.mark.parametrize("window,segments,S", [
    (64, 8, 1), (64, 8, 63), (64, 8, 65), (64, 8, 201), (32, 4, 77),
    (16, 16, 50), (128, 16, 300), (8, 2, 13)])
def test_windowed_order_matches_the_sequential_plain_version(window,
                                                             segments, S):
    """The CUDA kernel's order of the arithmetic against the step-by-step
    loop, both float32, with h0 and the biases fused: within 1e-5 of max
    |y| (the card's bar for the kernel against the plain version), and
    h_last is y's last step."""
    x, lam, ga, gx, h0 = (_t(a) for a in _scan_inputs(2, S, 48, seed=5))
    args = (x.bfloat16(), lam, ga.bfloat16(), gx.bfloat16(), h0)
    bias = dict(b_a=_t(_rand((48,), 6, 0.5)), b_i=_t(_rand((48,), 7, 0.5)))
    wy, wh = ref.reference_rglru(*args, **bias)
    gy, gh = ref.windowed_rglru(*args, **bias, window=window,
                                segments=segments)
    scale = float(wy.abs().max())
    assert float((gy - wy).abs().max()) <= 1e-5 * scale
    assert float((gh - wh).abs().max()) <= 1e-5 * scale
    assert torch.equal(gh, gy[:, -1])


def test_windowed_order_at_long_memory_against_float64():
    """a between 0.999 and 0.9999 over 4096 steps from h0: the segment
    products, formed as exp(sum log_a), are the order's one new rounding.
    Against the float64 recurrence the kernel's order may miss by at most
    twice the plain version's own error (the card's bar for the kernel),
    and by at most 1e-5 of max |y|."""
    B, S, D = 2, 4096, 128
    rng = np.random.default_rng(7)
    u = rng.uniform(0.999, 0.9999, D)
    lam = np.log(np.expm1(-np.log(u) / JG.RGLRU_C)).astype(np.float32)
    x, pa, pi = (_f32(jnp.asarray(rng.standard_normal((B, S, D)),
                                  jnp.bfloat16)) for _ in range(3))
    b_a, b_i = (0.5 * rng.standard_normal(D).astype(np.float32)
                for _ in range(2))
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    # the float32 gates the contract forms, then the recurrence in float64
    ty, _ = _rglru_float64(x, lam, pa + b_a, pi + b_i, h0)
    args = (_t(x).bfloat16(), _t(lam), _t(pa).bfloat16(),
            _t(pi).bfloat16(), _t(h0))
    bias = dict(b_a=_t(b_a), b_i=_t(b_i))
    scale = np.abs(ty).max()
    plain_err = np.abs(ref.reference_rglru(*args, **bias)[0].numpy()
                       - ty).max() / scale
    err = np.abs(ref.windowed_rglru(*args, **bias)[0].numpy()
                 - ty).max() / scale
    assert err <= 2 * plain_err and err <= 1e-5, (err, plain_err)


# ------------------------------------------------------------ conv4
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    x, w, b = _rand((2, 11, 48)), _rand((4, 48), 1, 0.1), _rand((48,), 2)
    want = JX.causal_conv1d(jnp.asarray(x, dtype), jnp.asarray(w),
                            jnp.asarray(b))
    got = TX.causal_conv1d(_t(x).to(getattr(torch, dtype)), _t(w), _t(b))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = OP_TOL if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


def test_conv1d_decode_matches_jax_and_the_full_conv():
    x, w, b = _rand((2, 9, 48)), _rand((4, 48), 1, 0.1), _rand((48,), 2)
    buf_j = jnp.zeros((2, 3, 48))
    buf_t = torch.zeros((2, 3, 48))
    full = TX.causal_conv1d(_t(x), _t(w), _t(b))
    for t in range(9):
        wo, buf_j = JX.conv1d_decode(jnp.asarray(x[:, t]), buf_j,
                                     jnp.asarray(w), jnp.asarray(b))
        go, buf_t = TX.conv1d_decode(_t(x[:, t]), buf_t, _t(w), _t(b))
        np.testing.assert_allclose(go.numpy(), np.asarray(wo), **OP_TOL)
        np.testing.assert_allclose(go.numpy(), full[:, t].numpy(), **OP_TOL)
    np.testing.assert_allclose(buf_t.numpy(), np.asarray(buf_j), **OP_TOL)


# ------------------------------------------------------------ block
def _block(cfg_dtype):
    jc = dataclasses.replace(jax_arch("recurrentgemma-9b").reduced(),
                             dtype=cfg_dtype)
    tc = dataclasses.replace(torch_arch("recurrentgemma-9b").reduced(),
                             dtype=cfg_dtype)
    p, _ = JG.init_rglru(jax.random.key(3), jc)
    p = jax.tree.map(np.asarray, p)
    # nonzero norm weight and biases, so that each is used
    p["ln"] = _rand(p["ln"].shape, 4, 0.1)
    p["conv_b"] = _rand(p["conv_b"].shape, 5, 0.1)
    p["b_a"] = _rand(p["b_a"].shape, 6, 0.5)
    p["b_i"] = _rand(p["b_i"].shape, 7, 0.5)
    return jc, tc, ({k: jnp.asarray(v) for k, v in p.items()},
                    {k: _t(v) for k, v in p.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_decode_rglru_match_jax(dtype):
    """The block on identical inputs: full sequence with its state, then
    three decode steps from that state."""
    jc, tc, (pj, pt) = _block(dtype)
    tdt = getattr(torch, dtype)
    tol = TOL[dtype]
    B, S = 2, 20
    x = _rand((B, S + 3, jc.d_model), 8)
    wo, ws = JG.apply_rglru(jnp.asarray(x[:, :S], dtype), pj, jc,
                            return_state=True)
    go, gs = TG.apply_rglru(_t(x[:, :S]).to(tdt), pt, tc, return_state=True)
    assert go.dtype == tdt
    assert gs["h"].dtype == torch.float32 and gs["conv"].dtype == \
        torch.bfloat16
    np.testing.assert_allclose(_f32(go), _f32(wo), atol=tol, rtol=0)
    np.testing.assert_allclose(_f32(gs["h"]), _f32(ws["h"]), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(_f32(gs["conv"]), _f32(ws["conv"]),
                               atol=tol, rtol=BF16_ULP)
    for t in range(S, S + 3):
        xt = x[:, t:t + 1]
        wo, ws = JG.decode_rglru(jnp.asarray(xt, dtype), pj, jc, ws)
        go, gs = TG.decode_rglru(_t(xt).to(tdt), pt, tc, gs)
        np.testing.assert_allclose(_f32(go), _f32(wo), atol=tol, rtol=0,
                                   err_msg=f"decode at {t}")
        np.testing.assert_allclose(_f32(gs["h"]), _f32(ws["h"]), atol=tol,
                                   rtol=0)
        assert gs["conv"].dtype == torch.bfloat16


def test_decode_rglru_updates_the_state_in_place():
    _, tc, (_, pt) = _block("float32")
    state = TG.init_state_rglru(tc, 2)
    h, conv = state["h"], state["conv"]
    x = _t(_rand((2, 1, tc.d_model), 9))
    _, new = TG.decode_rglru(x, pt, tc, state)
    assert new["h"] is h and new["conv"] is conv
    assert h.abs().sum() > 0 and conv[:, -1].abs().sum() > 0


# ------------------------------------------------------------ model
def _setup(case, dtype):
    jc = dataclasses.replace(CASES[case](jax_arch), dtype=dtype)
    tc = dataclasses.replace(CASES[case](torch_arch), dtype=dtype)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    return jc, tc, jp, tp


def _tokens(cfg, B=2, S=80, seed=0):       # S > 64, the reduced window
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("case,dtype", [
    ("recurrentgemma-9b", "float32"), ("griffin-tail", "float32")])
def test_forward_prefill_decode_match_jax(case, dtype):
    jc, tc, jp, tp = _setup(case, dtype)
    tol = TOL[dtype]
    toks = _tokens(jc)
    S = toks.shape[1]

    want = _jax_forward(jp, jc, {"tokens": jnp.asarray(toks)})
    got = R.forward_logits(tp, tc, {"tokens": toks}, device="cpu")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)

    pre = toks[:, :S - 4]
    jl, jcache = _jax_prefill(jp, jc, {"tokens": jnp.asarray(pre)},
                              cache_len=S)
    tl, tcache = R.prefill(tp, tc, {"tokens": pre}, cache_len=S,
                           device="cpu")
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0)
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    tflat = flatten_with_paths(cache_to_jax(tc, tcache))
    assert set(jflat) == set(tflat)
    for key, arr in jflat.items():
        assert tflat[key].shape == arr.shape, key
        rtol = BF16_ULP if key.endswith("['conv']") else 0
        np.testing.assert_allclose(tflat[key], _f32(arr), atol=tol,
                                   rtol=rtol, err_msg=key)
    for n, layer in enumerate(tcache["layers"]):
        if "h" in layer:
            assert layer["h"].dtype == torch.float32, n
            assert layer["conv"].dtype == torch.bfloat16, n
        else:
            assert layer["k"].dtype == getattr(torch, dtype), n

    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   device="cpu")
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0,
                                   err_msg=f"decode at {t}")


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_model_is_as_close_to_float32_as_the_references(case):
    """bf16 through the model entry points.  The two packages round at
    other points (GELU and matmul outputs differ by a bf16 ulp here and
    there), and over 6-8 layers their logits drift apart by up to ~0.17,
    beyond the 0.08 bar, each about 0.1 from the float32 logits.  So bf16
    parity at 0.08 is held on identical block inputs
    (test_apply_and_decode_rglru_match_jax), and here each package's bf16
    logits are held against the reference's float32 logits: the port's
    error may be at most twice the reference's own."""
    jc, tc, jp, tp = _setup(case, "bfloat16")
    jc32, _, jp32, _ = _setup(case, "float32")
    toks = _tokens(jc)
    S = toks.shape[1]
    ref = _f32(_jax_forward(jp32, jc32, {"tokens": jnp.asarray(toks)}))

    def check(got, want, truth, what):
        port_err = np.abs(_f32(got) - truth).max()
        jax_err = np.abs(_f32(want) - truth).max()
        assert jax_err < 0.15, (what, jax_err)
        assert port_err <= 2 * jax_err, (what, port_err, jax_err)

    check(R.forward_logits(tp, tc, {"tokens": toks}, device="cpu"),
          _jax_forward(jp, jc, {"tokens": jnp.asarray(toks)}), ref,
          "forward")
    pre = toks[:, :S - 4]
    jl, jcache = _jax_prefill(jp, jc, {"tokens": jnp.asarray(pre)},
                              cache_len=S)
    tl, tcache = R.prefill(tp, tc, {"tokens": pre}, cache_len=S,
                           device="cpu")
    check(tl, jl, ref[:, S - 5], "prefill")
    for layer in tcache["layers"]:
        assert layer["k" if "k" in layer else "conv"].dtype == \
            torch.bfloat16
    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   device="cpu")
        check(tl, jl, ref[:, t], f"decode at {t}")


def _gap(forward, prefill, decode, toks, pos_shift=0):
    """Largest |prefill + decode logits - forward logits| over max |logit|."""
    S = toks.shape[1]
    full = np.asarray(forward(toks), np.float32)
    logits, cache = prefill(toks[:, :S - 4])
    err = np.abs(np.asarray(logits, np.float32) - full[:, S - 5]).max()
    for t in range(S - 4, S - 1):
        logits, cache = decode(toks[:, t:t + 1], t + pos_shift, cache)
        err = max(err, np.abs(np.asarray(logits, np.float32)
                              - full[:, t]).max())
    return float(err / np.abs(full).max())


def test_float32_decode_gap_is_the_references_own():
    """The reference rounds the conv lag buffer to bf16 in a float32 model,
    so its prefill + decode differs from its forward by ~3.5e-4 of the
    logits' scale.  The port mirrors the rounding, so its own gap is the
    reference's to within 1e-5; a float32 lag buffer would give ~5e-7."""
    jc, tc, jp, tp = _setup("recurrentgemma-9b", "float32")
    toks = _tokens(jc, seed=1)
    S = toks.shape[1]
    jax_gap = _gap(
        lambda t: _jax_forward(jp, jc, {"tokens": jnp.asarray(t)}),
        lambda t: _jax_prefill(jp, jc, {"tokens": jnp.asarray(t)},
                               cache_len=S),
        lambda t, pos, c: _jax_decode(jp, jc, jnp.asarray(t), jnp.int32(pos),
                                      c),
        toks)
    to_np = lambda a: a.numpy()                                # noqa: E731
    port_gap = _gap(
        lambda t: to_np(R.forward_logits(tp, tc, {"tokens": t},
                                         device="cpu")),
        lambda t: (lambda lc: (to_np(lc[0]), lc[1]))(
            R.prefill(tp, tc, {"tokens": t}, cache_len=S, device="cpu")),
        lambda t, pos, c: (lambda lc: (to_np(lc[0]), lc[1]))(
            R.decode_step(tp, tc, t, pos, c, device="cpu")),
        toks)
    assert jax_gap > 1e-4          # the rounding shows ...
    assert abs(port_gap - jax_gap) < 1e-5, (port_gap, jax_gap)


def _dtypes_by_jax_path(cfg, cache):
    """{JAX cache path: dtype name} of a port cache, without stacking."""
    P, scanned = cfg.pattern_period, cfg.n_scan_blocks * cfg.pattern_period
    out = {}
    for n, layer in enumerate(cache["layers"]):
        prefix = (f"['blocks']['l{n % P}']" if n < scanned
                  else f"['tail'][{n - scanned}]")
        for name, t in layer.items():
            out[f"{prefix}['{name}']"] = str(t.dtype).replace("torch.", "")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_init_cache_matches_jax_shapes_and_dtypes(case):
    jc, tc = (dataclasses.replace(CASES[case](get), dtype="float32")
              for get in (jax_arch, torch_arch))
    want = flatten_with_paths(jax.tree.map(np.asarray,
                                           JR.init_cache(jc, 2, 40)))
    cache = R.init_cache(tc, 2, 40, device="cpu")
    got = flatten_with_paths(cache_to_jax(tc, cache))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert _dtypes_by_jax_path(tc, cache) == \
        {k: str(v.dtype) for k, v in want.items()}


def test_param_count_matches_jax_at_full_width():
    assert R.count_params_analytic(torch_arch("recurrentgemma-9b")) == \
        JR.count_params_analytic(jax_arch("recurrentgemma-9b")) == \
        10_444_984_320


# ------------------------------------------------------------ serving
def _requests(module, vocab, lens, max_new):
    rng = np.random.default_rng(0)
    return [module.Request(i, rng.integers(1, vocab, size=n).astype(np.int32),
                           max_new=max_new) for i, n in enumerate(lens)]


def test_serve_gives_the_jax_tokens_in_float32():
    jc = dataclasses.replace(jax_arch("recurrentgemma-9b").reduced(),
                             dtype="float32")
    tc = dataclasses.replace(torch_arch("recurrentgemma-9b").reduced(),
                             dtype="float32")
    lens = [16, 12, 16, 9, 16]
    want = jax_serve.serve(jc, _requests(jax_serve, jc.vocab_size, lens, 4),
                           slots=2, ctx_len=32, seed=0)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    params = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    got = torch_serve.serve(tc, _requests(torch_serve, tc.vocab_size, lens, 4),
                            slots=2, ctx_len=32, seed=0, params=params,
                            device="cpu")
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]


def test_cli_serves_the_griffin_smoke_arch_on_the_cpu(capsys):
    done = torch_serve.main(["--arch", "recurrentgemma-9b-smoke",
                             "--device", "cpu", "--requests", "3",
                             "--slots", "2", "--prompt-len", "8",
                             "--gen", "3"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b-smoke device=cpu requests=3 " \
           "new_tokens=9" in out
