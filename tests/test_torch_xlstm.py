"""The port's xLSTM path against the JAX package's, on the CPU: the mLSTM
cell (sequential oracle, chunkwise form, decode step), the port's
``ops.mlstm_chunkwise`` against the Pallas kernel in interpret mode, the
sLSTM scan, both blocks in both modes, and xlstm-1.3b reduced end to end
(forward, prefill with its cache, decode, serve).  The CUDA kernel itself
is held against the plain version on the card
(tests/test_torch_kernels_gpu.py)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels.mlstm_scan import ops as pallas_ops
from repro.launch import serve as jax_serve
from repro.models import registry as JR
from repro.models import xlstm as JX
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_from_jax)
from repro_torch.kernels.mlstm_scan import kernel, ops, ref
from repro_torch.launch import serve as torch_serve
from repro_torch.models import registry as R
from repro_torch.models import xlstm as TX

# float32 cell math: the same formulas, summed in another order (the JAX
# package's XLA products against PyTorch's) over at most 136 steps and a
# head dim of 48; the outputs are O(1-10).
OP_TOL = dict(rtol=1e-5, atol=1e-5)
# model logits, as tests/test_torch_transformer.py: float32 1e-4; bf16
# 0.08, the bar tests/test_models.py sets.
TOL = {"float32": 1e-4, "bfloat16": 0.08}
# the conv lag buffer is rounded to bf16 on both sides: an input that
# differs in the last float32 bits may round to the neighbouring bf16
# value, one bf16 ulp apart, which is at most 2**-7 of the value
BF16_ULP = 2.0 ** -7

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames="cache_len")
_jax_decode = jax.jit(JR.decode_step, static_argnums=1)
_jax_chunkwise = jax.jit(JX.mlstm_chunkwise, static_argnames="chunk")
_jax_sequential = jax.jit(JX.mlstm_sequential)


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _cell_inputs(B, S, H, Dh, seed=0, stress=False):
    """q, k, v, ig, fg and an initial state (C, n, m) as numpy.  The
    forget pre-activations sit near the model's init (bias 3 to 6); with
    ``stress``, strongly negative forget gates meet large input gates."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    ig = rng.standard_normal((B, S, H)).astype(np.float32)
    fg = (3.0 + rng.standard_normal((B, S, H))).astype(np.float32)
    if stress:
        ig, fg = ig * 4 + 12, fg * 2 - 16
    C0 = rng.standard_normal((B, H, Dh, Dh)).astype(np.float32)
    n0 = rng.standard_normal((B, H, Dh)).astype(np.float32)
    m0 = rng.standard_normal((B, H)).astype(np.float32)
    return (q, k, v, ig, fg), (C0, n0, m0)


def _assert_cell_close(got, want, tol=OP_TOL):
    (gh, gstate), (wh, wstate) = got, want
    assert gh.dtype == torch.float32
    np.testing.assert_allclose(gh.numpy(), _f32(wh), **tol)
    for name, g, w in zip("Cnm", gstate, wstate):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), _f32(w), err_msg=name, **tol)


# ------------------------------------------------------------ mLSTM cell
CELL_CASES = [                     # (B, S, H, Dh, chunk, with init_state)
    (2, 64, 2, 32, 16, False),     # S divisible by the chunk
    (2, 40, 2, 32, 16, False),     # not: the reference halves to 8
    (1, 37, 3, 16, 16, False),     # a prime S: chunk 1
    (2, 1, 2, 32, 16, False),      # a single step
    (2, 40, 2, 32, 16, True),      # from an initial state
    (1, 136, 1, 48, 64, False),    # the TPU kernel's chunk, halved to 8
]


@pytest.mark.parametrize("B,S,H,Dh,chunk,with_init", CELL_CASES)
def test_mlstm_chunkwise_matches_jax(B, S, H, Dh, chunk, with_init):
    xs, init = _cell_inputs(B, S, H, Dh)
    init = init if with_init else None
    want = _jax_chunkwise(*map(jnp.asarray, xs), chunk=chunk,
                          init_state=None if init is None
                          else tuple(map(jnp.asarray, init)))
    got = TX.mlstm_chunkwise(*map(_t, xs), chunk=chunk,
                             init_state=None if init is None
                             else tuple(map(_t, init)))
    _assert_cell_close(got, want)


@pytest.mark.parametrize("B,S,H,Dh,with_init", [
    (2, 40, 2, 32, False), (2, 1, 2, 32, False), (2, 40, 2, 32, True)])
def test_mlstm_sequential_matches_jax_and_the_chunkwise_form(B, S, H, Dh,
                                                              with_init):
    xs, init = _cell_inputs(B, S, H, Dh, seed=1)
    init = init if with_init else None
    want = _jax_sequential(*map(jnp.asarray, xs),
                           None if init is None
                           else tuple(map(jnp.asarray, init)))
    got = TX.mlstm_sequential(*map(_t, xs), init_state=None if init is None
                              else tuple(map(_t, init)))
    _assert_cell_close(got, want)
    # the chunkwise form computes the same function (up to float32 order)
    chunked = TX.mlstm_chunkwise(*map(_t, xs), chunk=16,
                                 init_state=None if init is None
                                 else tuple(map(_t, init)))
    _assert_cell_close(chunked, want, dict(rtol=1e-4, atol=1e-4))


def test_mlstm_chunkwise_keeps_its_stabiliser_under_stress():
    """Strongly negative forget gates with large input gates: the running
    max m keeps every exp finite, in both packages alike."""
    xs, _ = _cell_inputs(2, 40, 2, 32, seed=2, stress=True)
    want = _jax_chunkwise(*map(jnp.asarray, xs), chunk=16)
    got = TX.mlstm_chunkwise(*map(_t, xs), chunk=16)
    assert torch.isfinite(got[0]).all()
    _assert_cell_close(got, want)


def test_mlstm_decode_step_matches_jax_and_the_chunkwise_form():
    xs, init = _cell_inputs(2, 5, 2, 32, seed=3)
    q, k, v, ig, fg = xs
    js = tuple(map(jnp.asarray, init))
    ts = tuple(map(_t, init))
    for t in range(5):
        args = (q[:, t], k[:, t], v[:, t], ig[:, t], fg[:, t])
        wh, js = JX.mlstm_decode_step(*map(jnp.asarray, args), js)
        gh, ts = TX.mlstm_decode_step(*map(_t, args), ts)
        _assert_cell_close((gh, ts), (wh, js))
    # five single steps are the chunkwise pass over five steps
    _, (C, n, m) = TX.mlstm_chunkwise(*map(_t, xs), chunk=4,
                                      init_state=tuple(map(_t, init)))
    for got, want in zip(ts, (C, n, m)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_mlstm_decode_step_updates_C_and_n_in_place():
    xs, init = _cell_inputs(1, 1, 2, 16, seed=4)
    state = tuple(map(_t, init))
    _, (C, n, m) = TX.mlstm_decode_step(*(_t(a[:, 0]) for a in xs), state)
    assert C is state[0] and n is state[1]
    assert not torch.equal(C, _t(init[0]))


# ------------------------------------------------------------ the wrapper
@pytest.mark.parametrize("B,S,H,Dh,chunk", [
    (2, 64, 2, 32, 16), (1, 128, 2, 64, 64), (2, 16, 1, 32, 16)])
def test_plain_ops_match_the_pallas_kernel_in_interpret_mode(B, S, H, Dh,
                                                             chunk):
    """Shapes the Pallas kernel covers (its wrapper sends ragged S and an
    initial state to the reference)."""
    xs, _ = _cell_inputs(B, S, H, Dh, seed=5)
    want = pallas_ops.mlstm_chunkwise(*map(jnp.asarray, xs), chunk=chunk,
                                      interpret=True)
    before = kernel.LAUNCHES
    got = ops.mlstm_chunkwise(*map(_t, xs), chunk=chunk)
    assert kernel.LAUNCHES == before        # the CPU takes the plain version
    _assert_cell_close(got, want)


def test_plain_ops_take_bf16_qkv_with_float32_gates():
    """The served mix: bf16 q, k, v and float32 gates, as the block hands
    them over; the cell computes in float32 all the same."""
    (q, k, v, ig, fg), _ = _cell_inputs(2, 40, 2, 32, seed=6)
    want = _jax_chunkwise(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                          jnp.asarray(ig), jnp.asarray(fg), chunk=16)
    got = ops.mlstm_chunkwise(*(_t(a).bfloat16() for a in (q, k, v)), _t(ig),
                              _t(fg), chunk=16)
    _assert_cell_close(got, want)


def test_reference_module_is_the_models_chunkwise_form_and_oracle():
    xs, init = _cell_inputs(1, 24, 2, 16, seed=7)
    args = tuple(map(_t, xs))
    init_t = tuple(map(_t, init))
    for got, want in ((ref.reference_mlstm(*args, chunk=8,
                                           init_state=init_t),
                       TX.mlstm_chunkwise(*args, chunk=8,
                                          init_state=init_t)),
                      (ref.sequential_oracle(*args, init_state=init_t),
                       TX.mlstm_sequential(*args, init_state=init_t))):
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("with_init", [False, True])
def test_float64_oracle_is_the_float32_recurrence_in_float64(with_init):
    """The ground truth the card's stress case is held against: the same
    recurrence in float64, returned in float64, which the float32 oracle
    (and so JAX's) matches to float32 rounding."""
    xs, init = _cell_inputs(2, 40, 2, 32, seed=8)
    init_t = tuple(map(_t, init)) if with_init else None
    got = ref.sequential_oracle(*map(_t, xs), init_state=init_t,
                                dtype=torch.float64)
    assert got[0].dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in got[1])
    _assert_cell_close(TX.mlstm_sequential(*map(_t, xs), init_state=init_t),
                       got)


def test_mlstm_wrapper_checks_shapes_on_the_cpu_too():
    xs, init = _cell_inputs(2, 8, 2, 16)
    q, k, v, ig, fg = map(_t, xs)
    C0, n0, m0 = map(_t, init)
    with pytest.raises(ValueError, match="do not match"):
        ops.mlstm_chunkwise(q, k[:, :4], v, ig, fg)
    with pytest.raises(ValueError, match=r"\(B, S, H\)"):
        ops.mlstm_chunkwise(q, k, v, ig[..., :1], fg)
    with pytest.raises(ValueError, match="init_state"):
        ops.mlstm_chunkwise(q, k, v, ig, fg, init_state=(C0, n0[:, :1], m0))
    with pytest.raises(ValueError, match=r"\(B, S, H, Dh\)"):
        ops.mlstm_chunkwise(q[0], k[0], v[0], ig[0], fg[0])
    with pytest.raises(ValueError, match="chunk"):
        ops.mlstm_chunkwise(q, k, v, ig, fg, chunk=0)


def test_non_cpu_tensor_goes_to_the_kernel_checks_never_the_plain_path():
    xs, init = _cell_inputs(2, 8, 2, 16)
    q, k, v, ig, fg = map(_t, xs)
    before = kernel.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.mlstm_chunkwise(q.to("meta"), k, v, ig, fg)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.mlstm_chunkwise(q, k, v, ig, fg,
                            init_state=(_t(init[0]).to("meta"),
                                        _t(init[1]), _t(init[2])))
    assert kernel.LAUNCHES == before


# ------------------------------------------------------------ sLSTM scan
@pytest.mark.parametrize("S", [1, 40])
def test_slstm_scan_matches_jax(S):
    B, H, Dh = 2, 4, 16
    rng = np.random.default_rng(8)
    pre = [rng.standard_normal((B, S, H, Dh)).astype(np.float32)
           for _ in range(4)]
    pre[2] += 3.0                            # forget gates near the init
    p = {f"r_{g}": (rng.standard_normal((H, Dh, Dh)) / 4).astype(np.float32)
         for g in "zifo"}
    init = [rng.standard_normal((B, H, Dh)).astype(np.float32) * 0.5
            for _ in range(3)] + [rng.standard_normal((B, H, Dh))
                                  .astype(np.float32)]
    init[2] = np.abs(init[2]) + 0.5          # a normaliser n > 0
    whs, wst = JX._slstm_scan(*map(jnp.asarray, pre),
                              {k: jnp.asarray(w) for k, w in p.items()}, H,
                              Dh, tuple(map(jnp.asarray, init)))
    ghs, gst = TX._slstm_scan(*map(_t, pre),
                              {k: _t(w) for k, w in p.items()}, H, Dh,
                              tuple(map(_t, init)))
    assert ghs.shape == (B, S, H, Dh) and ghs.dtype == torch.float32
    np.testing.assert_allclose(ghs.numpy(), _f32(whs), **OP_TOL)
    for name, g, w in zip("hcnm", gst, wst):
        np.testing.assert_allclose(g.numpy(), _f32(w), err_msg=name, **OP_TOL)


# ------------------------------------------------------------ blocks
def _block(kind, cfg_dtype, seed=3):
    jc = dataclasses.replace(jax_arch("xlstm-1.3b").reduced(),
                             dtype=cfg_dtype)
    tc = dataclasses.replace(torch_arch("xlstm-1.3b").reduced(),
                             dtype=cfg_dtype)
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    p, _ = init(jax.random.key(seed), jc)
    p = jax.tree.map(np.asarray, p)
    # nonzero norm weights and biases, so that each is used
    for i, name in enumerate(sorted(p)):
        if name in ("ln", "gn", "mlp_ln", "conv_b", "b_ig", "b_z", "b_i",
                    "b_o"):
            p[name] = p[name] + _rand(p[name].shape, 10 + i, 0.1)
    return jc, tc, ({k: jnp.asarray(v) for k, v in p.items()},
                    {k: _t(v) for k, v in p.items()})


def _jit_block(apply, decode):
    return (jax.jit(apply, static_argnums=2, static_argnames="return_state"),
            jax.jit(decode, static_argnums=2))


_BLOCKS = {"mlstm": (*_jit_block(JX.apply_mlstm, JX.decode_mlstm),
                     TX.apply_mlstm, TX.decode_mlstm),
           "slstm": (*_jit_block(JX.apply_slstm, JX.decode_slstm),
                     TX.apply_slstm, TX.decode_slstm)}


@pytest.mark.parametrize("kind", list(_BLOCKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_decode_blocks_match_jax(kind, dtype):
    """The block on identical inputs: full sequence with its state, then
    three decode steps from that state."""
    j_apply, j_decode, t_apply, t_decode = _BLOCKS[kind]
    jc, tc, (pj, pt) = _block(kind, dtype)
    tdt = getattr(torch, dtype)
    tol = TOL[dtype]
    B, S = 2, 20
    x = _rand((B, S + 3, jc.d_model), 8)
    wo, ws = j_apply(jnp.asarray(x[:, :S], dtype), pj, jc, return_state=True)
    go, gs = t_apply(_t(x[:, :S]).to(tdt), pt, tc, return_state=True)
    assert go.dtype == tdt
    assert set(gs) == set(ws)
    np.testing.assert_allclose(_f32(go), _f32(wo), atol=tol, rtol=0)

    def check_state(gs, ws, what):
        for name in ws:
            want_dt = torch.bfloat16 if name == "conv" else torch.float32
            assert gs[name].dtype == want_dt, (what, name)
            np.testing.assert_allclose(
                _f32(gs[name]), _f32(ws[name]), atol=tol,
                rtol=BF16_ULP if name == "conv" else 0,
                err_msg=f"{what} {name}")
    check_state(gs, ws, "prefill")
    for t in range(S, S + 3):
        xt = x[:, t:t + 1]
        wo, ws = j_decode(jnp.asarray(xt, dtype), pj, jc, ws)
        go, gs = t_decode(_t(xt).to(tdt), pt, tc, gs)
        np.testing.assert_allclose(_f32(go), _f32(wo), atol=tol, rtol=0,
                                   err_msg=f"decode at {t}")
        check_state(gs, ws, f"decode at {t}")


@pytest.mark.parametrize("kind", list(_BLOCKS))
def test_decode_updates_the_state_in_place(kind):
    _, tc, (_, pt) = _block(kind, "float32")
    init = TX.init_state_mlstm if kind == "mlstm" else TX.init_state_slstm
    state = init(tc, 2)
    before = dict(state)
    x = _t(_rand((2, 1, tc.d_model), 9))
    _, new = _BLOCKS[kind][3](x, pt, tc, state)
    assert all(new[name] is before[name] for name in before)
    assert state["conv"][:, -1].abs().sum() > 0
    assert state["m"].max() > -1e29            # the first step set m


@pytest.mark.parametrize("kind", list(_BLOCKS))
def test_short_prompt_lag_buffer_breaks_decode_in_both(kind):
    """A prompt shorter than CONV_K - 1 = 3 tokens leaves a lag buffer of as
    many rows (ROADMAP C24); the next decode step raises in both packages."""
    j_apply, j_decode, t_apply, t_decode = _BLOCKS[kind]
    jc, tc, (pj, pt) = _block(kind, "float32")
    x = _rand((2, 3, jc.d_model), 10)
    _, ws = j_apply(jnp.asarray(x[:, :2]), pj, jc, return_state=True)
    _, gs = t_apply(_t(x[:, :2]), pt, tc, return_state=True)
    assert gs["conv"].shape[1] == ws["conv"].shape[1] == 2
    with pytest.raises(Exception):
        j_decode(jnp.asarray(x[:, 2:]), pj, jc, ws)
    with pytest.raises(RuntimeError):
        t_decode(_t(x[:, 2:]), pt, tc, gs)


# ------------------------------------------------------------ model
@functools.lru_cache(maxsize=None)
def _jax_params():
    """xlstm-1.3b reduced, the JAX init at key 0 as numpy (float32 leaves
    whatever ``cfg.dtype`` is).  Drawn once, under ``jit``: op by op the
    JAX init takes three times as long."""
    init = jax.jit(lambda key, cfg: JR.init_params(key, cfg)[0],
                   static_argnums=1)
    jp = init(jax.random.key(0), jax_arch("xlstm-1.3b").reduced())
    return jax.tree.map(np.asarray, jp)


def _setup(dtype):
    jc = dataclasses.replace(jax_arch("xlstm-1.3b").reduced(), dtype=dtype)
    tc = dataclasses.replace(torch_arch("xlstm-1.3b").reduced(), dtype=dtype)
    jp = _jax_params()
    return jc, tc, jax.tree.map(jnp.asarray, jp), params_from_jax(tc, jp)


def _tokens(cfg, B=2, S=40, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_forward_prefill_decode_match_jax_in_float32():
    jc, tc, jp, tp = _setup("float32")
    tol = TOL["float32"]
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
        for name, t in layer.items():
            assert t.dtype == (torch.bfloat16 if name == "conv"
                               else torch.float32), (n, name)

    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   device="cpu")
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0,
                                   err_msg=f"decode at {t}")


def test_bf16_model_is_as_close_to_float32_as_the_references():
    """bf16 through the model entry points.  The two packages round at
    other points (matmul and activation outputs differ by a bf16 ulp here
    and there), so, as for Griffin (ROADMAP C18), bf16 parity at 0.08 is
    held on identical block inputs (test_apply_and_decode_blocks_match_jax),
    and here each package's bf16 logits are held against the reference's
    float32 logits: the port's error may be at most twice the
    reference's own."""
    jc, tc, jp, tp = _setup("bfloat16")
    jc32, _, jp32, _ = _setup("float32")
    toks = _tokens(jc)
    S = toks.shape[1]
    ref32 = _f32(_jax_forward(jp32, jc32, {"tokens": jnp.asarray(toks)}))

    def check(got, want, truth, what):
        port_err = np.abs(_f32(got) - truth).max()
        jax_err = np.abs(_f32(want) - truth).max()
        assert jax_err < 0.15, (what, jax_err)
        assert port_err <= 2 * jax_err, (what, port_err, jax_err)

    check(R.forward_logits(tp, tc, {"tokens": toks}, device="cpu"),
          _jax_forward(jp, jc, {"tokens": jnp.asarray(toks)}), ref32,
          "forward")
    pre = toks[:, :S - 4]
    jl, jcache = _jax_prefill(jp, jc, {"tokens": jnp.asarray(pre)},
                              cache_len=S)
    tl, tcache = R.prefill(tp, tc, {"tokens": pre}, cache_len=S,
                           device="cpu")
    check(tl, jl, ref32[:, S - 5], "prefill")
    for layer in tcache["layers"]:
        assert layer["conv"].dtype == torch.bfloat16
        assert layer["m"].dtype == torch.float32
    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   device="cpu")
        check(tl, jl, ref32[:, t], f"decode at {t}")


def _gap(forward, prefill, decode, toks):
    """Largest |prefill + decode logits - forward logits| over max |logit|."""
    S = toks.shape[1]
    full = np.asarray(forward(toks), np.float32)
    logits, cache = prefill(toks[:, :S - 4])
    err = np.abs(np.asarray(logits, np.float32) - full[:, S - 5]).max()
    for t in range(S - 4, S - 1):
        logits, cache = decode(toks[:, t:t + 1], t, cache)
        err = max(err, np.abs(np.asarray(logits, np.float32)
                              - full[:, t]).max())
    return float(err / np.abs(full).max())


def test_float32_decode_gap_is_the_references_own():
    """The reference rounds both blocks' conv lag buffers to bf16 in a
    float32 model (ROADMAP C21), so its prefill + decode differs from its
    forward by ~1e-3 of the logits' scale.  The port mirrors the rounding,
    so its own gap is the reference's to within 1e-5."""
    jc, tc, jp, tp = _setup("float32")
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


def test_init_cache_matches_jax_shapes_and_dtypes():
    jc, tc = (dataclasses.replace(get("xlstm-1.3b").reduced(),
                                  dtype="float32")
              for get in (jax_arch, torch_arch))
    want = flatten_with_paths(jax.tree.map(np.asarray,
                                           JR.init_cache(jc, 2, 40)))
    got = flatten_with_paths(cache_to_jax(tc, R.init_cache(tc, 2, 40,
                                                           device="cpu")))
    assert {k: (v.shape, str(v.dtype)) for k, v in got.items()} == \
        {k: (v.shape, "float32" if v.dtype.name == "bfloat16" else
             str(v.dtype)) for k, v in want.items()}
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], _f32(arr), err_msg=key)


# the gate biases and the sLSTM's recurrent weights, which the reference
# keeps and reads in float32 (ROADMAP C20)
_FLOAT32_LEAVES = {"mlstm": ("b_ig", "b_fg"),
                   "slstm": ("b_z", "b_i", "b_f", "b_o", "r_z", "r_i", "r_f",
                             "r_o")}


def test_float32_leaves_stay_float32_after_init_and_conversion():
    tc = torch_arch("xlstm-1.3b").reduced()
    assert tc.dtype == "bfloat16"
    for params in (R.init_params(tc, 0, device="cpu"),
                   params_from_jax(tc, _jax_params())):
        for n, layer in enumerate(params["layers"]):
            kind = "mlstm" if n % 2 == 0 else "slstm"
            mix = layer["mix"]
            assert "ffn" not in layer
            for name in _FLOAT32_LEAVES[kind]:
                assert mix[name].dtype == torch.float32, (n, name)
    mix = R.init_params(tc, 0, device="cpu")["layers"][0]["mix"]
    assert mix["w_up"].dtype == mix["wq"].dtype == torch.bfloat16
    np.testing.assert_allclose(mix["b_fg"].numpy(),
                               np.linspace(3.0, 6.0, tc.n_heads), rtol=1e-6)


def test_param_count_matches_jax_at_full_width():
    assert R.count_params_analytic(torch_arch("xlstm-1.3b")) == \
        JR.count_params_analytic(jax_arch("xlstm-1.3b")) == 2_020_001_984


# ------------------------------------------------------------ serving
def _requests(module, vocab, lens, max_new):
    rng = np.random.default_rng(0)
    return [module.Request(i, rng.integers(1, vocab, size=n).astype(np.int32),
                           max_new=max_new) for i, n in enumerate(lens)]


def test_serve_gives_the_jax_tokens_in_float32(monkeypatch):
    jc = dataclasses.replace(jax_arch("xlstm-1.3b").reduced(),
                             dtype="float32")
    tc = dataclasses.replace(torch_arch("xlstm-1.3b").reduced(),
                             dtype="float32")
    lens = [16, 12, 16, 9, 16]
    # both serve the same weights: the JAX serve draws its own with the
    # op-by-op init, which this test hands the cached draw instead
    monkeypatch.setattr(jax_serve.R, "init_params", lambda key, cfg: (
        jax.tree.map(jnp.asarray, _jax_params()), None))
    want = jax_serve.serve(jc, _requests(jax_serve, jc.vocab_size, lens, 4),
                           slots=2, ctx_len=32, seed=0)
    params = params_from_jax(tc, _jax_params())
    got = torch_serve.serve(tc, _requests(torch_serve, tc.vocab_size, lens, 4),
                            slots=2, ctx_len=32, seed=0, params=params,
                            device="cpu")
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]


def test_cli_serves_the_xlstm_smoke_arch_on_the_cpu(capsys):
    done = torch_serve.main(["--arch", "xlstm-1.3b-smoke", "--device", "cpu",
                             "--requests", "3", "--slots", "2",
                             "--prompt-len", "8", "--gen", "3"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    assert "arch=xlstm-1.3b-smoke device=cpu requests=3 new_tokens=9" in out
