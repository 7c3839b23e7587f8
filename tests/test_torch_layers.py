"""The port's layers (repro_torch.models.layers) against the JAX package's,
on the CPU.  Inputs are made with numpy from a seed and handed to both."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import layers as JL
from repro_torch.configs import get_arch as torch_arch
from repro_torch.models import layers as TL

# float32 on both sides, same formulas, different op order: a few ulps
F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 on both sides: scores and probabilities round to bf16 (8 bits of
# mantissa) at the same points, sums may be taken in another order
BF16 = dict(rtol=2e-2, atol=2e-2)


def _rand(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_rms_norm_matches_jax():
    x, w = _rand((2, 5, 64)), _rand((64,), 1, 0.1)
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(TL.rms_norm(_t(x), _t(w)).numpy(), want, **F32)


def test_rms_norm_bf16_keeps_dtype_and_matches_jax():
    x, w = _rand((2, 5, 64)), _rand((64,), 1, 0.1)
    want = JL.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w))
    got = TL.rms_norm(_t(x).bfloat16(), _t(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


@pytest.mark.parametrize("dh", [64, 120])
def test_rope_matches_jax(dh):
    x = _rand((2, 7, 3, dh))
    pos = np.arange(7, dtype=np.int32) + 5
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))
    got = TL.rope(_t(x), _t(pos), 10_000.0).numpy()
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_gated_mlp_matches_jax(act):
    d, f = 16, 32
    p = {"w1": _rand((d, f), 1, 0.3), "w2": _rand((f, d), 2, 0.3)}
    if TL.is_gated_act(act):
        p["w3"] = _rand((d, f), 3, 0.3)
    x = _rand((2, 5, d), 4)
    want = np.asarray(JL.gated_mlp(jnp.asarray(x),
                                   {k: jnp.asarray(v) for k, v in p.items()},
                                   act))
    got = TL.gated_mlp(_t(x), {k: _t(v) for k, v in p.items()}, act).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    got = TL.act_fn("gelu")(x)
    want = np.asarray(JL.act_fn("gelu")(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert float((got - exact).abs().max()) > 1e-4   # not the exact form


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, 0, 0, None),
    (True, 3, 0, None),
    (True, 0, 4, None),
    (True, 5, 4, None),
    (False, 0, 0, 7),
    (False, 0, 0, None),
    (False, 4, 2, 9),
])
def test_attention_matches_jax(causal, window, q_offset, kv_len):
    B, Sq, Sk, H, KH, Dh = 2, 6, 10, 4, 2, 16
    q, k, v = (_rand((B, Sq, H, Dh), 1), _rand((B, Sk, KH, Dh), 2),
               _rand((B, Sk, KH, Dh), 3))
    want = np.asarray(JL.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.int32(kv_len)))
    got = TL.attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                       q_offset=q_offset, kv_len=kv_len).numpy()
    np.testing.assert_allclose(got, want, **F32)


def test_attention_bf16_matches_jax():
    B, S, H, KH, Dh = 2, 24, 4, 2, 16
    q, k, v = (_rand((B, S, H, Dh), 1), _rand((B, S, KH, Dh), 2),
               _rand((B, S, KH, Dh), 3))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = JL.attention(bf(q), bf(k), bf(v), causal=True, window=8)
    got = TL.attention(_t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(),
                       causal=True, window=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_attention_long_query_blocks_match_jax():
    # above _PLAIN_ATTN_MAX query rows the port evaluates q in blocks of
    # _QBLOCK; at a length that is no multiple of 512 the reference does not
    S = TL._PLAIN_ATTN_MAX + 5
    q, k, v = (_rand((1, S, 2, 8), i) for i in range(3))
    want = np.asarray(JL.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=40))
    got = TL.attention(_t(q), _t(k), _t(v), causal=True, window=40).numpy()
    np.testing.assert_allclose(got, want, **F32)


def _cfgs():
    """GQA reduced config in float32, for both packages."""
    j = dataclasses.replace(jax_arch("h2o-danube-3-4b").reduced(),
                            n_kv_heads=2, dtype="float32")
    t = dataclasses.replace(torch_arch("h2o-danube-3-4b").reduced(),
                            n_kv_heads=2, dtype="float32")
    return j, t


@pytest.mark.parametrize("window,S_cache,pos", [
    (0, 12, 5),       # plain append
    (0, 12, 11),      # last slot
    (0, 12, 12),      # past the cache: the reference clamps to the last slot
    (0, 12, 20),
    (8, 8, 5),        # ring, not yet wrapped
    (8, 8, 13),       # ring wrap: slot 13 % 8
    (8, 8, 16),
])
def test_decode_attention_block_matches_jax(window, S_cache, pos):
    jc, tc = _cfgs()
    d, H, KH, Dh = tc.d_model, tc.n_heads, tc.n_kv_heads, tc.head_dim
    p = {"ln": _rand((d,), 1, 0.1), "wq": _rand((d, H * Dh), 2, d ** -0.5),
         "wk": _rand((d, KH * Dh), 3, d ** -0.5),
         "wv": _rand((d, KH * Dh), 4, d ** -0.5),
         "wo": _rand((H * Dh, d), 5, (H * Dh) ** -0.5)}
    ck, cv = _rand((2, S_cache, KH, Dh), 6), _rand((2, S_cache, KH, Dh), 7)
    x = _rand((2, 1, d), 8)
    jo, jcache = JL.decode_attention_block(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jc,
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}, jnp.int32(pos),
        window=window)
    to, tcache = TL.decode_attention_block(
        _t(x), {k: _t(v) for k, v in p.items()}, tc,
        {"k": _t(ck), "v": _t(cv)}, pos, window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **F32)
    slot = pos % S_cache if window else min(pos, S_cache - 1)
    changed = np.flatnonzero(np.any(tcache["k"].numpy() != ck, axis=(0, 2, 3)))
    assert changed.tolist() == [slot]
