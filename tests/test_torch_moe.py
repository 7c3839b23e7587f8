"""The port's MoE layers and grouped expert-FFN against the JAX package's, on
the CPU: routing, capacity, both dispatches (with forced overflow), the
plain expert FFN against the Pallas kernel in interpret mode, and the MoE
models (granite-moe, a wide-routing variant, mixtral) end to end."""
import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels.moe_gmm import ops as jax_gmm_ops
from repro.kernels.moe_gmm import ref as jax_gmm_ref
from repro.launch import serve as jax_serve
from repro.launch import steps as jax_steps
from repro.models import moe as JM
from repro.models import registry as JR
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_from_jax)
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.launch import serve as torch_serve
from repro_torch.models import moe as TM
from repro_torch.models import registry as R

# float32: the same sums in another order, over d <= 64 and f <= 128 terms.
BLOCK_TOL = 1e-5
# model logits: float32 1e-4 (2 layers, O(10) logits); bf16 0.08, the bar
# tests/test_models.py sets for bf16 decode.
MODEL_TOL = {"float32": 1e-4, "bfloat16": 0.08}

# granite-moe reduced (4 experts top-2), a wide-routing variant at granite's
# own routing (40 experts, top-8, at d 64) and mixtral reduced (SWA + MoE)
MOE_CASES = {
    "granite-moe-3b-a800m": lambda get: get("granite-moe-3b-a800m").reduced(),
    "granite-wide-routing": lambda get: dataclasses.replace(
        get("granite-moe-3b-a800m").reduced(), n_experts=40, top_k=8),
    "mixtral-8x7b": lambda get: get("mixtral-8x7b").reduced(),
}


def _configs(case, dtype="float32", **extra):
    j, t = MOE_CASES[case](jax_arch), MOE_CASES[case](torch_arch)
    return (dataclasses.replace(j, dtype=dtype, **extra),
            dataclasses.replace(t, dtype=dtype, **extra))


def _moe_params(cfg, seed=0):
    """One MoE layer's weights as numpy, at the init's scales."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {"ln": (rng.standard_normal(d) * 0.1).astype(np.float32),
            "router": (rng.standard_normal((d, E)) / np.sqrt(d))
            .astype(np.float32),
            "w1": (rng.standard_normal((E, d, f)) / np.sqrt(d))
            .astype(np.float32),
            "w3": (rng.standard_normal((E, d, f)) / np.sqrt(d))
            .astype(np.float32),
            "w2": (rng.standard_normal((E, f, d)) / np.sqrt(f))
            .astype(np.float32)}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _jax_slots(idx, E):
    """The reference's slot formula (moe.py:132-133) on its own idx."""
    onehot = jax.nn.one_hot(jnp.asarray(idx).reshape(-1), E, dtype=jnp.int32)
    return np.asarray(jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, -1) - 1)


# --------------------------------------------------------------- routing
@pytest.mark.parametrize("T", [1, 8, 37, 160])
@pytest.mark.parametrize("case", ["granite-moe-3b-a800m",
                                  "granite-wide-routing"])
def test_router_topk_matches_jax(case, T):
    jc, tc = _configs(case)
    x = np.random.default_rng(T).standard_normal((T, jc.d_model)) \
        .astype(np.float32)
    wr = _moe_params(jc)["router"]
    jw, jidx, jaux = JM.router_topk(jnp.asarray(x), jnp.asarray(wr), jc.top_k)
    tw, tidx, taux = TM.router_topk(torch.from_numpy(x),
                                    torch.from_numpy(wr), tc.top_k)
    assert tw.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("T", [1, 4, 7, 8, 100, 511, 512, 513, 1000, 1024,
                               2048, 4000, 5000, 16384])
def test_capacity_and_group_size_match_jax(T):
    for E, k, cf in [(40, 8, 1.25), (8, 2, 1.25), (4, 2, 1.25), (40, 8, 5.0),
                     (4, 2, 0.25)]:
        assert TM._group_size(T, k, cf) == JM._group_size(T, k, cf)
        c = TM._capacity(T, E, k, cf)
        assert c == JM._capacity(T, E, k, cf)
        assert c >= 8 and c % 8 == 0


@pytest.mark.parametrize("shape,E", [((37 * 8,), 40), ((160 * 2,), 4),
                                     ((3, 50), 8), ((1,), 4)])
def test_slots_are_the_references_cumsum_ranks(shape, E):
    flat_e = torch.from_numpy(np.random.default_rng(E).integers(0, E, shape))
    onehot = torch.nn.functional.one_hot(flat_e, E)
    want = (torch.cumsum(onehot, -2) * onehot).sum(-1) - 1
    assert torch.equal(TM._slots(flat_e, E), want)


# --------------------------------------------------------------- dispatch
def _run_block(fn_j, fn_t, case, T, dtype="float32", **extra):
    jc, tc = _configs(case, dtype, **extra)
    p = _moe_params(jc)
    jp, tp = _both(p)
    x = np.random.default_rng(1).standard_normal((T, jc.d_model)) \
        .astype(np.float32)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jy, jaux = fn_j(jnp.asarray(x).astype(jnp.dtype(dtype)), jp, jc)
    ty, taux = fn_t(torch.from_numpy(x).to(dt), tp, tc)
    assert ty.dtype == dt
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    return (np.asarray(jy.astype(jnp.float32)), ty.float().numpy(),
            jc, tc, x, p)


@pytest.mark.parametrize("cf", [1.25, 0.25])        # 0.25: forced overflow
@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("kernel_mode", ["pallas", "reference"])
def test_moe_gather_matches_jax(case, cf, kernel_mode):
    want, got, jc, tc, x, p = _run_block(
        functools.partial(JM.moe_gather, kernel_mode=kernel_mode),
        TM.moe_gather, case, 96, capacity_factor=cf)
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=0)
    # the same (token, k) pairs are dropped: the port's slots against the
    # reference's formula on the reference's routing
    _, jidx, _ = JM.router_topk(jnp.asarray(x), jnp.asarray(p["router"]),
                                jc.top_k)
    C = JM._capacity(96, jc.n_experts, jc.top_k, cf)
    _, tidx, _ = TM.router_topk(torch.from_numpy(x),
                                torch.from_numpy(p["router"]), tc.top_k)
    jkeep = _jax_slots(jidx, jc.n_experts) < C
    tkeep = (TM._slots(tidx.reshape(-1), tc.n_experts) < C).numpy()
    np.testing.assert_array_equal(tkeep, jkeep)
    if cf < 1:                                   # the overflow did happen
        assert not jkeep.all()


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_einsum_matches_jax(case, cf):
    # T = 160 <= 512: one group of 160, which divides T
    want, got, *_ = _run_block(JM.moe_einsum, TM.moe_einsum, case, 160,
                               capacity_factor=cf)
    np.testing.assert_allclose(got, want, atol=BLOCK_TOL, rtol=0)


def test_moe_einsum_raises_where_the_reference_reshape_fails():
    jc, tc = _configs("granite-moe-3b-a800m")
    jp, tp = _both(_moe_params(jc))
    T = 1000                                         # g = 512 does not divide
    assert JM._group_size(T, jc.top_k, jc.capacity_factor) == 512
    with pytest.raises(TypeError):
        JM.moe_einsum(jnp.zeros((T, jc.d_model)), jp, jc)
    with pytest.raises(ValueError, match="1000 tokens .* groups of 512"):
        TM.moe_einsum(torch.zeros((T, tc.d_model)), tp, tc)
    # the gather dispatch serves the same T, as in the reference
    y, _ = TM.moe_gather(torch.zeros((T, tc.d_model)), tp, tc)
    assert y.shape == (T, tc.d_model)


@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_block_in_bf16_matches_jax(dispatch):
    """Block level in bf16 on identical inputs: routing agrees exactly (the
    router is float32 in both), the outputs within bf16 rounding."""
    jc, tc = _configs("granite-wide-routing", "bfloat16")
    p = _moe_params(jc)
    jp, tp = _both(p)
    x = np.random.default_rng(2).standard_normal((2, 80, jc.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).bfloat16()
    jy, _ = JM.moe_block(xj, jp, jc, dispatch=dispatch)
    ty, _ = TM.moe_block(xt, tp, tc, dispatch=dispatch)
    assert ty.dtype == torch.bfloat16
    err = np.abs(ty.float().numpy() - np.asarray(jy.astype(jnp.float32)))
    # the residual is O(1); bf16 rounds at 2**-8 of it at different points
    assert err.max() <= 0.05, err.max()


def test_moe_block_rejects_an_unknown_dispatch():
    _, tc = _configs("granite-moe-3b-a800m")
    tp = _both(_moe_params(tc))[1]
    with pytest.raises(ValueError, match="dispatch 'scatter'"):
        TM.moe_block(torch.zeros((1, 4, tc.d_model)), tp, tc,
                     dispatch="scatter")


# ------------------------------------------------------------ expert FFN
@pytest.mark.parametrize("E,C,d,f,act,gated", [
    (3, 64, 64, 128, "swiglu", True), (2, 40, 32, 96, "geglu", True),
    (2, 64, 64, 128, "gelu", False), (3, 24, 48, 64, "relu2", False),
    (2, 16, 32, 64, "relu2", True), (2, 16, 32, 64, "swiglu", False),
])
def test_plain_expert_ffn_matches_pallas_and_reference(E, C, d, f, act,
                                                       gated):
    rng = np.random.default_rng(E * C + f)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    xe[:, -3:] = 0.0                                  # pad rows
    p = {"w1": (rng.standard_normal((E, d, f)) / np.sqrt(d))
         .astype(np.float32),
         "w2": (rng.standard_normal((E, f, d)) / np.sqrt(f))
         .astype(np.float32)}
    if gated:
        p["w3"] = (rng.standard_normal((E, d, f)) / np.sqrt(d)) \
            .astype(np.float32)
    jp, tp = _both(p)
    got = gmm_ops.expert_ffn(torch.from_numpy(xe), tp, act).numpy()
    pallas = jax_gmm_ops.expert_ffn(jnp.asarray(xe), jp, act, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=BLOCK_TOL,
                               rtol=0)
    want = jax_gmm_ref.reference_expert_ffn(jnp.asarray(xe), jp, act)
    np.testing.assert_allclose(got, np.asarray(want), atol=BLOCK_TOL, rtol=0)
    np.testing.assert_array_equal(got[:, -3:], 0.0)
    np.testing.assert_array_equal(
        got, gmm_ref.reference_expert_ffn(torch.from_numpy(xe), tp,
                                          act).numpy())


def _fills(kind, E, C, rng):
    """Bucket fills: all empty, partial (at random, one empty and one
    full), or all full."""
    if kind == "empty":
        return np.zeros(E, np.int32)
    if kind == "full":
        return np.full(E, C, np.int32)
    fills = rng.integers(0, C + 1, E).astype(np.int32)
    fills[0], fills[-1] = 0, C
    return fills


@pytest.mark.parametrize("fill", ["empty", "partial", "full"])
@pytest.mark.parametrize("act,gated", [
    ("swiglu", True), ("geglu", True), ("gelu", False), ("relu2", False),
    ("relu2", True), ("swiglu", False),
])
def test_expert_ffn_with_counts_matches_pallas_and_reference(act, gated,
                                                             fill):
    """The buckets' fills as ``counts``: rows past each fill are zero pads
    (as the gather dispatch leaves them), the JAX functions see only the
    buckets, and the port's y equals theirs, with exactly 0 past the
    fills."""
    E, C, d, f = 4, 24, 32, 64
    rng = np.random.default_rng(zlib.crc32(f"{act} {gated} {fill}".encode()))
    counts = _fills(fill, E, C, rng)
    xe = rng.standard_normal((E, C, d)).astype(np.float32)
    xe[np.arange(C)[None, :] >= counts[:, None]] = 0.0
    p = {"w1": (rng.standard_normal((E, d, f)) / np.sqrt(d))
         .astype(np.float32),
         "w2": (rng.standard_normal((E, f, d)) / np.sqrt(f))
         .astype(np.float32)}
    if gated:
        p["w3"] = (rng.standard_normal((E, d, f)) / np.sqrt(d)) \
            .astype(np.float32)
    jp, tp = _both(p)
    got = gmm_ops.expert_ffn(torch.from_numpy(xe), tp, act,
                             torch.from_numpy(counts)).numpy()
    pallas = jax_gmm_ops.expert_ffn(jnp.asarray(xe), jp, act, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=BLOCK_TOL,
                               rtol=0)
    want = jax_gmm_ref.reference_expert_ffn(jnp.asarray(xe), jp, act)
    np.testing.assert_allclose(got, np.asarray(want), atol=BLOCK_TOL, rtol=0)
    pads = np.arange(C)[None, :] >= counts[:, None]
    assert (got[pads] == 0.0).all()
    if fill == "full":
        np.testing.assert_array_equal(
            got, gmm_ops.expert_ffn(torch.from_numpy(xe), tp, act).numpy())


def test_plain_expert_ffn_zeroes_rows_past_counts_whatever_they_hold():
    """Past counts[e] the rows are pads by contract: y is 0 there even
    where xe holds data, and the live rows are those of the full
    product."""
    rng = np.random.default_rng(5)
    E, C, d, f = 3, 16, 32, 48
    xe = torch.from_numpy(rng.standard_normal((E, C, d)).astype(np.float32))
    p = {k: torch.from_numpy((rng.standard_normal(s) / 6).astype(np.float32))
         for k, s in (("w1", (E, d, f)), ("w3", (E, d, f)),
                      ("w2", (E, f, d)))}
    counts = torch.tensor([0, 7, 16], dtype=torch.int32)
    got = gmm_ops.expert_ffn(xe, p, "swiglu", counts)
    full = gmm_ops.expert_ffn(xe, p, "swiglu")
    for e, n in enumerate(counts.tolist()):
        assert torch.equal(got[e, :n], full[e, :n])
        assert not got[e, n:].any()


@pytest.mark.parametrize("cf", [1.25, 0.25])        # 0.25: forced overflow
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_gather_hands_the_kernel_each_buckets_fill(case, cf,
                                                       monkeypatch):
    """moe_gather's counts are each bucket's fill: the pairs the reference
    routes to the expert and keeps (slot < C), int32 on the tokens' device,
    and the bucket holds its tokens in its first counts[e] rows, zeros
    after."""
    jc, tc = _configs(case, capacity_factor=cf)
    p = _moe_params(jc)
    _, tp = _both(p)
    T = 96
    x = np.random.default_rng(4).standard_normal((T, jc.d_model)) \
        .astype(np.float32)
    seen = []
    real = TM.gmm_ops.expert_ffn

    def recording(xe, q, act, counts=None):
        seen.append((xe.clone(), counts))
        return real(xe, q, act, counts)
    monkeypatch.setattr(TM.gmm_ops, "expert_ffn", recording)
    TM.moe_gather(torch.from_numpy(x), tp, tc)
    (xe, counts), = seen
    assert counts.dtype == torch.int32 and counts.shape == (jc.n_experts,)
    _, jidx, _ = JM.router_topk(jnp.asarray(x), jnp.asarray(p["router"]),
                                jc.top_k)
    C = JM._capacity(T, jc.n_experts, jc.top_k, cf)
    jidx = np.asarray(jidx).reshape(-1)
    kept = jidx[_jax_slots(jidx, jc.n_experts) < C]
    want = np.bincount(kept, minlength=jc.n_experts)
    np.testing.assert_array_equal(counts.numpy(), want)
    live = np.arange(C)[None, :] < want[:, None]
    assert (xe.numpy()[~live] == 0).all()
    assert (np.abs(xe.numpy()).sum(-1)[live] > 0).all()
    if cf < 1:                                   # some buckets overflowed
        assert (want == C).any()


def test_slots_and_counts_count_each_experts_pairs():
    flat_e = torch.from_numpy(np.random.default_rng(9).integers(0, 8,
                                                                (3, 50)))
    slot, counts = TM._slots_and_counts(flat_e, 8)
    assert torch.equal(slot, TM._slots(flat_e, 8))
    for row, c in zip(flat_e, counts):
        assert torch.equal(c, torch.bincount(row, minlength=8))


def test_expert_ffn_checks_shapes_on_the_cpu_too():
    xe = torch.zeros((2, 8, 16))
    p = {"w1": torch.zeros((2, 16, 32)), "w2": torch.zeros((2, 32, 16))}
    with pytest.raises(ValueError, match="unknown act"):
        gmm_ops.expert_ffn(xe, p, "tanh")
    with pytest.raises(ValueError, match="w1"):
        gmm_ops.expert_ffn(xe, {**p, "w1": torch.zeros((2, 8, 32))})
    with pytest.raises(ValueError, match="w3"):
        gmm_ops.expert_ffn(xe, {**p, "w3": torch.zeros((2, 16, 8))})
    with pytest.raises(ValueError, match="counts must be int32"):
        gmm_ops.expert_ffn(xe, p, "swiglu", torch.ones(2, dtype=torch.long))
    with pytest.raises(ValueError, match="counts must be int32"):
        gmm_ops.expert_ffn(xe, p, "swiglu", torch.ones(3, dtype=torch.int32))


# ------------------------------------------------------------------ models
_jax_forward = jax.jit(JR.forward_logits, static_argnums=1,
                       static_argnames="moe_dispatch")
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames=("cache_len", "moe_dispatch"))
_jax_decode = jax.jit(JR.decode_step, static_argnums=1,
                      static_argnames="moe_dispatch")


def _setup(case, dtype):
    jc, tc = _configs(case, dtype)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    return jc, tc, jp, params_from_jax(tc, jax.tree.map(np.asarray, jp))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("case,dtype,dispatch", [
    ("granite-moe-3b-a800m", "float32", "gather"),
    ("granite-moe-3b-a800m", "float32", "einsum"),
    ("granite-wide-routing", "float32", "gather"),
    ("mixtral-8x7b", "float32", "gather"),
    ("mixtral-8x7b", "float32", "einsum"),
])
def test_moe_forward_prefill_decode_match_jax(case, dtype, dispatch):
    jc, tc, jp, tp = _setup(case, dtype)
    tol = MODEL_TOL[dtype]
    B, S = 2, 80                       # > 64, mixtral's reduced window
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)
    want = _jax_forward(jp, jc, {"tokens": jnp.asarray(toks)},
                        moe_dispatch=dispatch)
    got = R.forward_logits(tp, tc, {"tokens": toks}, moe_dispatch=dispatch,
                           device="cpu")
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)

    pre = toks[:, :S - 4]
    jl, jcache = _jax_prefill(jp, jc, {"tokens": jnp.asarray(pre)},
                              cache_len=S, moe_dispatch=dispatch)
    tl, tcache = R.prefill(tp, tc, {"tokens": pre}, cache_len=S,
                           moe_dispatch=dispatch, device="cpu")
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0)
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    tflat = flatten_with_paths(cache_to_jax(tc, tcache))
    assert set(jflat) == set(tflat)
    for key, arr in jflat.items():
        np.testing.assert_allclose(tflat[key], _f32(arr), atol=tol, rtol=0,
                                   err_msg=key)
    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache, moe_dispatch=dispatch)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   moe_dispatch=dispatch, device="cpu")
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0,
                                   err_msg=f"decode at {t}")


def _record_routing(monkeypatch, module, sink):
    real = module.router_topk

    def recording(x, wr, k):
        w, idx, aux = real(x, wr, k)
        sink.append(np.asarray(idx))
        return w, idx, aux
    monkeypatch.setattr(module, "router_topk", recording)


def test_moe_model_in_bf16_routes_as_jax_and_matches(monkeypatch):
    """bf16 forward, prefill and decode: first the top-k sets of every MoE
    call agree for this seed, then the logits meet the bf16 bar.  The JAX
    side runs op by op, so that routing can be recorded (under jit, XLA
    rounds bf16 at yet other points; one decode logit of 512 then differs
    by 0.10).  The wide-routing variant does not route alike in bf16: its
    second layer's input is rounded at other points in the two frameworks,
    and 1-3 of 80 tokens flip a near-tie between their 8th and 9th expert;
    its bf16 parity is held at the block level, on identical inputs."""
    jc, tc, jp, tp = _setup("granite-moe-3b-a800m", "bfloat16")
    tol = MODEL_TOL["bfloat16"]
    toks = np.random.default_rng(3).integers(
        0, jc.vocab_size, (2, 40)).astype(np.int32)
    S = toks.shape[1]
    jroutes, troutes = [], []
    _record_routing(monkeypatch, JM, jroutes)
    _record_routing(monkeypatch, TM, troutes)
    pairs = []
    with jax.disable_jit():
        pairs.append((JR.forward_logits(jp, jc, {"tokens": jnp.asarray(toks)},
                                        moe_dispatch="gather"),
                      R.forward_logits(tp, tc, {"tokens": toks},
                                       moe_dispatch="gather", device="cpu")))
        jl, jcache = JR.prefill(jp, jc,
                                {"tokens": jnp.asarray(toks[:, :S - 3])},
                                cache_len=S, moe_dispatch="gather")
        tl, tcache = R.prefill(tp, tc, {"tokens": toks[:, :S - 3]},
                               cache_len=S, moe_dispatch="gather",
                               device="cpu")
        pairs.append((jl, tl))
        for t in range(S - 3, S - 1):
            jl, jcache = JR.decode_step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t), jcache,
                                        moe_dispatch="gather")
            tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                       moe_dispatch="gather", device="cpu")
            pairs.append((jl, tl))
    # forward, prefill and 2 decode steps through every MoE layer
    assert len(jroutes) == len(troutes) == 4 * tc.n_layers
    for n, (a, b) in enumerate(zip(jroutes, troutes)):
        np.testing.assert_array_equal(np.sort(a, -1), np.sort(b, -1),
                                      err_msg=f"MoE call {n}")
    for n, (want, got) in enumerate(pairs):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0,
                                   err_msg=f"call {n}")


# ------------------------------------------------------------------ serving
def _requests(module, vocab, lens, max_new):
    rng = np.random.default_rng(0)
    return [module.Request(i, rng.integers(1, vocab, size=n).astype(np.int32),
                           max_new=max_new) for i, n in enumerate(lens)]


def test_serve_gives_the_jax_tokens_with_the_gather_dispatch(monkeypatch):
    jc, tc = _configs("granite-moe-3b-a800m")
    # the JAX serving loop, its steps built with the gather dispatch
    monkeypatch.setattr(jax_serve, "make_prefill_step", functools.partial(
        jax_steps.make_prefill_step, moe_dispatch="gather"))
    monkeypatch.setattr(jax_serve, "make_serve_step", functools.partial(
        jax_steps.make_serve_step, moe_dispatch="gather"))
    lens = [16, 12, 16, 9, 16]
    want = jax_serve.serve(jc, _requests(jax_serve, jc.vocab_size, lens, 4),
                           slots=2, ctx_len=32, seed=0)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    params = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    got = torch_serve.serve(tc, _requests(torch_serve, tc.vocab_size, lens, 4),
                            slots=2, ctx_len=32, seed=0, params=params,
                            moe_dispatch="gather", device="cpu")
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]


def test_cli_serves_the_moe_smoke_arch_on_the_cpu(capsys):
    done = torch_serve.main(["--arch", "granite-moe-3b-a800m-smoke",
                             "--device", "cpu", "--moe-dispatch", "gather",
                             "--requests", "3", "--slots", "2",
                             "--prompt-len", "8", "--gen", "3"])
    assert len(done) == 3 and all(len(r.generated) == 3 for r in done)
    out = capsys.readouterr().out
    assert "arch=granite-moe-3b-a800m-smoke device=cpu requests=3 " \
           "new_tokens=9" in out
