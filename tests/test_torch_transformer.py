"""The port's dense model stack against the JAX package's, on the CPU:
forward_logits, prefill (logits and cache) and decode_step with the same
(converted) weights and the same tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import registry as JR
from repro.models.config import ArchConfig as JaxArchConfig
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_from_jax, params_to_jax)
from repro_torch.models import config as TC
from repro_torch.models import layers as TL
from repro_torch.models import registry as R
from repro_torch.tree import tree_leaves
from test_torch_vision import draw_nonzero

# float32: same math, other op order, 2-4 layers -> ~1e-6 of O(10) logits.
# bf16: activations round to 8 mantissa bits at different points in the two
# frameworks; 0.08 is the bar tests/test_models.py sets for bf16 decode.
TOL = {"float32": 1e-4, "bfloat16": 0.08}

# A dense pattern with a tail layer: (ATTN, SWA) x 1 scanned period + 1
# unrolled ATTN, window 16 < context, so ring rotation runs in prefill.
_TAIL = dict(name="attn-swa-tail", family="dense", n_layers=3, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
             block_pattern=("attn", "swa"), window=16, act="geglu",
             remat="none")

CASES = {
    # MHA, tied embeddings, full attention
    "minicpm-2b": lambda get: get("minicpm-2b").reduced(),
    # GQA (reduced() leaves H = KH = 4) with sliding window 64 < S
    "h2o-danube-3-4b": lambda get: dataclasses.replace(
        get("h2o-danube-3-4b").reduced(), n_kv_heads=2),
    # the non-gated relu2 MLP and an untied head, GQA 4/2
    "minitron-8b": lambda get: dataclasses.replace(
        get("minitron-8b").reduced(), n_kv_heads=2),
    # 56 query heads over 8 KV heads is a group of 7, which reduced()
    # (MHA, 4 heads) loses: 7 heads of 16 over one KV head keep it
    "deepseek-coder-33b": lambda get: dataclasses.replace(
        get("deepseek-coder-33b").reduced(), d_model=112, n_heads=7,
        n_kv_heads=1, head_dim=16),
}
# cases whose norm scales are drawn non-zero before conversion: at init
# they are 0, where a fault in a norm or its placement does not show
DRAWN = ("minitron-8b", "deepseek-coder-33b")


# jit: one compile per function beats op-by-op dispatch of the reference
_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames="cache_len")
_jax_decode = jax.jit(JR.decode_step, static_argnums=1)


def _configs(case, dtype):
    if case == "attn-swa-tail":
        j, t = JaxArchConfig(**_TAIL), TC.ArchConfig(**_TAIL)
    elif case not in CASES:            # an arch's reduced config as it is
        j, t = jax_arch(case).reduced(), torch_arch(case).reduced()
    else:
        j, t = CASES[case](jax_arch), CASES[case](torch_arch)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _setup(case, dtype):
    jc, tc = _configs(case, dtype)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    jp = draw_nonzero(jp) if case in DRAWN else jax.tree.map(np.asarray, jp)
    tp = params_from_jax(tc, jp)
    return jc, tc, jp, tp


def _f32(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


# each case in float32, and the served dtype once
@pytest.mark.parametrize("case,dtype", [
    ("minicpm-2b", "float32"), ("h2o-danube-3-4b", "float32"),
    ("attn-swa-tail", "float32"), ("minicpm-2b", "bfloat16"),
    ("minitron-8b", "float32"), ("minitron-8b", "bfloat16"),
    ("deepseek-coder-33b", "float32"), ("deepseek-coder-33b", "bfloat16")])
def test_forward_prefill_decode_match_jax(case, dtype):
    jc, tc, jp, tp = _setup(case, dtype)
    tol = TOL[dtype]
    B, S = 2, 80                     # > 64, the reduced window: ring roll
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, (B, S)).astype(np.int32)

    want = _jax_forward(jp, jc, {"tokens": jnp.asarray(toks)})
    got = R.forward_logits(tp, tc, {"tokens": toks}, device="cpu")
    assert got.dtype == (torch.float32 if dtype == "float32"
                         else torch.bfloat16)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0)

    pre = {"tokens": toks[:, :S - 4]}
    jl, jcache = _jax_prefill(jp, jc, {"tokens": jnp.asarray(pre["tokens"])},
                              cache_len=S)
    tl, tcache = R.prefill(tp, tc, pre, cache_len=S, device="cpu")
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0)
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    tflat = flatten_with_paths(cache_to_jax(tc, tcache))
    assert set(jflat) == set(tflat)
    for key, arr in jflat.items():
        assert tflat[key].shape == arr.shape, key
        np.testing.assert_allclose(tflat[key], _f32(arr), atol=tol, rtol=0,
                                   err_msg=key)
    for layer in tcache["layers"]:
        assert layer["k"].dtype == (torch.float32 if dtype == "float32"
                                    else torch.bfloat16)

    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   device="cpu")
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=tol, rtol=0,
                                   err_msg=f"decode at {t}")


def _decode_vs_forward(tc, tp, toks, *, pos_shift=0, cache_edit=None):
    """Largest |prefill+decode logits - forward logits| (the logic of
    tests/test_models.py's test_decode_matches_full_forward)."""
    S = toks.shape[1]
    full = R.forward_logits(tp, tc, {"tokens": toks}, device="cpu")
    logits, cache = R.prefill(tp, tc, {"tokens": toks[:, :S - 4]},
                              cache_len=S, device="cpu")
    if cache_edit:
        cache_edit(cache)
    err = float((logits - full[:, S - 5]).abs().max())
    for t in range(S - 4, S - 1):
        logits, cache = R.decode_step(tp, tc, toks[:, t:t + 1], t + pos_shift,
                                      cache, device="cpu")
        err = max(err, float((logits - full[:, t]).abs().max()))
    return err


@pytest.mark.parametrize("case", ["minicpm-2b", "h2o-danube-3-4b",
                                  "minitron-8b", "deepseek-coder-33b"])
def test_decode_matches_forward_and_catches_position_and_slot_faults(case):
    _, tc, _, tp = _setup(case, "float32")
    toks = np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, 80)).astype(np.int32)
    assert _decode_vs_forward(tc, tp, toks) < TOL["float32"]
    # the same check fails on an off-by-one position ...
    assert _decode_vs_forward(tc, tp, toks, pos_shift=1) > 10 * TOL["float32"]

    # ... and on a ring that is one slot out of place
    def shift_ring(cache):
        for layer in cache["layers"]:
            for name in ("k", "v"):
                layer[name].copy_(torch.roll(layer[name], 1, dims=1))
    assert _decode_vs_forward(tc, tp, toks, cache_edit=shift_ring) > \
        10 * TOL["float32"]


@pytest.mark.parametrize("arch", ["minicpm-2b", "h2o-danube-3-4b",
                                  "granite-moe-3b-a800m", "mixtral-8x7b",
                                  "recurrentgemma-9b", "xlstm-1.3b",
                                  "minitron-8b", "deepseek-coder-33b"])
def test_param_count_matches_jax(arch):
    assert R.count_params_analytic(torch_arch(arch)) == \
        JR.count_params_analytic(jax_arch(arch))
    assert torch_arch(arch).param_count() == \
        JR.count_params_analytic(jax_arch(arch))
    assert R.count_params_analytic(torch_arch(arch), active_only=True) == \
        JR.count_params_analytic(jax_arch(arch), active_only=True)


@pytest.mark.parametrize("case", list(CASES) + ["attn-swa-tail",
                                                 "granite-moe-3b-a800m",
                                                 "mixtral-8x7b",
                                                 "recurrentgemma-9b",
                                                 "xlstm-1.3b"])
def test_init_matches_jax_shapes_and_scales(case):
    jc, tc = _configs(case, "float32")
    jp, _ = JR.init_params(jax.random.key(0), jc)
    want = flatten_with_paths(jax.tree.map(np.asarray, jp))
    got = flatten_with_paths(
        params_to_jax(tc, R.init_params(tc, 0, device="cpu")))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    for key in want:
        if want[key].size >= 4096:                # std of a random matrix
            assert got[key].std() == pytest.approx(want[key].std(), rel=0.1)
        elif not want[key].any():                 # norm weights start at 0
            assert not got[key].any(), key


# the four configs chip_smoke.py serves at full size since they first ran
# on the card: what init allocates there, counted on the meta device
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "minitron-8b",
                                  "deepseek-coder-33b", "mixtral-8x7b"])
def test_full_size_init_on_meta_matches_the_jax_count(arch):
    leaves = tree_leaves(R.init_params(torch_arch(arch), 0, device="meta"))
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in leaves) == \
        JR.count_params_analytic(jax_arch(arch))


# relu in place of relu2, or the MLP run as gated (a w3 added), moves the
# logits far past the bar that the true MLP meets
@pytest.mark.parametrize("fault", ["relu", "gated"])
def test_minitron_mlp_faults_miss_the_tolerance(fault, monkeypatch):
    jc, tc, jp, tp = _setup("minitron-8b", "float32")
    toks = np.random.default_rng(2).integers(
        0, jc.vocab_size, (2, 24)).astype(np.int32)
    want = _f32(_jax_forward(jp, jc, {"tokens": jnp.asarray(toks)}))
    got = R.forward_logits(tp, tc, {"tokens": toks}, device="cpu")
    assert np.abs(_f32(got) - want).max() < TOL["float32"]
    if fault == "relu":
        monkeypatch.setitem(TL._ACTS, "relu2", torch.nn.functional.relu)
    else:
        gen = torch.Generator().manual_seed(0)
        for layer in tp["layers"]:
            w1 = layer["ffn"]["w1"]
            layer["ffn"]["w3"] = torch.randn(w1.shape, generator=gen) * \
                w1.shape[0] ** -0.5
    bad = R.forward_logits(tp, tc, {"tokens": toks}, device="cpu")
    assert np.abs(_f32(bad) - want).max() > 10 * TOL["float32"]


def test_init_is_seeded_and_in_cfg_dtype():
    cfg = torch_arch("minicpm-2b").reduced()
    a = R.init_params(cfg, 3, device="cpu")
    b = R.init_params(cfg, 3, device="cpu")
    c = R.init_params(cfg, 4, device="cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["layers"][1]["mix"]["wq"], b["layers"][1]["mix"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])


def test_moe_init_keeps_the_router_in_float32():
    cfg = torch_arch("granite-moe-3b-a800m").reduced()
    assert cfg.dtype == "bfloat16"
    ffn = R.init_params(cfg, 0, device="cpu")["layers"][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w1"].dtype == ffn["w3"].dtype == ffn["w2"].dtype == \
        torch.bfloat16


def test_rglru_init_keeps_lam_and_gate_biases_in_float32():
    cfg = torch_arch("recurrentgemma-9b").reduced()
    assert cfg.dtype == "bfloat16"
    mix = R.init_params(cfg, 0, device="cpu")["layers"][0]["mix"]
    assert mix["lam"].dtype == mix["b_a"].dtype == mix["b_i"].dtype == \
        torch.float32
    assert mix["w_x"].dtype == mix["w_a"].dtype == mix["w_out"].dtype == \
        mix["conv_w"].dtype == torch.bfloat16
    # a = exp(-c softplus(lam)) starts in [0.9, 0.999]
    a = torch.exp(-8.0 * torch.nn.functional.softplus(mix["lam"]))
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def test_init_cache_sizes_windowed_layers_to_the_window():
    jc, tc = _configs("attn-swa-tail", "float32")
    cache = R.init_cache(tc, 2, 40, device="cpu")
    assert [lay["k"].shape[1] for lay in cache["layers"]] == [40, 16, 40]
    assert cache["layers"][0]["k"].dtype == torch.bfloat16
    want = flatten_with_paths(
        jax.tree.map(np.asarray, JR.init_cache(jc, 2, 40)))
    got = flatten_with_paths(cache_to_jax(tc, cache))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


# these two configs once raised NotImplementedError, waiting for their
# slices; now the slices are ported and both initialise and count (their
# parity tests: tests/test_torch_vision.py and tests/test_torch_audio.py)
@pytest.mark.parametrize("arch,slice_name", [
    ("llama-3.2-vision-11b", "cross-attention"), ("hubert-xlarge", "audio"),
])
def test_later_slices_raise_not_implemented(arch, slice_name):
    cfg = torch_arch(arch).reduced()
    params = R.init_params(cfg, 0, device="cpu")
    if slice_name == "cross-attention":
        assert "vis_proj" in params
        assert [("gate" in lay["mix"]) for lay in params["layers"]] == \
            [kind == "cross" for kind in cfg.block_pattern] * 2
    else:
        assert "frontend" in params and "embed" not in params
    assert R.count_params_analytic(torch_arch(arch)) == \
        JR.count_params_analytic(jax_arch(arch))


def test_entry_points_raise_without_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = torch_arch("minicpm-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.init_params(cfg, 0)
    params = R.init_params(cfg, 0, device="cpu")
    toks = np.zeros((1, 4), np.int32)
    for call in (lambda: R.forward_logits(params, cfg, {"tokens": toks}),
                 lambda: R.prefill(params, cfg, {"tokens": toks}),
                 lambda: R.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_params_on_another_device_raise():
    cfg = torch_arch("minicpm-2b").reduced()
    params = R.init_params(cfg, 0, device="meta")
    with pytest.raises(ValueError, match="params is on meta"):
        R.forward_logits(params, cfg, {"tokens": np.zeros((1, 4), np.int32)},
                         device="cpu")
