"""Conversion of JAX params to the port's layout and back."""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.models import registry as JR
from repro.models.config import ArchConfig as JaxArchConfig
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_from_jax, params_to_jax)
from repro_torch.models import registry as R
from repro_torch.models.config import ArchConfig

_TAIL = dict(name="attn-swa-tail", family="dense", n_layers=5, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
             block_pattern=("attn", "swa"), window=16, remat="none")


def _pair(case):
    if case == "attn-swa-tail":            # 2 scanned periods + 1 tail layer
        return JaxArchConfig(**_TAIL), ArchConfig(**_TAIL)
    j, t = jax_arch(case).reduced(), torch_arch(case).reduced()
    if case == "h2o-danube-3-4b":          # untied head, GQA
        j = dataclasses.replace(j, n_kv_heads=2)
        t = dataclasses.replace(t, n_kv_heads=2)
    return j, t


def _jax_tree(jc):
    params, _ = JR.init_params(jax.random.key(0), jc)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("case", ["minicpm-2b", "h2o-danube-3-4b",
                                  "attn-swa-tail", "granite-moe-3b-a800m",
                                  "mixtral-8x7b", "recurrentgemma-9b",
                                  "xlstm-1.3b"])
def test_round_trip_is_exact_and_covers_every_key(case):
    jc, tc = _pair(case)
    tree = _jax_tree(jc)
    params = params_from_jax(tc, tree)
    assert len(params["layers"]) == tc.n_layers
    back = flatten_with_paths(params_to_jax(tc, params))
    want = flatten_with_paths(tree)
    assert set(back) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr, err_msg=key)


def test_layer_order_unstacks_scan_blocks_then_tail():
    jc, tc = _pair("attn-swa-tail")
    tree = _jax_tree(jc)
    params = params_from_jax(tc, tree)
    wq = [lay["mix"]["wq"].numpy() for lay in params["layers"]]
    blocks = tree["blocks"]
    np.testing.assert_array_equal(wq[0], blocks["l0"]["mix"]["wq"][0])
    np.testing.assert_array_equal(wq[1], blocks["l1"]["mix"]["wq"][0])
    np.testing.assert_array_equal(wq[2], blocks["l0"]["mix"]["wq"][1])
    np.testing.assert_array_equal(wq[3], blocks["l1"]["mix"]["wq"][1])
    np.testing.assert_array_equal(wq[4], tree["tail"][0]["mix"]["wq"])


def test_missing_leaf_raises_naming_its_path():
    jc, tc = _pair("minicpm-2b")
    tree = _jax_tree(jc)
    del tree["blocks"]["l0"]["mix"]["wq"]
    with pytest.raises(KeyError, match=r"\['blocks'\]\['l0'\]\['mix'\]\['wq'\]"):
        params_from_jax(tc, tree)


def test_unused_leaf_raises_naming_its_path():
    jc, tc = _pair("minicpm-2b")
    tree = _jax_tree(jc)
    tree["head"] = np.zeros((64, 256), np.float32)   # minicpm ties its head
    with pytest.raises(KeyError, match=r"\['head'\]"):
        params_from_jax(tc, tree)


def test_shape_mismatch_raises_naming_its_path():
    jc, tc = _pair("minicpm-2b")
    tree = _jax_tree(jc)
    tree["final_ln"] = np.zeros((65,), np.float32)
    with pytest.raises(ValueError, match=r"\['final_ln'\]"):
        params_from_jax(tc, tree)
    tree = _jax_tree(jc)
    tree["blocks"]["l0"]["ffn"]["w1"] = tree["blocks"]["l0"]["ffn"]["w1"][:1]
    with pytest.raises(ValueError, match="scanned blocks"):
        params_from_jax(tc, tree)


def test_bf16_leaves_convert():
    jc, tc = _pair("minicpm-2b")
    tree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), _jax_tree(jc))
    params = params_from_jax(tc, tree)
    assert params["embed"].dtype.is_floating_point
    np.testing.assert_array_equal(
        params["embed"].float().numpy(), tree["embed"].astype(np.float32))


def test_cache_to_jax_matches_the_jax_cache_layout():
    jc, tc = _pair("attn-swa-tail")
    want = flatten_with_paths(jax.tree.map(np.asarray,
                                           JR.init_cache(jc, 2, 40)))
    got = flatten_with_paths(cache_to_jax(tc, R.init_cache(tc, 2, 40,
                                                           device="cpu")))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("case", ["granite-moe-3b-a800m", "mixtral-8x7b"])
def test_moe_leaves_carry_router_and_experts_per_layer(case):
    jc, tc = _pair(case)
    tree = _jax_tree(jc)
    params = params_from_jax(tc, tree)
    E, d, f = tc.n_experts, tc.d_model, tc.d_ff
    for n, layer in enumerate(params["layers"]):
        ffn = layer["ffn"]
        assert set(ffn) == {"ln", "router", "w1", "w3", "w2"}
        assert tuple(ffn["router"].shape) == (d, E)
        assert tuple(ffn["w1"].shape) == tuple(ffn["w3"].shape) == (E, d, f)
        assert tuple(ffn["w2"].shape) == (E, f, d)
        np.testing.assert_array_equal(
            ffn["w2"].numpy(), tree["blocks"]["l0"]["ffn"]["w2"][n])
