"""The port's vision model (llama-3.2-vision-11b: gated cross-attention
from the tokens to projected image patches) against the JAX package's, on
the CPU, at the reduced config with GQA: the patch stub and batches, the
parameter count, forward_logits, forward_train's loss and every leaf's
gradient, prefill (logits, self-attention k/v and the CROSS layers'
ck/cv) and decode, two AdamW steps, checkpoints both ways, and the serve
CLI's refusal.

Every ``gate`` (0 at init) is drawn in [0.5, 0.9] and every norm scale (0
at init) away from 0 in the JAX tree before conversion, so that the cross
path and each norm count."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_arch as jax_arch
from repro.data import batch_for as jax_batch_for
from repro.data import frontends as jax_frontends
from repro.models import registry as JR
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 opt_state_from_jax, opt_state_to_jax,
                                 params_from_jax, params_to_jax)
from repro_torch.data import batch_for, frontends
from repro_torch.launch import serve as serve_cli
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw as TA

from test_torch_train import assert_grads_close, port_loss_and_grads
from test_torch_train_step import OPT, assert_train_steps_match_jax

ARCH = "llama-3.2-vision-11b"
# float32: the same math in another op order over 10 layers, ~1e-6 of
# O(1) logits; bf16 rounds activations at other points in the two
# frameworks, 0.08 is the bar tests/test_models.py sets for bf16
TOL = {"float32": 1e-4, "bfloat16": 0.08}
B, S = 2, 24
LOSS_ATOL = 1e-5
# two AdamW steps: an element whose gradient g is near AdamW's eps (1e-8)
# moves by lr g / (|g| + eps), which turns a rounding d of g into lr d eps
# / (|g| + eps)^2, up to lr d / (4 eps).  At 10 layers the two frameworks'
# float32 gradients differ by ~5e-9 on such elements (~2e-8 of the
# leaf's largest), which puts a few weights up to ~4e-2 lr apart (3.6e-5
# at lr 1e-3 measured: one element in 16384 in each of six leaves);
# 1e-1 lr is the bar.  A missed or doubled update moves a weight by ~lr.
STEP_PARAM_ATOL = 1e-1 * OPT["lr"]

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames="cache_len")
_jax_decode = jax.jit(JR.decode_step, static_argnums=1)


def configs(arch, dtype="float32", **changes):
    """(JAX, port) reduced configs of ``arch`` in ``dtype``."""
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype,
                                     **changes)
                 for get in (jax_arch, torch_arch))


def draw_nonzero(tree, seed=0):
    """A JAX params tree (numpy leaves) with every norm scale drawn at
    0.1 N(0, 1) and every CROSS ``gate`` in [0.5, 0.9]; other leaves
    kept."""
    rng = np.random.default_rng(seed)

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, name) for v in t]
        if name == "gate":
            return rng.uniform(0.5, 0.9, t.shape).astype(np.float32)
        if name.endswith("ln"):
            return (0.1 * rng.standard_normal(t.shape)).astype(np.float32)
        return t
    return walk(jax.tree.map(np.asarray, tree), "")


def jax_params(jc, seed=0):
    """Drawn by the JAX init under jit, norms and gates made non-zero."""
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(
        jax.random.key(seed))
    return draw_nonzero(jp, seed)


def to_jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


def assert_checkpoints_round_trip(jc, tc, jp, tmp_path):
    """Params and an AdamW state with non-zero moments, written by JAX and
    restored by the port, and written by the port and restored by JAX,
    bit for bit."""
    rng = np.random.default_rng(3)
    jst = JA.AdamWState(
        step=jnp.int32(5),
        m=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=np.shape(a)),
                                             jnp.float32), jp),
        v=jax.tree.map(lambda a: jnp.asarray(rng.random(np.shape(a)),
                                             jnp.float32), jp))
    jparams = jax.tree.map(jnp.asarray, jp)
    JaxCheckpointManager(str(tmp_path / "j")).save(
        5, {"params": jparams, "opt": jst})
    tmpl = R.init_params(tc, 1, device="cpu", param_dtype=torch.float32)
    step, trees, _ = CheckpointManager(str(tmp_path / "j"), tc) \
        .restore_latest({"params": tmpl, "opt": TA.adamw_init(tmpl)})
    assert step == 5
    want = flatten_with_paths(jax.tree.map(np.asarray, jparams))
    got = flatten_with_paths(params_to_jax(tc, trees["params"]))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, m, v = opt_state_to_jax(tc, trees["opt"])
    for got_t, want_t in ((m, jst.m), (v, jst.v)):
        want_f = flatten_with_paths(jax.tree.map(np.asarray, want_t))
        for k, w in flatten_with_paths(got_t).items():
            np.testing.assert_array_equal(w, want_f[k], err_msg=k)
    # and back
    topt = opt_state_from_jax(tc, jax.tree.map(np.asarray, tuple(jst)))
    CheckpointManager(str(tmp_path / "t"), tc).save(
        6, {"params": trees["params"], "opt": topt})
    step, back, _ = JaxCheckpointManager(str(tmp_path / "t")).restore_latest(
        {"params": jparams, "opt": JA.adamw_init(jparams)})
    assert step == 6
    for got_t, want_t in ((back["params"], jparams), (back["opt"], jst)):
        for g, w in zip(jax.tree.leaves(got_t), jax.tree.leaves(want_t)):
            assert np.shape(g) == np.shape(w)
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def setup():
    # GQA (4 query heads over 2 KV heads) in self- and cross-attention
    jc, tc = configs(ARCH, n_kv_heads=2)
    jp = jax_params(jc)
    tp = params_from_jax(tc, jp)
    batch = jax_batch_for(jc, JaxShapeSpec("t", S, B, "train"), seed=0)
    return jc, tc, jp, tp, batch


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 2)])
def test_patches_and_batches_match_the_reference(seed, step):
    got = frontends.vision_patches(3, 20, 24, seed=seed)
    want = jax_frontends.vision_patches(3, 20, 24, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    jc, tc = jax_arch(ARCH).reduced(), torch_arch(ARCH).reduced()
    want = jax_batch_for(jc, JaxShapeSpec("t", 32, 4, "train"), seed=seed,
                         step=step)
    got = batch_for(tc, ShapeSpec("t", 32, 4, "train"), seed=seed,
                    step=step)
    assert set(got) == set(want) == {"tokens", "labels", "patches"}
    assert got["patches"].shape == (4, tc.n_patches, tc.frontend_dim)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("active_only", [False, True])
def test_param_count_matches_jax(active_only):
    want = JR.count_params_analytic(jax_arch(ARCH), active_only=active_only)
    assert R.count_params_analytic(torch_arch(ARCH),
                                   active_only=active_only) == want
    assert 9.7e9 < want < 9.9e9


def test_init_has_the_reference_leaves_and_a_zero_gate():
    tc = torch_arch(ARCH).reduced()
    params = R.init_params(tc, 0, device="cpu")
    jc = jax_arch(ARCH).reduced()
    jp, _ = JR.init_params(jax.random.key(0), jc)
    want = flatten_with_paths(jax.tree.map(np.asarray, jp))
    got = flatten_with_paths(params_to_jax(tc, params))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    cross = tc.block_pattern.index("cross")
    gate = params["layers"][cross]["mix"]["gate"]
    assert gate.shape == () and gate.dtype == torch.float32
    assert float(gate) == 0.0
    assert params["vis_proj"].shape == (tc.frontend_dim, tc.d_model)


def test_forward_logits_matches_jax(setup):
    jc, tc, jp, tp, batch = setup
    want = _jax_forward(jp, jc, to_jnp(batch))
    got = R.forward_logits(tp, tc, batch, device="cpu")
    assert got.shape == (B, S, tc.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["float32"],
                               rtol=0)


def test_forward_logits_bf16_close_to_jax():
    jc, tc = configs(ARCH, "bfloat16", n_kv_heads=2)
    jp = jax_params(jc, seed=1)
    tp = params_from_jax(tc, jp)
    batch = jax_batch_for(jc, JaxShapeSpec("t", S, B, "train"), seed=1)
    want = _jax_forward(jp, jc, to_jnp(batch))
    got = R.forward_logits(tp, tc, batch, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["bfloat16"],
                               rtol=0)


def test_patches_move_the_logits(setup):
    """The control for every check here: other patches change the
    logits far past the bar, so the cross path is held."""
    jc, tc, jp, tp, batch = setup
    base = R.forward_logits(tp, tc, batch, device="cpu")
    other = dict(batch, patches=frontends.vision_patches(
        B, tc.n_patches, tc.frontend_dim, seed=9))
    moved = R.forward_logits(tp, tc, other, device="cpu")
    assert float((moved - base).abs().max()) > 100 * TOL["float32"]


def test_forward_train_loss_and_grads_match_jax(setup):
    jc, tc, jp, tp, batch = setup
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JR.forward_train(p, jc, b), has_aux=True))
    (jloss, jm), jgrads = fn(jax.tree.map(jnp.asarray, jp), to_jnp(batch))
    loss, metrics, grads = port_loss_and_grads(tc, tp, batch)
    assert abs(loss - float(jloss)) <= LOSS_ATOL * max(1.0, abs(float(jloss)))
    for k in ("nll", "acc"):
        assert abs(metrics[k] - float(jm[k])) <= LOSS_ATOL * max(
            1.0, abs(float(jm[k]))), k
    want = flatten_with_paths(jax.tree.map(np.asarray, jgrads))
    # every leaf, the gates and the patch projection among them
    assert {"['vis_proj']", "['blocks']['l4']['mix']['gate']"} <= set(want)
    assert float(np.abs(want["['blocks']['l4']['mix']['gate']"]).min()) > 0
    assert_grads_close(grads, want)


def test_prefill_and_decode_match_jax(setup):
    jc, tc, jp, tp, batch = setup
    toks = batch["tokens"]
    pre = {"tokens": toks[:, :S - 4], "patches": batch["patches"]}
    jl, jcache = _jax_prefill(jp, jc, to_jnp(pre), cache_len=S)
    tl, tcache = R.prefill(tp, tc, pre, cache_len=S, device="cpu")
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL["float32"],
                               rtol=0)
    jflat = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    tflat = flatten_with_paths(cache_to_jax(tc, tcache))
    assert set(jflat) == set(tflat)
    assert "['blocks']['l4']['ck']" in jflat
    for key, arr in jflat.items():
        assert tflat[key].shape == arr.shape, key
        np.testing.assert_allclose(tflat[key], _f32(arr),
                                   atol=TOL["float32"], rtol=0, err_msg=key)
    cross = tcache["layers"][tc.block_pattern.index("cross")]
    assert cross["ck"].dtype == cross["cv"].dtype == torch.float32
    for t in range(S - 4, S - 1):
        jl, jcache = _jax_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), jcache)
        tl, tcache = R.decode_step(tp, tc, toks[:, t:t + 1], t, tcache,
                                   device="cpu")
        np.testing.assert_allclose(_f32(tl), _f32(jl), atol=TOL["float32"],
                                   rtol=0, err_msg=f"decode at {t}")
    # decode reads ck/cv and leaves them as they are
    assert torch.equal(tcache["layers"][4]["ck"], cross["ck"])


def test_init_cache_matches_jax_and_keeps_ck_cv_bf16(setup):
    jc, tc = setup[:2]
    cache = R.init_cache(tc, 2, 40, device="cpu")
    want = flatten_with_paths(jax.tree.map(np.asarray,
                                           JR.init_cache(jc, 2, 40)))
    got = flatten_with_paths(cache_to_jax(tc, cache))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    cross = cache["layers"][tc.block_pattern.index("cross")]
    # bf16 in a float32 model too (C6), as the reference's
    assert cross["ck"].dtype == cross["cv"].dtype == torch.bfloat16
    assert cross["ck"].shape == (2, tc.n_patches, tc.n_kv_heads,
                                 tc.head_dim)


def test_two_adamw_steps_match_jax(setup):
    jc, tc, jp, _, _ = setup
    shape = JaxShapeSpec("t", S, 4, "train")
    batches = [jax_batch_for(jc, shape, seed=0, step=i) for i in range(2)]
    assert_train_steps_match_jax(jc, tc, jax.tree.map(jnp.asarray, jp),
                                 batches, accum=2,
                                 param_atol=STEP_PARAM_ATOL)


def test_checkpoints_round_trip_both_ways_with_a_0_dim_gate(tmp_path):
    # (CROSS, ATTN) x 1 scanned period + a CROSS tail layer: a stacked
    # gate of shape (1,) and an unstacked 0-dim one
    jc, tc = configs(ARCH, block_pattern=("cross", "attn"), n_layers=3)
    jp = jax_params(jc)
    assert jp["tail"][0]["mix"]["gate"].shape == ()
    assert jp["blocks"]["l0"]["mix"]["gate"].shape == (1,)
    tp = params_from_jax(tc, jp)
    assert tp["layers"][2]["mix"]["gate"].shape == ()
    assert_checkpoints_round_trip(jc, tc, jp, tmp_path)


def test_serve_refuses_a_vision_model_with_the_reason():
    cfg = torch_arch(ARCH).reduced()
    with pytest.raises(SystemExit, match="vision model.*patches"):
        serve_cli.main(["--arch", f"{ARCH}-smoke", "--device", "cpu",
                        "--requests", "1", "--gen", "2"])
    req = serve_cli.Request(0, np.ones(4, np.int32), 2)
    with pytest.raises(ValueError, match="make_prefill_step"):
        serve_cli.serve(cfg, [req], device="cpu")
    assert req.generated == []
