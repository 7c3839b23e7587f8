"""The port's train step against the JAX package's, on the CPU: two AdamW
steps of ``make_train_step`` (with and without microbatches) from the same
converted float32 weights on the same batches, the eval step, the three
remat policies, a loose bf16 check of ``forward_train``, and AdamW's
weight decay of every leaf under the reference's rule for its stacked
layout (ROADMAP C33)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import batch_for as jax_batch_for
from repro.launch import steps as JS
from repro.models import registry as JR
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (decay_mask, flatten_with_paths,
                                 opt_state_to_jax, params_from_jax,
                                 params_to_jax)
from repro_torch.launch import steps as S
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_map

from test_torch_train import (GRAD_FLOOR, assert_grads_close,
                              port_loss_and_grads)

ARCH = "minicpm-2b"
B, SEQ = 4, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, schedule="wsd")
# the same update from gradients that agree to ~1e-6 of their scale: the
# moments agree as the gradients do.  The weights move by lr * m / sqrt(v),
# ~lr per element whatever the gradient's size, so an element whose
# gradient is ~1e-3 of its leaf's sees that rounding as ~1e-3 of its move
# (3e-6 = 3e-3 lr measured after two steps); the bar is 1e-2 of lr
MOMENT_RTOL = 1e-4
PARAM_ATOL = 1e-2 * OPT["lr"]
METRIC_RTOL = 1e-5
# bf16 activations round to 8 mantissa bits at other points in the two
# frameworks; 0.08 is the bar tests/test_models.py sets for bf16
BF16_TOL = 0.08


def _configs(dtype="float32"):
    return (dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(torch_arch(ARCH).reduced(), dtype=dtype))


@pytest.fixture(scope="module")
def setup():
    jc, tc = _configs()
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(jax.random.key(0))
    shape = JaxShapeSpec("t", SEQ, B, "train")
    batches = [jax_batch_for(jc, shape, seed=0, step=i) for i in range(2)]
    return jc, tc, jp, batches


def _close(got, want, rtol, atol=0.0):
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        scale = float(np.abs(w).max()) if w.size else 0.0
        err = float(np.abs(np.asarray(got[key], np.float32) - w).max())
        assert err <= rtol * scale + atol, (key, err, scale)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(setup, accum):
    assert_train_steps_match_jax(*setup, accum)


def assert_train_steps_match_jax(jc, tc, jp, batches, accum,
                                 param_atol=PARAM_ATOL):
    """``make_train_step`` of the port and of JAX from the same float32
    weights ``jp`` (a JAX tree) over ``batches``: metrics, moments and
    weights (within ``param_atol``) after the last step."""
    jstep = jax.jit(JS.make_train_step(jc, JaxAdamWConfig(**OPT),
                                       accum_steps=accum))
    tstep = S.make_train_step(tc, AdamWConfig(**OPT), accum_steps=accum,
                              device="cpu")
    jparams, jopt = jp, jax_adamw_init(jp)
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    topt = adamw_init(tparams)
    for batch in batches:
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jparams, jopt, jm = jstep(jparams, jopt, jbatch)
        tparams, topt, tm = tstep(tparams, topt, batch)
        assert set(tm) == set(jm) == {"loss", "nll", "aux", "acc",
                                      "grad_norm", "lr"}
        for k in jm:
            w = float(jm[k])
            assert abs(float(tm[k]) - w) <= METRIC_RTOL * max(1.0, abs(w)), \
                (k, float(tm[k]), w)
    assert int(topt.step) == len(batches)
    step, m, v = opt_state_to_jax(tc, topt)
    assert int(step) == int(jopt.step)
    _close(flatten_with_paths(m),
           flatten_with_paths(jax.tree.map(np.asarray, jopt.m)), MOMENT_RTOL)
    _close(flatten_with_paths(v),
           flatten_with_paths(jax.tree.map(np.asarray, jopt.v)), MOMENT_RTOL)
    _close(flatten_with_paths(params_to_jax(tc, tparams)),
           flatten_with_paths(jax.tree.map(np.asarray, jparams)), 0.0,
           param_atol)


def test_eval_step_matches_jax(setup):
    jc, tc, jp, batches = setup
    want = jax.jit(JS.make_eval_step(jc))(
        jp, {k: jnp.asarray(v) for k, v in batches[0].items()})
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    got = S.make_eval_step(tc, device="cpu")(tparams, batches[0])
    assert set(got) == set(want)
    for k in want:
        assert not got[k].requires_grad
        assert abs(float(got[k]) - float(want[k])) <= METRIC_RTOL * max(
            1.0, abs(float(want[k])))


def test_remat_policies_give_the_same_gradients(setup):
    jc, tc, jp, batches = setup
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    runs = {remat: port_loss_and_grads(tc, tparams, batches[0], remat=remat)
            for remat in ("none", "full", "dots")}
    base_loss, _, base = runs["none"]
    for remat in ("full", "dots"):
        loss, _, grads = runs[remat]
        assert loss == base_loss, remat
        # the same operations recomputed: equal up to summation order
        assert_grads_close(grads, base, rtol=1e-6)


def test_forward_train_bf16_close_to_jax():
    jc, tc = _configs("bfloat16")
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(jax.random.key(0))
    batch = jax_batch_for(jc, JaxShapeSpec("t", SEQ, 2, "train"), seed=3)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JR.forward_train(p, jc, b), has_aux=True))
    (jloss, _), jgrads = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    assert all(t.dtype == torch.float32 for t in
               jax.tree.leaves(tree_map(lambda t: t, tparams)))
    loss, _, grads = port_loss_and_grads(tc, tparams, batch)
    assert abs(loss - float(jloss)) < BF16_TOL
    want = flatten_with_paths(jax.tree.map(
        lambda g: np.asarray(g, np.float32), jgrads))
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        assert float(np.abs(grads[key] - w).max()) <= BF16_TOL * scale, key


# C33: the reference decays a leaf of rank >= 2 in its stacked layout, so
# every vector of a scanned layer (norm scales, biases, Griffin's lam) is
# decayed and a tail layer's are not.  Vectors start 0.5 away from zero and
# the gradients are zero or small, so decay moves each decayed vector by
# lr * wd * 0.5 = 5e-4 a step, 50x PARAM_ATOL: a leaf decayed on one side
# only misses by 2e-3 after four steps.
DECAY_OPT = dict(lr=1e-2, weight_decay=0.1, warmup_steps=1, total_steps=10,
                 schedule="const")
DECAY_STEPS = 4


def _decay_configs(arch):
    jc, tc = jax_arch(arch).reduced(), torch_arch(arch).reduced()
    if arch == "recurrentgemma-9b":
        # two scanned periods and one tail layer
        n = 2 * tc.pattern_period + 1
        jc, tc = (dataclasses.replace(c, n_layers=n) for c in (jc, tc))
    return jc, tc


@pytest.mark.parametrize("grads", ["zero", "small"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "recurrentgemma-9b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_adamw_decay_matches_jax(arch, grads):
    jc, tc = _decay_configs(arch)
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(jax.random.key(0))
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    for t in flatten_with_paths(tparams).values():
        if t.dim() <= 1:
            t.add_(0.5)
    start = flatten_with_paths(params_to_jax(tc, tparams))
    mask = flatten_with_paths(decay_mask(tc, tparams))
    last = tc.n_layers - 1
    assert mask["['layers'][0]['ffn']['ln']"]            # scanned: stacked
    assert not mask["['final_ln']"]
    if arch == "recurrentgemma-9b":
        assert tc.n_layers > tc.n_scan_blocks * tc.pattern_period
        assert not mask[f"['layers'][{last}]['ffn']['ln']"]  # tail
        for name in ("lam", "b_a", "b_i"):
            assert mask[f"['layers'][0]['mix']['{name}']"]
            assert not mask[f"['layers'][{last}]['mix']['{name}']"]
    if arch == "llama-3.2-vision-11b":
        # a CROSS layer's 0-dim gate is (n_scan_blocks,) stacked: rank 1
        cross = tc.block_pattern.index("cross")
        assert not mask[f"['layers'][{cross}]['mix']['gate']"]
        assert mask["['vis_proj']"]
    if arch == "hubert-xlarge":
        assert mask["['frontend']"] and "['embed']" not in mask
    rng = np.random.default_rng(7)
    # a copy: the numpy arrays of params_to_jax share the torch tensors'
    # memory (an unstacked leaf such as hubert's frontend), jnp.asarray
    # can alias them on the CPU, and adamw_update writes tparams in place,
    # racing the asynchronous JAX update that reads them
    jparams = jax.tree.map(jnp.array, params_to_jax(tc, tparams))
    jopt, topt = jax_adamw_init(jparams), adamw_init(tparams)
    jcfg, tcfg = JaxAdamWConfig(**DECAY_OPT), AdamWConfig(**DECAY_OPT)
    decay = decay_mask(tc, tparams)
    for _ in range(DECAY_STEPS):
        g = tree_map(lambda t: torch.zeros_like(t) if grads == "zero" else
                     torch.from_numpy(np.asarray(1e-3 * rng.standard_normal(
                         t.shape, dtype=np.float32))), tparams)
        jparams, jopt, _ = jax_adamw_update(
            jax.tree.map(jnp.asarray, params_to_jax(tc, g)), jopt, jparams,
            jcfg)
        tparams, topt, _ = adamw_update(g, topt, tparams, tcfg, decay=decay)
    want = flatten_with_paths(jax.tree.map(np.asarray, jparams))
    got = flatten_with_paths(params_to_jax(tc, tparams))
    assert set(got) == set(want)
    for key, w in want.items():
        err = float(np.abs(got[key] - w).max())
        assert err <= PARAM_ATOL, (key, err)
    # the decay the reference applies moved a scanned layer's norm scale
    ln = "['blocks']['l0']['ffn']['ln']"
    assert float(np.abs(want[ln] - start[ln]).max()) > 10 * PARAM_ATOL


def test_train_step_passes_the_reference_decay_mask(setup, monkeypatch):
    jc, tc, jp, batches = setup
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    seen = []

    def spy(grads, state, params, cfg, schedule=None, decay=None):
        seen.append(decay)
        return adamw_update(grads, state, params, cfg, schedule, decay)
    monkeypatch.setattr(S, "adamw_update", spy)
    step = S.make_train_step(tc, AdamWConfig(**OPT), device="cpu")
    topt = adamw_init(tparams)
    for batch in batches:
        tparams, topt, _ = step(tparams, topt, batch)
    assert len(seen) == 2
    want = flatten_with_paths(decay_mask(tc, tparams))
    assert want["['layers'][0]['mix']['ln']"] and not want["['final_ln']"]
    for decay in seen:
        assert flatten_with_paths(decay) == want
