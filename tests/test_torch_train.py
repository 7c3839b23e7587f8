"""The port's training forward against the JAX package's, on the CPU:
``softmax_xent_from_hidden``, and ``forward_train``'s loss, metrics and
every parameter's gradient against ``jax.grad``, with the same (converted)
float32 weights and the same batch.  The JAX side runs its reference path
(``kernel_mode="reference"``), which is what its ``launch/train.py``
trains with; the port's CPU path is its plain versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.models.config import ArchConfig as JaxArchConfig
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import flatten_with_paths, params_from_jax, \
    params_to_jax
from repro_torch.models import config as TC
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

# float32 on both sides, the same math in another op order over 2-4 layers:
# gradients agree to ~1e-6 of each leaf's scale; 1e-4 is the bar.  A leaf
# whose true gradient nearly vanishes (the sLSTM's input-gate bias: its
# exponential gate scales the cell and the normaliser alike, ~4e-9 against
# ~1e-2 elsewhere) holds only the float32 rounding of the whole model's
# gradient, so each leaf's scale is floored at GRAD_FLOOR of the largest
# leaf's
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-3
LOSS_ATOL = 1e-5

# (ATTN, SWA) x 1 scanned period + 1 unrolled ATTN, window 16 < S, untied
_TAIL = dict(name="attn-swa-tail", family="dense", n_layers=3, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
             block_pattern=("attn", "swa"), window=16, act="geglu",
             remat="none")

CASES = ("minicpm-2b", "attn-swa-tail", "granite-moe-3b-a800m",
         "recurrentgemma-9b", "xlstm-1.3b")
B, S = 2, 40


def _configs(case):
    if case == "attn-swa-tail":
        j, t = JaxArchConfig(**_TAIL), TC.ArchConfig(**_TAIL)
    else:
        j, t = jax_arch(case).reduced(), torch_arch(case).reduced()
    return (dataclasses.replace(j, dtype="float32"),
            dataclasses.replace(t, dtype="float32"))


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _jax_loss_and_grads(jc, jp, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JR.forward_train(p, jc, b, kernel_mode="reference"),
        has_aux=True))
    (loss, metrics), grads = fn(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flatten_with_paths(jax.tree.map(np.asarray, grads)))


def port_loss_and_grads(tc, tp, batch, remat=None, moe_dispatch="einsum"):
    """(loss, metrics, {JAX path: gradient}) of the port on the CPU."""
    if remat is not None:
        tc = dataclasses.replace(tc, remat=remat)
    tp = tree_map(lambda p: p.detach().clone().requires_grad_(True), tp)
    loss, metrics = R.forward_train(tp, tc, batch, moe_dispatch=moe_dispatch,
                                    device="cpu")
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), tp)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            flatten_with_paths(params_to_jax(tc, grads)))


def assert_grads_close(got, want, rtol=GRAD_RTOL):
    assert set(got) == set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        err = float(np.abs(got[key] - w).max())
        assert err <= rtol * scale, (key, err, scale)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    jc, tc = _configs(request.param)
    # under jit: op by op, the xLSTM init alone takes ~12 s
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(jax.random.key(0))
    tp = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    batch = _batch(jc.vocab_size)
    return request.param, jc, tc, tp, batch, \
        _jax_loss_and_grads(jc, jp, batch)


def test_forward_train_loss_and_grads_match_jax(case):
    name, jc, tc, tp, batch, (jloss, jmetrics, jgrads) = case
    loss, metrics, grads = port_loss_and_grads(tc, tp, batch)
    assert abs(loss - jloss) <= LOSS_ATOL * max(1.0, abs(jloss)), name
    assert set(metrics) == {"nll", "aux", "acc"}
    for k in metrics:
        assert abs(metrics[k] - jmetrics[k]) <= LOSS_ATOL * max(
            1.0, abs(jmetrics[k])), (name, k, metrics[k], jmetrics[k])
    if tc.is_moe:
        assert metrics["aux"] > 0          # the load-balancing loss counts
        assert loss > metrics["nll"]
    assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("with_mask", [False, True])
def test_softmax_xent_from_hidden_matches_jax(with_mask):
    """Chunks of 16 over S 40: two whole chunks and a remainder of 8."""
    rng = np.random.default_rng(1)
    d, V = 32, 100
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    head = rng.normal(size=(d, V)).astype(np.float32) / np.sqrt(d)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.6).astype(np.float32) if with_mask \
        else None

    def jfn(x, head):
        return JT.softmax_xent_from_hidden(
            x, head, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), chunk=16)
    (jl, jacc), jvjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(head))
    jdx, jdhead = jvjp((jnp.float32(1.0), jnp.float32(0.0)))

    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    tl, tacc = T.softmax_xent_from_hidden(
        tx, th, torch.as_tensor(labels),
        None if mask is None else torch.as_tensor(mask), chunk=16)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    assert abs(float(tacc) - float(jacc)) <= 1e-6
    for g, w in ((tx.grad, jdx), (th.grad, jdhead)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            GRAD_RTOL * float(np.abs(w).max())
