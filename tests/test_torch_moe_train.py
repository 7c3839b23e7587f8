"""Training through the MoE gather dispatch, on the CPU.

``reference_expert_ffn_bwd`` (the backward of the expert-FFN kernel's
autograd function, by formula) against autograd of the plain version and
``jax.vjp`` of the JAX package's plain version; ``ExpertFFNFunction``'s
wiring with a stand-in for the kernel's launch; and the gather dispatch's
``forward_train`` loss and every leaf's gradient against ``jax.grad`` of the
reference (``kernel_mode="reference"``), beside the einsum dispatch, at a
capacity where no pair drops and one where pairs drop."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels.moe_gmm import ref as jax_gmm_ref
from repro.models import registry as JR
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import flatten_with_paths, params_from_jax
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from test_torch_train import (LOSS_ATOL, _batch, assert_grads_close,
                              port_loss_and_grads)

# float32 on both sides, the same products in another order over d <= 64
# and f <= 96 terms: ~1e-7 of each gradient's scale; 1e-5 is the bar
BWD_RTOL = 1e-5

# (act, gated): SiLU, GELU (tanh, C3) and squared ReLU, gated and not
ACTS = [("swiglu", True), ("geglu", True), ("gelu", False), ("relu2", False)]
E, C, D, F = 4, 24, 64, 96


def _inputs(gated, seed=0):
    rng = np.random.default_rng(seed)
    xe = rng.standard_normal((E, C, D)).astype(np.float32)
    p = {"w1": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "w2": rng.standard_normal((E, F, D)) / np.sqrt(F)}
    if gated:
        p["w3"] = rng.standard_normal((E, D, F)) / np.sqrt(D)
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    return xe, {k: w.astype(np.float32) for k, w in p.items()}, dy


def _fills(kind):
    """Bucket fills: every row live (None), or an empty, a partial and a
    full bucket beside a bucket no token reached."""
    if kind == "all":
        return None
    return torch.tensor([0, 7, C, 1], dtype=torch.int32)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _autograd(xe, p, dy, act, counts):
    """Autograd of the plain version: (dxe, dw1, dw3 or None, dw2)."""
    leaves = {k: torch.from_numpy(w).requires_grad_() for k, w in p.items()}
    x = torch.from_numpy(xe).requires_grad_()
    y = gmm_ref.reference_expert_ffn(x, leaves, act, counts)
    y.backward(torch.from_numpy(dy))
    return (x.grad, leaves["w1"].grad,
            leaves["w3"].grad if "w3" in leaves else None, leaves["w2"].grad)


@pytest.mark.parametrize("fill", ["all", "partial"])
@pytest.mark.parametrize("act,gated", ACTS)
def test_plain_expert_ffn_bwd_matches_autograd(act, gated, fill):
    """The backward by formula against autograd of the plain forward.  Pad
    rows hold NaN on the formula's side (the contract lets them hold
    anything) and 0 on autograd's, whose products would carry a NaN into
    every weight's gradient: the formula's gradients are finite, 0 on the
    pads, and the pads add nothing to the weights' gradients."""
    xe, p, dy = _inputs(gated)
    counts = _fills(fill)
    want = _autograd(xe, p, dy, act, counts)
    x = torch.from_numpy(xe)
    if counts is not None:
        pads = ~gmm_ref.live_rows(x, counts)
        x = x.masked_fill(pads[..., None], float("nan"))
    got = gmm_ref.reference_expert_ffn_bwd(
        x, {k: torch.from_numpy(w) for k, w in p.items()},
        torch.from_numpy(dy), act, counts)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.isfinite(g).all()
            assert _rel(g, w) <= BWD_RTOL
    if counts is not None:
        assert not got[0][pads].any()


@pytest.mark.parametrize("act,gated", ACTS)
def test_plain_expert_ffn_bwd_matches_jax_vjp(act, gated):
    """The same formula against ``jax.vjp`` of the reference's plain
    expert FFN, every row live (it takes no fills)."""
    xe, p, dy = _inputs(gated, seed=1)
    jp = {k: jnp.asarray(w) for k, w in p.items()}
    _, vjp = jax.vjp(lambda x, q: jax_gmm_ref.reference_expert_ffn(x, q, act),
                     jnp.asarray(xe), jp)
    jdx, jdp = vjp(jnp.asarray(dy))
    got = gmm_ref.reference_expert_ffn_bwd(
        torch.from_numpy(xe), {k: torch.from_numpy(w) for k, w in p.items()},
        torch.from_numpy(dy), act)
    want = (jdx, jdp["w1"], jdp.get("w3"), jdp["w2"])
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _rel(g, torch.from_numpy(np.array(w))) <= BWD_RTOL


def test_expert_ffn_function_wiring(monkeypatch):
    """ExpertFFNFunction on CPU tensors, its launch filled from the plain
    version: the forward launches once; the backward computes through the
    plain backward (on CPU tensors the backward kernel is not launched)
    and hands each input its gradient (through the weights' cast to xe's
    dtype, autograd carries them to float32 masters); no gradient for
    counts."""
    def launch(xe, w1, w3, w2, h, y, counts, *, act, route):
        y.copy_(gmm_ref.reference_expert_ffn(
            xe, {"w1": w1, "w3": w3, "w2": w2}, act, counts))
        gmm_kernel.LAUNCHES += 1
    plain_calls = []

    def plain_bwd(*args):
        plain_calls.append(args)
        return real_plain_bwd(*args)

    def launch_bwd(*args, **kwargs):
        raise AssertionError("the backward kernel launched on CPU tensors")
    real_plain_bwd = gmm_ref.reference_expert_ffn_bwd
    monkeypatch.setattr(gmm_kernel, "launch", launch)
    monkeypatch.setattr(gmm_kernel, "launch_bwd", launch_bwd)
    monkeypatch.setattr(gmm_ref, "reference_expert_ffn_bwd", plain_bwd)
    monkeypatch.setattr(gmm_ops, "check_kernel_args", lambda *a: None)
    xe, p, dy = _inputs(True, seed=2)
    counts = _fills("partial")
    want = _autograd(xe, p, dy, "swiglu", counts)
    masters = {k: torch.from_numpy(w).double().requires_grad_()
               for k, w in p.items()}
    x = torch.from_numpy(xe).requires_grad_()
    gmm_kernel.reset_launches()
    y = gmm_ops.ExpertFFNFunction.apply(
        x, *(masters[k].float() for k in ("w1", "w3", "w2")), counts,
        "swiglu")
    assert (gmm_kernel.LAUNCHES, gmm_kernel.BWD_LAUNCHES) == (1, 0)
    assert y.grad_fn is not None and not plain_calls
    y.backward(torch.from_numpy(dy))
    assert (gmm_kernel.LAUNCHES, gmm_kernel.BWD_LAUNCHES) == (1, 0)
    assert len(plain_calls) == 1
    got = (x.grad, masters["w1"].grad, masters["w3"].grad,
           masters["w2"].grad)
    for g, w in zip(got, want):
        assert _rel(g.float(), w) <= BWD_RTOL
    assert masters["w1"].grad.dtype == torch.float64
    gmm_kernel.reset_launches()
    assert gmm_kernel.LAUNCHES == 0 and gmm_kernel.BWD_LAUNCHES == 0


def _moe_configs(cf):
    j = jax_arch("granite-moe-3b-a800m").reduced()
    t = torch_arch("granite-moe-3b-a800m").reduced()
    return (dataclasses.replace(j, dtype="float32", capacity_factor=cf),
            dataclasses.replace(t, dtype="float32", capacity_factor=cf))


@pytest.fixture(scope="module")
def moe_init():
    jc, tc = _moe_configs(1.25)
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(jax.random.key(0))
    jp = jax.tree.map(np.asarray, jp)
    return jp, params_from_jax(tc, jp)


# cf 1.25: the config's own; 0.25: the buckets overflow and pairs drop
@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
def test_moe_forward_train_matches_jax_in_both_dispatches(moe_init, dispatch,
                                                          cf):
    """forward_train's loss, metrics and every leaf's gradient, the
    router's and the aux loss's path included, against ``jax.grad`` of the
    reference with ``kernel_mode="reference"`` and the same dispatch."""
    jc, tc = _moe_configs(cf)
    jp, tp = moe_init
    batch = _batch(jc.vocab_size)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JR.forward_train(p, jc, b, kernel_mode="reference",
                                      moe_dispatch=dispatch), has_aux=True))
    (jloss, jm), jgrads = fn(jax.tree.map(jnp.asarray, jp),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flatten_with_paths(jax.tree.map(np.asarray, jgrads))
    loss, metrics, grads = port_loss_and_grads(tc, tp, batch,
                                               moe_dispatch=dispatch)
    assert abs(loss - float(jloss)) <= LOSS_ATOL * max(1.0, abs(float(jloss)))
    for k in ("nll", "aux", "acc"):
        assert abs(metrics[k] - float(jm[k])) <= LOSS_ATOL * max(
            1.0, abs(float(jm[k]))), k
    assert metrics["aux"] > 0 and loss > metrics["nll"]
    assert_grads_close(grads, jgrads)
    for key, g in grads.items():
        if key.rsplit("'", 2)[-2] in ("w1", "w2", "w3", "router"):
            assert np.abs(g).max() > 0, key
