"""The port's audio encoder (hubert-xlarge: frame embeddings through a
frontend projection, non-causal self-attention, masked prediction of
cluster labels, no decode step) against the JAX package's, on the CPU, at
the reduced config: the frame stub and batches, the parameter count,
forward_logits, forward_train's loss and every leaf's gradient, the mask
and the non-causal attention, two AdamW steps, checkpoints both ways, and
the CLIs.  Every norm scale (0 at init) is drawn away from 0 in the JAX
tree before conversion."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import batch_for as jax_batch_for
from repro.data import frontends as jax_frontends
from repro.models import registry as JR
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_from_jax)
from repro_torch.checkpoint import latest_step
from repro_torch.data import batch_for, frontends
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec

from test_torch_train import assert_grads_close, port_loss_and_grads
from test_torch_vision import (LOSS_ATOL, TOL, to_jnp,
                               assert_checkpoints_round_trip, configs,
                               jax_params)
from test_torch_train_step import assert_train_steps_match_jax

ARCH = "hubert-xlarge"
B, S = 2, 24

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)


def _batch(jc, seed=0, step=0, batch=B):
    return jax_batch_for(jc, JaxShapeSpec("t", S, batch, "train"),
                         seed=seed, step=step)


@pytest.fixture(scope="module")
def setup():
    jc, tc = configs(ARCH)
    jp = jax_params(jc)
    return jc, tc, jp, params_from_jax(tc, jp), _batch(jc)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 2)])
def test_frames_and_batches_match_the_reference(seed, step):
    got = frontends.audio_frames(3, 20, 24, seed=seed)
    want = jax_frontends.audio_frames(3, 20, 24, seed=seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    jc, tc = jax_arch(ARCH).reduced(), torch_arch(ARCH).reduced()
    want = jax_batch_for(jc, JaxShapeSpec("t", 32, 4, "train"), seed=seed,
                         step=step)
    got = batch_for(tc, ShapeSpec("t", 32, 4, "train"), seed=seed,
                    step=step)
    assert set(got) == set(want) == {"frames", "labels", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # cluster labels over the vocab, not shifted frames; ~35% masked
    assert got["labels"].max() < tc.vocab_size
    assert 0.2 < got["mask"].mean() < 0.5


@pytest.mark.parametrize("active_only", [False, True])
def test_param_count_matches_jax(active_only):
    want = JR.count_params_analytic(jax_arch(ARCH), active_only=active_only)
    assert R.count_params_analytic(torch_arch(ARCH),
                                   active_only=active_only) == want
    assert 0.94e9 < want < 0.95e9


def test_init_has_a_frontend_and_no_embedding():
    jc, tc = jax_arch(ARCH).reduced(), torch_arch(ARCH).reduced()
    params = R.init_params(tc, 0, device="cpu")
    assert "embed" not in params and "head" in params
    assert params["frontend"].shape == (tc.frontend_dim, tc.d_model)
    jp, _ = JR.init_params(jax.random.key(0), jc)
    assert set(jp) == set(params) - {"layers"} | {"blocks"}


def test_forward_logits_matches_jax(setup):
    jc, tc, jp, tp, batch = setup
    frames = {"frames": batch["frames"]}
    want = _jax_forward(jp, jc, to_jnp(frames))
    got = R.forward_logits(tp, tc, frames, device="cpu")
    assert got.shape == (B, S, tc.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL["float32"], rtol=0)


def test_forward_logits_bf16_close_to_jax():
    jc, tc = configs(ARCH, "bfloat16")
    jp = jax_params(jc, seed=1)
    tp = params_from_jax(tc, jp)
    frames = {"frames": _batch(jc, seed=1)["frames"]}
    want = _jax_forward(jp, jc, to_jnp(frames))
    got = R.forward_logits(tp, tc, frames, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL["bfloat16"], rtol=0)


def test_attention_is_not_causal(setup):
    """A causal run of the same weights misses the reference by far: every
    frame sees the frames after it."""
    jc, tc, jp, tp, batch = setup
    frames = {"frames": batch["frames"]}
    want = np.asarray(_jax_forward(jp, jc, to_jnp(frames)))
    causal = dataclasses.replace(tc, encoder_only=False)
    got = R.forward_logits(tp, causal, frames, device="cpu").numpy()
    assert float(np.abs(got - want).max()) > 100 * TOL["float32"]


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
    assert "['frontend']" in want and "['embed']" not in want
    assert_grads_close(grads, want)


def test_the_loss_reads_the_masked_frames_only(setup):
    jc, tc, jp, tp, batch = setup
    mask = batch["mask"].astype(bool)

    def loss(b):
        return float(R.forward_train(tp, tc, b, device="cpu")[0])
    base = loss(batch)
    # labels outside the mask change nothing ...
    other = np.where(mask, batch["labels"], (batch["labels"] + 7) %
                     tc.vocab_size).astype(np.int32)
    assert loss(dict(batch, labels=other)) == base
    # ... inside it they do, and so does the mask itself
    other = np.where(mask, (batch["labels"] + 7) % tc.vocab_size,
                     batch["labels"]).astype(np.int32)
    assert abs(loss(dict(batch, labels=other)) - base) > 1e-3
    flipped = dict(batch, mask=1.0 - batch["mask"])
    assert abs(loss(flipped) - base) > 1e-3


def test_decode_step_raises_and_init_cache_matches_jax(setup):
    jc, tc, _, tp, _ = setup
    with pytest.raises(ValueError, match="encoder-only"):
        R.decode_step(tp, tc, np.zeros((B, 1), np.int32), 0,
                      R.init_cache(tc, B, 8, device="cpu"), device="cpu")
    cache = R.init_cache(tc, B, 8, device="cpu")
    want = flatten_with_paths(jax.tree.map(np.asarray,
                                           JR.init_cache(jc, B, 8)))
    got = flatten_with_paths(cache_to_jax(tc, cache))
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}


def test_two_adamw_steps_match_jax(setup):
    jc, tc, jp, _, _ = setup
    batches = [_batch(jc, step=i, batch=4) for i in range(2)]
    assert_train_steps_match_jax(jc, tc, jax.tree.map(jnp.asarray, jp),
                                 batches, accum=2)


def test_checkpoints_round_trip_both_ways(setup, tmp_path):
    jc, tc, jp = setup[:3]
    assert_checkpoints_round_trip(jc, tc, jp, tmp_path)


def test_train_cli_trains_the_audio_encoder_and_resumes(tmp_path, capsys):
    args = ["--arch", f"{ARCH}-smoke", "--device", "cpu", "--batch", "2",
            "--seq", "32", "--log-every", "2", "--warmup", "1",
            "--ckpt-dir", str(tmp_path)]
    first = train_cli.main(args + ["--steps", "4"])
    assert [h["step"] for h in first] == [1, 2, 4]
    assert all(np.isfinite(h["loss"]) for h in first)
    assert latest_step(str(tmp_path)) == 4
    second = train_cli.main(args + ["--steps", "6"])
    assert "auto-resumed from step 4" in capsys.readouterr().out
    assert [h["step"] for h in second] == [5, 6]


def test_serve_refuses_an_encoder_only_model():
    with pytest.raises(SystemExit, match="encoder-only: no decode step"):
        serve_cli.main(["--arch", f"{ARCH}-smoke", "--device", "cpu"])
    cfg = torch_arch(ARCH).reduced()
    with pytest.raises(ValueError, match="encoder-only"):
        serve_cli.serve(cfg, [serve_cli.Request(0, np.ones(4, np.int32), 2)],
                        device="cpu")
