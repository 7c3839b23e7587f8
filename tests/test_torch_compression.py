"""The port's int8 error-feedback compression (``optim.compression``) and
its data-parallel step (``launch.steps.make_train_step_dp_compressed``),
on the CPU: the pure functions against the JAX package's on the same
seeded numpy inputs; the all-reduce on a two-rank gloo group, in spawned
processes with a time limit of their own, against its formula written out
here; the compressed step on a one-rank gloo group against
``make_train_step`` (the JAX package's own compressed step is xfail on its
pinned jax, so the port's is held against the port's plain step, which is
held against JAX), and on two ranks, each with half the batch, against the
plain step on the whole batch within a bound derived from the scales."""
import dataclasses
import multiprocessing
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_workers
from repro.optim import compression as JC
from repro_torch.configs import get_arch
from repro_torch.data import batch_for
from repro_torch.launch import steps
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import compression as TC
from repro_torch.tree import tree_leaves, tree_map

WORKER_TIMEOUT_S = 180     # each spawned group's own limit
F32_EPS = float(np.finfo(np.float32).eps)


def _inputs(seed, shape=(64, 33), scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-4), (2, 300.0),
                                        (3, 0.0)])
def test_quantize_matches_jax(seed, scale):
    x = _inputs(seed, scale=scale)
    q, s = TC.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    # the scale within one unit in the last place
    assert abs(float(s) - float(js)) <= np.spacing(np.float32(js))
    np.testing.assert_allclose(TC.dequantize_int8(q, s).numpy(),
                               np.asarray(JC.dequantize_int8(jq, js)),
                               rtol=2 * F32_EPS, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ef_compress_update_matches_jax(seed):
    g, e = _inputs(seed), _inputs(seed + 10, scale=1e-2)
    q, s, new = TC.ef_compress_update(torch.from_numpy(g),
                                      torch.from_numpy(e))
    jq, js, jnew = JC.ef_compress_update(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= np.spacing(np.float32(js))
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=0,
                               atol=1e-7)
    # bf16 gradients are read in float32
    qb, sb, _ = TC.ef_compress_update(torch.from_numpy(g).bfloat16(),
                                      torch.from_numpy(e))
    jqb, jsb, _ = JC.ef_compress_update(jnp.asarray(g, jnp.bfloat16),
                                        jnp.asarray(e))
    np.testing.assert_array_equal(qb.numpy(), np.asarray(jqb))


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(_inputs(0, shape=(1000,)))
    q, scale = TC.quantize_int8(x)
    err = torch.max(torch.abs(TC.dequantize_int8(q, scale) - x))
    assert float(err) <= float(scale) / 2 + 1e-7


def test_error_feedback_tracks_the_gradient_stream():
    """As tests/test_optim.py checks the JAX package's: the summed
    dequantised stream stays within the last residual of the summed
    gradients; and the port's stream is JAX's."""
    rng = np.random.default_rng(1)
    g_sum = np.zeros(64, np.float32)
    d_sum = np.zeros(64, np.float32)
    err, jerr = torch.zeros(64), jnp.zeros(64, jnp.float32)
    for _ in range(50):
        g = rng.standard_normal(64).astype(np.float32)
        q, scale, err = TC.ef_compress_update(torch.from_numpy(g), err)
        jq, jscale, jerr = JC.ef_compress_update(jnp.asarray(g), jerr)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        g_sum += g
        d_sum += TC.dequantize_int8(q, scale).numpy()
    resid = np.abs(g_sum - d_sum).max()
    assert resid <= float(torch.max(torch.abs(err))) + 1e-5
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                               atol=1e-6)


def _spawn(target, world, tmp_path):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world,
                                              str(tmp_path / "store"),
                                              str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORKER_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"gloo workers past {WORKER_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


def test_all_reduce_on_two_gloo_ranks(tmp_path):
    ranks = _spawn(torch_dist_workers.all_reduce_worker, 2, tmp_path)
    n = len(ranks)
    for leaf in range(2):
        # the formula: each rank quantises grad + error with its own
        # scale; the int8 payloads are summed, then dequantised with the
        # mean scale and divided by the ranks
        targets, qs, scales = [], [], []
        for r in ranks:
            t = (tree_leaves(r["grads"])[leaf].numpy() +
                 tree_leaves(r["errors"])[leaf].numpy())
            s = np.float32(max(np.abs(t).max(), np.float32(1e-12))) / \
                np.float32(127.0)
            q = np.clip(np.round(t / s), -127, 127)
            targets.append(t)
            qs.append(q)
            scales.append(s)
        mean = (sum(qs).astype(np.float32) * (np.float32(sum(scales)) /
                                              np.float32(n)) / np.float32(n))
        for r, t, q, s in zip(ranks, targets, qs, scales):
            np.testing.assert_allclose(tree_leaves(r["mean"])[leaf].numpy(),
                                       mean, rtol=2 * F32_EPS, atol=0)
            np.testing.assert_allclose(
                tree_leaves(r["new"])[leaf].numpy(),
                t - q.astype(np.float32) * s, rtol=0,
                atol=2 * F32_EPS * np.abs(t).max())
    # the results keep the gradients' tree
    assert set(ranks[0]["mean"]) == {"a", "b"}


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_compressed_step_on_one_rank_matches_plain_step(one_rank_group):
    """From one init on one batch: step 1's loss the same bits, every
    parameter within the reference test's bar (5e-2) and within 2 lr of the
    plain step's, the errors the step's new residuals; the loss falls over
    a second step."""
    cfg = dataclasses.replace(get_arch("minicpm-2b").reduced(),
                              remat="full")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    params = R.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    plain = tree_map(lambda p: p.detach().clone(), params)
    opt, opt_plain = adamw_init(params), adamw_init(plain)
    errors = steps.init_ef_errors(params)
    batch = batch_for(cfg, ShapeSpec("t", 32, 4, "train"), seed=0)
    plain_step = steps.make_train_step(cfg, ocfg, accum_steps=2,
                                       device="cpu")
    comp_step = steps.make_train_step_dp_compressed(cfg, ocfg,
                                                    accum_steps=2,
                                                    device="cpu")
    for i in range(2):
        old = [e.clone() for e in tree_leaves(errors)]
        plain, opt_plain, mp = plain_step(plain, opt_plain, batch)
        params, opt, errors, mc = comp_step(params, opt, errors, batch)
        if i == 0:
            first = mc["loss"]
            assert float(mc["loss"]) == float(mp["loss"])
            lr = float(mc["lr"])
            with torch.no_grad():
                d = max(float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(params), tree_leaves(plain)))
            assert 0 < d <= min(5e-2, 2 * lr * (1 + 1e-3))
        assert all(torch.isfinite(e).all() for e in tree_leaves(errors))
        assert any(float(e.abs().max()) > 0 for e in tree_leaves(errors))
        assert [e.shape for e in tree_leaves(errors)] == \
            [p.shape for p in tree_leaves(params)]
        # the errors are the step's new residuals, updated in place
        assert not all(torch.equal(a, b) for a, b in
                       zip(tree_leaves(errors), old))
    assert float(mc["loss"]) < float(first)


def test_error_identity_in_the_step(one_rank_group):
    """With one rank the gradient used is q * scale, and it plus the new
    error is the gradient plus the old error within float32 rounding."""
    seen = {}
    reduce = TC.all_reduce_int8_with_ef

    def recording(grads, errors, group=None):
        seen["target"] = [g.float() + e for g, e in zip(
            tree_leaves(grads), tree_leaves(errors))]
        used, new = reduce(grads, errors, group)
        seen["sum"] = [u + n for u, n in zip(tree_leaves(used),
                                              tree_leaves(new))]
        return used, new
    cfg = get_arch("minicpm-2b").reduced()
    params = R.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    opt, errors = adamw_init(params), steps.init_ef_errors(params)
    batch = batch_for(cfg, ShapeSpec("t", 32, 2, "train"), seed=1)
    step = steps.make_train_step_dp_compressed(cfg, device="cpu")
    TC.all_reduce_int8_with_ef = recording
    try:
        for _ in range(3):
            params, opt, errors, _ = step(params, opt, errors, batch)
            for t, s in zip(seen["target"], seen["sum"]):
                assert float((t - s).abs().max()) <= \
                    4 * F32_EPS * max(float(t.abs().max()), 1e-30)
    finally:
        TC.all_reduce_int8_with_ef = reduce


def test_compressed_step_on_two_ranks_matches_plain_step(tmp_path):
    """Each of two ranks takes half the batch; the gradient they use is
    the plain step's (the mean over both halves) within
    (s0 + s1) / 4 + 127 |s1 - s0| / 2 per leaf, where s_r is rank r's
    scale: each rank's q_r s_r is within s_r / 2 of its gradient, and
    dequantising the summed q with the mean scale moves it by
    (q0 - q1)(s1 - s0) / 4 at most.  Both ranks end with the same
    parameters, within 2 lr of the plain step's, and the loss is the
    plain step's."""
    ranks = _spawn(torch_dist_workers.compressed_step_worker, 2, tmp_path)
    cfg = get_arch("minicpm-2b").reduced()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    params = R.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    opt = adamw_init(params)
    batch = batch_for(cfg, ShapeSpec("t", 32, 4, "train"), seed=0)
    # the plain step's gradient: both halves as two microbatches
    grads, loss, _ = steps._gradients(params, cfg, batch, "einsum", 2,
                                      "cpu")
    plain, _, mp = steps.make_train_step(cfg, ocfg, accum_steps=2,
                                         device="cpu")(params, opt, batch)
    np.testing.assert_allclose(ranks[0]["metrics"]["loss"], float(loss),
                               rtol=1e-6)
    assert ranks[0]["metrics"]["loss"] == ranks[1]["metrics"]["loss"]
    for leaf, g in enumerate(grads):
        g0, g1 = (r["seen"]["grads"][leaf] for r in ranks)
        torch.testing.assert_close((g0 + g1) / 2, g, rtol=1e-5, atol=1e-7)
        s0, s1 = (float(r["seen"]["grads"][leaf].abs().max()) / 127
                  for r in ranks)
        bound = (s0 + s1) / 4 + 127 * abs(s1 - s0) / 2 + \
            4 * F32_EPS * float(g.abs().max())
        used = ranks[0]["seen"]["used"][leaf]
        assert torch.equal(used, ranks[1]["seen"]["used"][leaf])
        assert float((used - g).abs().max()) <= bound
    lr = ranks[0]["metrics"]["lr"]
    for a, b, p in zip(ranks[0]["params"], ranks[1]["params"],
                       tree_leaves(plain)):
        assert torch.equal(a, b)
        assert float((a - p.detach()).abs().max()) <= 2 * lr * (1 + 1e-3)


def test_init_ef_errors_is_a_float32_zero_tree():
    cfg = get_arch("granite-moe-3b-a800m").reduced()
    params = R.init_params(cfg, 0, device="cpu")
    errors = steps.init_ef_errors(params)
    leaves = tree_leaves(errors)
    assert len(leaves) == len(tree_leaves(params))
    assert all(e.dtype == torch.float32 and not e.any() for e in leaves)


def test_compressed_step_needs_a_batch_the_ranks_split(one_rank_group,
                                                       monkeypatch):
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    cfg = get_arch("minicpm-2b").reduced()
    params = R.init_params(cfg, 0, device="cpu", param_dtype=torch.float32)
    step = steps.make_train_step_dp_compressed(cfg, device="cpu")
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        step(params, adamw_init(params), steps.init_ef_errors(params),
             batch_for(cfg, ShapeSpec("t", 16, 4, "train"), seed=0))


def test_worker_module_imports_no_jax():
    import ast
    tree = ast.parse(open(os.path.join(os.path.dirname(__file__),
                                       "torch_dist_workers.py")).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & {"jax", "repro"}
