"""The port's training on a device mesh, on four gloo ranks of the CPU: the
dense decoders' converted float32 params placed by the ``base`` and
``tp_only`` rulesets on a 2 x 2 ("data", "model") mesh (and once on a
2 x 1 x 2 ("pod", "data", "model") one), with AdamW moments placed like
them, then two steps of ``make_train_step`` with ``mesh=`` (accum 1, and
2 and 4 for minicpm-2b: microbatches of 1 row are whole over "data"),
against the JAX package's unsharded ``make_train_step``
on the same batches: every step's metrics, and the moments and weights
after the last, gathered whole, at ``test_torch_train_step``'s bars.

minicpm-2b ties its head to the embedding (a vocab-sharded table: the loss
runs on vocab-sharded logits); minitron-8b's 2 KV heads split over
"model"; deepseek's seven query heads over one KV head do not divide it
and run on whole heads.  Also: the compressed step on the 2 x 1 x 2 mesh
(each pod's params on its 1 x 2 submesh) against its group form over the
"pod" dim's two ranks and against JAX's unsharded step, and a trained
state through the checkpoint store and ``place_tree``.  All cases run in
one spawn of four workers (``torch_dist_workers.sharded_train_worker``).
"""
import dataclasses
import multiprocessing
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers
from repro.configs import get_arch as jax_arch
from repro.data import batch_for as jax_batch_for
from repro.launch import steps as JS
from repro.models import registry as JR
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import flatten_with_paths, params_to_jax

from test_torch_train_step import (METRIC_RTOL, MOMENT_RTOL, OPT,
                                   PARAM_ATOL, _close)

WORKER_TIMEOUT_S = 360     # the spawned group's own limit
WORLD = 4
B, SEQ, STEPS = 4, 32, 2   # B divides the data axes of both meshes
# tests/test_dp_compress.py's bars on the compressed step against the plain
# one: the loss and every weight
DP_LOSS_ATOL, DP_PARAM_ATOL = 1e-3, 5e-2
# the compressed step's targets (gradient plus error) and scales on the mesh
# against the group form, relative to the leaf's max |target|: the "model"
# ranks' partial sums round otherwise (measured ~1e-6)
QUANT_RTOL = 1e-5


def _gqa(get, name):
    return dataclasses.replace(get(name).reduced(), n_kv_heads=2)


# The weights after two steps.  AdamW moves an element by lr * m / (sqrt(v)
# + eps) whatever its gradient's size, so an element whose gradient nearly
# cancels carries the rounding of its sums into its move: minicpm-2b's
# runs hold PARAM_ATOL (1e-2 lr; 3.1e-6 measured), but the unsharded port
# itself misses it against JAX on the other two configs (1.8e-5 on
# minitron-8b, 2.6e-5 on deepseek, measured), and their sharded runs
# measure 2.2e-5 and 2.0e-5; they are held to 5e-2 lr.  The metrics hold
# METRIC_RTOL (3.2e-7 measured at worst)
WIDE_PARAM_ATOL = 5e-2 * OPT["lr"]

# name: (config maker, runs (ruleset, mesh, accum), weights' bar)
CASES = {
    "minicpm-2b": (lambda get: get("minicpm-2b").reduced(),
                   [("base", "2x2", 1), ("base", "2x2", 2),
                    ("base", "2x2", 4), ("tp_only", "2x2", 1),
                    ("base", "2x1x2", 1)],
                   PARAM_ATOL),
    "minitron-8b": (lambda get: _gqa(get, "minitron-8b"),
                    [("base", "2x2", 1)], WIDE_PARAM_ATOL),
    "deepseek-coder-33b": (lambda get: dataclasses.replace(
        get("deepseek-coder-33b").reduced(), d_model=112, n_heads=7,
        n_kv_heads=1, head_dim=16), [("base", "2x2", 1)], WIDE_PARAM_ATOL),
}
RUNS = [(name, rs, kind, accum) for name, (_, runs, _) in CASES.items()
        for rs, kind, accum in runs]


def _jax_train(jc, jp, batches, accum):
    """The JAX package's unsharded steps: (each step's metrics, the final
    params and AdamW state) as numpy."""
    step = jax.jit(JS.make_train_step(jc, JaxAdamWConfig(**OPT),
                                      accum_steps=accum))
    params, opt, metrics = jp, jax_adamw_init(jp), []
    for batch in batches:
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": jax.tree.map(np.asarray, params),
            "m": jax.tree.map(np.asarray, opt.m),
            "v": jax.tree.map(np.asarray, opt.v), "step": int(opt.step)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    cases, refs = [], {}
    shape = JaxShapeSpec("t", SEQ, B, "train")
    for n, (name, (make, runs, _)) in enumerate(CASES.items()):
        jc = dataclasses.replace(make(jax_arch), dtype="float32")
        tc = dataclasses.replace(make(torch_arch), dtype="float32")
        jp = jax.jit(lambda key, jc=jc: JR.init_params(key, jc)[0])(
            jax.random.key(n))
        batches = [jax_batch_for(jc, shape, seed=n, step=i)
                   for i in range(STEPS)]
        for accum in sorted({a for _, _, a in runs}):
            refs[name, accum] = _jax_train(jc, jp, batches, accum)
        cases.append({"name": name, "cfg": tc,
                      "params": jax.tree.map(np.asarray, jp),
                      "batches": batches, "runs": runs})
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"cases": cases, "opt": OPT,
                     "ckpt_dir": str(tmp / "ckpt")}, f)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_workers.sharded_train_worker,
                         args=(r, WORLD, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(WORKER_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"gloo workers past {WORKER_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    cfgs = {c["name"]: c["cfg"] for c in cases}
    return refs, cfgs, [torch.load(tmp / f"rank{r}.pt")
                        for r in range(WORLD)]


def _assert_metrics(got, want, rtol=METRIC_RTOL, what=""):
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w) == {"loss", "nll", "aux", "acc",
                                    "grad_norm", "lr"}
        for k in w:
            assert abs(g[k] - w[k]) <= rtol * max(1.0, abs(w[k])), \
                (what, i + 1, k, g[k], w[k])


def _jax_flat(cfg, tree):
    return flatten_with_paths(params_to_jax(cfg, tree))


@pytest.mark.parametrize("name,ruleset,kind,accum", RUNS)
def test_sharded_train_steps_match_jax(trained, name, ruleset, kind, accum):
    refs, cfgs, ranks = trained
    want, cfg = refs[name, accum], cfgs[name]
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind, accum)]
        # the same metrics on every rank
        _assert_metrics(got["metrics"], want["metrics"], what=f"rank {r}")
        assert got["step"] == want["step"] == STEPS
    got = ranks[0]["runs"][(name, ruleset, kind, accum)]
    _close(_jax_flat(cfg, got["m"]), flatten_with_paths(want["m"]),
           MOMENT_RTOL)
    _close(_jax_flat(cfg, got["v"]), flatten_with_paths(want["v"]),
           MOMENT_RTOL)
    _close(_jax_flat(cfg, got["params"]), flatten_with_paths(want["params"]),
           0.0, CASES[name][2])


def test_moments_are_placed_like_their_parameters(trained):
    _, _, ranks = trained
    for out in ranks:
        assert all(run["moments_placed_like_params"]
                   for run in out["runs"].values())


def test_compressed_step_on_a_pod_mesh(trained):
    """The compressed step on 2 x 1 x 2 against its group form on the
    "pod" dim's two ranks: step 1 quantises the same targets (gradient
    plus error) within float32 rounding (the "model" ranks' partial sums),
    with the same scales and the same int8 values but where a target lies
    within that rounding of a rounding boundary; both steps' metrics
    within METRIC_RTOL.  Against JAX's unsharded plain step, at
    tests/test_dp_compress.py's bars: step 1's loss, and every weight
    after the last step."""
    refs, cfgs, ranks = trained
    cfg, want = cfgs["minicpm-2b"], refs["minicpm-2b", 1]
    n_leaves = len(flatten_with_paths(want["params"]))
    for r, out in enumerate(ranks):
        mesh, group = out["compressed"]["mesh"], out["compressed"]["group"]
        assert mesh["errors_placed_like_params"]
        _assert_metrics(mesh["metrics"], group["metrics"],
                        what=f"rank {r} mesh against group")
        assert abs(mesh["metrics"][0]["loss"] - want["metrics"][0]["loss"]) \
            < DP_LOSS_ATOL, r
        first = zip(mesh["quantised"][:n_leaves],
                    group["quantised"][:n_leaves])
        for leaf, (m, g) in enumerate(first):
            t = g["target"].numpy()
            tol = QUANT_RTOL * float(np.abs(t).max())
            assert float(np.abs(m["target"].numpy() - t).max()) <= tol, leaf
            assert abs(m["scale"] - g["scale"]) <= QUANT_RTOL * g["scale"]
            dq = np.abs(m["q"].numpy() - g["q"].numpy())
            # a boundary of round() within the targets' rounding
            edge = np.abs(np.abs(t / g["scale"]) % 1.0 - 0.5) <= \
                2 * tol / g["scale"]
            assert dq.max() <= 1 and not (dq[~edge]).any(), leaf
    _close(_jax_flat(cfg, ranks[0]["compressed"]["mesh"]["params"]),
           flatten_with_paths(want["params"]), 0.0, DP_PARAM_ATOL)


def test_trained_state_round_trips_a_checkpoint(trained):
    _, _, ranks = trained
    for out in ranks:
        ckpt = out["checkpoint"]
        assert ckpt["step"] == 2 and ckpt["opt_step"] == STEPS
        assert ckpt["leaves"] and all(ckpt["leaves"])
