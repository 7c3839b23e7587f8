"""The port's serving on a device mesh, on four gloo ranks of the CPU: the
dense decoders' converted params placed by the ``base`` and ``tp_only``
rulesets on a 2 x 2 ("data", "model") mesh (and once on a 2 x 1 x 2
("pod", "data", "model") one), then ``forward_logits``, the prefill step
and four greedy serve steps, in float32, against the JAX package's
unsharded ``forward_logits``, ``prefill`` and ``decode_step`` on the same
tokens; and a checkpoint restored onto the mesh through ``place_tree``.

The caches of 1024 slots are sequence-sharded over "model" (512 a rank):
minicpm-2b's prompt of 520 fills both halves and decodes into the second;
minitron-8b's of 300 leaves the second half empty (its rank's partial
weighs 0) and decodes into the first; h2o-danube-3-4b's window of 64 makes
a cache shorter than 1024, sharded along its feature dim; deepseek's seven
query heads over one KV head do not divide the "model" axis and run on
whole heads.  All cases run in one spawn of four workers
(``torch_dist_workers.sharded_serve_worker``)."""
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
from repro.models import registry as JR
from repro_torch.checkpoint import store
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import params_from_jax

WORKER_TIMEOUT_S = 240     # the spawned group's own limit
WORLD = 4
TOL = 1e-4                 # float32, other op order and partial sums
B = 4                      # divides the data axes of both meshes
STEPS = 4
CACHE_LEN = 1024


def _gqa(get, name):
    return dataclasses.replace(get(name).reduced(), n_kv_heads=2)


# name: (config maker, prompt length, runs (ruleset, mesh))
CASES = {
    "minicpm-2b": (lambda get: get("minicpm-2b").reduced(), 520,
                   [("base", "2x2"), ("tp_only", "2x2"),
                    ("base", "2x1x2")]),
    "minitron-8b": (lambda get: _gqa(get, "minitron-8b"), 300,
                    [("base", "2x2"), ("tp_only", "2x2")]),
    "h2o-danube-3-4b": (lambda get: _gqa(get, "h2o-danube-3-4b"), 80,
                        [("base", "2x2"), ("tp_only", "2x2")]),
    "deepseek-coder-33b": (lambda get: dataclasses.replace(
        get("deepseek-coder-33b").reduced(), d_model=112, n_heads=7,
        n_kv_heads=1, head_dim=16), 520, [("base", "2x2"),
                                           ("tp_only", "2x2")]),
}
RUNS = [(name, rs, kind) for name, (_, _, runs) in CASES.items()
        for rs, kind in runs]

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames="cache_len")
_jax_decode = jax.jit(JR.decode_step, static_argnums=1)


def _reference(jc, jp, toks):
    """The JAX package's unsharded logits and greedy tokens."""
    S = toks.shape[1]
    ref = {"forward": np.asarray(_jax_forward(jp, jc, {"tokens": toks}))}
    logits, cache = _jax_prefill(jp, jc, {"tokens": toks},
                                 cache_len=CACHE_LEN)
    ref["prefill"] = np.asarray(logits)
    ref["decode"], ref["tokens"] = [], []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for i in range(STEPS):
        ref["tokens"].append(np.asarray(tok))
        logits, cache = _jax_decode(jp, jc, tok, jnp.int32(S + i), cache)
        ref["decode"].append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ref["tokens"].append(np.asarray(tok))
    return ref


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    cases, refs = [], {}
    for n, (name, (make, S, runs)) in enumerate(CASES.items()):
        jc = dataclasses.replace(make(jax_arch), dtype="float32")
        tc = dataclasses.replace(make(torch_arch), dtype="float32")
        jp, _ = JR.init_params(jax.random.key(n), jc)
        jp = jax.tree.map(np.asarray, jp)
        toks = np.random.default_rng(n).integers(
            0, jc.vocab_size, (B, S)).astype(np.int32)
        refs[name] = _reference(jc, jp, toks)
        cases.append({"name": name, "cfg": tc, "params": jp,
                      "tokens": toks, "cache_len": CACHE_LEN,
                      "steps": STEPS, "runs": runs})
    # the first case's params as a checkpoint, written whole on one host
    first = cases[0]
    store.save_checkpoint(str(tmp / "ckpt"), 7, store.flatten_trees(
        first["cfg"], {"params": params_from_jax(first["cfg"],
                                                 first["params"])}))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"cases": cases, "ckpt_dir": str(tmp / "ckpt")}, f)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_workers.sharded_serve_worker,
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
    return refs, [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("name,ruleset,kind", RUNS)
def test_sharded_serving_matches_jax(served, name, ruleset, kind):
    refs, ranks = served
    want = refs[name]
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind)]
        for key in ("forward", "prefill"):
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       atol=TOL, rtol=0,
                                       err_msg=f"rank {r} {key}")
        for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0,
                                       err_msg=f"rank {r} decode {i}")
        # the same greedy tokens, whole on every rank
        assert [t.numpy().tolist() for t in got["tokens"]] == \
            [t.tolist() for t in want["tokens"]], f"rank {r}"


# the tensor dim each mesh dim shards a layer's k cache along
@pytest.mark.parametrize("name,placements", [
    # 1024 slots: sequence-sharded over "model", batch over "data"
    ("minicpm-2b", [0, 1]),
    ("minitron-8b", [0, 1]),
    ("deepseek-coder-33b", [0, 1]),
    # the window's 64 slots: the feature dim over "model"
    ("h2o-danube-3-4b", [0, 3])])
def test_cache_placed_by_cache_specs(served, name, placements):
    _, ranks = served
    for out in ranks:
        for rs in ("base", "tp_only"):
            assert out["runs"][(name, rs, "2x2")]["cache_placements"] == \
                placements
    if name == "minicpm-2b":        # batch over ("pod", "data")
        assert ranks[0]["runs"][(name, "base", "2x1x2")][
            "cache_placements"] == [0, 0, 1]


def test_meshes_name_their_axes(served):
    _, ranks = served
    for out in ranks:
        assert out["mesh_dims"] == {"2x2": ("data", "model"),
                                    "2x1x2": ("pod", "data", "model")}


def test_place_tree_restores_a_checkpoint_onto_the_mesh(served):
    _, ranks = served

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]
    for out in ranks:
        assert out["checkpoint"]["step"] == 7
        got = leaves(out["checkpoint"]["leaves"])
        assert got and all(got)
