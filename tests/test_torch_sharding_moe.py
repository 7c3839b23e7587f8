"""The port's MoE layers on a device mesh, on four gloo ranks of the CPU:
reduced granite-moe-3b-a800m and mixtral-8x7b (4 experts, top-2) in
float32, their converted params placed by the ``base`` ruleset (each
expert's d_ff split over "model") and the ``ep`` one (the experts split
over "model") on a 2 x 2 ("data", "model") mesh, and under ``ep`` once on
a 2 x 1 x 2 ("pod", "data", "model") one; then ``forward_logits``, the
prefill step, four greedy serve steps and two steps of
``make_train_step`` with accumulation 2, against the JAX package's
unsharded functions on the same tokens and batches.

Both dispatches run: gather (the expert FFN through ``moe_gmm``'s wrapper
on each rank's experts or d_ff slice) and einsum, whose groups of the
global batch span the data ranks here, so its tokens are gathered over the
data axes for the dispatch; one forward case holds whole groups on each
rank (1024 tokens in groups of 512), whose dispatch runs on the rank.
Capacity is the reference's over the global batch: at capacity factor
0.5 pairs certainly drop, and the dropped pairs counted from the buckets
each rank fills equal the reference's.  Six experts on a 1 x 4 mesh under
``ep`` do not split over "model" and stay whole.  Norm scales are drawn
non-zero before conversion.  All runs go through one spawn of four
workers (``torch_dist_workers.sharded_moe_worker``).
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
from repro.models import moe as JM
from repro.models import registry as JR
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import flatten_with_paths, params_to_jax

from test_torch_train_step import METRIC_RTOL, MOMENT_RTOL, OPT, _close
from test_torch_vision import draw_nonzero

WORKER_TIMEOUT_S = 300     # the spawned group's own limit
WORLD = 4
TOL = 1e-4                 # float32, other op order and partial sums
B, S = 4, 24               # B divides the data axes of every mesh
STEPS = 4                  # greedy serve steps
ACCUM = 2                  # microbatches of 2 rows: 1 a data rank of 2 x 2
TRAIN_STEPS = 2
# The weights after two steps.  AdamW moves an element by lr * m / (sqrt(v)
# + eps) whatever its gradient's size, so an element whose gradient nearly
# cancels carries the rounding of its sums into its move: the unsharded
# port itself misses JAX by up to 1.25e-4 = 0.125 lr on these cases
# (measured: granite-6-experts; 6.0e-5 on mixtral's einsum, 1.4e-5 to
# 5.0e-5 on the rest).  The moments, and so the gradients, hold
# MOMENT_RTOL
MOE_PARAM_ATOL = 0.2 * OPT["lr"]


def _granite(get, **kw):
    return dataclasses.replace(get("granite-moe-3b-a800m").reduced(), **kw)


# name: (config maker, runs (ruleset, mesh, dispatch), serve and train, or
# forward only at B x S of its own)
CASES = {
    "granite-moe-3b-a800m": (_granite, [
        ("base", "2x2", "gather"), ("ep", "2x2", "gather"),
        ("ep", "2x1x2", "gather"), ("base", "2x2", "einsum")], None),
    "mixtral-8x7b": (lambda get: get("mixtral-8x7b").reduced(), [
        ("base", "2x2", "gather"), ("ep", "2x2", "gather"),
        ("ep", "2x2", "einsum")], None),
    # the capacity of the global batch drops pairs
    "granite-cf0.5": (lambda get: _granite(get, capacity_factor=0.5),
                      [("ep", "2x2", "gather"), ("base", "2x2", "gather")],
                      None),
    # 6 experts do not split over a model axis of 4: whole on every rank
    "granite-6-experts": (lambda get: _granite(get, n_experts=6),
                          [("ep", "1x4", "gather")], None),
    # 1024 tokens in groups of 512 (capacity factor 33 keeps g at 512):
    # each data rank's 512 rows hold one whole group
    "granite-local-groups": (lambda get: _granite(get, capacity_factor=33.0),
                             [("ep", "2x2", "einsum")], (4, 256)),
}
RUNS = [(name, rs, kind, disp) for name, (_, runs, _) in CASES.items()
        for rs, kind, disp in runs]
SERVED = [r for r in RUNS if CASES[r[0]][2] is None]
TRAINED_GATHER = [r for r in SERVED if r[3] == "gather"]
MESH_TP = {"2x2": 2, "2x1x2": 2, "1x4": 4}

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1,
                       static_argnames="moe_dispatch")
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames=("cache_len", "moe_dispatch"))
_jax_decode = jax.jit(JR.decode_step, static_argnums=1,
                      static_argnames="moe_dispatch")


def _jax_drops(jc, jp, toks):
    """The pairs the reference's gather dispatch drops over one
    ``forward_logits``, counted by its own slot formula (moe.py:132-133)
    in each layer."""
    drops = []
    real = JM.moe_gather

    def counted(x, p, cfg, kernel_mode="reference"):
        _, idx, _ = JM.router_topk(x, p["router"], cfg.top_k)
        C = JM._capacity(x.shape[0], cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
        onehot = jax.nn.one_hot(idx.reshape(-1), cfg.n_experts,
                                dtype=jnp.int32)
        slot = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, -1) - 1
        jax.debug.callback(lambda n: drops.append(int(n)),
                           jnp.sum(slot >= C))
        return real(x, p, cfg, kernel_mode)
    JM.moe_gather = counted
    try:
        jax.block_until_ready(JR.forward_logits(
            jp, jc, {"tokens": jnp.asarray(toks)}, moe_dispatch="gather"))
    finally:
        JM.moe_gather = real
    return sum(drops)


def _reference(jc, jp, toks, batches, dispatches):
    """The JAX package's unsharded results for each dispatch."""
    out = {}
    for dispatch in dispatches:
        ref = {"forward": np.asarray(_jax_forward(
            jp, jc, {"tokens": toks}, moe_dispatch=dispatch))}
        if batches:
            Sq = toks.shape[1]
            logits, cache = _jax_prefill(jp, jc, {"tokens": toks},
                                         cache_len=Sq + STEPS,
                                         moe_dispatch=dispatch)
            ref.update(prefill=np.asarray(logits), decode=[], tokens=[])
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            for i in range(STEPS):
                ref["tokens"].append(np.asarray(tok))
                logits, cache = _jax_decode(jp, jc, tok, jnp.int32(Sq + i),
                                            cache, moe_dispatch=dispatch)
                ref["decode"].append(np.asarray(logits))
                tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
            ref["tokens"].append(np.asarray(tok))
            step = jax.jit(JS.make_train_step(
                jc, JaxAdamWConfig(**OPT), moe_dispatch=dispatch,
                accum_steps=ACCUM))
            params, opt, metrics = jp, jax_adamw_init(jp), []
            for batch in batches:
                params, opt, m = step(params, opt, {
                    k: jnp.asarray(v) for k, v in batch.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            ref.update(metrics=metrics,
                       m=jax.tree.map(np.asarray, opt.m),
                       v=jax.tree.map(np.asarray, opt.v),
                       params=jax.tree.map(np.asarray, params))
        if dispatch == "gather":
            ref["drops"] = _jax_drops(jc, jp, toks)
        out[dispatch] = ref
    return out


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The workers run while the JAX references are computed."""
    tmp = tmp_path_factory.mktemp("sharded_moe")
    cases, jax_cases = [], []
    for n, (name, (make, runs, fwd_shape)) in enumerate(CASES.items()):
        jc = dataclasses.replace(make(jax_arch), dtype="float32")
        tc = dataclasses.replace(make(torch_arch), dtype="float32")
        jp = jax.jit(lambda key, jc=jc: JR.init_params(key, jc)[0])(
            jax.random.key(n))
        jp = draw_nonzero(jp, n)
        Bq, Sq = fwd_shape or (B, S)
        toks = np.random.default_rng(n).integers(
            0, jc.vocab_size, (Bq, Sq)).astype(np.int32)
        batches = [] if fwd_shape else [
            jax_batch_for(jc, JaxShapeSpec("t", S, B, "train"), seed=n,
                          step=i) for i in range(TRAIN_STEPS)]
        jax_cases.append((name, jc, jp, toks, batches,
                          sorted({d for _, _, d in runs})))
        cases.append({"name": name, "cfg": tc, "params": jp,
                      "tokens": toks, "cache_len": Sq + STEPS,
                      "steps": 0 if fwd_shape else STEPS,
                      "batches": batches, "accum": ACCUM, "runs": runs})
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"cases": cases, "opt": OPT}, f)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_workers.sharded_moe_worker,
                         args=(r, WORLD, str(tmp / "store"), str(tmp)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    refs = {name: _reference(*args) for name, *args in jax_cases}
    cfgs = {c["name"]: c["cfg"] for c in cases}
    for p in procs:
        p.join(WORKER_TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"gloo workers past {WORKER_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return refs, cfgs, [torch.load(tmp / f"rank{r}.pt")
                        for r in range(WORLD)]


@pytest.mark.parametrize("name,ruleset,kind,dispatch", RUNS)
def test_sharded_moe_serving_matches_jax(ran, name, ruleset, kind,
                                         dispatch):
    refs, _, ranks = ran
    want = refs[name][dispatch]
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind, dispatch)]
        keys = ("forward", "prefill") if "prefill" in want else ("forward",)
        for key in keys:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       atol=TOL, rtol=0,
                                       err_msg=f"rank {r} {key}")
        for i, (g, w) in enumerate(zip(got.get("decode", []),
                                       want.get("decode", []))):
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=0,
                                       err_msg=f"rank {r} decode {i}")
        # the same greedy tokens, whole on every rank
        assert [t.numpy().tolist() for t in got.get("tokens", [])] == \
            [t.tolist() for t in want.get("tokens", [])], f"rank {r}"


def _jax_flat(cfg, tree):
    return flatten_with_paths(params_to_jax(cfg, tree))


@pytest.mark.parametrize("name,ruleset,kind,dispatch", SERVED)
def test_sharded_moe_train_steps_match_jax(ran, name, ruleset, kind,
                                           dispatch):
    """Two steps of accumulation 2: the loss with aux and every metric on
    every rank, then every moment (the gradients' running sums, so each
    gradient) and weight gathered whole, at ``test_torch_train_step``'s
    bars; the weights at MOE_PARAM_ATOL."""
    refs, cfgs, ranks = ran
    want, cfg = refs[name][dispatch], cfgs[name]
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind, dispatch)]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(g) == set(w)
            for k in w:
                assert abs(g[k] - w[k]) <= METRIC_RTOL * max(1.0, abs(w[k])),\
                    (r, i + 1, k, g[k], w[k])
    got = ranks[0]["runs"][(name, ruleset, kind, dispatch)]
    _close(_jax_flat(cfg, got["m"]), flatten_with_paths(want["m"]),
           MOMENT_RTOL)
    _close(_jax_flat(cfg, got["v"]), flatten_with_paths(want["v"]),
           MOMENT_RTOL)
    _close(_jax_flat(cfg, got["params"]), flatten_with_paths(want["params"]),
           0.0, MOE_PARAM_ATOL)


def _local_experts(cfg, ruleset, kind):
    """(experts a rank holds, d_ff a rank holds) under ``ruleset``."""
    tp, E, f = MESH_TP[kind], cfg.n_experts, cfg.d_ff
    if ruleset == "ep":
        return (E // tp, f) if E % tp == 0 else (E, f)
    return E, (f // tp if f % tp == 0 else f)


def _first_expert(out, kind, E_loc, E):
    return out["coords"][kind][-1] * E_loc if E_loc < E else 0


@pytest.mark.parametrize("name,ruleset,kind,dispatch",
                         [r for r in RUNS if r[3] == "gather"])
def test_expert_ffn_runs_on_each_ranks_local_pieces(ran, name, ruleset,
                                                    kind, dispatch):
    """The expert FFN's wrapper receives (E / tp, C, d) buckets and (E / tp,
    d, f) weights under ``ep``, (E, C, d) and (E, d, f / tp) under
    ``base``, (E, C, d, f) where neither splits; C is the capacity of the
    global batch, once a layer."""
    _, cfgs, ranks = ran
    cfg = cfgs[name]
    E_loc, f_loc = _local_experts(cfg, ruleset, kind)
    T = B * S
    C = max(8, (int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
                + 7) // 8 * 8)
    for out in ranks:
        calls = out["runs"][(name, ruleset, kind, dispatch)]["forward_calls"]
        assert len(calls) == cfg.n_layers
        for xe, w1, _ in calls:
            assert xe == (E_loc, C, cfg.d_model)
            assert w1 == (E_loc, cfg.d_model, f_loc)
    if name == "granite-6-experts":
        assert E_loc == 6 and f_loc == cfg.d_ff


@pytest.mark.parametrize("name,ruleset,kind,dispatch",
                         [r for r in RUNS if r[3] == "gather"])
def test_dropped_pairs_equal_the_references(ran, name, ruleset, kind,
                                            dispatch):
    """The kept pairs of a forward, summed over the buckets every rank
    filled (each expert once a data rank), leave as many pairs dropped as
    the reference drops; at capacity factor 0.5 that is many."""
    refs, cfgs, ranks = ran
    cfg = cfgs[name]
    E_loc, _ = _local_experts(cfg, ruleset, kind)
    tp = MESH_TP[kind]
    kept = 0
    for out in ranks:
        fills = [sum(c) for _, _, c in out["runs"][
            (name, ruleset, kind, dispatch)]["forward_calls"]]
        kept += sum(fills)
    if E_loc == cfg.n_experts:        # every "model" rank fills them all
        assert kept % tp == 0
        kept //= tp
    drops = cfg.n_layers * B * S * cfg.top_k - kept
    assert drops == refs[name][dispatch]["drops"]
    if cfg.capacity_factor < 1:
        assert drops > 0.1 * cfg.n_layers * B * S * cfg.top_k


@pytest.mark.parametrize("name,ruleset,kind,dispatch", TRAINED_GATHER)
def test_routed_experts_have_moments_on_their_rank(ran, name, ruleset,
                                                   kind, dispatch):
    """After step 1, on the rank that holds it, each local expert's w1,
    w3 and w2 have a non-zero first moment exactly where some pair of the
    step's microbatches was kept in its bucket on some data rank (C30)."""
    _, cfgs, ranks = ran
    cfg = cfgs[name]
    E = cfg.n_experts
    E_loc, _ = _local_experts(cfg, ruleset, kind)
    per_layer = [np.zeros(E, dtype=bool) for _ in range(cfg.n_layers)]
    for out in ranks:
        calls = out["runs"][(name, ruleset, kind, dispatch)]["step1_calls"]
        e0 = _first_expert(out, kind, E_loc, E)
        # forward calls only: layer after layer, microbatch after microbatch
        for i, (_, _, fill) in enumerate(calls):
            per_layer[i % cfg.n_layers][e0:e0 + E_loc] |= \
                np.asarray(fill) > 0
    for out in ranks:
        run = out["runs"][(name, ruleset, kind, dispatch)]
        e0 = _first_expert(out, kind, E_loc, E)
        for layer, has in enumerate(run["step1_moments"]):
            reached = per_layer[layer][e0:e0 + E_loc].tolist()
            assert any(reached)
            for leaf in ("w1", "w3", "w2"):
                assert has[leaf] == reached, (layer, leaf)
