"""The port's vision and audio models on a device mesh, on four gloo ranks
of the CPU: reduced llama-3.2-vision-11b (one period: four ATTN layers
and a CROSS layer, GQA 4/2) and reduced hubert-xlarge (the audio encoder:
frames, a plain GELU MLP, not causal), their converted params placed by
the ``base`` and ``tp_only`` rulesets on a 2 x 2 ("data", "model") mesh;
then ``forward_logits`` (the encode, for hubert), the prefill step (its
logits and whole cache: k/v and the patch memory's ck/cv), three greedy
serve steps and two steps of ``make_train_step`` (hubert's with its frame
mask), against the JAX package's unsharded functions on the same inputs
and batches.

Also: the vision model with 1024 patches, whose ck/cv ``cache_specs``
shards along the sequence over "model", so that each decode step attends
each rank's 512 patches and combines them (``combine_partials``); the
vision model on a 1 x 4 mesh, whose 2 KV heads do not divide "model", so
that its self- and cross-attention run on all heads on every rank; hubert
with a vocabulary of 255, which "model" does not divide, so that its loss
runs on whole logits; the vision model in bf16 (at ``BF16_TOL``); and
the vision model's compressed step on a 2 x 1 x 2 ("pod", "data",
"model") mesh against its group form and JAX's plain step.  The flash kernel's wrapper
and the CROSS layers' plain ``attention`` are recorded as the blocks call
them: each receives a rank's (B / dp, S, H / tp, Dh) as plain tensors.

Every gate and norm scale is drawn non-zero before conversion
(``draw_nonzero``).  All runs go through one spawn of four workers
(``torch_dist_workers.sharded_modal_worker``).
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
from repro_torch.convert import (cache_to_jax, flatten_with_paths,
                                 params_to_jax)

from test_torch_train_step import BF16_TOL, METRIC_RTOL, MOMENT_RTOL, OPT, \
    _close
from test_torch_vision import draw_nonzero

WORKER_TIMEOUT_S = 300     # the spawned group's own limit
WORLD = 4
TOL = 1e-4                 # float32, other op order and partial sums
B, S = 4, 24               # B divides the data axes of every mesh
STEPS = 3                  # greedy serve steps
TRAIN_STEPS = 2
# The weights after two steps.  AdamW moves an element by lr * m / (sqrt(v)
# + eps) whatever its gradient's size, so an element whose gradient nearly
# cancels carries the rounding of its sums into its move:
# tests/test_torch_vision.py holds the unsharded port to 1e-1 lr against
# JAX for that reason (its measured 3.6e-5 at lr 1e-3), and so does this
# file; a missed or doubled update moves a weight by ~lr.  The moments, and
# so the gradients, hold MOMENT_RTOL.
STEP_PARAM_ATOL = 1e-1 * OPT["lr"]
# tests/test_dp_compress.py's bars on the compressed step against the plain
# one: the loss and every weight
DP_LOSS_ATOL, DP_PARAM_ATOL = 1e-3, 5e-2


def _vision(get, **kw):
    # one period of (ATTN x 4, CROSS); GQA 4/2 in self- and cross-attention
    return dataclasses.replace(get("llama-3.2-vision-11b").reduced(),
                               n_layers=5, n_kv_heads=2, **kw)


def _hubert(get, **kw):
    return dataclasses.replace(get("hubert-xlarge").reduced(), **kw)


# name: (config maker, dtype, runs (ruleset, mesh), greedy serve steps or
# None for no prefill (the audio encoder has no decode))
CASES = {
    "llama-3.2-vision-11b": (_vision, "float32",
                             [("base", "2x2"), ("tp_only", "2x2")], STEPS),
    # ck / cv of 1024 patches: sequence-sharded over "model"
    "vision-1024-patches": (lambda get: _vision(get, n_patches=1024),
                            "float32", [("base", "2x2")], STEPS),
    # 2 KV heads do not split over a model axis of 4: whole on every rank
    "vision-whole-heads": (_vision, "float32", [("base", "1x4")], STEPS),
    # bf16 logits of the two frameworks may order two tokens otherwise:
    # forward, prefill and the train metrics only
    "vision-bf16": (_vision, "bfloat16", [("base", "2x2")], 0),
    "hubert-xlarge": (_hubert, "float32",
                      [("base", "2x2"), ("tp_only", "2x2")], None),
    # 255 cluster labels do not split over "model": the loss on whole
    # logits
    "hubert-255-labels": (lambda get: _hubert(get, vocab_size=255),
                          "float32", [("base", "2x2")], None),
}
# the compressed step averages the pods' losses, each a mean over its own
# rows' weight: that is the plain step's loss where every position counts
# (the vision model's text), not under hubert's random frame mask
COMPRESSED = "llama-3.2-vision-11b"
RUNS = [(name, rs, kind) for name, (_, _, runs, _) in CASES.items()
        for rs, kind in runs]
MESH = {"2x2": (2, 2), "1x4": (1, 4)}     # (dp, tp)
INPUTS = ("tokens", "patches", "frames")

_jax_forward = jax.jit(JR.forward_logits, static_argnums=1)
_jax_prefill = jax.jit(JR.prefill, static_argnums=1,
                       static_argnames="cache_len")
_jax_decode = jax.jit(JR.decode_step, static_argnums=1)


def _jax_train(jc, jp, batches):
    step = jax.jit(JS.make_train_step(jc, JaxAdamWConfig(**OPT)))
    params, opt, metrics = jp, jax_adamw_init(jp), []
    for batch in batches:
        params, opt, m = step(params, opt,
                              {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "m": jax.tree.map(np.asarray, opt.m),
            "v": jax.tree.map(np.asarray, opt.v),
            "params": jax.tree.map(np.asarray, params)}


def _reference(jc, jp, inputs, batches, steps):
    """The JAX package's unsharded results."""
    f32 = np.float32
    ins = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref = {"forward": np.asarray(_jax_forward(jp, jc, ins), f32)}
    if steps is not None:
        logits, cache = _jax_prefill(jp, jc, ins, cache_len=S + STEPS)
        ref.update(prefill=np.asarray(logits, f32), decode=[], tokens=[],
                   cache=flatten_with_paths(jax.tree.map(np.asarray, cache)))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        for i in range(steps):
            ref["tokens"].append(np.asarray(tok))
            logits, cache = _jax_decode(jp, jc, tok, jnp.int32(S + i), cache)
            ref["decode"].append(np.asarray(logits, f32))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        ref["tokens"].append(np.asarray(tok))
    ref.update(_jax_train(jc, jp, batches))
    return ref


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The workers run while the JAX references are computed."""
    tmp = tmp_path_factory.mktemp("sharded_modal")
    cases, jax_cases = [], []
    for n, (name, (make, dtype, runs, steps)) in enumerate(CASES.items()):
        jc = dataclasses.replace(make(jax_arch), dtype=dtype)
        tc = dataclasses.replace(make(torch_arch), dtype=dtype)
        jp = jax.jit(lambda key, jc=jc: JR.init_params(key, jc)[0])(
            jax.random.key(n))
        jp = draw_nonzero(jp, n)
        batches = [jax_batch_for(jc, JaxShapeSpec("t", S, B, "train"),
                                 seed=n, step=i) for i in range(TRAIN_STEPS)]
        inputs = {k: v for k, v in batches[0].items() if k in INPUTS}
        jax_cases.append((name, jc, jp, inputs, batches, steps))
        cases.append({"name": name, "cfg": tc, "params": jp,
                      "inputs": inputs, "cache_len": S + STEPS,
                      "serve": steps is not None, "steps": steps or 0,
                      "batches": batches, "runs": runs})
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"cases": cases, "opt": OPT, "compressed": COMPRESSED},
                    f)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_workers.sharded_modal_worker,
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


def _tol(cfg):
    return TOL if cfg.dtype == "float32" else BF16_TOL


@pytest.mark.parametrize("name,ruleset,kind", RUNS)
def test_sharded_modal_serving_matches_jax(ran, name, ruleset, kind):
    """forward_logits (the encode) and the prefill's last logits on every
    rank within TOL of JAX's; in float32 every leaf of the prefill's
    cache (k/v, and the CROSS layer's ck/cv), each greedy serve step's
    logits, and the same greedy tokens."""
    refs, cfgs, ranks = ran
    want, cfg = refs[name], cfgs[name]
    tol = _tol(cfg)
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind)]
        keys = ("forward", "prefill") if "prefill" in want else ("forward",)
        assert ("prefill" in got) == ("prefill" in want)
        for key in keys:
            np.testing.assert_allclose(got[key].float().numpy(), want[key],
                                       atol=tol, rtol=0,
                                       err_msg=f"rank {r} {key}")
        if "prefill" not in want or cfg.dtype != "float32":
            continue
        cache = flatten_with_paths(cache_to_jax(cfg, got["cache"]))
        assert set(cache) == set(want["cache"])
        for key, w in want["cache"].items():
            np.testing.assert_allclose(np.asarray(cache[key], np.float32),
                                       np.asarray(w, np.float32), atol=tol,
                                       rtol=0, err_msg=f"rank {r} {key}")
        assert len(got["decode"]) == CASES[name][3] == len(want["decode"])
        for i, (g, w) in enumerate(zip(got["decode"], want["decode"])):
            np.testing.assert_allclose(g.float().numpy(), w, atol=tol,
                                       rtol=0, err_msg=f"rank {r} step {i}")
        assert [t.numpy().tolist() for t in got["tokens"]] == \
            [t.tolist() for t in want["tokens"]], f"rank {r}"


def _jax_flat(cfg, tree):
    return flatten_with_paths(params_to_jax(cfg, tree))


@pytest.mark.parametrize("name,ruleset,kind", RUNS)
def test_sharded_modal_train_steps_match_jax(ran, name, ruleset, kind):
    """Two steps: every metric on every rank, then every moment (so each
    gradient, the CROSS gate's among them) and weight gathered whole, at
    ``test_torch_train_step``'s bars and STEP_PARAM_ATOL; bf16: the
    metrics at BF16_TOL."""
    refs, cfgs, ranks = ran
    want, cfg = refs[name], cfgs[name]
    rtol = METRIC_RTOL if cfg.dtype == "float32" else BF16_TOL
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind)]
        assert len(got["metrics"]) == TRAIN_STEPS
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(g) == set(w)
            for k in w:
                assert abs(g[k] - w[k]) <= rtol * max(1.0, abs(w[k])), \
                    (r, i + 1, k, g[k], w[k])
    if cfg.dtype != "float32":
        return
    got = ranks[0]["runs"][(name, ruleset, kind)]
    _close(_jax_flat(cfg, got["m"]), flatten_with_paths(want["m"]),
           MOMENT_RTOL)
    _close(_jax_flat(cfg, got["v"]), flatten_with_paths(want["v"]),
           MOMENT_RTOL)
    _close(_jax_flat(cfg, got["params"]), flatten_with_paths(want["params"]),
           0.0, STEP_PARAM_ATOL)


def _layer_kinds(cfg):
    return [cfg.block_pattern[n % cfg.pattern_period]
            for n in range(cfg.n_layers)]


@pytest.mark.parametrize("name,ruleset,kind", RUNS)
def test_modal_attention_runs_on_each_ranks_local_heads(ran, name, ruleset,
                                                        kind):
    """In one forward the flash wrapper receives each self-attention
    layer's plain (B / dp, S, H / tp, Dh), causal for vision and not for
    the encoder, and each CROSS layer's plain ``attention`` a (B / dp, S,
    H / tp, Dh) query against (B / dp, P, KH / tp, Dh) keys, not causal;
    all heads where KH does not divide "model"."""
    _, cfgs, ranks = ran
    cfg = cfgs[name]
    dp, tp = MESH[kind]
    H, KH, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    split = KH % tp == 0
    h, kh = (H // tp, KH // tp) if split else (H, KH)
    kinds = _layer_kinds(cfg)
    causal = not cfg.encoder_only
    want = [("flash_attention", (B // dp, S, h, Dh), (B // dp, S, kh, Dh),
             False, causal) if k == "attn" else
            ("cross_attention", (B // dp, S, h, Dh),
             (B // dp, cfg.n_patches, kh, Dh), False, False)
            for k in kinds]
    for out in ranks:
        assert out["runs"][(name, ruleset, kind)]["forward_calls"] == want
    if name == "vision-whole-heads":
        assert not split


def test_cross_decode_combines_a_sequence_sharded_patch_cache(ran):
    """With 1024 patches each CROSS layer's ck / cv lie sequence-sharded
    over "model" (a rank's (B / dp, P / tp, KH, Dh)), and each decode
    step combines the ranks' partial attentions once a CROSS layer, on
    plain tensors of all H heads; with 16 patches the cache is
    feature-sharded (Shard(3)) and decode combines nothing."""
    _, cfgs, ranks = ran
    for name, dim, combines in (("vision-1024-patches", 1, 1),
                                ("llama-3.2-vision-11b", 3, 0)):
        cfg = cfgs[name]
        dp, tp = MESH["2x2"]
        P, KH, H, Dh = cfg.n_patches, cfg.n_kv_heads, cfg.n_heads, \
            cfg.head_dim
        local = (B // dp, P // tp, KH, Dh) if dim == 1 else \
            (B // dp, P, KH, Dh // tp)
        placement = ("Shard(dim=0)", f"Shard(dim={dim})")
        n_cross = _layer_kinds(cfg).count("cross")
        for out in ranks:
            run = out["runs"][(name, "base", "2x2")]
            assert run["cross_cache"] == [(placement, local)] * n_cross
            got = [c for c in run["decode_calls"]
                   if c[0] == "combine_partials"]
            assert got == [("combine_partials", (B // dp, 1, H, Dh), None,
                            False, None)] * (combines * n_cross * STEPS)


@pytest.mark.parametrize("name,branch", [("hubert-xlarge", "vocab_parallel"),
                                         ("hubert-255-labels", "whole")])
def test_audio_loss_branch_follows_the_vocabulary(ran, name, branch):
    """hubert's loss runs on vocab-sharded logits where "model" divides
    its labels (256) and on whole logits where it does not (255): every
    chunk of both train steps in one branch."""
    _, _, ranks = ran
    for out in ranks:
        got = out["runs"][(name, "base", "2x2")]["loss_branches"]
        assert set(got) == {branch} and got[branch] >= TRAIN_STEPS


def test_compressed_step_on_a_pod_mesh(ran):
    """The vision model's compressed step on 2 x 1 x 2 against its group
    form on the "pod" dim's two ranks: both steps' metrics within
    METRIC_RTOL; against JAX's unsharded plain step at
    tests/test_dp_compress.py's bars: step 1's loss, and every weight after
    the last step."""
    refs, cfgs, ranks = ran
    cfg, want = cfgs[COMPRESSED], refs[COMPRESSED]
    for r, out in enumerate(ranks):
        mesh, group = out["compressed"]["mesh"], out["compressed"]["group"]
        for i, (g, w) in enumerate(zip(mesh["metrics"], group["metrics"])):
            for k in w:
                assert abs(g[k] - w[k]) <= METRIC_RTOL * max(1.0, abs(w[k])),\
                    (r, i + 1, k, g[k], w[k])
        assert abs(mesh["metrics"][0]["loss"] - want["metrics"][0]["loss"]) \
            < DP_LOSS_ATOL, r
    _close(_jax_flat(cfg, ranks[0]["compressed"]["mesh"]["params"]),
           flatten_with_paths(want["params"]), 0.0, DP_PARAM_ATOL)
