"""The port's recurrent and xLSTM layers on a device mesh, on four gloo
ranks of the CPU: reduced recurrentgemma-9b (RGLRU, RGLRU, LOCAL and a
tail RGLRU; its LOCAL layer's four query heads over one KV head) and
reduced xlstm-1.3b (MLSTM, SLSTM), their converted params placed by the
``base`` and ``tp_only`` rulesets on a 2 x 2 ("data", "model") mesh; then
``forward_logits``, the prefill step, three greedy serve steps and two
steps of ``make_train_step``, against the JAX package's unsharded
functions on the same tokens and batches.

Also: xlstm-1.3b in bf16 (at ``BF16_TOL``); an xLSTM of two heads on a
1 x 4 mesh, whose heads do not divide "model" and run whole on every rank;
the compressed step of the xLSTM on a 2 x 1 x 2 ("pod", "data", "model")
mesh against its group form and against JAX's plain step.  The kernels'
wrappers are recorded as the blocks call them: ``rglru_scan`` receives each
rank's (B / dp, S, D / tp) channels and ``mlstm_scan`` its (B / dp, S,
H / tp, Dh) heads, as plain tensors, once a layer; the sLSTM's loop over
time runs on plain tensors with no DTensor op while it runs.

Both packages round the recurrent blocks' conv lag buffer to bf16, so a
buffer element whose float32 value differs in its last bits may round to
the neighbouring bf16 value: the unsharded port itself misses JAX's decode
logits by up to 1.2e-4 here (xlstm-1.3b, first step).  Each decode step
is held within TOL of JAX's beyond the unsharded port's own miss on the
same element, computed here on the same tokens.  Norm scales
are drawn non-zero before conversion.  All runs go through one spawn of
four workers (``torch_dist_workers.sharded_recurrent_worker``).
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
from repro_torch.convert import (flatten_with_paths, params_from_jax,
                                 params_to_jax)
from repro_torch.models import registry as R
from repro_torch.models.xlstm import mlstm_dims

from test_torch_train import GRAD_FLOOR
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
# cancels carries the rounding of its sums into its move (the unsharded
# port against itself on a mesh: 5.5e-5 measured on the xLSTM); the
# moments, and so the gradients, hold MOMENT_RTOL
RECURRENT_PARAM_ATOL = 0.2 * OPT["lr"]
# ... and a leaf whose gradient lies under GRAD_FLOOR of the largest (the
# sLSTM's input-gate bias) moves by the sign of its rounding, ~lr a step
# whatever its size: within this of JAX's.  AdamW moves an element by at
# most ~lr a step, so this bar cannot see a wrong update of such a leaf,
# not even one left where it was; its sign is the rounding's, so no sign
# check can either.  What holds the leaf is its moments, checked first: a
# gradient dropped or wrong shows there down to MOMENT_RTOL of GRAD_FLOOR
# of the largest moment, and the update is the code that every other
# leaf's RECURRENT_PARAM_ATOL holds.
NOISE_PARAM_ATOL = 2 * TRAIN_STEPS * OPT["lr"]
# tests/test_dp_compress.py's bars on the compressed step against the plain
# one: the loss and every weight
DP_LOSS_ATOL, DP_PARAM_ATOL = 1e-3, 5e-2


def _griffin(get):
    # one period of (RGLRU, RGLRU, LOCAL) and a tail RG-LRU layer
    return dataclasses.replace(get("recurrentgemma-9b").reduced(),
                               n_layers=4)


def _xlstm(get, **kw):
    return dataclasses.replace(get("xlstm-1.3b").reduced(), n_layers=2,
                               **kw)


# name: (config maker, dtype, runs (ruleset, mesh), greedy serve steps)
CASES = {
    "recurrentgemma-9b": (_griffin, "float32",
                          [("base", "2x2"), ("tp_only", "2x2")], STEPS),
    "xlstm-1.3b": (_xlstm, "float32", [("base", "2x2"), ("tp_only", "2x2")],
                   STEPS),
    # bf16 logits of the two frameworks may order two tokens otherwise:
    # forward, prefill and the train metrics only
    "xlstm-1.3b-bf16": (_xlstm, "bfloat16", [("base", "2x2")], 0),
    # 2 heads do not split over a model axis of 4: whole on every rank
    "xlstm-2-heads": (lambda get: _xlstm(get, n_heads=2, n_kv_heads=2),
                      "float32", [("base", "1x4")], STEPS),
}
COMPRESSED = "xlstm-1.3b"
RUNS = [(name, rs, kind) for name, (_, _, runs, _) in CASES.items()
        for rs, kind in runs]
MESH = {"2x2": (2, 2), "1x4": (1, 4)}     # (dp, tp)

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


def _port_decode(tc, jp, toks, tokens):
    """The unsharded port's decode logits after its prefill, fed JAX's
    greedy ``tokens``."""
    params = params_from_jax(tc, jp)
    Sq = toks.shape[1]
    with torch.no_grad():
        _, cache = R.prefill(params, tc, {"tokens": toks},
                             cache_len=Sq + STEPS, device="cpu")
        out = []
        for i, tok in enumerate(tokens):
            logits, cache = R.decode_step(params, tc, torch.as_tensor(tok),
                                          Sq + i, cache, device="cpu")
            out.append(logits.float().numpy())
    return out


def _reference(tc, jc, jp, toks, batches, steps):
    """The JAX package's unsharded results, and the unsharded port's
    decode logits."""
    f32 = np.float32
    ref = {"forward": np.asarray(_jax_forward(jp, jc, {"tokens": toks}),
                                 f32)}
    Sq = toks.shape[1]
    logits, cache = _jax_prefill(jp, jc, {"tokens": toks},
                                 cache_len=Sq + STEPS)
    ref.update(prefill=np.asarray(logits, f32), decode=[], tokens=[])
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for i in range(steps):
        ref["tokens"].append(np.asarray(tok))
        logits, cache = _jax_decode(jp, jc, tok, jnp.int32(Sq + i), cache)
        ref["decode"].append(np.asarray(logits, f32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    ref["port_decode"] = _port_decode(tc, jp, toks, ref["tokens"])
    ref["tokens"].append(np.asarray(tok))
    ref.update(_jax_train(jc, jp, batches))
    return ref


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """The workers run while the JAX references are computed."""
    tmp = tmp_path_factory.mktemp("sharded_recurrent")
    cases, jax_cases = [], []
    for n, (name, (make, dtype, runs, steps)) in enumerate(CASES.items()):
        jc = dataclasses.replace(make(jax_arch), dtype=dtype)
        tc = dataclasses.replace(make(torch_arch), dtype=dtype)
        jp = jax.jit(lambda key, jc=jc: JR.init_params(key, jc)[0])(
            jax.random.key(n))
        jp = draw_nonzero(jp, n)
        toks = np.random.default_rng(n).integers(
            0, jc.vocab_size, (B, S)).astype(np.int32)
        batches = [jax_batch_for(jc, JaxShapeSpec("t", S, B, "train"),
                                 seed=n, step=i) for i in range(TRAIN_STEPS)]
        jax_cases.append((name, tc, jc, jp, toks, batches, steps))
        cases.append({"name": name, "cfg": tc, "params": jp, "tokens": toks,
                      "cache_len": S + STEPS, "steps": steps,
                      "batches": batches, "runs": runs})
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump({"cases": cases, "opt": OPT, "compressed": COMPRESSED},
                    f)

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_dist_workers.sharded_recurrent_worker,
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
def test_sharded_recurrent_serving_matches_jax(ran, name, ruleset, kind):
    """forward_logits and the prefill's last logits on every rank within
    TOL of JAX's; each greedy serve step's logits within TOL beyond the
    unsharded port's own miss (its bf16 lag buffers); the same greedy
    tokens."""
    refs, cfgs, ranks = ran
    want, tol = refs[name], _tol(cfgs[name])
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind)]
        for key in ("forward", "prefill"):
            np.testing.assert_allclose(got[key].float().numpy(), want[key],
                                       atol=tol, rtol=0,
                                       err_msg=f"rank {r} {key}")
        assert len(got["decode"]) == CASES[name][3]
        for i, (g, w, u) in enumerate(zip(got["decode"], want["decode"],
                                          want["port_decode"])):
            miss = np.abs(g.float().numpy() - w) - np.abs(u - w)
            assert miss.max() <= tol, (r, i, float(miss.max()))
        if got["decode"]:
            assert [t.numpy().tolist() for t in got["tokens"]] == \
                [t.tolist() for t in want["tokens"]], f"rank {r}"


def _jax_flat(cfg, tree):
    return flatten_with_paths(params_to_jax(cfg, tree))


def _close_floored(got, want, rtol, floor):
    """``_close`` with each leaf's scale floored at ``floor`` of the
    largest leaf's: the sLSTM's input-gate bias has a gradient that nearly
    vanishes (``test_torch_train.GRAD_FLOOR``), and its moments hold only
    the rounding of the model's gradient."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), floor * top)
        err = float(np.abs(np.asarray(got[key], np.float32) - w).max())
        assert err <= rtol * scale, (key, err, scale)


@pytest.mark.parametrize("name,ruleset,kind", RUNS)
def test_sharded_recurrent_train_steps_match_jax(ran, name, ruleset, kind):
    """Two steps: every metric on every rank, then every moment (so each
    gradient) and weight gathered whole, at ``test_torch_train_step``'s
    bars, each moment's scale floored as ``test_torch_train`` floors a
    gradient's (the second moment's at the square of that floor); bf16:
    the metrics at BF16_TOL."""
    refs, cfgs, ranks = ran
    want, cfg = refs[name], cfgs[name]
    rtol = METRIC_RTOL if cfg.dtype == "float32" else BF16_TOL
    for r, out in enumerate(ranks):
        got = out["runs"][(name, ruleset, kind)]
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert set(g) == set(w)
            for k in w:
                assert abs(g[k] - w[k]) <= rtol * max(1.0, abs(w[k])), \
                    (r, i + 1, k, g[k], w[k])
    if cfg.dtype != "float32":
        return
    got = ranks[0]["runs"][(name, ruleset, kind)]
    _close_floored(_jax_flat(cfg, got["m"]), flatten_with_paths(want["m"]),
                   MOMENT_RTOL, GRAD_FLOOR)
    _close_floored(_jax_flat(cfg, got["v"]), flatten_with_paths(want["v"]),
                   MOMENT_RTOL, GRAD_FLOOR ** 2)
    moments = flatten_with_paths(want["m"])
    top = max(float(np.abs(w).max()) for w in moments.values())
    params = _jax_flat(cfg, got["params"])
    for key, w in flatten_with_paths(want["params"]).items():
        bar = RECURRENT_PARAM_ATOL if float(np.abs(moments[key]).max()) >= \
            GRAD_FLOOR * top else NOISE_PARAM_ATOL
        err = float(np.abs(np.asarray(params[key], np.float32) - w).max())
        assert err <= bar, (key, err, bar)


@pytest.mark.parametrize("name,ruleset,kind", RUNS)
def test_recurrent_kernels_run_on_each_ranks_local_pieces(ran, name,
                                                          ruleset, kind):
    """In one forward each RG-LRU layer's ``rglru_scan`` receives a plain
    (B / dp, S, D / tp) and each mLSTM layer's ``mlstm_scan`` a plain
    (B / dp, S, H / tp, Dh), or all H where H does not divide "model"."""
    _, cfgs, ranks = ran
    cfg = cfgs[name]
    dp, tp = MESH[kind]
    kinds = [cfg.block_pattern[n % cfg.pattern_period]
             for n in range(cfg.n_layers)]
    H, Dh, _ = mlstm_dims(cfg)
    want = {"rglru_scan": [(B // dp, S, cfg.d_model // tp)] *
            kinds.count("rglru"),
            "mlstm_scan": [(B // dp, S, H // tp if H % tp == 0 else H, Dh)] *
            kinds.count("mlstm")}
    assert sum(map(len, want.values())) > 0 or "slstm" in kinds
    for out in ranks:
        calls = out["runs"][(name, ruleset, kind)]["forward_calls"]
        for kernel, shapes in want.items():
            got = [c for c in calls if c[0] == kernel]
            assert [c[1] for c in got] == shapes, kernel
            assert not any(c[2] for c in got), kernel
    if name == "xlstm-2-heads":
        assert H % tp != 0


@pytest.mark.parametrize("name,ruleset,kind",
                         [r for r in RUNS if r[0].startswith("xlstm")])
def test_no_dtensor_op_runs_inside_the_slstm_loop(ran, name, ruleset, kind):
    """Each sLSTM layer's loop over time runs once, on its rank's heads as
    plain tensors (B / dp, S, H / tp, Dh), and the dispatch mode that
    watched it saw no DTensor op; the same mode sees one in a control."""
    _, cfgs, ranks = ran
    cfg = cfgs[name]
    dp, tp = MESH[kind]
    H = cfg.n_heads
    Dh = cfg.d_model // H
    n_slstm = sum(cfg.block_pattern[n % cfg.pattern_period] == "slstm"
                  for n in range(cfg.n_layers))
    for out in ranks:
        assert out["probe"], "the control saw no DTensor op"
        loops = [c for c in out["runs"][(name, ruleset, kind)]
                 ["forward_calls"] if c[0] == "slstm_loop"]
        assert len(loops) == n_slstm > 0
        for _, shape, is_dtensor, ops in loops:
            assert shape == (B // dp, S, H // tp if H % tp == 0 else H, Dh)
            assert not is_dtensor and ops == []


def test_compressed_step_on_a_pod_mesh(ran):
    """The xLSTM's compressed step on 2 x 1 x 2 against its group form on
    the "pod" dim's two ranks: both steps' metrics within METRIC_RTOL;
    against JAX's unsharded plain step at tests/test_dp_compress.py's
    bars: step 1's loss, and every weight after the last step."""
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
