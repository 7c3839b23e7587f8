"""Worker processes for the port's gloo tests (``test_torch_compression``,
``test_torch_sharding_serve``, ``test_torch_sharding_train``,
``test_torch_sharding_moe``, ``test_torch_sharding_recurrent``,
``test_torch_sharding_modal``): each joins
a gloo group through a file store and writes what it saw to
``out_dir/rank{r}.pt``.  Imports torch
and the port only, so that a spawned worker starts quickly."""
import os

import numpy as np
import torch
import torch.distributed as dist


def _join(rank, world, init_file):
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)


def all_reduce_worker(rank, world, init_file, out_dir):
    """Seeded gradients and errors of rank ``rank`` through
    ``all_reduce_int8_with_ef``."""
    from repro_torch.optim.compression import all_reduce_int8_with_ef
    _join(rank, world, init_file)
    try:
        rng = np.random.default_rng(100 + rank)
        grads = {"a": torch.as_tensor(rng.standard_normal((7, 5)) * (rank + 1),
                                      dtype=torch.float32),
                 "b": [torch.as_tensor(rng.standard_normal(33) * 1e-3,
                                       dtype=torch.float32)]}
        errors = {"a": torch.as_tensor(rng.standard_normal((7, 5)) * 1e-2,
                                       dtype=torch.float32),
                  "b": [torch.zeros(33)]}
        mean, new = all_reduce_int8_with_ef(grads, errors)
        torch.save({"grads": grads, "errors": errors, "mean": mean,
                    "new": new}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def compressed_step_worker(rank, world, init_file, out_dir):
    """One step of ``make_train_step_dp_compressed`` of reduced minicpm-2b
    on this rank's half of a seeded batch; records the gradients that went
    into the all-reduce and what came out, the metrics and the
    parameters after the step."""
    from repro_torch.configs import get_arch
    from repro_torch.data import batch_for
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import AdamWConfig, adamw_init, compression
    from repro_torch.tree import tree_leaves
    _join(rank, world, init_file)
    seen = {}
    reduce = compression.all_reduce_int8_with_ef

    def recording(grads, errors, group=None):
        seen["grads"] = [g.clone() for g in tree_leaves(grads)]
        seen["errors"] = [e.clone() for e in tree_leaves(errors)]
        used, new = reduce(grads, errors, group)
        seen["used"] = [u.clone() for u in tree_leaves(used)]
        seen["new"] = [n.clone() for n in tree_leaves(new)]
        return used, new
    compression.all_reduce_int8_with_ef = recording
    try:
        cfg = get_arch("minicpm-2b").reduced()
        params = R.init_params(cfg, 0, device="cpu",
                               param_dtype=torch.float32)
        opt = adamw_init(params)
        errors = steps.init_ef_errors(params)
        batch = batch_for(cfg, ShapeSpec("t", 32, 4, "train"), seed=0)
        step = steps.make_train_step_dp_compressed(
            cfg, AdamWConfig(lr=1e-3, warmup_steps=1), device="cpu")
        params, opt, errors, metrics = step(params, opt, errors, batch)
        torch.save({"seen": seen,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "params": [p.detach().clone()
                               for p in tree_leaves(params)]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        compression.all_reduce_int8_with_ef = reduce
        dist.destroy_process_group()


def sharded_serve_worker(rank, world, init_file, out_dir):
    """The cases of ``out_dir/cases.pkl`` (``test_torch_sharding_serve``):
    each case's converted params placed by a ruleset on a 2 x 2
    ("data", "model") mesh or a 2 x 1 x 2 ("pod", "data", "model") one,
    then ``forward_logits``, ``make_prefill_step`` and greedy
    ``make_serve_step`` steps on the mesh; and a checkpoint of the first
    case restored onto the 2 x 2 mesh through ``place_tree``.  Writes the
    whole logits, tokens and what was checked to ``rank{r}.pt``."""
    import pickle

    from repro_torch.checkpoint import store
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    # four ranks on a shared CPU: two threads each, or they oversubscribe it
    torch.set_num_threads(2)
    _join(rank, world, init_file)
    try:
        with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
            job = pickle.load(f)
        meshes = {"2x2": M.make_local_mesh(2),
                  "2x1x2": M.make_production_mesh(1, 2, multi_pod=True)}
        out = {"mesh_dims": {k: m.mesh_dim_names for k, m in meshes.items()},
               "runs": {}}
        for case in job["cases"]:
            cfg = case["cfg"]
            params = params_from_jax(cfg, case["params"])
            axes = R.logical_axes(cfg)
            toks = torch.as_tensor(case["tokens"])
            for ruleset, kind in case["runs"]:
                mesh = meshes[kind]
                specs = S.logical_to_specs(axes, params, mesh,
                                           S.RULESETS[ruleset])
                placed = S.distribute_tree(params, specs, mesh)
                prefill = steps.make_prefill_step(
                    cfg, cache_len=case["cache_len"], device="cpu",
                    mesh=mesh)
                serve = steps.make_serve_step(cfg, device="cpu", mesh=mesh)
                with torch.no_grad():
                    fwd = R.forward_logits(placed, cfg, {"tokens": toks},
                                           device="cpu", mesh=mesh)
                    logits, cache = prefill(placed, {"tokens": toks})
                    run = {"forward": fwd.full_tensor(),
                           "prefill": logits.full_tensor(),
                           # the dim each mesh dim shards, None whole
                           "cache_placements": [
                               p.dim if p.is_shard() else None for p in
                               cache["layers"][0]["k"].placements],
                           "decode": [], "tokens": []}
                    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                    for i in range(case["steps"]):
                        run["tokens"].append(tok.full_tensor())
                        tok, logits, cache = serve(
                            placed, tok, toks.shape[1] + i, cache)
                        run["decode"].append(logits.full_tensor())
                    run["tokens"].append(tok.full_tensor())
                out["runs"][(case["name"], ruleset, kind)] = run
        # a checkpoint of the first case's params, written whole, restored
        # onto the 2 x 2 mesh
        case, mesh = job["cases"][0], meshes["2x2"]
        cfg = case["cfg"]
        params = params_from_jax(cfg, case["params"])
        specs = S.logical_to_specs(R.logical_axes(cfg), params, mesh,
                                   S.RULESETS["base"])
        place = S.map_leaves(lambda s: S.placements(mesh, s), specs)
        step, trees, _ = store.CheckpointManager(
            job["ckpt_dir"], cfg).restore_latest(
                {"params": params}, {"params": place}, mesh)
        restored = S.map_leaves(
            lambda t, want, p: (tuple(t.placements) == p and torch.equal(
                t.to_local(), S.local_shard(want, mesh, p))),
            trees["params"], params, place)
        out["checkpoint"] = {"step": step, "leaves": restored}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _whole(t):
    """A DTensor gathered whole (a collective of its mesh), or the tensor,
    detached and copied."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().clone()


def _whole_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(_whole, tree)


def _train_steps(step, params, opt, batches, errors=None):
    """``step`` over ``batches``; returns (params, opt, errors, each step's
    metrics as floats)."""
    metrics = []
    for batch in batches:
        if errors is None:
            params, opt, m = step(params, opt, batch)
        else:
            params, opt, errors, m = step(params, opt, errors, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, errors, metrics


def sharded_train_worker(rank, world, init_file, out_dir):
    """The cases of ``out_dir/cases.pkl`` (``test_torch_sharding_train``):
    each case's converted float32 params placed by a ruleset on a 2 x 2
    ("data", "model") mesh or a 2 x 1 x 2 ("pod", "data", "model") one,
    with AdamW moments like them, trained by ``make_train_step`` with
    ``mesh=`` over the case's batches; the compressed step on the 2 x 1 x 2
    mesh (params on each pod's 1 x 2 submesh) beside its group form over
    the "pod" dim's group (whole params, two ranks), each leaf's
    quantisation recorded whole (target, int8 values, scale); and the
    first run's trained state through the checkpoint store and
    ``place_tree``.  Writes each run's metrics, whole moments and weights
    to ``rank{r}.pt``."""
    import pickle

    from repro_torch.checkpoint import store
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.optim import AdamWConfig, adamw_init, compression
    from repro_torch.tree import tree_leaves
    # four ranks on a shared CPU: two threads each, or they oversubscribe it
    torch.set_num_threads(2)
    _join(rank, world, init_file)
    try:
        with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
            job = pickle.load(f)
        ocfg = AdamWConfig(**job["opt"])
        meshes = {"2x2": M.make_local_mesh(2),
                  "2x1x2": M.make_production_mesh(1, 2, multi_pod=True)}
        out = {"runs": {}}
        kept = None
        for case in job["cases"]:
            cfg = case["cfg"]
            axes = R.logical_axes(cfg)
            for ruleset, kind, accum in case["runs"]:
                mesh = meshes[kind]
                params = params_from_jax(cfg, case["params"])
                specs = S.logical_to_specs(axes, params, mesh,
                                           S.RULESETS[ruleset])
                placed = S.distribute_tree(params, specs, mesh)
                opt = adamw_init(placed)
                step = steps.make_train_step(cfg, ocfg, accum_steps=accum,
                                             device="cpu", mesh=mesh)
                placed, opt, _, metrics = _train_steps(
                    step, placed, opt, case["batches"])
                out["runs"][(case["name"], ruleset, kind, accum)] = {
                    "metrics": metrics, "params": _whole_tree(placed),
                    "m": _whole_tree(opt.m), "v": _whole_tree(opt.v),
                    "step": int(opt.step),
                    "moments_placed_like_params": all(
                        tuple(p.placements) == tuple(m.placements) ==
                        tuple(v.placements) for p, m, v in zip(
                            tree_leaves(placed), tree_leaves(opt.m),
                            tree_leaves(opt.v)))}
                if kept is None:
                    kept = (cfg, params, specs, mesh, placed, opt)

        # the compressed step: on the 2 x 1 x 2 mesh, and its group form;
        # each leaf's quantisation (whole) recorded
        case = job["cases"][0]
        cfg, mesh = case["cfg"], meshes["2x1x2"]
        pod = mesh["data", "model"]
        seen = []
        quantize = compression.ef_compress_update

        def recording(grad, error):
            q, scale, new = quantize(grad, error)
            seen.append({"target": _whole(grad.float() + error),
                         "q": _whole(q.to(torch.int32)),
                         "scale": float(_whole(scale))})
            return q, scale, new
        compression.ef_compress_update = recording
        try:
            params = params_from_jax(cfg, case["params"])
            placed = S.distribute_tree(params, S.logical_to_specs(
                R.logical_axes(cfg), params, pod, S.RULESETS["base"]), pod)
            step = steps.make_train_step_dp_compressed(
                cfg, ocfg, mesh=mesh, device="cpu")
            placed, opt, errors, metrics = _train_steps(
                step, placed, adamw_init(placed), case["batches"],
                errors=steps.init_ef_errors(placed))
            comp = {"mesh": {
                "metrics": metrics, "params": _whole_tree(placed),
                "quantised": seen[:], "errors_placed_like_params": all(
                    tuple(p.placements) == tuple(e.placements)
                    for p, e in zip(tree_leaves(placed),
                                    tree_leaves(errors)))}}
            seen.clear()
            params = params_from_jax(cfg, case["params"])
            step = steps.make_train_step_dp_compressed(
                cfg, ocfg, group=mesh.get_group("pod"), device="cpu")
            params, opt, errors, metrics = _train_steps(
                step, params, adamw_init(params), case["batches"],
                errors=steps.init_ef_errors(params))
            comp["group"] = {"metrics": metrics, "params": params,
                             "quantised": seen[:]}
        finally:
            compression.ef_compress_update = quantize
        out["compressed"] = comp

        # the first run's trained state written whole by one rank, then
        # restored onto its mesh
        cfg, params, specs, mesh, placed, opt = kept
        flat = store.flatten_trees(cfg, {"params": placed, "opt": opt})
        if rank == 0:
            store.save_checkpoint(job["ckpt_dir"], 2, flat)
        dist.barrier()
        place = S.map_leaves(lambda s: S.placements(mesh, s), specs)
        restored_step, trees, _ = store.CheckpointManager(
            job["ckpt_dir"], cfg).restore_latest(
                {"params": params, "opt": adamw_init(params)},
                {"params": place, "opt": place}, mesh)
        same = [tuple(a.placements) == tuple(b.placements) and
                torch.equal(a.to_local(), b.to_local())
                for got, want in ((trees["params"], placed),
                                  (trees["opt"].m, opt.m),
                                  (trees["opt"].v, opt.v))
                for a, b in zip(tree_leaves(got), tree_leaves(want))]
        out["checkpoint"] = {"step": restored_step,
                             "opt_step": int(trees["opt"].step),
                             "leaves": same}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _record_expert_ffn(sink):
    """Wrap ``moe_gmm.ops.expert_ffn`` (the MoE layers call it through its
    module) so that each call appends (xe's shape, w1's shape, its bucket
    fills) to ``sink``; returns a function that restores it."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    real = gmm_ops.expert_ffn

    def recording(xe, p, act="swiglu", counts=None):
        sink.append((tuple(xe.shape), tuple(p["w1"].shape),
                     None if counts is None else counts.tolist()))
        return real(xe, p, act, counts)
    gmm_ops.expert_ffn = recording

    def restore():
        gmm_ops.expert_ffn = real
    return restore


def sharded_moe_worker(rank, world, init_file, out_dir):
    """The runs of ``out_dir/cases.pkl`` (``test_torch_sharding_moe``):
    each case's converted float32 params placed by a ruleset on a 2 x 2
    ("data", "model") mesh, a 2 x 1 x 2 ("pod", "data", "model") or a
    1 x 4 one; then ``forward_logits``, the prefill step and greedy serve
    steps, and ``make_train_step`` over the case's batches, each with its
    moe dispatch.  Each call of the expert FFN is recorded (its shapes and
    bucket fills), and after the first train step whether each local
    expert's first moments are non-zero.  Writes the whole logits,
    tokens, metrics and moments to ``rank{r}.pt``."""
    import pickle

    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.models import registry as R
    from repro_torch.optim import AdamWConfig
    torch.set_num_threads(2)
    _join(rank, world, init_file)
    calls = []
    restore = _record_expert_ffn(calls)
    try:
        with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
            job = pickle.load(f)
        ocfg = AdamWConfig(**job["opt"])
        meshes = {"2x2": M.make_local_mesh(2),
                  "2x1x2": M.make_production_mesh(1, 2, multi_pod=True),
                  "1x4": M.make_local_mesh(4)}
        out = {"coords": {k: m.get_coordinate() for k, m in meshes.items()},
               "runs": {}}
        for case in job["cases"]:
            cfg = case["cfg"]
            axes = R.logical_axes(cfg)
            toks = torch.as_tensor(case["tokens"])
            for ruleset, kind, dispatch in case["runs"]:
                mesh = meshes[kind]
                params = params_from_jax(cfg, case["params"])
                specs = S.logical_to_specs(axes, params, mesh,
                                           S.RULESETS[ruleset])
                placed = S.distribute_tree(params, specs, mesh)
                run = {}
                with torch.no_grad():
                    calls.clear()
                    run["forward"] = R.forward_logits(
                        placed, cfg, {"tokens": toks}, moe_dispatch=dispatch,
                        device="cpu", mesh=mesh).full_tensor()
                    run["forward_calls"] = calls[:]
                    if case["steps"]:
                        _serve_run(run, placed, cfg, toks, case, dispatch,
                                   mesh)
                if case["batches"]:
                    _train_run(run, calls, cfg, case, ruleset, dispatch,
                               mesh, ocfg)
                out["runs"][(case["name"], ruleset, kind, dispatch)] = run
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        restore()
        dist.destroy_process_group()


def _serve_run(run, placed, cfg, toks, case, dispatch, mesh):
    """The prefill step and ``case["steps"]`` greedy serve steps on
    ``mesh``: their whole logits and tokens into ``run``."""
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(cfg, cache_len=case["cache_len"],
                                      moe_dispatch=dispatch, device="cpu",
                                      mesh=mesh)
    serve = steps.make_serve_step(cfg, moe_dispatch=dispatch, device="cpu",
                                  mesh=mesh)
    logits, cache = prefill(placed, {"tokens": toks})
    run.update(prefill=logits.full_tensor(), decode=[], tokens=[])
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    for i in range(case["steps"]):
        run["tokens"].append(tok.full_tensor())
        tok, logits, cache = serve(placed, tok, toks.shape[1] + i, cache)
        run["decode"].append(logits.full_tensor())
    run["tokens"].append(tok.full_tensor())


def _train_run(run, calls, cfg, case, ruleset, dispatch, mesh, ocfg):
    """``make_train_step`` on ``mesh`` over ``case["batches"]`` from the
    case's params: each step's metrics, the whole moments after the last,
    and after the first each layer's (first local expert, [whether each
    local expert's w1, w3 and w2 first moments are non-zero]) with the
    fills of that step's expert FFN calls."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.optim import adamw_init
    params = params_from_jax(cfg, case["params"])
    placed = S.distribute_tree(params, S.logical_to_specs(
        R.logical_axes(cfg), params, mesh, S.RULESETS[ruleset]), mesh)
    opt = adamw_init(placed)
    step = steps.make_train_step(cfg, ocfg, moe_dispatch=dispatch,
                                 accum_steps=case["accum"], device="cpu",
                                 mesh=mesh)
    metrics = []
    for i, batch in enumerate(case["batches"]):
        calls.clear()
        placed, opt, m = step(placed, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            run["step1_calls"] = calls[:]
            run["step1_moments"] = [
                {n: (layer["ffn"][n].to_local().flatten(1).abs().amax(1) > 0)
                 .tolist() for n in ("w1", "w3", "w2")}
                for layer in opt.m["layers"]]
    run.update(metrics=metrics, m=_whole_tree(opt.m), v=_whole_tree(opt.v),
               params=_whole_tree(placed))


def _record_recurrent_kernels(sink):
    """Wrap the RG-LRU and mLSTM kernels' wrappers (as the blocks call
    them) and the sLSTM's loop over time: each call appends (its name, its
    first input's shape, whether that is a DTensor) to ``sink``; the loop
    also the DTensor ops that ran while it ran (a dispatch mode sees each
    op on a DTensor before DTensor does).  Returns a function that
    restores them."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
    from repro_torch.models import rglru, xlstm

    class DTensorOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                self.ops.append(str(func))
                return NotImplemented
            return func(*args, **(kwargs or {}))

    real = (rglru.rglru_scan, mlstm_ops.mlstm_chunkwise, xlstm._slstm_scan)

    def rg(x, *args, **kw):
        sink.append(("rglru_scan", tuple(x.shape), isinstance(x, DTensor)))
        return real[0](x, *args, **kw)

    def ml(q, *args, **kw):
        sink.append(("mlstm_scan", tuple(q.shape), isinstance(q, DTensor)))
        return real[1](q, *args, **kw)

    def loop(zx, *args, **kw):
        with DTensorOps() as seen:
            out = real[2](zx, *args, **kw)
        sink.append(("slstm_loop", tuple(zx.shape), isinstance(zx, DTensor),
                     seen.ops))
        return out
    rglru.rglru_scan, mlstm_ops.mlstm_chunkwise, xlstm._slstm_scan = \
        rg, ml, loop

    def probe(t):
        """The DTensor ops the loop's mode sees in ``t + 1`` (a control)."""
        with DTensorOps() as seen:
            t + 1
        return seen.ops

    def restore():
        rglru.rglru_scan, mlstm_ops.mlstm_chunkwise, xlstm._slstm_scan = \
            real
    return restore, probe


def sharded_recurrent_worker(rank, world, init_file, out_dir):
    """The runs of ``out_dir/cases.pkl`` (``test_torch_sharding_recurrent``):
    each case's converted params placed by a ruleset on a 2 x 2 ("data",
    "model") mesh or a 1 x 4 one; then ``forward_logits`` (each recurrent
    kernel's call and the sLSTM loop recorded), the prefill step and
    greedy serve steps, and ``make_train_step`` over the case's batches;
    and the compressed step of the ``compressed`` case on a 2 x 1 x 2
    ("pod", "data", "model") mesh beside its group form over "pod".
    Writes the whole logits, tokens, metrics, moments and weights to
    ``rank{r}.pt``."""
    import pickle

    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.set_num_threads(2)
    _join(rank, world, init_file)
    calls = []
    restore, probe = _record_recurrent_kernels(calls)
    try:
        with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
            job = pickle.load(f)
        ocfg = AdamWConfig(**job["opt"])
        meshes = {"2x2": M.make_local_mesh(2), "1x4": M.make_local_mesh(4),
                  "2x1x2": M.make_production_mesh(1, 2, multi_pod=True)}
        out = {"runs": {}}
        for case in job["cases"]:
            cfg = case["cfg"]
            axes = R.logical_axes(cfg)
            toks = torch.as_tensor(case["tokens"])
            for ruleset, kind in case["runs"]:
                mesh = meshes[kind]

                def placed_params():
                    params = params_from_jax(cfg, case["params"])
                    return S.distribute_tree(params, S.logical_to_specs(
                        axes, params, mesh, S.RULESETS[ruleset]), mesh)
                placed = placed_params()
                run = {}
                with torch.no_grad():
                    calls.clear()
                    run["forward"] = R.forward_logits(
                        placed, cfg, {"tokens": toks}, device="cpu",
                        mesh=mesh).full_tensor()
                    run["forward_calls"] = calls[:]
                    if "probe" not in out:
                        out["probe"] = probe(placed["final_ln"])
                    _serve_run(run, placed, cfg, toks, case, "einsum", mesh)
                placed = placed_params()
                opt = adamw_init(placed)
                step = steps.make_train_step(cfg, ocfg, device="cpu",
                                             mesh=mesh)
                placed, opt, _, run["metrics"] = _train_steps(
                    step, placed, opt, case["batches"])
                run.update(m=_whole_tree(opt.m), v=_whole_tree(opt.v),
                           params=_whole_tree(placed))
                out["runs"][(case["name"], ruleset, kind)] = run
        case = next(c for c in job["cases"] if c["name"] == job["compressed"])
        out["compressed"] = _compressed_runs(case, meshes["2x1x2"], ocfg)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        restore()
        dist.destroy_process_group()


def _compressed_runs(case, mesh, ocfg):
    """``make_train_step_dp_compressed`` over ``case["batches"]`` on the
    ("pod", "data", "model") ``mesh`` (params on each pod's submesh), and
    its group form over the "pod" dim's group: each's metrics and whole
    weights."""
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.optim import adamw_init
    cfg, pod = case["cfg"], mesh["data", "model"]
    params = params_from_jax(cfg, case["params"])
    placed = S.distribute_tree(params, S.logical_to_specs(
        R.logical_axes(cfg), params, pod, S.RULESETS["base"]), pod)
    step = steps.make_train_step_dp_compressed(cfg, ocfg, mesh=mesh,
                                               device="cpu")
    placed, _, _, metrics = _train_steps(
        step, placed, adamw_init(placed), case["batches"],
        errors=steps.init_ef_errors(placed))
    runs = {"mesh": {"metrics": metrics, "params": _whole_tree(placed)}}
    params = params_from_jax(cfg, case["params"])
    step = steps.make_train_step_dp_compressed(
        cfg, ocfg, group=mesh.get_group("pod"), device="cpu")
    params, _, _, metrics = _train_steps(
        step, params, adamw_init(params), case["batches"],
        errors=steps.init_ef_errors(params))
    runs["group"] = {"metrics": metrics, "params": _whole_tree(params)}
    return runs


def _record_attention_calls(sink):
    """Wrap the flash kernel's wrapper and the plain ``attention`` as the
    blocks call them (``transformer.flash_attention``, which self-attention
    calls, and ``transformer.attention``, which only a CROSS layer's
    full-sequence path calls) and ``layers.combine_partials`` (decode over
    a sequence-sharded cache): each call appends (its name, q's or out's
    shape, k's shape, whether q is a DTensor, its ``causal``) to
    ``sink``.  Returns a function that restores them."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import layers, transformer
    real = (transformer.flash_attention, transformer.attention,
            layers.combine_partials)

    def flash(q, k, v, **kw):
        sink.append(("flash_attention", tuple(q.shape), tuple(k.shape),
                     isinstance(q, DTensor), kw["causal"]))
        return real[0](q, k, v, **kw)

    def cross(q, k, v, **kw):
        sink.append(("cross_attention", tuple(q.shape), tuple(k.shape),
                     isinstance(q, DTensor), kw["causal"]))
        return real[1](q, k, v, **kw)

    def combine(out, lse, group):
        sink.append(("combine_partials", tuple(out.shape), None,
                     isinstance(out, DTensor), None))
        return real[2](out, lse, group)
    transformer.flash_attention, transformer.attention, \
        layers.combine_partials = flash, cross, combine

    def restore():
        transformer.flash_attention, transformer.attention, \
            layers.combine_partials = real
    return restore


def _record_loss_branches(sink):
    """Count the loss's per-chunk sums by branch (``_vocab_parallel_sums``
    on vocab-sharded logits, ``_xent_sums`` on whole ones) into ``sink``;
    returns a function that restores them."""
    from repro_torch.models import transformer
    real = (transformer._xent_sums, transformer._vocab_parallel_sums)

    def count(name, fn):
        def call(*args, **kw):
            sink[name] = sink.get(name, 0) + 1
            return fn(*args, **kw)
        return call
    transformer._xent_sums = count("whole", real[0])
    transformer._vocab_parallel_sums = count("vocab_parallel", real[1])

    def restore():
        transformer._xent_sums, transformer._vocab_parallel_sums = real
    return restore


def sharded_modal_worker(rank, world, init_file, out_dir):
    """The runs of ``out_dir/cases.pkl`` (``test_torch_sharding_modal``):
    each case's converted params placed by a ruleset on a 2 x 2 ("data",
    "model") mesh or a 1 x 4 one; then ``forward_logits`` on the case's
    inputs (tokens and patches, or frames; the attention calls recorded),
    for a served case the prefill step (its whole cache and the CROSS
    layers' placements and local shapes kept) and greedy serve steps (the
    combines recorded), and ``make_train_step`` over the case's batches
    (the loss's branches counted); and the compressed step of the
    ``compressed`` case on a 2 x 1 x 2 ("pod", "data", "model") mesh
    beside its group form over "pod".  Writes the whole logits, caches,
    tokens, metrics, moments and weights to ``rank{r}.pt``."""
    import pickle

    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.launch import steps
    from repro_torch.models import registry as R
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.set_num_threads(2)
    _join(rank, world, init_file)
    calls, branches = [], {}
    restore = [_record_attention_calls(calls),
               _record_loss_branches(branches)]
    try:
        with open(os.path.join(out_dir, "cases.pkl"), "rb") as f:
            job = pickle.load(f)
        ocfg = AdamWConfig(**job["opt"])
        meshes = {"2x2": M.make_local_mesh(2), "1x4": M.make_local_mesh(4),
                  "2x1x2": M.make_production_mesh(1, 2, multi_pod=True)}
        out = {"runs": {}}
        for case in job["cases"]:
            cfg = case["cfg"]
            axes = R.logical_axes(cfg)
            inputs = {k: torch.as_tensor(v)
                      for k, v in case["inputs"].items()}
            for ruleset, kind in case["runs"]:
                mesh = meshes[kind]

                def placed_params():
                    params = params_from_jax(cfg, case["params"])
                    return S.distribute_tree(params, S.logical_to_specs(
                        axes, params, mesh, S.RULESETS[ruleset]), mesh)
                placed = placed_params()
                run = {}
                with torch.no_grad():
                    calls.clear()
                    run["forward"] = R.forward_logits(
                        placed, cfg, inputs, device="cpu",
                        mesh=mesh).full_tensor()
                    run["forward_calls"] = calls[:]
                    if case["serve"]:
                        _modal_serve_run(run, calls, placed, cfg, inputs,
                                         case, mesh)
                placed = placed_params()
                opt = adamw_init(placed)
                step = steps.make_train_step(cfg, ocfg, device="cpu",
                                             mesh=mesh)
                branches.clear()
                placed, opt, _, run["metrics"] = _train_steps(
                    step, placed, opt, case["batches"])
                run.update(loss_branches=dict(branches), m=_whole_tree(opt.m),
                           v=_whole_tree(opt.v), params=_whole_tree(placed))
                out["runs"][(case["name"], ruleset, kind)] = run
        case = next(c for c in job["cases"] if c["name"] == job["compressed"])
        out["compressed"] = _compressed_runs(case, meshes["2x1x2"], ocfg)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        for undo in restore:
            undo()
        dist.destroy_process_group()


def _modal_serve_run(run, calls, placed, cfg, inputs, case, mesh):
    """The prefill step on ``inputs`` (its whole logits and cache, and
    each CROSS layer's cache placements and local shape) and
    ``case["steps"]`` greedy serve steps (their whole logits and tokens,
    and the calls recorded while they ran) into ``run``."""
    from repro_torch.launch import steps
    prefill = steps.make_prefill_step(cfg, cache_len=case["cache_len"],
                                      device="cpu", mesh=mesh)
    serve = steps.make_serve_step(cfg, device="cpu", mesh=mesh)
    logits, cache = prefill(placed, inputs)
    run.update(prefill=logits.full_tensor(), cache=_whole_tree(cache),
               cross_cache=[(tuple(map(repr, layer["ck"].placements)),
                             tuple(layer["ck"].to_local().shape))
                            for layer in cache["layers"] if "ck" in layer],
               decode=[], tokens=[])
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    calls.clear()
    for i in range(case["steps"]):
        run["tokens"].append(tok.full_tensor())
        tok, logits, cache = serve(placed, tok,
                                   inputs["tokens"].shape[1] + i, cache)
        run["decode"].append(logits.full_tensor())
    run["tokens"].append(tok.full_tensor())
    run["decode_calls"] = calls[:]
