"""Dry run of the port: one roofline record per (arch x shape) cell on one
H100, or on a mesh of H100s (PyTorch port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \
        --shape train_4k --out build/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minitron-8b \
        --shape prefill_32k --dp 1 --tp 8 --ruleset base --out DIR

Each cell builds the full-width, full-depth model on the ``meta`` device
and runs its step there at the cell's whole global batch, under
``distributed.flops.FlopCounter``: a training step (``forward_train``, its
backward with the config's remat, and AdamW), a prefill, or one decode
step against a cache of the shape's length.  Nothing is allocated and no
GPU is needed: this is an analysis of shapes, as ``count_params_analytic``
is.  The record holds the counted FLOPs and bytes (each kernel by its own
work), the memory of the step's arguments (parameters, their gradients
and the AdamW moments, the batch or the cache: exact, from shapes) and
the peak of its live temporaries (an estimate), and the roofline terms
against ``launch.mesh``'s figures.  ``launch/roofline.py`` turns the
records into a table.  A cell that does not apply is written as a record
with its ``skip`` reason.

With ``--dp``/``--tp`` (and ``--multi-pod``: two pods of dp x tp) above one
card, the cell runs on rank 0 of a fake process group of that many ranks
(``torch.distributed``'s "fake" backend: its collectives move nothing), on
a ``DeviceMesh`` ("data", "model") or ("pod", "data", "model"), with the
params placed by ``--ruleset``, the batch by ``batch_specs`` and the cache
by ``cache_specs``.  The counts are then one card's: its local FLOPs and
bytes, the wire bytes of the collectives DTensor emits, its share of the
arguments (the float32 parameters, their gradients and the AdamW moments
of a train cell each its local pieces); the record's ``mesh`` is e.g.
"1x8xH100" and ``chips`` the world size.  Every config runs on a mesh:
the text decoders, self-attention, dense or MoE (``--ruleset ep`` spreads
the experts over "model"; the record's ``moe`` says how many experts and
how much of d_ff a card holds), and the RG-LRU and xLSTM blocks (each
kernel counted at a rank's channels or heads, the sLSTM's steps through
``flops.loop``); llama-3.2-vision (the flash kernel at a card's local
heads, each CROSS layer's decode over its sequence-sharded patch cache
combined by all-reduces) and hubert-xlarge (whose decode cells keep their
encoder-only skip).

``--dp-compress`` counts a train cell's ``make_train_step_dp_compressed``
on the multi-pod mesh, the parameters placed on each pod's ("data",
"model") submesh and the int8 payloads all-reduced as int32 over "pod",
one a leaf; without ``--multi-pod`` the cell is skipped, as in the
reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.configs import ARCH_IDS, get_arch, get_schedule
from repro_torch.distributed import sharding
from repro_torch.distributed.flops import FlopCounter
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.steps import (init_ef_errors, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      make_train_step_dp_compressed,
                                      place_batch)
from repro_torch.models import registry as R
from repro_torch.models.config import SHAPES_BY_NAME, ShapeSpec, skip_reason
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import tree_leaves

MESH = "1xH100"
META = torch.device("meta")
DP_COMPRESS_NEEDS_POD = "dp_compress needs the pod axis"


def mesh_name(dp: int, tp: int, multi_pod: bool) -> str:
    """"1xH100" for one card, else e.g. "1x8xH100" or "2x4x2xH100"."""
    if dp * tp == 1 and not multi_pod:
        return MESH
    return ("2x" if multi_pod else "") + f"{dp}x{tp}xH100"


def _nbytes(tree) -> int:
    """The bytes of a tree's tensors on this card (a DTensor's local
    piece)."""
    return sum(sharding.local(t).nbytes for t in tree_leaves(tree))


@contextlib.contextmanager
def fake_group(world: int):
    """The default process group as rank 0 of ``world`` fake ranks, for
    the duration; raises if a group exists."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group exists; the dry run on a mesh "
                           "makes its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _batch(cfg, B: int, S: int, train: bool) -> Dict[str, torch.Tensor]:
    """The cell's inputs on ``meta``, as ``input_specs`` describes them."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    batch = {}
    if cfg.modality == "audio":
        batch["frames"] = empty((B, S, cfg.frontend_dim), torch.bfloat16)
        if train:
            batch["mask"] = empty((B, S), torch.float32)
    else:
        batch["tokens"] = empty((B, S), torch.int32)
    if train:
        batch["labels"] = empty((B, S), torch.int32)
    if cfg.modality == "vision":
        batch["patches"] = empty((B, cfg.n_patches, cfg.frontend_dim),
                                 torch.bfloat16)
    return batch


def lower_cell(arch: str, shape: Union[str, ShapeSpec], *,
               accum_steps: int = 1, moe_dispatch: str = "gather",
               remat: Optional[str] = None, dp: int = 1, tp: int = 1,
               ruleset: str = "base", multi_pod: bool = False,
               dp_compress: bool = False) -> Dict[str, Any]:
    """Count one cell's step on ``meta``; returns the JSON-able record.

    ``shape`` is a name of ``SHAPES_BY_NAME`` or a ``ShapeSpec`` of its
    own.  ``dp``, ``tp``, ``multi_pod``: the mesh (one card by default);
    ``ruleset``: a name of ``sharding.RULESETS``, read on a mesh;
    ``dp_compress``: a train cell's step is the compressed one."""
    cfg = get_arch(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if isinstance(shape, str):
        shape = SHAPES_BY_NAME[shape]
    B, S = shape.global_batch, shape.seq_len
    chips = dp * tp * (2 if multi_pod else 1)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape.name, "kind": shape.kind, "batch": B,
        "seq_len": S, "n_layers": cfg.n_layers,
        "mesh": mesh_name(dp, tp, multi_pod), "chips": chips,
        "accum_steps": accum_steps, "moe_dispatch": moe_dispatch,
        "remat": cfg.remat, "dp_compress": dp_compress,
    }
    reason = skip_reason(cfg, shape) if shape.name in SHAPES_BY_NAME \
        else None
    if reason is None and dp_compress and shape.kind == "train" and \
            not multi_pod:
        reason = DP_COMPRESS_NEEDS_POD
    if chips > 1:
        rec.update(ruleset=ruleset, mesh_dp_tp=[dp, tp],
                   multi_pod=multi_pod)
    if reason:
        rec["skip"] = reason
        return rec
    compressed = dp_compress and shape.kind == "train"
    if chips == 1:
        return _count(rec, cfg, shape, accum_steps, moe_dispatch, None,
                      None, compressed)
    with fake_group(chips):
        mesh = make_production_mesh(dp, tp, multi_pod, device_type="cpu")
        return _count(rec, cfg, shape, accum_steps, moe_dispatch, mesh,
                      sharding.RULESETS[ruleset], compressed)


def _count(rec, cfg, shape, accum_steps, moe_dispatch, mesh, rules,
           compressed):
    """Fill ``rec`` with the counts of the cell's step, on one card or on
    rank 0 of ``mesh`` with the params placed by ``rules`` (on each pod's
    ("data", "model") submesh for the ``compressed`` train step)."""
    arch, B, S, chips = rec["arch"], rec["batch"], rec["seq_len"], \
        rec["chips"]
    t0 = time.time()
    train = shape.kind == "train"
    # training keeps float32 master weights; serving cfg.dtype weights
    params = R.init_params(cfg, device=META,
                           param_dtype=torch.float32 if train else None)
    if mesh is not None:
        on = mesh["data", "model"] if compressed else mesh
        specs = sharding.logical_to_specs(R.logical_axes(cfg), params, on,
                                          rules)
        params = sharding.distribute_tree(params, specs, on)
    if cfg.is_moe:
        # the expert FFN's share of one card: (E_loc, d, f_loc) a layer
        w1 = sharding.local(params["layers"][0]["ffn"]["w1"])
        rec["moe"] = {"experts": cfg.n_experts, "d_ff": cfg.d_ff,
                      "experts_per_card": w1.shape[0],
                      "d_ff_per_card": w1.shape[2]}
    memory = {"parameters": _nbytes(params)}
    counter = FlopCounter()
    if train:
        opt = adamw_init(params)
        batch = _batch(cfg, B, S, train=True)
        memory.update(gradients=sum(4 * sharding.local(p).numel()
                                    for p in tree_leaves(params)),
                      optimizer=_nbytes([opt.m, opt.v]) + 4,
                      inputs=_nbytes(batch if mesh is None
                                     else place_batch(batch, mesh)))
        for p in tree_leaves(params):
            # a parameter's gradient is an argument of the step, not a
            # temporary of it
            p.requires_grad_(True).register_post_accumulate_grad_hook(
                lambda p: counter.exclude(sharding.local(p.grad)))
        ocfg = AdamWConfig(schedule=get_schedule(arch))
        if compressed:
            errors = init_ef_errors(params)
            memory["errors"] = _nbytes(errors)
            step = make_train_step_dp_compressed(
                cfg, ocfg, mesh=mesh, moe_dispatch=moe_dispatch,
                accum_steps=accum_steps, device=META)
            with counter:
                step(params, opt, errors, batch)
        else:
            step = make_train_step(cfg, ocfg, moe_dispatch=moe_dispatch,
                                   accum_steps=accum_steps, device=META,
                                   mesh=mesh)
            with counter:
                step(params, opt, batch)
        tokens = shape.tokens
    elif shape.kind == "prefill":
        batch = _batch(cfg, B, S, train=False)
        memory["inputs"] = _nbytes(batch if mesh is None
                                   else place_batch(batch, mesh))
        step = make_prefill_step(cfg, moe_dispatch=moe_dispatch,
                                 device=META, mesh=mesh)
        with counter, torch.inference_mode():
            step(params, batch)
        tokens = shape.tokens
    else:           # one new token a row against a cache of S positions
        cache = R.init_cache(cfg, B, S, device=META)
        tokens = torch.empty((B, 1), dtype=torch.int32, device=META)
        if mesh is not None:
            cache = sharding.distribute_tree(
                cache, sharding.cache_specs(cache, mesh), mesh)
        memory.update(cache=_nbytes(cache), inputs=_nbytes(
            tokens if mesh is None else place_batch({"t": tokens}, mesh)))
        step = make_serve_step(cfg, moe_dispatch=moe_dispatch, device=META,
                               mesh=mesh)
        with counter, torch.inference_mode():
            step(params, tokens, S - 1, cache)
        tokens = B
    rec["count_s"] = round(time.time() - t0, 2)

    tot = counter.totals
    rec["memory"] = {
        "argument_size_in_bytes": sum(memory.values()),
        "argument_parts": memory,
        "temp_size_in_bytes": tot.peak_live_bytes,
        "temp_is_estimate": True,
    }
    rec["counted"] = {
        "flops": tot.flops,
        "traffic_bytes": tot.traffic_bytes,
        "kernels": {k: dataclasses.asdict(v)
                    for k, v in sorted(tot.kernels.items())},
        "collective_wire_bytes": dict(tot.collective_bytes),
        "total_wire_bytes": tot.total_wire_bytes,
    }
    if mesh is not None:
        rec["counted"]["collective_calls"] = dict(tot.collective_calls)
    # the terms are one card's: the counts are rank 0's (every rank does
    # alike), the model's FLOPs its share
    model_fl = R.model_flops(cfg, tokens, train=train)
    compute_s = tot.flops / PEAK_FLOPS_BF16
    memory_s = tot.traffic_bytes / HBM_BW
    collective_s = tot.total_wire_bytes / NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bound_s = max(terms.values())
    rec["roofline"] = {
        "model_flops": model_fl,
        "counted_flops_global": tot.flops * chips,
        "useful_ratio": model_fl / (tot.flops * chips) if tot.flops
        else 0.0,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max(terms, key=terms.get),
        "bound_s": bound_s,
        "roofline_frac": (model_fl / chips / PEAK_FLOPS_BF16) /
        max(bound_s, 1e-12),
    }
    return rec


def run_cell(arch, shape_name, out_dir, suffix: str = "", **kw):
    mesh = mesh_name(kw.get("dp", 1), kw.get("tp", 1),
                     kw.get("multi_pod", False))
    name = f"{arch}__{shape_name}__{mesh}" + (f"__{suffix}" if suffix
                                              else "")
    try:
        rec = lower_cell(arch, shape_name, **kw)
    except Exception as e:  # a failure here is a fault of the port
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "error": repr(e), "traceback": traceback.format_exc()}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    status = ("SKIP " + rec["skip"] if "skip" in rec else
              "ERROR " + rec["error"] if "error" in rec else
              f"ok count={rec['count_s']}s "
              f"dom={rec['roofline']['dominant']}")
    print(f"[dryrun] {name}: {status}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ["all"], default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES_BY_NAME) + ["all"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--moe-dispatch", default="gather",
                    choices=["einsum", "gather"])
    ap.add_argument("--remat", default=None, choices=["full", "dots", "none"])
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods of dp x tp ranks")
    ap.add_argument("--dp-compress", action="store_true",
                    help="train cells: the int8 error-feedback all-reduce "
                         "over the pod axis (needs --multi-pod)")
    ap.add_argument("--ruleset", default="base",
                    choices=list(sharding.RULESETS))
    ap.add_argument("--suffix", default="",
                    help="artifact-name suffix for variants")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = (list(SHAPES_BY_NAME) if (args.all or args.shape in
                                       (None, "all")) else [args.shape])
    t0 = time.time()
    n_err = 0
    for a in archs:
        for s in shapes:
            rec = run_cell(a, s, args.out, args.suffix,
                           accum_steps=args.accum_steps,
                           moe_dispatch=args.moe_dispatch, remat=args.remat,
                           dp=args.dp, tp=args.tp, ruleset=args.ruleset,
                           multi_pod=args.multi_pod,
                           dp_compress=args.dp_compress)
            n_err += "error" in rec
    print(f"[dryrun] {len(archs) * len(shapes)} cells in "
          f"{time.time() - t0:.1f} s", flush=True)
    if n_err:
        raise SystemExit(f"{n_err} cell(s) failed")


if __name__ == "__main__":
    main()
