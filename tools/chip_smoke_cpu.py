#!/usr/bin/env python3
"""Rehearse chip_smoke.py's attention-only phases on the CPU, at the
reduced configs, before a chip call.

    PYTHONPATH=src python3 tools/chip_smoke_cpu.py [PHASE ...]

PHASE is any of ``serve-vision``, ``consistency-vision``, ``train-audio``,
``train-consistency-audio``, ``train-consistency`` (minicpm-2b),
``kernel-bwd-moe``, ``train-moe`` (gather against einsum), ``train-moe-full``,
``train-consistency-moe``, ``pipeline``, ``pipeline-consistency``,
``pipeline-engine`` (phase 25 then phase 38 on two small documents: the
§5 workflow through the port's engine, held to the hand-ordered run),
``pipeline-service`` (phases 25 and 38 on both, then phase 39: the
service's batches, its cancel and resume, and the analyzer's bound),
``pipeline-recovery`` (phases 25 and 38 on the smaller, then phase 40: a
crash and a resume from the journal alone),
``train-compressed`` (phase 35, on a one-rank gloo group where the card
has NCCL), ``train-driver`` (phase 36, the train driver on the CPU),
``dryrun`` (phase 12's minicpm-2b step at smoke size, then phase 37's
count of it on ``meta``), ``sharded-serve`` (phase 4's minicpm-2b serve,
then phase 41: its steps on a one-rank gloo mesh beside the same steps
without one, and one rank of a (1, 4) mesh of fake ranks),
``sharded-train`` (phase 42: minicpm-2b's train steps on a one-rank gloo
mesh beside the plain steps, the compressed step on a (1, 1, 1) mesh
beside its group form, and one train step on rank 0 of a (1, 4) mesh of
fake ranks), ``sharded-moe`` (phase 5's granite-moe serve, then phase 43:
its serving under ``ep`` and ``base`` and a train step on a one-rank gloo
mesh beside the same steps without one, then rank 0's prefills on a (1,
4) mesh of fake ranks, mixtral-8x7b's among them), ``sharded-recurrent``
(phases 8 and 10's recurrentgemma-9b and xlstm-1.3b serves, then phase 44:
each one's serving on a one-rank gloo mesh beside the same steps without
one and rank 0's prefill on a (1, 4) mesh of fake ranks with each
kernel's first call checked, then both train steps on the one-rank mesh),
``sharded-modal`` (phase 18's llama-3.2-vision serve, then phase 45: its
serving on a one-rank gloo mesh beside the same steps without one and
rank 0's prefill on a (1, 4) mesh of fake ranks; hubert-xlarge's encode
and train steps on the one-rank mesh beside plain ones and a train step
on rank 0 of (1, 4), each flash call's first checked forward and
backward) and ``zoo`` (phases 27-34: h2o-danube-3-4b on
prompts past its window, minitron-8b, deepseek-coder-33b and mixtral-8x7b through gather at
MIXTRAL_SERVE_LAYERS layers, each served, freed, then its float32
consistency on a model drawn anew at ZOO_CONSIST_LAYERS layers, past the
window for the two windowed configs, and card against CPU); by default all
of them.  The script runs a copy of chip_smoke.py with every
``"cuda"`` made ``"cpu"`` and ``torch.cuda``'s memory and synchronisation
calls stubbed, every architecture replaced by its ``-smoke`` config (remat
"full", as the train phases require) and the serving and encode sizes cut.
The flash, rglru_scan and mlstm_scan kernels' ``launch`` and
``launch_bwd``, and moe_gmm's ``launch`` and ``launch_bwd``, are replaced
by functions that fill their outputs from the plain versions (``ref``) and
count their launches by route (through ``kernels.counters``, as the
engine's threads launch at once), and CPU tensors are routed through the
wrappers' kernel paths and their autograd functions, so that every launch
check of these phases runs as it does on the card.  The pipeline's tools,
made without a device, and the engine's mesh sites, given none, run on the
CPU.
Timings are CPU times and mean nothing.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch import configs, pipeline  # noqa: E402
from repro_torch.core.connectors import mesh  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as ml_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan import ref as ml_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel as rg_kernel  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rg_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ref as gmm_ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import rglru, transformer  # noqa: E402

PHASES = ("serve-vision", "consistency-vision", "train-audio",
          "train-consistency-audio", "train-consistency", "kernel-bwd-moe",
          "train-moe", "train-moe-full", "train-consistency-moe",
          "pipeline", "pipeline-consistency", "pipeline-engine",
          "pipeline-service", "pipeline-recovery", "zoo",
          "train-compressed",
          "train-driver", "dryrun", "sharded-serve", "sharded-train",
          "sharded-moe", "sharded-recurrent", "sharded-modal")


def fake_launch(q, k, v, out, *, causal, window, scale=None, lse=None):
    # the plain versions scale by 1/sqrt of q's (padded) head dim
    qs = q.float() * ((scale or 1 / math.sqrt(q.shape[3]))
                      * math.sqrt(q.shape[3]))
    out.copy_(ref.reference_attention(qs, k.float(), v.float(),
                                      causal=causal, window=window))
    if lse is not None:
        lse.copy_(ref.reference_attention_lse(qs, k.float(), causal=causal,
                                              window=window))
    counters.bump(vars(kernel), "LAUNCHES", kernel.LAUNCHES_BY_ROUTE,
                  kernel.ROUTES[q.dtype][1])


def fake_launch_bwd(q, k, v, out, dout, lse, dsum, dq, dk, dv, *, causal,
                    window, scale, splits=None):
    c = scale * math.sqrt(q.shape[3])
    dqs, dks, dvs = ref.reference_attention_bwd(
        q.float() * c, k.float(), v.float(), out.float(), lse, dout.float(),
        causal=causal, window=window)
    dq.copy_(dqs * c)
    dk.copy_(dks)
    dv.copy_(dvs)
    counters.bump(vars(kernel), "BWD_LAUNCHES", kernel.BWD_LAUNCHES_BY_ROUTE,
                  kernel.BWD_ROUTES[q.dtype])


REAL_FLASH = ops.flash_attention


def flash_on_the_cpu(q, k, v, *, causal=True, window=0):
    """``ops.flash_attention`` without its CPU branch and device checks
    (on ``meta``, the wrapper itself, as the dry run counts it)."""
    if q.device.type == "meta":
        return REAL_FLASH(q, k, v, causal=causal, window=window)
    ops._check_shapes(q, k, v, window)
    head_dim = q.shape[3]
    scale = 1.0 / math.sqrt(head_dim)
    q, k, v = ops.kernel_layout(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = ops.FlashAttentionFunction.apply(q, k, v, causal, window, scale)
    else:
        out, _ = ops._forward(q, k, v, causal, window, scale, with_lse=False)
    return out if head_dim == out.shape[3] else \
        out[..., :head_dim].contiguous()


def fake_gmm_launch(xe, w1, w3, w2, h, y, counts, *, act, route):
    y.copy_(gmm_ref.reference_expert_ffn(
        xe, {"w1": w1, "w3": w3, "w2": w2}, act, counts))
    counters.bump(vars(gmm_kernel), "LAUNCHES", gmm_kernel.LAUNCHES_BY_ROUTE,
                  route)


PLAIN_GMM_BWD = gmm_ref.reference_expert_ffn_bwd


def fake_gmm_launch_bwd(xe, w1, w3, w2, dy, dxe, dw1, dw3, dw2, ws, counts,
                        *, act, route):
    """The plain backward (bound here, so that a phase counting the calls
    of ``ref.reference_expert_ffn_bwd`` sees none from the launch)."""
    grads = PLAIN_GMM_BWD(xe, {"w1": w1, "w3": w3, "w2": w2}, dy, act,
                          counts)
    for out, g in zip((dxe, dw1, dw3, dw2), grads):
        if out is not None:
            out.copy_(g)
    counters.bump(vars(gmm_kernel), "BWD_LAUNCHES",
                  gmm_kernel.BWD_LAUNCHES_BY_ROUTE, route)


def gmm_on_the_cpu(xe, p, act="swiglu", counts=None):
    """``ops.expert_ffn`` without its CPU branch and device checks."""
    gmm_ops._check_shapes(xe, p, act, counts)
    w1, w2 = p["w1"].to(xe.dtype), p["w2"].to(xe.dtype)
    w3 = None if p.get("w3") is None else p["w3"].to(xe.dtype)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xe, w1, w3, w2)):
        return gmm_ops.ExpertFFNFunction.apply(xe, w1, w3, w2, counts, act)
    return gmm_ops._forward(xe, w1, w3, w2, counts, act)


def fake_rglru_launch(x, lam, ga, gx, b_a, b_i, h0, y, h_last):
    wy, wh = rg_ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
    y.copy_(wy)
    h_last.copy_(wh)
    counters.bump(vars(rg_kernel), "LAUNCHES", rg_kernel.LAUNCHES_BY_ROUTE,
                  "gates" if b_a is None else "fused_bias")


def fake_rglru_launch_bwd(x, lam, ga, gx, b_a, b_i, h0, y, dy, dh_last, dx,
                          dga, dgx, dlam, db_a, db_i, dh0):
    got = rg_ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0, dh_last,
                                     b_a=b_a, b_i=b_i)
    for out, g in zip((dx, dlam, dga, dgx, dh0, db_a, db_i), got):
        if out is not None:
            out.copy_(g)
    counters.bump(vars(rg_kernel), "BWD_LAUNCHES",
                  rg_kernel.BWD_LAUNCHES_BY_ROUTE,
                  "gates" if b_a is None else "fused_bias")


REAL_RGLRU = rg_ops.rglru


def rglru_on_the_cpu(x, lam, ga, gx, h0=None, *, b_a=None, b_i=None):
    """``ops.rglru`` without its CPU branch and device checks."""
    if x.device.type == "meta":
        return REAL_RGLRU(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
    rg_ops._check_shapes(x, lam, ga, gx, h0, b_a, b_i)
    lam = lam.float()
    h0 = None if h0 is None else h0.float()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, lam, ga, gx, h0, b_a, b_i)):
        return rg_ops.RGLRUScanFunction.apply(x, lam, ga, gx, h0, b_a, b_i)
    return rg_ops._forward(x, lam, ga, gx, h0, b_a, b_i)


def fake_mlstm_launch(q, k, v, ig, fg, init, h, C, n, m, route, stats=None):
    wh, state = ml_ref.reference_mlstm(q, k, v, ig, fg, init_state=init)
    for out, w in zip((h, C, n, m), (wh, *state)):
        out.copy_(w)
    if stats is not None:
        for out, w in zip(stats, ml_ref.reference_mlstm_stats(
                q, k, v, ig, fg, init_state=init)):
            out.copy_(w)
    counters.bump(vars(ml_kernel), "LAUNCHES", ml_kernel.LAUNCHES_BY_ROUTE,
                  route)


def fake_mlstm_launch_bwd(q, k, v, ig, fg, init, h, stats, dh, dq, dk, dv,
                          dig, rows, route):
    full = ml_ref.reference_mlstm_stats(q, k, v, ig, fg, init_state=init)
    gq, gk, gv, gig, gfg = ml_ref.reference_mlstm_bwd(
        q, k, v, ig, fg, h, full, dh, init_state=init)
    for out, g in zip((dq, dk, dv, dig), (gq, gk, gv, gig)):
        out.copy_(g)
    # rows such that ops.fg_grad(fg, dig, rows) gives gfg: the reverse
    # cumulative sum of rows - dig, times sigmoid(-fg), is gfg
    dlf = gfg / torch.sigmoid(-fg)
    rows.copy_(gig + dlf - torch.cat([dlf[:, 1:], torch.zeros_like(
        dlf[:, :1])], dim=1))
    counters.bump(vars(ml_kernel), "BWD_LAUNCHES",
                  ml_kernel.BWD_LAUNCHES_BY_ROUTE, route)


REAL_MLSTM = ml_ops.mlstm_chunkwise


def mlstm_on_the_cpu(q, k, v, ig, fg, *, chunk=64, init_state=None):
    """``ops.mlstm_chunkwise`` without its CPU branch and device checks."""
    if q.device.type == "meta":
        return REAL_MLSTM(q, k, v, ig, fg, chunk=chunk,
                          init_state=init_state)
    ml_ops._check_shapes(q, k, v, ig, fg, chunk, init_state)
    ig, fg = ig.float(), fg.float()
    route = ml_ops.kernel_route(q, k, v)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, ig, fg)):
        h, C, n, m = ml_ops.MLSTMScanFunction.apply(
            q, k, v, ig, fg, *(init_state or (None, None, None)), route)
        return h, (C, n, m)
    h, state, _ = ml_ops._forward(q, k, v, ig, fg, init_state, route,
                                  with_stats=False)
    return h, state


class CPUEvent:
    """``torch.cuda.Event`` on the host's clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def load_chip_smoke():
    """chip_smoke.py's namespace, rewritten for the CPU at smoke size."""
    kernel.launch, kernel.launch_bwd = fake_launch, fake_launch_bwd
    ops.flash_attention = transformer.flash_attention = flash_on_the_cpu
    gmm_kernel.launch, gmm_kernel.launch_bwd = fake_gmm_launch, \
        fake_gmm_launch_bwd
    # the backward kernel's path on CPU tensors too
    gmm_ops._backward = gmm_ops.expert_ffn_bwd
    rg_kernel.launch, rg_kernel.launch_bwd = fake_rglru_launch, \
        fake_rglru_launch_bwd
    rg_ops.rglru = rglru.rglru_scan = rglru_on_the_cpu
    ml_kernel.launch, ml_kernel.launch_bwd = fake_mlstm_launch, \
        fake_mlstm_launch_bwd
    ml_ops.mlstm_chunkwise = mlstm_on_the_cpu
    gmm_ops.check_kernel_args = lambda *a, **k: None
    gmm_ops.expert_ffn = gmm_on_the_cpu
    pipeline.resolve_device = train.resolve_device = mesh.resolve_device = \
        lambda device=None: torch.device("cpu" if device is None else device)
    full = configs.get_arch

    def get_arch(name):
        if name.endswith("-smoke"):
            return full(name)
        return dataclasses.replace(full(name).reduced(), remat="full")
    configs.get_arch = get_arch
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache",
                 "set_device"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.Event = CPUEvent
    # the H100's 132 SMs, which the flash backward's timing reads
    torch.cuda.get_device_properties = lambda *a, **k: \
        types.SimpleNamespace(multi_processor_count=132)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0

    path = os.path.join(ROOT, "chip_smoke.py")
    with open(path) as f:
        src = f.read().replace('"cuda"', '"cpu"').replace(
            ".cuda()", ".cpu()").replace('"nccl"', '"gloo"')
    ns = {"__name__": "chip_smoke_cpu", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    ns["cuda_ms"] = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
    ns["profile_ms"] = lambda fn, host_ops=True: (fn(), (1.0, 0.0, [], {}))[1]
    ns["time_expert_bwd"] = lambda: ([], lambda: None)
    ns.update(PROMPT_LEN=40, GEN=4, ENCODE_BATCH=2, TRAIN_SEQ=64,
              PIPELINE_REAL=dict(n_samples=2, rows_per_sample=8,
                                 seq_len=64, train_steps=3, batch=4,
                                 vocab=512, d_model=64),
              PIPE_CONSIST=dict(vocab=512, d_model=64, rows=8, seq=64,
                                steps=4, batch=4, chain=1),
              # past the -smoke configs' window of 64 (h2o's prompts keep
              # their 5000 tokens)
              SWA_CONSIST_SEQ=72, CPU_CHECK_SEQ=16)
    ns["GMM_BWD_CASES"] = [
        ("granite-train", 8, 48, 64, 32, "swiglu", True, 96),
        ("ragged-36", 4, 36, 64, 128, "swiglu", True, None),
        ("odd-d-f", 3, 20, 21, 33, "geglu", True, None),
        ("relu2-no-w3", 6, 30, 40, 24, "relu2", False, None),
        ("nan-pads", 5, 30, 40, 24, "swiglu", True, None)]
    return ns


# the rehearsal's documents: phase 39 cancels a run after 8 completed
# invocations and phase 40 crashes one after 12, so the smaller has 6
# samples (20 invocations)
SMALL_DOC = dict(n_samples=6, rows_per_sample=8, seq_len=32)


def engine_results(cs, *sizes):
    """(phase 25's, phase 38's result, the document) at each size."""
    out = []
    for args in sizes:
        doc = pipeline.streamflow_doc_declarative_hybrid(**args)
        hand = cs["phase_pipeline"]("the port's hybrid document", doc)
        out.append((hand, cs["phase_pipeline_engine"](
            "the port's hybrid document", doc, hand, profile=False), doc))
    return out


def rehearse_service(cs):
    (hand, own, doc_own), (_, real, doc_real) = engine_results(
        cs, SMALL_DOC, cs["PIPELINE_REAL"])
    return cs["phase_pipeline_service"](own, real, hand, doc_own, doc_real)


def rehearse_recovery(cs):
    (_, own, doc_own), = engine_results(cs, SMALL_DOC)
    return cs["phase_pipeline_recovery"](own, doc_own)


def rehearse_recurrent(cs):
    """Phase 44 after the serves it reuses, as main() orders them."""
    cfg, params = cs["phase_serve"](cs["GRIFFIN_ARCH"])[:2]
    cs["phase_recurrent_sharded"](cfg, params)
    cfg, params = cs["phase_serve"](
        cs["XLSTM_ARCH"], n_layers=cs["XLSTM_SERVE_LAYERS"])[:2]
    cs["phase_recurrent_sharded"](cfg, params, cs["XLSTM_MESH_LAYERS"])
    return cs["phase_recurrent_sharded_train"]()


def rehearse_modal(cs):
    """Phase 45 after the vision serve it reuses, as main() orders them."""
    cfg, params = cs["phase_serve_vision"]()[:2]
    cs["phase_vision_sharded"](cfg, params)
    return cs["phase_audio_sharded"]()


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or list(PHASES)
    unknown = sorted(set(which) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; known: {PHASES}")
    cs = load_chip_smoke()
    runs = {
        "serve-vision": lambda: cs["phase_serve_vision"](),
        "consistency-vision": lambda: cs["phase_consistency_vision"](
            seq=32),
        "train-audio": lambda: cs["phase_train"](
            cs["AUDIO_ARCH"], seq=cs["TRAIN_SEQ"], profile=False,
            extra=cs["time_encode"]),
        "train-consistency-audio": lambda: cs["phase_train_consistency"](
            cs["AUDIO_ARCH"], cs["AUDIO_CONSIST_LAYERS"], 32),
        "train-consistency": lambda: cs["phase_train_consistency"](
            cs["ARCH"], cs["CONSIST_LAYERS"], 32),
        "kernel-bwd-moe": lambda: cs["phase_kernel_moe_bwd"](),
        "train-moe": lambda: cs["phase_train_moe_dispatches"](),
        "train-moe-full": lambda: cs["phase_train_moe_full"](),
        "train-consistency-moe": lambda: cs["phase_train_consistency"](
            cs["MOE_ARCH"], cs["MOE_CONSIST_LAYERS"], 32,
            tol=cs["MOE_TRAIN_RTOL"], moe_dispatch="gather"),
        "pipeline": lambda: [cs["phase_pipeline"](
            "the port's hybrid document", doc) for doc in (
                pipeline.streamflow_doc_declarative_hybrid(
                    n_samples=3, rows_per_sample=8, seq_len=32),
                pipeline.streamflow_doc_declarative_hybrid(
                    **cs["PIPELINE_REAL"]))],
        "pipeline-consistency": lambda: cs["phase_pipeline_consistency"](),
        "pipeline-engine": lambda: [cs["phase_pipeline_engine"](
            "the port's hybrid document", doc(), cs["phase_pipeline"](
                "the port's hybrid document", doc()), profile=True)
            for doc in (
                lambda: pipeline.streamflow_doc_declarative_hybrid(
                    n_samples=3, rows_per_sample=8, seq_len=32),
                lambda: pipeline.streamflow_doc_declarative_hybrid(
                    **cs["PIPELINE_REAL"]))],
        "pipeline-service": lambda: rehearse_service(cs),
        "pipeline-recovery": lambda: rehearse_recovery(cs),
        "zoo": lambda: cs["phase_zoo"](),
        "train-compressed": lambda: cs["phase_train_compressed"](),
        "train-driver": lambda: cs["phase_train_driver"](),
        "sharded-serve": lambda: cs["phase_serve_sharded"](
            *cs["phase_serve"](cs["ARCH"])[:2]),
        "sharded-train": lambda: cs["phase_train_sharded"](),
        "sharded-moe": lambda: cs["phase_moe_sharded"](*cs["phase_serve"](
            cs["MOE_ARCH"], moe_dispatch="gather")[:2]),
        "sharded-recurrent": lambda: rehearse_recurrent(cs),
        "sharded-modal": lambda: rehearse_modal(cs),
        "dryrun": lambda: cs["phase_dryrun"](
            "CPU rehearsal", cs["phase_train"](
                seq=cs["TRAIN_SEQ"], profile=False)[2]),
    }
    t0 = time.perf_counter()
    for name in which:
        runs[name]()
    print(f"rehearsed {', '.join(which)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
