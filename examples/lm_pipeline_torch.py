"""LM production pipeline through the port's StreamFlow engine (the twin of
``lm_pipeline.py``): the paper's hybrid pattern applied to an ML lifecycle.

    /tokenize   (cloud)  corpus -> packed token shards
    /pretrain   (HPC)    training on the mesh site's device
    /eval       (cloud)  held-out perplexity from the trained params
    /export     (cloud)  int8-quantized parameter package

The trained parameters cross the HPC->cloud boundary once (two-step copy);
eval and export then stay cloud-local (R4 keeps the params in place).  The
HPC site is a ``mesh`` connector: its step trains on the device the site
hands it (``ctx["device"]``), the GPU unless ``--device`` says otherwise;
the cloud steps compute on the same device.

    PYTHONPATH=src python examples/lm_pipeline_torch.py
    PYTHONPATH=src python examples/lm_pipeline_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.convert import (flatten_with_paths,  # noqa: E402
                                 params_from_jax, params_to_jax)
from repro_torch.core import (Binding, ModelSpec, Step,  # noqa: E402
                              StreamFlowExecutor, Workflow)
from repro_torch.data.synthetic import (SyntheticCorpus,  # noqa: E402
                                        pack_documents)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import (make_eval_step,  # noqa: E402
                                      make_train_step)
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.compression import quantize_int8  # noqa: E402
from repro_torch.pipeline import tiny_lm  # noqa: E402

CFG = tiny_lm(vocab=512, d_model=64, n_layers=2)
STEPS, BATCH = 30, 8


def tokenize(inputs, ctx):
    corpus = SyntheticCorpus(CFG.vocab_size, seed=int(inputs["seed"]))
    it = corpus.documents(0)
    return {"train_shard": pack_documents(it, 128, 64),
            "eval_shard": pack_documents(it, 128, 16)}


def pretrain(inputs, ctx):
    device = ctx["device"]              # the mesh site's device
    shard = inputs["shard"]
    params = R.init_params(CFG, seed=0, param_dtype=torch.float32,
                           device=device)
    step = make_train_step(CFG, AdamWConfig(lr=1e-3, warmup_steps=5,
                                            total_steps=STEPS),
                           device=device)
    opt = adamw_init(params)
    losses = []
    for s in range(STEPS):
        lo = (s * BATCH) % (shard.shape[0] - BATCH)
        blk = torch.as_tensor(shard[lo:lo + BATCH], device=device)
        params, opt, metrics = step(params, opt, {"tokens": blk[:, :-1],
                                                  "labels": blk[:, 1:]})
        losses.append(float(metrics["loss"]))
    return {"trained_params": params_to_jax(CFG, params),
            "train_log": {"losses": losses}}


def make_evaluate(device):
    def evaluate(inputs, ctx):
        params = params_from_jax(CFG, inputs["params"], device=device)
        tokens = torch.as_tensor(inputs["shard"], device=device)
        m = make_eval_step(CFG, device=device)(
            params, {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]})
        nll = float(m["nll"])
        return {"eval_report": {"nll": nll,
                                "ppl": float(np.exp(min(nll, 20.0))),
                                "acc": float(m["acc"])}}
    return evaluate


def make_export(device):
    def export(inputs, ctx):
        package = {}
        for key, leaf in flatten_with_paths(inputs["params"]).items():
            q, scale = quantize_int8(torch.as_tensor(leaf, device=device))
            package[key] = {"int8": q.cpu().numpy(), "scale": float(scale)}
        nbytes = sum(v["int8"].nbytes for v in package.values())
        return {"package": {"n_tensors": len(package),
                            "int8_bytes": nbytes}}
    return export


def build_workflow(device=None):
    device = resolve_device(device)
    wf = Workflow("lm-pipeline")
    wf.add_step(Step("/tokenize", tokenize, {"seed": "seed"},
                     ("train_shard", "eval_shard")))
    wf.add_step(Step("/pretrain", pretrain, {"shard": "train_shard"},
                     ("trained_params", "train_log")))
    wf.add_step(Step("/eval", make_evaluate(device),
                     {"params": "trained_params", "shard": "eval_shard"},
                     ("eval_report",)))
    wf.add_step(Step("/export", make_export(device),
                     {"params": "trained_params"}, ("package",)))
    wf.validate()
    return wf


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda")
    args = ap.parse_args(argv)
    hpc = {"topology": {"data": 16, "model": 16},
           "services": {"trainer": {"replicas": 1, "cores": 4,
                                    "memory_gb": 16}}}
    if args.device is not None:
        hpc["device"] = args.device
    models = {
        "hpc": ModelSpec("hpc", "mesh", hpc),
        "cloud": ModelSpec("cloud", "local", {
            "services": {"worker": {"replicas": 2}}}),
    }
    bindings = [
        Binding("/", "cloud", "worker"),
        Binding("/pretrain", "hpc", "trainer"),
    ]
    ex = StreamFlowExecutor(models)
    res = ex.run(build_workflow(args.device), bindings, inputs={"seed": 0})

    log = res.outputs["train_log"]["losses"]
    rep = res.outputs["eval_report"]
    pkg = res.outputs["package"]
    transfers = {k: (int(v["n"]), int(v["bytes"]))
                 for k, v in ex.data.transfer_summary().items()}
    print(f"\n[pipeline] train loss {log[0]:.3f} -> {log[-1]:.3f}")
    print(f"[pipeline] eval nll={rep['nll']:.3f} ppl={rep['ppl']:.1f} "
          f"acc={rep['acc']:.3f}")
    print(f"[pipeline] exported {pkg['n_tensors']} tensors, "
          f"{pkg['int8_bytes']:,} int8 bytes")
    print("[pipeline] transfers:", transfers)
    if not log[-1] < log[0]:
        raise SystemExit(f"training did not improve: {log[0]} -> {log[-1]}")
    return res, transfers


if __name__ == "__main__":
    main()
