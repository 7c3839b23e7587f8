"""The compute of the paper's single-cell workflow (§5, Fig. 7) on the port:
the step bodies and tool factories of ``repro/configs/paper_pipeline.py``,
under the same names, in PyTorch.

Structure (one splitter fanning out to independent chains):

  mkfastq  -> token shards                     (numpy)
  count    -> a trained tiny LM + its losses   (``make_train_step``: the
                                                flash kernel's forward and
                                                backward on the GPU)
  seurat   -> per-document embeddings, k-means (``forward_logits``: the
                                                flash forward)
  singler  -> cluster labels                   (numpy)
  aggregate-> one summary over the samples     (numpy)

A step body is ``fn(inputs, ctx) -> outputs`` with numpy in and out; the
only thing a body reads from ``ctx`` is the scatter tag
(``ctx.get("tag", (0,))``).  So the StreamFlow engine runs these bodies as
they are: its declarative frontend imports a tool's factory by module and
name and merges a step's ``args`` over the tool's, and
``streamflow_doc_declarative_hybrid`` / ``_chains`` here are the JAX
package's documents with ``implementation.module`` naming this module.
The Python workflow builders (``build_workflow``,
``build_scatter_workflow``) make the port's own engine objects
(``repro_torch.core``), so a document whose ``type: python`` workflow
names this module runs on the port's engine: ``streamflow_doc_full_hpc``
(Fig. 8), ``_single_service``, ``_scatter_hybrid`` and ``_hybrid``
(Fig. 9) are the JAX package's documents of those names that do so.

The count step emits its model in the JAX package's layout
(``convert.params_to_jax``, numpy), so either package's seurat step reads
either package's count step.  The factories that compute take ``device``:
``None`` means the GPU, and raises without one (``resolve_device``).
``jax.random.key(chain)`` cannot be drawn in torch: the count step's init
is ``init_params(cfg, seed=chain)``, and parity with the JAX step is held
from a converted init through :func:`train_shard`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.core.workflow import Requirements, Step, Workflow
from repro_torch.data.synthetic import SyntheticCorpus, pack_documents
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry as R
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWConfig, adamw_init

MODULE = "repro_torch.pipeline"


def tiny_lm(vocab: int = 512, d_model: int = 64, n_layers: int = 2
            ) -> ArchConfig:
    return ArchConfig(
        name="pipeline-lm", family="dense", n_layers=n_layers,
        d_model=d_model, n_heads=4, n_kv_heads=4, d_ff=2 * d_model,
        vocab_size=vocab, remat="none")


# ---------------------------------------------------------------------------
# Step bodies (fn(inputs, ctx) -> outputs)
# ---------------------------------------------------------------------------

def _split_fn(n_chains: int, rows_per_chain: int, seq_len: int, vocab: int):
    def fn(inputs: Dict, ctx) -> Dict:
        corpus = SyntheticCorpus(vocab, seed=int(inputs["seed"]))
        out = {}
        it = corpus.documents(0)
        for i in range(n_chains):
            out[f"shard{i}"] = pack_documents(it, seq_len, rows_per_chain)
        return out
    return fn


def init_model(cfg: ArchConfig, chain: int, device=None):
    """The count step's initial weights: float32 masters from seed
    ``chain`` on ``device``."""
    return R.init_params(cfg, seed=chain, param_dtype=torch.float32,
                         device=resolve_device(device))


def train_shard(params, shard: np.ndarray, cfg: ArchConfig,
                train_steps: int, batch: int, device=None, cancel=None
                ) -> Tuple[dict, List[float]]:
    """The count step's training: ``train_steps`` AdamW steps (lr 1e-3,
    5 warmup steps, cosine over ``train_steps``) on windows of ``batch``
    rows of ``shard`` ((rows, seq + 1) int32), as the reference's
    ``_jitted_train_step`` runs them.  Updates ``params`` in place; returns
    them and the per-step losses.  ``cancel``: the invocation's cancel
    event (``threading.Event``), read before each step: once it is set the
    training raises instead of launching the next step."""
    device = resolve_device(device)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=train_steps,
                       schedule="cosine")
    step = make_train_step(cfg, ocfg, device=device)
    opt = adamw_init(params)
    losses = []
    rows = shard.shape[0]
    for s in range(train_steps):
        if cancel is not None and cancel.is_set():
            raise RuntimeError(f"training cancelled after {s} of "
                               f"{train_steps} steps")
        lo = (s * batch) % max(rows - batch, 1)
        blk = torch.as_tensor(shard[lo: lo + batch], device=device)
        params, opt, metrics = step(
            params, opt, {"tokens": blk[:, :-1], "labels": blk[:, 1:]})
        losses.append(float(metrics["loss"]))
    return params, losses


def _count_fn(chain: int, cfg: ArchConfig, train_steps: int, batch: int,
              device=None):
    def fn(inputs: Dict, ctx) -> Dict:
        params = init_model(cfg, chain, device)
        # the executor's cancel event for this invocation, where it runs one
        cancel = ((ctx or {}).get("environment") or {}).get("__cancel__")
        params, losses = train_shard(params, inputs["shard"], cfg,
                                     train_steps, batch, device, cancel)
        return {f"model{chain}": params_to_jax(cfg, params),
                f"stats{chain}": {"losses": losses}}
    return fn


def embed_shard(params, shard: np.ndarray, cfg: ArchConfig, device=None
                ) -> np.ndarray:
    """Each row's mean logits over its positions, in float32: the seurat
    step's embeddings ((rows, vocab) numpy)."""
    device = resolve_device(device)
    with torch.inference_mode():
        tokens = torch.as_tensor(shard[:, :-1], device=device)
        logits = R.forward_logits(params, cfg, {"tokens": tokens},
                                  device=device)
        return torch.mean(logits, dim=1, dtype=torch.float32).cpu().numpy()


def _seurat_fn(chain: int, cfg: ArchConfig, n_clusters: int = 4,
               device=None):
    def fn(inputs: Dict, ctx) -> Dict:
        params = params_from_jax(cfg, inputs["model"],
                                 device=resolve_device(device))
        embs = embed_shard(params, inputs["shard"], cfg, device)
        # k-means (the Louvain/clustering stand-in), deterministic init
        rng = np.random.default_rng(chain)
        cent = embs[rng.choice(len(embs), n_clusters, replace=False)]
        for _ in range(8):
            d = ((embs[:, None] - cent[None]) ** 2).sum(-1)
            assign = d.argmin(1)
            for k in range(n_clusters):
                pts = embs[assign == k]
                if len(pts):
                    cent[k] = pts.mean(0)
        return {f"clusters{chain}": {"assign": assign.astype(np.int32),
                                     "centroids": cent,
                                     "embeddings": embs}}
    return fn


def _singler_fn(chain: int, n_types: int = 6):
    def fn(inputs: Dict, ctx) -> Dict:
        cl = inputs["clusters"]
        cent = cl["centroids"]
        rng = np.random.default_rng(1234)          # the reference database
        ref = rng.standard_normal((n_types, cent.shape[1])).astype(np.float32)

        # Spearman-ish: rank-correlate centroids against reference profiles
        def ranks(x):
            return np.argsort(np.argsort(x, axis=-1), axis=-1) \
                .astype(np.float32)
        rc, rr = ranks(cent), ranks(ref)
        rc = (rc - rc.mean(-1, keepdims=True))
        rr = (rr - rr.mean(-1, keepdims=True))
        corr = (rc @ rr.T) / (
            np.linalg.norm(rc, axis=-1, keepdims=True)
            * np.linalg.norm(rr, axis=-1).clip(1e-9))
        labels = corr.argmax(-1).astype(np.int32)
        return {f"labels{chain}": {"cluster_types": labels,
                                   "confidence": corr.max(-1)}}
    return fn


# ---------------------------------------------------------------------------
# The scatter variant: one declared chain, the tag picks the sample
# ---------------------------------------------------------------------------

def _split_stream_fn(n_samples: int, rows_per_sample: int, seq_len: int,
                     vocab: int):
    def fn(inputs: Dict, ctx) -> Dict:
        corpus = SyntheticCorpus(vocab, seed=int(inputs["seed"]))
        it = corpus.documents(0)
        return {"shard": [pack_documents(it, seq_len, rows_per_sample)
                          for _ in range(n_samples)]}
    return fn


def _count_stream_fn(cfg: ArchConfig, train_steps: int, batch: int,
                     device=None):
    def fn(inputs: Dict, ctx) -> Dict:
        i = ctx.get("tag", (0,))[0]             # scatter coordinate
        out = _count_fn(i, cfg, train_steps, batch, device)(inputs, ctx)
        return {"model": out[f"model{i}"], "stats": out[f"stats{i}"]}
    return fn


def _seurat_stream_fn(cfg: ArchConfig, n_clusters: int = 4, device=None):
    def fn(inputs: Dict, ctx) -> Dict:
        i = ctx.get("tag", (0,))[0]
        out = _seurat_fn(i, cfg, n_clusters, device)(inputs, ctx)
        return {"clusters": out[f"clusters{i}"]}
    return fn


def _singler_stream_fn(n_types: int = 6):
    def fn(inputs: Dict, ctx) -> Dict:
        i = ctx.get("tag", (0,))[0]
        out = _singler_fn(i, n_types)(inputs, ctx)
        return {"labels": out[f"labels{i}"]}
    return fn


def _aggregate_fn():
    def fn(inputs: Dict, ctx) -> Dict:
        labels = inputs["labels"]               # gathered: tag-ordered list
        types = np.concatenate([lab["cluster_types"] for lab in labels])
        conf = np.concatenate([lab["confidence"] for lab in labels])
        return {"summary": {
            "n_samples": len(labels),
            "type_counts": np.bincount(types).astype(np.int64),
            "mean_confidence": float(conf.mean())}}
    return fn


# ---------------------------------------------------------------------------
# Workflow builders (referenced from StreamFlow files' python workflows):
# the JAX package's, on the port's engine objects and bodies
# ---------------------------------------------------------------------------

def build_workflow(n_chains: int = 6, rows_per_chain: int = 32,
                   seq_len: int = 128, train_steps: int = 6,
                   batch: int = 8, vocab: int = 512, d_model: int = 64,
                   device: Optional[str] = None) -> Workflow:
    """The hand-unrolled pipeline: one splitter, then ``n_chains`` chains
    of count, seurat and singler steps."""
    cfg = tiny_lm(vocab=vocab, d_model=d_model)
    wf = Workflow("single-cell")
    wf.add_step(Step(
        path="/mkfastq",
        fn=_split_fn(n_chains, rows_per_chain, seq_len, vocab),
        inputs={"seed": "seed"},
        outputs=tuple(f"shard{i}" for i in range(n_chains)),
        requirements=Requirements(cores=1, memory_gb=1),
    ))
    for i in range(n_chains):
        wf.add_step(Step(
            path=f"/chains/{i}/count",
            fn=_count_fn(i, cfg, train_steps, batch, device),
            inputs={"shard": f"shard{i}"},
            outputs=(f"model{i}", f"stats{i}"),
            requirements=Requirements(cores=1, memory_gb=2),
        ))
        wf.add_step(Step(
            path=f"/chains/{i}/seurat",
            fn=_seurat_fn(i, cfg, device=device),
            inputs={"shard": f"shard{i}", "model": f"model{i}"},
            outputs=(f"clusters{i}",),
            requirements=Requirements(cores=1, memory_gb=2),
        ))
        wf.add_step(Step(
            path=f"/chains/{i}/singler",
            fn=_singler_fn(i),
            inputs={"clusters": f"clusters{i}"},
            outputs=(f"labels{i}",),
            requirements=Requirements(cores=1, memory_gb=1),
        ))
    wf.validate()
    return wf


def build_scatter_workflow(n_samples: int = 32, rows_per_sample: int = 12,
                           seq_len: int = 64, train_steps: int = 2,
                           batch: int = 4, vocab: int = 256,
                           d_model: int = 48, declare_scatter: bool = True,
                           device: Optional[str] = None) -> Workflow:
    """The pipeline as a 5-step scatter/gather graph: ``/mkfastq`` emits a
    ``shard`` stream of ``n_samples`` tokens, the three per-sample steps
    scatter over their stream slots and ``/aggregate`` gathers ``labels``.
    With ``declare_scatter=False`` the steps carry only the stream widths
    and the StreamFlow file's ``scatter:`` block declares the rest."""
    cfg = tiny_lm(vocab=vocab, d_model=d_model)
    dec = (lambda *slots: tuple(slots)) if declare_scatter \
        else (lambda *slots: ())
    wf = Workflow("single-cell-scatter")
    wf.add_step(Step(
        path="/mkfastq",
        fn=_split_stream_fn(n_samples, rows_per_sample, seq_len, vocab),
        inputs={"seed": "seed"},
        outputs=("shard",), streams={"shard": n_samples},
        requirements=Requirements(cores=1, memory_gb=1)))
    wf.add_step(Step(
        path="/count", fn=_count_stream_fn(cfg, train_steps, batch, device),
        inputs={"shard": "shard"}, outputs=("model", "stats"),
        scatter=dec("shard"),
        requirements=Requirements(cores=1, memory_gb=2)))
    wf.add_step(Step(
        path="/seurat", fn=_seurat_stream_fn(cfg, device=device),
        inputs={"shard": "shard", "model": "model"},
        outputs=("clusters",), scatter=dec("shard", "model"),
        requirements=Requirements(cores=1, memory_gb=2)))
    wf.add_step(Step(
        path="/singler", fn=_singler_stream_fn(),
        inputs={"clusters": "clusters"}, outputs=("labels",),
        scatter=dec("clusters"),
        requirements=Requirements(cores=1, memory_gb=1)))
    wf.add_step(Step(
        path="/aggregate", fn=_aggregate_fn(),
        inputs={"labels": "labels"}, outputs=("summary",),
        gather=dec("labels"),
        requirements=Requirements(cores=1, memory_gb=1)))
    wf.validate()
    return wf


# ---------------------------------------------------------------------------
# Tool implementation factories for the declarative frontend (a tool's
# implementation: {module: repro_torch.pipeline, factory: ...}); the same
# arguments as the JAX package's, plus ``device`` where they compute
# ---------------------------------------------------------------------------

def mkfastq_tool(n_samples: int = 32, rows_per_sample: int = 12,
                 seq_len: int = 64, vocab: int = 256):
    """Stream splitter: emits the ``shard`` stream (scatter variant)."""
    return _split_stream_fn(n_samples, rows_per_sample, seq_len, vocab)


def count_tool(train_steps: int = 2, batch: int = 4, vocab: int = 256,
               d_model: int = 48, device=None):
    """Per-shard trainer keyed by the scatter tag (scatter variant)."""
    return _count_stream_fn(tiny_lm(vocab=vocab, d_model=d_model),
                            train_steps, batch, device)


def seurat_tool(vocab: int = 256, d_model: int = 48, n_clusters: int = 4,
                device=None):
    return _seurat_stream_fn(tiny_lm(vocab=vocab, d_model=d_model),
                             n_clusters, device)


def singler_tool(n_types: int = 6):
    return _singler_stream_fn(n_types)


def aggregate_tool():
    return _aggregate_fn()


def mkfastq_chains_tool(n_chains: int = 6, rows_per_chain: int = 32,
                        seq_len: int = 128, vocab: int = 512):
    """Scalar-variant splitter: one ``shard<i>`` output per chain."""
    return _split_fn(n_chains, rows_per_chain, seq_len, vocab)


def count_chain_tool(chain: int = 0, train_steps: int = 6, batch: int = 8,
                     vocab: int = 512, d_model: int = 64, device=None):
    """Scalar-variant trainer: the chain index arrives as a step-level
    ``args: {chain: i}`` override instead of a scatter tag."""
    inner = _count_fn(chain, tiny_lm(vocab=vocab, d_model=d_model),
                      train_steps, batch, device)

    def fn(inputs: Dict, ctx) -> Dict:
        out = inner(inputs, ctx)
        return {"model": out[f"model{chain}"], "stats": out[f"stats{chain}"]}
    return fn


def seurat_chain_tool(chain: int = 0, vocab: int = 512, d_model: int = 64,
                      n_clusters: int = 4, device=None):
    inner = _seurat_fn(chain, tiny_lm(vocab=vocab, d_model=d_model),
                       n_clusters, device)

    def fn(inputs: Dict, ctx) -> Dict:
        return {"clusters": inner(inputs, ctx)[f"clusters{chain}"]}
    return fn


def singler_chain_tool(chain: int = 0, n_types: int = 6):
    inner = _singler_fn(chain, n_types)

    def fn(inputs: Dict, ctx) -> Dict:
        return {"labels": inner(inputs, ctx)[f"labels{chain}"]}
    return fn


# ---------------------------------------------------------------------------
# The JAX package's StreamFlow documents, naming this module's builders and
# tools; the mesh site's steps run on the GPU unless its config says
# ``device`` (the tests and examples set ``cpu`` there)
# ---------------------------------------------------------------------------

def _device_args(device: Optional[str]) -> dict:
    return {} if device is None else {"device": device}


def streamflow_doc_full_hpc(n_chains: int = 6, **wf_args) -> dict:
    """Fig. 8: everything on one HPC site (six nodes, both containers).
    ``wf_args`` go to ``build_workflow`` (``device`` among them)."""
    args = {"n_chains": n_chains, **wf_args}
    return {
        "version": "v1.0",
        "models": {
            "occam": {"type": "mesh", "config": {
                "topology": {"data": 16, "model": 16},
                "shared_store": True,            # /archive + /scratch
                "services": {
                    "cellranger": {"replicas": n_chains, "cores": 2,
                                   "memory_gb": 8},
                    "r_env": {"replicas": n_chains, "cores": 2,
                              "memory_gb": 8},
                }}},
        },
        "workflows": {
            "single-cell": {
                "type": "python",
                "config": {"module": MODULE,
                           "builder": "build_workflow", "args": args},
                "bindings": [
                    {"step": "/mkfastq",
                     "target": {"model": "occam", "service": "cellranger"}},
                    {"step": "/chains",
                     "target": {"model": "occam", "service": "r_env"}},
                    # deepest-path-wins: counts go to cellranger
                    *[{"step": f"/chains/{i}/count",
                       "target": {"model": "occam", "service": "cellranger"}}
                      for i in range(n_chains)],
                ],
            }
        },
        "scheduling": {"policy": "data_locality"},
    }


def streamflow_doc_single_service(n_chains: int = 6, **wf_args) -> dict:
    """Scheduler-bench topology: ONE pool of identical nodes with private
    stores, every step bound to it, so placement is the policy's choice
    alone."""
    args = {"n_chains": n_chains, **wf_args}
    return {
        "version": "v1.0",
        "models": {
            "pool": {"type": "local", "config": {
                "shared_store": False,
                "services": {"node": {"replicas": n_chains, "cores": 2,
                                      "memory_gb": 8}}}},
        },
        "workflows": {
            "single-cell": {
                "type": "python",
                "config": {"module": MODULE,
                           "builder": "build_workflow", "args": args},
                "bindings": [
                    {"step": "/",
                     "target": {"model": "pool", "service": "node"}},
                ],
            }
        },
        "scheduling": {"policy": "data_locality"},
    }


def streamflow_doc_scatter_hybrid(n_samples: int = 32,
                                  hpc_replicas: int = 8,
                                  cloud_replicas: int = 8,
                                  policy: str = "data_locality",
                                  **wf_args) -> dict:
    """Fig. 9 at its true width, scatter-style: ``build_scatter_workflow``
    (one declared chain expanded into ``n_samples`` invocations at run
    time) with the ``scatter:`` block of the workflow config and a
    ``/count`` binding that lists both sites, so each count invocation is
    placed on its own.  Plan-identical to
    ``streamflow_doc_declarative_hybrid``."""
    args = {"n_samples": n_samples, **wf_args}
    return {
        "version": "v1.0",
        "models": {
            "occam": {"type": "mesh", "config": {
                "topology": {"data": 16, "model": 16},
                "shared_store": True,
                "services": {"cellranger": {"replicas": hpc_replicas,
                                            "cores": 2, "memory_gb": 8}}}},
            "garr_cloud": {"type": "local", "config": {
                "services": {"r_env": {"replicas": cloud_replicas,
                                       "cores": 1, "memory_gb": 4}}}},
        },
        "workflows": {
            "single-cell": {
                "type": "python",
                "config": {"module": MODULE,
                           "builder": "build_scatter_workflow",
                           "args": args},
                "scatter": [
                    {"step": "/count", "over": ["shard"]},
                    {"step": "/seurat", "over": ["shard", "model"]},
                    {"step": "/singler", "over": ["clusters"]},
                    {"step": "/aggregate", "gather": ["labels"]},
                ],
                "bindings": [
                    {"step": "/mkfastq",
                     "target": {"model": "occam", "service": "cellranger"}},
                    {"step": "/count", "targets": [
                        {"model": "occam", "service": "cellranger"},
                        {"model": "garr_cloud", "service": "r_env"}]},
                    {"step": "/",
                     "target": {"model": "garr_cloud",
                                "service": "r_env"}},
                ],
            }
        },
        "scheduling": {"policy": policy},
        "topology": {
            "routing": "direct",
            "management": {"latency_s": 0.05, "bandwidth_mbps": 200},
            "links": [{"source": "occam", "target": "garr_cloud",
                       "latency_s": 0.005, "bandwidth_mbps": 2000}],
        },
    }


def streamflow_doc_hybrid(n_chains: int = 6, **wf_args) -> dict:
    """Fig. 9: CellRanger steps on the HPC site, R steps on the cloud site,
    two models with NO shared data space (two-step copies between them)."""
    args = {"n_chains": n_chains, **wf_args}
    return {
        "version": "v1.0",
        "models": {
            "occam": {"type": "mesh", "config": {
                "topology": {"data": 16, "model": 16},
                "shared_store": True,
                "services": {"cellranger": {"replicas": n_chains,
                                            "cores": 2, "memory_gb": 8}}}},
            "garr_cloud": {"type": "local", "config": {
                "services": {"r_env": {"replicas": n_chains, "cores": 1,
                                       "memory_gb": 4}}}},
        },
        "workflows": {
            "single-cell": {
                "type": "python",
                "config": {"module": MODULE,
                           "builder": "build_workflow", "args": args},
                "bindings": [
                    {"step": "/mkfastq",
                     "target": {"model": "occam", "service": "cellranger"}},
                    *[{"step": f"/chains/{i}/count",
                       "target": {"model": "occam", "service": "cellranger"}}
                      for i in range(n_chains)],
                    {"step": "/chains",
                     "target": {"model": "garr_cloud", "service": "r_env"}},
                ],
            }
        },
        "scheduling": {"policy": "data_locality"},
    }


def streamflow_doc_declarative_hybrid(n_samples: int = 32,
                                      hpc_replicas: int = 8,
                                      cloud_replicas: int = 8,
                                      policy: str = "data_locality",
                                      rows_per_sample: int = 12,
                                      seq_len: int = 64,
                                      train_steps: int = 2,
                                      batch: int = 4, vocab: int = 256,
                                      d_model: int = 48,
                                      device: Optional[str] = None) -> dict:
    """The §5 pipeline at its true width, scatter-style, through
    ``tools:`` and ``steps:`` alone: the JAX package's document of this
    name with its tools implemented here; ``device`` (None: the GPU) goes
    into the count and seurat tools' args."""
    lm = {"vocab": vocab, "d_model": d_model}
    dev = _device_args(device)
    return {
        "version": "v1.0",
        "models": {
            "occam": {"type": "mesh", "config": {
                "topology": {"data": 16, "model": 16},
                "shared_store": True,
                "services": {"cellranger": {"replicas": hpc_replicas,
                                            "cores": 2, "memory_gb": 8}}}},
            "garr_cloud": {"type": "local", "config": {
                "services": {"r_env": {"replicas": cloud_replicas,
                                       "cores": 1, "memory_gb": 4}}}},
        },
        "tools": {
            "mkfastq": {
                "command": "cellranger mkfastq --seed {seed}",
                "inputs": {"seed": "int"},
                "outputs": {"shard": "record"},
                "requirements": {"cores": 1, "memory_gb": 1},
                "implementation": {
                    "module": MODULE, "factory": "mkfastq_tool",
                    "args": {"n_samples": n_samples,
                             "rows_per_sample": rows_per_sample,
                             "seq_len": seq_len, "vocab": vocab}}},
            "count": {
                "command": "cellranger count --fastq {shard}",
                "inputs": {"shard": "record"},
                "outputs": {"model": "record", "stats": "record"},
                "requirements": {"cores": 1, "memory_gb": 2},
                "implementation": {
                    "module": MODULE, "factory": "count_tool",
                    "args": {"train_steps": train_steps, "batch": batch,
                             **lm, **dev}}},
            "seurat": {
                "command": "Rscript seurat.R {shard} {model}",
                "inputs": {"shard": "record", "model": "record"},
                "outputs": {"clusters": "record"},
                "requirements": {"cores": 1, "memory_gb": 2},
                "implementation": {
                    "module": MODULE, "factory": "seurat_tool",
                    "args": {**lm, **dev}}},
            "singler": {
                "command": "Rscript singler.R {clusters}",
                "inputs": {"clusters": "record"},
                "outputs": {"labels": "record"},
                "requirements": {"cores": 1, "memory_gb": 1},
                "implementation": {
                    "module": MODULE, "factory": "singler_tool"}},
            "aggregate": {
                "inputs": {"labels": "array<record>"},
                "outputs": {"summary": "record"},
                "requirements": {"cores": 1, "memory_gb": 1},
                "implementation": {
                    "module": MODULE, "factory": "aggregate_tool"}},
        },
        "workflows": {
            "single-cell-scatter": {
                "type": "declarative",
                "inputs": {"seed": "int"},
                "steps": {
                    "/mkfastq": {"tool": "mkfastq", "in": {"seed": "seed"},
                                 "streams": {"shard": n_samples}},
                    "/count": {"tool": "count", "in": {"shard": "shard"},
                               "scatter": ["shard"]},
                    "/seurat": {"tool": "seurat",
                                "in": {"shard": "shard", "model": "model"},
                                "scatter": ["shard", "model"]},
                    "/singler": {"tool": "singler",
                                 "in": {"clusters": "clusters"},
                                 "scatter": ["clusters"]},
                    "/aggregate": {"tool": "aggregate",
                                   "in": {"labels": "labels"},
                                   "gather": ["labels"]},
                },
                "bindings": [
                    {"step": "/mkfastq",
                     "target": {"model": "occam", "service": "cellranger"}},
                    {"step": "/count", "targets": [
                        {"model": "occam", "service": "cellranger"},
                        {"model": "garr_cloud", "service": "r_env"}]},
                    {"step": "/",
                     "target": {"model": "garr_cloud",
                                "service": "r_env"}},
                ],
            }
        },
        "scheduling": {"policy": policy},
        "topology": {
            "routing": "direct",
            "management": {"latency_s": 0.05, "bandwidth_mbps": 200},
            "links": [{"source": "occam", "target": "garr_cloud",
                       "latency_s": 0.005, "bandwidth_mbps": 2000}],
        },
    }


def streamflow_doc_declarative_chains(n_chains: int = 6,
                                      rows_per_chain: int = 32,
                                      seq_len: int = 128,
                                      train_steps: int = 6, batch: int = 8,
                                      vocab: int = 512,
                                      d_model: int = 64,
                                      device: Optional[str] = None) -> dict:
    """The hand-unrolled scalar pipeline declaratively: one
    chain-parameterised tool per stage, one step per chain with ``args:
    {chain: i}`` and ``out:`` port renames; the JAX package's document of
    this name with its tools implemented here."""
    lm = {"vocab": vocab, "d_model": d_model}
    dev = _device_args(device)
    steps = {
        "/mkfastq": {
            "tool": "mkfastq_chains", "in": {"seed": "seed"},
            "out": {f"shard{i}": f"shard{i}" for i in range(n_chains)}},
    }
    for i in range(n_chains):
        steps[f"/chains/{i}/count"] = {
            "tool": "count_chain", "in": {"shard": f"shard{i}"},
            "out": {"model": f"model{i}", "stats": f"stats{i}"},
            "args": {"chain": i}}
        steps[f"/chains/{i}/seurat"] = {
            "tool": "seurat_chain",
            "in": {"shard": f"shard{i}", "model": f"model{i}"},
            "out": {"clusters": f"clusters{i}"}, "args": {"chain": i}}
        steps[f"/chains/{i}/singler"] = {
            "tool": "singler_chain", "in": {"clusters": f"clusters{i}"},
            "out": {"labels": f"labels{i}"}, "args": {"chain": i}}
    return {
        "version": "v1.0",
        "models": {
            "pool": {"type": "local", "config": {
                "shared_store": False,
                "services": {"node": {"replicas": n_chains, "cores": 2,
                                      "memory_gb": 8}}}},
        },
        "tools": {
            "mkfastq_chains": {
                "inputs": {"seed": "int"},
                "outputs": {f"shard{i}": "record"
                            for i in range(n_chains)},
                "requirements": {"cores": 1, "memory_gb": 1},
                "implementation": {
                    "module": MODULE, "factory": "mkfastq_chains_tool",
                    "args": {"n_chains": n_chains,
                             "rows_per_chain": rows_per_chain,
                             "seq_len": seq_len, "vocab": vocab}}},
            "count_chain": {
                "inputs": {"shard": "record"},
                "outputs": {"model": "record", "stats": "record"},
                "requirements": {"cores": 1, "memory_gb": 2},
                "implementation": {
                    "module": MODULE, "factory": "count_chain_tool",
                    "args": {"train_steps": train_steps, "batch": batch,
                             **lm, **dev}}},
            "seurat_chain": {
                "inputs": {"shard": "record", "model": "record"},
                "outputs": {"clusters": "record"},
                "requirements": {"cores": 1, "memory_gb": 2},
                "implementation": {
                    "module": MODULE, "factory": "seurat_chain_tool",
                    "args": {**lm, **dev}}},
            "singler_chain": {
                "inputs": {"clusters": "record"},
                "outputs": {"labels": "record"},
                "requirements": {"cores": 1, "memory_gb": 1},
                "implementation": {
                    "module": MODULE, "factory": "singler_chain_tool"}},
        },
        "workflows": {
            "single-cell": {
                "type": "declarative",
                "inputs": {"seed": "int"},
                "steps": steps,
                "bindings": [
                    {"step": "/",
                     "target": {"model": "pool", "service": "node"}},
                ],
            }
        },
        "scheduling": {"policy": "data_locality"},
    }
