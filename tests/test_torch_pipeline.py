"""The §5 single-cell pipeline's compute in the port
(``repro_torch.pipeline``) against the JAX package's
(``repro/configs/paper_pipeline.py``), on the CPU.

The numpy steps (split, singler, aggregate) must give the same bits; the
count step's training, from a converted ``jax.random.key(chain)`` init,
the same per-step losses and weights in float32; the seurat step the same
embeddings and clusters; each package's seurat reads the other's count
model; the port's declarative documents compile to the JAX builders' plans
and run end to end through the unchanged engine."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import paper_pipeline as JP
from repro.core import FaultConfig, StreamFlowExecutor, load_streamflow_file
from repro.models import registry as JR
from repro_torch import pipeline as TP
from repro_torch.convert import flatten_with_paths, params_from_jax, \
    params_to_jax
from test_torch_train import LOSS_ATOL
from test_torch_train_step import PARAM_ATOL

# the documents' own test sizes (tests/test_frontend.py)
SCATTER_ARGS = dict(n_samples=4, rows_per_sample=4, seq_len=16,
                    train_steps=1, batch=2, vocab=64, d_model=16)
CHAIN_ARGS = dict(n_chains=3, rows_per_chain=8, seq_len=16, train_steps=1,
                  batch=2, vocab=64, d_model=16)

# one sample at the hybrid document's widths (vocab 256, d_model 48), in
# float32 on both sides; 3 steps, the row window wrapping once
ROWS, SEQ, STEPS, BATCH, CHAIN = 12, 64, 3, 4, 2
# seurat's embeddings: mean float32 logits over 64 positions of 2 layers in
# another op order, ~1e-7 of their scale; 1e-5 is the bar
EMBED_RTOL = 1e-5


def _cfgs():
    j = dataclasses.replace(JP.tiny_lm(vocab=256, d_model=48),
                            dtype="float32")
    t = dataclasses.replace(TP.tiny_lm(vocab=256, d_model=48),
                            dtype="float32")
    return j, t


def _shard():
    return JP._split_fn(1, ROWS, SEQ, 256)({"seed": 5}, {})["shard0"]


@pytest.fixture(scope="module")
def counted():
    """The JAX count step and the port's ``train_shard`` from its init."""
    jc, tc = _cfgs()
    shard = _shard()
    jout = JP._count_fn(CHAIN, jc, STEPS, BATCH)({"shard": shard}, {})
    init = jax.tree.map(np.asarray,
                        JR.init_params(jax.random.key(CHAIN), jc)[0])
    params, losses = TP.train_shard(params_from_jax(tc, init), shard, tc,
                                    STEPS, BATCH, device="cpu")
    return shard, jout[f"model{CHAIN}"], jout[f"stats{CHAIN}"]["losses"], \
        params_to_jax(tc, params), losses


def _ctx(tag=None):
    return {} if tag is None else {"tag": (tag,)}


def test_tiny_lm_is_the_references():
    for args in ({}, {"vocab": 256, "d_model": 48}, {"n_layers": 3}):
        assert dataclasses.asdict(TP.tiny_lm(**args)) == \
            dataclasses.asdict(JP.tiny_lm(**args))


@pytest.mark.parametrize("seed", [0, 7])
def test_split_is_bit_identical(seed):
    want = JP._split_fn(3, 5, 40, 300)({"seed": seed}, {})
    got = TP._split_fn(3, 5, 40, 300)({"seed": seed}, {})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k])
    want = JP._split_stream_fn(4, 6, 33, 128)({"seed": seed}, {})["shard"]
    got = TP.mkfastq_tool(4, 6, 33, 128)({"seed": seed}, {})["shard"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_count_losses_and_weights_match_jax(counted):
    _, jmodel, jlosses, tmodel, tlosses = counted
    assert len(tlosses) == len(jlosses) == STEPS
    for t, j in zip(tlosses, jlosses):
        assert abs(t - j) <= LOSS_ATOL * max(1.0, abs(j)), (tlosses, jlosses)
    assert tlosses[-1] < tlosses[0]
    want, got = flatten_with_paths(jmodel), flatten_with_paths(tmodel)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        err = float(np.abs(got[key] - np.asarray(w, np.float32)).max())
        assert err <= PARAM_ATOL, (key, err)


def test_count_step_emits_the_jax_layout():
    """The port's count body: a model in the JAX layout (numpy, the JAX
    init's shapes) and one loss a step, under the scatter tag's name."""
    jc, tc = _cfgs()
    out = TP._count_stream_fn(tc, 2, BATCH, device="cpu")(
        {"shard": _shard()}, _ctx(3))
    assert sorted(out) == ["model", "stats"]
    assert len(out["stats"]["losses"]) == 2
    want = flatten_with_paths(jax.tree.map(
        np.asarray, JR.init_params(jax.random.key(0), jc)[0]))
    got = flatten_with_paths(out["model"])
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(isinstance(v, np.ndarray) and v.dtype == np.float32
               for v in got.values())


def _seurat(fn_pkg, cfg, model, shard, **kw):
    return fn_pkg._seurat_fn(CHAIN, cfg, **kw)(
        {"shard": shard, "model": model}, {})[f"clusters{CHAIN}"]


def _same_clusters(got, want):
    e = np.abs(got["embeddings"] - want["embeddings"]).max()
    assert e <= EMBED_RTOL * np.abs(want["embeddings"]).max(), e
    assert np.array_equal(got["assign"], want["assign"])
    assert got["assign"].dtype == np.int32
    assert np.allclose(got["centroids"], want["centroids"],
                       rtol=0, atol=EMBED_RTOL *
                       np.abs(want["embeddings"]).max())


@pytest.mark.parametrize("whose_model", ["jax", "port"])
def test_seurat_matches_jax_and_reads_either_model(counted, whose_model):
    """Each package's seurat on the JAX count's model and on the port's:
    the same embeddings and assignments."""
    jc, tc = _cfgs()
    shard, jmodel, _, tmodel, _ = counted
    model = jmodel if whose_model == "jax" else tmodel
    want = _seurat(JP, jc, jax.tree.map(np.asarray, model), shard)
    got = _seurat(TP, tc, model, shard, device="cpu")
    assert len(set(want["assign"].tolist())) > 1
    _same_clusters(got, want)


def test_singler_and_aggregate_are_exact(counted):
    jc, tc = _cfgs()
    shard, jmodel, *_ = counted
    clusters = _seurat(JP, jc, jmodel, shard)
    labels = []
    for i in range(3):
        want = JP._singler_stream_fn()({"clusters": clusters}, _ctx(i))
        got = TP.singler_tool()({"clusters": clusters}, _ctx(i))
        for k in ("cluster_types", "confidence"):
            assert np.array_equal(got["labels"][k], want["labels"][k])
        want = JP._singler_fn(i, 5)({"clusters": clusters}, {})
        got = TP._singler_fn(i, 5)({"clusters": clusters}, {})
        assert np.array_equal(got[f"labels{i}"]["cluster_types"],
                              want[f"labels{i}"]["cluster_types"])
        labels.append(got[f"labels{i}"])
    want = JP._aggregate_fn()({"labels": labels}, {})["summary"]
    got = TP.aggregate_tool()({"labels": labels}, {})["summary"]
    assert got["n_samples"] == want["n_samples"] == 3
    assert np.array_equal(got["type_counts"], want["type_counts"])
    assert got["mean_confidence"] == want["mean_confidence"]


def test_factories_without_a_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (TP.count_tool(), TP.seurat_tool(), TP.count_chain_tool(),
               TP.seurat_chain_tool()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn({"shard": _shard(), "model": None}, {})


# ---------------------------------------------------------------------------
# the declarative documents
# ---------------------------------------------------------------------------

def test_declarative_hybrid_twin_plan_identical_to_builder():
    doc = TP.streamflow_doc_declarative_hybrid(**SCATTER_ARGS)
    tools = doc["tools"]
    assert {t["implementation"]["module"] for t in tools.values()} == \
        {"repro_torch.pipeline"}
    declared = load_streamflow_file(doc).workflows[
        "single-cell-scatter"].workflow
    built = JP.build_scatter_workflow(**SCATTER_ARGS)
    assert declared.expand().summary() == built.expand().summary()
    jdoc = JP.streamflow_doc_declarative_hybrid(**SCATTER_ARGS)
    for t in jdoc["tools"].values():
        t["implementation"]["module"] = "repro_torch.pipeline"
    assert doc == jdoc


def test_declarative_chains_twin_plan_identical_to_builder():
    doc = TP.streamflow_doc_declarative_chains(**CHAIN_ARGS, device="cpu")
    assert doc["tools"]["count_chain"]["implementation"]["args"][
        "device"] == "cpu"
    declared = load_streamflow_file(doc).workflows["single-cell"].workflow
    built = JP.build_workflow(**CHAIN_ARGS)
    assert declared.expand().summary() == built.expand().summary()


def test_declarative_hybrid_twin_runs_on_the_engine():
    """The unchanged engine runs the port's bodies, ``device: cpu`` passed
    as step args: a summary over every sample, one loss a step each."""
    doc = TP.streamflow_doc_declarative_hybrid(hpc_replicas=2,
                                               cloud_replicas=2,
                                               **SCATTER_ARGS)
    steps = doc["workflows"]["single-cell-scatter"]["steps"]
    for path in ("/count", "/seurat"):
        steps[path]["args"] = {"device": "cpu"}
    cfg = load_streamflow_file(doc)
    entry = cfg.workflows["single-cell-scatter"]
    ex = StreamFlowExecutor.from_config(
        cfg, fault=FaultConfig(speculative=False))
    res = ex.run(entry.workflow, entry.bindings, inputs={"seed": 0})
    n = SCATTER_ARGS["n_samples"]
    summary = res.outputs["summary"]
    assert summary["n_samples"] == n
    assert int(summary["type_counts"].sum()) == 4 * n   # 4 clusters each
    assert len(res.outputs["stats"]) == n
    assert all(len(s["losses"]) == SCATTER_ARGS["train_steps"]
               for s in res.outputs["stats"])
