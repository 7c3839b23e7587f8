"""The port's StreamFlow engine (``repro_torch.core``) against the JAX
package's (``repro.core``), unchanged, on the CPU.

The JAX package's own documents (every ``streamflow_doc_*`` builder of
``repro/configs/paper_pipeline.py`` and the two single-cell YAML examples)
plan the same through both loaders; the port's mesh connector keeps the
reference's resources, stores and declared topology while it runs a
site's steps on a torch device; a crash that a ``simcluster`` site injects
is retried once by both engines with the same outputs; and a run cut after
its counts resumes from its journal on the port's engine.

A ``type: python`` workflow names a builder module, which makes engine
objects: the JAX package's builders make the JAX engine's ``Workflow``,
which the port's loader refuses.  So the port's side of each document
names the port's builders (``repro_torch.pipeline``, the same builders on
the port's engine objects): :func:`port_doc`.
"""
import collections
import copy
import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.configs import paper_pipeline as JP
from repro.core.connectors import mesh as jmesh
from repro.core.connectors import multipod as jmultipod
from repro_torch import pipeline as TP
from repro_torch.core.connectors import mesh as tmesh
from repro_torch.core.connectors import multipod as tmultipod
from test_torch_pipeline import CHAIN_ARGS, SCATTER_ARGS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BUILDERS = "repro.configs.paper_pipeline"

CONFIG_KEYS = ("policy", "grace_period_s", "fault", "checkpoint",
               "topology", "service", "cache", "autoscale", "analyze")


def port_doc(doc: dict) -> dict:
    """A copy of ``doc`` whose python workflows name the port's builders
    where they name the JAX package's."""
    doc = copy.deepcopy(doc)
    for w in (doc.get("workflows") or {}).values():
        cfg = w.get("config") if isinstance(w, dict) else None
        if w.get("type", "python") == "python" and isinstance(cfg, dict) \
                and cfg.get("module") == JAX_BUILDERS:
            cfg["module"] = TP.__name__
    return doc


def config_view(cfg, dry_run) -> dict:
    """What a loaded StreamFlow file holds, in plain values: models,
    tools, the top-level blocks, and per workflow its bindings and its
    dry-run plan (invocations, widths, targets)."""
    return {
        "models": {n: dataclasses.asdict(m) for n, m in cfg.models.items()},
        "tools": {n: dataclasses.asdict(t) for n, t in cfg.tools.items()},
        **{k: getattr(cfg, k) for k in CONFIG_KEYS},
        "workflows": {
            n: {"bindings": [dataclasses.asdict(b) for b in e.bindings],
                "plan": dry_run(e)}
            for n, e in cfg.workflows.items()},
    }


# ---------------------------------------------------------------------------
# the JAX package's documents through both loaders
# ---------------------------------------------------------------------------

CHAIN_ARGS_RUN = dict(rows_per_chain=4, seq_len=16, train_steps=1,
                      batch=2, vocab=64, d_model=16, device="cpu")
DOC_BUILDERS = sorted(name for name, _ in inspect.getmembers(
    JP, inspect.isfunction) if name.startswith("streamflow_doc_"))
EXAMPLES = ["examples/singlecell_hybrid.yaml",
            "examples/singlecell_declarative.yaml"]


def test_every_document_builder_is_listed():
    assert DOC_BUILDERS == [
        "streamflow_doc_declarative_chains",
        "streamflow_doc_declarative_hybrid", "streamflow_doc_full_hpc",
        "streamflow_doc_hybrid", "streamflow_doc_scatter_hybrid",
        "streamflow_doc_single_service"]


@pytest.mark.parametrize("name", DOC_BUILDERS)
def test_jax_documents_plan_the_same(name):
    doc = getattr(JP, name)()
    want = config_view(J.load_streamflow_file(copy.deepcopy(doc)),
                       J.dry_run)
    got = config_view(T.load_streamflow_file(port_doc(doc)), T.dry_run)
    assert got == want


@pytest.mark.parametrize("path", EXAMPLES)
def test_yaml_examples_plan_the_same(path):
    import yaml
    with open(os.path.join(ROOT, path)) as f:
        doc = yaml.safe_load(f)
    want = config_view(J.load_streamflow_file(os.path.join(ROOT, path)),
                       J.dry_run)
    got = config_view(T.load_streamflow_file(port_doc(doc)), T.dry_run)
    assert got == want


@pytest.mark.parametrize("name", DOC_BUILDERS)
def test_port_document_builders_are_the_jax_ones(name):
    """Each of the port's ``streamflow_doc_*`` is the JAX package's
    document of that name, its builders and tools named in the port."""
    want = port_doc(getattr(JP, name)())
    for tool in (want.get("tools") or {}).values():
        tool["implementation"]["module"] = TP.MODULE
    assert getattr(TP, name)() == want
    # a device goes into the builders' arguments (python workflows) or the
    # computing tools' (declarative ones), never into a site
    doc = getattr(TP, name)(device="cpu")
    assert "device" not in str(doc["models"])
    for w in doc["workflows"].values():
        if w["type"] == "python":
            assert w["config"]["args"]["device"] == "cpu"
    for tool in ("count", "seurat", "count_chain", "seurat_chain"):
        if tool in doc.get("tools", {}):
            assert doc["tools"][tool]["implementation"]["args"][
                "device"] == "cpu"


@pytest.mark.parametrize("name", ["streamflow_doc_full_hpc",
                                  "streamflow_doc_hybrid",
                                  "streamflow_doc_single_service"])
def test_chain_documents_run_on_the_port_engine(name):
    """The Fig. 8 / Fig. 9 documents (the hand-unrolled chains) through
    the port's loader and executor on the CPU, each sample's chain
    complete."""
    doc = getattr(TP, name)(n_chains=2, **CHAIN_ARGS_RUN)
    if "occam" in doc["models"]:
        doc["models"]["occam"]["config"]["device"] = "cpu"
    cfg = T.load_streamflow_file(doc)
    entry = cfg.workflows["single-cell"]
    res = T.StreamFlowExecutor.from_config(
        cfg, fault=T.FaultConfig(speculative=False)).run(
        entry.workflow, entry.bindings, inputs={"seed": 0})
    assert sorted(res.outputs) == ["labels0", "labels1", "stats0", "stats1"]
    assert {e.status for e in res.events} == {"completed"}
    assert len(res.events) == 1 + 2 * 3


def test_the_port_loader_refuses_a_jax_engine_workflow():
    doc = JP.streamflow_doc_full_hpc(n_chains=2)
    with pytest.raises(T.StreamFlowFileError, match="returned Workflow"):
        T.load_streamflow_file(doc)


@pytest.mark.parametrize("builder,args", [
    ("build_workflow", CHAIN_ARGS),
    ("build_scatter_workflow", SCATTER_ARGS),
    ("build_scatter_workflow", dict(SCATTER_ARGS, declare_scatter=False))],
    ids=["chains", "scatter", "scatter-undeclared"])
def test_port_builders_plan_as_the_jax_builders(builder, args):
    want = getattr(JP, builder)(**args)
    got = getattr(TP, builder)(**args, device="cpu")
    assert isinstance(got, T.Workflow)

    def steps(wf):
        return {p: (dict(s.inputs), tuple(s.outputs), tuple(s.scatter),
                    tuple(s.gather), dict(s.streams),
                    dataclasses.asdict(s.requirements))
                for p, s in wf.steps.items()}
    assert steps(got) == steps(want)
    if args.get("declare_scatter", True):
        assert got.expand().summary() == want.expand().summary()


# ---------------------------------------------------------------------------
# the mesh connector
# ---------------------------------------------------------------------------

MESH_CONFIGS = [
    {},
    {"topology": {"data": 16, "model": 16}, "shared_store": True,
     "services": {"cellranger": {"replicas": 3, "cores": 2,
                                 "memory_gb": 8}}},
    {"topology": {"data": 4, "model": 2}, "shared_store": False,
     "model_axis": 2,
     "services": {"a": {"replicas": 2}, "b": {"replicas": 1, "cores": 4}}},
]


def _site_view(conn):
    resources = {r: dataclasses.asdict(conn.resource_info(r))
                 for s in conn.services()
                 for r in conn.get_available_resources(s)}
    stores = {r: conn.store(r).name for r in resources}
    return {"resources": resources, "stores": stores,
            "shared": conn.shared_data_space(),
            "topology": conn.declared_topology(),
            "chips": conn.declared_chips()}


@pytest.mark.parametrize("config", MESH_CONFIGS, ids=range(len(MESH_CONFIGS)))
def test_mesh_connector_keeps_the_references_site(config):
    want = jmesh.MeshConnector("occam", copy.deepcopy(config))
    got = tmesh.MeshConnector("occam", dict(copy.deepcopy(config),
                                            device="cpu"))
    want.deploy()
    got.deploy()
    assert _site_view(got) == _site_view(want)
    for r in _site_view(got)["resources"]:
        assert got.device(r) == torch.device("cpu")
    got.undeploy()
    want.undeploy()
    assert not got.deployed and got.get_available_resources("default") == []


def test_multipod_keeps_the_references_pods():
    for config in ({}, {"topology": {"pod": 4, "data": 2, "model": 8}}):
        want = jmultipod.MultiPodConnector("pods", copy.deepcopy(config))
        got = tmultipod.MultiPodConnector("pods", dict(config, device="cpu"))
        assert got.n_pods() == want.n_pods()
        assert got.declared_topology() == want.declared_topology()
        assert got.declared_chips() == want.declared_chips()
    for cls in (jmultipod.MultiPodConnector, tmultipod.MultiPodConnector):
        with pytest.raises(ValueError, match="pod"):
            cls("pods", {"topology": {"data": 2}})


def test_mesh_connector_without_a_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conn = tmesh.MeshConnector("occam", {"services": {"s": {}}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        conn.deploy()
    assert not conn.deployed and conn.get_available_resources("s") == []


def test_mesh_connector_hands_the_step_its_device():
    conn = tmesh.MeshConnector("occam", {
        "topology": {"data": 2, "model": 4}, "device": "cpu",
        "services": {"s": {"replicas": 2}}})
    conn.deploy()
    seen = []
    out = conn.run("occam/s/1", lambda ctx: seen.append(ctx) or 7,
                   environment={"A": "1"}, capture_output=True)
    assert out == 7
    (ctx,) = seen
    assert ctx["device"] == torch.device("cpu")
    assert set(ctx) == {"resource", "connector", "environment", "device",
                        "declared_topology"}
    assert ctx["resource"] == "occam/s/1" and ctx["connector"] is conn
    assert ctx["environment"] == {"A": "1"}
    assert ctx["declared_topology"] == {"data": 2, "model": 4}
    with pytest.raises(KeyError):
        conn.run("occam/s/9", lambda ctx: None)


def test_mesh_connector_runs_a_cuda_step_under_its_device(monkeypatch):
    """On a CUDA device the command runs inside ``torch.cuda.device``: the
    current device is per thread, and the executor's pool is threaded."""
    entered = []

    class Recorder:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(("enter", self.dev))

        def __exit__(self, *exc):
            entered.append(("exit", self.dev))
            return False

    monkeypatch.setattr(torch.cuda, "device", Recorder)
    conn = tmesh.MeshConnector("occam", {"device": "cuda:1",
                                         "services": {"s": {}}})
    conn.deploy()
    dev = torch.device("cuda:1")
    conn.run("occam/s/0", lambda ctx: entered.append(("run", ctx["device"])))
    assert entered == [("enter", dev), ("run", dev), ("exit", dev)]


def test_connector_registry_is_the_references():
    from repro.core import connectors as jc
    from repro_torch.core import connectors as tc
    assert sorted(tc.CONNECTOR_TYPES) == sorted(jc.CONNECTOR_TYPES)
    assert tc.CONNECTOR_TYPES["mesh"] is tmesh.MeshConnector
    site = tc.start_external_site("ext", "mesh", {"device": "cpu"})
    try:
        assert tc.get_external_site("ext") is site and site.deployed
        assert tc.start_external_site("ext", "mesh", {}) is site
    finally:
        tc.stop_external_site("ext")
    assert tc.get_external_site("ext") is None


# ---------------------------------------------------------------------------
# faults and recovery
# ---------------------------------------------------------------------------

def hybrid_doc(policy="data_locality", **extra):
    """The port's hybrid document at the test size, every computing step
    and the mesh site on the CPU; the JAX engine reads the same document
    (its mesh connector ignores ``device``)."""
    doc = TP.streamflow_doc_declarative_hybrid(
        hpc_replicas=2, cloud_replicas=2, policy=policy, device="cpu",
        **SCATTER_ARGS, **extra)
    doc["models"]["occam"]["config"]["device"] = "cpu"
    return doc


def chains_doc(policy="data_locality"):
    doc = TP.streamflow_doc_declarative_chains(device="cpu", **CHAIN_ARGS)
    doc["scheduling"]["policy"] = policy
    return doc


def run_doc(core, doc, fault=None, tick_hook=None, **fault_kw):
    """Load ``doc`` on ``core`` and run its one workflow from seed 0:
    (executor, RunResult)."""
    cfg = core.load_streamflow_file(copy.deepcopy(doc))
    (entry,) = cfg.workflows.values()
    ex = core.StreamFlowExecutor.from_config(
        cfg, fault=core.FaultConfig(speculative=False, **fault_kw))
    ex.tick_hook = tick_hook
    return ex, ex.run(entry.workflow, entry.bindings, inputs={"seed": 0})


def same_outputs(got, want):
    """Equal output bits: one serialization of both (numpy arrays and
    plain values, the same pickle)."""
    assert sorted(got) == sorted(want)
    assert T.serialize(got) == J.serialize(want)


def events_of(res):
    return collections.Counter((e.step, e.status, e.attempt)
                               for e in res.events)


def _wrap_in_simcluster(doc, site, match):
    inner = doc["models"][site]
    doc["models"][site] = {"type": "simcluster", "config": {
        "inner": {"type": inner["type"], "config": inner["config"]},
        "fail": [{"match": match, "attempts": [0]}]}}
    return doc


@pytest.mark.parametrize("which,site,match", [
    ("chains", "pool", "/chains/1/count"),
    ("hybrid", "occam", "/mkfastq")], ids=["local-count", "mesh-mkfastq"])
def test_a_crash_is_retried_once_by_both_engines(which, site, match):
    doc = _wrap_in_simcluster(
        chains_doc() if which == "chains" else hybrid_doc(), site, match)
    runs = {}
    for core in (J, T):
        ex, res = run_doc(core, doc, max_retries=2, backoff_s=0.01)
        failed = [e for e in res.events if e.status.startswith("failed")]
        assert [(e.step, e.attempt) for e in failed] == [(match, 0)]
        done = [e for e in res.events
                if e.step == match and e.status == "completed"]
        assert [e.attempt for e in done] == [1]
        runs[core.__name__] = res
    same_outputs(runs["repro_torch.core"].outputs,
                 runs["repro.core"].outputs)
    assert events_of(runs["repro_torch.core"]) == \
        events_of(runs["repro.core"])


class _Crash(BaseException):
    """Raised from the tick hook: the driver dies between two ticks."""


def test_a_run_cut_after_its_counts_resumes_from_the_journal(tmp_path):
    n = SCATTER_ARGS["n_samples"]
    journal = tmp_path / "journal.jsonl"
    doc = hybrid_doc()
    doc["checkpoint"] = {"journal_path": str(journal),
                         "include_payloads": True, "fsync": False}
    counts = {f"/count@{i}" for i in range(n)}

    def crash_after_counts(tick, completed):
        if counts <= completed:
            raise _Crash(sorted(completed))

    with pytest.raises(_Crash):
        run_doc(T, doc, tick_hook=crash_after_counts)
    text = journal.read_text()
    assert '"repro_torch.core.frontend"' in text
    assert "repro.core" not in text.replace("repro_torch.core", "")
    journaled = T.ExecutionJournal.replay(str(journal)).completed_steps
    assert counts <= journaled

    cfg = T.load_streamflow_file(copy.deepcopy(doc))
    ex = T.StreamFlowExecutor.from_config(
        cfg, fault=T.FaultConfig(speculative=False))
    res = ex.resume()                     # workflow and bindings from the WAL
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert not rerun & journaled and not rerun & counts
    _, straight = run_doc(J, hybrid_doc())
    same_outputs(res.outputs, straight.outputs)


def test_the_journal_rebuilds_the_ports_workflow(tmp_path):
    """A journal-only resume imports the builder the journal names: the
    port's frontend, which recompiles the document's tools and steps into
    the port's engine objects."""
    journal = tmp_path / "j.jsonl"
    doc = hybrid_doc()
    doc["checkpoint"] = {"journal_path": str(journal), "fsync": False}
    run_doc(T, doc)
    state = T.ExecutionJournal.replay(str(journal))
    wf = state.build_workflow()
    assert isinstance(wf, T.Workflow)
    assert wf.expand().summary() == JP.build_scatter_workflow(
        **SCATTER_ARGS).expand().summary()
    assert [(b.step, b.model, b.service) for b in state.build_bindings()] \
        == [("/mkfastq", "occam", "cellranger"),
            ("/count", "occam", "cellranger"), ("/", "garr_cloud", "r_env")]


def test_a_dict_document_needs_no_yaml(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = T.load_streamflow_file(hybrid_doc())
    assert "single-cell-scatter" in cfg.workflows
    with pytest.raises(ImportError, match="a dict document loads"):
        T.load_streamflow_file("version: v1.0\n")
    with pytest.raises(ImportError, match="PyYAML"):
        T.load_streamflow_file(os.path.join(ROOT, EXAMPLES[1]))


def test_hybrid_counts_land_on_both_sites_of_the_port():
    """Every count and seurat invocation records its resource, and no
    event is speculative or a retry."""
    _, res = run_doc(T, hybrid_doc())
    n = SCATTER_ARGS["n_samples"]
    for kind in ("count", "seurat"):
        evs = [e for e in res.events if e.step.startswith(f"/{kind}@")]
        assert len(evs) == n
        assert all(e.resource.split("/")[0] == e.model for e in evs)
    assert not any(e.speculative for e in res.events)
    assert {e.attempt for e in res.events} == {0}
    assert {e.status for e in res.events} == {"completed"}
    assert res.outputs["summary"]["n_samples"] == n
    assert np.isfinite(res.outputs["summary"]["mean_confidence"])
