"""The example twins on the port's engine: ``examples/lm_pipeline_torch.py``
(train, eval and int8 export through ``repro_torch.core``),
``examples/quickstart_torch.py`` (the Fig. 9 hybrid YAML) and
``examples/resume_after_crash_torch.py`` (two crash drills) run on the
CPU when asked and need a GPU otherwise, and
``examples/singlecell_declarative_torch.yaml`` and
``examples/singlecell_hybrid_torch.yaml`` load through the port's loader
and plan as the JAX package's YAMLs do."""
import copy
import importlib.util
import os

import numpy as np
import pytest
import torch
import yaml

import repro.core as J
import repro_torch.core as T
from test_torch_engine import config_view

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_YAML = os.path.join(ROOT, "examples", "singlecell_declarative.yaml")
PORT_YAML = os.path.join(ROOT, "examples",
                         "singlecell_declarative_torch.yaml")
JAX_HYBRID = os.path.join(ROOT, "examples", "singlecell_hybrid.yaml")
PORT_HYBRID = os.path.join(ROOT, "examples", "singlecell_hybrid_torch.yaml")


def _example(name):
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_lm_pipeline_twin_runs_on_the_cpu():
    lm = _example("lm_pipeline_torch.py")
    res, transfers = lm.main(["--device", "cpu"])
    log = res.outputs["train_log"]["losses"]
    assert len(log) == lm.STEPS and log[-1] < log[0]
    rep = res.outputs["eval_report"]
    assert np.isfinite(rep["nll"]) and 0.0 <= rep["acc"] <= 1.0
    # one int8 tensor per leaf of the JAX layout's tree
    assert res.outputs["package"]["n_tensors"] == 12
    # each step completed once; under load the executor may also start a
    # speculative twin of a slow step (the example keeps speculation on),
    # whose result is discarded as a duplicate
    done = [e for e in res.events if e.status == "completed"]
    where = {e.step: e.model for e in done}
    assert len(done) == len(where) == 4
    assert where == {"/tokenize": "cloud", "/pretrain": "hpc",
                     "/eval": "cloud", "/export": "cloud"}
    assert {e.status for e in res.events} <= {"completed", "duplicate"}
    assert transfers["two-step"][0] >= 2     # shard in, params out


def test_lm_pipeline_twin_without_a_device_needs_a_gpu(monkeypatch):
    lm = _example("lm_pipeline_torch.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.main([])


def _tools_without_module(view):
    view = copy.deepcopy(view)
    modules = set()
    for tool in view["tools"].values():
        modules.add(tool["implementation"].pop("module"))
    return view, modules


def test_declarative_yaml_twin_plans_as_the_jax_yaml():
    want, jmods = _tools_without_module(
        config_view(J.load_streamflow_file(JAX_YAML), J.dry_run))
    got, tmods = _tools_without_module(
        config_view(T.load_streamflow_file(PORT_YAML), T.dry_run))
    assert got == want
    assert (jmods, tmods) == ({"repro.configs.paper_pipeline"},
                              {"repro_torch.pipeline"})


def test_declarative_yaml_twin_is_the_jax_yaml_with_the_ports_tools():
    with open(JAX_YAML) as f:
        jdoc = yaml.safe_load(f)
    with open(PORT_YAML) as f:
        tdoc = yaml.safe_load(f)
    for tool in jdoc["tools"].values():
        tool["implementation"]["module"] = "repro_torch.pipeline"
    assert tdoc == jdoc
    # no device in the tools' args: the count and seurat steps run on the
    # GPU, and the mesh site's steps under its device (the GPU)
    assert all("device" not in t["implementation"].get("args", {})
               for t in tdoc["tools"].values())
    assert "device" not in tdoc["models"]["occam"]["config"]


def test_hybrid_yaml_twin_plans_as_the_jax_yaml():
    want = config_view(J.load_streamflow_file(JAX_HYBRID), J.dry_run)
    got = config_view(T.load_streamflow_file(PORT_HYBRID), T.dry_run)
    # its own journal, so that the two quickstarts never share one
    assert (want["checkpoint"]["journal_path"],
            got["checkpoint"]["journal_path"]) == (
        ".streamflow/singlecell_hybrid.jsonl",
        ".streamflow/singlecell_hybrid_torch.jsonl")
    got["checkpoint"] = want["checkpoint"]
    assert got == want


def test_hybrid_yaml_twin_is_the_jax_yaml_with_the_ports_builders():
    with open(JAX_HYBRID) as f:
        jdoc = yaml.safe_load(f)
    with open(PORT_HYBRID) as f:
        tdoc = yaml.safe_load(f)
    for w in jdoc["workflows"].values():
        assert w["config"]["module"] == "repro.configs.paper_pipeline"
        w["config"]["module"] = "repro_torch.pipeline"
    jdoc["checkpoint"]["journal_path"] = tdoc["checkpoint"]["journal_path"]
    assert tdoc == jdoc
    assert "device" not in tdoc["models"]["occam"]["config"]


def test_quickstart_twin_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    qs = _example("quickstart_torch.py")
    res, transfers = qs.main(["--device", "cpu"])
    assert sorted(res.outputs) == [f"{kind}{i}" for kind in
                                   ("labels", "stats") for i in range(3)]
    for i in range(3):
        assert len(res.outputs[f"stats{i}"]["losses"]) == 4
        assert len(res.outputs[f"labels{i}"]["cluster_types"]) == 4
    where = {e.step: e.model for e in res.events}
    assert all(where[f"/chains/{i}/count"] == "occam" and
               where[f"/chains/{i}/seurat"] == "garr_cloud"
               for i in range(3))
    assert {e.status for e in res.events} == {"completed"}
    assert transfers["two-step"]["n"] == 1      # the seed, in
    assert (tmp_path / ".streamflow" /
            "singlecell_hybrid_torch.jsonl").exists()


def test_quickstart_twin_without_a_device_needs_a_gpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    qs = _example("quickstart_torch.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qs.main([])


def test_resume_twin_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ex = _example("resume_after_crash_torch.py")
    demo, res = ex.main(["--device", "cpu"])
    rerun = {e.step for e in demo.events if e.status == "completed"}
    assert "/reduce" in rerun and "/source" not in rerun
    from repro_torch.configs import recovery_demo
    clean = T.StreamFlowExecutor(
        {"solo": T.ModelSpec("solo", "local",
                             {"services": {"s": {"replicas": 4}}})},
        fault=T.FaultConfig(speculative=False)).run(
        recovery_demo.build_workflow(), [T.Binding("/", "solo", "s")],
        inputs={"seed": 0})
    assert np.array_equal(demo.outputs["combined"],
                          clean.outputs["combined"])
    journal = T.ExecutionJournal.replay(ex.PIPELINE_JOURNAL)
    assert journal.run_ended
    summary = res.outputs["summary"]
    n = ex.PIPELINE_ARGS["n_samples"]
    assert summary["n_samples"] == n
    assert int(summary["type_counts"].sum()) == 4 * n
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert "/mkfastq" not in rerun and "/aggregate" in rerun


def test_resume_twin_without_a_device_needs_a_gpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ex = _example("resume_after_crash_torch.py")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main([])
