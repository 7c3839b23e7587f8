"""The example twins on the port's engine: ``examples/lm_pipeline_torch.py``
(train, eval and int8 export through ``repro_torch.core``) runs on the CPU
when asked, and ``examples/singlecell_declarative_torch.yaml`` loads
through the port's loader and plans as the JAX package's YAML does."""
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
    where = {e.step: e.model for e in res.events}
    assert where == {"/tokenize": "cloud", "/pretrain": "hpc",
                     "/eval": "cloud", "/export": "cloud"}
    assert {e.status for e in res.events} == {"completed"}
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
