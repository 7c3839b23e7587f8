"""The port's plan-time analyzer (``repro_torch.core.analyzer``) against
the JAX package's (``repro.core.analyzer``), unchanged, on the CPU.

Every conformance case that loads (the 27 valid ones and the 7 analysis
cases) gives the same ``analyze(...).to_dict()`` in both packages; then
the twins of ``tests/test_analyzer.py`` and
``tests/test_analyzer_properties.py`` on the port's analyzer, executor and
service, each analysis also held to the JAX package's report of the same
document.  The property tests draw their examples with
``derandomize=True``, so every run checks the same pipelines.
"""
import copy
import dataclasses

import pytest
from hypothesis import given, settings, strategies as st

import repro.core.analyzer as JA
import repro.core.streamflow_file as JS
from repro_torch.core import analyzer
from repro_torch.core.analyzer import (AnalyzeConfig, WorkflowAnalysisError,
                                       analyze, gate)
from repro_torch.core.checker import WorkflowCheckError
from repro_torch.core.executor import StreamFlowExecutor
from repro_torch.core.fault import FaultConfig
from repro_torch.core.streamflow_file import load
from repro_torch.core.topology import (MANAGEMENT, TopologyGraph,
                                       UnroutableError)
from test_torch_engine import port_doc
from test_torch_engine_conformance import ANALYSIS_INVALID, VALID, _case, _ids

LOADABLE = VALID + ANALYSIS_INVALID


def scatter_doc(width, replicas, *, models=None, work_model=None,
                analyze_block=None):
    """A split -> scatter(work) -> gather(agg) pipeline over command-stub
    tools: executes at once, wedges only when capacity says so."""
    models = models or {"site": replicas}
    work_model = work_model or next(iter(models))
    doc = {
        "version": "v1.0",
        "models": {m: {"type": "local",
                       "config": {"services": {"svc": {"replicas": r}}}}
                   for m, r in models.items()},
        "tools": {
            "split": {"outputs": {"shard": "record"}},
            "work": {"inputs": {"shard": "record"},
                     "outputs": {"out": "record"}},
            "agg": {"inputs": {"parts": "array<record>"},
                    "outputs": {"summary": "record"}},
        },
        "workflows": {"w": {
            "type": "declarative",
            "steps": {
                "/split": {"tool": "split", "streams": {"shard": width}},
                "/work": {"tool": "work", "in": {"shard": "shard"},
                          "scatter": ["shard"]},
                "/agg": {"tool": "agg", "in": {"parts": "out"},
                         "gather": ["parts"]},
            },
            "bindings": [
                {"step": "/", "target": {"model": next(iter(models)),
                                         "service": "svc"}},
                {"step": "/work", "target": {"model": work_model,
                                             "service": "svc"}},
            ],
        }},
    }
    if analyze_block is not None:
        doc["analyze"] = analyze_block
    return doc


def analyze_both(doc, **kw):
    """The port's report of ``doc``, after checking that it equals the JAX
    package's report of the same document."""
    got = analyze(load(port_doc(doc)), **kw)
    want = JA.analyze(JS.load(copy.deepcopy(doc)), **kw)
    assert got.to_dict() == want.to_dict()
    return got


def _run(cfg, **kw):
    ex = StreamFlowExecutor.from_config(cfg, **kw)
    entry = next(iter(cfg.workflows.values()))
    return ex.run(entry.workflow, entry.bindings, inputs={})


def _codes(report):
    return {d.code for d in report.diagnostics}


# ------------------------------------------------------------- the corpus
def test_the_loadable_cases_were_found():
    assert (len(VALID), len(ANALYSIS_INVALID)) == (27, 7)


@pytest.mark.parametrize("path", LOADABLE, ids=_ids(LOADABLE))
def test_corpus_case_analyzes_the_same(path):
    doc, expect = _case(path)
    report = analyze_both(doc)
    if expect.get("analysis"):
        assert sorted(_codes(report)) == sorted(expect["codes"])
    else:
        assert not report.errors(), [str(d) for d in report.errors()]
    assert set(report.cost) == set(load(port_doc(doc)).workflows)


def test_the_registries_are_the_reference_ones():
    assert analyzer.CODES == JA.CODES
    assert analyzer.SEVERITY == JA.SEVERITY


# ----------------------------------------------------------------- config
def test_analyze_config_from_value():
    assert AnalyzeConfig.from_value(None) is None
    assert AnalyzeConfig.from_value(False) is None
    assert AnalyzeConfig.from_value({}) is None
    assert AnalyzeConfig.from_value({"enabled": False}) is None
    cfg = AnalyzeConfig.from_value(True)
    assert cfg is not None and cfg.fail_on == "error"
    cfg = AnalyzeConfig.from_value(
        {"fail_on": "warning", "default_cost_s": 2.5, "costs": {"/a": 1.0}})
    assert cfg.fail_on == "warning"
    assert cfg.default_cost_s == 2.5 and cfg.costs == {"/a": 1.0}
    with pytest.raises(ValueError):
        AnalyzeConfig.from_value({"fail_on": "never"})
    with pytest.raises(ValueError):
        AnalyzeConfig.from_value({"bogus": 1})


def test_gate_off_and_thresholds():
    ok = load(scatter_doc(2, 2, analyze_block=True))
    assert gate(ok) is not None
    # absent/off block: the gate does nothing, even on a wedged plan
    wedged = load(scatter_doc(3, 0))
    assert AnalyzeConfig.from_value(wedged.analyze) is None
    assert gate(wedged) is None
    # enabled: errors raise, carrying the diagnostics and the full report
    doc = scatter_doc(3, 0, analyze_block=True)
    with pytest.raises(WorkflowAnalysisError) as ei:
        gate(load(doc))
    with pytest.raises(JA.WorkflowAnalysisError) as want:
        JA.gate(JS.load(copy.deepcopy(doc)))
    assert {d.code for d in ei.value.diagnostics} >= {"SF300", "SF301"}
    assert [str(d) for d in ei.value.diagnostics] == \
        [str(d) for d in want.value.diagnostics]
    assert ei.value.report.cost
    # fail_on: warning makes SF310 fatal
    narrow = load(scatter_doc(4, 1, analyze_block={"fail_on": "warning"}))
    with pytest.raises(WorkflowAnalysisError):
        gate(narrow)
    assert gate(load(scatter_doc(4, 1, analyze_block=True))) is not None


# ------------------------------------------------------------ diagnostics
def test_wedge_is_flagged_and_actually_wedges():
    """SF300's ground truth: the predicted wedge is the port's executor's
    runtime deadlock, seen through its deadlock guard."""
    report = analyze_both(scatter_doc(3, 0))
    assert {"SF300", "SF301"} <= _codes(report)
    with pytest.raises(RuntimeError, match="scheduling deadlock"):
        _run(load(scatter_doc(3, 0)), deadlock_timeout_s=0.4)


def test_serializing_scatter_completes_and_warns():
    report = analyze_both(scatter_doc(4, 1))
    assert "SF300" not in _codes(report)
    assert "SF310" in _codes(report)
    assert not report.errors()
    res = _run(load(scatter_doc(4, 1)), deadlock_timeout_s=2.0)
    assert len(res.timeline_rows()) == 6     # split + 4 x work + agg


def test_live_capacity_overrides_static_zero():
    report = analyze_both(scatter_doc(3, 0),
                          live_capacity={("site", "svc"): 2})
    assert not {"SF300", "SF301"} & _codes(report)


def test_cost_report_shape():
    report = analyze_both(scatter_doc(4, 2), step_costs={"/work": 3.0},
                          default_cost_s=1.0)
    cost = report.cost["w"]
    assert cost["n_invocations"] == 6
    assert cost["makespan_lower_bound_s"] >= cost["critical_path_s"]
    assert cost["critical_path_s"] >= 1.0 + 3.0 + 1.0
    assert cost["total_work_s"] == pytest.approx(1.0 + 4 * 3.0 + 1.0)
    assert cost["critical_path"][0] == "/split"
    assert cost["critical_path"][-1] == "/agg"


def test_sf150_no_workflows():
    doc = {"version": "v1.0",
           "models": {"site": {"type": "local", "config": {}}}}
    with pytest.raises(WorkflowCheckError) as ei:
        load(doc)
    assert {d.code for d in ei.value.diagnostics} == {"SF150"}
    load(doc, check=False)
    with pytest.raises(WorkflowCheckError):
        load({**doc, "workflows": {}})


# ---------------------------------------------------------- strict routing
def test_strict_routing_refuses_relay():
    topo = TopologyGraph(routing="strict")
    topo.add_site("hpc")
    topo.add_site("cloud")
    assert not topo.can_route("hpc", "cloud")
    assert topo.cost("hpc", "cloud", 1024) == float("inf")
    with pytest.raises(UnroutableError):
        topo.route("hpc", "cloud", 1024)
    assert topo.can_route(MANAGEMENT, "hpc")
    assert topo.can_route("hpc", MANAGEMENT)


def test_strict_routing_with_link_routes_directly():
    topo = TopologyGraph(routing="strict")
    topo.add_link("hpc", "cloud", bandwidth_mbps=100.0, symmetric=False)
    assert topo.can_route("hpc", "cloud")
    assert not topo.can_route("cloud", "hpc")
    route = topo.route("hpc", "cloud", 1024)
    assert [h.target for h in route.hops] == ["cloud"]
    assert not route.via_management


# ------------------------------------------------------------ service gate
def _service_for(doc):
    from repro_torch.core import FaultConfig, ModelSpec, WorkflowService
    models = {m: ModelSpec(m, spec["type"], spec.get("config") or {})
              for m, spec in doc["models"].items()}
    return WorkflowService(models, fault=FaultConfig(speculative=False),
                           deadlock_timeout_s=0.5)


def test_submit_document_gates_on_analyze_block():
    doc = scatter_doc(3, 0, analyze_block=True)
    svc = _service_for(doc)
    try:
        with pytest.raises(WorkflowAnalysisError) as ei:
            svc.submit_document(doc)
        assert {d.code for d in ei.value.diagnostics} >= {"SF300"}
        assert svc.list_runs() == []
    finally:
        svc.close(timeout=30)


def test_submit_document_gate_credits_live_capacity():
    doc = scatter_doc(2, 0, analyze_block=True)
    svc = _service_for(doc)
    try:
        svc.scheduler.register_resource("site-0", "site", "svc",
                                        cores=2, memory_gb=4.0)
        svc.scheduler.register_resource("site-1", "site", "svc",
                                        cores=2, memory_gb=4.0)
        assert svc.submit_document(doc)
    finally:
        svc.close(timeout=30)


# ------------------------------------------- properties, drawn the same way
@settings(max_examples=12, deadline=None, derandomize=True)
@given(width=st.integers(1, 5), r_a=st.integers(1, 3),
       r_b=st.integers(1, 3), split_site=st.booleans())
def test_analyzer_never_flags_completing_plans(width, r_a, r_b, split_site):
    models = {"a": r_a}
    work_model = "a"
    if split_site:
        models["b"] = r_b
        work_model = "b"
    doc = scatter_doc(width, r_a, models=models, work_model=work_model)
    report = analyze_both(doc)
    assert "SF300" not in _codes(report)
    assert not report.errors(), [str(d) for d in report.errors()]
    # speculation off: a straggler's twin is a timeline row of its own,
    # and a loaded machine makes stragglers (C38;
    # test_a_straggler_twin_adds_a_timeline_row holds the twin)
    cfg = load(doc)
    fault = dataclasses.replace(FaultConfig.from_dict(cfg.fault),
                                speculative=False)
    res = _run(cfg, deadlock_timeout_s=2.0, fault=fault)
    assert len(res.timeline_rows()) == width + 2
    _assert_each_completed_once(res, width + 2)


def _assert_each_completed_once(res, n_invocations):
    """Each of the run's ``n_invocations`` invocations has exactly one
    completed timeline row.  A straggler's twin adds a row of its own,
    whose loser is abandoned or a duplicate."""
    done = [row[0] for row in res.timeline_rows() if row[4] == "completed"]
    assert len(done) == len(set(done)) == n_invocations, \
        res.timeline_rows()


def test_a_straggler_twin_adds_a_timeline_row():
    """Straggler speculation on its own: an invocation that runs past
    ``straggler_factor`` times its service's median gets a twin on another
    replica, and both are timeline rows, one of them completed.  Held with
    events, not a sleep: the primary waits until its twin has started, and
    the twin lets it go."""
    import threading

    from repro_torch.core import Binding, ModelSpec
    from repro_torch.core.workflow import Step, Workflow
    twin_started, lock, calls = threading.Event(), threading.Lock(), []

    def fast(inputs, ctx):
        return {"o": inputs["x"]}

    def slow(inputs, ctx):
        with lock:
            calls.append(ctx)
            primary = len(calls) == 1
        if primary:
            assert twin_started.wait(timeout=60), "no twin was launched"
        else:
            twin_started.set()
        return {"out": inputs["a"] + inputs["b"]}
    wf = Workflow("straggler")
    wf.add_step(Step("/a", lambda i, c: {"a": fast(i, c)["o"]}, {"x": "x"},
                     ("a",)))
    wf.add_step(Step("/b", lambda i, c: {"b": fast(i, c)["o"]}, {"x": "x"},
                     ("b",)))
    wf.add_step(Step("/slow", slow, {"a": "a", "b": "b"}, ("out",)))
    models = {"site": ModelSpec("site", "local",
                                {"services": {"svc": {"replicas": 2}}})}
    ex = StreamFlowExecutor(models, fault=FaultConfig(speculative=True))
    res = ex.run(wf, [Binding("/", "site", "svc")], {"x": 1})
    assert res.outputs["out"] == 2 and len(calls) == 2
    rows = res.timeline_rows()
    assert len(rows) == 4 and [r[6] for r in rows].count(True) == 1
    _assert_each_completed_once(res, 3)


@settings(max_examples=8, deadline=None, derandomize=True)
@given(width=st.integers(2, 4), other=st.integers(1, 3))
def test_analyzer_always_flags_seeded_wedges(width, other):
    report = analyze_both(scatter_doc(width, other,
                                      models={"site": other, "dead": 0},
                                      work_model="dead"))
    assert {"SF300", "SF301"} <= _codes(report)
